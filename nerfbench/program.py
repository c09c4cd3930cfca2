"""The system under test, as the benchmark drives it: the PyTorch port
``indoor_nerf_tpu_torch``. This is the one module of the benchmark that
imports it, and it imports it only when a run starts.

Training goes through the trainer's own pieces: its flag parser, the
dataset loader, ``build_train_config``, ``init_train_state``,
``make_sampler`` and ``train_step``. Serving goes through ``serve.build``
and the ``render(c2w)`` it returns, the function the HTTP handler calls.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch


def cli_flags(args: Dict, extra: Dict) -> List[str]:
    """A flag list for the port's parser from a configuration's
    ``key = value`` pairs (``extra`` wins): ``True`` is a bare flag, ``False``
    leaves it out."""
    merged = dict(args)
    merged.update(extra)
    out = []
    for k, v in merged.items():
        if v is True:
            out.append(f"--{k}")
        elif v is False or v is None:
            continue
        else:
            out += [f"--{k}", str(v)]
    return out


class Training:
    """The trainer's state and inputs for one configuration: the parsed
    flags, the loaded scene, the static config, a fresh train state and the
    run's ray sampler (step i's batch is ``sample(i)``)."""

    def __init__(self, flags: List[str], device: torch.device, seed: int):
        from indoor_nerf_tpu_torch.data.load import load_dataset
        from indoor_nerf_tpu_torch.train.config import parse_args
        from indoor_nerf_tpu_torch.train.step import init_train_state
        from indoor_nerf_tpu_torch.train.trainer import (
            build_train_config,
            enable_normals,
            make_sampler,
        )

        self.args = parse_args(flags + ["--seed", str(seed)])
        enable_normals(self.args)
        self.scene = load_dataset(self.args)
        self.cfg = build_train_config(self.args, self.scene)
        self.device = device
        self.state = init_train_state(
            torch.Generator(device=device).manual_seed(seed), self.cfg, device)
        sample, _ = make_sampler(self.args, self.scene, self.cfg, seed)
        self.sample = sample
        self.prior_weights = {
            "depth_prior": self.args.depth_prior_weight,
            "planarity": self.args.planarity_weight,
            "manhattan": self.args.manhattan_weight,
            "normal_consistency": self.args.normal_consistency_weight,
        }
        self.with_coords = bool(self.args.no_batching)

    def leaves(self) -> Dict[str, torch.Tensor]:
        from indoor_nerf_tpu_torch.train.optim import named_leaves
        return named_leaves(self.state["params"])

    def load_params(self, params: Dict[str, torch.Tensor], step: int) -> None:
        """The benchmark's weights into the state, leaf by leaf (every leaf
        of the state must be given, with its shape), and the step and
        optimizer counters at ``step``."""
        leaves = self.leaves()
        if set(leaves) != set(params):
            raise ValueError("the benchmark's weights and the program's leaves "
                             f"differ: {sorted(set(leaves) ^ set(params))}")
        with torch.no_grad():
            for k, t in leaves.items():
                if tuple(t.shape) != tuple(params[k].shape):
                    raise ValueError(f"leaf {k}: program {tuple(t.shape)}, "
                                     f"benchmark {tuple(params[k].shape)}")
                t.copy_(params[k])
        self.state["step"] = step
        self.state["opt"]["step"] = step

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Step ``i``'s batch on the device (non-blocking copies, as the
        trainer makes them)."""
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in self.sample(i).items()}

    def draws(self, generator: torch.Generator) -> Dict:
        """The draws the next step takes, made as the step makes them."""
        from indoor_nerf_tpu_torch.train.step import draw_step
        return draw_step(generator, self.cfg, self.state["step"],
                         self.args.N_rand, self.with_coords)

    def step(self, batch, draws):
        from indoor_nerf_tpu_torch.train.step import train_step
        self.state, metrics = train_step(self.state, batch, self.cfg,
                                         draws=draws,
                                         prior_weights=self.prior_weights)
        return metrics

    def free(self) -> None:
        self.state = None


def serve_build(flags: List[str], width: int, height: int):
    """``serve.build`` of the online server at ``width`` x ``height``:
    returns ``(render, step, (H, W))``; it makes one warm-up render."""
    from indoor_nerf_tpu_torch import serve

    return serve.build(argparse.Namespace(
        width=width, height=height, baked=False, baked_res=256, guided=0,
        snapshot=None, train_args=["--"] + flags))


def write_checkpoint(path: str, params: Dict[str, torch.Tensor],
                     density: torch.Tensor, step: int) -> None:
    """A checkpoint in the port's format (a ``torch.save`` dict of CPU
    tensors keyed ``params.<leaf>``, ``occ.density``, ``step``) holding the
    benchmark's weights and occupancy grid; the optional keys (moments,
    counters) are left out."""
    from indoor_nerf_tpu_torch.utils.checkpoint import FORMAT

    payload = {"format": FORMAT, "step": int(step),
               "occ.density": density.detach().cpu()}
    payload.update({f"params.{k}": v.detach().cpu() for k, v in params.items()})
    torch.save(payload, path)


def build_seconds() -> float:
    """The seconds ``nvcc`` took in this process to build the port's CUDA
    kernels: 0 where the checkout already held every kernel the run loaded
    (``indoor_nerf_tpu_torch/build/``), the first run's compilation
    otherwise."""
    import sys

    builder = sys.modules.get("indoor_nerf_tpu_torch.cuda_build")
    if builder is None:
        return 0.0
    return float(sum(lib.seconds for lib in builder._LOADED.values()))
