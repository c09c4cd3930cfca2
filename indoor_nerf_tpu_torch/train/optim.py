"""RAdam with the reference's two param groups (train/optim.py of the JAX
package), as plain tensor code over a ``{name: tensor}`` dict.

Not ``torch.optim.RAdam``, whose semantics differ from the JAX one (and
the reference's, PocketNeRF/radam.py) in three ways: it takes an
un-rectified step while the rectification term N_sma is <= 5, where this
one leaves the parameter unchanged; its weight decay is L2 by default, not
decoupled; and it bias-corrects the denominator separately, where this one
keeps the ``(1 - beta2^t)`` factor inside the rectified step size.

The scalar schedule (lr, N_sma, the rectified step) is computed in float32
on the host, as the JAX package computes it in float32 on the device; the
step counter is a host integer. Moments and parameters are updated in
place, which saves a copy of each (the table's are 64 MiB at the flagship).

Two implementations of the same step live here, and ``radam_update``
dispatches on the leaves' device:

- ``radam_update_plain``: the eager loop, a few elementwise ops a leaf. The
  CPU path, and the reference the kernel is held against.
- the CUDA kernel of ``csrc/fused_radam.cu``: every leaf of the step in one
  launch, bit for bit the eager loop's arithmetic on the card. CUDA leaves
  launch it or raise (a leaf that is not contiguous float32); there is no
  fallback to the eager loop.

Both take their float32 scalars from ``radam_scalars``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from indoor_nerf_tpu_torch.cuda_build import count, launch_on_stream, load_library

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RAdamHyper:
    """Static RAdam hyperparameters for one param group."""

    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    weight_decay: float = 0.0


def named_leaves(params: Dict[str, object]) -> Leaves:
    """The params' tensors by name: ``"table"``, ``"coarse.sigma_net.0.w"``,
    ... (the JAX pytree path joined by dots)."""
    out: Leaves = {}
    for key, value in params.items():
        if isinstance(value, nn.Module):
            for name, t in value.named_parameters():
                out[f"{key}.{name}"] = t
        else:
            out[key] = value
    return out


def init_radam_state(leaves: Leaves) -> Dict[str, object]:
    return {"mu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "nu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "step": 0}


def exp_decay_lr(lrate: float, lrate_decay: int, step: int) -> float:
    """lr = lrate * 0.1^(step / (lrate_decay * 1000)), in float32
    (reference: run_nerf.py:1289-1293)."""
    decay_steps = np.float32(lrate_decay * 1000.0)
    return float(np.float32(lrate)
                 * np.power(np.float32(0.1), np.float32(step) / decay_steps))


def pocketnerf_hyper_fn(name: str) -> RAdamHyper:
    """The reference's two param groups (run_nerf.py:281-285): the table
    gets eps 1e-15 and no weight decay; everything else weight decay 1e-6
    and the default eps."""
    if name == "table":
        return RAdamHyper(eps=1e-15, weight_decay=0.0)
    return RAdamHyper(eps=1e-8, weight_decay=1e-6)


def nerfacto_hyper_fn(name: str) -> RAdamHyper:
    """Nerfacto's one group: nerfstudio's Adam settings for its fields and
    proposal networks (eps 1e-15, no weight decay) on every leaf."""
    return RAdamHyper(eps=1e-15, weight_decay=0.0)


def _rectified_step(h: RAdamHyper, t: int):
    """(adaptive?, rect) for step ``t`` (1-based), in float32 as JAX :81-95."""
    f32 = np.float32
    tf = f32(t)
    beta2_t = np.power(f32(h.beta2), tf)
    n_sma_max = f32(2.0 / (1.0 - h.beta2) - 1.0)
    n_sma = n_sma_max - f32(2.0) * tf * beta2_t / (f32(1.0) - beta2_t)
    rect = np.sqrt(np.maximum(
        (f32(1.0) - beta2_t)
        * (n_sma - f32(4.0)) / (n_sma_max - f32(4.0))
        * (n_sma - f32(2.0)) / n_sma
        * n_sma_max / (n_sma_max - f32(2.0)), f32(0.0)))
    rect = rect / (f32(1.0) - np.power(f32(h.beta1), tf))
    return bool(n_sma >= f32(5.0)), f32(rect)


@dataclasses.dataclass(frozen=True)
class RAdamScalars:
    """One param group's float32 scalars at one step: the values both
    implementations multiply by (each a ``np.float32``)."""

    adaptive: bool  # N_sma >= 5: the parameters move
    decay: bool  # weight decay != 0
    beta1: np.float32
    one_minus_beta1: np.float32
    beta2: np.float32
    one_minus_beta2: np.float32
    eps: np.float32
    wd_lr: np.float32
    lr_rect: np.float32


def radam_scalars(h: RAdamHyper, t: int, lr: float) -> RAdamScalars:
    """The scalars of step ``t`` (1-based) at learning rate ``lr``. A
    float32 tensor times a Python float multiplies by the float's float32
    rounding, so ``1 - beta`` is taken in double and then rounded, as the
    eager loop's ``g * (1.0 - beta1)`` does; ``wd * lr`` and ``lr * rect``
    are float32 products."""
    f32 = np.float32
    lr32 = f32(lr)
    adaptive, rect = _rectified_step(h, t)
    return RAdamScalars(
        adaptive=adaptive, decay=h.weight_decay != 0.0,
        beta1=f32(h.beta1), one_minus_beta1=f32(1.0 - h.beta1),
        beta2=f32(h.beta2), one_minus_beta2=f32(1.0 - h.beta2),
        eps=f32(h.eps), wd_lr=f32(h.weight_decay) * lr32,
        lr_rect=lr32 * rect)


@torch.no_grad()
def radam_update(leaves: Leaves, grads: Dict[str, Optional[torch.Tensor]],
                 state: Dict[str, object], lr: float,
                 hyper_fn: Callable[[str], RAdamHyper] = pocketnerf_hyper_fn
                 ) -> None:
    """One RAdam step over ``leaves`` in place (JAX ``radam_update``,
    :60-127). A missing gradient counts as zero. While N_sma < 5 (the first
    5 steps at beta2 0.99) the moments accumulate and the parameters stay
    unchanged; then ``p -= wd*lr*p`` (decoupled) and
    ``p -= lr*rect * mu / (sqrt(nu) + eps)``. CPU leaves take the eager
    loop; CUDA leaves the kernel, in one launch for up to 32 leaves."""
    devices = {p.device for p in leaves.values()}
    if all(d.type == "cpu" for d in devices):
        return radam_update_plain(leaves, grads, state, lr, hyper_fn)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("radam_update takes leaves on the cpu or on one "
                         f"cuda device, got {sorted(map(str, devices))}")
    return radam_update_fused(leaves, grads, state, lr, hyper_fn)


@torch.no_grad()
def radam_update_plain(leaves: Leaves,
                       grads: Dict[str, Optional[torch.Tensor]],
                       state: Dict[str, object], lr: float,
                       hyper_fn: Callable[[str], RAdamHyper]) -> None:
    """The eager loop: twelve to fourteen elementwise ops a leaf."""
    t = state["step"] + 1
    for name, p in leaves.items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        s = radam_scalars(hyper_fn(name), t, lr)
        mu, nu = state["mu"][name], state["nu"][name]
        nu.mul_(float(s.beta2)).add_(g * g * float(s.one_minus_beta2))
        mu.mul_(float(s.beta1)).add_(g * float(s.one_minus_beta1))
        if not s.adaptive:
            continue
        if s.decay:
            p.sub_(p * float(s.wd_lr))
        p.sub_(mu * float(s.lr_rect) / (torch.sqrt(nu) + float(s.eps)))
    state["step"] = t


# The kernel's geometry (csrc/fused_radam.cu: kChunk, kMaxLeaves; checked
# against the built library) and its leaf flags.
CHUNK = 4096
MAX_LEAVES = 32
_ADAPTIVE, _DECAY, _VECTOR = 1, 2, 4


def n_chunks(numel: int, head: int, chunk: int = CHUNK) -> int:
    """The blocks a leaf takes: the elements from ``head`` on in chunks of
    ``chunk``, the first also holding the ``head`` before them."""
    if numel == 0:
        return 0
    return max(1, -(-(numel - head) // chunk))


def chunk_ranges(numel: int, head: int, c: int,
                 chunk: int = CHUNK) -> List[Tuple[int, int]]:
    """The element ranges ``[begin, end)`` that chunk ``c`` of a leaf
    updates, as the kernel's ``chunk`` walks them."""
    out = []
    if c == 0 and min(head, numel) > 0:
        out.append((0, min(head, numel)))
    begin = head + c * chunk
    end = min(begin + chunk, numel)
    if begin < end:
        out.append((begin, end))
    return out


def chunk_plan(numels: List[int], heads: List[int],
               max_leaves: int = MAX_LEAVES,
               chunk: int = CHUNK) -> List[Tuple[int, int, np.ndarray]]:
    """The launches of one step: ``(first, stop, chunk_start)`` for the
    leaves ``[first, stop)``, at most ``max_leaves`` a launch, with
    ``chunk_start`` (int32, from 0) the first block of each leaf and the
    launch's block count last."""
    plan = []
    for first in range(0, len(numels), max_leaves):
        stop = min(first + max_leaves, len(numels))
        starts = np.zeros(stop - first + 1, np.int64)
        starts[1:] = np.cumsum([n_chunks(numels[i], heads[i], chunk)
                                for i in range(first, stop)])
        if starts[-1] >= 2 ** 31:
            raise ValueError(f"{int(starts[-1])} blocks exceed one launch's grid")
        plan.append((first, stop, starts.astype(np.int32)))
    return plan


def _head(*ptrs: int) -> Optional[int]:
    """The float32 elements before the first 16-byte boundary that every
    array of ``ptrs`` reaches at the same element, or None where their
    offsets modulo 16 B differ (the scalar path)."""
    offsets = {ptr % 16 for ptr in ptrs}
    if len(offsets) != 1:
        return None
    return (16 - offsets.pop()) % 16 // 4


def _check_leaf(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"fused_radam takes contiguous float32 leaves: "
                        f"{name} is {t.dtype}, contiguous "
                        f"{t.is_contiguous()}")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, its "
                         f"leaf {tuple(like.shape)} on {like.device}")


class _LeafTable:
    """The host arrays of one set of leaves, built once: the leaves'
    pointers stay put, since every update is in place. A step writes only
    the gradients' pointers, the scalars and the flags."""

    def __init__(self, leaves: Leaves, state: Dict[str, object],
                 hyper_fn: Callable[[str], RAdamHyper]):
        self.names = list(leaves)
        k = len(self.names)
        self.ptrs = np.zeros((k, 4), np.int64)
        self.numel = np.zeros(k, np.int64)
        self.head = np.zeros(k, np.int32)
        self.vector = np.zeros(k, np.int32)
        self.flags = np.zeros(k, np.int32)
        self.scalars = np.zeros((k, 7), np.float32)
        self.hypers = sorted({hyper_fn(n) for n in self.names}, key=repr)
        self.group = np.array([self.hypers.index(hyper_fn(n))
                               for n in self.names], np.int64)
        for i, name in enumerate(self.names):
            p, mu, nu = (leaves[name], state["mu"][name], state["nu"][name])
            for what, t in (("leaf", p), ("mu", mu), ("nu", nu)):
                _check_leaf(f"{what} {name}", t, p)
            self.ptrs[i] = (p.data_ptr(), 0, mu.data_ptr(), nu.data_ptr())
            self.numel[i] = p.numel()
            head = _head(p.data_ptr(), mu.data_ptr(), nu.data_ptr())
            self.head[i] = 0 if head is None else head
            self.vector[i] = 0 if head is None else _VECTOR
        self.plan = chunk_plan(self.numel.tolist(), self.head.tolist())
        # The launcher's arguments: each launch's rows of the arrays above.
        self.launches = [
            (tuple(a.ctypes.data + first * a.strides[0] for a in (
                self.ptrs, self.numel, self.head, self.flags, self.scalars))
             + (starts.ctypes.data, stop - first), starts)
            for first, stop, starts in self.plan]

    def step(self, grads: Dict[str, Optional[torch.Tensor]], leaves: Leaves,
             t: int, lr: float) -> None:
        """This step's gradients, scalars and flags into the arrays."""
        groups = [radam_scalars(h, t, lr) for h in self.hypers]
        table = np.array([(s.beta1, s.one_minus_beta1, s.beta2,
                           s.one_minus_beta2, s.eps, s.wd_lr, s.lr_rect)
                          for s in groups], np.float32)
        gflags = np.array([_ADAPTIVE * s.adaptive + _DECAY * s.decay
                           for s in groups], np.int32)
        self.scalars[:] = table[self.group]
        self.flags[:] = gflags[self.group] | self.vector
        for i, name in enumerate(self.names):
            g = grads.get(name)
            if g is None:
                self.ptrs[i, 1] = 0
                continue
            _check_leaf(f"gradient {name}", g, leaves[name])
            self.ptrs[i, 1] = g.data_ptr()
            if g.data_ptr() % 16 != self.ptrs[i, 0] % 16:
                self.flags[i] &= ~_VECTOR


_tables: Dict[tuple, _LeafTable] = {}


def _leaf_table(leaves: Leaves, state: Dict[str, object],
                hyper_fn: Callable[[str], RAdamHyper]) -> _LeafTable:
    key = (hyper_fn,) + tuple(
        (name, p.data_ptr(), state["mu"][name].data_ptr(),
         state["nu"][name].data_ptr(), p.numel(), p.dtype)
        for name, p in leaves.items())
    table = _tables.get(key)
    if table is None:
        table = _LeafTable(leaves, state, hyper_fn)
        if len(_tables) >= 8:  # tables of leaves since freed
            _tables.clear()
        _tables[key] = table
    return table


def radam_update_fused(leaves: Leaves,
                       grads: Dict[str, Optional[torch.Tensor]],
                       state: Dict[str, object], lr: float,
                       hyper_fn: Callable[[str], RAdamHyper]) -> None:
    """The kernel: every leaf (on one CUDA device) in one launch per
    ``MAX_LEAVES``, on the current stream, without a synchronize. Counts
    the leaves (once a step each) and elements it updates, as
    ``fused_radam.leaves`` and ``fused_radam.elements``."""
    t = state["step"] + 1
    table = _leaf_table(leaves, state, hyper_fn)
    table.step(grads, leaves, t, lr)
    lib = load_library("fused_radam", check_geometry).lib
    device = next(iter(leaves.values())).device
    for args, _ in table.launches:
        launch_on_stream(lib.fused_radam, lib.fused_radam_error_string,
                         "fused_radam", (), *args, device=device)
    # The kernel wrote the leaves through their pointers: count that as an
    # in-place update, so what is keyed by a leaf's version (the fused
    # MLP's weight pack, autograd's saved tensors) sees it.
    for p in leaves.values():
        torch.autograd.graph.increment_version(p)
    count("fused_radam.leaves", len(table.names))
    count("fused_radam.elements", int(table.numel.sum()))
    state["step"] = t


def check_geometry(lib) -> None:
    """Raise unless the built library's kChunk, kMaxLeaves are ``CHUNK``,
    ``MAX_LEAVES``."""
    if (lib.fused_radam_chunk(), lib.fused_radam_max_leaves()) != (
            CHUNK, MAX_LEAVES):
        raise RuntimeError("csrc/fused_radam.cu's kChunk, kMaxLeaves "
                           "differ from train/optim.py's")
