"""The fused RAdam kernel (csrc/fused_radam.cu) against the eager loop on
the card, bit for bit, over 8 steps that cross the rectification threshold
(the parameters stay put through t = 5 and move from t = 6). This file
imports no jax, so it runs on a card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fused_radam_cuda.py
"""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.train import optim
from indoor_nerf_tpu_torch.train.optim import (
    exp_decay_lr,
    pocketnerf_hyper_fn,
    radam_update,
    radam_update_plain,
)

MLP = {"coarse.sigma_net.0.w": (32, 64), "coarse.sigma_net.1.w": (64, 16),
       "coarse.color_net.0.w": (31, 64), "coarse.color_net.1.w": (64, 64),
       "coarse.color_net.2.w": (64, 3), "coarse.normal_net.0.w": (15, 32),
       "coarse.normal_net.0.b": (32,), "coarse.normal_net.1.w": (32, 3),
       "coarse.normal_net.1.b": (3,)}
# The leaf sets of the flagship (block hash) and of the hash grid (two
# NeRFSmall nets); "small": odd sizes and offsets, a leaf without gradients.
CASES = {
    "flagship": {"table": (65536, 256), **MLP},
    "hashgrid": {"table": (8388608, 2), **MLP,
                 **{k.replace("coarse", "fine"): s for k, s in MLP.items()}},
    "small": {"table": (1000, 7), "coarse.w": (5, 3), "coarse.b": (3,),
              "appearance": (4, 5), "head.w": (4097,), "skew.w": (4099,)},
    "many": {**{f"net.{i}.w": (37 * i + 1,) for i in range(40)},
             "table": (9000, 3)},
}
NO_GRAD = {"appearance"}  # every other step: a leaf with no gradient
OFFSET = {"head.w": (1, 1, 1, 1), "skew.w": (1, 2, 3, 0)}  # elements in


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _at(values: np.ndarray, offset: int, device) -> torch.Tensor:
    """A tensor holding ``values``, ``offset`` elements into its buffer."""
    buf = torch.zeros(values.size + offset, dtype=torch.float32, device=device)
    out = buf[offset:].view(values.shape)
    out.copy_(torch.from_numpy(values))
    return out


def _setup(shapes, device, seed):
    """Two equal (leaves, state) pairs; a leaf named in OFFSET lies, with
    its moments, at those element offsets (p, mu, nu), its gradient at the
    fourth."""
    rng = np.random.default_rng(seed)
    pairs = []
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    for _ in range(2):
        leaves, mu, nu = {}, {}, {}
        for n, v in init.items():
            o = OFFSET.get(n, (0, 0, 0, 0))
            leaves[n] = _at(v, o[0], device)
            mu[n] = _at(np.zeros_like(v), o[1], device)
            nu[n] = _at(np.zeros_like(v), o[2], device)
        pairs.append((leaves, {"mu": mu, "nu": nu, "step": 0}))
    return pairs


def _grads(shapes, rng, step, device):
    out = {}
    for n, s in shapes.items():
        if n in NO_GRAD and step % 2:
            continue
        g = rng.standard_normal(s).astype(np.float32)
        if n == "table":
            g *= 1e-3
            g[::2] = 0.0  # rows no point touched this step
        out[n] = _at(g, OFFSET.get(n, (0, 0, 0, 0))[3], device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_is_the_eager_loop_bit_for_bit(card, case):
    shapes = CASES[case]
    (a, sa), (b, sb) = _setup(shapes, card, seed=0)
    rng = np.random.default_rng(1)
    numel = sum(int(np.prod(s)) for s in shapes.values())
    launches_a_step = -(-len(shapes) // optim.MAX_LEAVES)
    init = {n: p.clone() for n, p in a.items()}
    for step in range(8):
        grads = _grads(shapes, rng, step, card)
        lr = exp_decay_lr(0.01, 250, step)
        reset_counts()
        radam_update(a, grads, sa, lr)
        counts = launch_counts()
        assert counts["fused_radam"] == launches_a_step
        assert (counts["fused_radam.leaves"], counts["fused_radam.elements"]) \
            == (len(shapes), numel)
        radam_update_plain(b, grads, sb, lr, pocketnerf_hyper_fn)
        torch.cuda.synchronize()
        assert sa["step"] == sb["step"] == step + 1
        for n in shapes:
            for what, got, want in (("p", a[n], b[n]),
                                    ("mu", sa["mu"][n], sb["mu"][n]),
                                    ("nu", sa["nu"][n], sb["nu"][n])):
                if not torch.equal(got, want):
                    diff = (got != want).sum().item()
                    raise AssertionError(f"{case} step {step + 1} {what} {n}: "
                                         f"{diff} entries differ")
        for n in shapes:
            assert (not torch.equal(a[n], init[n])) == (step >= 5), (n, step)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "strided", "grad_strided"])
def test_kernel_refuses_what_it_does_not_take(card, bad):
    leaves = {"table": torch.zeros(64, 8, device=card),
              "coarse.w": torch.zeros(8, 4, device=card)}
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    if bad == "float64":
        leaves["coarse.w"] = leaves["coarse.w"].double()
    elif bad == "strided":
        leaves["coarse.w"] = torch.zeros(4, 8, device=card).t()
        grads["coarse.w"] = torch.zeros(8, 4, device=card)
    else:
        grads["coarse.w"] = torch.zeros(4, 8, device=card).t()
    state = {"mu": {n: torch.zeros_like(p) for n, p in leaves.items()},
             "nu": {n: torch.zeros_like(p) for n, p in leaves.items()},
             "step": 0}
    with pytest.raises(TypeError, match="contiguous float32"):
        radam_update(leaves, grads, state, 0.01)
