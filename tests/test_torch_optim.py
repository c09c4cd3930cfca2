"""The RAdam step's host side on the CPU: the float32 scalars both paths
share, the eager loop against its earlier form bit for bit, the kernel's
chunk plan and leaf table. The kernel itself is held against the eager
loop on the card (tests/test_torch_fused_radam_cuda.py)."""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.train import optim
from indoor_nerf_tpu_torch.train.optim import (
    RAdamHyper,
    _rectified_step,
    exp_decay_lr,
    init_radam_state,
    pocketnerf_hyper_fn,
    radam_scalars,
    radam_update,
)

GROUPS = [pocketnerf_hyper_fn("table"), pocketnerf_hyper_fn("mlp.w"),
          RAdamHyper(beta1=0.8, beta2=0.95, eps=1e-6, weight_decay=3e-4)]


@torch.no_grad()
def _earlier_radam_update(leaves, grads, state, lr, hyper_fn):
    """The eager loop as it was before the scalars had a helper."""
    t = state["step"] + 1
    lr32 = np.float32(lr)
    for name, p in leaves.items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        h = hyper_fn(name)
        mu, nu = state["mu"][name], state["nu"][name]
        nu.mul_(h.beta2).add_(g * g * (1.0 - h.beta2))
        mu.mul_(h.beta1).add_(g * (1.0 - h.beta1))
        adaptive, rect = _rectified_step(h, t)
        if not adaptive:
            continue
        if h.weight_decay != 0.0:
            p.sub_(p * float(np.float32(h.weight_decay) * lr32))
        p.sub_(mu * float(lr32 * rect) / (torch.sqrt(nu) + h.eps))
    state["step"] = t


def _f32_of(x: float) -> float:
    """The float32 a float32 tensor multiplies by for the Python float x."""
    return (torch.ones(1, dtype=torch.float32) * x).item()


@pytest.mark.parametrize("h", GROUPS, ids=["table", "mlp", "other"])
@pytest.mark.parametrize("t", [1, 5, 6, 7, 500])
def test_scalars_are_the_values_the_eager_loop_fed_its_ops(h, t):
    lr = exp_decay_lr(0.01, 250, t - 1)
    s = radam_scalars(h, t, lr)
    adaptive, rect = _rectified_step(h, t)
    lr32 = np.float32(lr)
    assert s.adaptive == adaptive and s.decay == (h.weight_decay != 0.0)
    for got, x in ((s.beta1, h.beta1), (s.one_minus_beta1, 1.0 - h.beta1),
                   (s.beta2, h.beta2), (s.one_minus_beta2, 1.0 - h.beta2),
                   (s.eps, h.eps)):
        assert isinstance(got, np.float32)
        assert float(got) == _f32_of(x)
    assert float(s.wd_lr) == float(np.float32(h.weight_decay) * lr32)
    assert float(s.lr_rect) == float(lr32 * rect)
    assert s.wd_lr.dtype == s.lr_rect.dtype == np.float32


def _leaves(rng, shapes):
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in shapes.items()}


SHAPES = {"table": (64, 12), "coarse.sigma_net.0.w": (7, 5),
          "coarse.normal_net.1.b": (3,), "appearance": (4, 6)}


def _hyper_of_three(name):
    return GROUPS[2] if name == "appearance" else pocketnerf_hyper_fn(name)


@pytest.mark.parametrize("hyper_fn", [pocketnerf_hyper_fn, _hyper_of_three],
                         ids=["two_groups", "three_groups"])
def test_eager_loop_is_bit_identical_to_its_earlier_form(hyper_fn):
    """8 steps across the rectification threshold (t = 6), with a leaf that
    gets no gradient on odd steps and gradient entries of 0."""
    rng = np.random.default_rng(0)
    a, b = _leaves(rng, SHAPES), _leaves(rng, SHAPES)
    for n in a:
        b[n].copy_(a[n])
    sa, sb = init_radam_state(a), init_radam_state(b)
    for step in range(8):
        grads = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for n, s in SHAPES.items()
                 if not (n == "appearance" and step % 2)}
        grads["table"][::3] = 0.0
        lr = exp_decay_lr(0.01, 250, step)
        radam_update(a, grads, sa, lr, hyper_fn)
        _earlier_radam_update(b, grads, sb, lr, hyper_fn)
        assert sa["step"] == sb["step"] == step + 1
        for n in SHAPES:
            for got, want in ((a[n], b[n]), (sa["mu"][n], sb["mu"][n]),
                              (sa["nu"][n], sb["nu"][n])):
                assert torch.equal(got, want), (n, step)


def test_cpu_leaves_take_the_eager_loop_and_launch_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path ran for CPU leaves")

    monkeypatch.setattr(optim, "radam_update_fused", refuse)
    reset_counts()
    leaves = _leaves(np.random.default_rng(1), SHAPES)
    state = init_radam_state(leaves)
    radam_update(leaves, {}, state, 0.01)
    assert state["step"] == 1
    assert not any(launch_counts().values())


def test_leaves_off_cpu_and_cuda_are_refused():
    leaves = {"table": torch.empty(4, device="meta")}
    with pytest.raises(ValueError, match="cpu or on one cuda device"):
        radam_update(leaves, {}, init_radam_state(leaves), 0.01)


def _covered(numels, heads, max_leaves, chunk):
    """How often each element of each leaf is updated by the plan."""
    hits = [np.zeros(n, np.int64) for n in numels]
    plan = optim.chunk_plan(numels, heads, max_leaves, chunk)
    for first, stop, starts in plan:
        assert starts[0] == 0 and starts.dtype == np.int32
        assert stop - first <= max_leaves
        for j, i in enumerate(range(first, stop)):
            n_blocks = starts[j + 1] - starts[j]
            assert n_blocks == optim.n_chunks(numels[i], heads[i], chunk)
            for c in range(n_blocks):
                for begin, end in optim.chunk_ranges(numels[i], heads[i], c,
                                                     chunk):
                    hits[i][begin:end] += 1
    return plan, hits


@pytest.mark.parametrize("numels,heads", [
    ([1], [0]), ([3], [3]), ([2], [3]), ([16], [0]), ([17], [1]),
    ([64, 65, 0, 5, 31], [0, 3, 0, 2, 1]),
    ([1000, 1, 16, 15, 48, 2], [2, 1, 0, 3, 0, 0]),
], ids=["one", "head_only", "shorter_than_head", "one_chunk", "head_and_tail",
        "mixed", "large"])
@pytest.mark.parametrize("max_leaves", [1, 3, 32])
def test_chunk_plan_covers_every_element_once(numels, heads, max_leaves):
    plan, hits = _covered(numels, heads, max_leaves, chunk=16)
    for n, h in zip(numels, hits):
        assert np.all(h == 1), (n, h)
    assert [(first, stop) for first, stop, _ in plan] == [
        (i, min(i + max_leaves, len(numels)))
        for i in range(0, len(numels), max_leaves)]


def test_chunk_plan_splits_a_step_past_one_launch():
    """The flagship's chunk and capacity: 73 leaves take three launches,
    each over consecutive leaves."""
    numels = [65536 * 256] + [2048, 1024, 1984, 4096, 192, 480, 32, 96, 3] * 8
    heads = [0] * len(numels)
    plan = optim.chunk_plan(numels, heads)
    assert [(a, b) for a, b, _ in plan] == [(0, 32), (32, 64), (64, 73)]
    assert plan[0][2][1] == 65536 * 256 // optim.CHUNK
    total = sum(int(s[-1]) for _, _, s in plan)
    assert total == sum(optim.n_chunks(n, 0) for n in numels)


@pytest.mark.parametrize("ptrs,head", [
    ((4096, 8192, 512), 0), ((4100, 8196, 516), 3), ((4104, 8200, 520), 2),
    ((4108, 8204, 524), 1), ((4096, 8196, 512), None), ((4100, 8200, 516), None),
])
def test_head_needs_one_offset_modulo_16_bytes(ptrs, head):
    assert optim._head(*ptrs) == head


def test_leaf_table_writes_each_steps_scalars_flags_and_gradients():
    rng = np.random.default_rng(2)
    leaves = _leaves(rng, SHAPES)
    # An odd offset: a view one element into a buffer.
    buf = torch.zeros(64 * 12 + 1)
    leaves["table"] = buf[1:].view(64, 12).copy_(leaves["table"])
    state = init_radam_state(leaves)
    table = optim._LeafTable(leaves, state, pocketnerf_hyper_fn)
    names = list(SHAPES)
    assert table.names == names
    assert table.numel.tolist() == [int(np.prod(s)) for s in SHAPES.values()]
    assert len(table.launches) == 1 and table.launches[0][0][-1] == len(names)
    grads = {n: torch.ones(s) for n, s in SHAPES.items() if n != "appearance"}
    grads["coarse.sigma_net.0.w"] = torch.ones(36)[1:].view(7, 5)
    for t in (1, 6):
        table.step(grads, leaves, t, 0.01)
        for i, n in enumerate(names):
            s = radam_scalars(pocketnerf_hyper_fn(n), t, 0.01)
            assert table.scalars[i].tolist() == [
                float(v) for v in (s.beta1, s.one_minus_beta1, s.beta2,
                                   s.one_minus_beta2, s.eps, s.wd_lr,
                                   s.lr_rect)]
            want_g = 0 if n == "appearance" else grads[n].data_ptr()
            assert table.ptrs[i].tolist() == [
                leaves[n].data_ptr(), want_g, state["mu"][n].data_ptr(),
                state["nu"][n].data_ptr()]
            # The table is at another offset than its moments, and the
            # sigma net's gradient than its leaf: both take the scalar path.
            vector = n not in ("table", "coarse.sigma_net.0.w")
            want = (optim._ADAPTIVE * s.adaptive + optim._DECAY * s.decay
                    + optim._VECTOR * vector)
            assert table.flags[i] == want, (n, t)


@pytest.mark.parametrize("where,bad", [
    ("leaf", "float64"), ("leaf", "strided"), ("gradient", "float64"),
    ("gradient", "strided"), ("gradient", "shape")])
def test_leaf_table_refuses_what_the_kernel_does_not_take(where, bad):
    leaves = _leaves(np.random.default_rng(3), SHAPES)
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    odd = {"float64": torch.zeros(7, 5, dtype=torch.float64),
           "strided": torch.zeros(5, 7).t(),
           "shape": torch.zeros(35)}[bad]
    (leaves if where == "leaf" else grads)["coarse.sigma_net.0.w"] = odd
    state = init_radam_state(leaves)
    with pytest.raises(ValueError if bad == "shape" else TypeError):
        optim._LeafTable(leaves, state, pocketnerf_hyper_fn).step(
            grads, leaves, 1, 0.01)
