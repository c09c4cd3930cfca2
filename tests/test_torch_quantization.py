"""Port parity: A-CAQ's quantizers and controller (losses/quantization.py)
against the JAX package's, on numpy inputs made from a seed. The twelve
cases mirror tests/test_quantization.py's, each run through both packages.

Tolerances:
- the controller's arithmetic, the calibration and the STE gradients: 1e-6
  relative (float32 sums and products in one order on both sides);
- dequantized values: equal, except where ``x / scale + zero_point`` lies
  near a rounding boundary, where the two may round apart by exactly one
  step. XLA computes ``exp2`` on the CPU as ``exp(x ln 2)``, up to 1.2e-6
  relative away from torch's ``exp2`` (measured over soft bits in [2, 32];
  integer bits up to 2^12 agree exactly), so at soft bits the scales differ
  by that much: every dequantized value then differs by up to 2e-6
  relative (of the value and of the quantized range), and ``x / scale`` by
  2e-6 relative, so "near" is within ``1e-5 + 2e-6 |x / scale|``. Such
  entries are counted and their share bounded (``assert_dequant_equal``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.losses.quantization as jq
import indoor_nerf_tpu_torch.losses.quantization as tq

torch.set_num_threads(1)

J_CFG = jq.QuantConfig(n_embed_levels=4, n_act_quantizers=1)
T_CFG = tq.QuantConfig(n_embed_levels=4, n_act_quantizers=1)
T = torch.from_numpy


def _np(tree):
    """A group or state of either package as numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def assert_tree_close(got, want, rtol=1e-6, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], rtol, f"{what}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _groups(x, symmetric):
    """The same calibrated group in both packages (the weight's, or the
    first activation quantizer's), from ``x``."""
    j = jq.init_quant_state(J_CFG)
    t = tq.init_quant_state(T_CFG)
    if symmetric:
        jg, tg = j["weight"], t["weight"]
    else:
        jg = {k: v[0] for k, v in j["act"].items()}
        tg = {k: v[0] for k, v in t["act"].items()}
    jg = jq.calibrate(jg, jnp.asarray(x), symmetric=symmetric)
    tg = tq.calibrate(tg, T(x), symmetric=symmetric)
    assert_tree_close(tg, jg, what="calibrated group")
    return jg, tg


def assert_dequant_equal(got, want, x, group, train, max_share=0.01):
    """``got`` equals ``want`` except at entries whose ``x / scale +
    zero_point`` (the JAX quantizer's, asymmetric) lies near a rounding
    boundary (module docstring), where they differ by one step; the share
    of those entries stays under ``max_share``. Returns their count."""
    got, want, x = _np(got), _np(want), np.asarray(x, np.float64)
    g = _np(group)
    bits = np.clip(np.float64(g["soft_bits"]), 2.0, 32.0)
    b = bits if train else np.round(bits)
    scale = max(float(g["range_scale"]), 1e-8) / (2.0 ** b - 1.0)
    zp = np.round(np.clip(-float(g["running_min"]) / scale, 0, 2.0 ** b - 1))
    xs = x / scale + zp
    near = np.abs(np.abs(xs - np.floor(xs)) - 0.5) < 1e-5 + 2e-6 * np.abs(xs)
    err = np.abs(got.astype(np.float64) - want)
    diff = err > 2e-6 * (np.abs(want) + scale * 2.0 ** b)
    assert not (diff & ~near).any(), np.flatnonzero(diff & ~near)[:10]
    np.testing.assert_allclose(err[diff], scale, rtol=1e-4)
    assert diff.sum() <= max_share * diff.size, (diff.sum(), diff.size)
    return int(diff.sum())


def case_fixed_roundtrip_and_ste(rng):
    x = rng.normal(size=(256,)).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0)
    want = jq.fake_quant_fixed(jnp.asarray(x), jnp.asarray(scale),
                               jnp.zeros(()), num_bits=8, train=False)
    got = tq.fake_quant_fixed(T(x), torch.tensor(scale), torch.zeros(()), 8,
                              train=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(np.abs(got.numpy() - x).max()) <= float(scale) * 0.51
    xt = T(x).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(tq.fake_quant_fixed(
        xt, torch.tensor(scale), torch.zeros(()), 8, train=True)), xt)
    np.testing.assert_array_equal(g.numpy(), 1.0)


def case_small_scale_inputs(rng):
    x = rng.uniform(-1e-4, 1e-4, size=(4096,)).astype(np.float32)
    jg, tg = _groups(x, symmetric=False)
    want = jq.learned_fake_quant(jnp.asarray(x), jg, J_CFG, symmetric=False,
                                 train=False)
    got = tq.learned_fake_quant(T(x), tg, T_CFG, symmetric=False, train=False)
    assert_dequant_equal(got, want, x, jg, train=False)
    assert float(np.abs(got.numpy() - x).max()) < 2e-6


def case_high_bits_is_identity(rng):
    x = rng.uniform(-0.5, 0.5, size=(4096,)).astype(np.float32)
    jg, tg = _groups(x, symmetric=False)
    for bits in (24.0, 28.0, 32.0, 20.0):
        jgb = dict(jg, soft_bits=jnp.full_like(jg["soft_bits"], bits))
        tgb = dict(tg, soft_bits=torch.full_like(tg["soft_bits"], bits))
        for train in (True, False):
            want = jq.learned_fake_quant(jnp.asarray(x), jgb, J_CFG, False,
                                         train=train)
            got = tq.learned_fake_quant(T(x), tgb, T_CFG, False, train=train)
            if bits >= 24.0:
                np.testing.assert_array_equal(got.numpy(), x)
                np.testing.assert_array_equal(np.asarray(want), x)
            else:  # a fine quantization, not a collapse
                assert_dequant_equal(got, want, x, jgb, train)
                assert float(np.abs(got.numpy() - x).max()) < 1e-5


def case_unique_values_bounded(rng):
    x = rng.uniform(-1e-4, 1e-4, size=(8192,)).astype(np.float32)
    for bits in (2.0, 4.0, 8.0):
        jg, tg = _groups(x, symmetric=False)
        jg = dict(jg, soft_bits=jnp.asarray(bits))
        tg = dict(tg, soft_bits=torch.tensor(bits))
        want = jq.learned_fake_quant(jnp.asarray(x), jg, J_CFG, False,
                                     train=False)
        got = tq.learned_fake_quant(T(x), tg, T_CFG, False, train=False)
        assert_dequant_equal(got, want, x, jg, train=False)
        uniq = len(np.unique(got.numpy()))
        assert uniq == len(np.unique(np.asarray(want))) <= 2 ** int(bits)
        assert uniq > 2 ** (int(bits) - 1) * 0.5


def case_ste_gradient(rng):
    x = rng.uniform(-1e-4, 1e-4, size=(512,)).astype(np.float32)
    cot = rng.standard_normal(512).astype(np.float32)
    jg, tg = _groups(x, symmetric=False)
    want = jax.grad(lambda v: jnp.sum(jq.learned_fake_quant(
        v, jg, J_CFG, False, train=True) * cot))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(tq.learned_fake_quant(
        xt, tg, T_CFG, False, train=True) * T(cot)), xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), cot)


def case_calibration_tracks_content(rng):
    jg = jq.init_quant_state(J_CFG)["weight"]
    tg = tq.init_quant_state(T_CFG)["weight"]
    batches = [np.float32([-2.0, 3.0]), np.float32([-10.0, 10.0]),
               np.float32([-1.0, 1.0]),
               rng.normal(size=64).astype(np.float32)]
    for i, b in enumerate(batches):
        jg = jq.calibrate(jg, jnp.asarray(b), symmetric=True)
        tg = tq.calibrate(tg, T(b), symmetric=True)
        assert_tree_close(tg, jg, what=f"batch {i}")
        if i == 1:  # a wider batch expands the range at once
            assert float(tg["range_scale"]) == 20.0
    assert float(tg["range_scale"]) > 2.0 and bool(tg["calibrated"])
    ja = {k: v[0] for k, v in jq.init_quant_state(J_CFG)["act"].items()}
    ta = {k: v[0] for k, v in tq.init_quant_state(T_CFG)["act"].items()}
    for i, b in enumerate(batches):
        ja = jq.calibrate(ja, jnp.asarray(b), symmetric=False)
        ta = tq.calibrate(ta, T(b), symmetric=False)
        assert_tree_close(ta, ja, what=f"act batch {i}")


def case_controller_dynamics(rng):
    js, ts = jq.init_quant_state(J_CFG), tq.init_quant_state(T_CFG)
    mgl_j = jq.QuantConfig(n_embed_levels=4, n_act_quantizers=1,
                           target_metric=1.0)
    mgl_t = tq.QuantConfig(n_embed_levels=4, n_act_quantizers=1,
                           target_metric=1.0)
    for cur, (jc, tc) in ((0.5, (J_CFG, T_CFG)), (1.0, (J_CFG, T_CFG)),
                          (10.0, (mgl_j, mgl_t)), (0.97, (mgl_j, mgl_t))):
        jn, jt = jq.acaq_controller_update(js, jnp.asarray(cur, jnp.float32),
                                           jnp.asarray(1.0), jc)
        tn, tt = tq.acaq_controller_update(ts, torch.tensor(cur), 1.0, tc)
        assert_tree_close(tn, jn, what=f"current {cur}")
        np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for _ in range(200):
        js, _ = jq.acaq_controller_update(js, jnp.asarray(0.01, jnp.float32),
                                          jnp.asarray(1.0), J_CFG)
        ts, _ = tq.acaq_controller_update(ts, torch.tensor(0.01), 1.0, T_CFG)
    assert_tree_close(ts, js, what="after 200 shrinks")
    assert float(ts["embed"]["soft_bits"].min()) >= T_CFG.min_bits - 1e-6
    np.testing.assert_allclose(float(tq.average_bits(ts, T_CFG)),
                               float(jq.average_bits(js, J_CFG)), rtol=1e-6)


def case_mdl_closed_loop(rng):
    """The closed loop of test_mdl_fp_anchor_equilibrates..., both
    controllers driven by one seeded signal (the signal the port's own
    bits would give; the states are compared every controller step)."""
    js, ts = jq.init_quant_state(J_CFG), tq.init_quant_state(T_CFG)
    infl = ema = slow = None
    for i in range(0, 1500, 10):
        fp = (0.01 + 0.09 * np.exp(-i / 300.0)) * (
            1.0 + 0.1 * float(rng.standard_normal()))
        bits = float(tq.average_bits(ts, T_CFG))
        q = fp * (1.0 + 30.0 * 2.0 ** (-bits))
        ema = q if ema is None else 0.9 * ema + 0.1 * q
        slow = q if slow is None else 0.99 * slow + 0.01 * q
        ratio = (1.0 + 30.0 * 2.0 ** (-bits)) * (
            1.0 + 0.05 * float(rng.standard_normal()))
        infl = ratio if infl is None else 0.9 * infl + 0.1 * ratio
        signal = np.float32(max(1.0, infl, ema / slow))
        js, _ = jq.acaq_controller_update(js, jnp.asarray(signal),
                                          jnp.asarray(1.0), J_CFG)
        ts, _ = tq.acaq_controller_update(ts, torch.tensor(signal), 1.0,
                                          T_CFG)
        assert_tree_close(ts, js, rtol=1e-5, what=f"step {i}")
    assert T_CFG.min_bits + 0.5 < float(tq.average_bits(ts, T_CFG)) < 14.0


def case_train_state_tracks_loss_ema_min(rng):
    """A quantized step of the port keeps loss_ema (the first step adopts
    the batch loss) and best_loss = its running minimum, at the field's
    loss_ema_decay, and its quantizers calibrate (the MLP's from step 0)."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig
    from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig
    from indoor_nerf_tpu_torch.render.renderer import RenderConfig, draw_render
    from indoor_nerf_tpu_torch.train.step import (
        TrainConfig,
        init_train_state,
        train_step,
    )

    grid = HashGridConfig(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3,
                          n_levels=2, log2_hashmap_size=8,
                          finest_resolution=32)
    fc = FieldConfig(grid=grid, i_embed=1, n_importance=0,
                     use_quantization=True, quant=T_CFG)
    cfg = TrainConfig(render=RenderConfig(field=fc, n_samples=8), near=0.5,
                      far=2.0, n_rand=16, tv_loss_weight=0.0)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    assert state["quant"]["embed"]["soft_bits"].shape == (2,)
    assert torch.isinf(state["loss_ema"]) and torch.isinf(state["infl_ema"])
    batch = {"rays_o": torch.zeros(16, 3),
             "rays_d": torch.cat([torch.zeros(16, 2), torch.ones(16, 1)], -1),
             "target": torch.full((16, 3), 0.25)}
    gen = torch.Generator().manual_seed(1)
    emas, bests, losses = [], [], []
    for _ in range(4):
        state, m = train_step(state, batch, cfg,
                              draws=draw_render(gen, 16, cfg.render))
        emas.append(float(state["loss_ema"]))
        bests.append(float(state["best_loss"]))
        losses.append(float(m["img_loss"]))
    want = [np.float32(losses[0])]
    for l in losses[1:]:
        want.append(np.float32(0.99) * want[-1] + np.float32(0.01) * np.float32(l))
    np.testing.assert_allclose(emas, want, rtol=1e-6)
    np.testing.assert_allclose(bests, np.minimum.accumulate(emas), rtol=1e-6)
    assert bool(state["quant"]["act"]["calibrated"].all())
    assert bool(state["quant"]["weight"]["calibrated"])
    assert not bool(state["quant"]["embed"]["calibrated"].any())  # warmup


def case_layer_factor_varies_deltas(rng):
    js, ts = jq.init_quant_state(J_CFG), tq.init_quant_state(T_CFG)
    jn, _ = jq.acaq_controller_update(js, jnp.asarray(0.5), jnp.asarray(1.0),
                                      J_CFG)
    tn, _ = tq.acaq_controller_update(ts, torch.tensor(0.5), 1.0, T_CFG)
    deltas = tn["embed"]["soft_bits"].numpy() - 8.0
    np.testing.assert_array_equal(deltas, np.asarray(jn["embed"]["soft_bits"]) - 8.0)
    assert len(np.unique(np.round(deltas, 6))) > 1


def case_train_clip_bounds_follow_soft_bits(rng):
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    for soft in (8.49, 12.3, 20.45, 23.4):
        jg, tg = _groups(x, symmetric=False)
        jg = dict(jg, soft_bits=jnp.asarray(soft, jnp.float32))
        tg = dict(tg, soft_bits=torch.tensor(soft))
        want = jq.learned_fake_quant(jnp.asarray(x), jg, J_CFG, False,
                                     train=True)
        got = tq.learned_fake_quant(T(x), tg, T_CFG, False, train=True)
        assert_dequant_equal(got, want, x, jg, train=True, max_share=0.05)
        scale = 1.0 / (2.0 ** soft - 1.0)
        assert float(np.abs(got.numpy() - x).max()) <= scale + 1e-7, soft


def case_train_soft_below_int(rng):
    x = np.linspace(0.0, 1.0, 129, dtype=np.float32)
    jg, tg = _groups(x, symmetric=False)
    jg = dict(jg, soft_bits=jnp.asarray(7.6, jnp.float32))
    tg = dict(tg, soft_bits=torch.tensor(7.6))
    for train, bits in ((True, 7.6), (False, 8.0)):
        want = jq.learned_fake_quant(jnp.asarray(x), jg, J_CFG, False,
                                     train=train)
        got = tq.learned_fake_quant(T(x), tg, T_CFG, False, train=train)
        assert_dequant_equal(got, want, x, jg, train, max_share=0.05)
        assert float(np.abs(got.numpy() - x).max()) <= \
            1.0 / (2.0 ** bits - 1.0) + 1e-7
    # The symmetric weight quantizer too, at soft and rounded bits.
    w = rng.normal(size=(64, 32)).astype(np.float32)
    jw, tw = _groups(w, symmetric=True)
    jw = dict(jw, soft_bits=jnp.asarray(6.0, jnp.float32))
    tw = dict(tw, soft_bits=torch.tensor(6.0))
    for train in (True, False):
        want = jq.learned_fake_quant(jnp.asarray(w), jw, J_CFG, True,
                                     train=train)
        got = tq.learned_fake_quant(T(w), tw, T_CFG, True, train=train)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = {
    "fixed_roundtrip_and_ste": case_fixed_roundtrip_and_ste,
    "small_scale_inputs": case_small_scale_inputs,
    "high_bits_is_identity": case_high_bits_is_identity,
    "unique_values_bounded": case_unique_values_bounded,
    "ste_gradient": case_ste_gradient,
    "calibration_tracks_content": case_calibration_tracks_content,
    "controller_dynamics": case_controller_dynamics,
    "mdl_closed_loop": case_mdl_closed_loop,
    "train_state_tracks_loss_ema_min": case_train_state_tracks_loss_ema_min,
    "layer_factor_varies_deltas": case_layer_factor_varies_deltas,
    "train_clip_bounds_follow_soft_bits": case_train_clip_bounds_follow_soft_bits,
    "train_soft_below_int": case_train_soft_below_int,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantizer_matches_jax(name):
    """Each case of tests/test_quantization.py through both packages."""
    CASES[name](np.random.default_rng(0))


def test_quant_config_refuses_tolerance_below_one():
    with pytest.raises(ValueError, match="mdl_tolerance"):
        tq.QuantConfig(mdl_tolerance=0.9)
    with pytest.raises(ValueError, match="mdl_tolerance"):
        jq.QuantConfig(mdl_tolerance=0.9)


def test_init_quant_state_matches_jax():
    want = jq.init_quant_state(J_CFG)
    got = tq.init_quant_state(T_CFG)
    assert_tree_close(got, want, rtol=0)
    assert tq.PASSTHROUGH_BITS == jq.PASSTHROUGH_BITS
    x = torch.randn(5)
    assert tq.passthrough_quant(x) is x
