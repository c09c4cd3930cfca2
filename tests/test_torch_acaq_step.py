"""Port parity: A-CAQ in the training step and the render, and the int8
gather, against the JAX package, with the JAX draws replayed and the JAX
encode backward through its f32-accumulating Pallas scatter in interpret
mode (as ``test_torch_step_extensions.py`` runs it).

A quantized step is held as the step parity tests hold theirs, loss,
image loss and PSNR within 1e-5 relative, but its moments in norm
(``hold_quantized_step``: each leaf within 1e-3 of its norm; the block
table's also elementwise within 2^-8 / 2^-7 of its largest entry, as
``hold_step``): an activation whose ``h / scale`` lies within an ulp of a
rounding boundary rounds apart where XLA's and torch's sums of ``h``
differ in their last bit, which moves that sample's gradient by one
quantization step. The quantizer state besides: soft bits and the
controller's arithmetic within 1e-6 relative, ``infl_ema`` within 1e-5
relative, the grid's and the weight's running ranges within 1e-6
relative (min and max of table and weight entries), the activations'
within 1e-5 relative (the min and max of ``h``, whose sums XLA and torch
take in different orders: 2.8e-6 measured), ``calibrated`` exactly.
An unquantized int8 step is held as ``hold_step`` holds the flagship's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.ops.blockhash as jbh
from _torch_parity import (
    TINY_FLAGSHIP,
    TINY_HASH,
    configs,
    hold_step,
    one_step,
)
from indoor_nerf_tpu.render.renderer import render_image as j_render_image
from indoor_nerf_tpu.train.step import init_train_state as j_init
from indoor_nerf_tpu_torch import bridge
from indoor_nerf_tpu_torch.models import field as tfield
from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train.step import acaq_active

torch.set_num_threads(1)
T = torch.from_numpy
QUANT = ["--use_quantization"]
# The controller from step 300 (600 is a controller step, 605 is not).
ACAQ = QUANT + ["--use_acaq", "--acaq_start_iter", "300"]


@pytest.fixture(autouse=True)
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernel."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def _soft_bits(bits):
    """A state edit: the grid levels' soft bits set to ``bits``, the MLP's
    left at their 8."""
    def edit(jstate):
        q = dict(jstate["quant"])
        q["embed"] = dict(q["embed"], soft_bits=jnp.asarray(bits, jnp.float32))
        return {**jstate, "quant": q}
    return edit


def _calibrated(jstate):
    """A state edit: every quantizer calibrated as a trained run leaves it
    (the act and weight ranges of one earlier call), an MDL inflation EMA
    in progress and loss EMAs of a run that is improving."""
    q = jax.tree_util.tree_map(np.asarray, jstate["quant"])
    q["act"] = dict(q["act"], running_min=np.float32([0.0]),
                    running_max=np.float32([2.5]),
                    range_scale=np.float32([2.5]), v_max=np.float32([2.5]),
                    calibrated=np.array([True]))
    q["weight"] = dict(q["weight"], running_min=np.float32(-0.4),
                       running_max=np.float32(0.45),
                       range_scale=np.float32(0.9), calibrated=np.array(True))
    return {**jstate, "quant": jax.tree_util.tree_map(jnp.asarray, q),
            "infl_ema": jnp.asarray(1.02, jnp.float32),
            "loss_ema": jnp.asarray(0.09, jnp.float32),
            "loss_ema_slow": jnp.asarray(0.1, jnp.float32)}


def hold_quantized_step(jm, tm, want, got, block_table):
    """Loss, image loss and PSNR within 1e-5 relative; every moment leaf
    within 1e-3 of its norm; the block table's moments also elementwise as
    ``hold_step`` holds them (module docstring)."""
    for k in ("loss", "img_loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for key_, tol in (("mu", 2.0 ** -8), ("nu", 2.0 ** -7)):
        g = jax.tree_util.tree_leaves(got["opt"][key_])
        w = jax.tree_util.tree_flatten_with_path(want["opt"][key_])[0]
        assert len(g) == len(w)
        for gl, (path, wl) in zip(g, w):
            what = key_ + jax.tree_util.keystr(path)
            assert np.linalg.norm(gl - wl) <= 1e-3 * np.linalg.norm(wl), what
        if block_table:
            wt = want["opt"][key_]["table"]
            np.testing.assert_allclose(got["opt"][key_]["table"], wt, rtol=0,
                                       atol=tol * float(np.abs(wt).max()))


def hold_quant(want, got, infl_rtol=1e-5):
    """The quantizer state and infl_ema at the module's tolerances."""
    wq, gq = want["quant"], got["quant"]
    assert set(gq) == set(wq)
    for group in wq:
        assert set(gq[group]) == set(wq[group]), group
        for k, w in wq[group].items():
            g, w = gq[group][k], np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (group, k)
            if w.dtype == np.bool_:
                np.testing.assert_array_equal(g, w, err_msg=f"{group}.{k}")
            else:
                rtol = 1e-5 if group == "act" and k != "soft_bits" else 1e-6
                np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                           err_msg=f"{group}.{k}")
    np.testing.assert_allclose(got["infl_ema"], want["infl_ema"],
                               rtol=infl_rtol)
    for k in ("loss_ema", "loss_ema_slow", "best_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# name: (flags, step, state edit, block table?)
STEPS = {
    # Before the grid quantizer's warmup: the block table's live range is
    # recorded, nothing of it quantized; the MLP's quantizers act.
    "block_warmup": (TINY_FLAGSHIP + QUANT, 3, None, True),
    # After it, at 8 bits and at soft bits off the integer grid.
    "block_quantized": (TINY_FLAGSHIP + QUANT, 600, None, True),
    "block_soft_bits": (TINY_FLAGSHIP + QUANT, 600,
                        _soft_bits([7.0, 6.0, 5.0, 4.0]), True),
    # The hash grid with the fine pass: the corner quantizer (warmup passed
    # and not), the coarse then the fine MLP calibrating in turn.
    "hash_warmup": (TINY_HASH + QUANT, 3, None, False),
    "hash_quantized": (TINY_HASH + QUANT, 600, None, False),
    # The ray-structured encodes, which quantize the table too.
    "block_grouped": (TINY_FLAGSHIP + QUANT + ["--ray_groups", "2,2,1,1"],
                      600, None, True),
    "block_strided": (TINY_FLAGSHIP + QUANT + ["--ray_strides", "2,2,1,1"],
                      600, None, True),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_quantized_step_matches_jax(name):
    flags, step, edit, block = STEPS[name]
    jm, tm, before, want, got, _ = one_step(flags, step=step, edit=edit)
    hold_quantized_step(jm, tm, want, got, block_table=block)
    hold_quant(want, got)
    cal = got["quant"]["embed"]["calibrated"]
    assert cal.all() == (step >= 500)
    assert got["quant"]["act"]["calibrated"].all()
    # The quantizers act: the loss differs from the unquantized step's
    # after the warmup (the MLP's quantizers alone act before it).
    plain = one_step([f for f in flags if f != "--use_quantization"],
                     step=step)[1]
    assert abs(float(tm["loss"]) - float(plain["loss"])) > 1e-7


# name: (flags, state edit, block table?)
CONTROLLER = {
    "block_mdl": (TINY_FLAGSHIP + ACAQ, _calibrated, True),
    "block_mgl": (TINY_FLAGSHIP + ACAQ + ["--target_metric", "0.05",
                                          "--bit_penalty", "0.01"],
                  _calibrated, True),
    "block_mdl_tolerance": (TINY_FLAGSHIP + ACAQ + ["--mdl_tolerance",
                                                    "1.3"], _calibrated, True),
    "hash_mdl": (TINY_HASH + ACAQ, _calibrated, False),
    "block_int8_mdl": (TINY_FLAGSHIP + ACAQ + ["--block_io", "int8"],
                       _calibrated, True),
}


@pytest.mark.parametrize("name", sorted(CONTROLLER))
def test_controller_step_matches_jax(name):
    """A controller step after the warmup (600): the quantized forward, in
    MDL mode the bypassed forward on the same draws, the inflation EMA,
    the trajectory ratio and the controller's update, against JAX."""
    flags, edit, block = CONTROLLER[name]
    tcfg = configs(flags)[1]
    assert acaq_active(tcfg, 600) and not acaq_active(tcfg, 605)
    assert not acaq_active(tcfg, 290)
    jm, tm, before, want, got, _ = one_step(flags, step=600, edit=edit)
    hold_quantized_step(jm, tm, want, got, block_table=block)
    hold_quant(want, got)
    moved = got["quant"]["embed"]["soft_bits"] - before["quant"]["embed"]["soft_bits"]
    assert np.abs(moved).min() > 0.05  # the controller acted
    if "--target_metric" in flags:  # MGL reads no inflation
        assert float(got["infl_ema"]) == float(before["infl_ema"])
    else:
        assert float(got["infl_ema"]) != float(before["infl_ema"])
    # Off a controller step nothing moves the bits.
    _, _, before5, want5, got5, _ = one_step(flags, step=605, edit=edit)
    np.testing.assert_array_equal(got5["quant"]["embed"]["soft_bits"],
                                  before5["quant"]["embed"]["soft_bits"])
    hold_quant(want5, got5)


@pytest.mark.parametrize("block_size", [3, 4])
def test_int8_encode_forward_and_gradient_match_jax(rng, block_size):
    """The int8 gather's encode (tests/test_blockhash.py:178 through both
    packages): features within 1e-5 of the JAX ones (the same dequantized
    rows, contracted in another order) and within half a quantization step
    of the f32 encode; the table gradient, the straight-through bf16
    scatter of the cotangent of sum(f^2), within the bf16 tolerance of the
    block-table step tests (2^-8 of the largest entry, 1e-3 in norm); no
    gradient w.r.t. the points."""
    kw = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3),
              n_levels=4, n_features_per_level=2, log2_rows=6,
              base_resolution=4, finest_resolution=32, block_size=block_size,
              gather_dtype="int8", scatter_dtype="bfloat16")
    jcfg, tcfg = jbh.BlockHashConfig(**kw), tbh.BlockHashConfig(**kw)
    table = (np.asarray(jbh.init_block_table(jax.random.PRNGKey(0), jcfg))
             * 1e4).astype(np.float32)
    x = rng.uniform(-0.95, 0.95, size=(512, 3)).astype(np.float32)
    f8, m8 = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table), jcfg)
    tt = T(table.copy()).requires_grad_(True)
    xt = T(x).requires_grad_(True)
    got, keep = tbh.block_hash_encode(xt, tt, tcfg)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(m8))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(f8),
                               rtol=1e-5, atol=1e-5)
    f32, _ = tbh.block_hash_encode(T(x), T(table), tbh.BlockHashConfig(
        **dict(kw, gather_dtype="float32", scatter_dtype="float32")))
    step = np.abs(table).max() / 127.0
    err = np.abs(got.detach().numpy() - f32.numpy()).max()
    assert 0.0 < err <= step
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jbh.block_hash_encode(jnp.asarray(x), t, jcfg)[0] ** 2))(
            jnp.asarray(table)))
    (g,) = torch.autograd.grad(torch.sum(got ** 2), tt)
    scale = np.abs(want).max()
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=2.0 ** -8 * scale)
    assert np.linalg.norm(g.numpy() - want) <= 1e-3 * np.linalg.norm(want)
    assert xt.grad is None


INT8_STEPS = {
    "flat": [],
    "grouped": ["--ray_groups", "2,2,1,1"],
    "strided": ["--ray_strides", "2,2,1,1"],
    # JAX's int8 forward under --use_pallas contracts with tile_interp; the
    # port's with tent_contract: the same function.
    "pallas": ["--use_pallas"],
}


@pytest.mark.parametrize("name", sorted(INT8_STEPS))
def test_int8_step_matches_jax(name):
    """One flagship step with ``--block_io int8`` (bf16 scatter) on each
    route JAX runs it, alone and with A-CAQ after the warmup."""
    flags = TINY_FLAGSHIP + ["--block_io", "int8"] + INT8_STEPS[name]
    jm, tm, _, want, got, _ = one_step(flags)
    hold_step(jm, tm, want, got, block_table=True)
    jm, tm, _, want, got, _ = one_step(flags + QUANT, step=600)
    hold_quantized_step(jm, tm, want, got, block_table=True)
    hold_quant(want, got)


@pytest.mark.parametrize("flags", [TINY_FLAGSHIP, TINY_HASH,
                                   TINY_FLAGSHIP + ["--block_io", "int8"]],
                         ids=["block", "hash_fine", "block_int8"])
def test_eval_render_with_calibrated_quant_state(flags):
    """A test-mode render of a quantized field with a calibrated quantizer
    state (bits off the integer grid, which evaluation rounds; one grid
    level uncalibrated) against JAX's.

    The field's output on JAX's own sample points (its ``render_rays``
    with ``retraw``; the last pass's) is held within 1e-5 of the largest
    entry. The image is held within 1e-3 on average and 2e-2 at most: the
    two packages' inverse-CDF samples differ by ~4e-6 in position, on this
    steep random table (5 or 20 wide, so that it is opaque) that moves the
    features by ~1e-3, and where that carries an activation across a
    rounding boundary of its quantizer (a step of 2.5 / 63) the sample's
    output jumps by one step. The quantizers must move the image by more
    than 1e-2, and ``serving_params`` packs the quantized block table."""
    from indoor_nerf_tpu.ops.rays import get_rays
    from indoor_nerf_tpu.render.renderer import _prepare_rays
    from indoor_nerf_tpu.render.renderer import render_rays as j_render_rays

    jcfg, tcfg, scene = configs(flags + QUANT)
    jstate = _calibrated(j_init(jax.random.PRNGKey(0), jcfg))
    q = jax.tree_util.tree_map(np.asarray, jstate["quant"])
    q["embed"]["soft_bits"] = np.float32([6.4, 5.6, 7.5, 5.2])
    q["embed"]["calibrated"] = np.array([True, True, False, True])
    q["act"]["soft_bits"] = np.float32([5.6])
    q["weight"]["soft_bits"] = np.float32(6.4)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    width = 20.0 if flags is TINY_HASH else 5.0
    params["table"] = (width * rng.standard_normal(params["table"].shape)
                       ).astype(np.float32)
    tstate = bridge.state_from_numpy({
        **jax.tree_util.tree_map(np.asarray, {k: jstate[k] for k in (
            "opt", "occ", "step", "best_loss", "loss_ema", "loss_ema_slow",
            "infl_ema")}), "params": params, "quant": q})
    fc = tcfg.render.field
    H = W = 16
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    jq = jax.tree_util.tree_map(jnp.asarray, q)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    occ = jstate["occ"]

    ro, rd = get_rays(H, W, jnp.asarray(K, jnp.float32),
                      jnp.asarray(c2w, jnp.float32))
    ro, rd, vd, na, fa = _prepare_rays(ro, rd, H, W, K[0][0], scene.near,
                                       scene.far, jcfg.render)
    out, _ = j_render_rays(None, jp, ro, rd, vd, na, fa,
                           jcfg.render.test_mode(), quant_state=jq,
                           train=False, step=None, occ_state=occ, retraw=True)
    sp = tfield.serving_params(tstate["params"], fc, tstate["quant"])
    with torch.inference_mode():
        raw, _ = tfield.query_field(
            sp, "fine" if "fine" in sp else "coarse", T(np.array(out["pts"])),
            T(np.array(vd)), fc, None, tstate["quant"], train=False)
    want_raw = np.asarray(out["raw"])
    np.testing.assert_allclose(raw.numpy(), want_raw, rtol=0,
                               atol=1e-5 * np.abs(want_raw).max())

    want = j_render_image(jp, H, W, K, c2w, scene.near, scene.far,
                          jcfg.render, quant_state=jq, tile_rays=128,
                          occ_state=occ)
    got = render_image(tstate["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=128, occ_state=tstate["occ"],
                       quant_state=tstate["quant"])
    plain = j_render_image(jp, H, W, K, c2w, scene.near, scene.far,
                           jcfg.render, tile_rays=128, occ_state=occ)
    assert want["acc_map"].max() > 0.3
    for k in ("rgb_map", "acc_map"):
        err = np.abs(got[k] - want[k])
        assert err.mean() <= 1e-3 and err.max() <= 2e-2, (k, err.mean(),
                                                          err.max())
    assert np.abs(plain["rgb_map"] - want["rgb_map"]).max() > 1e-2
    if fc.i_embed == 3:
        tq, _ = tfield.quantize_block_table(
            tstate["params"]["table"].detach(), tstate["quant"], fc,
            train=False, step=None)
        assert torch.equal(sp["table"], tbh.gather_table(tq, fc.block_grid))


@pytest.mark.parametrize("flags", [TINY_FLAGSHIP, TINY_HASH],
                         ids=["block", "hash"])
def test_bytes_per_ray_counts_the_activation_quantizer(flags):
    """The render's tile model: a quantized grid field holds, per sample,
    ``ACT_QUANT_COPIES`` f32 copies of a hidden layer's activations more
    than the same field unquantized (the activation quantizer's
    temporaries, which (aq1) measured on the card)."""
    from indoor_nerf_tpu_torch.render import renderer

    plain = configs(flags)[1].render
    quant = configs(flags + QUANT)[1].render
    n = (plain.n_occ_samples if plain.occupancy is not None
         else plain.n_samples + plain.n_importance)
    extra = n * renderer.ACT_QUANT_COPIES * 4 * quant.field.hidden_dim
    assert extra > 0
    assert renderer.bytes_per_ray(quant) == renderer.bytes_per_ray(plain) + extra
