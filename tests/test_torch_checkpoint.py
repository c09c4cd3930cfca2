"""The port's checkpoints (utils/checkpoint.py), the import of a checkpoint
of the JAX package (bridge.load_jax_checkpoint), and the trainer's and the
server's use of both, on the CPU at the tiny flagship size."""

import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, TINY_FLAGSHIP, both_train_states, configs
from indoor_nerf_tpu.render.renderer import render_image as j_render_image
from indoor_nerf_tpu.train.config import parse_args as j_parse_args
from indoor_nerf_tpu.train.trainer import mangle_expname as j_mangle_expname
from indoor_nerf_tpu.utils import checkpoint as jckpt
from indoor_nerf_tpu_torch import bridge, serve
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import init_train_state
from indoor_nerf_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, _ROOT)
                 for p in glob.glob(os.path.join(_ROOT, "configs", "*.txt")))
SMALL = TINY_FLAGSHIP + CPU + ["--N_rand", "64", "--i_print", "4",
                               "--lrate", "0.01"]


def fresh_state(seed=0):
    _, tcfg, _ = configs()
    return init_train_state(torch.Generator().manual_seed(seed), tcfg), tcfg


def trained_state(seed=0, steps=2):
    """A state whose every leaf differs from a fresh one's (moments, grid,
    counters and loss scalars included)."""
    state, _ = fresh_state(seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for t in ckpt._tensor_leaves(state).values():
            t.copy_(torch.rand(t.shape, generator=g))
    state["loss_ema"] = torch.tensor(0.25)
    state["step"], state["opt"]["step"] = steps, steps
    return state


def assert_states_equal(a, b):
    la, lb = ckpt._tensor_leaves(a), ckpt._tensor_leaves(b)
    assert set(la) == set(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name], lb[name]), name
    assert (a["step"], a["opt"]["step"]) == (b["step"], b["opt"]["step"])


def ckpt_files(logdir):
    """The checkpoint files of a run directory (which also holds the run's
    args.txt, metrics/ and pickles)."""
    return sorted(f for f in os.listdir(logdir) if f.endswith(".ckpt"))


def run_dir(tmp_path, name="run"):
    return ["--basedir", str(tmp_path / "logs"), "--expname", name]


def test_round_trip_is_bit_for_bit_and_leaves_no_tmp(tmp_path):
    state = trained_state(steps=7)
    path = ckpt.save_checkpoint(str(tmp_path / "run"), 7, state)
    assert os.path.basename(path) == "000007.ckpt"
    assert os.listdir(tmp_path / "run") == ["000007.ckpt"]  # no .tmp left
    template, _ = fresh_state(seed=1)
    restored = ckpt.restore_checkpoint(path, template)
    assert restored is template
    assert_states_equal(restored, state)
    assert all(t.requires_grad for t in
               ckpt.named_leaves(restored["params"]).values())


def test_payload_is_plain_tensors_and_ints(tmp_path):
    """Readable with ``weights_only=True``: no pickled classes."""
    path = ckpt.save_checkpoint(str(tmp_path), 3, trained_state(steps=3))
    payload = torch.load(path, weights_only=True)
    assert payload["format"] == ckpt.FORMAT and payload["step"] == 3
    assert payload["opt.step"] == 3
    kinds = {type(v) for k, v in payload.items()
             if k not in ("format", "step", "opt.step")}
    assert kinds == {torch.Tensor}
    assert {"params.table", "params.coarse.sigma_net.0.w", "opt.mu.table",
            "opt.nu.coarse.color_net.2.w", "occ.density", "best_loss",
            "loss_ema", "loss_ema_slow"} <= set(payload)


def test_best_checkpoint_is_kept_out_of_auto_resume(tmp_path, capsys):
    logdir = str(tmp_path)
    ckpt.save_checkpoint(logdir, 5, trained_state(steps=5))
    ckpt.save_checkpoint(logdir, 12, trained_state(seed=2, steps=12))
    ckpt.save_best_checkpoint(logdir, trained_state(seed=3, steps=9))
    (tmp_path / "notes.txt").write_text("x")
    assert sorted(os.listdir(logdir)) == ["000005.ckpt", "000012.ckpt",
                                          "best.ckpt", "notes.txt"]
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(logdir)] == \
        ["000005.ckpt", "000012.ckpt"]
    assert ckpt.list_checkpoints(str(tmp_path / "absent")) == []
    state = ckpt.maybe_resume(logdir, fresh_state()[0])
    assert state["step"] == 12
    text = capsys.readouterr().out
    assert "Found ckpts" in text and "Resumed at step 12" in text
    assert "Reloading from " + os.path.join(logdir, "000012.ckpt") in text


@pytest.mark.parametrize("ft_path,no_reload,step", [
    (None, False, 5), ("None", False, 5), ("best", False, 9),
    ("best", True, 0), (None, True, 0)])
def test_maybe_resume_ft_path_and_no_reload(tmp_path, ft_path, no_reload, step):
    logdir = str(tmp_path)
    ckpt.save_checkpoint(logdir, 5, trained_state(steps=5))
    best = ckpt.save_best_checkpoint(logdir, trained_state(seed=3, steps=9))
    state = ckpt.maybe_resume(logdir, fresh_state()[0],
                              best if ft_path == "best" else ft_path, no_reload)
    assert state["step"] == step


def test_maybe_resume_without_checkpoints_keeps_the_state(tmp_path, capsys):
    state, _ = fresh_state()
    assert ckpt.maybe_resume(str(tmp_path / "none"), state) is state
    assert state["step"] == 0
    assert "Found ckpts []" in capsys.readouterr().out


@pytest.mark.parametrize("leaf,change,match", [
    ("params.table", lambda t: t[:-1], "leaf 'params.table' is torch.float32"),
    ("opt.nu.coarse.sigma_net.0.w", lambda t: t.T.contiguous(),
     "leaf 'opt.nu.coarse.sigma_net.0.w'"),
    ("occ.density", lambda t: t.double(), "leaf 'occ.density' is torch.float64"),
])
def test_restore_names_the_leaf_that_does_not_fit(tmp_path, leaf, change, match):
    path = ckpt.save_checkpoint(str(tmp_path), 1, trained_state())
    payload = torch.load(path, weights_only=True)
    payload[leaf] = change(payload[leaf])
    torch.save(payload, path)
    with pytest.raises(ValueError, match=match):
        ckpt.restore_checkpoint(path, fresh_state()[0])


def test_restore_refuses_missing_and_unknown_params_and_other_files(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 1, trained_state())
    payload = torch.load(path, weights_only=True)
    lost = dict(payload)
    del lost["params.coarse.color_net.1.w"]
    torch.save(lost, path)
    with pytest.raises(ValueError, match="no leaf 'params.coarse.color_net.1.w'"):
        ckpt.restore_checkpoint(path, fresh_state()[0])
    torch.save({**payload, "params.fine.sigma_net.0.w": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="'params.fine.sigma_net.0.w' has no place"):
        ckpt.restore_checkpoint(path, fresh_state()[0])
    torch.save({"format": "other"}, path)
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        ckpt.restore_checkpoint(path, fresh_state()[0])


def test_missing_optional_keys_keep_the_template(tmp_path):
    """A file without the moments, the grid or the counters restores the
    params and leaves the rest as the template had it."""
    saved = trained_state(steps=4)
    path = ckpt.save_checkpoint(str(tmp_path), 4, saved)
    payload = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in payload.items()
                if k == "format" or k.startswith("params.")}, path)
    template, _ = fresh_state(seed=1)
    density = template["occ"]["density"].clone()
    restored = ckpt.restore_checkpoint(path, template)
    assert torch.equal(restored["params"]["table"], saved["params"]["table"])
    assert torch.equal(restored["occ"]["density"], density)
    assert restored["step"] == 0 and restored["opt"]["step"] == 0
    assert float(restored["opt"]["mu"]["table"].abs().max()) == 0.0
    assert torch.isinf(restored["loss_ema"])


def jax_checkpoint(tmp_path, steps=3, **extra):
    """A checkpoint written by the JAX package's save_checkpoint after
    ``steps`` of its own train steps; returns (path, JAX state, configs)."""
    from _torch_parity import jax_batch_sampler, jax_step_fn

    jcfg, tcfg, scene = configs()
    jstate, _ = both_train_states(jcfg)
    sampler, step_fn = jax_batch_sampler(scene, 64), jax_step_fn(jcfg)
    key = jax.random.PRNGKey(1)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        b = sampler.next()
        jstate, _ = step_fn(jstate, {k: jnp.asarray(b[k]) for k in
                                     ("rays_o", "rays_d", "target")}, sub)
    jstate = {**jstate, **extra}
    return jckpt.save_checkpoint(str(tmp_path / "jax"), steps, jstate), \
        jstate, (jcfg, tcfg, scene)


def test_jax_checkpoint_imports_leaf_for_leaf(tmp_path):
    path, jstate, _ = jax_checkpoint(tmp_path)
    tree = bridge.load_jax_checkpoint(path)
    assert set(tree) == {"params", "opt", "occ", "step", "best_loss",
                         "loss_ema", "loss_ema_slow"}
    assert isinstance(tree["params"]["coarse"]["sigma_net"], list)
    restored = ckpt.restore_checkpoint(path, fresh_state(seed=5)[0])
    assert restored["step"] == 3 and restored["opt"]["step"] == 3
    got = bridge.state_to_numpy(restored)
    want = jax.tree_util.tree_map(np.asarray, {k: jstate[k] for k in tree})
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                          jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(kp))


def test_jax_checkpoint_renders_the_same_image(tmp_path):
    """Port and JAX render the same image from one JAX checkpoint, at the
    tolerance of tests/test_torch_render.py::test_render_image_matches_jax
    (1e-3 on rgb and acc; an O(1) table so the rays are not transparent)."""
    _, jstate, (jcfg, tcfg, scene) = jax_checkpoint(tmp_path, steps=0)
    rng = np.random.default_rng(0)
    table = 5.0 * rng.standard_normal(jstate["params"]["table"].shape)
    jstate["params"]["table"] = jnp.asarray(table, jnp.float32)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    restored = ckpt.restore_checkpoint(path, fresh_state(seed=5)[0])
    H = W = 20
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=256,
                          occ_state=jstate["occ"])
    got = render_image(restored["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=256, occ_state=restored["occ"])
    assert want["acc_map"].max() > 0.5
    np.testing.assert_allclose(got["rgb_map"], want["rgb_map"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["acc_map"], want["acc_map"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("key", ["ema", "quant"])
def test_jax_checkpoint_with_trained_extensions_is_refused(tmp_path, key):
    """Trained A-CAQ state is never dropped silently: the import names the
    item that brings it. A trained params EMA is imported: into a state
    built with ``--ema_decay`` it equals the JAX state's EMA bit for bit,
    and a state without one refuses it rather than drop it."""
    if key == "quant":
        extra = {key: {"table": jnp.ones((4, 4), jnp.float32)}}
        path, _, _ = jax_checkpoint(tmp_path, steps=0, **extra)
        with pytest.raises(NotImplementedError, match="'quant'.*Queue 1 item 5b"):
            bridge.load_jax_checkpoint(path)
        with pytest.raises(NotImplementedError, match="Queue 1 item 5b"):
            ckpt.restore_checkpoint(path, fresh_state()[0])
        return
    from _torch_parity import jax_batch_sampler, jax_step_fn
    from indoor_nerf_tpu.train.step import init_train_state as j_init

    flags = TINY_FLAGSHIP + ["--ema_decay", "0.9"]
    jcfg, tcfg, scene = configs(flags)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    sampler, step_fn = jax_batch_sampler(scene, 64), jax_step_fn(jcfg)
    key_ = jax.random.PRNGKey(1)
    for _ in range(7):  # RAdam moves the params (and so the EMA) at 6 and 7
        key_, sub = jax.random.split(key_)
        b = sampler.next()
        jstate, _ = step_fn(jstate, {k: jnp.asarray(b[k]) for k in
                                     ("rays_o", "rays_d", "target")}, sub)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 7, jstate)
    want = jax.tree_util.tree_map(np.asarray, jstate["ema"])
    assert not np.array_equal(want["table"], np.asarray(jstate["params"]["table"]))
    template = init_train_state(torch.Generator().manual_seed(5), tcfg)
    got = bridge.state_to_numpy(ckpt.restore_checkpoint(path, template))["ema"]
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                          jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(kp))
    with pytest.raises(ValueError, match="'ema.table' has no place"):
        ckpt.restore_checkpoint(path, fresh_state()[0])


def test_jax_normals_checkpoint_round_trips_and_renders(tmp_path):
    """A field with normal nets (``--predict_normals``) and a params EMA,
    written by the JAX package: every leaf imports bit for bit (the
    ``normal_net`` layers with their biases), goes back to the same numpy
    tree, and the port renders the image JAX renders (the normals are
    computed and not served, as in JAX), at the tolerance of
    ``test_jax_checkpoint_renders_the_same_image``."""
    from indoor_nerf_tpu.train.step import init_train_state as j_init

    flags = TINY_FLAGSHIP + ["--predict_normals", "--ema_decay", "0.5"]
    jcfg, tcfg, scene = configs(flags)
    jstate = j_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    table = 5.0 * rng.standard_normal(jstate["params"]["table"].shape)
    jstate["params"] = {**jstate["params"],
                        "table": jnp.asarray(table, jnp.float32)}
    jstate["ema"] = jax.tree_util.tree_map(lambda a: a * 0.5, jstate["params"])
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 4, jstate)
    restored = ckpt.restore_checkpoint(
        path, init_train_state(torch.Generator().manual_seed(5), tcfg))
    assert restored["params"]["coarse"].predict_normals
    got = bridge.state_to_numpy(restored)
    for key in ("params", "ema"):
        want = jax.tree_util.tree_map(np.asarray, jstate[key])
        assert len(want["coarse"]["normal_net"]) == 2
        for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                              jax.tree_util.tree_leaves(got[key])):
            np.testing.assert_array_equal(g, w, err_msg=key + jax.tree_util.keystr(kp))
    back = bridge.state_to_numpy(bridge.state_from_numpy(got))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    H = W = 16
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=128,
                          occ_state=jstate["occ"])
    out = render_image(restored["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=128, occ_state=restored["occ"])
    assert want["acc_map"].max() > 0.5
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-3, err_msg=k)


def test_flax_lists_come_back_in_index_order():
    """flax writes a list as a map keyed "0", "1", ...: twelve entries must
    not come back in string order ("10" < "2")."""
    node = {"layers": {str(i): {"w": np.full(1, i)} for i in range(12)},
            "names": {"a": 1, "0": 2}}
    tree = bridge._flax_tree(node)
    assert [int(l["w"][0]) for l in tree["layers"]] == list(range(12))
    assert tree["names"] == {"a": 1, "0": 2}  # not a list: keys are not 0..n-1


def test_import_says_so_when_msgpack_is_absent(tmp_path, monkeypatch):
    import sys

    path, _, _ = jax_checkpoint(tmp_path, steps=0)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="needs the 'msgpack' package"):
        bridge.load_jax_checkpoint(path)


@pytest.mark.parametrize("path", CONFIGS)
def test_mangle_expname_is_the_jax_one(path):
    full = os.path.join(_ROOT, path)
    want = j_mangle_expname(j_parse_args(["--config", full]))
    assert trainer.mangle_expname(parse_args(["--config", full])) == want
    args = parse_args(["--config", full, "--basedir", "/x"])
    assert trainer.logdir_of(args) == os.path.join("/x", want)


def test_changed_hyper_parameter_is_a_fresh_logdir(tmp_path):
    a = parse_args(SMALL + run_dir(tmp_path))
    b = parse_args(SMALL + run_dir(tmp_path) + ["--lrate", "0.02"])
    assert trainer.logdir_of(a) != trainer.logdir_of(b)
    assert trainer.logdir_of(parse_args(SMALL)) is None  # no --expname


def test_train_saves_resumes_and_continues(tmp_path, capsys):
    flags = SMALL + run_dir(tmp_path)
    first = trainer.train(parse_args(flags + ["--n_iters", "8", "--i_weights", "4"]))
    assert ckpt_files(first["logdir"]) == ["000004.ckpt", "000008.ckpt"]
    capsys.readouterr()
    second = trainer.train(parse_args(flags + ["--n_iters", "12"]))
    text = capsys.readouterr().out
    assert "Reloading from " + os.path.join(first["logdir"], "000008.ckpt") in text
    assert "training 4 steps (from step 8)" in text
    assert len(second["losses"]) == 4 and second["state"]["step"] == 12
    assert "000012.ckpt" in ckpt_files(first["logdir"])
    # Nothing left to do: no step, the checkpoint stays.
    third = trainer.train(parse_args(flags + ["--n_iters", "12"]))
    assert third["losses"] == [] and third["state"]["step"] == 12
    # --no_reload starts afresh in the same directory.
    fresh = trainer.train(parse_args(flags + ["--n_iters", "2", "--no_reload"]))
    assert len(fresh["losses"]) == 2 and fresh["state"]["step"] == 2


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """8 steps, a checkpoint, 6 more from a new process's point of view,
    against 14 uninterrupted: the sampler's batches and the generator's
    draws are replayed up to the resumed step, so on the CPU (one thread,
    sums in a fixed order) losses and every leaf agree bit for bit."""
    whole = trainer.train(parse_args(SMALL + run_dir(tmp_path, "whole")
                                     + ["--n_iters", "14"]))
    flags = SMALL + run_dir(tmp_path, "cut")
    trainer.train(parse_args(flags + ["--n_iters", "8"]))
    rest = trainer.train(parse_args(flags + ["--n_iters", "14"]))
    assert rest["losses"] == whole["losses"][8:]
    assert_states_equal(rest["state"], whole["state"])


def test_train_resumes_from_a_jax_checkpoint(tmp_path, capsys):
    path, _, _ = jax_checkpoint(tmp_path, steps=3)
    out = trainer.train(parse_args(SMALL + ["--n_iters", "5", "--ft_path", path]))
    assert "Resumed at step 3" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and out["state"]["step"] == 5
    assert out["logdir"] is None  # no --expname: nothing written


def test_train_without_expname_writes_nothing_and_says_so(tmp_path, capsys,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer.train(parse_args(SMALL + ["--n_iters", "1"]))
    assert "no --expname: no checkpoint is written or resumed" in \
        capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def test_train_saves_before_raising_on_a_non_finite_loss(tmp_path, monkeypatch):
    real = trainer.train_step

    def poisoned(state, batch, cfg, gen, **kw):
        state, metrics = real(state, batch, cfg, gen, **kw)
        if state["step"] == 4:
            metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    monkeypatch.setattr(trainer, "train_step", poisoned)
    args = parse_args(SMALL + run_dir(tmp_path) + ["--n_iters", "8"])
    # Step 4 prints (SMALL's --i_print 4), so it reads its own loss at
    # once, and the state saved is step 4's.
    with pytest.raises(FloatingPointError, match="non-finite loss nan at "
                       "iteration 4; state of step 4 saved to .*000004.ckpt"):
        trainer.train(args)
    assert ckpt_files(trainer.logdir_of(args)) == ["000004.ckpt"]


def serve_args(flags, **kw):
    return argparse.Namespace(width=16, height=16, train_args=["--"] + flags, **kw)


def psnr_against_training_view(render, scene):
    """Mean PSNR of the server's renders of three training poses against
    the training images (16 x 16, area-averaged)."""
    out = []
    for i in scene.i_train[:3]:
        maps, _ = render(scene.poses[i])
        H = scene.images.shape[1]
        gt = scene.images[i].reshape(16, H // 16, 16, H // 16, 3).mean((1, 3))
        out.append(-10 * np.log10(np.mean((maps["rgb_map"] - gt) ** 2)))
    return float(np.mean(out))


def test_trained_checkpoint_serves_a_better_image(tmp_path, capsys):
    """Train, save, reload in ``serve.build``: the served PSNR against the
    training images is above the untrained field's (the mirror of
    tests/test_blockhash.py::test_blockhash_training_converges), the
    reported step is the checkpoint's, and the UNTRAINED warning goes."""
    from indoor_nerf_tpu_torch.data.load import load_dataset

    flags = TINY_FLAGSHIP + CPU + ["--N_rand", "256", "--lrate", "0.01",
                                   "--i_print", "50"] + run_dir(tmp_path)
    scene = load_dataset(parse_args(flags))
    render0, step0, _ = serve.build(serve_args(flags))
    assert step0 == 0 and "UNTRAINED" in capsys.readouterr().out
    before = psnr_against_training_view(render0, scene)
    trainer.train(parse_args(flags + ["--n_iters", "150"]))
    capsys.readouterr()
    render1, step1, _ = serve.build(serve_args(flags))
    assert step1 == 150 and "UNTRAINED" not in capsys.readouterr().out
    after = psnr_against_training_view(render1, scene)
    assert after > before + 2.0, (before, after)


def test_server_packs_the_restored_table(tmp_path):
    """The packed copy the server renders from is made after the resume: a
    served image equals a render of the checkpoint's own state, and differs
    from the seeded field's."""
    from indoor_nerf_tpu_torch.data.load import load_dataset

    flags = TINY_FLAGSHIP + CPU + run_dir(tmp_path)
    cli = parse_args(flags)
    scene = load_dataset(cli)
    state = trained_state(steps=6)
    with torch.no_grad():
        state["params"]["table"].mul_(4.0).sub_(2.0)  # O(1): opaque rays
        for layer in state["params"]["coarse"].color_net:
            layer["w"].sub_(0.5)  # colours off the sigmoid's plateau
        state["occ"]["density"].fill_(1.0)
    ckpt.save_checkpoint(trainer.logdir_of(cli), 6, state)
    render, step, _ = serve.build(serve_args(flags))
    assert step == 6
    c2w = scene.poses[scene.i_test[0]]
    served, _ = render(c2w)
    _, tcfg, _ = configs()
    focal = scene.hwf[2] * (16 / scene.hwf[1])
    K = np.array([[focal, 0, 8.0], [0, focal, 8.0], [0, 0, 1]])
    want = render_image(state["params"], 16, 16, K, c2w, scene.near, scene.far,
                        tcfg.render, occ_state=state["occ"])
    assert want["acc_map"].max() > 0.5 and np.ptp(want["rgb_map"]) > 0.2
    np.testing.assert_array_equal(served["rgb_map"], want["rgb_map"])
    seeded, _ = serve.build(serve_args(TINY_FLAGSHIP + CPU))[0](c2w)
    assert np.abs(seeded["rgb_map"] - served["rgb_map"]).max() > 0.05


def test_server_serves_ft_path_and_a_jax_checkpoint(tmp_path):
    path, _, _ = jax_checkpoint(tmp_path, steps=3)
    _, step, _ = serve.build(serve_args(TINY_FLAGSHIP + CPU + ["--ft_path", path]))
    assert step == 3


def test_cli_entry_points_take_the_checkpoint_flags(tmp_path, capsys):
    """``python -m ...trainer -- <flags>`` writes {step:06d}.ckpt under
    basedir/mangle_expname and a second call resumes; none of the flags
    raises or is named idle."""
    flags = SMALL + run_dir(tmp_path) + ["--i_weights", "2"]
    trainer.main(["--"] + flags + ["--n_iters", "2"])
    trainer.main(["--"] + flags + ["--n_iters", "3", "--ft_path", "None"])
    text = capsys.readouterr().out
    assert "without effect" not in text and "Resumed at step 2" in text
    logdir = trainer.logdir_of(parse_args(flags))
    assert ckpt_files(logdir) == ["000002.ckpt", "000003.ckpt"]
