"""The port's image metrics and metrics logger against the JAX package's."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from indoor_nerf_tpu.utils import evaluation as j_eval
from indoor_nerf_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from indoor_nerf_tpu_torch.utils import evaluation
from indoor_nerf_tpu_torch.utils.metrics import MetricsLogger

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(40, 52, 3), (33, 31)])
def test_psnr_ssim_gmsd_are_the_jax_ones(shape):
    rng = np.random.default_rng(0)
    gt = rng.random(shape).astype(np.float32)
    img = np.clip(gt + 0.05 * rng.normal(size=shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim", "gmsd"):
        got = getattr(evaluation, name)(img, gt)
        want = getattr(j_eval, name)(img, gt)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), name


def _lpips_weights(path):
    g = torch.Generator().manual_seed(0)
    state = {}
    for i, (out_c, in_c, k, _, _) in enumerate(evaluation.LPIPS_ALEX_CONVS, 1):
        state[f"conv{i}.weight"] = 0.05 * torch.randn(out_c, in_c, k, k, generator=g)
        state[f"conv{i}.bias"] = 0.01 * torch.randn(out_c, generator=g)
        state[f"lin{i}.weight"] = torch.rand(1, out_c, 1, 1, generator=g)
    torch.save(state, path)


def test_native_lpips_is_the_jax_one(tmp_path):
    path = str(tmp_path / "alex.pt")
    _lpips_weights(path)
    rng = np.random.default_rng(1)
    gt = rng.random((64, 64, 3)).astype(np.float32)
    img = np.clip(gt + 0.1 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
    got = evaluation.LpipsScorer(path)
    want = j_eval.LpipsScorer(path)
    assert got.available and want.available
    a, b = got(img, gt), want(img, gt)
    assert a > 0 and abs(a - b) <= 1e-6 * max(1.0, abs(b))
    assert got(gt, gt) == 0.0


def test_evaluator_without_lpips_weights(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("INDOOR_NERF_LPIPS_WEIGHTS", str(tmp_path / "absent.pt"))
    ev = evaluation.ComprehensiveEvaluator()
    assert "LPIPS unavailable" in capsys.readouterr().out
    gt = np.random.default_rng(2).random((16, 16, 3))
    out = ev.evaluate_image(gt * 0.9, gt)
    assert set(out) == {"psnr", "ssim", "lpips_proxy"}
    summary = ev.evaluate_test_set([gt * 0.9, gt], [gt, gt])
    assert summary["psnr_mean"] > 0 and len(summary["per_image"]) == 2


def test_device_memory_stats():
    stats = evaluation.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    for s in stats.values():
        assert set(s) == {"bytes_in_use_mb", "peak_bytes_mb", "bytes_limit_mb"}


def _log(logger):
    """The calls the trainer makes, with values whose repr is long."""
    rng = np.random.default_rng(3)
    for i in range(1, 8):
        logger.log_iteration(i, 0.1 * i + rng.random(), rng.random() / 7,
                             10 + 20 * rng.random(), 1e-2 * 0.9 ** i)
        if i % 3 == 0:
            logger.log_test_metrics(i, 20 + rng.random(), ssim=rng.random(),
                                    lpips=None, lpips_proxy=rng.random())
            logger.save_checkpoint(i)
    logger.save_checkpoint(7)
    logger.plot_training_curves()
    return logger.generate_summary_table()


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_metrics_logger_writes_the_jax_files(tmp_path):
    """The same pickles, the same CSVs byte for byte, config.json."""
    cfg = {"lrate": 0.01, "expname": "e", "N_rand": 64}
    rows = _log(MetricsLogger(str(tmp_path / "t"), "e", cfg))
    _log(JMetricsLogger(str(tmp_path / "j"), "e", cfg))
    got = _files(tmp_path / "t" / "e" / "metrics")
    want = _files(tmp_path / "j" / "e" / "metrics")
    assert rows[0]["Metric"] == "Final PSNR (dB)"
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        if name.endswith(".pkl"):
            assert pickle.loads(got[name]) == pickle.loads(data), name
        elif name.endswith((".csv", ".json", ".tex")):
            assert got[name] == data, name
    assert got["training_curves.png"].startswith(b"\x89PNG")


def test_quantized_metrics_logger_writes_the_jax_files(tmp_path):
    """A quantized run's calls (the soft bits with each logged step, the
    controller's updates, the model complexity of the flagship's params at
    each save, the quantization figure): the same pickles, the quantizer
    CSV and the others byte for byte, and both figures."""
    import jax

    from _torch_parity import TINY_FLAGSHIP, configs
    from indoor_nerf_tpu.models.field import init_field_params
    from indoor_nerf_tpu_torch.bridge import params_from_numpy

    jcfg, _, _ = configs(TINY_FLAGSHIP + ["--use_quantization"])
    jparams = jax.tree_util.tree_map(np.asarray, init_field_params(
        jax.random.PRNGKey(0), jcfg.render.field))
    tparams = params_from_numpy({"params": jparams})["params"]
    rng = np.random.default_rng(4)

    def log(logger, params):
        for i in range(1, 9):
            bits = {"embed": (8 - 0.1 * i + rng.random(4)).astype(np.float32),
                    "network": (8 + rng.random(2)).astype(np.float32)}
            logger.log_iteration(i, 0.1 * i, rng.random() / 7,
                                 10 + 20 * rng.random(), 1e-3,
                                 quantizer_bits=bits)
            if i % 4 == 0:
                logger.log_acaq_update(1.0, rng.random() + 0.5,
                                       rng.random(6) - 0.5)
                logger.calculate_model_complexity(params, bits)
                logger.save_checkpoint(i)
                logger.plot_quantization_analysis()
        logger.plot_training_curves()
        return logger.generate_summary_table()

    rows = log(MetricsLogger(str(tmp_path / "t"), "e", {}), tparams)
    rng = np.random.default_rng(4)
    log(JMetricsLogger(str(tmp_path / "j"), "e", {}), jparams)
    got = _files(tmp_path / "t" / "e" / "metrics")
    want = _files(tmp_path / "j" / "e" / "metrics")
    assert [r["Metric"] for r in rows] == [
        "Final PSNR (dB)", "Average Bitwidth", "Model Size (MB)"]
    assert sorted(got) == sorted(want)
    assert "quant_metrics_8.csv" in got
    for name, data in want.items():
        if name.endswith(".pkl"):
            assert pickle.loads(got[name]) == pickle.loads(data), name
        elif name.endswith((".csv", ".json", ".tex")):
            assert got[name] == data, name
    for name in ("training_curves.png", "quantization_analysis.png"):
        assert got[name].startswith(b"\x89PNG"), name


def test_metrics_logger_without_steps_is_the_jax_one(tmp_path):
    for cls, d in ((MetricsLogger, "t"), (JMetricsLogger, "j")):
        logger = cls(str(tmp_path / d), "e", {})
        logger.save_checkpoint(0)
        logger.generate_summary_table()
    got = _files(tmp_path / "t" / "e" / "metrics")
    want = _files(tmp_path / "j" / "e" / "metrics")
    for name in ("main_metrics_0.csv", "summary_table.csv"):
        assert got[name] == want[name], name


_BLOCKED = r"""
import os, sys
sys.modules["matplotlib"] = None
sys.modules["pandas"] = None
from indoor_nerf_tpu_torch.utils.metrics import MetricsLogger
logger = MetricsLogger(sys.argv[1], "e", {"a": 1})
logger.log_iteration(1, 0.5, 0.1, 10.0, 1e-2)
logger.save_checkpoint(1)
logger.plot_training_curves()
logger.generate_summary_table()
print(sorted(os.listdir(os.path.join(sys.argv[1], "e", "metrics"))))
"""


def test_metrics_logger_without_matplotlib_and_pandas(tmp_path):
    """Everything else is written; one line names what is left out."""
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    said = [line for line in lines if "not written" in line]
    assert len(said) == 1
    assert "training_curves.png" in said[0] and "summary_table.tex" in said[0]
    assert lines[-1] == str(["config.json", "main_metrics_1.csv",
                             "metrics_iter_1.pkl", "summary_table.csv"])
