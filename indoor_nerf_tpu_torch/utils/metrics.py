"""Experiment metrics logging with the JAX package's artifact layout
(utils/metrics.py there; reference: PocketNeRF/metric_logger.py:12-352).

The same directory (``<logdir>/<exp>/metrics/``) and files for the same
calls: ``config.json``, ``metrics_iter_N.pkl`` (the same pickled dicts),
``main_metrics_N.csv`` and ``summary_table.csv`` (written with the standard
``csv`` module, byte for byte the JAX logger's pandas output),
``training_curves.png`` (matplotlib) and ``summary_table.tex`` (pandas).
The card's machine has neither matplotlib nor pandas: the logger then
writes everything else and says once, when it is made, which files it
leaves out and why (the JAX logger raises ImportError at the first save).

The quantizer series (A-CAQ, ROADMAP.md Queue 1 item 5) are kept empty in
the pickles as the JAX logger keeps them for an unquantized run;
``calculate_model_complexity``, ``log_acaq_update``, the quantizer CSV and
``quantization_analysis.png`` come with that item.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from collections import defaultdict
from typing import Dict, List

from indoor_nerf_tpu_torch.data.images import installed

MAIN_COLUMNS = ("iteration", "time", "loss", "psnr", "avg_bitwidth")
SUMMARY_COLUMNS = ("Metric", "Baseline", "Quantized (8-bit)", "A-CAQ")


def _write_csv(path: str, header, rows) -> None:
    """CSV as pandas' ``to_csv(index=False)`` writes it: ``\\n`` line ends,
    minimal quoting, ``None`` as an empty field, floats as ``repr``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


class MetricsLogger:
    def __init__(self, log_dir: str, experiment_name: str, config,
                 write: bool = True):
        """``write=False`` keeps the in-memory series and writes no file
        (a run without ``--expname``)."""
        self.log_dir = log_dir
        self.experiment_name = experiment_name
        self.config = config
        self.write = write
        self.metrics_dir = os.path.join(log_dir, experiment_name, "metrics")
        self.has_matplotlib = installed("matplotlib")
        self.has_pandas = installed("pandas")
        if write:
            os.makedirs(self.metrics_dir, exist_ok=True)
            left_out = [name for name, ok in (
                ("training_curves.png (needs matplotlib)", self.has_matplotlib),
                ("summary_table.tex (needs pandas)", self.has_pandas)) if not ok]
            if left_out:
                print("[metrics] not installed here, so not written: "
                      + "; ".join(left_out))

        self.metrics: Dict[str, list] = {
            "iteration": [], "time": [], "loss": [], "psnr": [],
            "learning_rate": [], "avg_bitwidth": [], "bitwidth_distribution": [],
            "component_bitwidths": defaultdict(list), "memory_usage": [],
            "inference_time": [], "test_psnr": [], "test_ssim": [],
            "test_lpips": [], "test_lpips_proxy": [],
        }
        self.quant_metrics: Dict[str, list] = {
            "embed_bits": [], "mlp_bits": [], "activation_bits": [],
            "weight_bits": [], "quantization_error": [], "bit_operations": [],
            "model_size": [],
        }
        self.acaq_metrics: Dict[str, list] = {
            "target_metric": [], "loss_ratio": [], "bit_adjustments": [],
            "layer_sensitivity": defaultdict(list),
        }
        self.save_config()

    def save_config(self):
        """config.json for reproducibility (reference: metric_logger.py:66-70)."""
        if not self.write:
            return
        path = os.path.join(self.metrics_dir, "config.json")
        cfg = self.config if isinstance(self.config, dict) else vars(self.config)
        with open(path, "w") as f:
            json.dump(cfg, f, indent=4, default=str)

    def log_iteration(self, iteration, time_elapsed, loss, psnr, lr):
        """Per-iteration series (reference: metric_logger.py:72-82)."""
        self.metrics["iteration"].append(iteration)
        self.metrics["time"].append(time_elapsed)
        self.metrics["loss"].append(float(loss))
        self.metrics["psnr"].append(float(psnr))
        self.metrics["learning_rate"].append(float(lr))

    def log_test_metrics(self, iteration, psnr, ssim=None, lpips=None,
                         lpips_proxy=None):
        """(reference: metric_logger.py:122-128). ``lpips_proxy`` is the
        weights-free GMSD (utils/evaluation.py::gmsd)."""
        self.metrics["test_psnr"].append((iteration, float(psnr)))
        if ssim is not None:
            self.metrics["test_ssim"].append((iteration, float(ssim)))
        if lpips is not None:
            self.metrics["test_lpips"].append((iteration, float(lpips)))
        if lpips_proxy is not None:
            self.metrics["test_lpips_proxy"].append(
                (iteration, float(lpips_proxy))
            )

    def save_checkpoint(self, iteration):
        """metrics_iter_N.pkl + main_metrics_N.csv (reference:
        metric_logger.py:165-205)."""
        if not self.write:
            return
        path = os.path.join(self.metrics_dir, f"metrics_iter_{iteration}.pkl")
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "metrics": {**self.metrics,
                                "component_bitwidths":
                                    dict(self.metrics["component_bitwidths"])},
                    "quant_metrics": self.quant_metrics,
                    "acaq_metrics": {**self.acaq_metrics,
                                     "layer_sensitivity":
                                         dict(self.acaq_metrics["layer_sensitivity"])},
                },
                f,
            )
        m = self.metrics
        n = len(m["iteration"])
        avg_bw = (m["avg_bitwidth"] + [None] * n)[:n]
        _write_csv(
            os.path.join(self.metrics_dir, f"main_metrics_{iteration}.csv"),
            MAIN_COLUMNS,
            zip(m["iteration"], m["time"], m["loss"], m["psnr"], avg_bw))

    def plot_training_curves(self, save_path=None):
        """The JAX logger's 2x2 PNG, where matplotlib is installed: PSNR
        against time and the loss (log scale); its two bitwidth panels stay
        blank, as they do there for an unquantized run."""
        if not (self.write and self.has_matplotlib):
            return
        if save_path is None:
            save_path = os.path.join(self.metrics_dir, "training_curves.png")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        m = self.metrics
        fig, axes = plt.subplots(2, 2, figsize=(12, 10))
        panels = (("PSNR vs Training Time", "Time (seconds)", "PSNR (dB)",
                   m["time"], m["psnr"], False),
                  ("Training Loss", "Iteration", "Loss (MSE)",
                   m["iteration"], m["loss"], True))
        for ax in axes.flat[len(panels):]:
            ax.set_axis_off()
        for ax, (title, xlabel, ylabel, x, y, logy) in zip(axes.flat, panels):
            if not y:
                ax.set_axis_off()
                continue
            (ax.semilogy if logy else ax.plot)(x, y, alpha=0.8)
            ax.set_title(title)
            ax.set_xlabel(xlabel)
            ax.set_ylabel(ylabel)
            ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)

    def generate_summary_table(self) -> List[Dict[str, str]]:
        """summary_table.csv (and .tex where pandas is installed), the
        JAX logger's table of an unquantized run: the final training PSNR
        under Baseline. Returns its rows."""
        rows = []
        if self.metrics["psnr"]:
            rows.append(dict(zip(SUMMARY_COLUMNS, (
                "Final PSNR (dB)", f"{self.metrics['psnr'][-1]:.2f}", "N/A",
                "N/A"))))
        if self.write:
            _write_csv(os.path.join(self.metrics_dir, "summary_table.csv"),
                       SUMMARY_COLUMNS, [list(r.values()) for r in rows])
            if self.has_pandas:
                import pandas as pd

                df = pd.DataFrame({c: [r[c] for r in rows]
                                   for c in SUMMARY_COLUMNS})
                with open(os.path.join(self.metrics_dir, "summary_table.tex"),
                          "w") as f:
                    f.write(df.to_latex(index=False))
        return rows
