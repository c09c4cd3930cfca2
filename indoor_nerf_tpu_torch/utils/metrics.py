"""Experiment metrics logging with the JAX package's artifact layout
(utils/metrics.py there; reference: PocketNeRF/metric_logger.py:12-352).

The same directory (``<logdir>/<exp>/metrics/``) and files for the same
calls: ``config.json``, ``metrics_iter_N.pkl`` (the same pickled dicts),
``main_metrics_N.csv`` and ``summary_table.csv`` (written with the standard
``csv`` module, byte for byte the JAX logger's pandas output),
``training_curves.png`` and ``quantization_analysis.png`` (matplotlib),
``summary_table.tex`` (pandas), and for a quantized run
``quant_metrics_N.csv``. The card's machine has neither matplotlib nor
pandas: the logger then writes everything else and says once, when it is
made, which files it leaves out and why (the JAX logger raises ImportError
at the first save).

The quantizer series (A-CAQ) fill as the JAX logger fills them: the soft
bits each logged step carries (``log_iteration``'s ``quantizer_bits``), the
model size of ``calculate_model_complexity`` and the controller's updates
(``log_acaq_update``); an unquantized run keeps them empty.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

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
                ("training_curves.png and quantization_analysis.png (need "
                 "matplotlib)", self.has_matplotlib),
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

    def log_iteration(self, iteration, time_elapsed, loss, psnr, lr,
                      quantizer_bits: Optional[Dict[str, np.ndarray]] = None):
        """Per-iteration series (reference: metric_logger.py:72-82);
        ``quantizer_bits`` ``{"embed": [L], "network": [n_act + 1]}`` soft
        bits (``train/trainer.py::_quant_bits``) for a quantized run."""
        self.metrics["iteration"].append(iteration)
        self.metrics["time"].append(time_elapsed)
        self.metrics["loss"].append(float(loss))
        self.metrics["psnr"].append(float(psnr))
        self.metrics["learning_rate"].append(float(lr))
        if quantizer_bits:
            self._log_quant(quantizer_bits)

    def _log_quant(self, quantizer_bits: Dict[str, np.ndarray]):
        """(reference: metric_logger.py:84-120; the JAX ``_log_quant``)"""
        all_bits, embed_bits, mlp_bits = [], [], []
        for name, arr in quantizer_bits.items():
            if arr is None:
                continue
            vals = np.atleast_1d(np.asarray(arr, np.float64))
            for idx, b in enumerate(vals):
                all_bits.append(float(b))
                (embed_bits if "embed" in name else mlp_bits).append(float(b))
                self.metrics["component_bitwidths"][f"{name}_{idx}"].append(
                    float(b))
        if all_bits:
            self.metrics["avg_bitwidth"].append(float(np.mean(all_bits)))
            self.metrics["bitwidth_distribution"].append(list(all_bits))
            self.quant_metrics["embed_bits"].append(
                float(np.mean(embed_bits)) if embed_bits else None)
            self.quant_metrics["mlp_bits"].append(
                float(np.mean(mlp_bits)) if mlp_bits else None)
            for k in ("activation_bits", "weight_bits", "quantization_error",
                      "bit_operations", "model_size"):
                self.quant_metrics[k].append(None)

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

    def log_acaq_update(self, target_metric, loss_ratio, bit_adjustments):
        """(reference: metric_logger.py:130-134)"""
        self.acaq_metrics["target_metric"].append(float(target_metric))
        self.acaq_metrics["loss_ratio"].append(float(loss_ratio))
        self.acaq_metrics["bit_adjustments"].append(
            [float(b) for b in np.atleast_1d(bit_adjustments)])

    def calculate_model_complexity(self, params, quantizer_bits=None):
        """Bits and compressed size (MB) of the params (reference:
        metric_logger.py:136-163, the JAX logger's rule): the table at the
        grid quantizers' mean bits, every other leaf at the network
        quantizers' mean, 32 where a group is missing. Appends both to the
        quantizer series; returns (bits, MB)."""
        from indoor_nerf_tpu_torch.train.optim import named_leaves

        embed_mean = mlp_mean = 32.0
        if quantizer_bits:
            if quantizer_bits.get("embed") is not None:
                embed_mean = float(np.mean(np.asarray(quantizer_bits["embed"])))
            if quantizer_bits.get("network") is not None:
                mlp_mean = float(np.mean(np.asarray(quantizer_bits["network"])))
        total_bits = 0.0
        for name, leaf in sorted(named_leaves(params).items()):
            bits = embed_mean if name == "table" else mlp_mean
            total_bits += bits * int(leaf.numel())
        model_size_mb = total_bits / (8 * 1024 * 1024)
        self.quant_metrics["bit_operations"].append(total_bits)
        self.quant_metrics["model_size"].append(model_size_mb)
        return total_bits, model_size_mb

    def save_checkpoint(self, iteration):
        """metrics_iter_N.pkl, main_metrics_N.csv and, once a quantizer
        series holds a value, quant_metrics_N.csv (reference:
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
        q = self.quant_metrics
        if any(q.values()):
            n = max(len(v) for v in q.values())
            cols = [(v + [None] * (n - len(v))) for v in q.values()]
            _write_csv(
                os.path.join(self.metrics_dir, f"quant_metrics_{iteration}.csv"),
                list(q), zip(*cols))

    def _draw_panel_grid(self, save_path, panels):
        """Up to 4 panel specs in a 2x2 PNG, where matplotlib is installed
        (the JAX logger's ``_draw_panel_grid``): each spec has a ``kind``
        (line, scatter, hist), ``series`` of (x, y, label), a title and axis
        labels, and optionally ``logy``, ``ylim``, ``legend`` or
        ``small_legend``; a panel without series stays blank."""
        if not (self.write and self.has_matplotlib):
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(12, 10))
        for ax, spec in zip(axes.flat, panels):
            if spec is None or not spec.get("series"):
                ax.set_axis_off()
                continue
            for x, y, label in spec["series"]:
                if spec["kind"] == "hist":
                    ax.hist(x, bins=20, edgecolor="black", alpha=0.7)
                elif spec["kind"] == "scatter":
                    ax.scatter(x, y, alpha=0.6, label=label)
                else:
                    draw = ax.semilogy if spec.get("logy") else ax.plot
                    draw(x, y, alpha=0.8, label=label)
            ax.set_title(spec["title"])
            ax.set_xlabel(spec["xlabel"])
            ax.set_ylabel(spec["ylabel"])
            ax.grid(True, alpha=0.3)
            if spec.get("ylim"):
                ax.set_ylim(*spec["ylim"])
            if spec.get("small_legend"):
                ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left",
                          fontsize=6)
            elif spec.get("legend"):
                ax.legend()
        fig.tight_layout()
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)

    def plot_training_curves(self, save_path=None):
        """training_curves.png: PSNR against time, the loss (log scale), the
        average bitwidth and each quantizer's bitwidth (the last two blank
        for an unquantized run), as the JAX logger draws it."""
        m = self.metrics
        iters, avg_bw = m["iteration"], m["avg_bitwidth"]
        components = [(list(range(len(h))), h, name.replace("_", " ").title())
                      for name, h in m["component_bitwidths"].items() if h]
        self._draw_panel_grid(
            save_path or os.path.join(self.metrics_dir, "training_curves.png"),
            [{"kind": "line", "title": "PSNR vs Training Time",
              "xlabel": "Time (seconds)", "ylabel": "PSNR (dB)",
              "series": [(m["time"], m["psnr"], None)] if m["psnr"] else []},
             {"kind": "line", "logy": True, "title": "Training Loss",
              "xlabel": "Iteration", "ylabel": "Loss (MSE)",
              "series": [(iters, m["loss"], None)] if m["loss"] else []},
             {"kind": "line", "title": "Bitwidth Evolution",
              "xlabel": "Iteration", "ylabel": "Average Bitwidth",
              "ylim": (0, max(avg_bw) + 1) if avg_bw else None,
              "series": ([(iters[:len(avg_bw)], avg_bw, None)]
                         if avg_bw else [])},
             {"kind": "line", "title": "Component-wise Bitwidth Evolution",
              "xlabel": "Iteration", "ylabel": "Bitwidth",
              "small_legend": True, "series": components}])

    def plot_quantization_analysis(self, save_path=None):
        """quantization_analysis.png: the last bitwidth histogram, PSNR
        against average bits, the model size over time and the grid's
        against the MLP's bits, as the JAX logger draws it."""
        m, q = self.metrics, self.quant_metrics
        avg_bw = m["avg_bitwidth"]
        sizes = [v for v in q["model_size"] if v is not None]
        eb = [b for b in q["embed_bits"] if b is not None]
        mb = [b for b in q["mlp_bits"] if b is not None]
        self._draw_panel_grid(
            save_path or os.path.join(self.metrics_dir,
                                      "quantization_analysis.png"),
            [{"kind": "hist", "title": "Final Bitwidth Distribution",
              "xlabel": "Bitwidth", "ylabel": "Count",
              "series": ([(m["bitwidth_distribution"][-1], None, None)]
                         if m["bitwidth_distribution"] else [])},
             {"kind": "scatter", "title": "PSNR vs Bitwidth Trade-off",
              "xlabel": "Average Bitwidth", "ylabel": "PSNR (dB)",
              "series": ([(avg_bw, m["psnr"][:len(avg_bw)], None)]
                         if avg_bw and len(m["psnr"]) >= len(avg_bw) else [])},
             {"kind": "line", "title": "Model Compression Over Time",
              "xlabel": "Iteration", "ylabel": "Model Size (MB)",
              "series": ([(list(range(len(sizes))), sizes, None)]
                         if sizes else [])},
             {"kind": "line", "title": "Component-wise Compression",
              "xlabel": "Iteration", "ylabel": "Average Bitwidth",
              "legend": True,
              "series": ([(list(range(len(eb))), eb, "Embeddings"),
                          (list(range(len(mb))), mb, "MLP")]
                         if eb and mb else [])}])

    def generate_summary_table(self) -> List[Dict[str, str]]:
        """summary_table.csv (and .tex where pandas is installed), the JAX
        logger's table: an unquantized run's final training PSNR under
        Baseline; a quantized run's final PSNR (and its PSNR at the 1001st
        logged step under "Quantized (8-bit)"), last average bitwidth and
        last model size under A-CAQ. Returns its rows."""
        m = self.metrics
        rows = []
        if m["psnr"]:
            if m["avg_bitwidth"]:
                cells = ("N/A", f"{m['psnr'][1000]:.2f}"
                         if len(m["psnr"]) > 1000 else "N/A",
                         f"{m['psnr'][-1]:.2f}")
            else:
                cells = (f"{m['psnr'][-1]:.2f}", "N/A", "N/A")
            rows.append(("Final PSNR (dB)",) + cells)
        if m["avg_bitwidth"]:
            rows.append(("Average Bitwidth", "32.0", "8.0",
                         f"{m['avg_bitwidth'][-1]:.2f}"))
        sizes = [v for v in self.quant_metrics["model_size"] if v is not None]
        if sizes:
            rows.append(("Model Size (MB)", "N/A", "N/A", f"{sizes[-1]:.2f}"))
        rows = [dict(zip(SUMMARY_COLUMNS, r)) for r in rows]
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
