"""Image-quality evaluation: PSNR / SSIM / GMSD / LPIPS, copied from
indoor_nerf_tpu/utils/evaluation.py (whose package imports jax).

Equivalent of ComprehensiveEvaluator (reference:
PocketNeRF/evaluation_utils.py:11-141). skimage and lpips are not needed:
SSIM is implemented here (Wang et al. 2004 with skimage's NeRF-standard
settings: 11x11 Gaussian window sigma 1.5, data_range 1), GMSD stands as
``lpips_proxy``, and LPIPS is None when no AlexNet weights are on disk (no
weights are downloaded). ``device_memory_stats`` reads ``torch.cuda``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def psnr(img: np.ndarray, gt: np.ndarray) -> float:
    """(reference: evaluation_utils.py:24-27, run_nerf.py:186)"""
    mse = np.mean((img.astype(np.float64) - gt.astype(np.float64)) ** 2)
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along the two leading axes."""
    from numpy.lib.stride_tricks import sliding_window_view

    w = k.size
    out = sliding_window_view(img, w, axis=0) @ k
    out = sliding_window_view(out, w, axis=1) @ k
    return out


def ssim(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM with Gaussian weighting, averaged over channels.

    Matches skimage.metrics.structural_similarity with
    gaussian_weights=True, sigma=1.5, use_sample_covariance=False — the
    standard NeRF-benchmark configuration.
    """
    img = img.astype(np.float64)
    gt = gt.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]
        gt = gt[..., None]
    k = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals = []
    for c in range(img.shape[-1]):
        x, y = img[..., c], gt[..., c]
        mu_x = _filter2d_sep(x, k)
        mu_y = _filter2d_sep(y, k)
        mu_xx = _filter2d_sep(x * x, k)
        mu_yy = _filter2d_sep(y * y, k)
        mu_xy = _filter2d_sep(x * y, k)
        var_x = mu_xx - mu_x**2
        var_y = mu_yy - mu_y**2
        cov = mu_xy - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def gmsd(img: np.ndarray, gt: np.ndarray) -> float:
    """Gradient Magnitude Similarity Deviation (Xue et al. 2013) — a
    pretrained-weights-free perceptual distortion metric; lower is better,
    0 for identical images. Reported as ``lpips_proxy`` wherever the
    reference reports LPIPS (evaluation_utils.py:36-43) so the third
    quality metric stays live in zero-egress environments where the LPIPS
    AlexNet weights cannot be downloaded (VERDICT.md round-1 item 8).

    Standard formulation: luminance -> 2x2 average downsample -> Prewitt
    gradient magnitudes -> gradient-magnitude-similarity map -> its
    standard deviation. c = 170/255^2 rescaled for [0,1] inputs.
    """
    def lum(x):
        x = np.asarray(x, np.float64)
        if x.ndim == 3:
            x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        return x

    def down2(x):
        h, w = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
        x = x[:h, :w]
        return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2]
                       + x[0::2, 1::2] + x[1::2, 1::2])

    def prewitt_mag(x):
        xp = np.pad(x, 1, mode="edge")
        # Prewitt kernels /3: horizontal = column diff averaged over rows.
        gx = (xp[:-2, 2:] + xp[1:-1, 2:] + xp[2:, 2:]
              - xp[:-2, :-2] - xp[1:-1, :-2] - xp[2:, :-2]) / 3.0
        gy = (xp[2:, :-2] + xp[2:, 1:-1] + xp[2:, 2:]
              - xp[:-2, :-2] - xp[:-2, 1:-1] - xp[:-2, 2:]) / 3.0
        return np.sqrt(gx * gx + gy * gy)

    a, b = down2(lum(img)), down2(lum(gt))
    g1, g2 = prewitt_mag(a), prewitt_mag(b)
    c = 170.0 / (255.0 ** 2)
    gms = (2.0 * g1 * g2 + c) / (g1 * g1 + g2 * g2 + c)
    return float(np.std(gms))


#: AlexNet conv-stack geometry shared by the native LPIPS implementation
#: and fixture builders: (out_ch, in_ch, kernel, stride, padding) per conv,
#: with 3x3/stride-2 max-pools before conv2 and conv3 (torchvision AlexNet
#: features layout, the backbone the lpips package taps).
LPIPS_ALEX_CONVS = (
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
)


class _NativeLpipsAlex:
    """LPIPS(alex) forward pass in plain torch, no lpips package.

    Faithful to the lpips reference computation (richzhang/PerceptualSimilarity,
    used by PocketNeRF/evaluation_utils.py:18-20): images scaled to [-1,1],
    shifted/scaled per channel, passed through the AlexNet conv stack; the five
    post-ReLU feature maps are channel-unit-normalized, squared-differenced,
    reduced by non-negative 1x1 "lin" heads, spatially averaged and summed.

    Weights arrive as a plain state dict with keys ``conv{i}.weight``,
    ``conv{i}.bias`` (torchvision AlexNet shapes) and ``lin{i}.weight``
    ([1, C_i, 1, 1]) for i in 1..5 — the tensors the lpips package would
    download, saved locally with ``torch.save``.
    """

    # lpips' ScalingLayer constants (input normalization in [-1,1] space).
    _SHIFT = (-0.030, -0.088, -0.188)
    _SCALE = (0.458, 0.448, 0.450)

    def __init__(self, state):
        import torch

        self._torch = torch
        self.convs = [
            (state[f"conv{i}.weight"].float(), state[f"conv{i}.bias"].float())
            for i in range(1, 6)
        ]
        self.lins = [state[f"lin{i}.weight"].float() for i in range(1, 6)]
        for i, ((w, _), spec) in enumerate(zip(self.convs, LPIPS_ALEX_CONVS)):
            if tuple(w.shape) != (spec[0], spec[1], spec[2], spec[2]):
                raise ValueError(f"conv{i+1} weight shape {tuple(w.shape)} "
                                 f"!= expected {spec}")

    def _features(self, x):
        import torch.nn.functional as F

        t = self._torch
        shift = t.tensor(self._SHIFT).view(1, 3, 1, 1)
        scale = t.tensor(self._SCALE).view(1, 3, 1, 1)
        h = (x - shift) / scale
        feats = []
        for i, ((w, b), spec) in enumerate(zip(self.convs, LPIPS_ALEX_CONVS)):
            if i in (1, 2):  # max-pools sit before conv2 and conv3
                h = F.max_pool2d(h, kernel_size=3, stride=2)
            h = F.relu(F.conv2d(h, w, b, stride=spec[3], padding=spec[4]))
            feats.append(h)
        return feats

    def __call__(self, x, y):
        t = self._torch
        with t.no_grad():
            total = t.zeros(())
            for fx, fy, lin in zip(self._features(x), self._features(y),
                                   self.lins):
                nx = fx / (fx.square().sum(1, keepdim=True).sqrt() + 1e-10)
                ny = fy / (fy.square().sum(1, keepdim=True).sqrt() + 1e-10)
                d = (nx - ny).square()
                total = total + (d * lin.clamp(min=0)).sum(1).mean()
        return float(total)


def default_lpips_weights_path() -> str:
    """Local AlexNet+lin weight file consulted by LpipsScorer. Override with
    $INDOOR_NERF_LPIPS_WEIGHTS."""
    return os.environ.get(
        "INDOOR_NERF_LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/indoor_nerf_tpu/lpips_alex.pt"),
    )


class LpipsScorer:
    """LPIPS(alex) scorer; silently unavailable without pretrained weights.

    The reference uses the lpips package with the AlexNet backbone
    (evaluation_utils.py:18-20). That package needs downloaded weights; here
    the resolution order is (1) the lpips package if importable, (2) a local
    weight file (``weights_path`` arg, $INDOOR_NERF_LPIPS_WEIGHTS, or
    ~/.cache/indoor_nerf_tpu/lpips_alex.pt) driving the native torch
    implementation above, (3) unavailable — scores degrade to None rather
    than being faked, and GMSD ships as ``lpips_proxy``.
    """

    def __init__(self, weights_path: Optional[str] = None):
        self._model = None
        self.available = False
        try:  # pragma: no cover - depends on environment weights
            import lpips  # type: ignore

            self._model = lpips.LPIPS(net="alex")
            self.available = True
            return
        except Exception:
            pass
        path = weights_path or default_lpips_weights_path()
        if os.path.exists(path):
            import torch

            state = torch.load(path, map_location="cpu", weights_only=True)
            self._model = _NativeLpipsAlex(state)
            self.available = True

    def __call__(self, img: np.ndarray, gt: np.ndarray) -> Optional[float]:
        if not self.available:
            return None
        import torch

        def prep(x):
            t = torch.from_numpy(np.asarray(x, np.float32) * 2.0 - 1.0)
            return t.permute(2, 0, 1)[None]

        with torch.no_grad():
            return float(self._model(prep(img), prep(gt)))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory in MB, the keys of the JAX package's
    ``device_memory_stats`` (reference: evaluation_utils.py:85-92): in use
    and peak from ``torch.cuda.memory_stats``, the limit from
    ``torch.cuda.mem_get_info``. Empty without a CUDA card."""
    import torch

    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 2**20,
            "peak_bytes_mb": s.get("allocated_bytes.all.peak", 0) / 2**20,
            "bytes_limit_mb": total / 2**20,
        }
    return stats


class ComprehensiveEvaluator:
    """Test-set sweep with mean/std per metric
    (reference: evaluation_utils.py:11-92)."""

    def __init__(self):
        self.lpips = LpipsScorer()
        if not self.lpips.available:
            print("[eval] LPIPS unavailable (no pretrained weights); "
                  "reporting GMSD as lpips_proxy alongside PSNR/SSIM")

    def memory_stats(self) -> Dict[str, float]:
        return device_memory_stats()

    def evaluate_image(self, img: np.ndarray, gt: np.ndarray) -> Dict:
        # lpips_proxy (GMSD, lower-better like LPIPS) is always reported so
        # the third quality metric never degrades to nothing; real LPIPS is
        # added when the pretrained backbone is available.
        out = {
            "psnr": psnr(img, gt),
            "ssim": ssim(img, gt),
            "lpips_proxy": gmsd(img, gt),
        }
        lp = self.lpips(img, gt)
        if lp is not None:
            out["lpips"] = lp
        return out

    def comparison_figure(self, gt: np.ndarray, baseline: np.ndarray,
                          method: np.ndarray, save_path: str,
                          labels=("GT", "Baseline", "Method")):
        """Side-by-side baseline-vs-method comparison with error maps
        (reference: evaluation_utils.py:99-141)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        err_b = np.abs(baseline - gt).mean(-1)
        err_m = np.abs(method - gt).mean(-1)
        vmax = max(err_b.max(), err_m.max(), 1e-8)
        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        for ax, img, title in zip(
            axes[0], (gt, baseline, method), labels
        ):
            ax.imshow(np.clip(img, 0, 1))
            ax.set_title(title)
            ax.axis("off")
        axes[1][0].axis("off")
        for ax, err, src in zip(axes[1][1:], (err_b, err_m), labels[1:]):
            im = ax.imshow(err, cmap="hot", vmin=0, vmax=vmax)
            m = self.evaluate_image(
                baseline if src == labels[1] else method, gt
            )
            ax.set_title(f"{src} error (PSNR {m['psnr']:.2f})")
            ax.axis("off")
        fig.colorbar(im, ax=axes[1][2], fraction=0.046)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path

    def evaluate_test_set(self, images: List[np.ndarray],
                          gts: List[np.ndarray]) -> Dict:
        per_image = [self.evaluate_image(i, g) for i, g in zip(images, gts)]
        keys = per_image[0].keys() if per_image else []
        summary = {}
        for k in keys:
            vals = [m[k] for m in per_image]
            summary[f"{k}_mean"] = float(np.mean(vals))
            summary[f"{k}_std"] = float(np.std(vals))
        summary["per_image"] = per_image
        return summary
