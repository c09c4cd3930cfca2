"""Image files of the loaders, and their half-resolution resize.

The card's machine has numpy but no ``imageio`` and no ``cv2``, so every
``.png`` is read with the port's own reader (``utils/png.py::read_png``),
whatever is installed, and the 2x ``INTER_AREA`` resize of ``--half_res``
is taken in numpy where it is exact (even sizes). Anything else imports its
package inside the call and names it when it is missing.
"""

from __future__ import annotations

import importlib
import importlib.util

import numpy as np

from indoor_nerf_tpu_torch.utils.png import read_png


def require(module: str, what: str):
    """``import module``, or an ImportError that names the package and
    ``what`` needed it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        raise ImportError(f"{what} needs the {package!r} package, which is "
                          "not installed") from e


def installed(module: str) -> bool:
    """Whether ``module`` can be imported here (a module set to None in
    ``sys.modules`` counts as missing)."""
    try:
        return importlib.util.find_spec(module) is not None
    except ValueError:
        return False


def imread(path: str) -> np.ndarray:
    """The image of ``path``: ``read_png`` for ``.png`` files, else
    ``imageio``'s reader (LLFF's ``images/*.JPG``)."""
    if path.lower().endswith(".png"):
        return read_png(path)
    return require("imageio.v2", f"reading {path}").imread(path)


def half_res(imgs: np.ndarray) -> np.ndarray:
    """``[N, H, W, C]`` float32 -> ``[N, H // 2, W // 2, C]`` float32, as the
    JAX loaders' ``cv2.resize(img, (W // 2, H // 2), INTER_AREA)`` per image.
    At even H and W that is the mean of each 2x2 block, taken here in the
    order of OpenCV's fast area path; at an odd size the area weights are
    fractional, and ``cv2`` itself does the resize."""
    n, h, w = imgs.shape[:3]
    if h % 2 == 0 and w % 2 == 0:
        x = np.asarray(imgs, np.float32)
        return ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2]
                 + x[:, 1::2, 1::2]) * np.float32(0.25))
    cv2 = require("cv2", f"--half_res of {h}x{w} images (an odd size)")
    return np.stack([cv2.resize(img, (w // 2, h // 2),
                                interpolation=cv2.INTER_AREA)
                     for img in imgs]).astype(np.float32)
