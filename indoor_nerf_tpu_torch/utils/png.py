"""A small PNG encoder and decoder on the standard library (zlib + struct).

The server writes 8-bit RGB PNGs with no row filter. ``decode_png`` and
``read_png`` read non-interlaced 8-bit gray, gray+alpha, RGB and RGBA PNGs
with any of the five row filters (None, Sub, Up, Average, Paeth), which is
what Blender, LINEMOD and LLFF scenes hold, so the loaders need nothing
beyond numpy. ``encode_png`` writes the same kinds, with one filter for
every row or a filter per row.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type by channel count, and back.
_COLOR_OF = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS_OF = {v: k for k, v in _COLOR_OF.items()}


def to8b(x: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> uint8 pixels (reference: run_nerf_helpers.py:13)."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 ``a`` (left), ``b`` (up), ``c`` (up-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(px: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Filter ``px`` ``[H, W, C]`` uint8 with ``filters[y]`` per row: the
    ``[H, W * C]`` filtered bytes (the encoder sees every original pixel, so
    each filter is one whole-image expression)."""
    h, w, c = px.shape
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, cc)])
    pred = preds[filters, np.arange(h)]
    return ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * c)


def encode_png(img: np.ndarray,
               filter_type: Union[int, Sequence[int]] = 0) -> bytes:
    """``[H, W]``, ``[H, W, 1..4]`` uint8 (gray, gray+alpha, RGB, RGBA) ->
    PNG bytes. ``filter_type`` is one filter (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth) for every row, or a sequence of one per row."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_OF:
        raise ValueError("expected [H, W] or [H, W, 1-4] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    filters = np.broadcast_to(np.asarray(filter_type, np.int64), (h,))
    if np.any((filters < 0) | (filters > 4)):
        raise ValueError(f"PNG filter types are 0-4, got {filter_type}")
    if np.all(filters == 0):
        body = img.reshape(h, w * c)
    else:
        body = _filter_rows(img, filters)
    raw = np.concatenate([filters.astype(np.uint8)[:, None], body], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_OF[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_rows(rows: np.ndarray, filters: np.ndarray, w: int,
                   c: int) -> np.ndarray:
    """Rows whose filters are None, Sub or Up only: one numpy pass per row
    (Sub is a running sum mod 256 per channel)."""
    h = rows.shape[0]
    out = np.empty((h, w, c), np.uint8)
    prior = np.zeros((w, c), np.uint8)
    for y in range(h):
        row = rows[y].reshape(w, c)
        f = filters[y]
        if f == 0:
            cur = row
        elif f == 1:
            cur = np.cumsum(row, axis=0, dtype=np.uint8)  # wraps mod 256
        else:
            cur = row + prior  # uint8: wraps mod 256
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_wavefront(rows: np.ndarray, filters: np.ndarray, w: int,
                        c: int) -> np.ndarray:
    """Any mix of the five filters. Average and Paeth read the reconstructed
    pixel to the left, so a pixel waits for its left, upper and upper-left
    neighbours: all pixels of one anti-diagonal ``x + y = d`` are ready
    together. The image is sheared so that each anti-diagonal is one
    contiguous ``[H, C]`` slab, and the slabs are reconstructed in order,
    one numpy pass over the diagonal's rows and channels each (``H + W - 1``
    passes)."""
    h = rows.shape[0]
    f = rows.reshape(h, w, c).astype(np.int16)
    n_diag = h + w - 1
    ys = np.arange(h)[None, :]
    xs = np.arange(n_diag)[:, None] - ys  # the column of (y, d)
    valid = (xs >= 0) & (xs < w)
    sheared = np.zeros((n_diag, h, c), np.int16)
    sheared[valid] = f[np.broadcast_to(ys, valid.shape)[valid], xs[valid]]
    # recon[d + 2, y + 1] holds (y, d - y); slabs 0-1 and row 0 are the
    # zeros a pixel outside the image predicts from.
    recon = np.zeros((n_diag + 2, h + 1, c), np.int16)
    kind = filters[:, None]
    present = [k for k in (1, 2, 3, 4) if np.any(kind == k)]
    uniform = bool(np.all(kind == kind[0]))
    masks = {k: kind == k for k in present}
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)  # the rows on diagonal d
        a = recon[d + 1, 1 + y0:1 + y1]  # (y, x - 1)
        b = recon[d + 1, y0:y1]  # (y - 1, x)
        pred = 0
        for k in present:
            p = (a if k == 1 else b if k == 2 else (a + b) >> 1 if k == 3
                 else _paeth(a, b, recon[d, y0:y1]))
            pred = pred + (p if uniform else np.where(masks[k][y0:y1], p, 0))
        recon[d + 2, 1 + y0:1 + y1] = (sheared[d, y0:y1] + pred) & 0xFF
    out = recon[2:, 1:][np.arange(w)[None, :] + ys.T,
                        np.broadcast_to(ys.T, (h, w))]
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray, gray+alpha, RGB or RGBA, not interlaced, any
    row filters) -> ``[H, W]`` uint8 for gray, else ``[H, W, C]``: the
    arrays ``imageio.imread`` returns for the same files."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    c = _CHANNELS_OF.get(color)
    if depth != 8 or c is None or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}): 8-bit gray, gray+alpha, RGB or RGBA, "
            "not interlaced, is read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (1 + w * c)].reshape(h, 1 + w * c)
    filters = rows[:, 0]
    if np.any(filters > 4):
        raise ValueError(f"bad PNG row filter {int(filters.max())}")
    if np.any(filters >= 3):
        out = _unfilter_wavefront(rows[:, 1:], filters, w, c)
    else:
        out = _unfilter_rows(rows[:, 1:], filters, w, c)
    return out[..., 0] if c == 1 else out


def read_png(path: str) -> np.ndarray:
    """The image of the PNG file ``path`` (see ``decode_png``)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
