"""A small PNG encoder and decoder on the standard library (zlib + struct).

The server writes 8-bit RGB PNGs with no row filter; ``decode_png`` reads
what ``encode_png`` writes (and any 8-bit RGB/RGBA PNG with unfiltered
rows), so a client and the tests need nothing beyond numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 -> PNG bytes."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    # Filter byte 0 ("None") in front of every row.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, unfiltered rows) -> ``[H, W, C]`` uint8."""
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
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, color {color}, "
                         f"interlace {interlace})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * channels)
    if np.any(rows[:, 0] != 0):
        raise ValueError("filtered PNG rows are not supported")
    return rows[:, 1:].reshape(h, w, channels).copy()
