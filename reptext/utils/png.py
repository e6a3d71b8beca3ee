"""PNG encode and decode with the standard library's ``zlib`` and numpy.

Covers what the pipelines read and write: 8-bit grayscale (L), RGB and RGBA,
non-interlaced. Any other image, PNG variant or format raises ``ValueError``
naming what it found.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}           # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_OTHER_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
    (b"RIFF", "WEBP/RIFF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W] (L), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes.

    Every row uses the Up filter (difference with the row above), which
    compresses photographs well and costs one vectorised subtraction.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG encode needs uint8 pixels, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    if arr.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"PNG encode takes [H, W] or [H, W, 3|4], got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, w * channels)
    up = rows - np.concatenate([np.zeros((1, rows.shape[1]), np.uint8), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: cumulative sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte depends on its left
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"corrupt PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (L), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    if not data.startswith(_SIGNATURE):
        for magic, name in _OTHER_FORMATS:
            if data.startswith(magic):
                raise ValueError(f"{name} images are not supported; use PNG")
        raise ValueError("not a PNG image")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        kind = {3: "palette", 4: "grayscale+alpha"}.get(ctype, f"colour type {ctype}")
        raise ValueError(f"unsupported PNG: {kind}, {depth}-bit (8-bit L, RGB, "
                         "RGBA only)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("corrupt PNG: pixel data has the wrong size")
    pixels = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
    return pixels.reshape(h, w) if bpp == 1 else pixels.reshape(h, w, bpp)
