"""A TrueType reader and rasterizer for glyph conditioning images.

Reads the tables text rendering needs: ``head``, ``hhea``, ``maxp``,
``cmap`` (formats 4 and 12), ``hmtx``, ``loca`` and ``glyf`` (simple and
composite glyphs). Quadratic outlines are
flattened to line segments and filled by the non-zero winding rule with
supersampled coverage, so the result is an anti-aliased 8-bit mask.

Layout follows ``PIL.ImageDraw.text`` with FreeType's basic layout: the
anchor is the left end of the ascender line, the pen moves by advances
rounded to whole pixels, and no kerning applies. Text arrives already shaped
and in visual order (conditioning/arabic.py), one glyph per code point.
"""

from __future__ import annotations

import functools
import math
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

DEFAULT_FONT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "fonts", "DejaVuSans.ttf")

_SUPERSAMPLE = 8        # sub-samples per pixel along each axis
_CURVE_STEPS = 8        # line segments per quadratic Bezier


class TrueTypeFont:
    """Glyph outlines and metrics of one TrueType (glyf-outline) font file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = data = f.read()
        n = struct.unpack(">H", data[4:6])[0]
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(n):
            tag, _, off, length = struct.unpack(">4sIII", data[12 + 16 * i:28 + 16 * i])
            self.tables[tag] = (off, length)
        for tag in (b"head", b"hhea", b"maxp", b"cmap", b"hmtx", b"loca", b"glyf"):
            if tag not in self.tables:
                raise ValueError(f"{path}: not a TrueType outline font (no {tag.decode()})")
        head = self.tables[b"head"][0]
        self.units_per_em = struct.unpack(">H", data[head + 18:head + 20])[0]
        long_loca = struct.unpack(">h", data[head + 50:head + 52])[0] == 1
        hhea = self.tables[b"hhea"][0]
        self.ascender, self.descender = struct.unpack(">hh", data[hhea + 4:hhea + 8])
        n_hmetrics = struct.unpack(">H", data[hhea + 34:hhea + 36])[0]
        maxp = self.tables[b"maxp"][0]
        self.num_glyphs = struct.unpack(">H", data[maxp + 4:maxp + 6])[0]

        hmtx = self.tables[b"hmtx"][0]
        adv = np.frombuffer(data, ">u2", n_hmetrics * 2, hmtx)[0::2].astype(np.int64)
        self.advances = np.concatenate(
            [adv, np.full(max(self.num_glyphs - n_hmetrics, 0), adv[-1])])
        loca = self.tables[b"loca"][0]
        if long_loca:
            self.loca = np.frombuffer(data, ">u4", self.num_glyphs + 1, loca).astype(np.int64)
        else:
            self.loca = np.frombuffer(data, ">u2", self.num_glyphs + 1, loca).astype(np.int64) * 2
        self.cmap = self._read_cmap()

    # ---------------------------------------------------------------- tables

    def _read_cmap(self) -> Dict[int, int]:
        data = self.data
        base = self.tables[b"cmap"][0]
        n = struct.unpack(">H", data[base + 2:base + 4])[0]
        best = None
        for i in range(n):
            pid, eid, off = struct.unpack(">HHI", data[base + 4 + 8 * i:base + 12 + 8 * i])
            fmt = struct.unpack(">H", data[base + off:base + off + 2])[0]
            if (pid, eid) in ((3, 10), (0, 4), (0, 6)) and fmt == 12:
                best = (12, base + off)
                break
            if (pid, eid) in ((3, 1), (0, 3), (0, 1), (0, 0)) and fmt == 4:
                best = best or (4, base + off)
        if best is None:
            raise ValueError("font has no Unicode cmap (format 4 or 12)")
        fmt, off = best
        out: Dict[int, int] = {}
        if fmt == 12:
            groups = struct.unpack(">I", data[off + 12:off + 16])[0]
            for g in range(groups):
                start, end, gid = struct.unpack(">III", data[off + 16 + 12 * g:off + 28 + 12 * g])
                for c in range(start, end + 1):
                    out[c] = gid + c - start
            return out
        segs = struct.unpack(">H", data[off + 6:off + 8])[0] // 2
        arr = lambda k: np.frombuffer(data, ">u2", segs, off + 14 + k * 2 * segs + (2 if k else 0))  # noqa: E731
        ends, starts, deltas, ranges = arr(0), arr(1), arr(2), arr(3)
        range_base = off + 16 + 6 * segs
        for s in range(segs):
            start, end = int(starts[s]), int(ends[s])
            for c in range(start, min(end, 0xFFFE) + 1):
                if ranges[s] == 0:
                    gid = (c + int(deltas[s])) & 0xFFFF
                else:
                    at = range_base + 2 * s + int(ranges[s]) + 2 * (c - start)
                    gid = struct.unpack(">H", data[at:at + 2])[0]
                    if gid:
                        gid = (gid + int(deltas[s])) & 0xFFFF
                if gid:
                    out[c] = gid
        return out

    # --------------------------------------------------------------- glyphs

    def glyph_id(self, char: str) -> int:
        return self.cmap.get(ord(char), 0)

    @functools.lru_cache(maxsize=4096)
    def contours(self, gid: int) -> Tuple[np.ndarray, ...]:
        """Outline of glyph ``gid``: per contour, [N, 3] (x, y, on_curve)
        in font units (composites resolved)."""
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end <= start:
            return ()
        data = self.data
        off = self.tables[b"glyf"][0] + start
        n_contours = struct.unpack(">h", data[off:off + 2])[0]
        if n_contours >= 0:
            return self._simple(off, n_contours)
        return self._composite(off)

    def _simple(self, off: int, n_contours: int) -> Tuple[np.ndarray, ...]:
        data = self.data
        p = off + 10
        ends = np.frombuffer(data, ">u2", n_contours, p).astype(np.int64)
        p += 2 * n_contours
        n_points = int(ends[-1]) + 1 if n_contours else 0
        p += 2 + struct.unpack(">H", data[p:p + 2])[0]          # skip instructions
        flags = []
        while len(flags) < n_points:
            f = data[p]
            p += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * data[p])
                p += 1
        flags = flags[:n_points]

        def coords(short_bit, same_bit):
            nonlocal p
            vals, v = [], 0
            for f in flags:
                if f & short_bit:
                    d = data[p]
                    p += 1
                    v += d if f & same_bit else -d
                elif not f & same_bit:
                    v += struct.unpack(">h", data[p:p + 2])[0]
                    p += 2
                vals.append(v)
            return vals

        xs = coords(2, 16)
        ys = coords(4, 32)
        pts = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                        np.asarray([f & 1 for f in flags], np.float64)], axis=1)
        out, s = [], 0
        for e in ends.tolist():
            out.append(pts[s:e + 1])
            s = e + 1
        return tuple(out)

    def _composite(self, off: int) -> Tuple[np.ndarray, ...]:
        data = self.data
        p = off + 10
        out: List[np.ndarray] = []
        while True:
            flags, gid = struct.unpack(">HH", data[p:p + 4])
            p += 4
            if flags & 1:                                         # ARG_1_AND_2_ARE_WORDS
                a1, a2 = struct.unpack(">hh", data[p:p + 4])
                p += 4
            else:
                a1, a2 = struct.unpack(">bb", data[p:p + 2])
                p += 2
            dx, dy = (a1, a2) if flags & 2 else (0, 0)            # ARGS_ARE_XY_VALUES
            m = np.eye(2)
            f2d14 = lambda q: struct.unpack(">h", data[q:q + 2])[0] / 16384.0  # noqa: E731
            if flags & 8:                                         # WE_HAVE_A_SCALE
                m = np.eye(2) * f2d14(p)
                p += 2
            elif flags & 0x40:                                    # X_AND_Y_SCALE
                m = np.diag([f2d14(p), f2d14(p + 2)])
                p += 4
            elif flags & 0x80:                                    # TWO_BY_TWO
                m = np.array([[f2d14(p), f2d14(p + 4)], [f2d14(p + 2), f2d14(p + 6)]])
                p += 8
            for c in self.contours(gid):
                xy = c[:, :2] @ m.T + np.array([dx, dy], np.float64)
                out.append(np.concatenate([xy, c[:, 2:]], axis=1))
            if not flags & 0x20:                                  # MORE_COMPONENTS
                break
        return tuple(out)


@functools.lru_cache(maxsize=8)
def load_font(path: str = DEFAULT_FONT) -> TrueTypeFont:
    return TrueTypeFont(path)


def _flatten(contour: np.ndarray) -> np.ndarray:
    """One closed contour -> [N, 2] polygon (quadratic segments sampled)."""
    n = len(contour)
    if n < 2:
        return np.zeros((0, 2))
    on = contour[:, 2] > 0
    pts = contour[:, :2]
    # start at an on-curve point (or the midpoint of two off-curve ones)
    if on.any():
        k = int(np.argmax(on))
        pts, on = np.roll(pts, -k, axis=0), np.roll(on, -k)
    else:
        mid = (pts[0] + pts[1]) / 2
        pts, on = np.vstack([mid, pts[1:], pts[:1]]), np.concatenate([[True], on[1:], on[:1]])
    out = [pts[0]]
    t = np.linspace(0, 1, _CURVE_STEPS + 1)[1:, None]
    i, m = 1, len(pts)
    ctrl = None
    cur = pts[0]
    while i <= m:
        p, is_on = pts[i % m], on[i % m]
        if is_on:
            if ctrl is None:
                out.append(p)
            else:
                out.extend((1 - t) ** 2 * cur + 2 * (1 - t) * t * ctrl + t ** 2 * p)
                ctrl = None
            cur = p
        else:
            if ctrl is not None:
                mid = (ctrl + p) / 2
                out.extend((1 - t) ** 2 * cur + 2 * (1 - t) * t * ctrl + t ** 2 * mid)
                cur = mid
            ctrl = p
        i += 1
    if ctrl is not None:
        out.extend((1 - t) ** 2 * cur + 2 * (1 - t) * t * ctrl + t ** 2 * pts[0])
    return np.asarray(out)


class Font:
    """A font at one pixel size: layout, ink box and rasterization."""

    def __init__(self, path: str = DEFAULT_FONT, size: int = 80):
        self.face = load_font(path)
        self.size = size
        self.scale = size / self.face.units_per_em
        self.ascent = math.ceil(self.face.ascender * self.scale)

    def _layout(self, text: str) -> Tuple[List[Tuple[int, int]], int]:
        """([(glyph id, pen x in pixels)] per character, total advance)."""
        face, pen, out = self.face, 0, []
        for ch in text:
            gid = face.glyph_id(ch)
            out.append((gid, pen))
            pen += round(int(face.advances[gid]) * self.scale)
        return out, pen

    def _edges(self, text: str, x: float, y: float) -> np.ndarray:
        """[E, 4] polygon edges (x0, y0, x1, y1) in pixels; y grows down."""
        base = y + self.ascent
        edges = []
        for gid, pen in self._layout(text)[0]:
            for c in self.face.contours(gid):
                poly = _flatten(c)
                if len(poly) < 2:
                    continue
                px = x + pen + poly[:, 0] * self.scale
                py = base - poly[:, 1] * self.scale
                pts = np.stack([px, py], 1)
                edges.append(np.concatenate([pts, np.roll(pts, -1, axis=0)], 1))
        return np.concatenate(edges) if edges else np.zeros((0, 4))

    def coverage(self, text: str, position: Tuple[int, int], width: int,
                 height: int) -> np.ndarray:
        """uint8 [height, width] anti-aliased ink of ``text`` drawn with its
        ascender line's left end at ``position``."""
        out = np.zeros((height, width), np.uint8)
        edges = self._edges(text, float(position[0]), float(position[1]))
        edges = edges[edges[:, 1] != edges[:, 3]]
        if not len(edges):
            return out
        # rasterize only the text's box, clipped to the canvas
        xa = max(int(math.floor(edges[:, 0::2].min())), 0)
        ya = max(int(math.floor(edges[:, 1::2].min())), 0)
        w = min(int(math.ceil(edges[:, 0::2].max())) + 1, width) - xa
        h = min(int(math.ceil(edges[:, 1::2].max())) + 1, height) - ya
        if w <= 0 or h <= 0:
            return out
        s = _SUPERSAMPLE
        edges = (edges - np.array([xa, ya, xa, ya], np.float64)) * s
        x0, y0, x1, y1 = edges.T
        direction = np.where(y1 > y0, 1, -1)
        lo, hi = np.minimum(y0, y1), np.maximum(y0, y1)
        # sample rows r (centre r + 0.5) with lo <= r + 0.5 < hi
        r0 = np.clip(np.ceil(lo - 0.5), 0, h * s).astype(np.int64)
        r1 = np.clip(np.ceil(hi - 0.5), 0, h * s).astype(np.int64)
        counts = r1 - r0
        total = int(counts.sum())
        if not total:
            return out
        idx = np.repeat(np.arange(len(edges)), counts)
        rows = np.repeat(r0, counts) + (np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
        yc = rows + 0.5
        xc = x0[idx] + (yc - y0[idx]) * (x1[idx] - x0[idx]) / (y1[idx] - y0[idx])
        cols = np.ceil(xc - 0.5).astype(np.int64)
        keep = cols < w * s
        winding = np.zeros((h * s, w * s + 1), np.int32)
        np.add.at(winding, (rows[keep], np.maximum(cols[keep], 0)), direction[idx][keep])
        inside = np.cumsum(winding[:, :-1], axis=1) != 0
        cov = inside.reshape(h, s, w, s).sum(axis=(1, 3))
        out[ya:ya + h, xa:xa + w] = np.round(cov * (255.0 / (s * s))).astype(np.uint8)
        return out

    def bbox(self, text: str, position: Tuple[int, int]) -> Tuple[int, int, int, int]:
        """(x0, y0, x1, y1), x1/y1 exclusive, as ``ImageDraw.textbbox``:
        horizontally the pen's span joined with the ink, vertically the ink."""
        x, y = position
        end = x + self._layout(text)[1]
        edges = self._edges(text, float(x), float(y))
        if not len(edges):
            return x, y, int(math.ceil(end)), y
        xs, ys = edges[:, 0::2], edges[:, 1::2]
        return (min(x, int(math.floor(xs.min()))), int(math.floor(ys.min())),
                max(int(math.ceil(end)), int(math.ceil(xs.max()))),
                int(math.ceil(ys.max())))
