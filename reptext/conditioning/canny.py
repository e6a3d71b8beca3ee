"""Pure numpy/scipy Canny edge detector (cv2-free).

Matches the reference's conditioning semantics — ``cv2.Canny(img, 50, 100)``
then inverted to white background (reference: RepText/infer.py:16-22) — with
OpenCV's defaults: 3x3 Sobel aperture, no pre-blur, L1 gradient magnitude,
4-sector non-maximum suppression, and 8-connected hysteresis.

cv2 is not available in this environment; this implementation is deliberately
dependency-light (numpy + scipy.ndimage for the hysteresis flood fill).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)


def _sobel(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    gx = ndimage.convolve(img, _SOBEL_X[::-1, ::-1], mode="nearest")
    gy = ndimage.convolve(img, _SOBEL_Y[::-1, ::-1], mode="nearest")
    return gx, gy


def canny_edges(
    img: np.ndarray,
    low_threshold: float = 50.0,
    high_threshold: float = 100.0,
    backend: str = "auto",
) -> np.ndarray:
    """Binary edge map (uint8 {0,255}) of a grayscale or RGB uint8 image.

    For multi-channel input the per-pixel gradient is taken from the channel
    with the largest L1 magnitude (OpenCV's multi-channel behavior).

    ``backend``: 'auto' uses the native C++ implementation
    (reptext/native/canny.cpp) when a toolchain is available — ~10x the
    numpy path, relevant at serving QPS — else 'numpy'. Both produce identical
    output (tested).
    """
    if backend in ("auto", "native"):
        out = _canny_native(img, low_threshold, high_threshold)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native canny unavailable (no toolchain?)")
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3:
        gxs, gys = zip(*(_sobel(img[..., c]) for c in range(img.shape[-1])))
        mags = [np.abs(gx) + np.abs(gy) for gx, gy in zip(gxs, gys)]
        pick = np.argmax(np.stack(mags), axis=0)
        gx = np.take_along_axis(np.stack(gxs), pick[None], 0)[0]
        gy = np.take_along_axis(np.stack(gys), pick[None], 0)[0]
        mag = np.take_along_axis(np.stack(mags), pick[None], 0)[0]
    else:
        gx, gy = _sobel(img)
        mag = np.abs(gx) + np.abs(gy)

    # Non-maximum suppression with 4-sector angle quantization.
    # Sector by tan comparisons (avoids atan2): 0=horizontal-ish gradient
    # (edge vertical), 1=45deg, 2=vertical, 3=135deg.
    ax, ay = np.abs(gx), np.abs(gy)
    tan22 = 0.4142135623730951   # tan(22.5)
    tan67 = 2.414213562373095    # tan(67.5)
    sector = np.zeros(mag.shape, dtype=np.uint8)
    sector[(ay > tan22 * ax) & (ay <= tan67 * ax)] = 1
    sector[ay > tan67 * ax] = 2
    diag_neg = (gx * gy) < 0  # gradient pointing into the 135deg diagonal
    sector[(sector == 1) & diag_neg] = 3

    pad = np.pad(mag, 1, mode="constant")

    def sh(dy: int, dx: int) -> np.ndarray:
        h, w = mag.shape
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    n0 = np.where(sector == 0, np.maximum(sh(0, -1), sh(0, 1)), 0)
    n1 = np.where(sector == 1, np.maximum(sh(-1, -1), sh(1, 1)), 0)
    n2 = np.where(sector == 2, np.maximum(sh(-1, 0), sh(1, 0)), 0)
    n3 = np.where(sector == 3, np.maximum(sh(-1, 1), sh(1, -1)), 0)
    neighbor_max = n0 + n1 + n2 + n3
    nms = np.where(mag >= neighbor_max, mag, 0.0)

    strong = nms > high_threshold
    weak = nms > low_threshold

    # Hysteresis: keep weak pixels 8-connected to a strong pixel.
    labels, _ = ndimage.label(weak, structure=np.ones((3, 3), dtype=np.int32))
    keep_labels = np.unique(labels[strong & (labels > 0)])
    edges = np.isin(labels, keep_labels) & (labels > 0)
    return (edges * 255).astype(np.uint8)


def _canny_native(img: np.ndarray, low: float, high: float):
    """C++ path; returns None when the native library can't be built/loaded."""
    from reptext.native import ensure_built

    lib = ensure_built()
    if lib is None:
        return None
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        h, w = arr.shape
        c = 1
    else:
        h, w, c = arr.shape
    out = np.empty((h, w), dtype=np.uint8)
    lib.canny_u8(
        arr.ctypes.data, int(h), int(w), int(c), float(low), float(high),
        out.ctypes.data,
    )
    return out


def inverted_canny_rgb(
    img: np.ndarray,
    low_threshold: float = 50.0,
    high_threshold: float = 100.0,
) -> np.ndarray:
    """The RepText canny conditioning image: 255 - edges, replicated to RGB.

    Black edges on a white background, [H, W, 3] uint8 (reference:
    RepText/infer.py:16-22).
    """
    edges = canny_edges(img, low_threshold, high_threshold)
    inv = (255 - edges).astype(np.uint8)
    return np.repeat(inv[:, :, None], 3, axis=2)
