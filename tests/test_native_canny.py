"""Native C++ canny: parity with the numpy reference implementation + speed."""

import time

import numpy as np
import pytest

from reptext.conditioning.canny import canny_edges
from reptext.native import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain / native build failed"
)


def _glyph_image(h=256, w=256, seed=0):
    from reptext.conditioning import TextLine, build_conditions

    conds = build_conditions(
        [TextLine("مرحبا Test", (20, h // 2 - 20), font_size=40)], w, h
    )
    return conds.lines[0].glyph_image


def test_native_matches_numpy_on_glyphs():
    img = _glyph_image()
    a = canny_edges(img, backend="numpy")
    b = canny_edges(img, backend="native")
    mismatch = (a != b).mean()
    assert mismatch < 0.002, f"{mismatch:.4%} pixels differ"


def test_native_matches_numpy_on_noise():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (128, 128, 3), np.uint8)
    a = canny_edges(img, backend="numpy")
    b = canny_edges(img, backend="native")
    assert (a != b).mean() < 0.02  # float-order ties on noise


def test_native_grayscale_input():
    img = np.zeros((64, 64), np.uint8)
    img[16:48, 16:48] = 255
    out = canny_edges(img, backend="native")
    assert out.shape == (64, 64)
    assert set(np.unique(out)).issubset({0, 255})
    assert out.any() and not out[30:34, 30:34].any()


def test_native_faster_than_numpy():
    img = _glyph_image(1024, 1024)
    canny_edges(img, backend="native")  # warm build
    t0 = time.perf_counter(); canny_edges(img, backend="numpy"); t_np = time.perf_counter() - t0
    t0 = time.perf_counter(); canny_edges(img, backend="native"); t_nat = time.perf_counter() - t0
    assert t_nat < t_np, (t_nat, t_np)
