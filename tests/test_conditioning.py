"""Glyph rendering, masks, canny — deterministic frontend tests."""

import numpy as np

from reptext.conditioning import (
    TextLine,
    build_conditions,
    canny_edges,
    inverted_canny_rgb,
)


def test_canny_rectangle_edges():
    img = np.zeros((64, 64), dtype=np.uint8)
    img[16:48, 16:48] = 255
    edges = canny_edges(img)
    assert edges.dtype == np.uint8
    assert set(np.unique(edges)).issubset({0, 255})
    # edges around the rectangle border, none deep inside or far outside
    assert edges[15:18, 16:48].any() or edges[16:48, 15:18].any()
    assert not edges[30:34, 30:34].any()
    assert not edges[:8, :8].any()


def test_canny_blank_image_no_edges():
    assert not canny_edges(np.zeros((32, 32), np.uint8)).any()
    assert not canny_edges(np.full((32, 32), 200, np.uint8)).any()


def test_inverted_canny_rgb_format():
    img = np.zeros((32, 32), np.uint8)
    img[8:24, 8:24] = 255
    out = inverted_canny_rgb(img)
    assert out.shape == (32, 32, 3)
    # white background, black edges (inverted)
    assert (out[0, 0] == 255).all()
    assert (out == 0).any()
    # channels identical
    assert (out[..., 0] == out[..., 1]).all() and (out[..., 1] == out[..., 2]).all()


def test_build_conditions_latin():
    conds = build_conditions(
        [TextLine("Shakker", (32, 40)), TextLine("Labs", (32, 120))],
        width=256, height=256, font_size=40,
    )
    assert conds.num_lines == 2
    assert conds.glyph_canvas.shape == (256, 256, 3)
    assert conds.glyph_canvas.any()
    for lc in conds.lines:
        x0, y0, x1, y1 = lc.bbox
        assert x1 > x0 and y1 > y0
        # position mask covers exactly the bbox
        assert lc.position_mask[y0:y1, x0:x1].all()
        assert lc.position_mask.sum() == 255 * (y1 - y0) * (x1 - x0)
        # region mask strictly contains position mask (5px dilation)
        assert (lc.region_mask >= lc.position_mask).all()
        assert lc.region_mask.sum() > lc.position_mask.sum()
        # canny: white background with black strokes inside the bbox region
        assert (lc.canny_image[0, 0] == 255).all()
        assert (lc.canny_image[y0:y1, x0:x1] == 0).any()
        # glyph drawn within bbox only
        outside = lc.glyph_image.copy()
        outside[y0:y1, x0:x1] = 0
        assert not outside.any()


def test_build_conditions_arabic_renders_connected():
    conds = build_conditions(
        [TextLine("السلام عليكم", (20, 80))],
        width=320, height=192, font_size=48,
    )
    lc = conds.lines[0]
    assert lc.glyph_image.any(), "Arabic text must render visible glyphs"
    # Shaped text renders different pixels than unshaped (joined forms).
    raw = build_conditions(
        [TextLine("السلام عليكم", (20, 80))],
        width=320, height=192, font_size=48, shape_text=False,
    )
    assert (lc.glyph_image != raw.lines[0].glyph_image).any()


def test_conditions_deterministic():
    a = build_conditions([TextLine("Test", (10, 10))], 128, 128, font_size=32)
    b = build_conditions([TextLine("Test", (10, 10))], 128, 128, font_size=32)
    np.testing.assert_array_equal(a.glyph_canvas, b.glyph_canvas)
    np.testing.assert_array_equal(a.lines[0].canny_image, b.lines[0].canny_image)


def test_per_line_font_size_override():
    conds = build_conditions(
        [TextLine("big", (10, 10), font_size=64), TextLine("small", (10, 100), font_size=20)],
        256, 256, font_size=40,
    )
    big = conds.lines[0].bbox
    small = conds.lines[1].bbox
    assert (big[3] - big[1]) > (small[3] - small[1])
