"""PNG codec (utils/png.py) and TrueType rasterizer (conditioning/ttf.py),
with Pillow as the test-only reference."""

import io

import numpy as np
import pytest

from reptext.conditioning.arabic import prepare_display_text
from reptext.conditioning.ttf import DEFAULT_FONT, Font
from reptext.utils.image import load_image, resize_image
from reptext.utils.png import decode_png, encode_png

Image = pytest.importorskip("PIL.Image")
ImageDraw = pytest.importorskip("PIL.ImageDraw")
ImageFont = pytest.importorskip("PIL.ImageFont")

_MODES = {"L": (37, 53), "RGB": (29, 41, 3), "RGBA": (17, 64, 4)}


def _pixels(shape, seed=0):
    r = np.random.default_rng(seed)
    smooth = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3 % 256
    if len(shape) == 3:
        smooth = smooth[:, :, None] + np.arange(shape[2]) * 40
    noise = r.integers(0, 16, shape)
    return ((smooth + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_our_png_decodes_in_pil(mode):
    arr = _pixels(_MODES[mode])
    got = Image.open(io.BytesIO(encode_png(arr)))
    assert got.mode == mode
    np.testing.assert_array_equal(np.asarray(got), arr)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_pil_png_decodes_here(mode):
    # PIL picks Sub/Up/Average/Paeth per row: every filter is exercised
    arr = _pixels(_MODES[mode], seed=1)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), arr)


def test_load_image_converts_like_pil():
    arr = _pixels((21, 30, 4), seed=2)
    data = encode_png(arr)
    pil = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(load_image(data, "RGB"), np.asarray(pil.convert("RGB")))
    np.testing.assert_array_equal(load_image(data, "L"), np.asarray(pil.convert("L")))
    gray = encode_png(_pixels((8, 9), seed=3))
    assert load_image(gray, "RGB").shape == (8, 9, 3)


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"), ("BMP", "BMP")])
def test_other_formats_are_refused_by_name(fmt, name):
    buf = io.BytesIO()
    Image.fromarray(_pixels((8, 8, 3)), "RGB").save(buf, format=fmt)
    with pytest.raises(ValueError, match=name):
        decode_png(buf.getvalue())


def test_palette_png_is_refused():
    buf = io.BytesIO()
    Image.fromarray(_pixels((8, 8, 3)), "RGB").convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="palette"):
        decode_png(buf.getvalue())


def test_resize_image_shapes_and_range():
    arr = _pixels((40, 60, 3))
    out = resize_image(arr, 25, 33)
    assert out.shape == (25, 33, 3) and out.dtype == np.uint8
    assert resize_image(arr, 40, 60) is arr
    flat = np.full((16, 16), 200, np.uint8)
    np.testing.assert_array_equal(resize_image(flat, 7, 9, "linear"), 200)


def _pil_render(text, size, pos, canvas=(900, 220)):
    font = ImageFont.truetype(DEFAULT_FONT, size, layout_engine=ImageFont.Layout.BASIC)
    img = Image.new("L", canvas, 0)
    draw = ImageDraw.Draw(img)
    draw.text(pos, text, font=font, fill=255)
    return np.asarray(img), draw.textbbox(pos, text, font=font)


@pytest.mark.parametrize("text,size", [
    ("Hello World", 80), ("Grand Opening 2025", 48),
    ("مرحبا بالعالم", 80), ("سوق المدينة", 64),
])
def test_rasterizer_matches_pil(text, size):
    display = prepare_display_text(text)
    pos = (37, 51)
    ref, ref_box = _pil_render(display, size, pos)
    font = Font(DEFAULT_FONT, size)
    ours = font.coverage(display, pos, ref.shape[1], ref.shape[0])
    box = font.bbox(display, pos)
    assert max(abs(a - b) for a, b in zip(box, ref_box)) <= 2, (box, ref_box)
    a, b = ref > 127, ours > 127
    iou = (a & b).sum() / (a | b).sum()
    assert iou >= 0.9, iou


def test_glyph_line_is_colored_ink_on_black():
    from reptext.conditioning import TextLine, build_conditions

    conds = build_conditions([TextLine("Hi", (4, 4), color=(200, 100, 50))], 96, 64,
                             font_size=32)
    img = conds.lines[0].glyph_image
    ink = img.max(axis=-1) > 0
    assert ink.any() and img[~ink].max() == 0
    full = img[img[:, :, 0] == 200]
    assert len(full) and (full[:, 1] == 100).all() and (full[:, 2] == 50).all()
    x0, y0, x1, y1 = conds.lines[0].bbox
    ys, xs = np.nonzero(ink)
    assert x0 <= xs.min() and xs.max() < x1 + 1 and y0 <= ys.min() and ys.max() < y1 + 1
