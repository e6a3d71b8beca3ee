"""Token-span finder + resize utility tests."""

import numpy as np

from reptext.utils.image import resize_to_multiple
from reptext.utils.text_span import find_token_span, render_text_spans, span_mask


def test_find_token_span():
    assert find_token_span([1, 2, 3, 4, 5], [3, 4]) == (2, 4)
    assert find_token_span([1, 2, 3], [3, 4]) is None
    assert find_token_span([1, 2], [1, 2, 3]) is None
    assert find_token_span([5, 5, 5], []) is None
    assert find_token_span([7, 8, 7, 8], [7, 8]) == (0, 2)  # first occurrence


def test_render_text_spans_strips_special():
    prompt = [10, 20, 30, 40, 1]
    spans = render_text_spans(prompt, [[20, 30, 1, 0], [99, 1]])
    assert spans == [(1, 3), None]


def test_span_mask():
    m = span_mask(6, (2, 4))
    np.testing.assert_array_equal(m, [0, 0, 1, 1, 0, 0])
    assert span_mask(4, None).sum() == 0


def test_resize_to_multiple():
    img = np.zeros((1000, 700, 3), np.uint8)
    out = resize_to_multiple(img, multiple=64, max_side=1536, min_side=768)
    h, w = out.shape[:2]
    assert h % 64 == 0 and w % 64 == 0
    # aspect ratio roughly preserved
    assert abs((h / w) - (1000 / 700)) < 0.15

    small = np.zeros((100, 200, 3), np.uint8)
    out2 = resize_to_multiple(small)
    assert max(out2.shape[:2]) >= 768  # upscaled to min_side
    assert out2.shape[0] % 64 == 0 and out2.shape[1] % 64 == 0

    big = np.zeros((4000, 2000, 3), np.uint8)
    out3 = resize_to_multiple(big)
    assert max(out3.shape[:2]) <= 1536 + 63
