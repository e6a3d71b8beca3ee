"""OCR glyph-accuracy judge (reptext/eval/ocr.py).

Fast tier: decode/edit-distance unit tests + frozen-weight separation checks
(the committed benchmarks/ocr_judge.npz must score ~1 on clean renders and
~0 on noise — the discrimination the edge-IoU proxy lacks, VERDICT r2 #2).
Training itself is exercised by benchmarks/train_ocr_judge.py, not here.
"""

import os

import numpy as np
import pytest

from reptext.eval import ocr

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "ocr_judge.npz",
)


def test_decode_collapses_repeats_and_blanks():
    k = len(ocr.CHARSET)
    t, classes = 6, k + 1
    logits = np.full((1, t, classes), -10.0, np.float32)
    # frames: A A blank A B B  -> "AAB" (repeat collapse is per-run, blank
    # separates two runs of A)
    a = ocr.CHAR_TO_ID["A"]
    b = ocr.CHAR_TO_ID["B"]
    for frame, cls in enumerate([a, a, 0, a, b, b]):
        logits[0, frame, cls] = 10.0
    assert ocr.decode_logits(logits) == ["AAB"]


def test_edit_distance():
    assert ocr._edit_distance("", "abc") == 3
    assert ocr._edit_distance("abc", "abc") == 0
    assert ocr._edit_distance("abc", "axc") == 1
    assert ocr._edit_distance("abc", "ab") == 1
    assert ocr._edit_distance("kitten", "sitting") == 3


def test_charset_covers_data_pools():
    """Every character the training data pools render must be labelable."""
    from reptext.data import DEFAULT_WORDS

    for word in DEFAULT_WORDS:
        for ch in word:
            assert ch in ocr.CHAR_TO_ID, (word, ch)


def test_prepare_crop_shapes_and_standardization():
    crop = ocr.prepare_crop(np.random.default_rng(0).random((40, 90, 3)))
    assert crop.shape == (ocr.IMG_H, ocr.IMG_W, 1)
    assert abs(float(crop.mean())) < 1e-3
    empty = ocr.prepare_crop(np.zeros((0, 5)))
    assert empty.shape == (ocr.IMG_H, ocr.IMG_W, 1)


def test_render_word_shapes_arabic():
    """The judge reads the same shaped forms the pipeline renders."""
    img = ocr.render_word("مرحبا", font_size=40)
    assert img.ndim == 2 and img.max() > 0.5  # ink present
    # isolated-forms rendering differs from shaped: widths must differ from
    # per-letter concatenation only through shaping; just sanity-check size
    assert img.shape[1] > img.shape[0]  # a word is wider than tall


@pytest.mark.skipif(not os.path.isfile(WEIGHTS), reason="no frozen judge")
def test_frozen_judge_separates():
    """The committed weights give char accuracy ~1 on clean renders and ~0 on
    noise — the separation evidence the north star requires."""
    params = ocr.load_judge(WEIGHTS)
    rng = np.random.default_rng(5)
    words = [ocr.random_word(rng) for _ in range(16)]
    clean = [ocr.render_word(w, font_size=40) for w in words]
    noise = [rng.random((40, 100)).astype(np.float32) for _ in words]
    acc_clean = ocr.char_accuracy(clean, words, params)
    acc_noise = ocr.char_accuracy(noise, words, params)
    assert acc_clean > 0.85, acc_clean
    assert acc_noise < 0.1, acc_noise


@pytest.mark.skipif(not os.path.isfile(WEIGHTS), reason="no frozen judge")
def test_frozen_judge_polarity_and_contrast_invariance():
    """Sampled images render text in arbitrary polarity/contrast; the judge
    is trained invariant to both."""
    params = ocr.load_judge(WEIGHTS)
    words = ["OPEN", "سلام", "2026"]
    imgs = [ocr.render_word(w, font_size=44) for w in words]
    inverted = [1.0 - 0.8 * im for im in imgs]          # dark-on-bright
    low_contrast = [0.4 + 0.3 * im for im in imgs]
    assert ocr.char_accuracy(inverted, words, params) > 0.8
    assert ocr.char_accuracy(low_contrast, words, params) > 0.8
