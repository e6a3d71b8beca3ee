"""Differentiable OCR text-perceptual loss (the RepText paper's missing term).

The reference carries vestigial machinery for a text-perceptual loss — prompt
span extraction computed and then never used
(RepText/pipeline_flux_controlnet.py:239-277,423-430) — because the published
repo ships no training code at all (SURVEY.md §0). This module implements the
term end-to-end and in-graph:

    x0_pred = x_t − t · v_pred              (rectified-flow identity)
    image   = VAE.decode(x0_pred)           (frozen decoder, differentiable)
    crop    = crop_and_resize(image, box)   (ops/crop.py, known text boxes)
    loss    = CTC(OCRJudge(crop), label)    (frozen judge, optax.ctc_loss)

Everything stays inside one jitted training step: no host round-trip, no
external OCR engine. The frozen judge (eval/ocr.py, weights
benchmarks/ocr_judge.npz) was trained polarity/contrast/blur-invariant on the
same synthetic render distribution, so its gradients score ink SHAPE.

Differentiable-vs-eval preprocessing: eval-time ``prepare_crop`` canonicalizes
tightness by detecting the ink bbox (data-dependent — not jittable). Training
knows the ground-truth text box, so the dataset precomputes an equivalent
crop window host-side (:func:`aspect_box`: pad-fraction margin around the
glyph bbox, then widened/heightened to the judge's 4:1 aspect so one bilinear
resize is aspect-preserving), and the in-graph path is crop → grayscale →
per-crop standardization — matching ``prepare_crop`` semantics on exact-box
crops.

Timestep weighting: at t→1 the model predicts x0 from (almost) pure noise and
a legibility penalty is uninformative, so per-sample CTC is ramped by (1−t).

Measured calibration (benchmarks/ocr_loss_ab.json): on the tiny overfit
MEMORIZATION demo the term is negative-to-neutral (mean char-acc −0.048 over
3 seed pairs at weight 0.3) — the velocity loss already saturates glyph
shape there. It is opt-in (default 0); its intended regime is large-corpus
generalization training, where pixel velocity underdetermines legibility.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from reptext.eval.ocr import IMG_H, IMG_W, OCRJudge
from reptext.ops.crop import crop_and_resize

# judge input aspect (W/H = 4) — boxes are extended to this before cropping
_ASPECT = IMG_W / IMG_H


def aspect_box(
    ink_bbox: Tuple[int, int, int, int],
    height: int,
    width: int,
    pad_frac: float = 0.18,
) -> np.ndarray:
    """Ground-truth glyph bbox -> normalized judge crop window [y0,x0,y1,x1].

    Mirrors eval-time canonicalization (eval/ocr.py::_canonicalize +
    _resize_box) using the KNOWN box instead of ink detection: add a
    ``pad_frac``-of-ink-height margin, then extend symmetrically to the
    judge's 4:1 aspect so the single bilinear resize in the loss preserves
    aspect. The extension samples real image background — the equivalent of
    _resize_box's border-median padding. May extend past the image edge;
    crop_and_resize clamps (edge padding).
    """
    y0, x0, y1, x1 = (float(v) for v in ink_bbox)
    pad = max(2.0, pad_frac * max(y1 - y0, 1.0))
    y0, x0, y1, x1 = y0 - pad, x0 - pad, y1 + pad, x1 + pad
    bh, bw = y1 - y0, x1 - x0
    if bw < _ASPECT * bh:                      # too narrow: widen
        extra = (_ASPECT * bh - bw) / 2.0
        x0, x1 = x0 - extra, x1 + extra
    else:                                      # too wide: heighten
        extra = (bw / _ASPECT - bh) / 2.0
        y0, y1 = y0 - extra, y1 + extra
    return np.asarray(
        [y0 / height, x0 / width, y1 / height, x1 / width], np.float32
    )


def glyph_ink_bbox(canvas: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(y0, x0, y1, x1) of rendered ink in an RGB glyph canvas; None if blank."""
    ink = (np.asarray(canvas) > 0).any(axis=-1)
    rows = np.flatnonzero(ink.any(axis=1))
    cols = np.flatnonzero(ink.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return None
    return int(rows[0]), int(cols[0]), int(rows[-1]) + 1, int(cols[-1]) + 1


def standardize_crops(crops: jax.Array) -> jax.Array:
    """Per-crop mean-0 / std-1 (differentiable eval/ocr.py::_standardize)."""
    m = crops.mean(axis=(1, 2, 3), keepdims=True)
    s = crops.std(axis=(1, 2, 3), keepdims=True)
    return (crops - m) / (s + 1e-5)


def ocr_logits_from_images(
    images: jax.Array, boxes: jax.Array, judge_params, judge_apply=None
) -> jax.Array:
    """[B,H,W,3] images (any affine range) + [B,4] boxes -> CTC logits [B,T,K]."""
    g = images.astype(jnp.float32).mean(axis=-1, keepdims=True)
    crops = crop_and_resize(g, boxes, IMG_H, IMG_W)
    crops = standardize_crops(crops)
    apply = judge_apply or OCRJudge().apply
    return apply(judge_params, crops)


def ocr_ctc_loss(
    images: jax.Array,
    boxes: jax.Array,
    labels: jax.Array,
    label_paddings: jax.Array,
    judge_params,
    judge_apply=None,
    sample_weights: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-character-normalized CTC loss of text regions vs known labels.

    labels [B, L] int32 (eval/ocr.py CHAR_TO_ID, 0-padded), label_paddings
    [B, L] float (1.0 = pad). sample_weights [B] optionally scales each
    sample's contribution (used for the (1−t) ramp).
    """
    logits = ocr_logits_from_images(images, boxes, judge_params, judge_apply)
    logit_paddings = jnp.zeros(logits.shape[:2], logits.dtype)
    per = optax.ctc_loss(logits, logit_paddings, labels, label_paddings)
    nchar = (1.0 - label_paddings).sum(axis=-1)
    # samples whose text maps to NO judge charset chars (CJK, punctuation)
    # are excluded: CTC against an empty label is -log P(all blanks), whose
    # gradient rewards ERASING that sample's rendered text
    valid = (nchar > 0).astype(per.dtype)
    per = per / jnp.maximum(nchar, 1.0)
    weights = valid if sample_weights is None else sample_weights * valid
    return jnp.sum(per * weights) / jnp.maximum(jnp.sum(weights), 1e-6)
