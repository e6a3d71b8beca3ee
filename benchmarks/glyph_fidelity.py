"""Glyph-accuracy harness: OCR-free fidelity scoring of rendered text regions.

The reference validates text fidelity only visually (SURVEY.md §4); BASELINE.md
asks for an OCR-verified accuracy metric. No OCR engine ships in this
environment, so this harness scores glyph fidelity directly against the
conditioning ground truth (which IS the target the ControlNet was trained to
reproduce):

- edge-IoU: canny edges of the generated text region vs the conditioning canny
  edges (dilated tolerance band);
- ink-correlation: normalized cross-correlation between the binarized glyph
  mask and the generated region's local-contrast map.

Both scores are in [0, 1]; fixed seed + fixed conditions make runs comparable
across commits (the parity protocol from BASELINE.md).

Usage:
    python benchmarks/glyph_fidelity.py            # demo on rendered glyphs
    from benchmarks.glyph_fidelity import score_region
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from reptext.conditioning import TextLine, build_conditions  # noqa: E402
from reptext.conditioning.canny import canny_edges  # noqa: E402


def _dilate(mask: np.ndarray, it: int = 1) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_dilation(mask, iterations=it)


def edge_iou(generated: np.ndarray, target_edges: np.ndarray, tol: int = 2) -> float:
    """IoU between generated-region edges and target edges, each dilated by
    ``tol`` px so 1-px localization error doesn't zero the score."""
    gen_e = canny_edges(generated) > 0
    tgt_e = target_edges > 0
    if not tgt_e.any():
        return 1.0 if not gen_e.any() else 0.0
    gen_d, tgt_d = _dilate(gen_e, tol), _dilate(tgt_e, tol)
    inter = (gen_e & tgt_d).sum() + (tgt_e & gen_d).sum()
    union = gen_e.sum() + tgt_e.sum()
    return float(inter / max(union, 1))


def edge_f1(generated: np.ndarray, target_edges: np.ndarray, tol: int = 2) -> float:
    """Harmonic mean of STRICT edge precision and ±tol-band recall.

    Unlike :func:`edge_iou` (whose symmetric dilated bands forgive dense
    spurious edges — noisy output scores ~0.6-0.7, VERDICT r2 weak #2),
    precision here counts generated edge pixels that land EXACTLY on target
    strokes (no dilation): in a glyph-dense crop the ±tol band covers most
    of the box, so any tolerance on the precision side collapses the noise
    floor separation. Recall keeps the ±tol band (1-2px localization error in
    sampled output shouldn't zero the score). Measured floors: perfect
    ~0.98, uniform noise ~0.13-0.27."""
    gen_e = canny_edges(generated) > 0
    tgt_e = target_edges > 0
    if not tgt_e.any():
        return 1.0 if not gen_e.any() else 0.0
    if not gen_e.any():
        return 0.0
    gen_d = _dilate(gen_e, tol)
    precision = (gen_e & tgt_e).sum() / gen_e.sum()
    recall = (tgt_e & gen_d).sum() / tgt_e.sum()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def ink_correlation(generated: np.ndarray, glyph_mask: np.ndarray) -> float:
    """Normalized cross-correlation between glyph ink mask and the generated
    region's intensity deviation (text regions should deviate from their local
    background exactly where ink is)."""
    g = generated.astype(np.float32).mean(axis=-1) if generated.ndim == 3 else generated
    m = (glyph_mask > 0).astype(np.float32)
    if m.sum() == 0:
        return 1.0
    g = g - g.mean()
    m = m - m.mean()
    denom = np.sqrt((g * g).sum() * (m * m).sum())
    if denom == 0:
        return 0.0
    return float(abs((g * m).sum()) / denom)


def score_region(generated_region, cond_line) -> dict:
    """Score one generated text region against its LineCondition."""
    x0, y0, x1, y1 = cond_line.bbox
    tgt_edges = 255 - cond_line.canny_image[y0:y1, x0:x1, 0]  # back to edges-on-black
    glyph = cond_line.glyph_image[y0:y1, x0:x1].mean(axis=-1)
    return {
        "edge_iou": edge_iou(generated_region, tgt_edges),
        "edge_f1": edge_f1(generated_region, tgt_edges),
        "ink_corr": ink_correlation(generated_region, glyph),
    }


def main():
    # self-check: the rendered glyph itself must score ~perfectly; a flat
    # background must score ~0 on ink correlation; a NOISE region pins each
    # metric's effective floor (VERDICT r2 weak #2: edge_iou's floor is high
    # — ~0.6 — which is exactly why edge_f1 and the OCR judge
    # (reptext/eval/ocr.py) exist; the noise row makes the limitation
    # visible instead of assumed away).
    conds = build_conditions(
        [TextLine("مرحبا", (40, 60), font_size=56), TextLine("Test", (40, 150), font_size=56)],
        width=320, height=240,
    )
    rng = np.random.default_rng(0)
    for i, lc in enumerate(conds.lines):
        x0, y0, x1, y1 = lc.bbox
        perfect = lc.glyph_image[y0:y1, x0:x1]
        flat = np.full_like(perfect, 128)
        noise = rng.integers(0, 256, perfect.shape).astype(np.uint8)
        s_perfect = score_region(perfect, lc)
        s_flat = score_region(flat, lc)
        s_noise = score_region(noise, lc)
        print(f"line {i}: perfect={s_perfect} flat={s_flat} noise={s_noise}")
        assert s_perfect["edge_iou"] > 0.8, s_perfect
        assert s_perfect["edge_f1"] > 0.8, s_perfect
        assert s_perfect["ink_corr"] > 0.8, s_perfect
        assert s_flat["ink_corr"] < 0.1, s_flat
        # noise floors: edge_f1 must separate noise from perfect by a wide
        # margin; edge_iou's floor is recorded but NOT asserted small — its
        # dilated-band symmetry makes it non-discriminative on noise, which
        # is the documented reason it is not the headline metric.
        assert s_noise["edge_f1"] < s_perfect["edge_f1"] - 0.3, s_noise
        assert s_noise["ink_corr"] < 0.2, s_noise
    print("glyph-fidelity harness self-check OK")


if __name__ == "__main__":
    main()
