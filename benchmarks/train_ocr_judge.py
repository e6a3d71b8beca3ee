"""Train + freeze the OCR glyph-accuracy judge (reptext/eval/ocr.py).

Produces benchmarks/ocr_judge.npz (committed) and prints the separation
evidence the metric needs (VERDICT r2 #2): character accuracy ~1 on perfect
renders, ~0 on noise — the discrimination the edge-IoU proxy lacks.

Usage:
    python benchmarks/train_ocr_judge.py [--steps 3000] [--eval-only]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WEIGHTS = Path(__file__).resolve().parent / "ocr_judge.npz"
REPORT = Path(__file__).resolve().parent / "ocr_judge_eval.json"


def _script_words(rng, script: str, n: int, lo=3, hi=10) -> list:
    from reptext.eval import ocr

    pools = {"arabic": ocr.ARABIC, "latin_upper": ocr.LATIN,
             "latin_lower": ocr.LATIN_LOWER, "digits": ocr.DIGITS}
    pool = list(pools[script])
    return ["".join(rng.choice(pool) for _ in range(int(rng.integers(lo, hi))))
            for _ in range(n)]


def evaluate(params) -> dict:
    """Separation evidence on held-out words: perfect, augmented, noise —
    plus the per-script breakdown the v2 judge gates on (VERDICT r3 #5:
    "≥0.95 accuracy on augmented renders across all three scripts")."""
    from reptext.eval import ocr

    rng = np.random.default_rng(123)
    words = [ocr.random_word(rng) for _ in range(64)]
    perfect = [ocr.render_word(w, font_size=int(rng.integers(24, 56)))
               for w in words]
    augmented = [ocr._augment(img, rng) for img in perfect]
    noise = [rng.random((40, 100)).astype(np.float32) for _ in words]
    # fixed demo words (data.py pools / reference demo strings) with
    # mixed-case Latin — case-SENSITIVE classes in v2
    demo = ["مرحبا", "سلام", "OPEN", "CAFE", "2026", "مطعم", "Hello", "Cafe"]
    demo_imgs = [ocr.render_word(w, font_size=40) for w in demo]
    report = {
        "char_accuracy_perfect": round(ocr.char_accuracy(perfect, words, params), 4),
        "char_accuracy_augmented": round(ocr.char_accuracy(augmented, words, params), 4),
        "char_accuracy_noise_floor": round(ocr.char_accuracy(noise, words, params), 4),
        "char_accuracy_demo_words": round(ocr.char_accuracy(demo_imgs, demo, params), 4),
        "n_eval_words": len(words),
    }
    per_script = {}
    for script in ("arabic", "latin_upper", "latin_lower", "digits"):
        # 128 words (~770 chars)/script: one flipped char moves the metric
        # ~0.13% instead of ~0.8% at 64 eval words total — the 0.90 gate is
        # meaningless if run-to-run eval noise spans it
        sw = _script_words(rng, script, 128)
        simgs = [ocr._augment(
            ocr.render_word(w, font_size=int(rng.integers(28, 52))), rng)
            for w in sw]
        per_script[script] = round(ocr.char_accuracy(simgs, sw, params), 4)
    report["char_accuracy_by_script_augmented"] = per_script
    # long lines (the v2 motivation: MAX_LABEL 24 / 256px input)
    long_words = [ocr.random_word(rng) for _ in range(24)]
    long_words = [w for w in long_words if len(w) >= 8] or ["Shakker Labs"]
    long_imgs = [ocr.render_word(w, font_size=40) for w in long_words]
    report["char_accuracy_long_lines"] = round(
        ocr.char_accuracy(long_imgs, long_words, params), 4)
    report["max_label"] = ocr.MAX_LABEL
    report["charset_size"] = len(ocr.CHARSET)
    report["cjk"] = (
        "blocked: no CJK-capable font in this image (DejaVu only; han chars "
        "render as identical .notdef tofu — verified). The charset is "
        "embedded in ocr_judge.npz; with a CJK TTF installed, extend "
        "eval/ocr.py CHARSET and rerun this script. Reference demo strings "
        "affected: RepText/infer.py:44,56."
    )
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--confusion-frac", type=float, default=0.15,
                        help="fraction of training words drawn from the "
                             "visually-confusable groups (eval.ocr."
                             "CONFUSION_GROUPS); the v3 latin_upper gate "
                             "miss (0.897 vs 0.90) was confusable caps")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--member", type=int, default=None, metavar="M",
                        help="train committee member M (saved to "
                             "ocr_judge_mM.npz next to the primary weights); "
                             "scoring loads the whole committee via "
                             "load_judge_ensemble and averages member "
                             "probabilities — independently-seeded members "
                             "fix each other's borderline-glyph confusions")
    parser.add_argument("--device", choices=["cpu", "default"], default="cpu",
                        help="cpu (default: the judge trains without an "
                             "accelerator) or 'default' = let jax pick (a "
                             "few-core host makes CPU training of the v3 "
                             "judge slow; the train step is tiny on a GPU)")
    args = parser.parse_args(argv)

    import jax

    if args.device == "cpu":
        # set BEFORE any backend probe (jax.default_backend() would
        # initialize the accelerator backend just to ask its name)
        jax.config.update("jax_platforms", "cpu")

    from reptext.eval import ocr

    if not args.eval_only:
        out_path = (WEIGHTS if args.member is None else
                    WEIGHTS.with_name(f"ocr_judge_m{args.member}.npz"))
        t0 = time.time()
        params = ocr.train_judge(steps=args.steps, batch_size=args.batch_size,
                                 seed=args.seed,
                                 confusion_frac=args.confusion_frac)
        print(f"trained {args.steps} steps in {time.time() - t0:.0f}s")
        ocr.save_judge(params, str(out_path))
        print(f"wrote {out_path}")

    # evaluate what scoring will actually use: the full committee on disk
    ensemble = ocr.load_judge_ensemble()
    print(f"evaluating ensemble of {len(ensemble)} member(s)")
    report = evaluate(ensemble)
    report["ensemble_members"] = len(ensemble)
    print(json.dumps(report, indent=1))
    REPORT.write_text(json.dumps(report, indent=1))
    print(f"wrote {REPORT}")
    # the judge is only a judge if it separates: hard gates (VERDICT r4 #3:
    # >=0.90 on ALL scripts augmented, noise floor <=0.03)
    assert report["char_accuracy_perfect"] > 0.9, report
    assert report["char_accuracy_noise_floor"] <= 0.03, report
    misses = {s_: a for s_, a in
              report["char_accuracy_by_script_augmented"].items() if a < 0.95}
    if misses:
        print(f"GATE MISS (<0.95 augmented): {misses} — hard floor is 0.90; "
              "retrain with more capacity/steps to clear 0.95")
    for script, acc in report["char_accuracy_by_script_augmented"].items():
        assert acc >= 0.90, (script, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
