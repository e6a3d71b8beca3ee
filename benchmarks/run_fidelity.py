"""Fixed-seed glyph-fidelity runs on ACTUAL sampled pipeline output.

Closes the loop BASELINE.md asks for ("OCR glyph accuracy" row): generate
images through the real pipeline at a fixed seed/config, score every text
region with the OCR-free fidelity metrics (benchmarks/glyph_fidelity.py),
and record the scores in ``results/fidelity.json`` so accuracy is tracked
across commits.

With random weights (this environment has no converted FLUX checkpoint) the
scores are a wiring/regression tracker, not a model-quality claim: the
"perfect" row records the metric's upper bound on the same conditions, the
"flat" row its noise floor, and the "sampled" row whatever the current model
produces. Re-run with --checkpoint-dir once converted weights exist.

Usage:
    JAX_PLATFORMS=cpu python benchmarks/run_fidelity.py          # tiny, random
    python benchmarks/run_fidelity.py --checkpoint-dir /path     # real weights
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks.glyph_fidelity import score_region  # noqa: E402

SEED = 42
H = W = 256  # tiny-model demo resolution; real runs use 1024


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", default=None,
                        help="converted weights; full geometry + 1024^2 when set")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--output", default="results/fidelity.json")
    args = parser.parse_args(argv)

    import jax.numpy as jnp

    from reptext.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
    )
    from reptext.conditioning import TextLine, build_conditions
    from reptext.pipelines import FluxRepTextPipeline

    real = args.checkpoint_dir is not None
    size = 1024 if real else H
    steps = args.steps or (30 if real else 4)
    font = int(size * 80 / 1024) if real else 48

    pipe_cfg = PipelineConfig(
        height=size, width=size, num_inference_steps=steps,
        controlnet_conditioning_step=steps,  # reference op-point: CN all steps
    )
    if real:
        from reptext.io.checkpoint import load_pipeline_params

        params = load_pipeline_params(args.checkpoint_dir)
        pipe = FluxRepTextPipeline.create(
            flux_cfg=FluxConfig(), cn_cfg=ControlNetConfig(), vae_cfg=VAEConfig(),
            pipe_cfg=pipe_cfg, clip_cfg=CLIPConfig(), t5_cfg=T5Config(),
            params=params, compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
        )
    else:
        pipe = FluxRepTextPipeline.create(
            flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
            vae_cfg=VAEConfig().tiny(), pipe_cfg=pipe_cfg,
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
        )

    lines = [
        TextLine("مرحبا", (size // 8, size // 4), font_size=font),
        TextLine("Hi", (size // 8, size // 2), font_size=font),
    ]
    conds = build_conditions(lines, size, size)
    from reptext.cli import _tokenize

    clip_ids, t5_ids = _tokenize(
        "a street sign in city, 'Hi'", pipe.clip.config, pipe.t5.config,
        args.checkpoint_dir,
    )
    t0 = time.time()
    images = pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=SEED)
    gen = np.asarray(images[0])
    gen_s = time.time() - t0

    # Velocity-cache fidelity tracking (ROADMAP #11): same seed/params with
    # interval=2 step skipping; record the pixel divergence vs the uncached
    # image and the cached image's own fidelity scores.
    import dataclasses

    vc_cfg = dataclasses.replace(
        pipe_cfg, velocity_cache_interval=2,
        velocity_cache_warmup=max(steps // 3, 1), velocity_cache_mode="linear",
    )
    vc_pipe = FluxRepTextPipeline.create(
        flux_cfg=pipe.flux.config, cn_cfg=pipe.controlnet.config,
        vae_cfg=pipe.vae.config, pipe_cfg=vc_cfg,
        clip_cfg=pipe.clip.config, t5_cfg=pipe.t5.config,
        params=pipe.params,
        compute_dtype=jnp.bfloat16 if real else jnp.float32,
        param_dtype=jnp.bfloat16 if real else jnp.float32,
    )
    gen_vc = np.asarray(
        vc_pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=SEED)[0]
    )
    vc_pixel_mad = float(
        np.abs(gen.astype(np.float64) - gen_vc.astype(np.float64)).mean()
    )

    # fp8 weight-only storage fidelity (io/quantize.py, --weight-dtype fp8):
    # same seed/params quantized to fp8-e4m3 per-channel storage; record the
    # pixel divergence and (below) the char-accuracy delta as the
    # acceptance gate for the single-chip-resident deployment mode.
    fp8_pipe = FluxRepTextPipeline.create(
        flux_cfg=pipe.flux.config, cn_cfg=pipe.controlnet.config,
        vae_cfg=pipe.vae.config, pipe_cfg=pipe_cfg,
        clip_cfg=pipe.clip.config, t5_cfg=pipe.t5.config,
        params=dict(pipe.params),
        compute_dtype=jnp.bfloat16 if real else jnp.float32,
        param_dtype=jnp.bfloat16 if real else jnp.float32,
    ).quantize_weights()
    gen_fp8 = np.asarray(
        fp8_pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=SEED)[0]
    )
    fp8_pixel_mad = float(
        np.abs(gen.astype(np.float64) - gen_fp8.astype(np.float64)).mean()
    )

    rows = []
    for i, lc in enumerate(conds.lines):
        x0, y0, x1, y1 = lc.bbox
        sampled = score_region(gen[y0:y1, x0:x1], lc)
        cached = score_region(gen_vc[y0:y1, x0:x1], lc)
        perfect = score_region(lc.glyph_image[y0:y1, x0:x1], lc)
        flat = score_region(np.full_like(lc.glyph_image[y0:y1, x0:x1], 128), lc)
        rows.append({
            "line": i, "text": lines[i].text,
            "sampled": sampled, "velocity_cached": cached,
            "perfect_bound": perfect, "flat_floor": flat,
        })
        print(f"line {i}: sampled={sampled} cached={cached} "
              f"perfect={perfect} flat={flat}")

    # OCR judge (reptext/eval/ocr.py, frozen weights in benchmarks/):
    # character accuracy per region — the discriminative accuracy metric
    # (floor ~0 on noise, ~1 on perfect renders; see ocr_judge_eval.json).
    ocr_scores = {}
    try:
        from reptext.eval import ocr as ocr_judge

        judge = ocr_judge.load_judge_ensemble()
        texts = [ln.text for ln in lines]
        crops = {
            "sampled": [gen[lc.bbox[1]:lc.bbox[3], lc.bbox[0]:lc.bbox[2]]
                        for lc in conds.lines],
            "cached": [gen_vc[lc.bbox[1]:lc.bbox[3], lc.bbox[0]:lc.bbox[2]]
                       for lc in conds.lines],
            "fp8": [gen_fp8[lc.bbox[1]:lc.bbox[3], lc.bbox[0]:lc.bbox[2]]
                    for lc in conds.lines],
            "perfect": [lc.glyph_image[lc.bbox[1]:lc.bbox[3], lc.bbox[0]:lc.bbox[2]]
                        for lc in conds.lines],
            "noise_floor": [
                np.random.default_rng(7).integers(
                    0, 256, (lc.bbox[3] - lc.bbox[1], lc.bbox[2] - lc.bbox[0], 3)
                ).astype(np.uint8) for lc in conds.lines],
        }
        for name, regions in crops.items():
            ocr_scores[f"char_accuracy_{name}"] = round(
                ocr_judge.char_accuracy(regions, texts, judge), 4)
        # Velocity-cache acceptance gate: caching must not cost more than 1%
        # character accuracy at the same seed/conditions.
        ocr_scores["velocity_cache_char_acc_delta"] = round(
            ocr_scores["char_accuracy_sampled"]
            - ocr_scores["char_accuracy_cached"], 4)
        ocr_scores["velocity_cache_acceptable"] = bool(
            ocr_scores["velocity_cache_char_acc_delta"] < 0.01)
        # fp8 weight-storage acceptance gate: same 1% char-accuracy budget
        ocr_scores["fp8_char_acc_delta"] = round(
            ocr_scores["char_accuracy_sampled"]
            - ocr_scores["char_accuracy_fp8"], 4)
        ocr_scores["fp8_acceptable"] = bool(
            ocr_scores["fp8_char_acc_delta"] < 0.01)
        print(f"ocr judge: {ocr_scores}")
    except FileNotFoundError:
        print("ocr judge weights not found (run benchmarks/train_ocr_judge.py)")

    out = {
        "seed": SEED, "size": size, "steps": steps,
        "weights": "converted" if real else "random-init (tiny geometry)",
        "mean_sampled_edge_iou": float(np.mean([r["sampled"]["edge_iou"] for r in rows])),
        "mean_sampled_edge_f1": float(np.mean([r["sampled"]["edge_f1"] for r in rows])),
        "mean_sampled_ink_corr": float(np.mean([r["sampled"]["ink_corr"] for r in rows])),
        "mean_perfect_edge_iou": float(np.mean([r["perfect_bound"]["edge_iou"] for r in rows])),
        "mean_perfect_edge_f1": float(np.mean([r["perfect_bound"]["edge_f1"] for r in rows])),
        "mean_cached_edge_iou": float(np.mean(
            [r["velocity_cached"]["edge_iou"] for r in rows])),
        **ocr_scores,
        "velocity_cache_pixel_mad": round(vc_pixel_mad, 4),
        "fp8_pixel_mad": round(fp8_pixel_mad, 4),
        "generate_s": round(gen_s, 2),
        "lines": rows,
    }
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.output}")
    # save the image alongside for visual inspection
    try:
        from PIL import Image

        img_path = str(Path(args.output).with_suffix(".png"))
        Image.fromarray(gen).save(img_path)
        print(f"wrote {img_path}")
    except Exception as e:  # noqa: BLE001
        print(f"image save skipped: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
