"""Command-line driver: the equivalent of the reference's infer.py.

Usage (demo mode, random weights, no checkpoints needed):
    python -m reptext.cli --text "مرحبا" --position 370 200 \
        --prompt "a street sign in city" --size 512 --steps 20 \
        --random-weights --tiny --output results/result.png

With converted checkpoints (see reptext.io.convert):
    python -m reptext.cli --checkpoint-dir /path/to/converted ...

Reference behavior mirrored (RepText/infer.py:25-134): per-line glyph/canny/
position/region conditioning, "sign/billboard" prompt guidance, non-CJK render
text quoted into the prompt, fixed seed. Arabic shaping applied automatically
(the reference lacks it).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np


def contains_cjk(text: str) -> bool:
    return re.search(r"[一-鿿]", text) is not None


def build_prompt(prompt: str, texts, suffix: str = "") -> str:
    """Quote non-CJK render text into the prompt (reference: infer.py:108-112)."""
    for t in texts:
        if not contains_cjk(t):
            prompt += f", '{t}'"
    return prompt + suffix


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments (also what ``_train`` reads)."""
    parser = argparse.ArgumentParser(description="RepText text-to-image")
    parser.add_argument("--text", action="append",
                        help="text line to render (repeatable)")
    parser.add_argument("--position", action="append", nargs=2, type=int,
                        metavar=("X", "Y"),
                        help="top-left position per text line (repeatable)")
    parser.add_argument("--color", action="append", nargs=3, type=int,
                        metavar=("R", "G", "B"), default=None)
    parser.add_argument("--prompt", default="a street sign in city")
    parser.add_argument("--prompt-2", default=None,
                        help="separate prompt for the T5 encoder (CLIP still "
                             "sees --prompt); default: same as --prompt "
                             "(reference prompt_2, "
                             "pipeline_flux_controlnet.py:753-754)")
    parser.add_argument("--prompt-suffix",
                        default=", filmfotos, film grain, reversal film photography")
    parser.add_argument("--size", type=int, default=1024, help="square image size")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--timesteps", default=None, metavar="T1,T2,...",
                        help="custom model-facing timestep grid in (0,1000] "
                             "(overrides --steps; reference timesteps kwarg "
                             "via retrieve_timesteps)")
    parser.add_argument("--sigmas", default=None, metavar="S1,S2,...",
                        help="custom base sigma ladder in (0,1] (overrides "
                             "--steps; mutually exclusive with --timesteps)")
    parser.add_argument("--guidance-scale", type=float, default=3.5)
    parser.add_argument("--controlnet-scale", type=float, default=1.0)
    parser.add_argument("--controlnet-step", type=int, default=30,
                        help="ControlNet active for the first N steps")
    parser.add_argument("--controlnet-mode", type=int, default=None,
                        help="union-mode conditioning-type index (required "
                             "when the loaded ControlNet is a union model)")
    parser.add_argument("--control-guidance-start", type=float, default=0.0,
                        help="step fraction at which the ControlNet turns on")
    parser.add_argument("--control-guidance-end", type=float, default=1.0,
                        help="step fraction at which the ControlNet turns off")
    parser.add_argument("--velocity-cache-interval", type=int, default=1,
                        help="run the transformer every k-th step after warmup, "
                             "reusing the last velocity between (1 = off)")
    parser.add_argument("--velocity-cache-warmup", type=int, default=8,
                        help="full model steps before velocity caching kicks in")
    parser.add_argument("--velocity-cache-mode",
                        choices=["reuse", "linear", "adaptive", "adaptive-linear"],
                        default="reuse",
                        help="skipped-step velocity: repeat last computed, or "
                             "first-order extrapolation over sigma; adaptive* "
                             "replaces the fixed interval with the in-graph "
                             "latent-drift trigger")
    parser.add_argument("--velocity-cache-threshold", type=float, default=0.05,
                        help="adaptive modes: skip while the latents' relative "
                             "L1 drift since the last computed step is below this")
    parser.add_argument("--velocity-cache-max-skip", type=int, default=3,
                        help="adaptive modes: max consecutive skipped steps")
    parser.add_argument("--font", default=None, help="TTF font path")
    parser.add_argument("--font-size", type=int, default=80)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-images", type=int, default=1,
                        help="images per prompt, txt2img and inpaint (one "
                             "batched sampler call; siblings saved as "
                             "<output>_K.png)")
    parser.add_argument("--output", default="results/result.png")
    parser.add_argument("--mode",
                        choices=["txt2img", "inpaint", "serve", "train"],
                        default="txt2img")
    parser.add_argument("--host", default="127.0.0.1", help="serve: bind host")
    parser.add_argument("--port", type=int, default=8470, help="serve: bind port")
    parser.add_argument("--warmup", action="store_true",
                        help="serve: compile generation graphs before accepting traffic")
    parser.add_argument("--max-batch", type=int, default=4,
                        help="serve: max coalesced requests per sampler call")
    parser.add_argument("--batch-window", type=float, default=0.0,
                        help="serve: seconds to linger for burst coalescing")
    parser.add_argument("--serve-inpaint", action="store_true",
                        help="serve: also load the inpaint pipeline "
                             "(POST /generate with mode=inpaint)")
    parser.add_argument("--image", default=None,
                        help="inpaint: input PNG path (resized to x64 dims)")
    parser.add_argument("--init-image", default=None, metavar="PATH",
                        help="txt2img: img2img init PNG (paired with "
                             "--strength; noise blended at the matching "
                             "schedule point)")
    parser.add_argument("--strength", type=float, default=1.0,
                        help="img2img denoise strength in (0, 1]; 1.0 = pure "
                             "txt2img")
    parser.add_argument("--mask", default=None,
                        help="inpaint: white-on-black mask PNG path")
    parser.add_argument("--negative-prompt", default=None,
                        help="inpaint: CFG negative prompt (default: reference's)")
    parser.add_argument("--true-guidance-scale", type=float, default=1.0)
    parser.add_argument("--shard", default=None, metavar="DPxTP",
                        help="shard transformer/ControlNet params over a "
                             "dp x tp device mesh (e.g. 2x4, or 'auto' = "
                             "1 x all local devices); the jitted samplers "
                             "then run tensor-parallel")
    parser.add_argument("--sp-backend", choices=["ring", "ulysses"],
                        default="ring",
                        help="sequence-parallel attention for --shard spN: "
                             "per-block K/V ppermute ring, or ulysses "
                             "all-to-all head swap (needs heads %% sp == 0)")
    parser.add_argument("--attention-backend",
                        choices=["auto", "xla", "cudnn"], default="auto",
                        help="attention impl: auto = cuDNN flash attention "
                             "on a GPU with bf16/fp16, XLA einsum elsewhere; "
                             "cudnn where it cannot run is an error")
    parser.add_argument("--weight-dtype", choices=["bf16", "fp8"],
                        default="bf16",
                        help="fp8 = weight-only fp8-e4m3 storage of the "
                             "transformer/ControlNet block stacks (half the "
                             "weight bytes; matmuls stay bf16)")
    parser.add_argument("--vae-tiling", choices=["auto", "on", "off"],
                        default="auto",
                        help="tiled VAE encode/decode (ops/vae_tiling.py): "
                             "bounds VAE activation memory. auto = on "
                             "whenever fp8 weights are used at full geometry")
    parser.add_argument("--train-steps", type=int, default=100,
                        help="train: optimization steps")
    parser.add_argument("--batch-size", type=int, default=2,
                        help="train: samples per step")
    parser.add_argument("--learning-rate", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--ocr-loss-weight", type=float, default=0.0,
                        help="weight of the in-graph OCR CTC text-perceptual "
                             "loss (decodes predicted x0 through the frozen "
                             "VAE + OCR judge; 0 disables)")
    parser.add_argument("--ocr-judge", default=None, metavar="NPZ",
                        help="OCR judge weights (default benchmarks/ocr_judge.npz)")
    parser.add_argument("--text-loss-weight", type=float, default=2.0,
                        help="train: extra loss weight inside text-region tokens")
    parser.add_argument("--checkpoint-every", type=int, default=50,
                        help="train: steps between elastic restore points")
    parser.add_argument("--corpus-dir", default=None, metavar="DIR",
                        help="train on an annotated photo corpus "
                             "(annotations.jsonl + images; data_disk.py) "
                             "instead of synthetic composites")
    parser.add_argument("--train-dir", default=None,
                        help="train: orbax restore-point/output directory "
                             "(omit for in-memory restore points)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="directory with converted orbax/safetensors weights")
    parser.add_argument("--random-weights", action="store_true",
                        help="random-init weights (smoke/demo mode)")
    parser.add_argument("--lora", action="append", default=None, metavar="PATH",
                        help="LoRA safetensors (diffusers FLUX naming) merged "
                             "into the transformer at load time; repeatable")
    parser.add_argument("--lora-scale", action="append", type=float, default=None,
                        metavar="S", help="merge scale for the matching --lora "
                                          "(default 1.0 each)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model geometry (demo on small hosts)")
    parser.add_argument("--no-shape", action="store_true",
                        help="disable Arabic shaping (reference raw behavior)")
    parser.add_argument("--ip-adapter-image", default=None, metavar="PATH",
                        help="image-prompt (FLUX IP-Adapter) reference image")
    parser.add_argument("--ip-adapter-scale", type=float, default=1.0)
    parser.add_argument("--ip-adapter-dir", default=None, metavar="DIR",
                        help="orbax dir of converted IP-Adapter params "
                             "(io/convert.py::{convert_clip_vision, "
                             "convert_ip_adapter}); without it the adapter "
                             "is zero-init (an exact no-op)")
    parser.add_argument("--compile-cache", choices=["on", "off"], default="on",
                        help="persistent XLA compilation cache, reused across "
                             "processes (warm serve/CLI restarts skip the "
                             "pipeline compiles): $JAX_COMPILATION_CACHE_DIR "
                             "when set, else <checkout>/.cache/xla")
    return parser


def pipeline_config(args, height: int, width: int):
    """The sampling settings the parsed CLI ``args`` ask for."""
    from reptext.configs import PipelineConfig

    return PipelineConfig(
        height=height, width=width, num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        controlnet_conditioning_scale=args.controlnet_scale,
        controlnet_conditioning_step=args.controlnet_step,
        control_mode=args.controlnet_mode,
        control_guidance_start=args.control_guidance_start,
        control_guidance_end=args.control_guidance_end,
        true_guidance_scale=args.true_guidance_scale,
        velocity_cache_interval=args.velocity_cache_interval,
        velocity_cache_warmup=args.velocity_cache_warmup,
        velocity_cache_mode=args.velocity_cache_mode,
        velocity_cache_threshold=args.velocity_cache_threshold,
        velocity_cache_max_skip=args.velocity_cache_max_skip,
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    serve = args.mode in ("serve", "train")
    if not serve:
        if not args.text or not args.position:
            parser.error("--text and --position are required for generation modes")
        if len(args.text) != len(args.position):
            parser.error("--text and --position counts must match")
        colors = args.color or [(255, 255, 255)] * len(args.text)
        if len(colors) != len(args.text):
            parser.error("--color count must match --text")
        if os.path.splitext(args.output)[1].lower() not in ("", ".png"):
            parser.error(f"--output must be a .png path, got {args.output!r}")

    if args.shard:
        # syntax check up front, before models are built (the full semantic
        # checks — mode constraints, device counts — stay at the use sites)
        spec = args.shard.lower()
        if spec.startswith("sp"):
            if spec[2:] and not spec[2:].isdigit():
                parser.error("--shard spN expects an integer N (e.g. sp8)")
        elif spec != "auto":
            parts = spec.split("x")
            if len(parts) != 2 or not all(p.isdigit() for p in parts):
                parser.error("--shard expects DPxTP (e.g. 2x4), spN "
                             "(e.g. sp8), or 'auto'")

    import jax.numpy as jnp

    from reptext.utils.compile_cache import enable_compile_cache

    enable_compile_cache(args.compile_cache == "on")

    from reptext.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig,
    )
    from reptext.conditioning import TextLine, build_conditions
    from reptext.pipelines import FluxRepTextPipeline

    inpaint = args.mode == "inpaint"
    if inpaint and (args.image is None or args.mask is None):
        parser.error("--mode inpaint requires --image and --mask")

    height = width = args.size
    image_arr = mask_arr = None
    if inpaint:
        from reptext.utils.image import load_image, resize_image, resize_to_multiple

        image_arr = resize_to_multiple(load_image(args.image, "RGB"))
        height, width = image_arr.shape[:2]
        mask_arr = resize_image(load_image(args.mask, "L"), height, width)

    pipe_cfg = pipeline_config(args, height, width)
    if args.tiny:
        flux_cfg, cn_cfg = FluxConfig().tiny(), ControlNetConfig().tiny()
        vae_cfg, clip_cfg, t5_cfg = VAEConfig().tiny(), CLIPConfig().tiny(), T5Config().tiny()
    else:
        flux_cfg, cn_cfg = FluxConfig(), ControlNetConfig()
        vae_cfg, clip_cfg, t5_cfg = VAEConfig(), CLIPConfig(), T5Config()
    saved_cfgs = {}
    if args.checkpoint_dir and not args.tiny:
        # geometry recorded by io/convert_cli.py (from each checkpoint's HF
        # config.json) wins over library defaults — builds the exact model
        # the published weights were trained with
        from reptext.io.checkpoint import load_saved_configs

        saved_cfgs = load_saved_configs(args.checkpoint_dir)
        flux_cfg = saved_cfgs.get("flux", flux_cfg)
        cn_cfg = saved_cfgs.get("controlnet", cn_cfg)
        vae_cfg = saved_cfgs.get("vae", vae_cfg)
        clip_cfg = saved_cfgs.get("clip", clip_cfg)
        t5_cfg = saved_cfgs.get("t5", t5_cfg)

    params = None
    if args.checkpoint_dir:
        from reptext.io.checkpoint import load_pipeline_params
        params = load_pipeline_params(args.checkpoint_dir)
    elif not args.random_weights:
        parser.error("pass --checkpoint-dir or --random-weights")

    pre_quantized = False
    if params is not None:
        # fp8-STORED checkpoints (convert_cli --dtype fp8) are detected from
        # the trees themselves; the models must run weight_quant or apply
        # fails. Any quantized component triggers the switch --
        # quantize_params is idempotent, so mixed-storage dirs (components
        # converted by separate runs) are normalized by quantize_weights.
        from reptext.io.quantize import is_quantized

        pre_quantized = any(
            is_quantized(params[name])
            for name in ("flux", "controlnet", "inpaint_controlnet")
            if name in params
        )

    if args.lora:
        # inference-time LoRA as ahead-of-time weight surgery (reference uses
        # diffusers PEFT layers, RepText/pipeline_flux_controlnet.py:394-403;
        # merging keeps the sampler graph LoRA-free = zero runtime overhead)
        if params is None or "flux" not in params:
            parser.error("--lora requires --checkpoint-dir with a flux component")
        if pre_quantized:
            parser.error("--lora cannot merge into an fp8-stored checkpoint; "
                         "bake it at conversion time (convert_cli --lora) or "
                         "convert with --dtype keep/bf16")
        from reptext.io.convert import load_safetensors_state
        from reptext.io.lora import apply_lora

        scales = list(args.lora_scale or [])
        if len(scales) > len(args.lora):
            parser.error("more --lora-scale values than --lora paths")
        scales += [1.0] * (len(args.lora) - len(scales))
        for path, scale in zip(args.lora, scales):
            params["flux"] = apply_lora(
                params["flux"], load_safetensors_state(path, dtype=None),
                scale=scale, head_dim=flux_cfg.attention_head_dim,
            )
            print(f"merged LoRA {path} (scale {scale})")

    dtype = jnp.bfloat16 if not args.tiny else jnp.float32
    create_kwargs = dict(
        flux_cfg=flux_cfg, cn_cfg=cn_cfg, vae_cfg=vae_cfg, pipe_cfg=pipe_cfg,
        params=params, clip_cfg=clip_cfg, t5_cfg=t5_cfg,
        compute_dtype=dtype, param_dtype=dtype,
        attention_backend=(None if args.attention_backend == "auto"
                           else args.attention_backend),
    )
    if inpaint:
        from reptext.pipelines import FluxRepTextInpaintPipeline
        import dataclasses as _dc
        inpaint_cn_cfg = saved_cfgs.get(
            "inpaint_controlnet", _dc.replace(cn_cfg, extra_condition_channels=4)
        )
        pipeline = FluxRepTextInpaintPipeline.create_inpaint(
            inpaint_cn_cfg=inpaint_cn_cfg, **create_kwargs
        )
    else:
        pipeline = FluxRepTextPipeline.create(**create_kwargs)

    # IP-Adapter attach must precede fp8 quantization (the adapter kernels
    # join the double-block stack and are quantized with it)
    if (args.mode == "serve" and args.ip_adapter_dir is not None) or (
            args.mode == "txt2img" and args.ip_adapter_image):
        from reptext.configs import CLIPVisionConfig
        ip_params = None
        if args.ip_adapter_dir:
            from reptext.io.checkpoint import load_pipeline_params as _lpp
            ip_params = _lpp(args.ip_adapter_dir,
                             components=("vision", "proj", "blocks", "flux"))
        pipeline.attach_ip_adapter(
            vision_cfg=saved_cfgs.get(
                "clip_vision",
                CLIPVisionConfig().tiny() if args.tiny else CLIPVisionConfig()),
            params=ip_params,
        )

    if args.mode == "train" and (args.weight_dtype == "fp8" or pre_quantized):
        parser.error("training needs dense weights: convert with --dtype "
                     "keep/bf16 and drop --weight-dtype fp8")
    if args.weight_dtype == "fp8" or pre_quantized:
        # pre-quantized storage: quantize_params is idempotent, so this only
        # re-quantizes freshly-attached dense adapter kernels (if any) and
        # switches the models to weight_quant
        pipeline.quantize_weights()
    if args.vae_tiling == "on" or (
            args.vae_tiling == "auto" and not args.tiny
            and (args.weight_dtype == "fp8" or pre_quantized)):
        pipeline.enable_vae_tiling()

    mesh = None
    if args.shard and args.mode != "train":  # train shards inside _train
        import jax as _jax

        from reptext.parallel import make_mesh

        spec = args.shard.lower()
        if spec.startswith("sp"):
            # sequence parallelism: tokens sharded, params replicated —
            # the >=2048^2 long-context path (parallel/sequence.py);
            # works for txt2img, inpaint, and serve pipelines
            from reptext.parallel import make_sp_mesh

            n = int(spec[2:]) if spec[2:] else len(_jax.devices())
            sp_mesh_obj = make_sp_mesh(n)
            pipeline.shard_for_sp(sp_mesh_obj, backend=args.sp_backend)
        else:
            if spec == "auto":
                dp, tp = 1, len(_jax.devices())
            else:
                try:
                    dp, tp = (int(x) for x in spec.split("x"))
                except ValueError:
                    parser.error("--shard expects DPxTP (e.g. 2x4), spN "
                                 "(e.g. sp8), or 'auto'")
            mesh = make_mesh(dp=dp, tp=tp)
            pipeline.shard_for_inference(mesh)

    if args.mode == "train":
        return _train(args, pipeline)

    if serve:
        from reptext.serving import GenerationServer

        def tokenizer(prompt):
            return _tokenize(prompt, clip_cfg, t5_cfg, args.checkpoint_dir)

        inpaint_pipeline = None
        if args.serve_inpaint:
            import dataclasses as _dc

            from reptext.pipelines import FluxRepTextInpaintPipeline
            # share the (possibly quantized/sharded) resident trees -- a
            # second quantization of create_kwargs' original params would
            # put a SECOND full-size copy on device
            inpaint_pipeline = FluxRepTextInpaintPipeline.create_inpaint(
                inpaint_cn_cfg=saved_cfgs.get(
                    "inpaint_controlnet",
                    _dc.replace(cn_cfg, extra_condition_channels=4)),
                **dict(create_kwargs, params=dict(pipeline.params)),
            )
            if args.weight_dtype == "fp8" or pre_quantized:
                # flux/controlnet already quantized (shared); this only
                # switches the modules and covers a dense inpaint CN
                inpaint_pipeline.quantize_weights()
            if mesh is not None:
                inpaint_pipeline.shard_for_inference(mesh)
            elif getattr(pipeline, "sp_mesh", None) is not None:
                inpaint_pipeline.shard_for_sp(
                    pipeline.sp_mesh, pipeline.sp_axis,
                    backend=args.sp_backend)

        server = GenerationServer(
            pipeline, host=args.host, port=args.port, tokenizer=tokenizer,
            warmup=args.warmup, max_batch=args.max_batch,
            batch_window_s=args.batch_window, inpaint_pipeline=inpaint_pipeline,
        )
        host, port = server.address
        print(f"serving on http://{host}:{port} "
              f"(POST /generate, GET /healthz, GET /metrics)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        return 0

    lines = [
        TextLine(t, tuple(p), tuple(c), font_size=args.font_size)
        for t, p, c in zip(args.text, args.position, colors)
    ]
    conditions = build_conditions(
        lines, width, height, font_path=args.font,
        font_size=args.font_size, shape_text=not args.no_shape,
    )

    prompt = build_prompt(args.prompt, args.text, args.prompt_suffix)
    print(f"prompt: {prompt}")

    # Tokenize: local tokenizer files if available, else deterministic hash ids
    clip_ids, t5_ids = _tokenize(prompt, clip_cfg, t5_cfg, args.checkpoint_dir)
    if args.prompt_2 is not None:
        # separate T5 prompt: CLIP keeps --prompt, T5 gets --prompt-2 (with the
        # same render-text quoting; reference encode_prompt routes prompt_2 to
        # tokenizer_2/text_encoder_2, pipeline_flux_controlnet.py:349-360)
        prompt2 = build_prompt(args.prompt_2, args.text, args.prompt_suffix)
        print(f"prompt_2: {prompt2}")
        _, t5_ids = _tokenize(prompt2, clip_cfg, t5_cfg, args.checkpoint_dir)

    sched_kwargs = {}
    if args.timesteps and args.sigmas:
        parser.error("--timesteps and --sigmas are mutually exclusive")
    if args.timesteps:
        sched_kwargs["timesteps"] = [float(t) for t in args.timesteps.split(",")]
    if args.sigmas:
        sched_kwargs["sigmas"] = [float(s) for s in args.sigmas.split(",")]

    if inpaint:
        from reptext.pipelines import DEFAULT_NEGATIVE_PROMPT

        neg = args.negative_prompt or DEFAULT_NEGATIVE_PROMPT
        neg_clip, neg_t5 = _tokenize(neg, clip_cfg, t5_cfg, args.checkpoint_dir)
        # true CFG concatenates [neg, pos] embeds -> equal seq lengths required
        from reptext.text import pad_to_common_length

        t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
        clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
        images = pipeline(
            conditions, image=image_arr, mask=mask_arr,
            clip_ids=clip_ids, t5_ids=t5_ids,
            negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
            seed=args.seed, num_images=args.num_images, **sched_kwargs,
        )
    else:
        gen_kwargs = {}
        from reptext.utils.image import load_image, resize_image

        if args.ip_adapter_image:
            # adapter already attached (before quantization) in main flow
            gen_kwargs = {
                "ip_adapter_image": load_image(args.ip_adapter_image, "RGB"),
                "ip_adapter_scale": args.ip_adapter_scale,
            }
        if args.init_image and args.strength >= 1.0:
            parser.error("--init-image does nothing at --strength 1.0; pass "
                         "--strength < 1.0 (fraction of the schedule to "
                         "re-noise)")
        if args.init_image:
            init = resize_image(load_image(args.init_image, "RGB"), height, width)
            gen_kwargs["init_image"] = init[None]
            gen_kwargs["strength"] = args.strength
        images = pipeline(
            conditions, clip_ids=clip_ids, t5_ids=t5_ids, seed=args.seed,
            num_images=args.num_images, **sched_kwargs, **gen_kwargs,
        )

    from reptext.utils.png import encode_png

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    root, ext = os.path.splitext(args.output)
    for k in range(len(images)):
        path = args.output if k == 0 else f"{root}_{k}{ext or '.png'}"
        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(images[k])))
        print(f"saved {path}")
    return 0


def _train(args, pipeline) -> int:
    """ControlNet training driver (the reference has no training entry point;
    recipe: sampling/train_controlnet.py over the data path in data.py)."""
    import jax
    import numpy as np

    from reptext.data import GlyphTextDataset, PrefetchLoader
    from reptext.sampling.elastic import ElasticTrainer
    from reptext.sampling.train_controlnet import (
        bind_frozen_base, init_controlnet_training, make_controlnet_train_step,
    )
    from reptext.utils import compiler
    from reptext.utils.metrics import default_metrics

    flux_params = pipeline.params["flux"]
    cn_cfg = pipeline.controlnet.config
    cn_params, optimizer, opt_state = init_controlnet_training(
        flux_params, pipeline.params["controlnet"],
        cn_cfg.num_layers, cn_cfg.num_single_layers,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
    )
    # the vendored checkpoint tokenizers (when present) must be used for
    # TRAINING prompts too -- hash-fallback ids here would train the CN on a
    # different prompt-embedding distribution than serving uses
    tokenize = lambda p: _tokenize(  # noqa: E731
        p, pipeline.clip.config, pipeline.t5.config, args.checkpoint_dir)
    if args.corpus_dir:
        from reptext.data_disk import DiskImageTextDataset

        dataset = DiskImageTextDataset(
            pipeline, args.corpus_dir, batch_size=args.batch_size,
            font_path=args.font, seed=args.seed, tokenize=tokenize,
        )
    else:
        dataset = GlyphTextDataset(
            pipeline, batch_size=args.batch_size, font_path=args.font,
            seed=args.seed, tokenize=tokenize,
        )

    def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return pipeline.flux.apply(p, x, ctx, pooled, t, iid, tid, g,
                                   controlnet_block_samples=br,
                                   controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, t, iid, tid, g, scale):
        kw = {}
        if cn_cfg.union:
            # union checkpoints need a conditioning-type index in training
            # exactly as in sampling (models/controlnet.py mode token)
            if args.controlnet_mode is None:
                raise SystemExit("training a union-mode ControlNet requires "
                                 "--controlnet-mode")
            import jax.numpy as _jnp
            kw["mode"] = _jnp.full((x.shape[0],), args.controlnet_mode,
                                   _jnp.int32)
        return pipeline.controlnet.apply(p, x, cnd, ctx, pooled, t, iid, tid,
                                         g, conditioning_scale=scale, **kw)

    perceptual, frozen_extra = None, ()
    if args.ocr_loss_weight > 0.0:
        # OCR text-perceptual term: frozen VAE decoder + frozen CTC judge
        # inside the jitted step (sampling/ocr_loss.py)
        from reptext.eval.ocr import load_judge
        from reptext.ops.latents import unpack_latents

        cfg = pipeline.pipe_cfg
        vcfg = pipeline.vae.config

        def decode_apply(vae_params, x0_packed):
            lat = unpack_latents(x0_packed, cfg.latent_height, cfg.latent_width)
            lat = lat / vcfg.scaling_factor + vcfg.shift_factor
            return pipeline.vae.apply(
                vae_params, lat.transpose(0, 2, 3, 1), method="decode"
            )

        perceptual = {"decode_apply": decode_apply, "judge_apply": None,
                      "weight": args.ocr_loss_weight}
        frozen_extra = (pipeline.params["vae"], load_judge(args.ocr_judge))

    # cn_params and opt_state are donated: the step updates them in place
    # instead of holding the old and new ControlNet state at once
    step = compiler.jit(make_controlnet_train_step(
        flux_apply, cn_apply, optimizer,
        text_loss_weight=args.text_loss_weight,
        perceptual=perceptual,
    ), donate_argnums=(0, 1))

    batch_fn = dataset.batch
    if args.shard:
        # distributed training: Megatron TP rules on both stacks + dp batch
        # sharding (parallel/partition.py); the jitted step compiles SPMD
        # from the input shardings (parity: mesh_scenarios.
        # check_sharded_cn_train_step)
        from reptext.parallel import make_mesh, shard_batch, shard_params

        spec = args.shard.lower()
        if spec.startswith("sp"):
            raise SystemExit("--shard spN is an inference mode; training "
                             "shards dp x tp (e.g. --shard 2x4)")
        if spec == "auto":
            dp, tp = 1, len(jax.devices())
        else:
            try:
                dp, tp = (int(x) for x in spec.split("x"))
            except ValueError:
                raise SystemExit("--shard expects DPxTP (e.g. 2x4) or 'auto'")
        if args.batch_size % max(dp, 1) != 0:
            raise SystemExit(f"--batch-size {args.batch_size} not divisible "
                             f"by dp={dp}")
        mesh = make_mesh(dp=dp, tp=tp)
        flux_params = shard_params(flux_params, mesh)
        cn_params = shard_params(cn_params, mesh)
        opt_state = jax.jit(optimizer.init)(cn_params)
        frozen_extra = tuple(
            shard_params(t, mesh) if t is not None else None
            for t in frozen_extra
        )
        batch_fn = lambda s: shard_batch(dataset.batch(s), mesh)  # noqa: E731

    loader = PrefetchLoader(batch_fn, depth=2)  # host build overlaps device step
    trainer = ElasticTrainer(
        bind_frozen_base(step, flux_params, *frozen_extra),
        batch_fn=loader,
        checkpoint_dir=args.train_dir,
        checkpoint_every=args.checkpoint_every,
        on_event=lambda kind, info: print(f"[{kind}] {info}", flush=True),
    )
    try:
        cn_params, opt_state = trainer.run(
            cn_params, opt_state, args.train_steps, jax.random.PRNGKey(args.seed)
        )
    finally:
        loader.close()
    losses = np.asarray(trainer.losses)
    for loss in losses.tolist():
        default_metrics.observe("train.loss", loss)
    k = max(1, min(10, len(losses) // 4))
    print(f"trained {args.train_steps} steps: "
          f"loss(first {k} mean)={losses[:k].mean():.4f} -> "
          f"loss(last {k} mean)={losses[-k:].mean():.4f}")
    if args.train_dir:
        from reptext.io.checkpoint import save_pipeline_params

        out = os.path.join(args.train_dir, "controlnet_final")
        save_pipeline_params({"controlnet": jax.device_get(cn_params)}, out)
        print(f"saved trained ControlNet params to {out}")
    return 0


def _tokenize(prompt, clip_cfg, t5_cfg, checkpoint_dir):
    """Vendored tokenizers from checkpoint-dir files (no transformers import;
    reference wires HF tokenizers via the pipeline,
    RepText/pipeline_flux_controlnet.py:194-226); else deterministic fallback
    ids (keeps demo mode runnable with zero network egress)."""
    import jax.numpy as jnp

    if checkpoint_dir:
        clip_tok_dir = os.path.join(checkpoint_dir, "tokenizer")
        t5_spm = os.path.join(checkpoint_dir, "tokenizer_2", "spiece.model")
        if os.path.isfile(os.path.join(clip_tok_dir, "vocab.json")) and os.path.isfile(t5_spm):
            from reptext.text import CLIPBPETokenizer, SentencePieceUnigram

            ct = CLIPBPETokenizer.from_dir(clip_tok_dir)
            tt = SentencePieceUnigram.from_file(t5_spm)
            clip_ids = [ct.encode(prompt, max_length=clip_cfg.max_position_embeddings)]
            t5_ids = [tt.encode(prompt, max_length=512, add_eos=True, pad_to_max=True)]
            return jnp.asarray(clip_ids, jnp.int32), jnp.asarray(t5_ids, jnp.int32)

    # fallback: stable per-word hash ids (demo only)
    words = prompt.split()[:16]
    clip = [min(hash(w) % (clip_cfg.vocab_size - 2) + 1, clip_cfg.vocab_size - 2)
            for w in words]
    clip = (clip + [clip_cfg.eos_token_id])[:clip_cfg.max_position_embeddings]
    clip += [0] * (min(16, clip_cfg.max_position_embeddings) - len(clip))
    t5 = [min(hash(w) % (t5_cfg.vocab_size - 2) + 2, t5_cfg.vocab_size - 1)
          for w in words] + [1]
    return (
        jnp.asarray([clip], jnp.int32),
        jnp.asarray([t5], jnp.int32),
    )


if __name__ == "__main__":
    sys.exit(main())
