"""One-command checkpoint conversion: HF snapshots -> a runnable --checkpoint-dir.

The reference loads every component through diffusers ``from_pretrained``
(RepText/infer.py:30-33). The equivalent here is a one-time offline
conversion of the published safetensors checkpoints into this framework's
orbax param trees:

    python -m reptext.io.convert_cli \\
        --pipeline-dir   ~/ckpts/FLUX.1-dev \\
        --controlnet-dir ~/ckpts/RepText \\
        --inpaint-controlnet-dir ~/ckpts/FLUX.1-dev-Controlnet-Inpainting-Beta \\
        --out ~/ckpts/converted

    python -m reptext.cli --checkpoint-dir ~/ckpts/converted ...

``--pipeline-dir`` is an HF snapshot of the base pipeline (subdirectories
``transformer/ vae/ text_encoder/ text_encoder_2/`` with config.json +
safetensors shards, plus ``tokenizer/`` and ``tokenizer_2/`` whose assets
are copied into the output for the vendored tokenizers). ControlNets are
standalone snapshots (config.json + safetensors at the top level).

Model geometry — block depths, guidance embeds, extra condition channels,
union-mode token count — is read from each component's ``config.json``, so
the converted tree matches the ACTUAL checkpoint (e.g. whatever depth the
published Shakker-Labs/RepText ControlNet was trained at), not this
library's defaults. SURVEY.md §2.2 notes the reference gets these facts the
same way (diffusers ConfigMixin).

IP-Adapter (optional): ``--ip-adapter <file-or-dir> --image-encoder-dir
<CLIP-vision snapshot>`` writes ``<out>/ip_adapter/`` with components
{vision, proj, blocks} consumed by ``--ip-adapter-dir`` in the driver; the
stacked to_k_ip/to_v_ip ``blocks`` are merged into the resident flux params
at attach time (no duplicated 24 GB transformer copy on disk).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
from typing import Any, Dict, Optional

import numpy as np

from reptext.configs import (
    CLIPConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    FluxConfig,
    T5Config,
    VAEConfig,
)


def _read_config(component_dir: str) -> Dict[str, Any]:
    path = os.path.join(component_dir, "config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _replace_known(cfg, hf: Dict[str, Any], mapping: Dict[str, str]):
    """dataclasses.replace(cfg) with every mapped key present in hf."""
    kw = {}
    for ours, theirs in mapping.items():
        if theirs in hf and hf[theirs] is not None:
            v = hf[theirs]
            kw[ours] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(cfg, **kw)


_FLUX_MAP = {
    "in_channels": "in_channels",
    "num_layers": "num_layers",
    "num_single_layers": "num_single_layers",
    "attention_head_dim": "attention_head_dim",
    "num_attention_heads": "num_attention_heads",
    "joint_attention_dim": "joint_attention_dim",
    "pooled_projection_dim": "pooled_projection_dim",
    "guidance_embeds": "guidance_embeds",
    "axes_dims_rope": "axes_dims_rope",
}


def flux_config_from_hf(hf: Dict[str, Any]) -> FluxConfig:
    return _replace_known(FluxConfig(), hf, _FLUX_MAP)


def controlnet_config_from_hf(hf: Dict[str, Any]) -> ControlNetConfig:
    cfg = _replace_known(
        ControlNetConfig(), hf,
        dict(_FLUX_MAP, extra_condition_channels="extra_condition_channels"),
    )
    # num_mode=None means non-union; only replace when the checkpoint has it
    if hf.get("num_mode") is not None:
        cfg = dataclasses.replace(cfg, num_mode=int(hf["num_mode"]))
    return cfg


def vae_config_from_hf(hf: Dict[str, Any]) -> VAEConfig:
    return _replace_known(
        VAEConfig(), hf,
        {
            "in_channels": "in_channels",
            "out_channels": "out_channels",
            "latent_channels": "latent_channels",
            "block_out_channels": "block_out_channels",
            "layers_per_block": "layers_per_block",
            "norm_num_groups": "norm_num_groups",
            "scaling_factor": "scaling_factor",
            "shift_factor": "shift_factor",
        },
    )


def clip_config_from_hf(hf: Dict[str, Any]) -> CLIPConfig:
    return _replace_known(
        CLIPConfig(), hf,
        {
            "vocab_size": "vocab_size",
            "hidden_size": "hidden_size",
            "intermediate_size": "intermediate_size",
            "num_layers": "num_hidden_layers",
            "num_heads": "num_attention_heads",
            "max_position_embeddings": "max_position_embeddings",
            "eos_token_id": "eos_token_id",
        },
    )


def t5_config_from_hf(hf: Dict[str, Any]) -> T5Config:
    return _replace_known(
        T5Config(), hf,
        {
            "vocab_size": "vocab_size",
            "d_model": "d_model",
            "d_kv": "d_kv",
            "d_ff": "d_ff",
            "num_layers": "num_layers",
            "num_heads": "num_heads",
            "relative_attention_num_buckets": "relative_attention_num_buckets",
            "relative_attention_max_distance": "relative_attention_max_distance",
        },
    )


def clip_vision_config_from_hf(hf: Dict[str, Any]) -> CLIPVisionConfig:
    return _replace_known(
        CLIPVisionConfig(), hf,
        {
            "image_size": "image_size",
            "patch_size": "patch_size",
            "hidden_size": "hidden_size",
            "intermediate_size": "intermediate_size",
            "num_layers": "num_hidden_layers",
            "num_heads": "num_attention_heads",
            "projection_dim": "projection_dim",
        },
    )


def _cast_tree(tree: Any, dtype) -> Any:
    """Cast every floating leaf; leaves int/bool leaves untouched."""
    import jax

    def cast(leaf):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            return a
        return a.astype(dtype) if a.dtype != dtype else a

    return jax.tree_util.tree_map(cast, tree)


_STORAGE_DTYPES = {"keep": None, "bf16": "bfloat16", "fp32": "float32", "fp8": "fp8"}


def _storage_dtype(name: str):
    if name in ("keep", "fp8"):   # fp8 handled per-component in main()
        return None
    if name == "fp32":
        return np.float32
    import ml_dtypes

    return ml_dtypes.bfloat16


def _copy_tokenizers(pipeline_dir: str, out: str) -> list:
    """Copy tokenizer assets the vendored tokenizers read (cli.py::_tokenize)."""
    copied = []
    clip_src = os.path.join(pipeline_dir, "tokenizer")
    if os.path.isdir(clip_src):
        dst = os.path.join(out, "tokenizer")
        os.makedirs(dst, exist_ok=True)
        for fname in ("vocab.json", "merges.txt", "special_tokens_map.json"):
            p = os.path.join(clip_src, fname)
            if os.path.isfile(p):
                shutil.copy2(p, os.path.join(dst, fname))
                copied.append(f"tokenizer/{fname}")
    spm_src = os.path.join(pipeline_dir, "tokenizer_2", "spiece.model")
    if os.path.isfile(spm_src):
        dst = os.path.join(out, "tokenizer_2")
        os.makedirs(dst, exist_ok=True)
        shutil.copy2(spm_src, os.path.join(dst, "spiece.model"))
        copied.append("tokenizer_2/spiece.model")
    return copied


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert HF safetensors checkpoints to a reptext "
                    "--checkpoint-dir (orbax param trees)")
    parser.add_argument("--pipeline-dir", default=None,
                        help="HF FLUX.1 pipeline snapshot (transformer/ vae/ "
                             "text_encoder/ text_encoder_2/ tokenizer*/)")
    parser.add_argument("--controlnet-dir", default=None,
                        help="RepText ControlNet snapshot (config.json + "
                             "safetensors)")
    parser.add_argument("--inpaint-controlnet-dir", default=None,
                        help="inpainting ControlNet snapshot (alimama beta)")
    parser.add_argument("--ip-adapter", default=None, metavar="PATH",
                        help="FLUX IP-Adapter safetensors file or dir")
    parser.add_argument("--image-encoder-dir", default=None,
                        help="CLIP vision tower snapshot for the IP-Adapter")
    parser.add_argument("--flux-dir", default=None,
                        help="override: transformer snapshot dir (else "
                             "<pipeline-dir>/transformer)")
    parser.add_argument("--flux-single-file", default=None, metavar="PATH",
                        help="BFL single-file transformer checkpoint "
                             "(flux1-dev.safetensors original naming, "
                             "optionally ComfyUI-wrapped, or diffusers "
                             "naming) instead of a snapshot dir — the "
                             "reference's FromSingleFileMixin surface; "
                             "geometry is inferred from the weights")
    parser.add_argument("--vae-dir", default=None)
    parser.add_argument("--clip-dir", default=None)
    parser.add_argument("--t5-dir", default=None)
    parser.add_argument("--lora", action="append", default=None, metavar="PATH",
                        help="LoRA safetensors (diffusers FLUX naming) baked "
                             "into the converted transformer; repeatable. "
                             "Alternative to the driver's load-time --lora "
                             "(bake once for serving fleets)")
    parser.add_argument("--lora-scale", action="append", type=float,
                        default=None, metavar="S",
                        help="merge scale per --lora (default 1.0 each)")
    parser.add_argument("--dtype", choices=sorted(_STORAGE_DTYPES),
                        default="keep",
                        help="storage dtype of saved params: keep = as stored "
                             "in the checkpoint (FLUX publishes bf16), "
                             "bf16/fp32 = force-cast, fp8 = weight-only "
                             "fp8-e4m3 block stacks + bf16 rest (half the "
                             "disk/HBM; drivers auto-detect and run "
                             "weight_quant — io/quantize.py)")
    parser.add_argument("--out", required=True,
                        help="output directory (becomes --checkpoint-dir)")
    args = parser.parse_args(argv)

    from reptext.io import convert as C
    from reptext.io.checkpoint import LAYOUT_VERSION, _checkpointer, _LAYOUT_FILE

    def comp_dir(override, sub):
        if override:
            return override
        if args.pipeline_dir:
            d = os.path.join(args.pipeline_dir, sub)
            return d if os.path.isdir(d) else None
        return None

    plan = []  # (component_name, source_dir, config_fn, convert_fn)
    flux_dir = comp_dir(args.flux_dir, "transformer")
    if args.flux_single_file:
        plan.append(("flux", args.flux_single_file, None,
                     C.convert_flux_transformer))
        flux_dir = None
    elif flux_dir:
        plan.append(("flux", flux_dir, flux_config_from_hf,
                     C.convert_flux_transformer))
    vae_dir = comp_dir(args.vae_dir, "vae")
    if vae_dir:
        plan.append(("vae", vae_dir, vae_config_from_hf, C.convert_vae))
    clip_dir = comp_dir(args.clip_dir, "text_encoder")
    if clip_dir:
        plan.append(("clip", clip_dir, clip_config_from_hf, C.convert_clip))
    t5_dir = comp_dir(args.t5_dir, "text_encoder_2")
    if t5_dir:
        plan.append(("t5", t5_dir, t5_config_from_hf, C.convert_t5))
    if args.controlnet_dir:
        plan.append(("controlnet", args.controlnet_dir,
                     controlnet_config_from_hf, C.convert_controlnet))
    if args.inpaint_controlnet_dir:
        plan.append(("inpaint_controlnet", args.inpaint_controlnet_dir,
                     controlnet_config_from_hf, C.convert_controlnet))
    if not plan and not args.ip_adapter:
        parser.error("nothing to convert: pass --pipeline-dir and/or "
                     "--controlnet-dir / component overrides")
    if args.lora and not any(entry[0] == "flux" for entry in plan):
        parser.error("--lora requires a transformer source "
                     "(--pipeline-dir or --flux-dir)")

    dtype = _storage_dtype(args.dtype)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    ckptr = _checkpointer()
    configs_meta: Dict[str, Any] = {}

    # one component at a time: a full bf16 FLUX.1-dev state is ~24 GB host
    # RAM; converting sequentially keeps peak memory at one component.
    for name, src, cfg_fn, conv_fn in plan:
        if name == "flux" and args.flux_single_file:
            from reptext.io.single_file import (
                bfl_flux_to_diffusers,
                flux_config_from_state,
                is_bfl_flux,
                strip_wrapper_prefixes,
            )

            state = strip_wrapper_prefixes(
                C.load_safetensors_state(src, dtype=None))
            if is_bfl_flux(state):
                state = bfl_flux_to_diffusers(state)
            cfg = flux_config_from_state(state)
        else:
            hf_cfg = _read_config(src)
            cfg = cfg_fn(hf_cfg)
            if not hf_cfg:
                print(f"[{name}] no config.json in {src}; using library "
                      "defaults", file=sys.stderr)
            state = C.load_safetensors_state(src, dtype=None)
        n_params = sum(int(np.prod(v.shape)) for v in state.values())
        tree = conv_fn(state, cfg)
        del state
        if name == "flux" and args.lora:
            from reptext.io.lora import apply_lora

            scales = list(args.lora_scale or [])
            if len(scales) > len(args.lora):
                parser.error("more --lora-scale values than --lora paths")
            scales += [1.0] * (len(args.lora) - len(scales))
            for lp, sc in zip(args.lora, scales):
                tree = apply_lora(
                    tree, C.load_safetensors_state(lp, dtype=None),
                    scale=sc, head_dim=cfg.attention_head_dim,
                )
                print(f"[flux] baked LoRA {lp} (scale {sc})")
        if args.dtype == "fp8":
            # after any LoRA bake: deltas must merge into dense weights
            import ml_dtypes

            from reptext.io.quantize import quantize_params

            tree = _cast_tree(tree, ml_dtypes.bfloat16)
            if name in ("flux", "controlnet", "inpaint_controlnet"):
                tree = dict(tree)
                tree["params"] = quantize_params(tree["params"])
        if dtype is not None:
            tree = _cast_tree(tree, dtype)
        ckptr.save(os.path.join(out, name), tree)
        del tree
        configs_meta[name] = dataclasses.asdict(cfg)
        print(f"[{name}] {n_params/1e9:.3f}B params <- {src}")

    # IP-Adapter bundle: vision tower + image projection + stacked ip blocks
    if args.ip_adapter:
        ip_out = os.path.join(out, "ip_adapter")
        os.makedirs(ip_out, exist_ok=True)
        n_layers = None
        flux_meta = configs_meta.get("flux")
        if flux_meta:
            n_layers = flux_meta["num_layers"]
        if n_layers is None and flux_dir:
            n_layers = flux_config_from_hf(_read_config(flux_dir)).num_layers
        if n_layers is None:
            n_layers = FluxConfig().num_layers
        if args.dtype == "fp8":
            import ml_dtypes

            dtype = ml_dtypes.bfloat16    # adapter merges at attach; the
            # driver re-quantizes the whole stack afterwards
        state = C.load_safetensors_state(args.ip_adapter, dtype=None)
        head_dim = (flux_meta or {}).get("attention_head_dim",
                                         FluxConfig().attention_head_dim)
        ip = C.convert_ip_adapter(state, num_layers=n_layers, head_dim=head_dim)
        del state
        proj, blocks = ip["proj"], {"params": ip["blocks"]}
        if dtype is not None:
            proj, blocks = _cast_tree(proj, dtype), _cast_tree(blocks, dtype)
        ckptr.save(os.path.join(ip_out, "proj"), proj)
        ckptr.save(os.path.join(ip_out, "blocks"), blocks)
        print(f"[ip_adapter] {n_layers}-layer to_k_ip/to_v_ip + projection "
              f"<- {args.ip_adapter}")
        if args.image_encoder_dir:
            vcfg = clip_vision_config_from_hf(_read_config(args.image_encoder_dir))
            vstate = C.load_safetensors_state(args.image_encoder_dir, dtype=None)
            vision = C.convert_clip_vision(vstate, vcfg)
            del vstate
            if dtype is not None:
                vision = _cast_tree(vision, dtype)
            ckptr.save(os.path.join(ip_out, "vision"), vision)
            configs_meta["clip_vision"] = dataclasses.asdict(vcfg)
            print(f"[ip_adapter/vision] <- {args.image_encoder_dir}")
        with open(os.path.join(ip_out, _LAYOUT_FILE), "w") as f:
            f.write(f"{LAYOUT_VERSION}\n")

    copied = _copy_tokenizers(args.pipeline_dir, out) if args.pipeline_dir else []
    for c in copied:
        print(f"[tokenizer] {c}")

    if plan:
        with open(os.path.join(out, _LAYOUT_FILE), "w") as f:
            f.write(f"{LAYOUT_VERSION}\n")
    # record the checkpoint-derived geometry so drivers can rebuild the
    # exact model configs without re-reading the HF snapshots
    with open(os.path.join(out, "configs.json"), "w") as f:
        json.dump(configs_meta, f, indent=1, sort_keys=True)
    print(f"wrote {out} (param layout v{LAYOUT_VERSION}, dtype={args.dtype})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
