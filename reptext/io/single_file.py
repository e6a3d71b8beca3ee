"""BFL single-file FLUX checkpoint support (``FromSingleFileMixin`` parity).

The reference pipelines inherit diffusers' ``FromSingleFileMixin``
(RepText/pipeline_flux_controlnet.py:195, pipeline_flux_controlnet_inpaint.py
class bases), so reference users can load Black Forest Labs' original
``flux1-dev.safetensors`` / ``flux1-schnell.safetensors`` layout instead of a
diffusers snapshot directory. This module is the analogue here: a
pure numpy key remap from the BFL layout to diffusers naming, after which the
single converter (:mod:`reptext.io.convert`) applies — the RoPE-fold and
kernel-layout logic stays single-sourced.

BFL layout facts handled here (same facts diffusers' own
``convert_flux_to_diffusers`` conversion encodes; interface constants, not
code):

- fused attention projections: ``double_blocks.{i}.{img,txt}_attn.qkv`` rows
  are [q; k; v]; ``single_blocks.{i}.linear1`` rows are [q; k; v; mlp];
- MLPEmbedder naming: ``time_in/vector_in/guidance_in.{in,out}_layer`` map to
  ``time_text_embed.*_embedder.linear_{1,2}``;
- per-head QK-RMSNorm scales live at ``*.norm.{query,key}_norm.scale``;
- the final AdaLN produces [shift; scale] while diffusers'
  ``AdaLayerNormContinuous`` consumes [scale; shift] — the two output halves
  of ``final_layer.adaLN_modulation.1`` are swapped;
- ComfyUI-style dumps wrap everything under ``model.diffusion_model.``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from reptext.configs import FluxConfig
from reptext.io.convert import convert_flux_transformer, load_safetensors_state

_WRAPPER_PREFIXES = ("model.diffusion_model.", "module.")


def strip_wrapper_prefixes(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove ComfyUI/DDP-style key wrappers, keeping unwrapped keys as-is."""
    for prefix in _WRAPPER_PREFIXES:
        if any(k.startswith(prefix) for k in state):
            state = {
                (k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in state.items()
            }
    return state


def is_bfl_flux(state: Dict[str, np.ndarray]) -> bool:
    """True when the state dict uses BFL original naming."""
    return "double_blocks.0.img_attn.qkv.weight" in state


def _swap_scale_shift(w: np.ndarray) -> np.ndarray:
    shift, scale = np.split(w, 2, axis=0)
    return np.ascontiguousarray(np.concatenate([scale, shift], axis=0))


def bfl_flux_to_diffusers(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remap a BFL-layout FLUX transformer state dict to diffusers naming.

    Pure renames/splits on numpy arrays (torch ``[out, in]`` layout is
    preserved); :func:`convert_flux_transformer` handles the rest.
    """
    out: Dict[str, np.ndarray] = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = state[f"{src}.weight"]
        if f"{src}.bias" in state:
            out[f"{dst}.bias"] = state[f"{src}.bias"]

    def split_rows(srcname: str, dsts, sizes) -> None:
        w = state[f"{srcname}.weight"]
        offs = np.cumsum(sizes)[:-1]
        for dst, piece in zip(dsts, np.split(w, offs, axis=0)):
            out[f"{dst}.weight"] = np.ascontiguousarray(piece)
        if f"{srcname}.bias" in state:
            for dst, piece in zip(dsts, np.split(state[f"{srcname}.bias"], offs)):
                out[f"{dst}.bias"] = np.ascontiguousarray(piece)

    d = state["img_in.weight"].shape[0]

    put("x_embedder", "img_in")
    put("context_embedder", "txt_in")
    put("time_text_embed.timestep_embedder.linear_1", "time_in.in_layer")
    put("time_text_embed.timestep_embedder.linear_2", "time_in.out_layer")
    put("time_text_embed.text_embedder.linear_1", "vector_in.in_layer")
    put("time_text_embed.text_embedder.linear_2", "vector_in.out_layer")
    if "guidance_in.in_layer.weight" in state:
        put("time_text_embed.guidance_embedder.linear_1", "guidance_in.in_layer")
        put("time_text_embed.guidance_embedder.linear_2", "guidance_in.out_layer")

    n_double = 1 + max(
        (int(k.split(".")[1]) for k in state if k.startswith("double_blocks.")),
        default=-1,
    )
    for i in range(n_double):
        s, p = f"double_blocks.{i}", f"transformer_blocks.{i}"
        put(f"{p}.norm1.linear", f"{s}.img_mod.lin")
        put(f"{p}.norm1_context.linear", f"{s}.txt_mod.lin")
        split_rows(f"{s}.img_attn.qkv",
                   [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"],
                   [d, d, d])
        split_rows(f"{s}.txt_attn.qkv",
                   [f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj",
                    f"{p}.attn.add_v_proj"],
                   [d, d, d])
        out[f"{p}.attn.norm_q.weight"] = state[f"{s}.img_attn.norm.query_norm.scale"]
        out[f"{p}.attn.norm_k.weight"] = state[f"{s}.img_attn.norm.key_norm.scale"]
        out[f"{p}.attn.norm_added_q.weight"] = state[f"{s}.txt_attn.norm.query_norm.scale"]
        out[f"{p}.attn.norm_added_k.weight"] = state[f"{s}.txt_attn.norm.key_norm.scale"]
        put(f"{p}.attn.to_out.0", f"{s}.img_attn.proj")
        put(f"{p}.attn.to_add_out", f"{s}.txt_attn.proj")
        put(f"{p}.ff.net.0.proj", f"{s}.img_mlp.0")
        put(f"{p}.ff.net.2", f"{s}.img_mlp.2")
        put(f"{p}.ff_context.net.0.proj", f"{s}.txt_mlp.0")
        put(f"{p}.ff_context.net.2", f"{s}.txt_mlp.2")

    n_single = 1 + max(
        (int(k.split(".")[1]) for k in state if k.startswith("single_blocks.")),
        default=-1,
    )
    for i in range(n_single):
        s, p = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        put(f"{p}.norm.linear", f"{s}.modulation.lin")
        mlp_dim = state[f"{s}.linear1.weight"].shape[0] - 3 * d
        split_rows(f"{s}.linear1",
                   [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v",
                    f"{p}.proj_mlp"],
                   [d, d, d, mlp_dim])
        put(f"{p}.proj_out", f"{s}.linear2")
        out[f"{p}.attn.norm_q.weight"] = state[f"{s}.norm.query_norm.scale"]
        out[f"{p}.attn.norm_k.weight"] = state[f"{s}.norm.key_norm.scale"]

    out["norm_out.linear.weight"] = _swap_scale_shift(
        state["final_layer.adaLN_modulation.1.weight"]
    )
    if "final_layer.adaLN_modulation.1.bias" in state:
        out["norm_out.linear.bias"] = _swap_scale_shift(
            state["final_layer.adaLN_modulation.1.bias"]
        )
    put("proj_out", "final_layer.linear")
    return out


def flux_config_from_state(state: Dict[str, np.ndarray],
                           head_dim: int = 128) -> FluxConfig:
    """Infer FLUX geometry from a diffusers-named state dict.

    Single-file checkpoints carry no config.json; everything except the head
    dim (all published FLUX.1 variants use 128) is derivable from shapes —
    including guidance distillation (dev has ``guidance_in``, schnell
    doesn't).
    """
    import dataclasses

    inner = state["x_embedder.weight"].shape[0]
    n_double = 1 + max(
        (int(k.split(".")[1]) for k in state if k.startswith("transformer_blocks.")),
        default=-1,
    )
    n_single = 1 + max(
        (int(k.split(".")[1])
         for k in state if k.startswith("single_transformer_blocks.")),
        default=-1,
    )
    return dataclasses.replace(
        FluxConfig(),
        in_channels=state["x_embedder.weight"].shape[1],
        num_layers=n_double,
        num_single_layers=n_single,
        attention_head_dim=head_dim,
        num_attention_heads=inner // head_dim,
        joint_attention_dim=state["context_embedder.weight"].shape[1],
        pooled_projection_dim=state[
            "time_text_embed.text_embedder.linear_1.weight"].shape[1],
        guidance_embeds=(
            "time_text_embed.guidance_embedder.linear_1.weight" in state),
    )


def load_flux_single_file(path: str, cfg: FluxConfig, dtype=np.float32) -> Dict:
    """Load a FLUX transformer from one safetensors file in either layout.

    Accepts BFL original naming (``flux1-dev.safetensors``, optionally
    ComfyUI-wrapped) or diffusers naming; returns framework variables
    (``{"params": ...}``) via the standard converter.
    """
    state = strip_wrapper_prefixes(load_safetensors_state(path, dtype))
    if is_bfl_flux(state):
        state = bfl_flux_to_diffusers(state)
    return convert_flux_transformer(state, cfg)
