"""Synthetic HF-format checkpoints at tiny config for converter tests.

Builds state dicts with EXACTLY the torch/diffusers/transformers key names
the published checkpoints use (FLUX.1-dev transformer/VAE, Shakker-Labs
RepText ControlNet, CLIP-L text encoder, T5 encoder — naming pinned by the
torch-parity suites), and writes them as HF-layout snapshot directories
(config.json + *.safetensors) so `reptext.io.convert_cli` can be tested
end-to-end without network access or real weights.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from reptext.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig


def _rng(seed=0):
    return np.random.default_rng(seed)


def flux_state(cfg: FluxConfig, seed: int = 0) -> dict:
    """diffusers FluxTransformer2DModel state dict (random values)."""
    r, state = _rng(seed), {}
    d = cfg.inner_dim

    def lin(name, i, o, bias=True):
        state[f"{name}.weight"] = r.standard_normal((o, i)).astype(np.float32) * 0.02
        if bias:
            state[f"{name}.bias"] = r.standard_normal((o,)).astype(np.float32) * 0.02

    lin("x_embedder", cfg.in_channels, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    embs = [("timestep_embedder", cfg.time_embed_dim),
            ("text_embedder", cfg.pooled_projection_dim)]
    if cfg.guidance_embeds:
        embs.insert(1, ("guidance_embedder", cfg.time_embed_dim))
    for emb, width in embs:
        lin(f"time_text_embed.{emb}.linear_1", width, d)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for nm in ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k", "norm_added_q", "norm_added_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"{p}.attn.to_out.0", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        lin(f"{p}.ff.net.0.proj", d, 4 * d)
        lin(f"{p}.ff.net.2", 4 * d, d)
        lin(f"{p}.ff_context.net.0.proj", d, 4 * d)
        lin(f"{p}.ff_context.net.2", 4 * d, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        lin(f"{p}.proj_mlp", d, 4 * d)
        lin(f"{p}.proj_out", 5 * d, d)
        for nm in ["to_q", "to_k", "to_v"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.out_channels)
    return state


def controlnet_state(cfg: ControlNetConfig, seed: int = 1) -> dict:
    """diffusers FluxControlNetModel state dict (RepText layout)."""
    r, state = _rng(seed), {}
    d = cfg.inner_dim

    def lin(name, i, o):
        state[f"{name}.weight"] = r.standard_normal((o, i)).astype(np.float32) * 0.02
        state[f"{name}.bias"] = r.standard_normal((o,)).astype(np.float32) * 0.02

    lin("x_embedder", cfg.in_channels, d)
    lin("controlnet_x_embedder", cfg.in_channels + cfg.extra_condition_channels, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    embs = [("timestep_embedder", cfg.time_embed_dim),
            ("text_embedder", cfg.pooled_projection_dim)]
    if cfg.guidance_embeds:
        embs.insert(1, ("guidance_embedder", cfg.time_embed_dim))
    for emb, width in embs:
        lin(f"time_text_embed.{emb}.linear_1", width, d)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    if cfg.num_mode is not None:
        state["controlnet_mode_embedder.weight"] = (
            r.standard_normal((cfg.num_mode, d)).astype(np.float32) * 0.02
        )
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for nm in ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k", "norm_added_q", "norm_added_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"{p}.attn.to_out.0", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        lin(f"{p}.ff.net.0.proj", d, 4 * d)
        lin(f"{p}.ff.net.2", 4 * d, d)
        lin(f"{p}.ff_context.net.0.proj", d, 4 * d)
        lin(f"{p}.ff_context.net.2", 4 * d, d)
        lin(f"controlnet_blocks.{i}", d, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        lin(f"{p}.proj_mlp", d, 4 * d)
        lin(f"{p}.proj_out", 5 * d, d)
        for nm in ["to_q", "to_k", "to_v"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"controlnet_single_blocks.{i}", d, d)
    return state


def vae_state(cfg: VAEConfig, seed: int = 2) -> dict:
    """diffusers AutoencoderKL state dict."""
    r, state = _rng(seed), {}
    ch = cfg.block_out_channels

    def conv(name, i, o, k=3):
        state[f"{name}.weight"] = r.standard_normal((o, i, k, k)).astype(np.float32) * 0.02
        state[f"{name}.bias"] = r.standard_normal((o,)).astype(np.float32) * 0.02

    def norm(name, c):
        state[f"{name}.weight"] = np.ones((c,), np.float32)
        state[f"{name}.bias"] = np.zeros((c,), np.float32)

    def resnet(prefix, i, o):
        norm(f"{prefix}.norm1", i); conv(f"{prefix}.conv1", i, o)
        norm(f"{prefix}.norm2", o); conv(f"{prefix}.conv2", o, o)
        if i != o:
            conv(f"{prefix}.conv_shortcut", i, o, 1)

    def attn(prefix, c):
        norm(f"{prefix}.group_norm", c)
        for nm in ["to_q", "to_k", "to_v", "to_out.0"]:
            state[f"{prefix}.{nm}.weight"] = (
                r.standard_normal((c, c)).astype(np.float32) * 0.02
            )
            state[f"{prefix}.{nm}.bias"] = np.zeros((c,), np.float32)

    conv("encoder.conv_in", cfg.in_channels, ch[0])
    in_c = ch[0]
    for i, out_c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out_c, out_c)
        in_c = out_c
    resnet("encoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("encoder.mid_block.attentions.0", ch[-1])
    resnet("encoder.mid_block.resnets.1", ch[-1], ch[-1])
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", ch[-1], 2 * cfg.latent_channels)

    conv("decoder.conv_in", cfg.latent_channels, ch[-1])
    resnet("decoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("decoder.mid_block.attentions.0", ch[-1])
    resnet("decoder.mid_block.resnets.1", ch[-1], ch[-1])
    rev = list(reversed(ch))
    in_c = rev[0]
    for i, out_c in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
        in_c = out_c
    norm("decoder.conv_norm_out", ch[0])
    conv("decoder.conv_out", ch[0], cfg.out_channels)
    return state


def clip_state(cfg: CLIPConfig, seed: int = 3) -> dict:
    """transformers CLIPTextModel state dict."""
    r, state = _rng(seed), {}
    tm = "text_model"
    h = cfg.hidden_size

    def lin(name, i, o):
        state[f"{name}.weight"] = r.standard_normal((o, i)).astype(np.float32) * 0.02
        state[f"{name}.bias"] = np.zeros((o,), np.float32)

    def norm(name, c):
        state[f"{name}.weight"] = np.ones((c,), np.float32)
        state[f"{name}.bias"] = np.zeros((c,), np.float32)

    state[f"{tm}.embeddings.token_embedding.weight"] = (
        r.standard_normal((cfg.vocab_size, h)).astype(np.float32) * 0.02
    )
    state[f"{tm}.embeddings.position_embedding.weight"] = (
        r.standard_normal((cfg.max_position_embeddings, h)).astype(np.float32) * 0.02
    )
    for i in range(cfg.num_layers):
        p = f"{tm}.encoder.layers.{i}"
        norm(f"{p}.layer_norm1", h)
        norm(f"{p}.layer_norm2", h)
        for nm in ["q_proj", "k_proj", "v_proj", "out_proj"]:
            lin(f"{p}.self_attn.{nm}", h, h)
        lin(f"{p}.mlp.fc1", h, cfg.intermediate_size)
        lin(f"{p}.mlp.fc2", cfg.intermediate_size, h)
    norm(f"{tm}.final_layer_norm", h)
    return state


def t5_state(cfg: T5Config, seed: int = 4) -> dict:
    """transformers T5EncoderModel state dict."""
    r, state = _rng(seed), {}
    dm = cfg.d_model
    inner = cfg.num_heads * cfg.d_kv

    def lin(name, i, o):
        # T5 linears are bias-free
        state[f"{name}.weight"] = r.standard_normal((o, i)).astype(np.float32) * 0.02

    state["shared.weight"] = r.standard_normal((cfg.vocab_size, dm)).astype(np.float32) * 0.02
    state["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        r.standard_normal(
            (cfg.relative_attention_num_buckets, cfg.num_heads)
        ).astype(np.float32) * 0.02
    )
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}"
        state[f"{p}.layer.0.layer_norm.weight"] = np.ones((dm,), np.float32)
        lin(f"{p}.layer.0.SelfAttention.q", dm, inner)
        lin(f"{p}.layer.0.SelfAttention.k", dm, inner)
        lin(f"{p}.layer.0.SelfAttention.v", dm, inner)
        lin(f"{p}.layer.0.SelfAttention.o", inner, dm)
        state[f"{p}.layer.1.layer_norm.weight"] = np.ones((dm,), np.float32)
        lin(f"{p}.layer.1.DenseReluDense.wi_0", dm, cfg.d_ff)
        lin(f"{p}.layer.1.DenseReluDense.wi_1", dm, cfg.d_ff)
        lin(f"{p}.layer.1.DenseReluDense.wo", cfg.d_ff, dm)
    state["encoder.final_layer_norm.weight"] = np.ones((dm,), np.float32)
    return state


# ------------------------------------------------------ HF snapshot layout


def _write_component(dir_path: str, state: dict, config: dict, shards: int = 1):
    """Write state as config.json + one or more .safetensors shards."""
    from safetensors.numpy import save_file

    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "config.json"), "w") as f:
        json.dump(config, f)
    keys = sorted(state)
    per = max(1, (len(keys) + shards - 1) // shards)
    for s in range(shards):
        chunk = {k: state[k] for k in keys[s * per:(s + 1) * per]}
        if not chunk:
            continue
        name = ("model.safetensors" if shards == 1
                else f"model-{s + 1:05d}-of-{shards:05d}.safetensors")
        save_file(chunk, os.path.join(dir_path, name))


def write_flux_pipeline_snapshot(
    root: str,
    flux_cfg: FluxConfig,
    vae_cfg: VAEConfig,
    clip_cfg: CLIPConfig,
    t5_cfg: T5Config,
) -> str:
    """HF FLUX.1-dev-style snapshot: transformer/ vae/ text_encoder/ text_encoder_2/."""
    _write_component(
        os.path.join(root, "transformer"),
        flux_state(flux_cfg),
        {
            "_class_name": "FluxTransformer2DModel",
            "in_channels": flux_cfg.in_channels,
            "num_layers": flux_cfg.num_layers,
            "num_single_layers": flux_cfg.num_single_layers,
            "attention_head_dim": flux_cfg.attention_head_dim,
            "num_attention_heads": flux_cfg.num_attention_heads,
            "joint_attention_dim": flux_cfg.joint_attention_dim,
            "pooled_projection_dim": flux_cfg.pooled_projection_dim,
            "guidance_embeds": flux_cfg.guidance_embeds,
            "axes_dims_rope": list(flux_cfg.axes_dims_rope),
        },
        shards=2,  # exercises the multi-shard load path
    )
    _write_component(
        os.path.join(root, "vae"),
        vae_state(vae_cfg),
        {
            "_class_name": "AutoencoderKL",
            "in_channels": vae_cfg.in_channels,
            "out_channels": vae_cfg.out_channels,
            "latent_channels": vae_cfg.latent_channels,
            "block_out_channels": list(vae_cfg.block_out_channels),
            "layers_per_block": vae_cfg.layers_per_block,
            "norm_num_groups": vae_cfg.norm_num_groups,
            "scaling_factor": vae_cfg.scaling_factor,
            "shift_factor": vae_cfg.shift_factor,
        },
    )
    _write_component(
        os.path.join(root, "text_encoder"),
        clip_state(clip_cfg),
        {
            "architectures": ["CLIPTextModel"],
            "vocab_size": clip_cfg.vocab_size,
            "hidden_size": clip_cfg.hidden_size,
            "intermediate_size": clip_cfg.intermediate_size,
            "num_hidden_layers": clip_cfg.num_layers,
            "num_attention_heads": clip_cfg.num_heads,
            "max_position_embeddings": clip_cfg.max_position_embeddings,
            "eos_token_id": clip_cfg.eos_token_id,
        },
    )
    _write_component(
        os.path.join(root, "text_encoder_2"),
        t5_state(t5_cfg),
        {
            "architectures": ["T5EncoderModel"],
            "vocab_size": t5_cfg.vocab_size,
            "d_model": t5_cfg.d_model,
            "d_kv": t5_cfg.d_kv,
            "d_ff": t5_cfg.d_ff,
            "num_layers": t5_cfg.num_layers,
            "num_heads": t5_cfg.num_heads,
            "relative_attention_num_buckets": t5_cfg.relative_attention_num_buckets,
            "relative_attention_max_distance": t5_cfg.relative_attention_max_distance,
        },
    )
    return root


def write_controlnet_snapshot(root: str, cfg: ControlNetConfig) -> str:
    """Shakker-Labs/RepText-style standalone ControlNet snapshot."""
    conf = {
        "_class_name": "FluxControlNetModel",
        "in_channels": cfg.in_channels,
        "num_layers": cfg.num_layers,
        "num_single_layers": cfg.num_single_layers,
        "attention_head_dim": cfg.attention_head_dim,
        "num_attention_heads": cfg.num_attention_heads,
        "joint_attention_dim": cfg.joint_attention_dim,
        "pooled_projection_dim": cfg.pooled_projection_dim,
        "guidance_embeds": cfg.guidance_embeds,
        "axes_dims_rope": list(cfg.axes_dims_rope),
        "extra_condition_channels": cfg.extra_condition_channels,
        "num_mode": cfg.num_mode,
    }
    _write_component(root, controlnet_state(cfg), conf)
    return root
