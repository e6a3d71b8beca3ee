"""FLUX.1 MMDiT diffusion transformer (nn/module.py, scan-over-layers).

The reference imports this model from diffusers (`FluxTransformer2DModel`,
invoked at RepText/pipeline_flux_controlnet.py:1092-1104). This is a
reimplementation:

- Layers run under ``nn.scan`` with stacked parameters: constant-size XLA graph
  (compile time independent of depth) and a single fused while-loop on device.
- ControlNet residual injection is an optional scanned input: per-double-block
  residuals added to the image stream, per-single-block residuals added to the
  image-token slice, matching diffusers' injection points including the
  ceil-interval index mapping for depth-mismatched ControlNets.
- Timestep semantics: callers pass sigma-scaled t in [0, 1]; the model embeds
  t*1000 (reference behavior, RepText/controlnet_flux.py:282,
  RepText/pipeline_flux_controlnet.py:1048).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.configs import FluxConfig
from reptext.io.quantize import dequantize_collection
from reptext.nn.blocks import JointTransformerBlock, SingleTransformerBlock
from reptext.nn.embeddings import CombinedTimestepTextEmbed
from reptext.nn.layers import AdaLayerNormContinuous
from reptext.ops.rope import rope_cos_sin_half

Dtype = Any


class _DoubleLayer(nn.Module):
    config: FluxConfig
    attention_backend: Optional[str]
    dtype: Dtype
    param_dtype: Dtype
    ip_adapter: bool = False

    @nn.compact
    def __call__(self, carry, idx, raw):
        if self.ip_adapter:
            ctx, x, temb, cos, sin, ip_tokens, ip_scale = carry
        else:
            ctx, x, temb, cos, sin = carry
            ip_tokens = ip_scale = None
        ctx, x = JointTransformerBlock(
            dim=self.config.inner_dim,
            num_heads=self.config.num_attention_heads,
            head_dim=self.config.attention_head_dim,
            mlp_ratio=self.config.mlp_ratio,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            ip_adapter=self.ip_adapter,
            name="block",
        )(x, ctx, temb, cos, sin, ip_tokens, ip_scale)
        # diffusers adds the ControlNet residual to the block's OUTPUT
        # (after-block injection: `hidden_states = hidden_states +
        # controlnet_block_samples[index_block // interval]` in
        # FluxTransformer2DModel.forward, invoked at
        # RepText/pipeline_flux_controlnet.py:1092-1104). ``raw`` is the
        # UNSPREAD stack tuple (broadcast into the scan); ``idx`` the
        # per-layer source indices — index-on-read instead of a
        # materialized [num_layers, B, S, D] spread temp (see
        # _spread_residuals note).
        if raw is not None:
            x = x + _read_inject(raw, idx).astype(x.dtype)
        if self.ip_adapter:
            return (ctx, x, temb, cos, sin, ip_tokens, ip_scale), None
        return (ctx, x, temb, cos, sin), None


class _SingleLayer(nn.Module):
    config: FluxConfig
    txt_len: int
    attention_backend: Optional[str]
    dtype: Dtype
    param_dtype: Dtype

    @nn.compact
    def __call__(self, carry, idx, raw):
        x, temb, cos, sin = carry
        x = SingleTransformerBlock(
            dim=self.config.inner_dim,
            num_heads=self.config.num_attention_heads,
            head_dim=self.config.attention_head_dim,
            mlp_ratio=self.config.mlp_ratio,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            txt_len=self.txt_len,
            name="block",
        )(x, temb, cos, sin)
        # after-block injection into the image-token slice, matching
        # diffusers' single-stream residual add (see _DoubleLayer note);
        # index-on-read from the unspread stack tuple
        if raw is not None:
            x = x.at[:, self.txt_len:, :].add(
                _read_inject(raw, idx).astype(x.dtype))
        return (x, temb, cos, sin), None


def _spread_residuals(samples: jax.Array, num_layers: int) -> jax.Array:
    """Map [n, ...] ControlNet residuals onto [num_layers, ...] injection slots.

    diffusers indexes residuals as ``samples[i // ceil(L/n)]`` when the
    ControlNet is shallower than the base model; reproduced here as a static
    gather so the scan sees one stacked array.

    NOTE: the base model no longer materializes this gather — spreading a
    10-layer CN single stack to 38 base slots is a 912MB HLO temp at 1024^2
    that lives across the whole scan (measured: it tipped the full-geometry
    velocity-cache program 8.4MB past HBM). The layer scans index the RAW
    stack per layer instead (_inject_index + lax.dynamic_index_in_dim).
    Kept for the multi-ControlNet combiner, whose summed output is
    base-depth by construction.
    """
    n = samples.shape[0]
    if n == num_layers:
        return samples
    interval = int(math.ceil(num_layers / n))
    idx = jnp.asarray([min(i // interval, n - 1) for i in range(num_layers)])
    return samples[idx]


def _as_stack_tuple(samples) -> Optional[Tuple[jax.Array, ...]]:
    """Residual stacks arg -> tuple of stacks (callers may pass one array or
    a tuple/list of differently-deep stacks, e.g. dual-CN inpaint)."""
    if samples is None:
        return None
    if isinstance(samples, (tuple, list)):
        return tuple(samples)
    return (samples,)


def _inject_index(n: int, num_layers: int) -> jax.Array:
    """Per-base-layer source index into an [n, ...] residual stack
    (diffusers' ceil-interval mapping, as data instead of a gather)."""
    interval = int(math.ceil(num_layers / n))
    return jnp.asarray(
        [min(i // interval, n - 1) for i in range(num_layers)], jnp.int32)


def _read_inject(raw, idx):
    """Sum the per-layer residual from each raw stack (index-on-read)."""
    add = None
    for j, stack in enumerate(raw):
        r = jax.lax.dynamic_index_in_dim(stack, idx[j], 0, keepdims=False)
        add = r if add is None else add + r
    return add


class FluxTransformer2D(nn.Module):
    """The base FLUX diffusion transformer.

    Call signature mirrors the reference model surface
    (RepText/pipeline_flux_controlnet.py:1092-1104): packed latents, T5 context,
    CLIP pooled projection, sigma-timestep, RoPE ids, optional guidance, and
    optional ControlNet residual stacks.
    """

    config: FluxConfig
    attention_backend: Optional[str] = None
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # rematerialize block activations in the backward pass (training memory;
    # the reference ControlNet's gradient checkpointing equivalent,
    # RepText/controlnet_flux.py:321-340)
    remat: bool = False
    # IP-Adapter image-prompt support: every double block gains to_k_ip /
    # to_v_ip projections (nn/blocks.py JointTransformerBlock.ip_adapter).
    # Single blocks are untouched (diffusers FLUX IP-Adapter behavior;
    # reference compatibility claim: RepText/README.md:183).
    ip_adapter: bool = False
    # fp8 weight-only storage (io/quantize.py): apply with params whose block
    # stacks hold kernel_q8/kernel_scale pairs; each scan iteration
    # dequantizes ONE layer slice to bf16 (nn.map_variables inside the scan),
    # so full FLUX.1-dev's 24 GB of bf16 weights are stored in 12 GB.
    # Apply-time only: init() with weight_quant=False, then
    # io.quantize.quantize_params.
    weight_quant: bool = False

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,            # [B, S_img, in_channels]
        encoder_hidden_states: jax.Array,    # [B, S_txt, joint_attention_dim]
        pooled_projections: jax.Array,       # [B, pooled_projection_dim]
        timestep: jax.Array,                 # [B] in [0, 1]
        img_ids: jax.Array,                  # [S_img, 3]
        txt_ids: jax.Array,                  # [S_txt, 3]
        guidance: Optional[jax.Array] = None,          # [B]
        controlnet_block_samples: Optional[jax.Array] = None,         # [n, B, S_img, D]
        controlnet_single_block_samples: Optional[jax.Array] = None,  # [n, B, S_img, D]
        ip_tokens: Optional[jax.Array] = None,   # [B, N_ip, cross_dim]
        ip_scale: Optional[jax.Array] = None,    # scalar
    ) -> jax.Array:
        cfg = self.config
        dense = lambda feat, name: nn.Dense(  # noqa: E731
            feat, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )

        x = dense(cfg.inner_dim, "x_embedder")(hidden_states)
        temb = CombinedTimestepTextEmbed(
            inner_dim=cfg.inner_dim,
            time_embed_dim=cfg.time_embed_dim,
            guidance_embeds=cfg.guidance_embeds,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="time_text_embed",
        )(timestep, pooled_projections, guidance)
        ctx = dense(cfg.inner_dim, "context_embedder")(encoder_hidden_states)

        ids = jnp.concatenate([txt_ids, img_ids], axis=0)
        cos, sin = rope_cos_sin_half(ids, cfg.axes_dims_rope, cfg.rope_theta)

        double_stacks = _as_stack_tuple(controlnet_block_samples)
        double_idx = None if double_stacks is None else tuple(
            _inject_index(s.shape[0], cfg.num_layers) for s in double_stacks)
        single_stacks = _as_stack_tuple(controlnet_single_block_samples)
        single_idx = None if single_stacks is None else tuple(
            _inject_index(s.shape[0], cfg.num_single_layers)
            for s in single_stacks)

        double_layer = nn.remat(_DoubleLayer, prevent_cse=False) if self.remat else _DoubleLayer
        if self.weight_quant:
            double_layer = nn.map_variables(
                double_layer, "params", trans_in_fn=dequantize_collection
            )
        DoubleScan = nn.scan(
            double_layer,
            variable_axes={"params": 0, "intermediates": 0},
            split_rngs={"params": True},
            length=cfg.num_layers,
            in_axes=(0, nn.broadcast),   # (per-layer idx, unspread stacks)
            out_axes=0,
        )
        if self.ip_adapter:
            if ip_tokens is None:
                raise ValueError("ip_adapter model requires ip_tokens")
            scale = jnp.asarray(1.0 if ip_scale is None else ip_scale, jnp.float32)
            double_carry = (ctx, x, temb, cos, sin,
                            ip_tokens.astype(self.dtype), scale)
        else:
            double_carry = (ctx, x, temb, cos, sin)
        double_carry, _ = DoubleScan(
            config=cfg,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            ip_adapter=self.ip_adapter,
            name="double_blocks",
        )(double_carry, double_idx, double_stacks)
        ctx, x = double_carry[0], double_carry[1]

        joint = jnp.concatenate([ctx, x], axis=1)
        txt_len = encoder_hidden_states.shape[1]

        single_layer = nn.remat(_SingleLayer, prevent_cse=False) if self.remat else _SingleLayer
        if self.weight_quant:
            single_layer = nn.map_variables(
                single_layer, "params", trans_in_fn=dequantize_collection
            )
        SingleScan = nn.scan(
            single_layer,
            variable_axes={"params": 0, "intermediates": 0},
            split_rngs={"params": True},
            length=cfg.num_single_layers,
            in_axes=(0, nn.broadcast),   # (per-layer idx, unspread stacks)
            out_axes=0,
        )
        (joint, _, _, _), _ = SingleScan(
            config=cfg,
            txt_len=txt_len,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="single_blocks",
        )((joint, temb, cos, sin), single_idx, single_stacks)

        x = joint[:, txt_len:, :]
        x = AdaLayerNormContinuous(
            cfg.inner_dim, dtype=self.dtype, param_dtype=self.param_dtype, name="norm_out"
        )(x, temb)
        return dense(cfg.out_channels, "proj_out")(x)
