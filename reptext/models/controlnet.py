"""RepText FLUX ControlNet (scan-over-layers).

Rebuild of the reference's ControlNet (RepText/controlnet_flux.py:
41-413): embeds packed latents plus a packed conditioning tensor through a
zero-initialised embedder, runs trimmed double-/single-stream MMDiT stacks, and
emits one zero-initialised linear residual per block for injection into the
base transformer. Differences from the reference implementation (not semantics):

- Blocks and their residual projections are scanned with stacked params — the
  per-layer Python loop collecting ``block_samples``
  (RepText/controlnet_flux.py:319-381) becomes scan outputs.
- Multi-line conditioning is intended to be batched (lines stacked on the batch
  axis) rather than looped (reference loops per line per step,
  RepText/pipeline_flux_controlnet.py:1037); see the sampler.

Conditioning-scale multiply (reference :394-396) is applied here; union-mode
token prepend (:294-301) is supported via ``mode``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.configs import ControlNetConfig
from reptext.io.quantize import dequantize_collection
from reptext.nn.blocks import JointTransformerBlock, SingleTransformerBlock
from reptext.nn.embeddings import CombinedTimestepTextEmbed
from reptext.ops.rope import rope_cos_sin_half

Dtype = Any


class _ControlDoubleLayer(nn.Module):
    config: ControlNetConfig
    attention_backend: Optional[str]
    dtype: Dtype
    param_dtype: Dtype

    @nn.compact
    def __call__(self, carry, _):
        ctx, x, temb, cos, sin = carry
        ctx, x = JointTransformerBlock(
            dim=self.config.inner_dim,
            num_heads=self.config.num_attention_heads,
            head_dim=self.config.attention_head_dim,
            mlp_ratio=self.config.mlp_ratio,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="block",
        )(x, ctx, temb, cos, sin)
        # zero-init residual head (reference: controlnet_blocks, zero_module)
        sample = nn.Dense(
            self.config.inner_dim,
            kernel_init=nn.initializers.zeros,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="proj",
        )(x)
        return (ctx, x, temb, cos, sin), sample


class _ControlSingleLayer(nn.Module):
    config: ControlNetConfig
    txt_len: int
    attention_backend: Optional[str]
    dtype: Dtype
    param_dtype: Dtype

    @nn.compact
    def __call__(self, carry, _):
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
        # residual over the image-token slice only (reference :377-381)
        sample = nn.Dense(
            self.config.inner_dim,
            kernel_init=nn.initializers.zeros,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="proj",
        )(x[:, self.txt_len:, :])
        return (x, temb, cos, sin), sample


class RepTextControlNet(nn.Module):
    """FLUX-architecture ControlNet emitting per-block injection residuals."""

    config: ControlNetConfig
    attention_backend: Optional[str] = None
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # gradient checkpointing (reference: RepText/controlnet_flux.py:321-340)
    remat: bool = False
    # fp8 weight-only storage of the block stacks (io/quantize.py; see
    # models/flux.py FluxTransformer2D.weight_quant). Apply-time only.
    weight_quant: bool = False

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,            # [B, S_img, in_channels] packed latents
        controlnet_cond: jax.Array,          # [B, S_img, in+extra] packed conditioning
        encoder_hidden_states: jax.Array,    # [B, S_txt, joint_attention_dim]
        pooled_projections: jax.Array,       # [B, pooled_projection_dim]
        timestep: jax.Array,                 # [B] in [0, 1]
        img_ids: jax.Array,                  # [S_img, 3]
        txt_ids: jax.Array,                  # [S_txt, 3]
        guidance: Optional[jax.Array] = None,
        conditioning_scale: float | jax.Array = 1.0,
        mode: Optional[jax.Array] = None,    # [B] int mode index (union only)
    ) -> Tuple[jax.Array, jax.Array]:
        """Returns (block_samples [L,B,S_img,D], single_block_samples [L1,B,S_img,D])."""
        cfg = self.config
        dense = lambda feat, name, **kw: nn.Dense(  # noqa: E731
            feat, dtype=self.dtype, param_dtype=self.param_dtype, name=name, **kw
        )

        x = dense(cfg.inner_dim, "x_embedder")(hidden_states)
        # zero-init conditioning embedder: at init the ControlNet is a no-op
        # (reference: RepText/controlnet_flux.py:112-114,277-280)
        x = x + dense(
            cfg.inner_dim, "controlnet_x_embedder", kernel_init=nn.initializers.zeros
        )(controlnet_cond)

        temb = CombinedTimestepTextEmbed(
            inner_dim=cfg.inner_dim,
            time_embed_dim=cfg.time_embed_dim,
            guidance_embeds=cfg.guidance_embeds,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="time_text_embed",
        )(timestep, pooled_projections, guidance)
        ctx = dense(cfg.inner_dim, "context_embedder")(encoder_hidden_states)

        if cfg.union:
            if mode is None:
                raise ValueError("union-mode ControlNet requires a `mode` index array")
            mode_tok = nn.Embed(
                cfg.num_mode, cfg.inner_dim, dtype=self.dtype,
                param_dtype=self.param_dtype, name="controlnet_mode_embedder",
            )(mode.reshape(-1, 1))                       # [B, 1, D]
            ctx = jnp.concatenate([mode_tok, ctx], axis=1)
            txt_ids = jnp.concatenate([txt_ids[:1], txt_ids], axis=0)

        ids = jnp.concatenate([txt_ids, img_ids], axis=0)
        cos, sin = rope_cos_sin_half(ids, cfg.axes_dims_rope, cfg.rope_theta)

        double_layer = (nn.remat(_ControlDoubleLayer, prevent_cse=False)
                        if self.remat else _ControlDoubleLayer)
        if self.weight_quant:
            double_layer = nn.map_variables(
                double_layer, "params", trans_in_fn=dequantize_collection
            )
        DoubleScan = nn.scan(
            double_layer,
            variable_axes={"params": 0, "intermediates": 0},
            split_rngs={"params": True},
            length=cfg.num_layers,
            in_axes=0,
            out_axes=0,
        )
        (ctx, x, _, _, _), block_samples = DoubleScan(
            config=cfg,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="double_blocks",
        )((ctx, x, temb, cos, sin), None)

        joint = jnp.concatenate([ctx, x], axis=1)
        txt_len = ctx.shape[1]

        single_layer = (nn.remat(_ControlSingleLayer, prevent_cse=False)
                        if self.remat else _ControlSingleLayer)
        if self.weight_quant:
            single_layer = nn.map_variables(
                single_layer, "params", trans_in_fn=dequantize_collection
            )
        SingleScan = nn.scan(
            single_layer,
            variable_axes={"params": 0, "intermediates": 0},
            split_rngs={"params": True},
            length=cfg.num_single_layers,
            in_axes=0,
            out_axes=0,
        )
        (joint, _, _, _), single_block_samples = SingleScan(
            config=cfg,
            txt_len=txt_len,
            attention_backend=self.attention_backend,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="single_blocks",
        )((joint, temb, cos, sin), None)

        scale = jnp.asarray(conditioning_scale, dtype=block_samples.dtype)
        return block_samples * scale, single_block_samples * scale


def params_from_transformer(
    flux_params: Any,
    cn_params_template: Any,
    num_layers: int,
    num_single_layers: int,
) -> Any:
    """Initialize ControlNet params from base-transformer params (weight surgery).

    Reference: ``FluxControlNetModel.from_transformer``
    (RepText/controlnet_flux.py:182-214) — copy embedders and the first N
    double / M single blocks from the base model; the zero-initialised
    residual heads and conditioning embedder stay at zero (so the fresh
    ControlNet is a no-op until trained). With scanned params this is a
    leading-axis slice.

    Args:
      flux_params: base FluxTransformer2D param tree ({"params": ...}).
      cn_params_template: a freshly-initialised RepTextControlNet tree (gives
        the zero heads + controlnet_x_embedder and the exact structure).
      num_layers/num_single_layers: ControlNet depth (must be <= base depth).
    """
    import jax

    fp = flux_params["params"]
    base_layers = fp["double_blocks"]["block"]["to_q"]["kernel"].shape[0]
    base_singles = fp["single_blocks"]["block"]["to_q"]["kernel"].shape[0]
    if num_layers > base_layers or num_single_layers > base_singles:
        raise ValueError(
            f"ControlNet depth ({num_layers} double, {num_single_layers} single) "
            f"exceeds base transformer depth ({base_layers}, {base_singles})"
        )
    cn = jax.tree_util.tree_map(lambda x: x, cn_params_template)
    cp = cn["params"] if "params" in cn else cn

    for name in ("x_embedder", "context_embedder", "time_text_embed"):
        cp[name] = fp[name]

    def slice_layers(tree, n):
        return jax.tree_util.tree_map(lambda x: x[:n], tree)

    cp["double_blocks"]["block"] = slice_layers(
        fp["double_blocks"]["block"], num_layers
    )
    cp["single_blocks"]["block"] = slice_layers(
        fp["single_blocks"]["block"], num_single_layers
    )
    # buffers of its own: training donates the ControlNet's params to the
    # step, which must not free the frozen base's (or the template's)
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), cn)
