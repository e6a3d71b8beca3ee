"""T5 (v1.1 gated-gelu) encoder stack — source of FLUX sequence prompt embeddings.

The reference loads T5-XXL from transformers (`T5EncoderModel`, imported at
RepText/pipeline_flux_controlnet.py:8; sequence embeds built at :232-305).
Reimplemented: T5LayerNorm (no mean subtraction), unscaled attention with
bucketed relative position bias computed once and shared across layers, and
gated-gelu feedforward.
"""

from __future__ import annotations

from typing import Any

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.configs import T5Config

Dtype = Any


class T5LayerNorm(nn.Module):
    """RMS-style norm without mean subtraction or bias, fp32 accumulation."""

    dim: int
    eps: float = 1e-6
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        weight = self.param("weight", nn.initializers.ones, (self.dim,), self.param_dtype)
        xf = x.astype(jnp.float32)
        var = jnp.mean(xf * xf, axis=-1, keepdims=True)
        return (xf * jax.lax.rsqrt(var + self.eps)).astype(x.dtype) * weight.astype(x.dtype)


def relative_position_bucket(
    relative_position: jax.Array,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> jax.Array:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(jnp.int32) * num_buckets
    n = jnp.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        jnp.log(n.astype(jnp.float32) / max_exact + 1e-6)
        / jnp.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(jnp.int32)
    val_if_large = jnp.minimum(val_if_large, num_buckets - 1)
    return ret + jnp.where(is_small, n, val_if_large)


class T5EncoderLayer(nn.Module):
    config: T5Config
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, position_bias: jax.Array) -> jax.Array:
        cfg = self.config
        inner = cfg.num_heads * cfg.d_kv
        dense = lambda feat, name: nn.Dense(  # noqa: E731
            feat, use_bias=False, dtype=self.dtype, param_dtype=self.param_dtype,
            name=name,
        )

        # Self-attention block (unscaled q, additive relative bias)
        residual = x
        h = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, self.param_dtype,
                        name="attn_layer_norm")(x)
        b, s, _ = h.shape
        heads = lambda t: t.reshape(b, s, cfg.num_heads, cfg.d_kv).transpose(0, 2, 1, 3)  # noqa: E731
        q, k, v = heads(dense(inner, "q")(h)), heads(dense(inner, "k")(h)), heads(dense(inner, "v")(h))
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
        logits = logits + position_bias
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        attn = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        attn = attn.transpose(0, 2, 1, 3).reshape(b, s, inner)
        x = residual + dense(cfg.d_model, "o")(attn)

        # Gated-gelu feedforward
        residual = x
        h = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, self.param_dtype,
                        name="ff_layer_norm")(x)
        gate = nn.gelu(dense(cfg.d_ff, "wi_0")(h), approximate=True)
        h = gate * dense(cfg.d_ff, "wi_1")(h)
        return residual + dense(cfg.d_model, "wo")(h)


class T5Encoder(nn.Module):
    """input_ids [B, S] -> last hidden states [B, S, d_model]."""

    config: T5Config
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, input_ids: jax.Array) -> jax.Array:
        cfg = self.config
        x = nn.Embed(
            cfg.vocab_size, cfg.d_model, dtype=self.dtype,
            param_dtype=self.param_dtype, name="shared",
        )(input_ids)

        s = input_ids.shape[1]
        ctx = jnp.arange(s)[:, None]
        mem = jnp.arange(s)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        )
        bias_table = nn.Embed(
            cfg.relative_attention_num_buckets, cfg.num_heads, dtype=jnp.float32,
            param_dtype=self.param_dtype, name="relative_attention_bias",
        )(buckets)                                      # [S, S, H]
        position_bias = bias_table.transpose(2, 0, 1)[None]  # [1, H, S, S]

        for i in range(cfg.num_layers):
            x = T5EncoderLayer(cfg, self.dtype, self.param_dtype, name=f"layer_{i}")(
                x, position_bias
            )

        return T5LayerNorm(
            cfg.d_model, cfg.layer_norm_epsilon, self.param_dtype, name="final_layer_norm"
        )(x)
