"""CLIP-L/14 text encoder — source of FLUX pooled prompt embeddings.

The reference loads this from transformers (`CLIPTextModel`, imported at
RepText/pipeline_flux_controlnet.py:8; pooled embedding extracted at :308-347).
Reimplemented here: causal transformer with quick-gelu MLPs, final LayerNorm,
and the pooled output taken at the EOS position (argmax of token ids, the
CLIPTextModel convention for vocab where EOS is the max id).
"""

from __future__ import annotations

from typing import Any, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.configs import CLIPConfig

Dtype = Any


def quick_gelu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(1.702 * x)


class CLIPEncoderLayer(nn.Module):
    config: CLIPConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, causal_mask: jax.Array) -> jax.Array:
        cfg = self.config
        head_dim = cfg.hidden_size // cfg.num_heads
        dense = lambda feat, name: nn.Dense(  # noqa: E731
            feat, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        ln = lambda name: nn.LayerNorm(  # noqa: E731
            epsilon=cfg.layer_norm_eps, dtype=jnp.float32,
            param_dtype=self.param_dtype, name=name,
        )

        residual = x
        h = ln("layer_norm1")(x.astype(jnp.float32)).astype(x.dtype)
        b, s, _ = h.shape
        shape_heads = lambda t: t.reshape(b, s, cfg.num_heads, head_dim).transpose(0, 2, 1, 3)  # noqa: E731
        q = shape_heads(dense(cfg.hidden_size, "q_proj")(h)) * (head_dim ** -0.5)
        k = shape_heads(dense(cfg.hidden_size, "k_proj")(h))
        v = shape_heads(dense(cfg.hidden_size, "v_proj")(h))
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
        logits = jnp.where(causal_mask, logits, -jnp.inf)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        attn = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        attn = attn.transpose(0, 2, 1, 3).reshape(b, s, cfg.hidden_size)
        x = residual + dense(cfg.hidden_size, "out_proj")(attn)

        residual = x
        h = ln("layer_norm2")(x.astype(jnp.float32)).astype(x.dtype)
        h = dense(cfg.intermediate_size, "fc1")(h)
        h = quick_gelu(h)
        x = residual + dense(cfg.hidden_size, "fc2")(h)
        return x


class CLIPTextEncoder(nn.Module):
    """Returns (last_hidden_state, pooled_output)."""

    config: CLIPConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, input_ids: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.config
        b, s = input_ids.shape
        if s > cfg.max_position_embeddings:
            # out-of-range nn.Embed lookups FILL with NaN (jnp.take default),
            # which surfaces far downstream as NaN latents — fail loudly at
            # the boundary instead (tokenize to the config length, see
            # cli._tokenize)
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings} for this CLIPConfig")
        tok = nn.Embed(
            cfg.vocab_size, cfg.hidden_size, dtype=self.dtype,
            param_dtype=self.param_dtype, name="token_embedding",
        )(input_ids)
        pos = nn.Embed(
            cfg.max_position_embeddings, cfg.hidden_size, dtype=self.dtype,
            param_dtype=self.param_dtype, name="position_embedding",
        )(jnp.arange(s)[None, :])
        x = tok + pos

        causal = jnp.tril(jnp.ones((s, s), dtype=bool))[None, None]
        for i in range(cfg.num_layers):
            x = CLIPEncoderLayer(
                cfg, self.dtype, self.param_dtype, name=f"layer_{i}"
            )(x, causal)

        x = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=jnp.float32,
            param_dtype=self.param_dtype, name="final_layer_norm",
        )(x.astype(jnp.float32)).astype(x.dtype)

        # pooled = hidden state at the EOS token (max token id position)
        eos_idx = jnp.argmax(input_ids, axis=-1)
        pooled = x[jnp.arange(b), eos_idx]
        return x, pooled
