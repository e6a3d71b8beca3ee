"""Timestep / guidance / pooled-text embeddings for FLUX conditioning.

Semantics mirror the combined time-text(-guidance) embedding the reference's
ControlNet instantiates (RepText/controlnet_flux.py:66-71): sinusoidal timestep
features (cos-first, 256-dim, max period 10000) through a 2-layer silu MLP,
optional guidance embedding likewise, plus pooled CLIP projection; all summed
into one modulation vector. Timestep and guidance values are multiplied by 1000
inside the model (RepText/controlnet_flux.py:282).
"""

from __future__ import annotations

from typing import Any

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

Dtype = Any


def timestep_embedding(
    t: jax.Array, dim: int, max_period: float = 10000.0
) -> jax.Array:
    """Sinusoidal features [B] -> [B, dim], cos-first (flip_sin_to_cos=True).

    Computed in float32 regardless of input dtype.
    """
    half = dim // 2
    t = t.astype(jnp.float32)
    freqs = jnp.exp(-jnp.log(max_period) * jnp.arange(half, dtype=jnp.float32) / half)
    args = t[:, None] * freqs[None, :]
    emb = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
    if dim % 2 == 1:
        emb = jnp.pad(emb, ((0, 0), (0, 1)))
    return emb


class MLPEmbedder(nn.Module):
    """2-layer silu MLP: in -> hidden (silu) -> hidden."""

    hidden_dim: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        h = nn.Dense(
            self.hidden_dim, dtype=self.dtype, param_dtype=self.param_dtype, name="linear_1"
        )(x)
        h = nn.silu(h)
        return nn.Dense(
            self.hidden_dim, dtype=self.dtype, param_dtype=self.param_dtype, name="linear_2"
        )(h)


class CombinedTimestepTextEmbed(nn.Module):
    """temb = MLP(sin(t*1000)) [+ MLP(sin(g*1000))] + MLP(pooled_text).

    ``guidance`` may be None when the config has no guidance embedding
    (e.g. FLUX.1-schnell-style checkpoints).
    """

    inner_dim: int
    time_embed_dim: int = 256
    guidance_embeds: bool = True
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        timestep: jax.Array,       # [B], in [0, 1] (sigma units)
        pooled_text: jax.Array,    # [B, pooled_dim]
        guidance: jax.Array = None,  # [B] guidance scale, or None
    ) -> jax.Array:
        t_feat = timestep_embedding(timestep * 1000.0, self.time_embed_dim)
        temb = MLPEmbedder(
            self.inner_dim, dtype=self.dtype, param_dtype=self.param_dtype,
            name="timestep_embedder",
        )(t_feat.astype(self.dtype))
        if self.guidance_embeds:
            if guidance is None:
                raise ValueError("config.guidance_embeds=True requires a guidance array")
            g_feat = timestep_embedding(guidance * 1000.0, self.time_embed_dim)
            temb = temb + MLPEmbedder(
                self.inner_dim, dtype=self.dtype, param_dtype=self.param_dtype,
                name="guidance_embedder",
            )(g_feat.astype(self.dtype))
        temb = temb + MLPEmbedder(
            self.inner_dim, dtype=self.dtype, param_dtype=self.param_dtype,
            name="text_embedder",
        )(pooled_text.astype(self.dtype))
        return temb
