"""Normalization, modulation, and MLP building blocks (nn/module.py).

Layer semantics follow the FLUX MMDiT design the reference builds on (its block
classes are imported from diffusers, RepText/controlnet_flux.py:29): AdaLN-Zero
modulation from the combined time/text embedding, per-head RMS query/key norm,
and gelu-tanh feedforwards. Norms and modulation math run in float32 and cast
back to the compute dtype (bf16 on the GPU).
"""

from __future__ import annotations

from typing import Any, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

Dtype = Any


class RMSNorm(nn.Module):
    """RMS normalization with a learned scale (used for per-head q/k norm)."""

    dim: int
    eps: float = 1e-6
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        weight = self.param("weight", nn.initializers.ones, (self.dim,), self.param_dtype)
        xf = x.astype(jnp.float32)
        var = jnp.mean(xf * xf, axis=-1, keepdims=True)
        normed = xf * jax.lax.rsqrt(var + self.eps)
        return (normed * weight.astype(jnp.float32)).astype(x.dtype)


def layer_norm_no_affine(x: jax.Array, eps: float = 1e-6) -> jax.Array:
    """LayerNorm without learnable affine, computed in float32."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


class AdaLayerNormZero(nn.Module):
    """AdaLN-Zero: temb -> 6 modulation vectors (msa/mlp shift, scale, gate)."""

    dim: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, x: jax.Array, temb: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
        emb = nn.Dense(
            6 * self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="linear"
        )(nn.silu(temb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = jnp.split(
            emb, 6, axis=-1
        )
        normed = layer_norm_no_affine(x)
        out = normed * (1.0 + scale_msa[:, None, :]) + shift_msa[:, None, :]
        return out.astype(x.dtype), gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """Single-stream AdaLN: temb -> (shift, scale, gate)."""

    dim: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, temb: jax.Array) -> Tuple[jax.Array, jax.Array]:
        emb = nn.Dense(
            3 * self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="linear"
        )(nn.silu(temb))
        shift_msa, scale_msa, gate_msa = jnp.split(emb, 3, axis=-1)
        normed = layer_norm_no_affine(x)
        out = normed * (1.0 + scale_msa[:, None, :]) + shift_msa[:, None, :]
        return out.astype(x.dtype), gate_msa


class AdaLayerNormContinuous(nn.Module):
    """Output norm: temb -> (scale, shift); x -> LN(x)*(1+scale)+shift."""

    dim: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, temb: jax.Array) -> jax.Array:
        emb = nn.Dense(
            2 * self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="linear"
        )(nn.silu(temb))
        scale, shift = jnp.split(emb, 2, axis=-1)
        normed = layer_norm_no_affine(x)
        return (normed * (1.0 + scale[:, None, :]) + shift[:, None, :]).astype(x.dtype)


def gelu_tanh(x: jax.Array) -> jax.Array:
    return nn.gelu(x, approximate=True)


class FeedForward(nn.Module):
    """dim -> mult*dim -> dim with gelu-tanh (FLUX feedforward)."""

    dim: int
    mult: float = 4.0
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        inner = int(self.dim * self.mult)
        h = nn.Dense(inner, dtype=self.dtype, param_dtype=self.param_dtype, name="in_proj")(x)
        h = gelu_tanh(h)
        return nn.Dense(self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="out_proj")(h)
