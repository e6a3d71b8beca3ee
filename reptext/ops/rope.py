"""3-axis rotary position embeddings (FLUX-style interleaved RoPE).

Semantics match the reference's FluxPosEmbed (theta=10000, axes_dim=(16,56,56),
RepText/controlnet_flux.py:56,65) and diffusers' ``apply_rotary_emb`` with
``use_real=True, use_real_unbind_dim=-1``: per axis a, frequencies
``1/theta^(2i/d_a)``, each cos/sin value repeated twice (interleaved pairs), and
rotation acting on adjacent element pairs (x0, x1) -> (x0*c - x1*s, x1*c + x0*s).

Angles are always computed in float32; application casts back to input dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def rope_cos_sin(
    ids: jax.Array,
    axes_dim: Sequence[int],
    theta: int = 10000,
) -> Tuple[jax.Array, jax.Array]:
    """Compute interleaved cos/sin tables from multi-axis position ids.

    Args:
      ids: [S, n_axes] float position ids (text ids all-zero, image ids
        (0, row, col)).
      axes_dim: per-axis rotary dims, summing to the attention head dim.
      theta: rotary base.

    Returns:
      (cos, sin), each [S, sum(axes_dim)] float32, with every frequency value
      repeated twice consecutively (matching torch repeat_interleave(2, -1)).
    """
    ids = ids.astype(jnp.float32)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (jnp.arange(0, dim, 2, dtype=jnp.float32) / dim))
        angles = ids[:, axis:axis + 1] * freqs[None, :]  # [S, dim/2]
        cos = jnp.repeat(jnp.cos(angles), 2, axis=-1)    # [S, dim]
        sin = jnp.repeat(jnp.sin(angles), 2, axis=-1)
        cos_parts.append(cos)
        sin_parts.append(sin)
    return jnp.concatenate(cos_parts, axis=-1), jnp.concatenate(sin_parts, axis=-1)


def _rotate_half_interleaved(x: jax.Array) -> jax.Array:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = jnp.stack([-x2[..., 1], x2[..., 0]], axis=-1)
    return rot.reshape(x.shape)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Apply interleaved rotary embedding.

    Args:
      x: [..., S, D] query or key (any leading batch/head dims).
      cos/sin: [S, D] tables from :func:`rope_cos_sin`.
    """
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32)
    out = xf * cos + _rotate_half_interleaved(xf) * sin
    return out.astype(orig_dtype)


# --------------------------------------------------------------------------
# Half-split layout — the framework-native q/k channel order.
#
# Interleaved pair rotation touches adjacent elements (x0,x1), a strided
# shuffle that fuses worse than two contiguous halves. Since
# attention logits are invariant under any fixed permutation applied to BOTH
# q and k head channels, the deinterleave permutation (even channels first,
# odd channels second: pair (2j, 2j+1) -> (j, j+D/2)) is folded into the
# q/k projection weights at checkpoint conversion (io/convert.py::_lin_rope),
# making rotate-half a contiguous half swap: (x_lo, x_hi) -> (-x_hi, x_lo).
# This is the GPT-NeoX layout; the reference's diffusers apply_rotary_emb
# (use_real_unbind_dim=-1) is the interleaved GPT-J layout.
# --------------------------------------------------------------------------


def deinterleave_perm(d: int) -> jax.Array:
    """Channel permutation taking interleaved pair layout to half-split."""
    import numpy as np

    return jnp.asarray(
        np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    )


def rope_cos_sin_half(
    ids: jax.Array,
    axes_dim: Sequence[int],
    theta: int = 10000,
) -> Tuple[jax.Array, jax.Array]:
    """Half-split cos/sin tables: per-pair values duplicated in both halves.

    Row j and row j + D/2 hold the angle of global pair j, so the half-split
    rotation ``x*cos + (-x_hi ++ x_lo)*sin`` equals the interleaved rotation
    after the :func:`deinterleave_perm` channel permutation of x.
    """
    ids = ids.astype(jnp.float32)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (jnp.arange(0, dim, 2, dtype=jnp.float32) / dim))
        angles = ids[:, axis:axis + 1] * freqs[None, :]  # [S, dim/2]
        cos_parts.append(jnp.cos(angles))
        sin_parts.append(jnp.sin(angles))
    cos_p = jnp.concatenate(cos_parts, axis=-1)  # [S, D/2] per-pair
    sin_p = jnp.concatenate(sin_parts, axis=-1)
    return (
        jnp.concatenate([cos_p, cos_p], axis=-1),
        jnp.concatenate([sin_p, sin_p], axis=-1),
    )


def apply_rope_half(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Apply half-split rotary embedding (fp32 math, cast back).

    Args:
      x: [..., S, D] query or key in half-split channel order.
      cos/sin: [S, D] tables from :func:`rope_cos_sin_half`.
    """
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32)
    d2 = x.shape[-1] // 2
    rot = jnp.concatenate([-xf[..., d2:], xf[..., :d2]], axis=-1)
    return (xf * cos + rot * sin).astype(orig_dtype)
