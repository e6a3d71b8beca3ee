"""RoPE cos/sin construction + application tests.

Checks the interleaved-pair convention (diffusers apply_rotary_emb with
use_real_unbind_dim=-1) against an explicit complex-rotation reference.
"""

import jax.numpy as jnp
import numpy as np

from reptext.ops import rope_cos_sin, apply_rope


def reference_rope(ids, axes_dim, theta, x):
    """Complex-number reference: each adjacent pair rotated by angle pos*freq."""
    s, d = x.shape[-2], x.shape[-1]
    angles = []
    for axis, dim in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
        angles.append(ids[:, axis:axis + 1] * freqs[None, :])  # [S, dim/2]
    ang = np.concatenate(angles, axis=-1)  # [S, D/2]
    xr = x[..., 0::2]
    xi = x[..., 1::2]
    zr = xr * np.cos(ang) - xi * np.sin(ang)
    zi = xr * np.sin(ang) + xi * np.cos(ang)
    out = np.empty_like(x)
    out[..., 0::2] = zr
    out[..., 1::2] = zi
    return out


def test_rope_tables_shapes():
    ids = jnp.zeros((10, 3))
    cos, sin = rope_cos_sin(ids, (16, 56, 56))
    assert cos.shape == (10, 128) and sin.shape == (10, 128)
    # zero positions: identity rotation
    np.testing.assert_allclose(np.asarray(cos), 1.0)
    np.testing.assert_allclose(np.asarray(sin), 0.0)


def test_rope_matches_complex_reference():
    rng = np.random.default_rng(2)
    axes = (4, 6, 6)
    ids = rng.integers(0, 32, size=(12, 3)).astype(np.float32)
    x = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)  # B,H,S,D
    cos, sin = rope_cos_sin(jnp.asarray(ids), axes, theta=10000)
    got = np.asarray(apply_rope(jnp.asarray(x), cos, sin))
    want = reference_rope(ids, axes, 10000, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rope_preserves_norm():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, size=(8, 3)).astype(np.float32)
    x = rng.standard_normal((1, 2, 8, 32)).astype(np.float32)
    cos, sin = rope_cos_sin(jnp.asarray(ids), (8, 12, 12))
    y = np.asarray(apply_rope(jnp.asarray(x), cos, sin))
    np.testing.assert_allclose(
        np.linalg.norm(y, axis=-1), np.linalg.norm(x, axis=-1), rtol=1e-5
    )


def test_half_layout_equivalence():
    """Half-split rotation == interleaved rotation under the deinterleave
    channel permutation (the identity io/convert.py::_lin_rope relies on)."""
    from reptext.ops.rope import (
        apply_rope_half,
        deinterleave_perm,
        rope_cos_sin_half,
    )

    r = np.random.default_rng(0)
    ids = np.zeros((10, 3), np.float32)
    ids[4:, 1] = np.arange(6)
    ids[4:, 2] = np.arange(6)[::-1]
    axes = (8, 12, 12)
    x = jnp.asarray(r.standard_normal((2, 3, 10, 32)), jnp.float32)

    cos, sin = rope_cos_sin(jnp.asarray(ids), axes)
    cos_h, sin_h = rope_cos_sin_half(jnp.asarray(ids), axes)
    perm = deinterleave_perm(32)

    want = np.asarray(apply_rope(x, cos, sin))[..., perm]
    got = np.asarray(apply_rope_half(x[..., perm], cos_h, sin_h))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_half_inverse_rotation():
    """apply_rope_half(., cos, -sin) inverts apply_rope_half(., cos, sin)
    (the adjoint identity the fused-kernel backward uses)."""
    from reptext.ops.rope import apply_rope_half, rope_cos_sin_half

    r = np.random.default_rng(1)
    ids = np.asarray(r.integers(0, 7, (6, 3)), np.float32)
    cos_h, sin_h = rope_cos_sin_half(jnp.asarray(ids), (4, 6, 6))
    x = jnp.asarray(r.standard_normal((1, 2, 6, 16)), jnp.float32)
    y = apply_rope_half(x, cos_h, sin_h)
    back = apply_rope_half(y, cos_h, -sin_h)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), rtol=1e-5, atol=1e-6)
