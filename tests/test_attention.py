"""Attention backends: the XLA reference and the cuDNN route's wrapper.

cuDNN itself runs only on the card (the ``gpu``-marked test, and phase 1 of
chip_smoke.py). Here the wrapper's layout handling is checked through
``jax.nn.dot_product_attention(implementation="xla")``, and the choice of
route through ``resolve_backend`` with the platform given explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.ops import attention as attn
from reptext.ops.attention import (
    attention, fused_attention, resolve_backend, xla_attention)
from reptext.ops.rope import apply_rope_half, rope_cos_sin_half


def _qkv(b=1, h=2, s=128, d=32, seed=0, dtype=jnp.float32):
    r = np.random.default_rng(seed)
    mk = lambda: jnp.asarray(r.standard_normal((b, h, s, d)), dtype)  # noqa: E731
    return mk(), mk(), mk()


def test_xla_attention_matches_naive_softmax():
    q, k, v = _qkv(s=16, d=8)
    out = np.asarray(xla_attention(q, k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", np.asarray(q), np.asarray(k)) / np.sqrt(8)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", probs, np.asarray(v))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,platform,dtype,want", [
    ("auto", "cpu", jnp.bfloat16, "xla"),
    ("auto", "gpu", jnp.bfloat16, "cudnn"),
    ("auto", "gpu", jnp.float16, "cudnn"),
    ("auto", "gpu", jnp.float32, "xla"),
    ("xla", "gpu", jnp.bfloat16, "xla"),
    ("cudnn", "gpu", jnp.bfloat16, "cudnn"),
])
def test_backend_choice_by_platform_and_dtype(backend, platform, dtype, want):
    assert resolve_backend(backend, dtype, platform) == want


@pytest.mark.parametrize("platform,dtype", [
    ("cpu", jnp.bfloat16), ("cpu", jnp.float16), ("gpu", jnp.float32)])
def test_forced_cudnn_where_it_cannot_run_raises(platform, dtype):
    with pytest.raises(ValueError, match="cudnn attention needs a GPU"):
        resolve_backend("cudnn", dtype, platform)


def test_forced_cudnn_on_this_host_raises_not_substitutes():
    q, k, v = _qkv(s=8, d=16, dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="cudnn"):
        attention(q, k, v, backend="cudnn")


def test_default_backend_is_validated_and_restorable():
    with pytest.raises(ValueError, match="unknown attention backend"):
        attn.set_default_backend("pallas")
    attn.set_default_backend("xla")
    try:
        assert attn.get_default_backend() == "xla"
        assert resolve_backend(None, jnp.bfloat16, "gpu") == "xla"
    finally:
        attn.set_default_backend("auto")


@pytest.mark.parametrize("s", [7, 37, 130])
def test_fused_wrapper_layout_matches_reference(s):
    q, k, v = _qkv(b=2, h=3, s=s, d=16, seed=s)
    np.testing.assert_allclose(fused_attention(q, k, v, "xla"),
                               xla_attention(q, k, v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [130, 128, 4817])
def test_fused_wrapper_hands_the_library_unpadded_bshd(s):
    q, k, v = _qkv(b=2, h=1, s=s, d=8)
    jaxpr = jax.make_jaxpr(lambda *a: fused_attention(*a, "xla"))(q, k, v)
    prims = {eqn.primitive.name for eqn in jaxpr.eqns}
    shapes = {tuple(var.aval.shape) for eqn in jaxpr.eqns for var in eqn.outvars}
    assert "pad" not in prims
    assert (2, s, 1, 8) in shapes


@pytest.mark.parametrize("s", [9, 67])
def test_fused_wrapper_gradients_match_reference(s):
    q, k, v = _qkv(b=1, h=2, s=s, d=16, seed=s)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(q.shape), jnp.float32)

    def loss(f):
        return lambda q, k, v: jnp.sum(f(q, k, v) * w)

    g_ref = jax.grad(loss(xla_attention), argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(loss(lambda *a: fused_attention(*a, "xla")), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_rope_is_applied_before_attention():
    q, k, v = _qkv(s=12, d=32)
    ids = jnp.stack([jnp.zeros(12), jnp.arange(12.0), jnp.arange(12.0)[::-1]], -1)
    cos, sin = rope_cos_sin_half(ids, (8, 12, 12))
    got = attention(q, k, v, backend="xla", rope_cos=cos, rope_sin=sin)
    want = xla_attention(apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4608, 4737])
def test_cudnn_matches_reference_on_the_card(gpu_device, s):
    q, k, v = _qkv(b=1, h=24, s=s, d=128, seed=s, dtype=jnp.bfloat16)
    got = np.asarray(attention(q, k, v), np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(xla_attention(*(x.astype(jnp.float32) for x in (q, k, v))))
    # bf16 output rounding alone is ~4e-3 relative to the largest value
    assert np.max(np.abs(got - want)) <= 1e-2 * np.max(np.abs(want))
