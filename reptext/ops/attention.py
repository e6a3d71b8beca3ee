"""Attention dispatch: cuDNN's fused flash attention on the GPU, and the XLA
einsum as the reference and the CPU path.

The reference relies on torch SDPA inside diffusers attention processors.
Here attention is a backend-dispatched pure function over ``[B, H, S, D]``
tensors (full, non-causal):

- ``xla``: an einsum softmax with float32 logits. It materialises the
  ``[B, H, S, S]`` logits, so it is the numerical reference and the CPU path,
  not the GPU path;
- ``cudnn``: ``jax.nn.dot_product_attention(implementation="cudnn")``, the
  cuDNN flash kernel with its own backward. It takes the ``[B, S, H, D]``
  layout, so the wrapper transposes in and out (XLA folds the transposes into
  the neighbouring head split and merge). Lengths go to cuDNN as they are:
  it takes lengths off its 128-token tiles, such as the 4,817 tokens of a
  1280x960 inpaint with a short prompt.

``auto`` picks ``cudnn`` on a GPU for bf16 and fp16 inputs, and ``xla``
otherwise. Asking for ``cudnn`` where it cannot run is an error; it never
falls back to another route.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

BACKENDS = ("auto", "xla", "cudnn")
_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)
_DEFAULT_BACKEND = "auto"


def set_default_backend(name: str) -> None:
    """Set the process-wide attention backend: 'auto' | 'xla' | 'cudnn'."""
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; one of {BACKENDS}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


def resolve_backend(backend: Optional[str], dtype, platform: Optional[str] = None) -> str:
    """The route for inputs of ``dtype`` on ``platform`` (default: JAX's).

    ``auto`` -> ``cudnn`` on a GPU with bf16/fp16 inputs, else ``xla``.
    ``cudnn`` off a GPU or with other dtypes raises ``ValueError``.
    """
    b = backend or _DEFAULT_BACKEND
    if b not in BACKENDS:
        raise ValueError(f"unknown attention backend {b!r}; one of {BACKENDS}")
    platform = platform or jax.default_backend()
    supported = platform == "gpu" and jnp.dtype(dtype) in map(jnp.dtype, _CUDNN_DTYPES)
    if b == "auto":
        return "cudnn" if supported else "xla"
    if b == "cudnn" and not supported:
        raise ValueError(
            f"cudnn attention needs a GPU and bf16/fp16 inputs; got platform "
            f"{platform!r}, dtype {jnp.dtype(dtype).name}")
    return b


def xla_attention(q: jax.Array, k: jax.Array, v: jax.Array) -> jax.Array:
    """[B, H, S, D] q/k/v -> [B, H, S, D]; fp32 softmax accumulation."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits * scale, axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v)


def fused_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                    implementation: str = "cudnn") -> jax.Array:
    """[B, H, S, D] attention through ``jax.nn.dot_product_attention``.

    ``implementation`` is ``"cudnn"`` on the GPU; tests run the same layout
    on the CPU with ``"xla"``.
    """
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    out = jax.nn.dot_product_attention(q, k, v, implementation=implementation)
    return out.transpose(0, 2, 1, 3)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    backend: Optional[str] = None,
    rope_cos: Optional[jax.Array] = None,
    rope_sin: Optional[jax.Array] = None,
) -> jax.Array:
    """Multi-head attention over [B, H, S, D] tensors (full, non-causal).

    With half-split rope tables, q/k arrive UNROTATED (half-split channel
    order) and are rotated here in XLA, which fuses the rotation into the
    q/k-norm producer.
    """
    if rope_cos is not None:
        from reptext.ops.rope import apply_rope_half

        q = apply_rope_half(q, rope_cos, rope_sin)
        k = apply_rope_half(k, rope_cos, rope_sin)
    if resolve_backend(backend, q.dtype) == "cudnn":
        return fused_attention(q, k, v, "cudnn")
    return xla_attention(q, k, v)
