"""Weight-only fp8 storage of the transformer block stacks.

Full FLUX.1-dev + RepText ControlNet is ~12B params = ~24 GB bf16. Storing the
transformer-block weights as float8_e4m3fn with per-output-channel scales
halves that, and the matmuls stay bf16: each scanned layer's weight slice is
dequantized inside the scan body (``nn.map_variables`` on the scanned layer,
models/flux.py), so at most one block's bf16 weights exist at a time and XLA
can fuse the convert-and-scale into the dot operand read.

This mirrors the community fp8 FLUX deployments (naive float8_e4m3 casts of
the same checkpoints); per-channel scaling here is strictly more accurate
than those. Weight-only: activations, norms, biases, and all accumulation
remain bf16/f32 — no activation quantization, no change to attention.

Format: in any params subtree, an eligible ``kernel`` leaf (ndim >= 2) is
replaced by two sibling leaves so ``nn.scan`` (nn/module.py) slices both
along the stacked layer axis:

    kernel            [..., in, out]  ->
    kernel_q8         [..., in, out]  float8_e4m3fn
    kernel_scale      [..., 1,  out]  bfloat16  (bf16-representable by
                                      construction so dequant is exact in bf16)

``dequantize_collection`` is idempotent over unquantized leaves, so it is safe
as a blanket ``trans_in_fn``.

Reference scale facts: 19 double + 38 single blocks at 24x128
(RepText/controlnet_flux.py:248-279 imports the diffusers FluxTransformer2D
this framework rebuilds); the published RepText ControlNet is 4+10 blocks
(RepText/controlnet_flux.py:182-214).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp

E4M3_MAX = 448.0
QUANT_KEY = "kernel_q8"
SCALE_KEY = "kernel_scale"
# params subtrees holding the scanned transformer blocks — the >99% of bytes.
# Top-level embedders/heads stay bf16 (they are small and outside the
# map_variables wrap).
DEFAULT_SUBTREES = ("double_blocks", "single_blocks")


def quantize_kernel(w: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-output-channel symmetric fp8-e4m3 quantization of one kernel.

    Kernel layout is Dense ``[..., in, out]`` (a leading stacked-layer
    axis passes through untouched). The scale is rounded to bf16 BEFORE
    quantizing so ``q * scale`` in bf16 reproduces the intended value exactly
    (fp8-e4m3 mantissas embed in bf16).
    """
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2, keepdims=True)
    scale = jnp.maximum(amax / E4M3_MAX, 1e-12).astype(jnp.bfloat16)
    q = (wf / scale.astype(jnp.float32)).astype(jnp.float8_e4m3fn)
    return q, scale


def dequantize_kernel(q: jax.Array, scale: jax.Array) -> jax.Array:
    """Exact-in-bf16 dequantization (see quantize_kernel)."""
    return q.astype(jnp.bfloat16) * scale.astype(jnp.bfloat16)


def _is_eligible(key: str, leaf: Any) -> bool:
    return (
        key == "kernel"
        and getattr(leaf, "ndim", 0) >= 2
        and jnp.issubdtype(leaf.dtype, jnp.floating)
    )


def _quantize_dict(d: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _quantize_dict(v)
        elif _is_eligible(k, v):
            q, s = quantize_kernel(v)
            out[QUANT_KEY] = q
            out[SCALE_KEY] = s
        else:
            out[k] = v
    return out


def dequantize_collection(col: Dict[str, Any]) -> Dict[str, Any]:
    """map_variables trans_in_fn: restore ``kernel`` from q8+scale pairs.

    Idempotent: dicts without quantized pairs pass through unchanged, so the
    same wrap serves quantized and unquantized params.
    """
    if not isinstance(col, dict):
        return col
    out: Dict[str, Any] = {}
    for k, v in col.items():
        if k == QUANT_KEY:
            out["kernel"] = dequantize_kernel(v, col[SCALE_KEY])
        elif k == SCALE_KEY:
            continue
        elif isinstance(v, dict):
            out[k] = dequantize_collection(v)
        else:
            out[k] = v
    return out


def _to_plain(d: Any) -> Any:
    # tolerate frozen mappings (checkpoint restores) as plain dicts
    if hasattr(d, "unfreeze"):
        d = d.unfreeze()
    return d


def quantize_params(
    params: Dict[str, Any],
    subtrees: Optional[Iterable[str]] = DEFAULT_SUBTREES,
) -> Dict[str, Any]:
    """Quantize the block-stack kernels of a model params tree.

    ``params`` is the tree under the 'params' collection (as produced by
    ``model.init(...)['params']`` or io/convert.py). Only named ``subtrees``
    are touched (None = everything): the map_variables dequant wrap in the
    models covers exactly the scanned block stacks, so quantization outside
    them would feed raw fp8 into Dense (auto-promoted, but unscaled).
    """
    params = _to_plain(params)
    out: Dict[str, Any] = {}
    for k, v in params.items():
        v = _to_plain(v)
        if isinstance(v, dict) and (subtrees is None or k in tuple(subtrees)):
            out[k] = _quantize_dict(v)
        else:
            out[k] = v
    return out


def quantized_bytes(params: Dict[str, Any]) -> Tuple[int, int]:
    """(bytes as stored, bytes if all-bf16) — for memory reporting."""
    stored = 0
    bf16 = 0
    for leaf in jax.tree_util.tree_leaves(params):
        n = int(jnp.asarray(leaf).size)
        stored += n * jnp.asarray(leaf).dtype.itemsize
        bf16 += n * 2
    return stored, bf16


def is_quantized(tree: Any) -> bool:
    """True if any dict level of ``tree`` carries the fp8 storage pair.

    Used by drivers to auto-detect fp8-STORED checkpoints
    (io/convert_cli.py --dtype fp8) and switch the models to weight_quant
    without an explicit flag — loading quantized storage into dense models
    would otherwise fail at apply time.
    """
    tree = _to_plain(tree)
    if not isinstance(tree, dict):
        return False
    if QUANT_KEY in tree:
        return True
    return any(is_quantized(v) for v in tree.values() if isinstance(v, dict))
