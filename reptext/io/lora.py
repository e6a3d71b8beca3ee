"""LoRA loading and merging for FLUX transformer / ControlNet param trees.

The reference inherits LoRA support from diffusers' ``FluxLoraLoaderMixin``
with PEFT scale plumbing (RepText/pipeline_flux_controlnet.py:163,394-403;
RepText/controlnet_flux.py:263-276,403-405). Equivalent here: LoRA
safetensors (diffusers naming, ``transformer.<module>.lora_A.weight`` /
``lora_B.weight``) are converted to delta pytrees aligned with this package's
scanned-layer layout and merged into the dense weights ahead of time —
W' = W + scale * (B @ A)^T — so sampling runs with zero runtime overhead
(inference-time LoRA as weight surgery, which keeps the sampler graph LoRA-free).

``apply_lora`` is pure and invertible (keep the base params to unmerge or
re-scale).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np


# torch module path (diffusers FLUX naming) -> (our tree path, stacked layer axis)
_BLOCK_PATTERNS = [
    # double blocks
    (re.compile(r"transformer_blocks\.(\d+)\.attn\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out)$"),
     lambda m: ("double_blocks", "block", m.group(2))),
    (re.compile(r"transformer_blocks\.(\d+)\.attn\.to_out\.0$"),
     lambda m: ("double_blocks", "block", "to_out")),
    (re.compile(r"transformer_blocks\.(\d+)\.norm1\.linear$"),
     lambda m: ("double_blocks", "block", "norm1", "linear")),
    (re.compile(r"transformer_blocks\.(\d+)\.norm1_context\.linear$"),
     lambda m: ("double_blocks", "block", "norm1_context", "linear")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff\.net\.0\.proj$"),
     lambda m: ("double_blocks", "block", "ff", "in_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff\.net\.2$"),
     lambda m: ("double_blocks", "block", "ff", "out_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff_context\.net\.0\.proj$"),
     lambda m: ("double_blocks", "block", "ff_context", "in_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff_context\.net\.2$"),
     lambda m: ("double_blocks", "block", "ff_context", "out_proj")),
    # single blocks
    (re.compile(r"single_transformer_blocks\.(\d+)\.attn\.(to_q|to_k|to_v)$"),
     lambda m: ("single_blocks", "block", m.group(2))),
    (re.compile(r"single_transformer_blocks\.(\d+)\.(proj_mlp|proj_out)$"),
     lambda m: ("single_blocks", "block", m.group(2))),
    (re.compile(r"single_transformer_blocks\.(\d+)\.norm\.linear$"),
     lambda m: ("single_blocks", "block", "norm", "linear")),
]

# non-stacked (top-level) modules
_TOP_PATTERNS = [
    (re.compile(r"^(x_embedder|context_embedder|proj_out)$"), lambda m: (m.group(1),)),
    (re.compile(r"^norm_out\.linear$"), lambda m: ("norm_out", "linear")),
]


def parse_lora_state(
    state: Dict[str, np.ndarray], prefix: str = "transformer."
) -> Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """Group a flat LoRA state dict into {module_path: {layer_idx: (A, B)}}.

    ``layer_idx`` is -1 for non-stacked modules. A: [r, in], B: [out, r]
    (torch layout).
    """
    grouped: Dict[Tuple, Dict[int, list]] = {}
    for key, arr in state.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        m = re.match(r"(.+)\.(lora_A|lora_B)\.weight$", name)
        if not m:
            continue
        module, which = m.group(1), m.group(2)
        layer = -1
        path = None
        for pat, fn in _BLOCK_PATTERNS:
            mm = pat.match(module)
            if mm:
                layer = int(mm.group(1))
                path = fn(mm)
                break
        if path is None:
            for pat, fn in _TOP_PATTERNS:
                mm = pat.match(module)
                if mm:
                    path = fn(mm)
                    break
        if path is None:
            raise KeyError(f"unrecognized LoRA module {module!r}")
        slot = grouped.setdefault(path, {}).setdefault(layer, [None, None])
        slot[0 if which == "lora_A" else 1] = arr

    out: Dict[Tuple, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
    for path, layers in grouped.items():
        out[path] = {}
        for layer, (a, b) in layers.items():
            if a is None or b is None:
                raise ValueError(f"LoRA pair incomplete for {path} layer {layer}")
            out[path][layer] = (a, b)
    return out


# q/k projection leaves whose converted kernels carry the RoPE half-split
# channel permutation (io/convert.py::_lin_rope) — LoRA deltas targeting them
# must be permuted identically before merging.
_ROPE_PERMUTED_LEAVES = frozenset({"to_q", "to_k", "add_q_proj", "add_k_proj"})


def apply_lora(params: Dict[str, Any], lora_state: Dict[str, np.ndarray],
               scale: float = 1.0, prefix: str = "transformer.",
               head_dim: int = 128) -> Dict[str, Any]:
    """Merge LoRA deltas into a (possibly scanned) param tree; returns new tree."""
    import jax

    from reptext.io.convert import _deinterleave

    grouped = parse_lora_state(lora_state, prefix)
    tree = jax.tree_util.tree_map(lambda x: x, params)  # shallow copy of leaves

    def get_node(root, path):
        node = root["params"] if "params" in root else root
        for key in path[:-1]:
            node = node[key]
        return node, path[-1]

    perm = _deinterleave(head_dim)
    for path, layers in grouped.items():
        node, leaf = get_node(tree, path)
        kernel = np.array(node[leaf]["kernel"])  # [L?, in, out]
        stacked = kernel.ndim == 3
        for layer, (a, b) in layers.items():
            delta = (b.astype(np.float32) @ a.astype(np.float32)).T * scale  # [in, out]
            if leaf in _ROPE_PERMUTED_LEAVES:
                in_dim, out_dim = delta.shape
                delta = delta.reshape(in_dim, out_dim // head_dim, head_dim)[
                    :, :, perm].reshape(in_dim, out_dim)
            if stacked:
                if layer < 0:
                    raise ValueError(f"stacked module {path} needs a layer index")
                kernel[layer] = kernel[layer] + delta.astype(kernel.dtype)
            else:
                kernel = kernel + delta.astype(kernel.dtype)
        node[leaf] = dict(node[leaf])
        node[leaf]["kernel"] = kernel
    return tree
