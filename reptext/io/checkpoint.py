"""Orbax checkpoint save/load for pipeline param trees.

The reference checkpoints only via HF hub safetensors (SURVEY.md §5
"Checkpoint/resume"); here converted weights are cached as orbax checkpoints
for fast direct-to-device reload, and full pipeline param sets (flux / controlnet /
vae / clip / t5) are stored under one directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

COMPONENTS = ("flux", "controlnet", "inpaint_controlnet", "vae", "clip", "t5")

# Param-layout version written into every checkpoint directory. Version 2 =
# the RoPE deinterleave permutation is folded into converted q/k kernels and
# qk-norm scales (io/convert.py::_fold_rope_permutation); version 1 =
# pre-fold interleaved channel order. A v1 checkpoint loaded into current
# models silently produces wrong attention, so load_pipeline_params fails
# loudly on any mismatch (re-run the converter to regenerate the cache).
LAYOUT_VERSION = 2
_LAYOUT_FILE = "LAYOUT_VERSION"


def checkpoint_layout_version(directory: str) -> int:
    """Layout version recorded in ``directory`` (1 if no marker: pre-fold)."""
    path = os.path.join(os.path.abspath(directory), _LAYOUT_FILE)
    if not os.path.isfile(path):
        return 1
    with open(path) as f:
        return int(f.read().strip())


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def load_saved_configs(directory: str) -> Dict[str, Any]:
    """Rebuild config dataclasses from a converter-written ``configs.json``.

    ``io.convert_cli`` records each component's checkpoint-derived geometry
    (depths, guidance embeds, extra condition channels, union mode) so
    drivers construct the EXACT model the weights were trained with instead
    of library defaults — the equivalent of diffusers reading a hub
    ``config.json`` (reference: RepText/controlnet_flux.py:44 ConfigMixin).
    Returns {} when the directory has no configs.json (e.g. hand-built
    checkpoints); unknown component names and fields are ignored.
    """
    import dataclasses
    import json

    path = os.path.join(os.path.abspath(directory), "configs.json")
    if not os.path.isfile(path):
        return {}
    from reptext.configs import (
        CLIPConfig,
        CLIPVisionConfig,
        ControlNetConfig,
        FluxConfig,
        T5Config,
        VAEConfig,
    )

    classes = {
        "flux": FluxConfig,
        "controlnet": ControlNetConfig,
        "inpaint_controlnet": ControlNetConfig,
        "vae": VAEConfig,
        "clip": CLIPConfig,
        "t5": T5Config,
        "clip_vision": CLIPVisionConfig,
    }
    with open(path) as f:
        raw = json.load(f)
    out: Dict[str, Any] = {}
    for name, d in raw.items():
        cls = classes.get(name)
        if cls is None or not isinstance(d, dict):
            continue
        fields = {fld.name: fld for fld in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in fields:
                continue
            kw[k] = tuple(v) if isinstance(v, list) else v
        out[name] = cls(**kw)
    return out


def save_pipeline_params(params: Dict[str, Any], directory: str) -> None:
    """Save each component param tree under directory/<component>."""
    ckptr = _checkpointer()
    os.makedirs(directory, exist_ok=True)
    for name, tree in params.items():
        ckptr.save(os.path.join(os.path.abspath(directory), name), tree)
    with open(os.path.join(os.path.abspath(directory), _LAYOUT_FILE), "w") as f:
        f.write(f"{LAYOUT_VERSION}\n")


def load_pipeline_params(
    directory: str, components: Optional[tuple] = None
) -> Dict[str, Any]:
    """Load every component checkpoint found under ``directory``.

    Refuses checkpoints whose recorded param layout differs from the current
    LAYOUT_VERSION (e.g. caches converted before the RoPE permutation fold):
    such params load cleanly but rotate the wrong channel pairs in attention.
    """
    version = checkpoint_layout_version(directory)
    if os.path.isdir(directory) and version != LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint {directory} has param layout v{version}, current is "
            f"v{LAYOUT_VERSION} (RoPE half-split permutation folded into q/k "
            "weights). Loading it would silently corrupt attention — delete "
            "the cache and re-run the converter (io.checkpoint.convert_and_"
            "cache) from the original safetensors."
        )
    ckptr = _checkpointer()
    out: Dict[str, Any] = {}
    for name in components or COMPONENTS:
        path = os.path.join(os.path.abspath(directory), name)
        if os.path.isdir(path):
            out[name] = ckptr.restore(path)
    if not out:
        raise FileNotFoundError(f"no component checkpoints under {directory}")
    return out


def convert_and_cache(
    hf_dirs: Dict[str, str], configs: Dict[str, Any], cache_dir: str
) -> Dict[str, Any]:
    """Convert HF safetensors checkpoints and cache as orbax.

    hf_dirs maps component name -> safetensors file/dir; configs maps
    component name -> this package's config dataclass.
    """
    from reptext.io.convert import (
        convert_clip,
        convert_controlnet,
        convert_flux_transformer,
        convert_t5,
        convert_vae,
        load_safetensors_state,
    )

    converters = {
        "flux": convert_flux_transformer,
        "controlnet": convert_controlnet,
        "inpaint_controlnet": convert_controlnet,
        "vae": convert_vae,
        "clip": convert_clip,
        "t5": convert_t5,
    }
    params = {}
    for name, path in hf_dirs.items():
        state = load_safetensors_state(path)
        params[name] = converters[name](state, configs[name])
    save_pipeline_params(params, cache_dir)
    return params
