"""BFL single-file checkpoint loading (FromSingleFileMixin parity).

Builds a BFL-layout state dict by fusing the synthetic diffusers state
(tests/synth_checkpoints.py) into the original Black-Forest-Labs key schema,
then asserts the remap + standard converter produce byte-identical params to
converting the diffusers state directly.
"""

import os

import numpy as np
import pytest

from reptext.configs import FluxConfig
from reptext.io.convert import convert_flux_transformer
from reptext.io.single_file import (
    bfl_flux_to_diffusers,
    is_bfl_flux,
    load_flux_single_file,
    strip_wrapper_prefixes,
)
from tests.synth_checkpoints import flux_state

CFG = FluxConfig().tiny()


def _diffusers_to_bfl(state, cfg):
    """Inverse remap: fuse qkv/linear1, rename to BFL keys, swap adaLN halves."""
    bfl = {}

    def mv(dst, src):
        bfl[f"{dst}.weight"] = state[f"{src}.weight"]
        if f"{src}.bias" in state:
            bfl[f"{dst}.bias"] = state[f"{src}.bias"]

    def fuse(dst, srcs):
        bfl[f"{dst}.weight"] = np.concatenate(
            [state[f"{s}.weight"] for s in srcs], axis=0)
        bfl[f"{dst}.bias"] = np.concatenate(
            [state[f"{s}.bias"] for s in srcs], axis=0)

    mv("img_in", "x_embedder")
    mv("txt_in", "context_embedder")
    mv("time_in.in_layer", "time_text_embed.timestep_embedder.linear_1")
    mv("time_in.out_layer", "time_text_embed.timestep_embedder.linear_2")
    mv("vector_in.in_layer", "time_text_embed.text_embedder.linear_1")
    mv("vector_in.out_layer", "time_text_embed.text_embedder.linear_2")
    if cfg.guidance_embeds:
        mv("guidance_in.in_layer", "time_text_embed.guidance_embedder.linear_1")
        mv("guidance_in.out_layer", "time_text_embed.guidance_embedder.linear_2")
    for i in range(cfg.num_layers):
        p, s = f"transformer_blocks.{i}", f"double_blocks.{i}"
        mv(f"{s}.img_mod.lin", f"{p}.norm1.linear")
        mv(f"{s}.txt_mod.lin", f"{p}.norm1_context.linear")
        fuse(f"{s}.img_attn.qkv",
             [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"])
        fuse(f"{s}.txt_attn.qkv",
             [f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj",
              f"{p}.attn.add_v_proj"])
        bfl[f"{s}.img_attn.norm.query_norm.scale"] = state[f"{p}.attn.norm_q.weight"]
        bfl[f"{s}.img_attn.norm.key_norm.scale"] = state[f"{p}.attn.norm_k.weight"]
        bfl[f"{s}.txt_attn.norm.query_norm.scale"] = state[f"{p}.attn.norm_added_q.weight"]
        bfl[f"{s}.txt_attn.norm.key_norm.scale"] = state[f"{p}.attn.norm_added_k.weight"]
        mv(f"{s}.img_attn.proj", f"{p}.attn.to_out.0")
        mv(f"{s}.txt_attn.proj", f"{p}.attn.to_add_out")
        mv(f"{s}.img_mlp.0", f"{p}.ff.net.0.proj")
        mv(f"{s}.img_mlp.2", f"{p}.ff.net.2")
        mv(f"{s}.txt_mlp.0", f"{p}.ff_context.net.0.proj")
        mv(f"{s}.txt_mlp.2", f"{p}.ff_context.net.2")
    for i in range(cfg.num_single_layers):
        p, s = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        mv(f"{s}.modulation.lin", f"{p}.norm.linear")
        fuse(f"{s}.linear1",
             [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v",
              f"{p}.proj_mlp"])
        mv(f"{s}.linear2", f"{p}.proj_out")
        bfl[f"{s}.norm.query_norm.scale"] = state[f"{p}.attn.norm_q.weight"]
        bfl[f"{s}.norm.key_norm.scale"] = state[f"{p}.attn.norm_k.weight"]

    # diffusers [scale; shift] -> BFL [shift; scale] (its own inverse)
    for nm in ("weight", "bias"):
        w = state[f"norm_out.linear.{nm}"]
        scale, shift = np.split(w, 2, axis=0)
        bfl[f"final_layer.adaLN_modulation.1.{nm}"] = np.concatenate(
            [shift, scale], axis=0)
    mv("final_layer.linear", "proj_out")
    return bfl


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


def test_bfl_remap_matches_diffusers_convert():
    diff_state = flux_state(CFG, seed=7)
    bfl_state = _diffusers_to_bfl(diff_state, CFG)
    assert is_bfl_flux(bfl_state) and not is_bfl_flux(diff_state)
    want = convert_flux_transformer(diff_state, CFG)
    got = convert_flux_transformer(bfl_flux_to_diffusers(bfl_state), CFG)
    _assert_trees_equal(want, got)


def test_comfyui_wrapper_stripped():
    diff_state = flux_state(CFG, seed=3)
    bfl_state = _diffusers_to_bfl(diff_state, CFG)
    wrapped = {f"model.diffusion_model.{k}": v for k, v in bfl_state.items()}
    assert not is_bfl_flux(wrapped)
    assert is_bfl_flux(strip_wrapper_prefixes(wrapped))


def test_load_single_file_roundtrip(tmp_path):
    safetensors = pytest.importorskip("safetensors.numpy")
    diff_state = flux_state(CFG, seed=11)
    bfl_state = _diffusers_to_bfl(diff_state, CFG)
    path = os.path.join(tmp_path, "flux1-tiny.safetensors")
    safetensors.save_file(bfl_state, path)
    got = load_flux_single_file(path, CFG)
    want = convert_flux_transformer(diff_state, CFG)
    _assert_trees_equal(want, got)


def test_convert_cli_single_file(tmp_path):
    """convert_cli --flux-single-file: BFL file -> checkpoint dir with
    inferred geometry (head-dim 128, every published FLUX.1 variant)."""
    import dataclasses
    import json

    safetensors = pytest.importorskip("safetensors.numpy")
    from reptext.io import convert_cli
    from reptext.io.checkpoint import load_pipeline_params, load_saved_configs

    cfg = dataclasses.replace(
        FluxConfig(), num_layers=1, num_single_layers=2,
        num_attention_heads=1, joint_attention_dim=48,
        pooled_projection_dim=40,
    )
    diff_state = flux_state(cfg, seed=5)
    bfl_state = _diffusers_to_bfl(diff_state, cfg)
    src = os.path.join(tmp_path, "flux1-dev.safetensors")
    safetensors.save_file(bfl_state, src)
    out = os.path.join(tmp_path, "ckpt")
    assert convert_cli.main(["--flux-single-file", src, "--out", out]) == 0

    saved_cfgs = load_saved_configs(out)
    got_cfg = saved_cfgs["flux"]
    assert got_cfg.num_layers == 1 and got_cfg.num_single_layers == 2
    assert got_cfg.attention_head_dim == 128 and got_cfg.num_attention_heads == 1
    assert got_cfg.joint_attention_dim == 48
    assert got_cfg.pooled_projection_dim == 40
    assert got_cfg.guidance_embeds

    params = load_pipeline_params(out, components=("flux",))
    want = convert_flux_transformer(diff_state, cfg)
    flat_got = {
        "/".join(map(str, p)): np.asarray(v)
        for p, v in _flatten(params["flux"])
    }
    flat_want = {
        "/".join(map(str, p)): np.asarray(v) for p, v in _flatten(want)
    }
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v
