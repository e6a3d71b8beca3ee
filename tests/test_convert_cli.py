"""End-to-end converter-CLI tests: HF snapshot dirs -> runnable checkpoint dir.

The reference's loading story is diffusers ``from_pretrained`` over an HF
snapshot (RepText/infer.py:30-33); ours is a one-time offline conversion via
``python -m reptext.io.convert_cli``. These tests build synthetic
HF-layout snapshots (exact diffusers/transformers key names + config.json,
see tests/synth_checkpoints.py), run the real CLI main(), and assert that

  * every component converts and restores through orbax bit-exactly vs a
    direct in-process conversion of the same state dict,
  * ``configs.json`` round-trips each component's checkpoint-derived
    geometry through ``load_saved_configs`` (the driver's path),
  * storage dtype policy (keep / bf16) is honored,
  * tokenizer assets are copied for the vendored tokenizers.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from reptext.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig
from reptext.io import convert_cli
from reptext.io.checkpoint import (
    LAYOUT_VERSION,
    checkpoint_layout_version,
    load_pipeline_params,
    load_saved_configs,
)

from tests import synth_checkpoints as synth


def _cfgs():
    # HF configs don't record time_embed_dim (a fixed diffusers constant),
    # so the converter derives it from library defaults — the synthetic
    # snapshots must be built at the default value for shapes to agree.
    default_ted = FluxConfig().time_embed_dim
    flux = dataclasses.replace(FluxConfig().tiny(), time_embed_dim=default_ted)
    cn = dataclasses.replace(
        ControlNetConfig().tiny(), time_embed_dim=default_ted, num_mode=10
    )
    inpaint_cn = dataclasses.replace(
        cn, num_mode=None, extra_condition_channels=4
    )
    return flux, cn, inpaint_cn, VAEConfig().tiny(), CLIPConfig().tiny(), T5Config().tiny()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    flux, cn, inpaint_cn, vae, clip, t5 = _cfgs()
    root = tmp_path_factory.mktemp("hf")
    pipe_dir = str(root / "pipeline")
    synth.write_flux_pipeline_snapshot(pipe_dir, flux, vae, clip, t5)
    # tokenizer assets the CLI should copy through
    for sub, files in (
        ("tokenizer", {"vocab.json": "{}", "merges.txt": "#version: 0.2"}),
        ("tokenizer_2", {"spiece.model": "\x00fake"}),
    ):
        os.makedirs(os.path.join(pipe_dir, sub), exist_ok=True)
        for fname, content in files.items():
            with open(os.path.join(pipe_dir, sub, fname), "w") as f:
                f.write(content)
    cn_dir = str(root / "controlnet")
    synth.write_controlnet_snapshot(cn_dir, cn)
    ip_dir = str(root / "inpaint_controlnet")
    synth.write_controlnet_snapshot(ip_dir, inpaint_cn)
    out = str(root / "out")
    rc = convert_cli.main([
        "--pipeline-dir", pipe_dir,
        "--controlnet-dir", cn_dir,
        "--inpaint-controlnet-dir", ip_dir,
        "--out", out,
    ])
    assert rc == 0
    return dict(out=out, pipe_dir=pipe_dir, cn_dir=cn_dir, ip_dir=ip_dir,
                cfgs=(flux, cn, inpaint_cn, vae, clip, t5))


def test_configs_roundtrip(converted):
    flux, cn, inpaint_cn, vae, clip, t5 = converted["cfgs"]
    saved = load_saved_configs(converted["out"])
    assert saved["flux"] == flux
    assert saved["controlnet"] == cn
    assert saved["inpaint_controlnet"] == inpaint_cn
    assert saved["vae"] == vae
    assert saved["clip"] == clip
    assert saved["t5"] == t5


def test_layout_version_written(converted):
    assert checkpoint_layout_version(converted["out"]) == LAYOUT_VERSION


def test_components_restore_bitexact(converted):
    """Orbax round-trip equals a direct in-process conversion."""
    import jax

    from reptext.io import convert as C

    flux, cn, *_ = converted["cfgs"]
    params = load_pipeline_params(converted["out"])
    assert set(params) >= {"flux", "controlnet", "inpaint_controlnet", "vae", "clip", "t5"}

    state = C.load_safetensors_state(
        os.path.join(converted["pipe_dir"], "transformer"), dtype=None
    )
    direct = C.convert_flux_transformer(state, flux)
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(params["flux"])[0],
        jax.tree_util.tree_flatten_with_path(direct)[0],
    ):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    cstate = C.load_safetensors_state(converted["cn_dir"], dtype=None)
    cdirect = C.convert_controlnet(cstate, cn)
    leaves_a = jax.tree_util.tree_leaves(params["controlnet"])
    leaves_b = jax.tree_util.tree_leaves(cdirect)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dtype_keep_preserves_storage(converted):
    """Synthetic states are fp32; --dtype keep must not cast them."""
    import jax

    params = load_pipeline_params(converted["out"], components=("flux",))
    dtypes = {np.asarray(v).dtype for v in jax.tree_util.tree_leaves(params["flux"])}
    assert dtypes == {np.dtype(np.float32)}


def test_dtype_bf16(converted, tmp_path):
    import jax
    import ml_dtypes

    out = str(tmp_path / "bf16")
    rc = convert_cli.main([
        "--controlnet-dir", converted["cn_dir"], "--dtype", "bf16", "--out", out,
    ])
    assert rc == 0
    params = load_pipeline_params(out, components=("controlnet",))
    float_dtypes = {
        np.asarray(v).dtype
        for v in jax.tree_util.tree_leaves(params["controlnet"])
        if not np.issubdtype(np.asarray(v).dtype, np.integer)
    }
    assert float_dtypes == {np.dtype(ml_dtypes.bfloat16)}


def test_tokenizer_assets_copied(converted):
    out = converted["out"]
    assert os.path.isfile(os.path.join(out, "tokenizer", "vocab.json"))
    assert os.path.isfile(os.path.join(out, "tokenizer", "merges.txt"))
    assert os.path.isfile(os.path.join(out, "tokenizer_2", "spiece.model"))


def test_configs_json_is_complete_dataclass_dump(converted):
    with open(os.path.join(converted["out"], "configs.json")) as f:
        raw = json.load(f)
    flux_fields = {f.name for f in dataclasses.fields(FluxConfig)}
    assert set(raw["flux"]) == flux_fields


def test_cli_lora_requires_checkpoint():
    from reptext.cli import main

    with pytest.raises(SystemExit):
        main(["--text", "a", "--position", "1", "2", "--random-weights",
              "--tiny", "--lora", "/tmp/nope.safetensors"])


@pytest.mark.slow
def test_cli_generation_from_converted_checkpoint_with_lora(converted, tmp_path, capsys):
    """Full driver path: converted checkpoint dir (geometry from configs.json,
    --tiny NOT passed) + LoRA weight surgery + txt2img to a PNG."""
    from safetensors.numpy import save_file

    from reptext.cli import main

    flux = converted["cfgs"][0]
    r = np.random.default_rng(7)
    rank, d = 2, flux.inner_dim
    lora = {
        # plain module + a RoPE-permuted q projection
        "transformer.x_embedder.lora_A.weight":
            r.standard_normal((rank, flux.in_channels)).astype(np.float32) * 0.1,
        "transformer.x_embedder.lora_B.weight":
            r.standard_normal((d, rank)).astype(np.float32) * 0.1,
        "transformer.transformer_blocks.0.attn.to_q.lora_A.weight":
            r.standard_normal((rank, d)).astype(np.float32) * 0.1,
        "transformer.transformer_blocks.0.attn.to_q.lora_B.weight":
            r.standard_normal((d, rank)).astype(np.float32) * 0.1,
    }
    lora_path = str(tmp_path / "lora.safetensors")
    save_file(lora, lora_path)
    # drop the fixture's placeholder tokenizer assets (not real vocab files)
    # so the driver uses its deterministic fallback ids
    import shutil

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(converted["out"], ckpt,
                    ignore=shutil.ignore_patterns("tokenizer*"))
    out = tmp_path / "out.png"
    rc = main(["--compile-cache", "off",
        "--text", "Hi", "--position", "8", "16",
        "--checkpoint-dir", ckpt,
        "--lora", lora_path, "--lora-scale", "0.5",
        "--size", "64", "--steps", "2", "--controlnet-step", "1",
        "--controlnet-mode", "3",  # fixture CN is union (num_mode=10)
        "--font-size", "24", "--output", str(out),
    ])
    assert rc == 0 and out.exists() and out.stat().st_size > 0
    assert "merged LoRA" in capsys.readouterr().out


@pytest.mark.slow
def test_cli_inpaint_from_converted_checkpoint(converted, tmp_path):
    """Inpaint driver from the converted dir: the 68-feature (extra=4)
    inpaint_controlnet geometry must come from configs.json."""
    from PIL import Image

    from reptext.cli import main

    import shutil

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(converted["out"], ckpt,
                    ignore=shutil.ignore_patterns("tokenizer*"))
    rng = np.random.default_rng(0)
    img_p, mask_p = str(tmp_path / "in.png"), str(tmp_path / "mask.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(img_p)
    m = np.zeros((64, 64), np.uint8)
    m[16:48, 8:56] = 255
    Image.fromarray(m).save(mask_p)
    out = tmp_path / "out.png"
    rc = main(["--compile-cache", "off",
        "--mode", "inpaint", "--image", img_p, "--mask", mask_p,
        "--text", "Hi", "--position", "8", "16",
        "--checkpoint-dir", ckpt, "--controlnet-mode", "3",
        "--size", "64", "--steps", "2", "--controlnet-step", "1",
        "--font-size", "24", "--output", str(out),
    ])
    assert rc == 0 and out.exists() and out.stat().st_size > 0


def test_ip_adapter_convert_and_attach(converted, tmp_path):
    """--ip-adapter conversion writes {proj, blocks}; attach_ip_adapter must
    merge the CONVERTED blocks into the resident flux params (regression:
    the blocks component used to be ignored -> random/zero adapter)."""
    from safetensors.numpy import save_file

    from reptext.configs import (
        CLIPConfig, CLIPVisionConfig, ControlNetConfig, FluxConfig,
        IPAdapterConfig, PipelineConfig, T5Config, VAEConfig,
    )
    from reptext.pipelines import FluxRepTextPipeline

    flux = converted["cfgs"][0]
    d, cd, ed, nt = flux.inner_dim, flux.joint_attention_dim, 32, 2
    r = np.random.default_rng(11)
    state = {
        "image_proj.proj.weight": r.standard_normal((nt * cd, ed)).astype(np.float32),
        "image_proj.proj.bias": np.zeros((nt * cd,), np.float32),
        "image_proj.norm.weight": np.ones((cd,), np.float32),
        "image_proj.norm.bias": np.zeros((cd,), np.float32),
    }
    for i in range(flux.num_layers):
        for nm in ("to_k_ip", "to_v_ip"):
            state[f"ip_adapter.{i}.{nm}.weight"] = (
                r.standard_normal((d, cd)).astype(np.float32))
            state[f"ip_adapter.{i}.{nm}.bias"] = (
                r.standard_normal((d,)).astype(np.float32))
    ip_path = str(tmp_path / "ip.safetensors")
    save_file(state, ip_path)

    out = str(tmp_path / "out_ip")
    rc = convert_cli.main([
        "--flux-dir", os.path.join(converted["pipe_dir"], "transformer"),
        "--ip-adapter", ip_path, "--out", out,
    ])
    assert rc == 0
    ip_params = load_pipeline_params(
        os.path.join(out, "ip_adapter"),
        components=("vision", "proj", "blocks", "flux"),
    )
    assert set(ip_params) == {"proj", "blocks"}

    pipe = FluxRepTextPipeline.create(
        flux_cfg=flux,
        cn_cfg=dataclasses.replace(converted["cfgs"][1], num_mode=None),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=64, width=64, num_inference_steps=2),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    pipe.attach_ip_adapter(
        vision_cfg=CLIPVisionConfig().tiny(), ip_cfg=IPAdapterConfig().tiny(),
        params=ip_params,
    )
    blk = pipe.params["flux"]["params"]["double_blocks"]["block"]
    # to_v_ip is RoPE-untouched: converted kernel == stacked weight^T exactly
    want_v = np.stack([state[f"ip_adapter.{i}.to_v_ip.weight"].T
                       for i in range(flux.num_layers)])
    np.testing.assert_allclose(np.asarray(blk["to_v_ip"]["kernel"]), want_v)
    # to_k_ip is permuted (RoPE fold) but must match the converter output
    np.testing.assert_allclose(
        np.asarray(blk["to_k_ip"]["kernel"]),
        np.asarray(ip_params["blocks"]["params"]["to_k_ip"]["kernel"]),
    )


def test_lora_bake_at_conversion(converted, tmp_path):
    """convert_cli --lora merges W += scale*(B@A)^T into the saved tree."""
    from safetensors.numpy import save_file

    flux = converted["cfgs"][0]
    r = np.random.default_rng(5)
    rank, d = 2, flux.inner_dim
    a = r.standard_normal((rank, flux.in_channels)).astype(np.float32)
    b = r.standard_normal((d, rank)).astype(np.float32)
    lora_path = str(tmp_path / "lora.safetensors")
    save_file({"transformer.x_embedder.lora_A.weight": a,
               "transformer.x_embedder.lora_B.weight": b}, lora_path)
    out = str(tmp_path / "baked")
    rc = convert_cli.main([
        "--flux-dir", os.path.join(converted["pipe_dir"], "transformer"),
        "--lora", lora_path, "--lora-scale", "0.5", "--out", out,
    ])
    assert rc == 0
    baked = load_pipeline_params(out, components=("flux",))["flux"]
    plain = load_pipeline_params(converted["out"], components=("flux",))["flux"]
    got = np.asarray(baked["params"]["x_embedder"]["kernel"])
    want = (np.asarray(plain["params"]["x_embedder"]["kernel"])
            + 0.5 * (b @ a).T)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    with pytest.raises(SystemExit):   # --lora without a transformer source
        convert_cli.main(["--controlnet-dir", converted["cn_dir"],
                          "--lora", lora_path, "--out", str(tmp_path / "x")])


def test_fp8_storage_matches_load_time_quantization(converted, tmp_path):
    """--dtype fp8 stores exactly what quantize_params produces from the
    bf16-cast weights — storage-time and load-time quantization agree
    bitwise."""
    import ml_dtypes

    from reptext.io.convert_cli import _cast_tree
    from reptext.io.quantize import QUANT_KEY, SCALE_KEY, is_quantized, quantize_params

    out = str(tmp_path / "fp8")
    rc = convert_cli.main([
        "--flux-dir", os.path.join(converted["pipe_dir"], "transformer"),
        "--dtype", "fp8", "--out", out,
    ])
    assert rc == 0
    stored = load_pipeline_params(out, components=("flux",))["flux"]
    assert is_quantized(stored)
    blk = stored["params"]["double_blocks"]["block"]["to_q"]
    assert set(blk) == {QUANT_KEY, SCALE_KEY, "bias"}
    assert np.asarray(blk[QUANT_KEY]).dtype == np.dtype(ml_dtypes.float8_e4m3fn)
    assert np.asarray(blk[SCALE_KEY]).dtype == np.dtype(ml_dtypes.bfloat16)
    # embedders outside the block stacks stay dense bf16
    emb = stored["params"]["x_embedder"]["kernel"]
    assert np.asarray(emb).dtype == np.dtype(ml_dtypes.bfloat16)

    plain = load_pipeline_params(converted["out"], components=("flux",))["flux"]
    ref = quantize_params(_cast_tree(plain, ml_dtypes.bfloat16)["params"])
    ref_blk = ref["double_blocks"]["block"]["to_q"]
    np.testing.assert_array_equal(
        np.asarray(blk[QUANT_KEY]).view(np.uint8),
        np.asarray(ref_blk[QUANT_KEY]).view(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(blk[SCALE_KEY]).view(np.uint16),
        np.asarray(ref_blk[SCALE_KEY]).view(np.uint16))


@pytest.mark.slow
def test_cli_generation_from_fp8_checkpoint_autodetect(converted, tmp_path):
    """An fp8-STORED checkpoint runs without any flag: the driver detects
    quantized storage and switches the models to weight_quant."""
    import shutil

    from reptext.cli import main

    out = str(tmp_path / "fp8full")
    rc = convert_cli.main([
        "--pipeline-dir", converted["pipe_dir"],
        "--controlnet-dir", converted["cn_dir"],
        "--dtype", "fp8", "--out", out,
    ])
    assert rc == 0
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(out, ckpt, ignore=shutil.ignore_patterns("tokenizer*"))
    png = tmp_path / "out.png"
    rc = main(["--compile-cache", "off",
        "--text", "Hi", "--position", "8", "16",
        "--checkpoint-dir", ckpt, "--controlnet-mode", "3",
        "--size", "64", "--steps", "2", "--controlnet-step", "1",
        "--font-size", "24", "--output", str(png),
    ])
    assert rc == 0 and png.exists() and png.stat().st_size > 0

    with pytest.raises(SystemExit):   # LoRA cannot merge into fp8 storage
        main(["--text", "a", "--position", "1", "2",
              "--checkpoint-dir", ckpt, "--lora", "/tmp/nope.safetensors"])
    with pytest.raises(SystemExit):   # training needs dense weights
        main(["--mode", "train", "--checkpoint-dir", ckpt,
              "--train-steps", "1"])


def test_load_saved_configs_missing_dir(tmp_path):
    assert load_saved_configs(str(tmp_path)) == {}


def test_nothing_to_convert_errors():
    with pytest.raises(SystemExit):
        convert_cli.main(["--out", "/tmp/nope"])
