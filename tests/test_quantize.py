"""fp8 weight-only storage (reptext/io/quantize.py).

Full FLUX.1-dev + RepText CN is ~24 GB bf16; fp8-e4m3 storage with
per-channel scales halves the weight bytes while the matmuls stay bf16. These tests pin the storage format, the
error bound, the scan-sliced dequantization inside both models, and the
pipeline switch. Reference scale facts: RepText/controlnet_flux.py:182-214
(4+10 CN), diffusers FluxTransformer2D 19+38 (imported at
RepText/controlnet_flux.py:29).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.io.quantize import (
    QUANT_KEY,
    SCALE_KEY,
    dequantize_collection,
    dequantize_kernel,
    quantize_kernel,
    quantize_params,
    quantized_bytes,
)
from reptext.models import FluxTransformer2D, RepTextControlNet


def _flux_inputs(cfg, batch=1, s_img=16, s_txt=8, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        hidden_states=jnp.asarray(
            rng.standard_normal((batch, s_img, cfg.in_channels)), jnp.bfloat16),
        encoder_hidden_states=jnp.asarray(
            rng.standard_normal((batch, s_txt, cfg.joint_attention_dim)),
            jnp.bfloat16),
        pooled_projections=jnp.asarray(
            rng.standard_normal((batch, cfg.pooled_projection_dim)),
            jnp.bfloat16),
        timestep=jnp.asarray([0.5] * batch),
        img_ids=jnp.zeros((s_img, 3)),
        txt_ids=jnp.zeros((s_txt, 3)),
        guidance=jnp.asarray([3.5] * batch),
    )


def test_quantize_kernel_roundtrip_error():
    rng = np.random.default_rng(0)
    # per-channel magnitudes spanning 3 orders of magnitude: per-channel
    # scaling must hold the relative error where a per-tensor scale cannot
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w *= np.logspace(-2, 1, 48)[None, :].astype(np.float32)
    q, s = quantize_kernel(jnp.asarray(w))
    assert q.dtype == jnp.float8_e4m3fn
    assert s.dtype == jnp.bfloat16
    assert s.shape == (1, 48)
    back = np.asarray(dequantize_kernel(q, s), np.float32)
    rel = np.abs(back - w).mean() / np.abs(w).mean()
    assert rel < 0.04, rel
    # per-column relative error is uniform despite the magnitude spread
    col_rel = np.abs(back - w).mean(0) / np.abs(w).mean(0)
    assert col_rel.max() < 0.08, col_rel.max()


def test_quantize_kernel_stacked_layer_axis():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((3, 8, 5)).astype(np.float32))
    q, s = quantize_kernel(w)
    assert q.shape == (3, 8, 5)
    assert s.shape == (3, 1, 5)
    # slicing the stacked axis (what nn.scan does) commutes with dequant
    per_layer = dequantize_kernel(q[1], s[1])
    stacked = dequantize_kernel(q, s)[1]
    np.testing.assert_array_equal(np.asarray(per_layer), np.asarray(stacked))


def test_dequantize_collection_idempotent_and_inverse():
    tree = {
        "block": {"kernel": jnp.ones((4, 4)), "bias": jnp.zeros((4,))},
        "norm": {"weight": jnp.ones((4,))},
    }
    # unquantized trees pass through untouched
    out = dequantize_collection(tree)
    assert set(out) == {"block", "norm"}
    np.testing.assert_array_equal(np.asarray(out["block"]["kernel"]), 1.0)
    # quantized trees come back with 'kernel' restored
    q = quantize_params(tree, subtrees=None)
    assert QUANT_KEY in q["block"] and SCALE_KEY in q["block"]
    assert "kernel" not in q["block"]
    back = dequantize_collection(q)
    assert "kernel" in back["block"] and QUANT_KEY not in back["block"]
    np.testing.assert_allclose(
        np.asarray(back["block"]["kernel"], np.float32), 1.0)


def test_flux_forward_fp8_close_and_smaller():
    cfg = FluxConfig().tiny()
    model = FluxTransformer2D(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    inp = _flux_inputs(cfg)
    v = model.init(jax.random.PRNGKey(0), **inp)
    y0 = np.asarray(model.apply(v, **inp), np.float32)

    pq = quantize_params(v["params"])
    mq = FluxTransformer2D(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                           weight_quant=True)
    y1 = np.asarray(mq.apply({"params": pq}, **inp), np.float32)
    rel = np.abs(y1 - y0).mean() / np.abs(y0).mean()
    assert rel < 0.10, rel

    stored, bf16 = quantized_bytes(pq)
    # block-stack kernels dominate: storage must land well under bf16 size
    assert stored < 0.62 * bf16, (stored, bf16)


@pytest.mark.slow  # a full extra tiny-FLUX compile; the invariant is also
# exercised e2e by the pre-quantized-checkpoint CLI tests (slow tier)
def test_flux_weight_quant_flag_accepts_unquantized_params():
    """dequantize_collection is idempotent, so a weight_quant model applied
    to plain bf16 params is bit-identical to the plain model (one pipeline
    code path can serve both)."""
    cfg = FluxConfig().tiny()
    inp = _flux_inputs(cfg, seed=2)
    model = FluxTransformer2D(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    v = model.init(jax.random.PRNGKey(1), **inp)
    mq = FluxTransformer2D(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                           weight_quant=True)
    np.testing.assert_array_equal(
        np.asarray(model.apply(v, **inp)), np.asarray(mq.apply(v, **inp)))


def test_controlnet_fp8_forward_and_zero_init_preserved():
    cfg = ControlNetConfig().tiny()
    cn = RepTextControlNet(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    rng = np.random.default_rng(3)
    s_img, s_txt = 16, 8
    hidden = jnp.asarray(rng.standard_normal((1, s_img, cfg.in_channels)),
                         jnp.bfloat16)
    cond = jnp.asarray(
        rng.standard_normal(
            (1, s_img, cfg.in_channels + cfg.extra_condition_channels)),
        jnp.bfloat16)
    ctx = jnp.asarray(rng.standard_normal((1, s_txt, cfg.joint_attention_dim)),
                      jnp.bfloat16)
    pooled = jnp.asarray(rng.standard_normal((1, cfg.pooled_projection_dim)),
                         jnp.bfloat16)
    args = (hidden, cond, ctx, pooled, jnp.asarray([0.5]),
            jnp.zeros((s_img, 3)), jnp.zeros((s_txt, 3)), jnp.asarray([3.5]))
    v = cn.init(jax.random.PRNGKey(2), *args)
    b0, s0 = cn.apply(v, *args)

    pq = quantize_params(v["params"])
    cq = RepTextControlNet(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                           weight_quant=True)
    b1, s1 = cq.apply({"params": pq}, *args)
    # zero-init residual heads quantize to exactly zero: the quantized
    # ControlNet is still a no-op at init (RepText/controlnet_flux.py:112-114)
    np.testing.assert_array_equal(np.asarray(b1), 0.0)
    np.testing.assert_array_equal(np.asarray(s1), 0.0)
    np.testing.assert_array_equal(np.asarray(b0), np.asarray(b1))


@pytest.mark.slow
def test_pipeline_quantize_weights_smoke():
    from reptext.conditioning import TextLine, build_conditions
    from reptext.configs import (
        CLIPConfig, PipelineConfig, T5Config, VAEConfig,
    )
    from reptext.pipelines.txt2img import FluxRepTextPipeline

    pipe_cfg = dataclasses.replace(
        PipelineConfig(), height=64, width=64, num_inference_steps=2,
        controlnet_conditioning_step=2)
    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(), pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
        compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    pipe.quantize_weights()
    assert pipe.flux.weight_quant and pipe.controlnet.weight_quant
    flat = jax.tree_util.tree_flatten_with_path(pipe.params["flux"])[0]
    assert any(QUANT_KEY in str(p) for p, _ in flat)
    conds = build_conditions(
        [TextLine("Hi", (8, 16), font_size=24)], width=64, height=64)
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    img = pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=0)
    assert np.isfinite(np.asarray(img, np.float64)).all()
