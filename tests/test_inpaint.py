"""Inpaint pipeline tests: dual ControlNet + CFG at tiny config."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import (
    CLIPConfig,
    ControlNetConfig,
    FluxConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
)
from reptext.conditioning import TextLine, build_conditions
from reptext.pipelines import FluxRepTextInpaintPipeline

H = W = 64


@pytest.fixture(scope="module")
def pipeline():
    pipe_cfg = PipelineConfig(
        height=H, width=W, num_inference_steps=2, controlnet_conditioning_step=1,
        true_guidance_scale=3.0,
    )
    inpaint_cfg = dataclasses.replace(
        ControlNetConfig().tiny(), extra_condition_channels=4
    )
    return FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=inpaint_cfg,
        flux_cfg=FluxConfig().tiny(),
        cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(),
        t5_cfg=T5Config().tiny(),
    )


@pytest.mark.smoke
def test_inpaint_end_to_end(pipeline):
    conds = build_conditions([TextLine("X", (20, 20), font_size=24)], W, H)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255

    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    neg_clip = jnp.asarray([[2, 255, 0, 0, 0, 0, 0, 0]], jnp.int32)
    neg_t5 = jnp.asarray([[4, 1, 0, 0, 0, 0]], jnp.int32)

    out = pipeline(
        conds, image=image, mask=mask,
        clip_ids=clip_ids, t5_ids=t5_ids,
        negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
        seed=42,
    )
    assert out.shape == (1, H, W, 3)
    assert out.dtype == np.uint8


def test_inpaint_num_images_batch(pipeline):
    """num_images>1 (reference num_images_per_prompt,
    RepText/pipeline_flux_controlnet_inpaint.py:373-377): both CFG halves and
    the 68-feat inpaint conditioning tile to the image batch."""
    conds = build_conditions([TextLine("X", (20, 20), font_size=24)], W, H)
    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    lat = np.asarray(pipeline(
        conds, image=image, mask=mask,
        clip_ids=jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32),
        t5_ids=jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32),
        negative_clip_ids=jnp.asarray([[2, 255, 0, 0, 0, 0, 0, 0]], jnp.int32),
        negative_t5_ids=jnp.asarray([[4, 1, 0, 0, 0, 0]], jnp.int32),
        seed=11, num_images=2, output_type="latent",
    ))
    assert lat.shape[0] == 2 and np.isfinite(lat).all()
    # independent noise per image: the two edits must differ
    assert np.abs(lat[0] - lat[1]).max() > 0


def test_inpaint_cond_shape(pipeline):
    import jax

    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.float32)
    mask[:32] = 1.0
    cond = pipeline.prepare_inpaint_cond(image, mask, jax.random.PRNGKey(0))
    # 17 channels * 2x2 patch = 68 features per token; 8x8 latent -> 16 tokens
    assert cond.shape == (1, 16, 68)


def test_inpaint_requires_image_and_mask(pipeline):
    conds = build_conditions([TextLine("X", (20, 20), font_size=24)], W, H)
    with pytest.raises(ValueError):
        pipeline(conds)


@pytest.mark.smoke
def test_inpaint_velocity_cache(pipeline):
    """Inpaint sampler honors velocity_cache_interval ("reuse" mode): cached
    and uncached runs agree at the warmup prefix semantics (finite, same
    shape, mildly divergent), and interval=1 reproduces the fixture pipeline
    exactly."""
    conds = build_conditions([TextLine("X", (20, 20), font_size=24)], W, H)
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    kw = dict(
        conds=conds, image=image, mask=mask,
        clip_ids=jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32),
        t5_ids=jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32),
        negative_clip_ids=jnp.asarray([[2, 255, 0, 0, 0, 0, 0, 0]], jnp.int32),
        negative_t5_ids=jnp.asarray([[4, 1, 0, 0, 0, 0]], jnp.int32),
        seed=7,
    )

    def build(steps, interval, **cache_kw):
        cfg = dataclasses.replace(
            pipeline.pipe_cfg, num_inference_steps=steps,
            controlnet_conditioning_step=steps,
            velocity_cache_interval=interval, velocity_cache_warmup=1,
            **cache_kw,
        )
        return FluxRepTextInpaintPipeline.create_inpaint(
            inpaint_cn_cfg=pipeline.inpaint_controlnet.config,
            flux_cfg=pipeline.flux.config, cn_cfg=pipeline.controlnet.config,
            vae_cfg=pipeline.vae.config, pipe_cfg=cfg,
            clip_cfg=pipeline.clip.config, t5_cfg=pipeline.t5.config,
            params=pipeline.params,
        )

    rest = {k: v for k, v in kw.items() if k != "conds"}
    base = build(4, 1)(kw["conds"], **rest)
    cached = build(4, 2)(kw["conds"], **rest)
    assert base.shape == cached.shape == (1, H, W, 3)
    assert np.isfinite(base.astype(np.float64)).all()
    assert np.isfinite(cached.astype(np.float64)).all()
    diff = np.abs(base.astype(np.int32) - cached.astype(np.int32))
    assert diff.max() > 0      # caching changed the trajectory
    assert diff.mean() < 64    # but did not diverge

    # adaptive mode: threshold=0 always computes -> same trajectory as
    # uncached. Tolerance 1: the lax.cond wrapper shifts XLA fusion
    # boundaries, and a handful of pixels land on the other side of the
    # uint8 rounding boundary (measured: 4/12288 off by exactly 1).
    always = build(4, 1, velocity_cache_mode="adaptive",
                   velocity_cache_threshold=0.0)(kw["conds"], **rest)
    d1 = np.abs(base.astype(np.int32) - always.astype(np.int32))
    assert d1.max() <= 1 and (d1 > 0).mean() < 0.01
    skippy = build(4, 1, velocity_cache_mode="adaptive",
                   velocity_cache_threshold=1e9,
                   velocity_cache_max_skip=2)(kw["conds"], **rest)
    d2 = np.abs(base.astype(np.int32) - skippy.astype(np.int32))
    assert d2.max() > 0 and d2.mean() < 64

    # linear mode: skipped steps extrapolate from the last two computed CFG
    # velocities — a third distinct trajectory (differs from both uncached
    # and reuse-cached), still bounded
    linear = build(4, 2, velocity_cache_mode="linear")(kw["conds"], **rest)
    d3 = np.abs(base.astype(np.int32) - linear.astype(np.int32))
    d4 = np.abs(cached.astype(np.int32) - linear.astype(np.int32))
    assert d3.max() > 0 and d4.max() > 0
    assert d3.mean() < 64


def test_inpaint_generate_batch_matches_individual(pipeline):
    """Coalesced cross-request inpaint batching (serving path): one fused
    dual-CN CFG sampler call with per-image conds must reproduce per-request
    results (mirror of the txt2img generate_batch parity test)."""
    rng = np.random.default_rng(1)
    conds_a = build_conditions([TextLine("Hi", (8, 16), font_size=24)], W, H)
    conds_b = build_conditions([TextLine("Yo", (24, 32), font_size=24)], W, H)
    img_a = rng.integers(0, 255, (H, W, 3), np.uint8)
    img_b = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask_a = np.zeros((H, W), np.uint8); mask_a[8:40, 8:40] = 255
    mask_b = np.zeros((H, W), np.uint8); mask_b[24:56, 16:48] = 255

    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0],
                            [2, 11, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0],
                          [4, 2, 1, 0, 0, 0]], jnp.int32)
    neg_clip = jnp.asarray([[2, 255, 0, 0, 0, 0, 0, 0],
                            [2, 255, 0, 0, 0, 0, 0, 0]], jnp.int32)
    neg_t5 = jnp.asarray([[4, 1, 0, 0, 0, 0],
                          [4, 1, 0, 0, 0, 0]], jnp.int32)

    batched = pipeline.generate_batch(
        [conds_a, conds_b], [img_a, img_b], [mask_a, mask_b],
        clip_ids=clip_ids, t5_ids=t5_ids,
        negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
        seeds=[7, 13], output_type="latent",
    )
    single_a = pipeline(
        conds_a, image=img_a, mask=mask_a,
        clip_ids=clip_ids[:1], t5_ids=t5_ids[:1],
        negative_clip_ids=neg_clip[:1], negative_t5_ids=neg_t5[:1],
        seed=7, output_type="latent",
    )
    single_b = pipeline(
        conds_b, image=img_b, mask=mask_b,
        clip_ids=clip_ids[1:], t5_ids=t5_ids[1:],
        negative_clip_ids=neg_clip[1:], negative_t5_ids=neg_t5[1:],
        seed=13, output_type="latent",
    )
    np.testing.assert_allclose(np.asarray(batched[0]), np.asarray(single_a[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(batched[1]), np.asarray(single_b[0]),
                               rtol=2e-4, atol=2e-4)


def test_inpaint_generate_batch_rejects_mismatched_lines(pipeline):
    conds_a = build_conditions([TextLine("A", (8, 16), font_size=24)], W, H)
    conds_b = build_conditions(
        [TextLine("A", (8, 16), font_size=24), TextLine("B", (24, 40), font_size=20)],
        W, H)
    img = np.zeros((H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.uint8)
    ids = jnp.zeros((2, 4), jnp.int32)
    with pytest.raises(ValueError, match="num_lines"):
        pipeline.generate_batch(
            [conds_a, conds_b], [img, img], [mask, mask],
            clip_ids=ids, t5_ids=ids, negative_clip_ids=ids,
            negative_t5_ids=ids, seeds=[1, 2])
