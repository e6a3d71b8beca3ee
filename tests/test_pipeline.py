"""Tiny-config end-to-end pipeline test: conditions -> sampler -> image."""

import jax
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
from reptext.pipelines import FluxRepTextPipeline

H = W = 64  # latent 8x8 -> 16 tokens


@pytest.fixture(scope="module")
def pipeline():
    pipe_cfg = PipelineConfig(
        height=H, width=W, num_inference_steps=2, controlnet_conditioning_step=1,
        guidance_scale=3.5,
    )
    return FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(),
        cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(),
        t5_cfg=T5Config().tiny(),
    )


@pytest.fixture(scope="module")
def conditions():
    return build_conditions(
        [TextLine("Hi", (8, 16), font_size=24)], width=W, height=H
    )


@pytest.mark.smoke
def test_end_to_end_generation(pipeline, conditions):
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    images = pipeline(
        conditions, clip_ids=clip_ids, t5_ids=t5_ids, seed=42, num_images=1
    )
    assert images.shape == (1, H, W, 3)
    assert images.dtype == np.uint8
    assert np.isfinite(images.astype(np.float64)).all()


def test_generation_deterministic_per_seed(pipeline, conditions):
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids, num_images=1)
    a = pipeline(seed=42, **kw)
    b = pipeline(seed=42, **kw)
    c = pipeline(seed=43, **kw)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_latent_output_type(pipeline, conditions):
    clip_ids = jnp.asarray([[3, 255, 0, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 1, 0, 0, 0, 0]], jnp.int32)
    lat = pipeline(
        conditions, clip_ids=clip_ids, t5_ids=t5_ids, output_type="latent"
    )
    assert lat.shape == (1, 16, 4 * VAEConfig().tiny().latent_channels)


def test_multiline_conditions(pipeline):
    conds = build_conditions(
        [TextLine("A", (6, 10), font_size=20), TextLine("B", (30, 34), font_size=20)],
        width=W, height=H,
    )
    clip_ids = jnp.asarray([[3, 255, 0, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 1, 0, 0, 0, 0]], jnp.int32)
    images = pipeline(conds, clip_ids=clip_ids, t5_ids=t5_ids)
    assert images.shape == (1, H, W, 3)


def test_generate_batch_matches_individual_calls(pipeline, conditions):
    """Coalesced cross-request batching (serving path): one fused sampler
    call with per-image conds must reproduce per-request results."""
    conds_b = build_conditions(
        [TextLine("Yo", (4, 8), font_size=20)], width=W, height=H
    )
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0],
                            [2, 11, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0],
                          [4, 2, 1, 0, 0, 0]], jnp.int32)

    batched = pipeline.generate_batch(
        [conditions, conds_b], clip_ids=clip_ids, t5_ids=t5_ids, seeds=[7, 13],
        output_type="latent",
    )
    single_a = pipeline(conditions, clip_ids=clip_ids[:1], t5_ids=t5_ids[:1],
                        seed=7, output_type="latent")
    single_b = pipeline(conds_b, clip_ids=clip_ids[1:], t5_ids=t5_ids[1:],
                        seed=13, output_type="latent")

    np.testing.assert_allclose(np.asarray(batched[0]), np.asarray(single_a[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(batched[1]), np.asarray(single_b[0]),
                               rtol=2e-4, atol=2e-4)


def test_generate_batch_rejects_mismatched_lines(pipeline, conditions):
    conds_two = build_conditions(
        [TextLine("A", (4, 8), font_size=20), TextLine("B", (24, 32), font_size=20)],
        width=W, height=H,
    )
    clip_ids = jnp.zeros((2, 8), jnp.int32)
    t5_ids = jnp.zeros((2, 6), jnp.int32)
    with pytest.raises(ValueError, match="num_lines"):
        pipeline.generate_batch([conditions, conds_two], clip_ids=clip_ids,
                                t5_ids=t5_ids, seeds=[1, 2])


def test_explicit_latents_override(pipeline, conditions):
    """`latents=` kwarg (reference pipeline_flux_controlnet.py:768): caller-
    provided packed noise makes the seed irrelevant — identical outputs from
    different seeds, different from the seed-derived run."""
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids,
              num_images=1, output_type="latent")
    noise = jax.random.normal(
        jax.random.PRNGKey(123),
        (1, 16, 4 * VAEConfig().tiny().latent_channels),
    )
    a = pipeline(seed=1, latents=noise, **kw)
    b = pipeline(seed=2, latents=noise, **kw)
    c = pipeline(seed=1, **kw)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (np.asarray(a) != np.asarray(c)).any()


def test_num_images_batch(pipeline, conditions):
    """num_images>1 (reference num_images_per_prompt): the text stream is
    tiled to the image batch — previously crashed the scan with a carry
    shape mismatch."""
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    lat = np.asarray(pipeline(
        conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids,
        num_images=2, seed=11, output_type="latent"))
    assert lat.shape[0] == 2 and np.isfinite(lat).all()
    # independent noise per image: the two samples must differ
    assert np.abs(lat[0] - lat[1]).max() > 0


def test_explicit_latents_shape_validated(pipeline, conditions):
    """Wrong-shape `latents=` must fail fast with an actionable message, not
    deep inside the jitted scan (reference check_inputs parity)."""
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids,
              num_images=1, output_type="latent")
    c = VAEConfig().tiny().latent_channels
    unpacked = jax.random.normal(  # [B, C, H/2, W/2] — not packed
        jax.random.PRNGKey(0), (1, c, 8, 8))
    with pytest.raises(ValueError, match="PACKED"):
        pipeline(seed=1, latents=unpacked, **kw)
    wrong_seq = jax.random.normal(jax.random.PRNGKey(0), (1, 32, 4 * c))
    with pytest.raises(ValueError, match="PACKED"):
        pipeline(seed=1, latents=wrong_seq, **kw)


@pytest.mark.smoke
def test_custom_sigmas_matches_default_schedule(pipeline, conditions):
    """Passing the pipeline's own linspace as `sigmas=` must reproduce the
    default schedule bit-for-bit (reference retrieve_timesteps default path,
    RepText/pipeline_flux_controlnet.py:948-967)."""
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids,
              seed=42, output_type="latent")
    default = np.asarray(pipeline(num_inference_steps=2, **kw))
    custom = np.asarray(pipeline(sigmas=np.linspace(1.0, 0.5, 2), **kw))
    np.testing.assert_allclose(custom, default, rtol=1e-5, atol=1e-6)


def test_custom_timesteps_runs_and_differs(pipeline, conditions):
    """A 3-point distillation-style timestep grid: runs through one fused
    sampler, overrides steps, and differs from the 2-step default."""
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids,
              seed=42, output_type="latent")
    lat = np.asarray(pipeline(timesteps=[950.0, 600.0, 200.0], **kw))
    assert lat.shape == (1, 16, 4 * VAEConfig().tiny().latent_channels)
    assert np.isfinite(lat).all()
    default = np.asarray(pipeline(num_inference_steps=2, **kw))
    assert np.abs(lat - default).max() > 0
    with pytest.raises(ValueError, match="Only one of"):
        pipeline(timesteps=[500.0], sigmas=[0.5], **kw)


def test_pil_output_and_return_dict(pipeline, conditions):
    """output_type='pil' + return_dict: the reference's public return contract
    (FluxPipelineOutput with PIL images, pipeline_flux_controlnet.py:1132-1148)."""
    from PIL import Image

    from reptext.pipelines import FluxPipelineOutput

    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    kw = dict(conditions=conditions, clip_ids=clip_ids, t5_ids=t5_ids, seed=42)
    out = pipeline(output_type="pil", return_dict=True, **kw)
    assert isinstance(out, FluxPipelineOutput)
    assert isinstance(out.images, list) and len(out.images) == 1
    assert isinstance(out.images[0], Image.Image)
    assert out.images[0].size == (W, H)
    # tuple-style unpacking parity with return_dict=False in the reference
    (images,) = out
    assert images is out.images
    # PIL pixels match the np output exactly
    np_imgs = pipeline(output_type="np", **kw)
    np.testing.assert_array_equal(np.asarray(out.images[0]), np_imgs[0])
