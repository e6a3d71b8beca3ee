"""img2img strength + chunked callback/interrupt tests (tiny pipeline)."""

import jax.numpy as jnp
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.conditioning import TextLine, build_conditions
from reptext.pipelines import FluxRepTextPipeline

H = W = 64


@pytest.fixture(scope="module")
def pipeline():
    pipe_cfg = PipelineConfig(
        height=H, width=W, num_inference_steps=4, controlnet_conditioning_step=2,
    )
    return FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(), pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )


@pytest.fixture(scope="module")
def conditions():
    return build_conditions([TextLine("Hi", (8, 16), font_size=24)], W, H)


IDS = dict(
    clip_ids=jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32),
    t5_ids=jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32),
)


def test_img2img_strength(pipeline, conditions):
    init = np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8)
    out = pipeline(conditions, **IDS, init_image=init, strength=0.5, seed=1)
    assert out.shape == (1, H, W, 3)
    # strength=0.5 with 4 steps -> start at t=2: fewer steps, different result
    full = pipeline(conditions, **IDS, seed=1)
    assert (out != full).any()


def test_callback_invoked_and_chunked_matches_fused(pipeline, conditions):
    calls = []

    def cb(i, latents):
        calls.append(i)

    chunked = pipeline(conditions, **IDS, seed=7, callback=cb, callback_steps=2,
                       output_type="latent")
    assert calls == [2, 4]
    fused = pipeline(conditions, **IDS, seed=7, output_type="latent")
    np.testing.assert_allclose(
        np.asarray(chunked), np.asarray(fused), rtol=2e-4, atol=2e-4)


def test_callback_interrupt(pipeline, conditions):
    def cb(i, latents):
        return False  # abort after first chunk

    out = pipeline(conditions, **IDS, seed=3, callback=cb, callback_steps=1,
                   output_type="latent")
    # aborted after 1 of 4 steps; must differ from the full run
    full = pipeline(conditions, **IDS, seed=3, output_type="latent")
    assert np.abs(np.asarray(out) - np.asarray(full)).max() > 1e-4
