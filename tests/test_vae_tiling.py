"""Tiled VAE encode/decode (ops/vae_tiling.py + pipeline enable_vae_tiling).

The tiling bounds the decoder's activations by the tile instead of the
image. These tests pin (a) the tiling math (coverage, weight
normalization, exact identity), (b) tiled-vs-full VAE numerics on a small
model, and (c) the pipeline integration end-to-end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import (
    CLIPConfig,
    ControlNetConfig,
    FluxConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
)
from reptext.nn.vae import AutoencoderKL
from reptext.ops.vae_tiling import (
    blend_weights_1d,
    tile_positions,
    tiled_apply,
)


def test_tile_positions_cover_grid():
    for size, tile, stride in [(128, 64, 48), (128, 48, 32), (100, 64, 48),
                               (64, 64, 48), (40, 64, 48), (130, 64, 48)]:
        pos = tile_positions(size, tile, stride)
        covered = np.zeros(size, bool)
        for p in pos:
            assert p >= 0
            assert p + tile >= size or p + tile <= size
            covered[p:p + tile] = True
        assert covered.all(), (size, tile, stride, pos)
        if tile < size:
            assert pos[-1] == size - tile  # clamped: one program signature


def test_blend_weights_positive_and_interior_one():
    w = blend_weights_1d(64, 16, 48, 128)   # interior tile: ramps both sides
    assert (w > 0).all()
    assert (w[16:-16] == 1.0).all()
    assert w[0] == pytest.approx(1.0 / 17.0)
    w0 = blend_weights_1d(64, 16, 0, 128)   # left-border tile: no left ramp
    assert (w0[:16] == 1.0).all()
    wl = blend_weights_1d(64, 16, 64, 128)  # right-border tile: no right ramp
    assert (wl[-16:] == 1.0).all()


def test_tiled_identity_is_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 80, 112, 3)).astype(np.float32)
    out = tiled_apply(lambda t, i: t, x, 48, 16, 1, 1, 3)
    np.testing.assert_allclose(out, x, rtol=0, atol=1e-6)


def test_tiled_scaled_map_is_exact():
    # x8 upsampling map (nearest repeat): blending convexity must be exact
    # for any per-pixel-consistent map
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 24, 24, 2)).astype(np.float32)
    fn = lambda t, i: np.repeat(np.repeat(t, 8, axis=1), 8, axis=2)  # noqa: E731
    out = tiled_apply(fn, x, 16, 8, 8, 1, 2)
    np.testing.assert_allclose(
        out, np.repeat(np.repeat(x, 8, axis=1), 8, axis=2), atol=1e-5)


@pytest.fixture(scope="module")
def small_vae():
    cfg = VAEConfig().tiny()
    vae = AutoencoderKL(cfg)
    params = vae.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, 8 * cfg.scale_factor, 8 * cfg.scale_factor, 3)))
    return cfg, vae, params


def test_tiled_decode_matches_full(small_vae):
    cfg, vae, params = small_vae
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 48, 48, cfg.latent_channels)).astype(np.float32)

    full = np.asarray(vae.apply(params, jnp.asarray(lat), method="decode"))
    fn = lambda t, i: vae.apply(params, jnp.asarray(t), method="decode")  # noqa: E731
    # production ratio (pipeline default 64/16 at 128 latent): tile/2, grid/2
    tiled = tiled_apply(fn, lat, 32, 8, cfg.scale_factor, 1, cfg.out_channels)
    assert tiled.shape == full.shape
    # convs/GroupNorm see per-tile context: not bitwise, but close — seam
    # error must stay a small fraction of the output scale (random weights,
    # so thresholds are relative to the decode's own std)
    d = np.abs(tiled - full)
    std = full.std()
    assert d.mean() < 0.1 * std, (d.mean(), std)
    assert np.percentile(d, 99) < 0.4 * std
    assert d.max() < 1.5 * std


def test_tiled_encode_matches_full_mode(small_vae):
    cfg, vae, params = small_vae
    rng = np.random.default_rng(3)
    f = cfg.scale_factor
    img = rng.uniform(-1, 1, (1, 24 * f, 24 * f, 3)).astype(np.float32)

    full = np.asarray(vae.apply(params, jnp.asarray(img), None, method="encode"))
    fn = lambda t, i: vae.apply(params, jnp.asarray(t), None, method="encode")  # noqa: E731
    tiled = tiled_apply(fn, img, 16 * f, 8 * f, 1, f, cfg.latent_channels)
    assert tiled.shape == full.shape
    assert np.abs(tiled - full).mean() < 0.2


@pytest.mark.slow
def test_pipeline_with_vae_tiling_end_to_end():
    """Tiled pipeline produces images agreeing with the untiled pipeline."""
    from reptext.conditioning import TextLine, build_conditions
    from reptext.pipelines import FluxRepTextPipeline

    H = W = 128   # latent 16x16; tile 8 + overlap 4 -> tiled both paths
    pipe_cfg = PipelineConfig(
        height=H, width=W, num_inference_steps=2,
        controlnet_conditioning_step=1, guidance_scale=3.5,
    )
    kw = dict(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(), pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    pipe = FluxRepTextPipeline.create(**kw)
    conds = build_conditions([TextLine("Hi", (16, 32), font_size=24)],
                             width=W, height=H)
    clip_ids = jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32)
    t5_ids = jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32)
    base = pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=42)

    tiled_pipe = dataclasses.replace(pipe)     # shares params
    tiled_pipe.enable_vae_tiling(tile_latent=8, overlap_latent=4)
    tiled = tiled_pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=42)

    assert tiled.shape == base.shape
    # uint8 pixel space: identical trajectory, only the VAE boundary-context
    # differs. Per-tile encode rng makes cond latents differ slightly too,
    # so compare loosely but meaningfully.
    diff = np.abs(tiled.astype(np.int32) - base.astype(np.int32))
    assert diff.mean() < 24.0, diff.mean()


def test_enable_vae_tiling_validates():
    from reptext.pipelines import FluxRepTextPipeline

    pipe = FluxRepTextPipeline.__new__(FluxRepTextPipeline)
    with pytest.raises(ValueError):
        FluxRepTextPipeline.enable_vae_tiling(pipe, 8, 8)
