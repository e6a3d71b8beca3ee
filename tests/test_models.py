"""Tiny-config model tests: shapes, determinism, zero-init ControlNet no-op,
residual injection plumbing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.ops.latents import prepare_latent_image_ids

B, S_TXT, S_IMG = 2, 6, 16  # 8x8 latent -> 4x4 tokens
FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()


def _flux_inputs(rng=0):
    r = np.random.default_rng(rng)
    return dict(
        hidden_states=jnp.asarray(r.standard_normal((B, S_IMG, FLUX_CFG.in_channels)), jnp.float32),
        encoder_hidden_states=jnp.asarray(
            r.standard_normal((B, S_TXT, FLUX_CFG.joint_attention_dim)), jnp.float32),
        pooled_projections=jnp.asarray(
            r.standard_normal((B, FLUX_CFG.pooled_projection_dim)), jnp.float32),
        timestep=jnp.full((B,), 0.5),
        img_ids=prepare_latent_image_ids(8, 8),
        txt_ids=jnp.zeros((S_TXT, 3)),
        guidance=jnp.full((B,), 3.5),
    )


@pytest.fixture(scope="module")
def flux_and_params():
    model = FluxTransformer2D(FLUX_CFG)
    params = model.init(jax.random.PRNGKey(0), **_flux_inputs())
    return model, params


@pytest.fixture(scope="module")
def cn_and_params():
    model = RepTextControlNet(CN_CFG)
    inputs = _flux_inputs()
    inputs["controlnet_cond"] = jnp.ones(
        (B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels), jnp.float32)
    params = model.init(jax.random.PRNGKey(1), **inputs)
    return model, params, inputs


def test_flux_forward_shape(flux_and_params):
    model, params = flux_and_params
    out = model.apply(params, **_flux_inputs())
    assert out.shape == (B, S_IMG, FLUX_CFG.out_channels)
    assert jnp.isfinite(out).all()


def test_flux_deterministic(flux_and_params):
    model, params = flux_and_params
    a = model.apply(params, **_flux_inputs())
    b = model.apply(params, **_flux_inputs())
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_flux_scan_param_stacking(flux_and_params):
    _, params = flux_and_params
    p = params["params"]
    # double blocks stacked on axis 0 with depth num_layers
    kernel = p["double_blocks"]["block"]["to_q"]["kernel"]
    assert kernel.shape[0] == FLUX_CFG.num_layers
    kernel_s = p["single_blocks"]["block"]["to_q"]["kernel"]
    assert kernel_s.shape[0] == FLUX_CFG.num_single_layers


def test_controlnet_zero_init_residuals(cn_and_params):
    model, params, inputs = cn_and_params
    block, single = model.apply(params, **inputs)
    assert block.shape == (CN_CFG.num_layers, B, S_IMG, CN_CFG.inner_dim)
    assert single.shape == (CN_CFG.num_single_layers, B, S_IMG, CN_CFG.inner_dim)
    # zero-init projection heads -> exactly zero residuals at init
    np.testing.assert_array_equal(np.asarray(block), 0.0)
    np.testing.assert_array_equal(np.asarray(single), 0.0)


def test_controlnet_nonzero_after_param_perturbation(cn_and_params):
    model, params, inputs = cn_and_params
    params2 = jax.tree_util.tree_map(lambda x: x + 0.01, params)
    block, single = model.apply(params2, **inputs)
    assert np.abs(np.asarray(block)).max() > 0
    assert np.abs(np.asarray(single)).max() > 0


def test_controlnet_conditioning_scale(cn_and_params):
    model, params, inputs = cn_and_params
    params2 = jax.tree_util.tree_map(lambda x: x + 0.01, params)
    b1, s1 = model.apply(params2, **inputs, conditioning_scale=1.0)
    b2, s2 = model.apply(params2, **inputs, conditioning_scale=0.5)
    np.testing.assert_allclose(np.asarray(b2), 0.5 * np.asarray(b1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s2), 0.5 * np.asarray(s1), rtol=1e-5)


def test_flux_residual_injection_changes_output(flux_and_params):
    model, params = flux_and_params
    inputs = _flux_inputs()
    base = model.apply(params, **inputs)
    # zero residuals: output unchanged
    zeros_d = jnp.zeros((CN_CFG.num_layers, B, S_IMG, FLUX_CFG.inner_dim))
    zeros_s = jnp.zeros((CN_CFG.num_single_layers, B, S_IMG, FLUX_CFG.inner_dim))
    same = model.apply(
        params, **inputs,
        controlnet_block_samples=zeros_d, controlnet_single_block_samples=zeros_s)
    np.testing.assert_allclose(np.asarray(base), np.asarray(same), atol=1e-5)
    # nonzero (non-constant) residuals: output changes. NB a constant residual
    # is provably a no-op: LayerNorm subtracts the feature mean, so only the
    # varying component of an injection can influence the output.
    noise_d = jax.random.normal(jax.random.PRNGKey(5), zeros_d.shape) * 0.1
    diff = model.apply(
        params, **inputs,
        controlnet_block_samples=noise_d, controlnet_single_block_samples=zeros_s)
    assert np.abs(np.asarray(diff) - np.asarray(base)).max() > 1e-4


def test_residual_interval_spreading():
    from reptext.models.flux import _spread_residuals
    samples = jnp.arange(4.0).reshape(4, 1, 1, 1)
    out = np.asarray(_spread_residuals(samples, 8)).ravel()
    # ceil(8/4)=2 -> [0,0,1,1,2,2,3,3]
    np.testing.assert_array_equal(out, [0, 0, 1, 1, 2, 2, 3, 3])
    out19 = np.asarray(_spread_residuals(jnp.arange(4.0).reshape(4, 1, 1, 1), 19)).ravel()
    # ceil(19/4)=5 -> idx i//5 capped at 3
    np.testing.assert_array_equal(out19, [i // 5 for i in range(19)])


def test_union_mode_controlnet():
    import dataclasses
    cfg = dataclasses.replace(CN_CFG, num_mode=3)
    model = RepTextControlNet(cfg)
    inputs = _flux_inputs()
    inputs["controlnet_cond"] = jnp.ones(
        (B, S_IMG, cfg.in_channels + cfg.extra_condition_channels), jnp.float32)
    inputs["mode"] = jnp.zeros((B,), jnp.int32)
    params = model.init(jax.random.PRNGKey(2), **inputs)
    block, single = model.apply(params, **inputs)
    assert block.shape[2] == S_IMG  # residuals cover image tokens only


def test_flux_schnell_no_guidance_embeds():
    """FLUX.1-schnell geometry: guidance_embeds=False, guidance=None
    (reference analogue: transformer config.guidance_embeds checked at
    RepText/pipeline_flux_controlnet.py:1028-1032)."""
    import dataclasses
    cfg = dataclasses.replace(FLUX_CFG, guidance_embeds=False)
    model = FluxTransformer2D(cfg)
    inputs = _flux_inputs()
    inputs["guidance"] = None
    params = model.init(jax.random.PRNGKey(3), **inputs)
    out = model.apply(params, **inputs)
    assert out.shape == (B, S_IMG, cfg.out_channels)
    assert jnp.isfinite(out).all()
    # guidance value must not leak into the graph: passing one anyway fails
    # loudly or is ignored — the embedder raises when required and absent.
    with pytest.raises(ValueError):
        bad = dataclasses.replace(FLUX_CFG, guidance_embeds=True)
        m2 = FluxTransformer2D(bad)
        i2 = _flux_inputs()
        i2["guidance"] = None
        m2.init(jax.random.PRNGKey(4), **i2)


@pytest.mark.parametrize("depth", [(1, 2), (2, 4)])   # a slice, and the whole base
def test_weight_surgery_gives_the_controlnet_buffers_of_its_own(flux_and_params, depth):
    from reptext.models.controlnet import params_from_transformer

    cfg = dataclasses.replace(CN_CFG, num_layers=depth[0], num_single_layers=depth[1])
    inputs = _flux_inputs()
    inputs["controlnet_cond"] = jnp.ones(
        (B, S_IMG, cfg.in_channels + cfg.extra_condition_channels), jnp.float32)
    template = RepTextControlNet(cfg).init(jax.random.PRNGKey(1), **inputs)
    model, flux_params = flux_and_params
    cn = params_from_transformer(flux_params, template, *depth)

    def buffers(tree):
        return {x.unsafe_buffer_pointer() for x in jax.tree_util.tree_leaves(tree)}

    assert not buffers(cn) & buffers((flux_params, template))
    # training donates the ControlNet's params; the base stays usable
    jax.jit(lambda p: jax.tree_util.tree_map(lambda x: x + 1, p), donate_argnums=0)(cn)
    assert jnp.isfinite(model.apply(flux_params, **_flux_inputs())).all()
