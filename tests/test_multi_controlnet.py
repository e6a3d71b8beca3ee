"""MultiControlNet composition tests (tiny config)."""

import pytest

# heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.models import ControlNetEntry, MultiControlNet, RepTextControlNet
from reptext.ops.latents import prepare_latent_image_ids

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()
B, S_TXT, S_IMG = 1, 3, 16


def _make_cn(cfg, seed, cond_feat):
    model = RepTextControlNet(cfg)
    params = model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((B, S_IMG, cfg.in_channels)),
        jnp.zeros((B, S_IMG, cond_feat)),
        jnp.zeros((B, S_TXT, cfg.joint_attention_dim)),
        jnp.zeros((B, cfg.pooled_projection_dim)),
        jnp.zeros((B,)),
        prepare_latent_image_ids(8, 8), jnp.zeros((S_TXT, 3)), jnp.ones((B,)),
    )
    # perturb so residuals are nonzero
    params = jax.tree_util.tree_map(lambda x: x + 0.01, params)
    return model, params


def _common_inputs():
    return dict(
        hidden_states=jnp.ones((B, S_IMG, CN_CFG.in_channels)),
        encoder_hidden_states=jnp.ones((B, S_TXT, CN_CFG.joint_attention_dim)),
        pooled_projections=jnp.ones((B, CN_CFG.pooled_projection_dim)),
        timestep=jnp.full((B,), 0.5),
        img_ids=prepare_latent_image_ids(8, 8),
        txt_ids=jnp.zeros((S_TXT, 3)),
        guidance=jnp.full((B,), 3.5),
    )


def test_two_nets_sum():
    cfg2 = dataclasses.replace(CN_CFG, extra_condition_channels=4)
    m1, p1 = _make_cn(CN_CFG, 0, CN_CFG.in_channels + CN_CFG.extra_condition_channels)
    m2, p2 = _make_cn(cfg2, 1, cfg2.in_channels + 4)
    multi = MultiControlNet(
        [ControlNetEntry(m1, 1.0), ControlNetEntry(m2, 0.5)],
        FLUX_CFG.num_layers, FLUX_CFG.num_single_layers,
    )
    inp = _common_inputs()
    c1 = jnp.ones((B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels))
    c2 = jnp.ones((B, S_IMG, cfg2.in_channels + 4))
    block, single = multi(
        [p1, p2], inp["hidden_states"], [c1, c2],
        inp["encoder_hidden_states"], inp["pooled_projections"],
        inp["timestep"], inp["img_ids"], inp["txt_ids"], inp["guidance"],
    )
    # spread onto base depth
    assert block.shape[0] == FLUX_CFG.num_layers
    assert single.shape[0] == FLUX_CFG.num_single_layers

    # sum equals the two individually-spread contributions
    from reptext.models.flux import _spread_residuals
    b1, s1 = m1.apply(p1, inp["hidden_states"], c1, inp["encoder_hidden_states"],
                      inp["pooled_projections"], inp["timestep"], inp["img_ids"],
                      inp["txt_ids"], inp["guidance"], conditioning_scale=1.0)
    b2, s2 = m2.apply(p2, inp["hidden_states"], c2, inp["encoder_hidden_states"],
                      inp["pooled_projections"], inp["timestep"], inp["img_ids"],
                      inp["txt_ids"], inp["guidance"], conditioning_scale=0.5)
    want = np.asarray(_spread_residuals(b1, FLUX_CFG.num_layers)
                      + _spread_residuals(b2, FLUX_CFG.num_layers))
    np.testing.assert_allclose(np.asarray(block), want, rtol=1e-5, atol=1e-6)


def test_mask_gates_residuals():
    m1, p1 = _make_cn(CN_CFG, 0, CN_CFG.in_channels + CN_CFG.extra_condition_channels)
    multi = MultiControlNet(
        [ControlNetEntry(m1, 1.0)], FLUX_CFG.num_layers, FLUX_CFG.num_single_layers
    )
    inp = _common_inputs()
    c1 = jnp.ones((B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels))
    mask = jnp.zeros((S_IMG, 1))
    block, single = multi(
        [p1], inp["hidden_states"], [c1],
        inp["encoder_hidden_states"], inp["pooled_projections"],
        inp["timestep"], inp["img_ids"], inp["txt_ids"], inp["guidance"],
        token_masks=[mask],
    )
    np.testing.assert_array_equal(np.asarray(block), 0.0)
    np.testing.assert_array_equal(np.asarray(single), 0.0)


def test_per_entry_guidance_window():
    """Entry windows gate residuals by step fraction (reference keep list,
    RepText/pipeline_flux_controlnet.py:999-1005)."""
    m1, p1 = _make_cn(CN_CFG, 0, CN_CFG.in_channels + CN_CFG.extra_condition_channels)
    inp = _common_inputs()
    c1 = jnp.ones((B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels))

    def run(entry, step_index):
        multi = MultiControlNet(
            [entry], FLUX_CFG.num_layers, FLUX_CFG.num_single_layers
        )
        return multi(
            [p1], inp["hidden_states"], [c1],
            inp["encoder_hidden_states"], inp["pooled_projections"],
            inp["timestep"], inp["img_ids"], inp["txt_ids"], inp["guidance"],
            step_index=jnp.asarray(step_index), num_steps=10,
        )

    early = ControlNetEntry(m1, 1.0, guidance_start=0.0, guidance_end=0.5)
    # inside the window: matches an unwindowed entry
    b_in, s_in = run(early, 2)
    b_ref, s_ref = run(ControlNetEntry(m1, 1.0), 2)
    np.testing.assert_allclose(np.asarray(b_in), np.asarray(b_ref), rtol=1e-6)
    # outside the window: residuals zeroed
    b_out, s_out = run(early, 7)
    np.testing.assert_array_equal(np.asarray(b_out), 0.0)
    np.testing.assert_array_equal(np.asarray(s_out), 0.0)
