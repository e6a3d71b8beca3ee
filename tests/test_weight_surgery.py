"""from_transformer weight surgery + remat (gradient checkpointing) tests."""

import pytest

# heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.models.controlnet import params_from_transformer
from reptext.ops.latents import prepare_latent_image_ids

FLUX_CFG = FluxConfig().tiny()          # 2 double + 4 single
CN_CFG = ControlNetConfig().tiny()      # 1 double + 2 single
B, S_TXT, S_IMG = 1, 3, 16


def _flux_inputs():
    return (
        jnp.ones((B, S_IMG, FLUX_CFG.in_channels)),
        jnp.ones((B, S_TXT, FLUX_CFG.joint_attention_dim)),
        jnp.ones((B, FLUX_CFG.pooled_projection_dim)),
        jnp.full((B,), 0.5),
        prepare_latent_image_ids(8, 8),
        jnp.zeros((S_TXT, 3)),
        jnp.ones((B,)),
    )


def test_params_from_transformer_copies_and_zeroes():
    flux = FluxTransformer2D(FLUX_CFG)
    flux_params = flux.init(jax.random.PRNGKey(0), *_flux_inputs())

    cn = RepTextControlNet(CN_CFG)
    cond = jnp.ones((B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels))
    inputs = _flux_inputs()
    template = cn.init(jax.random.PRNGKey(1), inputs[0], cond, *inputs[1:])

    surged = params_from_transformer(
        flux_params, template, CN_CFG.num_layers, CN_CFG.num_single_layers
    )

    # embedders copied exactly
    np.testing.assert_array_equal(
        np.asarray(surged["params"]["x_embedder"]["kernel"]),
        np.asarray(flux_params["params"]["x_embedder"]["kernel"]),
    )
    # first double block copied from base (leading-axis slice)
    np.testing.assert_array_equal(
        np.asarray(surged["params"]["double_blocks"]["block"]["to_q"]["kernel"]),
        np.asarray(flux_params["params"]["double_blocks"]["block"]["to_q"]["kernel"][:1]),
    )
    # zero-init heads preserved -> fresh ControlNet is a no-op
    block, single = cn.apply(
        surged, inputs[0], cond, *inputs[1:]
    )
    np.testing.assert_array_equal(np.asarray(block), 0.0)
    np.testing.assert_array_equal(np.asarray(single), 0.0)


def test_remat_matches_no_remat():
    inputs = _flux_inputs()
    base = FluxTransformer2D(FLUX_CFG)
    params = base.init(jax.random.PRNGKey(0), *inputs)
    rem = FluxTransformer2D(FLUX_CFG, remat=True)
    out_a = np.asarray(base.apply(params, *inputs))
    out_b = np.asarray(rem.apply(params, *inputs))
    np.testing.assert_allclose(out_a, out_b, rtol=1e-6, atol=1e-6)


def test_remat_gradients_flow():
    inputs = _flux_inputs()
    rem = FluxTransformer2D(FLUX_CFG, remat=True)
    params = rem.init(jax.random.PRNGKey(0), *inputs)

    def loss(p):
        return jnp.sum(rem.apply(p, *inputs) ** 2)

    grads = jax.grad(loss)(params)
    g = grads["params"]["double_blocks"]["block"]["to_q"]["kernel"]
    assert np.abs(np.asarray(g)).max() > 0
