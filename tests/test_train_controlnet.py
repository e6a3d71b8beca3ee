"""ControlNet training recipe: frozen base, region-weighted loss, elastic wiring."""

import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.ops.latents import prepare_latent_image_ids
from reptext.sampling.train_controlnet import (
    bind_frozen_base,
    controlnet_flow_match_loss,
    init_controlnet_training,
    make_controlnet_train_step,
)

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()


def _setup(mask_half=True):
    flux = FluxTransformer2D(FLUX_CFG)
    cn = RepTextControlNet(CN_CFG)
    b, s_txt, s_img = 2, 4, 16
    rng = jax.random.PRNGKey(0)
    img_ids = prepare_latent_image_ids(8, 8)
    txt_ids = jnp.zeros((s_txt, 3))
    cond_feat = CN_CFG.in_channels + CN_CFG.extra_condition_channels
    mask = jnp.ones((b, s_img, 1))
    if mask_half:  # text region = first half of the tokens
        mask = mask.at[:, s_img // 2:, :].set(0.0)
    batch = {
        "x0": jax.random.normal(rng, (b, s_img, FLUX_CFG.in_channels)),
        "cond_tokens": jax.random.normal(rng, (b, s_img, cond_feat)),
        "token_mask": mask,
        "prompt_embeds": jax.random.normal(rng, (b, s_txt, FLUX_CFG.joint_attention_dim)),
        "pooled": jax.random.normal(rng, (b, FLUX_CFG.pooled_projection_dim)),
        "img_ids": img_ids,
        "txt_ids": txt_ids,
        "guidance": jnp.full((b,), 3.5),
    }
    t0 = jnp.zeros((b,))
    flux_params = flux.init(
        rng, batch["x0"], batch["prompt_embeds"], batch["pooled"], t0,
        img_ids, txt_ids, batch["guidance"],
    )
    cn_template = cn.init(
        rng, batch["x0"], batch["cond_tokens"], batch["prompt_embeds"],
        batch["pooled"], t0, img_ids, txt_ids, batch["guidance"],
    )

    def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return flux.apply(p, x, ctx, pooled, t, iid, tid, g,
                          controlnet_block_samples=br,
                          controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, t, iid, tid, g, scale):
        return cn.apply(p, x, cnd, ctx, pooled, t, iid, tid, g,
                        conditioning_scale=scale)

    return flux_apply, cn_apply, flux_params, cn_template, batch


def test_all_ones_mask_makes_weight_irrelevant():
    """Normalized weighting: constant mask ⇒ loss independent of the weight."""
    flux_apply, cn_apply, flux_params, cn_template, batch = _setup(mask_half=False)
    rng = jax.random.PRNGKey(1)
    l0 = controlnet_flow_match_loss(
        flux_apply, cn_apply, cn_template, flux_params, batch, rng,
        text_loss_weight=0.0,
    )
    l5 = controlnet_flow_match_loss(
        flux_apply, cn_apply, cn_template, flux_params, batch, rng,
        text_loss_weight=5.0,
    )
    np.testing.assert_allclose(float(l0), float(l5), rtol=1e-6)


def test_warm_start_zero_head_gradient_structure():
    """from_transformer init: residual heads get gradient, gated block
    internals do not (zero heads block the path), and the loss is finite."""
    flux_apply, cn_apply, flux_params, cn_template, batch = _setup()
    cn_params, _, _ = init_controlnet_training(
        flux_params, cn_template, CN_CFG.num_layers, CN_CFG.num_single_layers
    )
    # warm start copied base blocks into the CN
    np.testing.assert_array_equal(
        np.asarray(cn_params["params"]["double_blocks"]["block"]["to_q"]["kernel"]),
        np.asarray(
            flux_params["params"]["double_blocks"]["block"]["to_q"]["kernel"]
        )[: CN_CFG.num_layers],
    )
    loss, grads = jax.value_and_grad(
        lambda p: controlnet_flow_match_loss(
            flux_apply, cn_apply, p, flux_params, batch, jax.random.PRNGKey(2)
        )
    )(cn_params)
    assert np.isfinite(float(loss))
    g = grads["params"]
    assert np.abs(np.asarray(g["double_blocks"]["proj"]["kernel"])).max() > 0
    assert np.abs(np.asarray(g["single_blocks"]["proj"]["kernel"])).max() > 0
    # zero-init heads gate the blocks: no signal reaches block internals yet
    assert np.abs(np.asarray(g["double_blocks"]["block"]["to_q"]["kernel"])).max() == 0


def test_train_step_decreases_loss_and_freezes_base():
    flux_apply, cn_apply, flux_params, cn_template, batch = _setup()
    opt = optax.adam(1e-3)
    cn_params = cn_template
    opt_state = opt.init(cn_params)
    step = jax.jit(make_controlnet_train_step(flux_apply, cn_apply, opt))
    rng = jax.random.PRNGKey(3)
    base_before = np.asarray(
        flux_params["params"]["double_blocks"]["block"]["to_q"]["kernel"]
    ).copy()
    losses = []
    for _ in range(6):
        cn_params, opt_state, loss = step(cn_params, opt_state, flux_params, batch, rng)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    # the base is an argument, never updated
    np.testing.assert_array_equal(
        base_before,
        np.asarray(flux_params["params"]["double_blocks"]["block"]["to_q"]["kernel"]),
    )


def test_elastic_trainer_compatibility():
    from reptext.sampling.elastic import ElasticTrainer

    flux_apply, cn_apply, flux_params, cn_template, batch = _setup()
    opt = optax.adam(1e-3)
    opt_state = opt.init(cn_template)
    step = jax.jit(make_controlnet_train_step(flux_apply, cn_apply, opt))
    trainer = ElasticTrainer(
        bind_frozen_base(step, flux_params),
        batch_fn=lambda i: batch,
        checkpoint_every=2,
    )
    cn_params, _ = trainer.run(cn_template, opt_state, 3, jax.random.PRNGKey(4))
    assert len(trainer.losses) == 3 and not trainer.faults
    assert all(np.isfinite(v) for v in trainer.losses)


def test_weight_decay_mask_targets_kernels_only():
    flux_apply, cn_apply, flux_params, cn_template, batch = _setup()
    cn_params, opt, opt_state = init_controlnet_training(
        flux_params, cn_template, CN_CFG.num_layers, CN_CFG.num_single_layers,
        weight_decay=0.1,
    )
    step = jax.jit(make_controlnet_train_step(flux_apply, cn_apply, opt))
    new_params, _, loss = step(
        cn_params, opt_state, flux_params, batch, jax.random.PRNGKey(5)
    )
    assert np.isfinite(float(loss))
    # structure preserved
    jax.tree_util.tree_all(
        jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, cn_params, new_params)
    )
