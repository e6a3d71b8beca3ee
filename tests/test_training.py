"""Flow-matching training step: loss decreases, grads flow through scan stacks."""

import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np
import optax

from reptext.configs import FluxConfig
from reptext.models import FluxTransformer2D
from reptext.ops.latents import prepare_latent_image_ids
from reptext.sampling.training import flow_match_loss, make_train_step

CFG = FluxConfig().tiny()


def _setup():
    model = FluxTransformer2D(CFG)
    b, s_txt, s_img = 2, 4, 16
    rng = jax.random.PRNGKey(0)
    img_ids = prepare_latent_image_ids(8, 8)
    txt_ids = jnp.zeros((s_txt, 3))
    batch = {
        "x0": jax.random.normal(rng, (b, s_img, CFG.in_channels)),
        "prompt_embeds": jax.random.normal(rng, (b, s_txt, CFG.joint_attention_dim)),
        "pooled": jax.random.normal(rng, (b, CFG.pooled_projection_dim)),
        "img_ids": img_ids,
        "txt_ids": txt_ids,
        "guidance": jnp.full((b,), 3.5),
    }
    params = model.init(
        rng, batch["x0"], batch["prompt_embeds"], batch["pooled"],
        jnp.zeros((b,)), img_ids, txt_ids, batch["guidance"],
    )

    def apply_fn(p, x, ctx, pooled, t, iid, tid, g):
        return model.apply(p, x, ctx, pooled, t, iid, tid, g)

    return apply_fn, params, batch


def test_loss_finite_and_positive():
    apply_fn, params, batch = _setup()
    loss = flow_match_loss(apply_fn, params, batch, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss)) and float(loss) > 0


@pytest.mark.smoke
def test_train_step_decreases_loss():
    apply_fn, params, batch = _setup()
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    step = jax.jit(make_train_step(apply_fn, opt))
    rng = jax.random.PRNGKey(2)
    losses = []
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, batch, rng)  # fixed rng
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_gradients_reach_scanned_layers():
    apply_fn, params, batch = _setup()
    grads = jax.grad(
        lambda p: flow_match_loss(apply_fn, p, batch, jax.random.PRNGKey(3))
    )(params)
    g = grads["params"]["double_blocks"]["block"]["to_q"]["kernel"]
    assert np.abs(np.asarray(g)).max() > 0
    g2 = grads["params"]["single_blocks"]["block"]["proj_out"]["kernel"]
    assert np.abs(np.asarray(g2)).max() > 0
