"""Flow-matching training step (rectified-flow objective) for FLUX/ControlNet.

The reference ships no training code (SURVEY.md §0), but its ControlNet carries
training affordances (gradient checkpointing, RepText/controlnet_flux.py:
321-340; `from_transformer` weight surgery, :182-214). This module supplies the
Training path: the conditional flow-matching objective used by FLUX
(velocity target u = noise - x0 at x_t = (1-t) x0 + t noise), one jitted
train step (loss + grad + optax update), designed to run under pjit with the
parallel/partition.py sharding rules.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax


def flow_match_loss(
    apply_fn: Callable,
    params: Any,
    batch: Dict[str, jax.Array],
    rng: jax.Array,
) -> jax.Array:
    """Conditional flow-matching MSE.

    batch keys: x0 (packed clean latents [B, S, C]), prompt_embeds, pooled,
    txt_ids, img_ids, guidance (optional).
    """
    x0 = batch["x0"].astype(jnp.float32)
    b = x0.shape[0]
    rng_t, rng_n = jax.random.split(rng)
    # logit-normal timestep sampling (SD3/FLUX recipe)
    t = jax.nn.sigmoid(jax.random.normal(rng_t, (b,)))
    noise = jax.random.normal(rng_n, x0.shape, jnp.float32)
    t_b = t[:, None, None]
    x_t = (1.0 - t_b) * x0 + t_b * noise
    target = noise - x0

    pred = apply_fn(
        params,
        x_t,
        batch["prompt_embeds"],
        batch["pooled"],
        t,
        batch["img_ids"],
        batch["txt_ids"],
        batch.get("guidance"),
    )
    return jnp.mean((pred.astype(jnp.float32) - target) ** 2)


def make_train_step(
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
) -> Callable:
    """Returns train_step(params, opt_state, batch, rng) -> (params, opt_state, loss).

    Pure function — jit/pjit it with appropriate shardings at the call site.
    """

    def train_step(params, opt_state, batch, rng):
        loss, grads = jax.value_and_grad(
            lambda p: flow_match_loss(apply_fn, p, batch, rng)
        )(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
