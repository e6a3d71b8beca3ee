"""ControlNet training walkthrough: the RepText training recipe end-to-end.

The reference ships no training code; its ControlNet carries the affordances
(gradient checkpointing RepText/controlnet_flux.py:321-340, from_transformer
:182-214). This example wires the full recipe at tiny scale:

1. warm-start the ControlNet from the base transformer (weight surgery),
2. build glyph conditioning for synthetic text samples (the real data path:
   render text -> canny+position -> VAE encode -> packed cond tokens),
3. train with the region-weighted flow-matching loss (frozen base) under the
   ElasticTrainer (periodic restore points, NaN rollback, watchdog).

Run: python examples/train_controlnet.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import ControlNetConfig, FluxConfig
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.ops.latents import prepare_latent_image_ids
from reptext.sampling.elastic import ElasticTrainer
from reptext.sampling.train_controlnet import (
    bind_frozen_base,
    init_controlnet_training,
    make_controlnet_train_step,
)

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()
B, S_TXT, S_IMG = 2, 4, 16  # 8x8 latent grid, 2x2 packed


def synthetic_batch(step: int) -> dict:
    """Deterministic step-indexed batch (ElasticTrainer replays by step).

    Production replaces this with: render TextLine -> build_conditions ->
    VAE-encode canny+position -> pack (pipelines/txt2img.py
    prepare_control_tokens), and x0 = VAE-encoded training images.
    """
    rng = jax.random.PRNGKey(1000 + step)
    r = jax.random.split(rng, 4)
    cond_feat = CN_CFG.in_channels + CN_CFG.extra_condition_channels
    mask = jnp.zeros((B, S_IMG, 1)).at[:, : S_IMG // 2, :].set(1.0)
    return {
        "x0": jax.random.normal(r[0], (B, S_IMG, FLUX_CFG.in_channels)),
        "cond_tokens": jax.random.normal(r[1], (B, S_IMG, cond_feat)),
        "token_mask": mask,
        "prompt_embeds": jax.random.normal(
            r[2], (B, S_TXT, FLUX_CFG.joint_attention_dim)),
        "pooled": jax.random.normal(r[3], (B, FLUX_CFG.pooled_projection_dim)),
        "img_ids": prepare_latent_image_ids(8, 8),
        "txt_ids": jnp.zeros((S_TXT, 3)),
        "guidance": jnp.full((B,), 3.5),
    }


def main(num_steps: int = 20):
    flux = FluxTransformer2D(FLUX_CFG)
    cn = RepTextControlNet(CN_CFG, remat=True)  # gradient checkpointing
    rng = jax.random.PRNGKey(0)
    b0 = synthetic_batch(0)
    t0 = jnp.zeros((B,))
    flux_params = flux.init(rng, b0["x0"], b0["prompt_embeds"], b0["pooled"],
                            t0, b0["img_ids"], b0["txt_ids"], b0["guidance"])
    cn_template = cn.init(rng, b0["x0"], b0["cond_tokens"], b0["prompt_embeds"],
                          b0["pooled"], t0, b0["img_ids"], b0["txt_ids"],
                          b0["guidance"])

    cn_params, optimizer, opt_state = init_controlnet_training(
        flux_params, cn_template, CN_CFG.num_layers, CN_CFG.num_single_layers,
        learning_rate=1e-3, weight_decay=0.01,
    )

    def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return flux.apply(p, x, ctx, pooled, t, iid, tid, g,
                          controlnet_block_samples=br,
                          controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, t, iid, tid, g, scale):
        return cn.apply(p, x, cnd, ctx, pooled, t, iid, tid, g,
                        conditioning_scale=scale)

    step = jax.jit(make_controlnet_train_step(
        flux_apply, cn_apply, optimizer, text_loss_weight=2.0))
    trainer = ElasticTrainer(
        bind_frozen_base(step, flux_params),
        batch_fn=synthetic_batch,
        checkpoint_every=10,
        on_event=lambda kind, info: print(f"  [{kind}] {info}"),
    )
    cn_params, opt_state = trainer.run(cn_params, opt_state, num_steps,
                                       jax.random.PRNGKey(1))
    losses = np.asarray(trainer.losses)
    print(f"trained {num_steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]


if __name__ == "__main__":
    main()
