"""ControlNet training recipe: frozen base FLUX, trainable RepText ControlNet.

The reference ships no training code (SURVEY.md §0) but its ControlNet carries
the training affordances the RepText paper describes: gradient checkpointing
(RepText/controlnet_flux.py:321-340), ``from_transformer`` weight-surgery init
(:182-214), and the vestigial ``get_text_to_render`` span machinery for a
text-perceptual loss (RepText/pipeline_flux_controlnet.py:239-277 — computed,
never called). This module is the training path those affordances
point at:

- ``controlnet_flow_match_loss`` — rectified-flow velocity MSE through the
  *frozen* base transformer with ControlNet residual injection and the same
  regional-mask semantics the sampler applies at inference
  (sampling/sampler.py: residuals x per-token text-region mask).
- **Text-perceptual term, in-graph**: the paper's OCR-feature loss needs a
  host-side OCR network; the on-device equivalent used here re-weights the
  velocity error inside the rendered-text token mask by
  ``1 + text_loss_weight`` (normalized), concentrating gradient signal on
  glyph tokens without leaving the fused graph. ``utils/text_span.py``
  locates prompt-token spans when a context-side weighting is wanted.
- ``make_controlnet_train_step`` — grads w.r.t. ControlNet params ONLY; the
  base params are a non-differentiated argument (never copied into the
  optimizer state). Works under pjit with parallel/partition.py rules and is
  signature-compatible with sampling/elastic.ElasticTrainer once the frozen
  base is bound (``bind_frozen_base``).

Init recipe: ``models.controlnet.params_from_transformer`` (copy the first
N double / M single base blocks; zero heads keep the net a no-op at step 0 —
at the first step only the zero-init residual heads receive nonzero gradient,
which un-gates the rest of the net from step 2 on: standard ControlNet
warm-start dynamics).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import optax


def controlnet_flow_match_loss(
    flux_apply: Callable,
    cn_apply: Callable,
    cn_params: Any,
    flux_params: Any,
    batch: Dict[str, jax.Array],
    rng: jax.Array,
    text_loss_weight: float = 2.0,
    conditioning_scale: float = 1.0,
    perceptual: Optional[Dict[str, Any]] = None,
    vae_params: Any = None,
    judge_params: Any = None,
) -> jax.Array:
    """Region-weighted conditional flow-matching MSE with CN injection.

    batch keys:
      x0            [B, S, C]   packed clean latents
      cond_tokens   [B, S, F]   packed glyph conditioning (canny+position)
      token_mask    [B, S, 1]   per-token text-region mask (regional masking,
                                 RepText/pipeline_flux_controlnet.py:1060-1069)
      prompt_embeds [B, S_txt, D_joint], pooled [B, D_pool]
      img_ids [S, 3], txt_ids [S_txt, 3], guidance [B] (optional)

    Optional OCR text-perceptual term (sampling/ocr_loss.py — the RepText
    paper's loss, in-graph): ``perceptual`` is a static dict
    ``{"decode_apply": fn(vae_params, x0_packed) -> images [B,H,W,3],
    "judge_apply": Optional[fn], "weight": float}``; the frozen VAE decoder
    and OCR-judge params ride as runtime args (``vae_params`` /
    ``judge_params``), and the batch must carry ``ocr_boxes [B,4]`` /
    ``ocr_labels [B,L]`` / ``ocr_paddings [B,L]`` (data.py emits them).
    x0 is recovered from the predicted velocity (x0 = x_t − t·v), decoded,
    cropped at the known text boxes, and scored with CTC against the known
    labels; per-sample terms ramp by (1−t) since x0-from-high-noise is
    uninformative.
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

    mask = batch["token_mask"].astype(jnp.float32)  # [B, S, 1]

    block_res, single_res = cn_apply(
        cn_params,
        x_t,
        batch["cond_tokens"],
        batch["prompt_embeds"],
        batch["pooled"],
        t,
        batch["img_ids"],
        batch["txt_ids"],
        batch.get("guidance"),
        conditioning_scale,
    )
    # regional masking exactly as the inference sampler applies it
    # (residual stacks are [L, B, S, D]; mask broadcasts over L and D)
    block_res = block_res * mask[None].astype(block_res.dtype)
    single_res = single_res * mask[None].astype(single_res.dtype)

    pred = flux_apply(
        flux_params,
        x_t,
        batch["prompt_embeds"],
        batch["pooled"],
        t,
        batch["img_ids"],
        batch["txt_ids"],
        batch.get("guidance"),
        block_res,
        single_res,
    )

    err = (pred.astype(jnp.float32) - target) ** 2          # [B, S, C]
    w = 1.0 + text_loss_weight * mask                        # [B, S, 1]
    # normalized weighting: text_loss_weight=0 reduces exactly to jnp.mean(err)
    loss = jnp.sum(err * w) / (jnp.sum(w) * x0.shape[-1])

    if perceptual is not None and perceptual.get("weight", 0.0) > 0.0:
        from reptext.sampling.ocr_loss import ocr_ctc_loss

        x0_pred = x_t - t_b * pred.astype(jnp.float32)
        images = perceptual["decode_apply"](vae_params, x0_pred)
        ocr = ocr_ctc_loss(
            images,
            batch["ocr_boxes"],
            batch["ocr_labels"],
            batch["ocr_paddings"],
            judge_params,
            perceptual.get("judge_apply"),
            sample_weights=1.0 - t,
        )
        loss = loss + perceptual["weight"] * ocr
    return loss


def make_controlnet_train_step(
    flux_apply: Callable,
    cn_apply: Callable,
    optimizer: optax.GradientTransformation,
    text_loss_weight: float = 2.0,
    conditioning_scale: float = 1.0,
    perceptual: Optional[Dict[str, Any]] = None,
) -> Callable:
    """Returns ``step(cn_params, opt_state, flux_params, batch, rng) ->
    (cn_params, opt_state, loss)`` — with ``perceptual`` set (see
    ``controlnet_flow_match_loss``), the signature gains two trailing frozen
    trees: ``step(..., rng, vae_params, judge_params)``.

    Pure; jit/pjit at the call site (donate cn_params/opt_state). The frozen
    ``flux_params`` (and perceptual-term VAE/judge params) are arguments —
    NOT closures — so the 12B base rides as device buffers, never as
    compile-time constants, and never enters the optimizer state.
    """

    def step(cn_params, opt_state, flux_params, batch, rng,
             vae_params=None, judge_params=None):
        loss, grads = jax.value_and_grad(
            lambda p: controlnet_flow_match_loss(
                flux_apply, cn_apply, p, flux_params, batch, rng,
                text_loss_weight, conditioning_scale,
                perceptual, vae_params, judge_params,
            )
        )(cn_params)
        updates, opt_state = optimizer.update(grads, opt_state, cn_params)
        cn_params = optax.apply_updates(cn_params, updates)
        return cn_params, opt_state, loss

    return step


def make_joint_train_step(
    flux_apply: Callable,
    cn_apply: Callable,
    optimizer: optax.GradientTransformation,
    text_loss_weight: float = 2.0,
    conditioning_scale: float = 1.0,
    perceptual: Optional[Dict[str, Any]] = None,
) -> Callable:
    """Full-model training: gradients through BOTH the base transformer and
    the ControlNet (same region-weighted flow-matching loss as the CN-only
    recipe). Returns ``step(params, opt_state, batch, rng) ->
    (params, opt_state, loss)`` where ``params = {"flux": ..., "controlnet":
    ...}`` is one optimizer-managed tree. With ``perceptual`` set the step
    takes two trailing frozen trees (vae_params, judge_params) like the
    CN-only factory.

    This is the from-scratch / full-fine-tune path (the CN-only recipe above
    is the reference-style frozen-base training, RepText paper §training);
    it also powers the end-to-end trained-weights fidelity demo
    (examples/overfit_e2e.py), which memorizes a tiny synthetic set to prove
    the train -> sample -> OCR loop on non-random weights.
    """

    def step(params, opt_state, batch, rng, vae_params=None, judge_params=None):
        def loss_fn(p):
            return controlnet_flow_match_loss(
                flux_apply, cn_apply, p["controlnet"], p["flux"], batch, rng,
                text_loss_weight, conditioning_scale,
                perceptual, vae_params, judge_params,
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def bind_frozen_base(step: Callable, flux_params: Any, *frozen: Any) -> Callable:
    """Adapt a controlnet train step to the ElasticTrainer signature
    ``(params, opt_state, batch, rng) -> (params, opt_state, loss)``.

    ``flux_params`` (and any extra ``frozen`` trees — e.g. the perceptual
    term's VAE decoder + OCR-judge params, appended after ``rng``) stay
    call-time arguments of the underlying (possibly jitted) step — binding
    happens outside the traced function, so the frozen trees are not baked
    into the executable as constants.
    """

    @functools.wraps(step)
    def bound(cn_params, opt_state, batch, rng):
        return step(cn_params, opt_state, flux_params, batch, rng, *frozen)

    return bound


def init_controlnet_training(
    flux_params: Any,
    cn_params_template: Any,
    num_layers: int,
    num_single_layers: int,
    optimizer: Optional[optax.GradientTransformation] = None,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.0,
):
    """Assemble (cn_params, optimizer, opt_state) for ControlNet training.

    Warm-starts the ControlNet from the base transformer
    (``params_from_transformer`` weight surgery — reference
    RepText/controlnet_flux.py:182-214) and builds an AdamW optimizer whose
    weight-decay mask excludes biases/norm scales (standard recipe; decay on
    kernels only).
    """
    from reptext.models.controlnet import params_from_transformer

    cn_params = params_from_transformer(
        flux_params, cn_params_template, num_layers, num_single_layers
    )
    if optimizer is None:
        if weight_decay > 0.0:
            def decay_mask(params):
                def is_kernel(path, _):
                    return any(
                        getattr(k, "key", None) == "kernel" for k in path
                    )
                return jax.tree_util.tree_map_with_path(is_kernel, params)

            optimizer = optax.adamw(
                learning_rate, weight_decay=weight_decay, mask=decay_mask
            )
        else:
            optimizer = optax.adamw(learning_rate)
    opt_state = optimizer.init(cn_params)
    return cn_params, optimizer, opt_state
