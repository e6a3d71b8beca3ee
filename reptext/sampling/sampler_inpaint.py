"""Fused inpaint denoising loop: dual ControlNet + true CFG, one lax.scan.

Rebuild of the reference inpaint hot loop
(RepText/pipeline_flux_controlnet_inpaint.py:1160-1274). Semantics preserved:

- true classifier-free guidance: embeds are [negative; positive] (batch 2B);
  the reference broadcasts latents batch 1 against embeds batch 2 implicitly
  (:1034 vs :1145) — here latents are explicitly duplicated so the whole step
  is one static-shape graph;
- RepText ControlNet per text line, regionally masked, gated to the first
  `controlnet_conditioning_step` steps (:1164-1182);
- inpaint ControlNet every step, unmasked, own conditioning scale (:1213-1227);
- residual stacks summed (:1229-1248), base transformer with injection,
- CFG combine `uncond + s*(cond - uncond)`, with step 0 forced to ZERO
  velocity (:1264-1270);
- Euler update in fp32.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from reptext.configs import PipelineConfig
from reptext.sampling.flow_match import FlowMatchSchedule


def make_inpaint_sampler(
    flux_apply: Callable,
    reptext_cn_apply: Callable,
    inpaint_cn_apply: Callable,
    schedule: FlowMatchSchedule,
    pipe_cfg: PipelineConfig,
    base_num_layers: int,
    base_num_single_layers: int,
    inpaint_conditioning_scale: float = 1.0,
    compute_dtype: Any = jnp.float32,
    signal_axis: Optional[str] = None,
) -> Callable:
    """Build the jitted dual-ControlNet CFG sampling function.

    ``signal_axis``: mesh axis name when the loop runs inside a shard_map
    (SP) — the adaptive-cache drift means are pmean'd over it (global drift)
    so every shard takes the same lax.cond branch (see sampler.py).

    The two ControlNets may have different depths; each residual stack is
    spread onto the base model's injection slots (ceil-interval mapping, the
    same rule diffusers applies inside the transformer) BEFORE summing, which
    is exactly equivalent to the reference when depths match and well-defined
    when they don't (the reference's list-zip silently truncates).
    """
    sigmas = jnp.asarray(schedule.sigmas, jnp.float32)
    timesteps = jnp.asarray(schedule.timesteps, jnp.float32)
    num_steps = schedule.num_steps
    gate_step = min(pipe_cfg.controlnet_conditioning_step, num_steps)
    from reptext.sampling.sampler import (
        _cn_active_mask, _velocity_cache_select,
    )
    cn_active = _cn_active_mask(pipe_cfg, num_steps, gate_step)
    cond_scale = pipe_cfg.controlnet_conditioning_scale
    true_scale = pipe_cfg.true_guidance_scale
    vc_interval = max(getattr(pipe_cfg, "velocity_cache_interval", 1), 1)
    vc_warmup = max(getattr(pipe_cfg, "velocity_cache_warmup", 8), 1)
    vc_mode = getattr(pipe_cfg, "velocity_cache_mode", "reuse")
    vc_linear = vc_mode in ("linear", "adaptive-linear")
    vc_adaptive = vc_mode in ("adaptive", "adaptive-linear")
    vc_threshold = float(getattr(pipe_cfg, "velocity_cache_threshold", 0.05))
    vc_max_skip = max(int(getattr(pipe_cfg, "velocity_cache_max_skip", 3)), 1)
    vc_enabled = vc_interval > 1 or vc_adaptive

    def sample(
        flux_params,
        reptext_params,
        inpaint_params,
        latents: jax.Array,            # [B, S, C] fp32 initial latents
        cond_tokens: jax.Array,        # [N_lines, S, F_glyph] RepText conditioning
        token_masks: jax.Array,        # [N_lines, S, 1]
        inpaint_cond: jax.Array,       # [B, S, F_inpaint] 17ch-packed conditioning
        prompt_embeds_cfg: jax.Array,  # [2B, S_txt, joint_dim]  [neg; pos]
        pooled_embeds_cfg: jax.Array,  # [2B, pooled_dim]
        txt_ids: jax.Array,
        img_ids: jax.Array,
        guidance: Optional[jax.Array],  # [B] embedded guidance or None
    ) -> jax.Array:
        b = latents.shape[0]
        n_lines = cond_tokens.shape[0]
        b2 = 2 * b

        ctx = prompt_embeds_cfg.astype(compute_dtype)
        pooled = pooled_embeds_cfg.astype(compute_dtype)
        guidance2 = None if guidance is None else jnp.tile(guidance, 2)
        # RepText conds duplicated for the CFG pair (reference :721-722).
        # [N, S, F] = one request's conds shared across the batch;
        # [N, B, S, F] = per-image conds (cross-request serving batch) —
        # repeated per CFG half in the x2 = [lat; lat] batch order.
        if cond_tokens.ndim == 4:
            cond_rt = jnp.tile(cond_tokens, (1, 2, 1, 1)).reshape(
                n_lines * b2, cond_tokens.shape[2], cond_tokens.shape[3]
            ).astype(compute_dtype)                                          # [N*2B, S, F]
        else:
            cond_rt = jnp.repeat(cond_tokens, b2, axis=0).astype(compute_dtype)  # [N*2B, S, F]
        ctx_n = jnp.tile(ctx, (n_lines, 1, 1))
        pooled_n = jnp.tile(pooled, (n_lines, 1))
        guidance_n = None if guidance2 is None else jnp.tile(guidance2, n_lines)
        cond_inp = jnp.tile(inpaint_cond, (2, 1, 1)).astype(compute_dtype)   # [2B, S, F]
        if token_masks.ndim == 4:
            masks = jnp.tile(token_masks, (1, 2, 1, 1))[None]  # [1, N, 2B, S, 1]
        else:
            masks = token_masks[None, :, None, :, :]

        def run_reptext(x2, t2):
            block, single = reptext_cn_apply(
                reptext_params,
                jnp.tile(x2, (n_lines, 1, 1)),
                cond_rt,
                ctx_n,
                pooled_n,
                jnp.tile(t2, n_lines),
                img_ids,
                txt_ids,
                guidance_n,
                cond_scale,
            )

            def mask_and_sum(res):
                l, nb, s, d = res.shape
                res = res.reshape(l, n_lines, b2, s, d)
                return (res * masks.astype(res.dtype)).sum(axis=1)

            return mask_and_sum(block), mask_and_sum(single)

        def step(carry, i):
            # cache registers mirror sampler.py: last two COMPUTED CFG
            # velocities + their sigmas (extrapolated values never enter the
            # registers), plus the adaptive trigger's (lat_ref, skips).
            lat, v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips = carry
            x2 = jnp.tile(lat, (2, 1, 1)).astype(compute_dtype)
            t2 = jnp.full((b2,), timesteps[i] / 1000.0, compute_dtype)

            def with_rt(_):
                return run_reptext(x2, t2)

            def without_rt(_):
                return (
                    jnp.zeros((rt_layers, b2, lat.shape[1], inner_dim), compute_dtype),
                    jnp.zeros((rt_singles, b2, lat.shape[1], inner_dim), compute_dtype),
                )

            def compute_v_cfg(_):
                block_res, single_res = jax.lax.cond(
                    cn_active[i], with_rt, without_rt, operand=None
                )

                blk_i, sgl_i = inpaint_cn_apply(
                    inpaint_params, x2, cond_inp, ctx, pooled, t2,
                    img_ids, txt_ids, guidance2, inpaint_conditioning_scale,
                )
                # BOTH raw stacks ride into the base model as a tuple; the
                # layer scan indexes each per layer and sums — semantically
                # the reference's spread+sum (:1229-1248) without
                # materializing two [L_base, 2B, S, D] spread temps across
                # the whole scan (~1.4GB at the inpaint op-point)
                block_all = (block_res, blk_i.astype(compute_dtype))
                single_all = (single_res, sgl_i.astype(compute_dtype))

                velocity2 = flux_apply(
                    flux_params, x2, ctx, pooled, t2, img_ids, txt_ids,
                    guidance2, block_all, single_all,
                ).astype(jnp.float32)
                v_uncond, v_text = velocity2[:b], velocity2[b:]
                return v_uncond + true_scale * (v_text - v_uncond)

            sig_i = sigmas[i]
            if not vc_enabled:
                v_cfg = compute_v_cfg(None)
                regs = (v_cfg, v_prev, sig_i, s_prev, lat_ref, skips)
            else:
                # velocity caching (see sampler.py): warmup >= 1 always runs
                # step 0, so the cache seed (zeros) is never consumed. Unlike
                # txt2img there is no `local == 0` term — the inpaint scan is
                # never chunked, warmup >= 1 covers step 0.
                always = (i < vc_warmup) | (i >= num_steps - 1)
                v_cfg, regs = _velocity_cache_select(
                    compute_v_cfg,
                    (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips),
                    lat, sig_i, i, always,
                    vc_adaptive=vc_adaptive, vc_linear=vc_linear,
                    vc_warmup=vc_warmup, vc_interval=vc_interval,
                    vc_threshold=vc_threshold, vc_max_skip=vc_max_skip,
                    signal_axis=signal_axis,
                )
            # step 0: zero velocity (reference :1264-1270) — applied OUTSIDE
            # the cache so a skipped step 1+ never reuses the zeroed value.
            v = jnp.where(i > 0, v_cfg, jnp.zeros_like(v_cfg))

            dt = sigmas[i + 1] - sigmas[i]
            return (lat + dt * v,) + regs, None

        rt_shapes = jax.eval_shape(
            run_reptext,
            jax.ShapeDtypeStruct((b2,) + latents.shape[1:], compute_dtype),
            jax.ShapeDtypeStruct((b2,), compute_dtype),
        )
        rt_layers, rt_singles = rt_shapes[0].shape[0], rt_shapes[1].shape[0]
        inner_dim = rt_shapes[0].shape[-1]

        init = (
            latents.astype(jnp.float32),
            jnp.zeros(latents.shape, jnp.float32),  # v_prev (cache seed)
            jnp.zeros(latents.shape, jnp.float32),  # v_prev2
            jnp.zeros((), jnp.float32),             # sigma of v_prev
            jnp.zeros((), jnp.float32),             # sigma of v_prev2
            jnp.zeros(latents.shape, jnp.float32),  # lat_ref (adaptive)
            jnp.zeros((), jnp.int32),               # consecutive skips
        )
        (latents_out, *_), _ = jax.lax.scan(step, init, jnp.arange(num_steps))
        return latents_out

    return sample


def make_sp_inpaint_sampler(
    flux_apply: Callable,
    reptext_cn_apply: Callable,
    inpaint_cn_apply: Callable,
    schedule: FlowMatchSchedule,
    pipe_cfg: PipelineConfig,
    base_num_layers: int,
    base_num_single_layers: int,
    mesh,
    inpaint_conditioning_scale: float = 1.0,
    axis_name: str = "sp",
    compute_dtype: Any = jnp.float32,
) -> Callable:
    """SEQUENCE-PARALLEL variant of the inpaint sampler: the whole dual-
    ControlNet true-CFG scan runs under ONE ``shard_map`` with the image
    token axis sharded over ``axis_name`` (mirror of
    sampler.make_sp_txt2img_sampler — all three models must be built with an
    SP ``attention_backend`` ('ring' or 'ulysses'); everything outside
    attention is per-token and collective-free on the local shard). The
    reference inpaint loop is strictly single-GPU
    (RepText/pipeline_flux_controlnet_inpaint.py:1160-1274); this is the
    >=2048^2 growth path applied to text editing.
    """
    import jax.sharding as _sh

    P = _sh.PartitionSpec
    base = make_inpaint_sampler(
        flux_apply, reptext_cn_apply, inpaint_cn_apply, schedule, pipe_cfg,
        base_num_layers, base_num_single_layers, inpaint_conditioning_scale,
        compute_dtype, signal_axis=axis_name,
    )
    tok = P(None, axis_name, None)   # [B/N, S, C] latents / conds / masks
    ids = P(axis_name, None)         # [S, 3] image RoPE ids

    def sample(flux_params, reptext_params, inpaint_params, latents,
               cond_tokens, token_masks, inpaint_cond, prompt_embeds_cfg,
               pooled_embeds_cfg, txt_ids, img_ids, guidance):
        # per-image conds ([N, B, S, F], cross-request serving batch) shard
        # their token axis one position later (mirror of sampler.py::_specs)
        cond_spec = tok if cond_tokens.ndim == 3 else P(None, None, axis_name, None)
        mask_spec = tok if token_masks.ndim == 3 else P(None, None, axis_name, None)
        return jax.shard_map(
            base,
            mesh=mesh,
            in_specs=(P(), P(), P(), tok, cond_spec, mask_spec, tok,
                      P(), P(), P(), ids, P()),
            out_specs=tok,
            check_vma=False,
        )(flux_params, reptext_params, inpaint_params, latents, cond_tokens,
          token_masks, inpaint_cond, prompt_embeds_cfg, pooled_embeds_cfg,
          txt_ids, img_ids, guidance)

    return sample
