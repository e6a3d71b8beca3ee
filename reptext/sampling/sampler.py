"""Fused RepText denoising loop: one jitted lax.scan over FlowMatch Euler steps.

Redesign of the reference's Python hot loop
(RepText/pipeline_flux_controlnet.py:1016-1130). Differences in structure, not
semantics:

- The whole loop (ControlNet fwd + regional masking + base transformer fwd +
  Euler update) is ONE compiled XLA graph via ``lax.scan`` — zero host-device
  round trips per step.
- The per-line ControlNet Python loop (reference :1037-1090) becomes a batch:
  lines are stacked onto the ControlNet batch axis, residuals are multiplied by
  per-line token masks and summed over lines in one einsum-like contraction.
- Step gating (ControlNet only for the first ``controlnet_conditioning_step``
  steps, reference :1042) is a ``lax.cond`` inside the scan body, so gated-off
  steps skip the ControlNet entirely at runtime.
- Latents are carried in fp32 (Euler math), model inputs cast to the model
  compute dtype (bf16 on the GPU).
- Optional training-free velocity caching (``PipelineConfig.velocity_cache_*``,
  FORA/TeaCache-style): after a warmup of full steps, the transformer runs
  only every k-th step and skipped steps reuse (or linearly extrapolate) the
  previous velocity — a second ``lax.cond`` whose taken branch is the whole
  model forward, so skipped steps cost one Euler update. ``adaptive`` /
  ``adaptive-linear`` modes replace the fixed interval with an in-graph
  trigger: skip while the latents' relative L1 drift since the last computed
  step stays below ``velocity_cache_threshold`` (at most
  ``velocity_cache_max_skip`` consecutive skips) — the rectified-flow
  trajectory is near-straight exactly when the latents move slowly, so the
  drift signal spends model evaluations where the trajectory bends. Off by
  default (interval=1, mode="reuse"); the reference has no analogue
  (acceleration beyond the per-step roofline).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from reptext.configs import PipelineConfig
from reptext.sampling.flow_match import FlowMatchSchedule


def _cn_active_mask(pipe_cfg, num_steps: int, gate_step: int) -> jax.Array:
    """Static per-step ControlNet on/off mask.

    Intersects the step gate (``controlnet_conditioning_step``,
    RepText/pipeline_flux_controlnet.py:1042) with the diffusers
    fraction window (``control_guidance_start/end``, reference :999-1005:
    keep iff i/T >= start and (i+1)/T <= end). Precomputed on the host so
    the scan body pays one bool gather per step.
    """
    cg_s = float(getattr(pipe_cfg, "control_guidance_start", 0.0))
    cg_e = float(getattr(pipe_cfg, "control_guidance_end", 1.0))
    idx = jnp.arange(num_steps)
    keep = (idx / num_steps >= cg_s) & ((idx + 1) / num_steps <= cg_e)
    return (idx < gate_step) & keep


def _velocity_cache_select(
    compute_fn, carry_regs, lat, sig_i, i, always, *,
    vc_adaptive, vc_linear, vc_warmup, vc_interval, vc_threshold,
    vc_max_skip, signal_axis,
):
    """Shared velocity-cache trigger + register rotation (txt2img & inpaint).

    ``carry_regs = (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips)`` holds
    the last two COMPUTED velocities, the sigmas they were computed at, the
    adaptive trigger's latent reference, and the consecutive-skip counter.
    Returns ``(velocity, new_regs)``; extrapolated values never enter the
    registers (no compounding).
    """
    v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips = carry_regs
    if vc_adaptive:
        # TeaCache-family in-graph trigger: skip while the latents' relative
        # L1 drift since the last COMPUTED step stays under the threshold
        # (max over the batch — a coalesced batch never skips past any
        # member's drift), bounded by vc_max_skip consecutive skips.
        drift = jnp.mean(jnp.abs(lat - lat_ref), axis=(1, 2))
        ref = jnp.mean(jnp.abs(lat_ref), axis=(1, 2))
        if signal_axis is not None:
            # Under SP the token axis is sharded: reconstruct the GLOBAL
            # per-image means (equal shards => mean of shard means) so the
            # trigger matches the single-device trajectory the threshold was
            # calibrated on. A max of shard-local ratios would fire earlier
            # wherever drift is unevenly distributed over the sequence.
            drift = jax.lax.pmean(drift, signal_axis)
            ref = jax.lax.pmean(ref, signal_axis)
        rel = jnp.max(drift / (ref + 1e-8))
        run = always | (rel >= vc_threshold) | (skips >= vc_max_skip)
    else:
        run = always | ((i - vc_warmup) % vc_interval == 0)

    def computed(_):
        v = compute_fn(None)
        return v, (v, v_prev, sig_i, s_prev,
                   lat.astype(jnp.float32), jnp.zeros((), jnp.int32))

    def skipped(_):
        if vc_linear:
            # first-order extrapolation over sigma from the last two computed
            # velocities; degenerates to reuse until two computes exist (the
            # seed register carries s_prev2 == 0, real schedule sigmas are > 0)
            ds = s_prev - s_prev2
            inv = jnp.where(
                (jnp.abs(ds) > 1e-8) & (s_prev2 > 0.0), 1.0 / ds, 0.0,
            )
            v = v_prev + (v_prev - v_prev2) * (inv * (sig_i - s_prev))
        else:
            v = v_prev
        return v, (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips + 1)

    return jax.lax.cond(run, computed, skipped, operand=None)


def make_txt2img_sampler(
    flux_apply: Callable,
    controlnet_apply: Callable,
    schedule: FlowMatchSchedule,
    pipe_cfg: PipelineConfig,
    compute_dtype: Any = jnp.float32,
    signal_axis: Optional[str] = None,
) -> Callable:
    """Build the jitted sampling function.

    ``flux_apply(params, hidden, ctx, pooled, t, img_ids, txt_ids, guidance,
    block_res, single_res)`` and ``controlnet_apply(params, hidden, cond, ctx,
    pooled, t, img_ids, txt_ids, guidance, scale)`` are bound model apply fns
    (e.g. functools.partial(model.apply)).

    ``signal_axis``: mesh axis name when the sampler body runs inside a
    shard_map (SP) — the adaptive-cache drift means are pmean'd over it
    (reconstructing the global drift) so every shard takes the same lax.cond
    branch (the model forward contains collectives; divergent branches would
    deadlock).
    """
    sigmas = jnp.asarray(schedule.sigmas, jnp.float32)
    timesteps = jnp.asarray(schedule.timesteps, jnp.float32)
    num_steps = schedule.num_steps
    gate_step = min(pipe_cfg.controlnet_conditioning_step, num_steps)
    cn_active = _cn_active_mask(pipe_cfg, num_steps, gate_step)
    cond_scale = pipe_cfg.controlnet_conditioning_scale
    vc_interval = max(getattr(pipe_cfg, "velocity_cache_interval", 1), 1)
    vc_warmup = max(getattr(pipe_cfg, "velocity_cache_warmup", 8), 1)
    vc_mode = getattr(pipe_cfg, "velocity_cache_mode", "reuse")
    vc_linear = vc_mode in ("linear", "adaptive-linear")
    vc_adaptive = vc_mode in ("adaptive", "adaptive-linear")
    vc_threshold = float(getattr(pipe_cfg, "velocity_cache_threshold", 0.05))
    vc_max_skip = max(int(getattr(pipe_cfg, "velocity_cache_max_skip", 3)), 1)
    vc_enabled = vc_interval > 1 or vc_adaptive

    def _scan_chunk(
        flux_params,
        cn_params,
        latents: jax.Array,        # [B, S, C] packed fp32 initial latents
        cond_tokens: jax.Array,    # [N, S, F] shared or [N, B, S, F] per-image
        token_masks: jax.Array,    # [N, S, 1] shared or [N, B, S, 1] per-image
        prompt_embeds: jax.Array,  # [B, S_txt, joint_dim]
        pooled_embeds: jax.Array,  # [B, pooled_dim]
        txt_ids: jax.Array,        # [S_txt, 3]
        img_ids: jax.Array,        # [S_img, 3]
        guidance: Optional[jax.Array],  # [B] or None
        start_step=0,              # traced: chunk offset into the schedule
        chunk_steps: int = None,   # static: steps in this scan
        flux_extra=None,           # optional pytree forwarded to flux_apply
                                   # (e.g. IP-Adapter {"ip_tokens","ip_scale"})
    ) -> jax.Array:
        b = latents.shape[0]
        n_lines = cond_tokens.shape[0]

        ctx = prompt_embeds.astype(compute_dtype)
        pooled = pooled_embeds.astype(compute_dtype)
        # line-major tiling: latents for line j, image i at index j*b + i.
        # Rank-3 conds are shared across the batch (single request, num_images
        # copies); rank-4 conds carry one condition set per image (serving's
        # coalesced cross-request batches).
        if cond_tokens.ndim == 4:
            cond = cond_tokens.reshape(
                n_lines * b, cond_tokens.shape[2], cond_tokens.shape[3]
            ).astype(compute_dtype)
            masks = token_masks[None]              # [1, N, B, S, 1]
        else:
            cond = jnp.repeat(cond_tokens, b, axis=0).astype(compute_dtype)
            masks = token_masks[None, :, None, :, :]  # [1, N, 1, S, 1]
        ctx_nb = jnp.tile(ctx, (n_lines, 1, 1))
        pooled_nb = jnp.tile(pooled, (n_lines, 1))
        guidance_nb = None if guidance is None else jnp.tile(guidance, n_lines)

        def run_controlnet(x_model, t_b):
            block, single = controlnet_apply(
                cn_params,
                jnp.tile(x_model, (n_lines, 1, 1)),
                cond,
                ctx_nb,
                pooled_nb,
                jnp.tile(t_b, n_lines),
                img_ids,
                txt_ids,
                guidance_nb,
                cond_scale,
            )
            # [L, N*B, S, D] -> [L, N, B, S, D]; regional mask; sum lines
            def mask_and_sum(res):
                l, nb, s, d = res.shape
                res = res.reshape(l, n_lines, b, s, d)
                return (res * masks.astype(res.dtype)).sum(axis=1)

            return mask_and_sum(block), mask_and_sum(single)

        def step(carry, scan_in):
            # cache registers hold the last two COMPUTED velocities and the
            # sigmas at which they were computed (extrapolated values never
            # enter the registers — no compounding). lat_ref/skips drive the
            # adaptive trigger and are dead (XLA-DCE'd) in the other modes.
            lat, v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips = carry
            i, local = scan_in
            t_b = jnp.full((b,), timesteps[i] / 1000.0, compute_dtype)
            x_model = lat.astype(compute_dtype)

            def with_cn(_):
                return run_controlnet(x_model, t_b)

            def without_cn(_):
                zb = jnp.zeros(
                    (cn_num_layers, b, lat.shape[1], inner_dim), compute_dtype
                )
                zs = jnp.zeros(
                    (cn_num_single, b, lat.shape[1], inner_dim), compute_dtype
                )
                return zb, zs

            def compute_velocity(_):
                block_res, single_res = jax.lax.cond(
                    cn_active[i], with_cn, without_cn, operand=None
                )
                args = (
                    flux_params, x_model, ctx, pooled, t_b,
                    img_ids, txt_ids, guidance, block_res, single_res,
                )
                # keep the 10-arg call for plain flux_apply fns; only
                # extra-aware fns (pipeline IP-Adapter path) see the pytree
                out = (flux_apply(*args) if flux_extra is None
                       else flux_apply(*args, flux_extra))
                return out.astype(jnp.float32)

            sig_i = sigmas[i]
            if not vc_enabled:
                velocity = compute_velocity(None)
                regs = (velocity, v_prev, sig_i, s_prev, lat_ref, skips)
            else:
                # Cache schedule; `local == 0` forces the first step of every
                # scan chunk (the carried velocity is zeros at a chunk
                # boundary, never a valid cache entry).
                always = (i < vc_warmup) | (i >= num_steps - 1) | (local == 0)
                velocity, regs = _velocity_cache_select(
                    compute_velocity,
                    (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips),
                    lat, sig_i, i, always,
                    vc_adaptive=vc_adaptive, vc_linear=vc_linear,
                    vc_warmup=vc_warmup, vc_interval=vc_interval,
                    vc_threshold=vc_threshold, vc_max_skip=vc_max_skip,
                    signal_axis=signal_axis,
                )

            dt = sigmas[i + 1] - sigmas[i]
            lat = lat + dt * velocity
            return (lat,) + regs, None

        # Residual stack shapes come from one abstract ControlNet eval.
        cn_shapes = jax.eval_shape(
            run_controlnet,
            jax.ShapeDtypeStruct(latents.shape, compute_dtype),
            jax.ShapeDtypeStruct((b,), compute_dtype),
        )
        cn_num_layers = cn_shapes[0].shape[0]
        cn_num_single = cn_shapes[1].shape[0]
        inner_dim = cn_shapes[0].shape[-1]

        indices = jnp.arange(chunk_steps) + start_step
        locals_ = jnp.arange(chunk_steps)
        zeros_v = jnp.zeros(latents.shape, jnp.float32)
        init = (
            latents.astype(jnp.float32),
            zeros_v,                    # v_prev  (cache seed, never consumed)
            zeros_v,                    # v_prev2
            jnp.zeros((), jnp.float32),  # sigma of v_prev
            jnp.zeros((), jnp.float32),  # sigma of v_prev2
            zeros_v,                    # lat_ref (adaptive trigger reference)
            jnp.zeros((), jnp.int32),    # consecutive skips since last compute
        )
        (latents_out, *_), _ = jax.lax.scan(step, init, (indices, locals_))
        return latents_out

    def sample(
        flux_params, cn_params, latents, cond_tokens, token_masks,
        prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
        start_step=0, flux_extra=None,
    ):
        return _scan_chunk(
            flux_params, cn_params, latents, cond_tokens, token_masks,
            prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
            start_step, num_steps, flux_extra,
        )

    def sample_chunk(
        flux_params, cn_params, latents, cond_tokens, token_masks,
        prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
        start_step, chunk_len, flux_extra=None,
    ):
        """Run ``chunk_len`` (static) steps from traced ``start_step`` —
        enables host callbacks / cooperative interruption between chunks
        (the reference's per-step `self._interrupt` check,
        RepText/pipeline_flux_controlnet.py:1019-1020, without giving up the
        fused graph inside a chunk)."""
        return _scan_chunk(
            flux_params, cn_params, latents, cond_tokens, token_masks,
            prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
            start_step, chunk_len, flux_extra,
        )

    sample.chunked = sample_chunk
    return sample


def make_sp_txt2img_sampler(
    flux_apply: Callable,
    controlnet_apply: Callable,
    schedule: FlowMatchSchedule,
    pipe_cfg: PipelineConfig,
    mesh,
    axis_name: str = "sp",
    compute_dtype: Any = jnp.float32,
) -> Callable:
    """SEQUENCE-PARALLEL variant of the fused sampler: the entire lax.scan
    denoise loop (ControlNet fwd + regional masking + base fwd + Euler
    update) runs under ONE ``shard_map`` with the image-token axis sharded
    over ``axis_name``.

    Both models must be constructed with an SP ``attention_backend`` —
    ``'ring'`` (K/V ppermute, parallel/sequence.joint_ring_attention_local)
    or ``'ulysses'`` (all-to-all head swap, joint_ulysses_attention_local;
    needs heads % sp == 0) — while every other op in the loop — embedders,
    AdaLN, FFs, residual heads, regional masks, the Euler update — is
    per-token and runs collective-free on the local shard. The per-block
    attention exchange is the ONLY communication per step.

    This is the >=2048^2 multi-chip growth path (SURVEY.md §2.3/§5) as an
    actual runnable pipeline stage, not just a standalone attention kernel;
    validated sharded==single-device on the 8-device CPU mesh
    (tests/mesh_scenarios.py::check_sp_sampler). The reference is strictly
    single-GPU (SURVEY.md §2.3).
    """
    from jax.sharding import PartitionSpec as P

    base = make_txt2img_sampler(
        flux_apply, controlnet_apply, schedule, pipe_cfg, compute_dtype,
        signal_axis=axis_name,
    )
    tok = P(None, axis_name, None)       # [B, S, C] latents / [N, S, F] conds
    ids = P(axis_name, None)             # [S, 3] image RoPE ids

    def _specs(cond_tokens, token_masks):
        cond_spec = tok if cond_tokens.ndim == 3 else P(None, None, axis_name, None)
        mask_spec = tok if token_masks.ndim == 3 else P(None, None, axis_name, None)
        return (P(), P(), tok, cond_spec, mask_spec, P(), P(), P(), ids, P())

    def sample(
        flux_params, cn_params, latents, cond_tokens, token_masks,
        prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
        flux_extra=None,
    ):
        # IP-Adapter image-prompt tokens: a tiny [B, N_ip, D] set, REPLICATED
        # per shard — the decoupled ip attention (local image queries over
        # the full ip K/V, nn/blocks.py) is per-token and collective-free.
        # (tree.map over None is None, a valid empty-pytree arg/spec.)
        extra_spec = jax.tree.map(lambda _: P(), flux_extra)
        return jax.shard_map(
            lambda *a: base(*a[:-1], flux_extra=a[-1]),
            mesh=mesh,
            in_specs=_specs(cond_tokens, token_masks) + (extra_spec,),
            out_specs=tok,
            check_vma=False,
        )(flux_params, cn_params, latents, cond_tokens, token_masks,
          prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
          flux_extra)

    def sample_chunk(
        flux_params, cn_params, latents, cond_tokens, token_masks,
        prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
        start_step, chunk_len, flux_extra=None,
    ):
        """Chunked SP sampling (callback / img2img under --shard spN): the
        traced ``start_step`` scalar is replicated; each chunk is one
        shard_map over the same specs as the full scan."""
        extra_spec = jax.tree.map(lambda _: P(), flux_extra)
        return jax.shard_map(
            lambda *a: base.chunked(*a[:-2], a[-2], chunk_len,
                                    flux_extra=a[-1]),
            mesh=mesh,
            in_specs=_specs(cond_tokens, token_masks) + (P(), extra_spec),
            out_specs=tok, check_vma=False,
        )(flux_params, cn_params, latents, cond_tokens, token_masks,
          prompt_embeds, pooled_embeds, txt_ids, img_ids, guidance,
          jnp.asarray(start_step, jnp.int32), flux_extra)

    sample.chunked = sample_chunk
    return sample
