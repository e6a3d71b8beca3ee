"""control_guidance_start/end step-fraction window (diffusers kwarg surface).

Reference semantics: RepText/pipeline_flux_controlnet.py:760-761,999-1005 —
keep[i] = 1 iff i/T >= start and (i+1)/T <= end, per controlnet. Here the
window is intersected with the step gate (controlnet_conditioning_step) into
one precomputed per-step mask driving the sampler's lax.cond; stub models
keep compiles tiny so this stays in the fast tier.
"""

import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import PipelineConfig
from reptext.sampling import build_schedule
from reptext.sampling.sampler import _cn_active_mask, make_txt2img_sampler

B, S, C, S_TXT, INNER = 1, 16, 8, 4, 8
L_CN, LS_CN = 2, 3


def _reference_keep(i, T, s, e):
    # RepText/pipeline_flux_controlnet.py:1002 verbatim semantics
    return 1.0 - float(i / T < s or (i + 1) / T > e)


def test_mask_matches_reference_formula():
    T = 30
    for s, e in [(0.0, 1.0), (0.0, 0.5), (0.25, 0.75), (0.5, 1.0), (0.9, 0.1)]:
        cfg = PipelineConfig(control_guidance_start=s, control_guidance_end=e)
        mask = np.asarray(_cn_active_mask(cfg, T, gate_step=T))
        want = [bool(_reference_keep(i, T, s, e)) for i in range(T)]
        assert mask.tolist() == want, (s, e)


def test_mask_intersects_step_gate():
    cfg = PipelineConfig(control_guidance_start=0.0, control_guidance_end=1.0)
    mask = np.asarray(_cn_active_mask(cfg, 30, gate_step=10))
    assert mask[:10].all() and not mask[10:].any()


def _stub_flux(params, x, ctx, pooled, t, img_ids, txt_ids, guidance,
               block_res, single_res):
    inj = jnp.sum(block_res, axis=0)[..., :C] + jnp.sum(single_res, axis=0)[..., :C]
    return -0.3 * x + 0.1 * jnp.sin(t)[:, None, None] + 0.01 * inj


def _stub_cn(params, hidden, cond, ctx, pooled, t, img_ids, txt_ids,
             guidance, scale):
    nb = hidden.shape[0]
    base = jnp.mean(cond) + jnp.mean(hidden)
    block = jnp.full((L_CN, nb, S, INNER), base, hidden.dtype) * scale
    single = jnp.full((LS_CN, nb, S, INNER), base * 0.5, hidden.dtype) * scale
    return block, single


def _run(num_steps, **cfg_kw):
    cfg = PipelineConfig(height=32, width=32, num_inference_steps=num_steps,
                         **cfg_kw)
    schedule = build_schedule(num_steps, cfg.image_seq_len)
    sampler = make_txt2img_sampler(_stub_flux, _stub_cn, schedule, cfg)
    rng = jax.random.PRNGKey(0)
    latents = jax.random.normal(rng, (B, S, C))
    cond = jax.random.normal(jax.random.fold_in(rng, 1), (1, S, 12))
    masks = jnp.ones((1, S, 1))
    ctx = jax.random.normal(jax.random.fold_in(rng, 2), (B, S_TXT, 6))
    pooled = jax.random.normal(jax.random.fold_in(rng, 3), (B, 5))
    return sampler(None, None, latents, cond, masks, ctx, pooled,
                   jnp.zeros((S_TXT, 3)), jnp.zeros((S, 3)), None)


def test_window_equals_equivalent_step_gate():
    # end=0.5 over 10 steps == ControlNet on for the first 5 steps
    by_window = _run(10, controlnet_conditioning_step=10,
                     control_guidance_end=0.5)
    by_gate = _run(10, controlnet_conditioning_step=5)
    np.testing.assert_allclose(np.asarray(by_window), np.asarray(by_gate),
                               rtol=0, atol=0)


def test_window_changes_output():
    full = _run(10, controlnet_conditioning_step=10)
    late = _run(10, controlnet_conditioning_step=10,
                control_guidance_start=0.5)
    assert not np.allclose(np.asarray(full), np.asarray(late))
