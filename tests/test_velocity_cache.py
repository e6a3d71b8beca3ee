"""Velocity-cache (training-free step skipping) semantics of the fused sampler.

The fused lax.scan sampler with ``velocity_cache_interval=k`` must match a
hand-rolled Python Euler loop that recomputes the velocity only on schedule
steps (warmup, every k-th, final) and reuses the last velocity otherwise.
The reference has no analogue (acceleration feature); the flow-matching Euler
semantics it accelerates are RepText/pipeline_flux_controlnet.py:1016-1130.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import PipelineConfig
from reptext.sampling import build_schedule
from reptext.sampling.sampler import make_txt2img_sampler

B, S, C, S_TXT, INNER = 1, 16, 8, 4, 8
L_CN, LS_CN = 2, 3


def _stub_flux(params, x, ctx, pooled, t, img_ids, txt_ids, guidance,
               block_res, single_res):
    # Deterministic, state-dependent velocity; consumes the CN residuals so
    # the gate is observable.
    inj = jnp.sum(block_res, axis=0)[..., :C] + jnp.sum(single_res, axis=0)[..., :C]
    return -0.3 * x + 0.1 * jnp.sin(t)[:, None, None] + 0.01 * inj


def _stub_cn(params, hidden, cond, ctx, pooled, t, img_ids, txt_ids,
             guidance, scale):
    nb = hidden.shape[0]
    base = jnp.mean(cond) + jnp.mean(hidden)
    block = jnp.full((L_CN, nb, S, INNER), base, hidden.dtype) * scale
    single = jnp.full((LS_CN, nb, S, INNER), base * 0.5, hidden.dtype) * scale
    return block, single


def _make(num_steps, interval, warmup=2, gate=10**9, mode="reuse",
          threshold=0.05, max_skip=3):
    cfg = PipelineConfig(
        height=32, width=32, num_inference_steps=num_steps,
        controlnet_conditioning_step=min(gate, num_steps),
        velocity_cache_interval=interval, velocity_cache_warmup=warmup,
        velocity_cache_mode=mode,
        velocity_cache_threshold=threshold, velocity_cache_max_skip=max_skip,
    )
    schedule = build_schedule(num_steps, cfg.image_seq_len)
    sampler = make_txt2img_sampler(_stub_flux, _stub_cn, schedule, cfg)
    return sampler, schedule, cfg


def _args():
    rng = jax.random.PRNGKey(0)
    latents = jax.random.normal(rng, (B, S, C))
    cond_tokens = jax.random.normal(jax.random.fold_in(rng, 1), (1, S, 12))
    token_masks = jnp.ones((1, S, 1))
    ctx = jax.random.normal(jax.random.fold_in(rng, 2), (B, S_TXT, 6))
    pooled = jax.random.normal(jax.random.fold_in(rng, 3), (B, 5))
    txt_ids = jnp.zeros((S_TXT, 3))
    img_ids = jnp.zeros((S, 3))
    return latents, cond_tokens, token_masks, ctx, pooled, txt_ids, img_ids


def _reference_loop(schedule, cfg, latents, cond_tokens, token_masks, ctx,
                    pooled, txt_ids, img_ids):
    """Plain Python Euler loop with explicit velocity caching."""
    num_steps = schedule.num_steps
    interval = cfg.velocity_cache_interval
    warmup = cfg.velocity_cache_warmup
    linear = cfg.velocity_cache_mode in ("linear", "adaptive-linear")
    adaptive = cfg.velocity_cache_mode in ("adaptive", "adaptive-linear")
    gate = cfg.controlnet_conditioning_step
    lat = latents.astype(jnp.float32)
    v = None
    computed = []  # [(sigma, v), ...] last-two computed register
    lat_ref = jnp.zeros_like(lat)
    skips = 0
    for i in range(num_steps):
        if adaptive:
            drift = jnp.mean(jnp.abs(lat - lat_ref), axis=(1, 2))
            ref = jnp.mean(jnp.abs(lat_ref), axis=(1, 2))
            rel = float(jnp.max(drift / (ref + 1e-8)))
            run = (i < warmup or i >= num_steps - 1 or i == 0
                   or rel >= cfg.velocity_cache_threshold
                   or skips >= cfg.velocity_cache_max_skip)
        else:
            run = (interval == 1 or i < warmup
                   or (i - warmup) % interval == 0 or i >= num_steps - 1
                   or i == 0)
        if not run:
            skips += 1
        if not run:
            if linear and len(computed) >= 2:
                (s1, v1), (s2, v2) = computed[-1], computed[-2]
                v = v1 + (v1 - v2) * ((schedule.sigmas[i] - s1) / (s1 - s2))
            else:
                v = computed[-1][1]
        if run:
            lat_ref = lat
            skips = 0
            t_b = jnp.full((B,), schedule.timesteps[i] / 1000.0)
            if i < gate:
                block, single = _stub_cn(
                    None, lat, cond_tokens[0:1].repeat(B, 0), ctx, pooled, t_b,
                    img_ids, txt_ids, None, cfg.controlnet_conditioning_scale,
                )
                block = block * token_masks[None, 0]
                single = single * token_masks[None, 0]
            else:
                block = jnp.zeros((L_CN, B, S, INNER))
                single = jnp.zeros((LS_CN, B, S, INNER))
            v = _stub_flux(None, lat, ctx, pooled, t_b, img_ids, txt_ids,
                           None, block, single).astype(jnp.float32)
            computed.append((float(schedule.sigmas[i]), v))
        lat = lat + (schedule.sigmas[i + 1] - schedule.sigmas[i]) * v
    return lat


@pytest.mark.parametrize("interval,warmup,mode", [
    (1, 2, "reuse"), (2, 2, "reuse"), (3, 1, "reuse"),
    (2, 2, "linear"), (3, 1, "linear"),
])
def test_fused_matches_reference_loop(interval, warmup, mode):
    sampler, schedule, cfg = _make(8, interval, warmup, mode=mode)
    args = _args()
    got = sampler(None, None, args[0], args[1], args[2], args[3], args[4],
                  args[5], args[6], None)
    want = _reference_loop(schedule, cfg, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,threshold,max_skip", [
    ("adaptive", 0.05, 3),
    ("adaptive", 1e9, 2),          # drift never triggers: pure max-skip cadence
    ("adaptive-linear", 0.05, 3),
    ("adaptive-linear", 0.02, 4),
])
def test_adaptive_matches_reference_loop(mode, threshold, max_skip):
    """Adaptive (TeaCache-family) trigger semantics: the in-graph lax.cond
    decision must match a Python loop replicating the drift accumulator."""
    sampler, schedule, cfg = _make(10, 1, warmup=2, mode=mode,
                                   threshold=threshold, max_skip=max_skip)
    args = _args()
    got = sampler(None, None, args[0], args[1], args[2], args[3], args[4],
                  args[5], args[6], None)
    want = _reference_loop(schedule, cfg, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_adaptive_zero_threshold_is_uncached():
    """threshold=0 means the drift trigger always fires: every step computes,
    bit-identical to the uncached sampler."""
    args = _args()
    uncached, _, _ = _make(10, 1)
    adaptive, _, _ = _make(10, 1, mode="adaptive", threshold=0.0)
    a = uncached(None, None, args[0], args[1], args[2], args[3], args[4],
                 args[5], args[6], None)
    b = adaptive(None, None, args[0], args[1], args[2], args[3], args[4],
                 args[5], args[6], None)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.smoke
def test_adaptive_skips_and_stays_close():
    """A high threshold actually skips (result differs from uncached) while
    max_skip bounds divergence."""
    args = _args()
    uncached, _, _ = _make(12, 1, warmup=4)
    adaptive, _, _ = _make(12, 1, warmup=4, mode="adaptive",
                           threshold=1e9, max_skip=2)
    a = np.asarray(uncached(None, None, args[0], args[1], args[2], args[3],
                            args[4], args[5], args[6], None))
    b = np.asarray(adaptive(None, None, args[0], args[1], args[2], args[3],
                            args[4], args[5], args[6], None))
    diff = np.abs(a - b).max()
    assert diff > 0
    assert diff < 0.2 * np.abs(a).max()


def test_cache_changes_result_but_stays_close():
    args = _args()
    outs = {}
    for interval in (1, 2):
        sampler, _, _ = _make(12, interval, warmup=4)
        outs[interval] = np.asarray(
            sampler(None, None, args[0], args[1], args[2], args[3], args[4],
                    args[5], args[6], None)
        )
    diff = np.abs(outs[1] - outs[2]).max()
    scale = np.abs(outs[1]).max()
    assert diff > 0  # caching is actually active
    assert diff < 0.2 * scale  # and a mild approximation, not divergence


def test_chunked_forces_recompute_at_chunk_start():
    """Chunk boundaries reset the cache: first step of each chunk runs the
    model even if the absolute index is a skip step."""
    sampler, schedule, cfg = _make(8, 4, warmup=1)
    args = _args()
    full = sampler(None, None, args[0], args[1], args[2], args[3], args[4],
                   args[5], args[6], None)
    # Same steps split into two chunks of 4.
    lat = args[0]
    for start in (0, 4):
        lat = sampler.chunked(None, None, lat, args[1], args[2], args[3],
                              args[4], args[5], args[6], None, start, 4)
    # Chunked result differs only because chunk-2's first step recomputes
    # (cache reset) — both must be finite and the same order of magnitude.
    assert np.isfinite(np.asarray(lat)).all()
    assert np.isfinite(np.asarray(full)).all()
    # With interval=1 chunked must match unchunked exactly (regression).
    sampler1, _, _ = _make(8, 1)
    full1 = sampler1(None, None, args[0], args[1], args[2], args[3], args[4],
                     args[5], args[6], None)
    lat1 = args[0]
    for start in (0, 4):
        lat1 = sampler1.chunked(None, None, lat1, args[1], args[2], args[3],
                                args[4], args[5], args[6], None, start, 4)
    np.testing.assert_allclose(np.asarray(lat1), np.asarray(full1),
                               rtol=1e-5, atol=1e-6)
