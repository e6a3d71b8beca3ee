"""FlowMatch Euler schedule golden-value tests.

Golden mu values computed by hand from the reference's calculate_shift
coefficients (RepText/pipeline_flux_controlnet.py:78-88): m = 0.66/3840,
b = 0.5 - m*256.
"""

import math

import jax.numpy as jnp
import numpy as np

from reptext.sampling import FlowMatchSchedule, build_schedule, calculate_shift


def test_calculate_shift_golden():
    assert math.isclose(calculate_shift(256), 0.5)
    assert math.isclose(calculate_shift(4096), 1.16)
    m = (1.16 - 0.5) / (4096 - 256)
    assert math.isclose(calculate_shift(1024), 0.5 + m * (1024 - 256))


def test_schedule_shapes_and_endpoints():
    sched = build_schedule(num_steps=30, image_seq_len=4096)
    assert sched.num_steps == 30
    assert len(sched.sigmas) == 31
    assert sched.sigmas[-1] == 0.0
    # first sigma: shift(mu, 1.0) = e^mu/(e^mu + 0) = 1.0
    assert math.isclose(float(sched.sigmas[0]), 1.0, abs_tol=1e-6)
    # timesteps = sigma*1000, decreasing
    np.testing.assert_allclose(sched.timesteps, sched.sigmas[:-1] * 1000, rtol=1e-6)
    assert (np.diff(sched.sigmas) < 0).all()


def test_dynamic_shift_formula():
    mu = calculate_shift(1024)
    sched = build_schedule(num_steps=10, image_seq_len=1024)
    raw = np.linspace(1.0, 0.1, 10)
    want = np.exp(mu) / (np.exp(mu) + (1 / raw - 1))
    np.testing.assert_allclose(sched.sigmas[:-1], want, rtol=1e-5)


def test_static_shift_formula():
    sched = build_schedule(num_steps=4, image_seq_len=0, use_dynamic_shifting=False, shift=3.0)
    raw = np.linspace(1.0, 0.25, 4)
    want = 3.0 * raw / (1 + 2.0 * raw)
    np.testing.assert_allclose(sched.sigmas[:-1], want, rtol=1e-6)


def test_euler_step():
    sched = build_schedule(num_steps=5, image_seq_len=256)
    x = jnp.ones((1, 4))
    v = jnp.full((1, 4), 2.0)
    got = np.asarray(sched.step(x, v, 0))
    dt = sched.sigmas[1] - sched.sigmas[0]
    np.testing.assert_allclose(got, 1.0 + dt * 2.0, rtol=1e-6)


def test_scale_noise_at_step0_is_pure_noise():
    sched = build_schedule(num_steps=8, image_seq_len=256)
    sample = jnp.zeros((2, 2))
    noise = jnp.ones((2, 2))
    out = np.asarray(sched.scale_noise(sample, noise, 0))
    np.testing.assert_allclose(out, float(sched.sigmas[0]), rtol=1e-6)


# --- custom caller schedules (reference retrieve_timesteps semantics,
# RepText/pipeline_flux_controlnet.py:91-160: set_timesteps(sigmas=...) or
# set_timesteps(timesteps=...) with mu-shift) ---


def test_custom_sigmas_equals_default_when_linspace():
    # passing the pipeline's own linspace must reproduce the default schedule
    default = build_schedule(num_steps=12, image_seq_len=1024)
    custom = build_schedule(
        num_steps=999, image_seq_len=1024,
        sigmas=np.linspace(1.0, 1.0 / 12, 12),
    )
    assert custom.num_steps == 12  # length of sigmas wins over num_steps
    np.testing.assert_allclose(custom.sigmas, default.sigmas, rtol=1e-6)
    np.testing.assert_allclose(custom.timesteps, default.timesteps, rtol=1e-6)


def test_custom_sigmas_shift_applied_and_timesteps_derived():
    mu = calculate_shift(1024)
    base = np.array([0.9, 0.5, 0.2])
    sched = build_schedule(num_steps=3, image_seq_len=1024, sigmas=base)
    want = np.exp(mu) / (np.exp(mu) + (1 / base - 1))
    np.testing.assert_allclose(sched.sigmas[:-1], want, rtol=1e-5)
    assert sched.sigmas[-1] == 0.0
    np.testing.assert_allclose(sched.timesteps, want * 1000, rtol=1e-5)


def test_custom_timesteps_kept_verbatim_sigmas_shifted():
    # the scheduler's is_timesteps_provided branch: model-facing timesteps are
    # the caller's values UNCHANGED; Euler sigmas derive from shifted t/1000
    mu = calculate_shift(1024)
    ts = np.array([990.0, 500.0, 125.0])
    sched = build_schedule(num_steps=3, image_seq_len=1024, timesteps=ts)
    np.testing.assert_allclose(sched.timesteps, ts, rtol=1e-6)
    base = ts / 1000.0
    want = np.exp(mu) / (np.exp(mu) + (1 / base - 1))
    np.testing.assert_allclose(sched.sigmas[:-1], want, rtol=1e-5)


def test_custom_timesteps_static_shift():
    ts = np.array([800.0, 400.0])
    sched = build_schedule(
        num_steps=2, image_seq_len=0, use_dynamic_shifting=False, shift=3.0,
        timesteps=ts,
    )
    base = ts / 1000.0
    np.testing.assert_allclose(
        sched.sigmas[:-1], 3.0 * base / (1 + 2.0 * base), rtol=1e-6)
    np.testing.assert_allclose(sched.timesteps, ts, rtol=1e-6)


def test_custom_schedule_validation():
    import pytest

    with pytest.raises(ValueError, match="Only one of"):
        build_schedule(2, 256, timesteps=[500.0], sigmas=[0.5])
    with pytest.raises(ValueError):
        build_schedule(2, 256, timesteps=[0.0, -5.0])
    with pytest.raises(ValueError):
        build_schedule(2, 256, sigmas=[1.5])
    with pytest.raises(ValueError):
        build_schedule(2, 256, sigmas=[])
