"""Elastic trainer: fault detection, rollback-to-checkpoint, watchdog."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.sampling.elastic import ElasticTrainer


def quad_step(params, opt_state, batch, rng):
    """Minimal gradient step on a quadratic: loss = mean((w*x - y)^2)."""
    def loss_fn(p):
        return jnp.mean((p["w"] * batch["x"] - batch["y"]) ** 2)

    loss, g = jax.value_and_grad(loss_fn)(params)
    return {"w": params["w"] - 0.1 * g["w"]}, opt_state, loss


def clean_batch(step):
    return {"x": jnp.ones((4,)), "y": jnp.full((4,), 3.0)}


def test_clean_run_checkpoints_and_converges():
    events = []
    tr = ElasticTrainer(quad_step, clean_batch, checkpoint_every=5,
                        on_event=lambda k, i: events.append((k, i)))
    params, _ = tr.run({"w": jnp.zeros(())}, None, 10, jax.random.PRNGKey(0))
    assert len(tr.losses) == 10
    assert tr.losses[-1] < tr.losses[0]
    assert not tr.faults
    ckpt_steps = [i["step"] for k, i in events if k == "checkpoint"]
    assert ckpt_steps == [0, 5, 10]
    assert float(params["w"]) == pytest.approx(3.0, abs=0.5)


def test_nan_fault_rolls_back_and_recovers():
    seen_fault = {"done": False}

    def batch_fn(step):
        if step == 7 and not seen_fault["done"]:
            seen_fault["done"] = True  # transient fault: NaN batch once
            return {"x": jnp.full((4,), jnp.nan), "y": jnp.full((4,), 3.0)}
        return clean_batch(step)

    events = []
    tr = ElasticTrainer(quad_step, batch_fn, checkpoint_every=5,
                        on_event=lambda k, i: events.append((k, i)))
    params, _ = tr.run({"w": jnp.zeros(())}, None, 10, jax.random.PRNGKey(0))
    assert len(tr.faults) == 1 and tr.faults[0]["step"] == 7
    assert ("rollback", {"to_step": 5}) in events
    assert len(tr.losses) == 10                      # replayed, no double-count
    assert np.isfinite(float(params["w"]))
    assert float(params["w"]) == pytest.approx(3.0, abs=0.5)


def test_deterministic_fault_exhausts_retries():
    def batch_fn(step):
        if step == 3:  # permanent fault at step 3
            return {"x": jnp.full((4,), jnp.nan), "y": jnp.full((4,), 3.0)}
        return clean_batch(step)

    tr = ElasticTrainer(quad_step, batch_fn, checkpoint_every=2, max_retries=2)
    with pytest.raises(FloatingPointError):
        tr.run({"w": jnp.zeros(())}, None, 10, jax.random.PRNGKey(0))
    assert len(tr.faults) == 3  # initial + 2 retries


def test_orbax_checkpoints_written(tmp_path):
    tr = ElasticTrainer(quad_step, clean_batch, checkpoint_dir=str(tmp_path),
                        checkpoint_every=3)
    tr.run({"w": jnp.zeros(())}, None, 3, jax.random.PRNGKey(0))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_0", "step_3"]


def test_watchdog_flags_hung_step():
    def slow_step(params, opt_state, batch, rng):
        time.sleep(0.6)
        return quad_step(params, opt_state, batch, rng)

    tr = ElasticTrainer(slow_step, clean_batch, checkpoint_every=5,
                        max_retries=0, step_timeout_s=0.2)
    with pytest.raises(TimeoutError):
        tr.run({"w": jnp.zeros(())}, None, 3, jax.random.PRNGKey(0))
    assert tr.faults and "exceeded" in tr.faults[0]["error"]
