"""Failure detection + elastic (checkpoint/resume) training loop.

The reference has no failure handling at all (SURVEY.md §5 "Failure
detection/elastic: none"); this module is the green-field
equivalent of an elastic trainer:

- **Periodic checkpointing** (orbax) of params + opt_state + step counter.
- **Anomaly detection**: every step's loss is fetched as a host scalar (the
  fetch doubles as the device heartbeat — a dead/hung chip surfaces here as
  an exception or a watchdog timeout); non-finite losses trigger rollback.
- **Failure recovery**: on a detected fault (device error, preemption
  exception, NaN loss, hung step), state is restored from the last good
  checkpoint and training resumes from that step. Data-loader state is
  rewound by replaying the step-indexed batch function — batches are
  addressed by step, so recovery is deterministic.
- **Watchdog**: a monitor thread flags steps exceeding ``step_timeout_s``
  (hung device) so the controller can re-create the backend or
  re-exec; in-process we surface it as a TimeoutError fault.

Single-controller scope (one JAX process driving a device mesh). Multi-slice
elasticity (scaling the dp axis across restarts) composes on top: the
checkpoint is mesh-independent (fully-addressable arrays), so a resume may
use a different device count.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np


class StepWatchdog:
    """Flags a step that exceeds ``timeout_s`` (hung device)."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self.expired = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
        self.expired.clear()

    def disarm(self):
        with self._lock:
            self._deadline = None

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                d = self._deadline
            if d is not None and time.monotonic() > d:
                self.expired.set()
            time.sleep(min(self.timeout_s / 4, 1.0))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


class ElasticTrainer:
    """Checkpointed training loop with fault rollback.

    Args:
        train_step: jitted ``(params, opt_state, batch, rng) ->
            (params, opt_state, loss)`` (see sampling/training.py).
        batch_fn: ``step -> batch`` — step-indexed so recovery replays
            deterministically.
        checkpoint_dir: orbax target; ``None`` keeps restore points in host
            RAM only (tests / ephemeral runs).
        checkpoint_every: steps between restore points.
        max_retries: faults tolerated per step before re-raising.
        step_timeout_s: watchdog limit per step (0 disables).
    """

    def __init__(
        self,
        train_step: Callable,
        batch_fn: Callable[[int], Dict[str, Any]],
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        max_retries: int = 2,
        step_timeout_s: float = 0.0,
        on_event: Optional[Callable[[str, dict], None]] = None,
    ):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.on_event = on_event or (lambda kind, info: None)
        self._watchdog = StepWatchdog(step_timeout_s) if step_timeout_s > 0 else None
        self._restore: Optional[dict] = None  # last good {step, params, opt_state}
        self.faults: list = []
        self.losses: list = []
        self._fault_counts: Dict[int, int] = {}

    # ------------------------------------------------------------- ckpt io

    def _save(self, step: int, params, opt_state):
        state = {
            "step": step,
            "params": jax.device_get(params),
            "opt_state": jax.device_get(opt_state),
        }
        self._restore = state
        if self.checkpoint_dir:
            import orbax.checkpoint as ocp

            path = os.path.join(os.path.abspath(self.checkpoint_dir), f"step_{step}")
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(path, {"step": np.asarray(step), "params": state["params"]},
                       force=True)
            ckptr.wait_until_finished()
        self.on_event("checkpoint", {"step": step})

    def _rollback(self):
        if self._restore is None:
            raise RuntimeError("fault before first checkpoint; nothing to restore")
        state = self._restore
        params = jax.device_put(state["params"])
        opt_state = jax.device_put(state["opt_state"])
        self.on_event("rollback", {"to_step": state["step"]})
        return state["step"], params, opt_state

    # --------------------------------------------------------------- loop

    def run(self, params, opt_state, num_steps: int, rng: jax.Array):
        """Run ``num_steps`` with fault recovery; returns (params, opt_state)."""
        step = 0
        self._save(step, params, opt_state)  # step-0 restore point
        while step < num_steps:
            batch = self.batch_fn(step)
            step_rng = jax.random.fold_in(rng, step)
            if self._watchdog:
                self._watchdog.arm()
            try:
                params, opt_state, loss = self.train_step(
                    params, opt_state, batch, step_rng
                )
                loss_val = float(loss)  # heartbeat: forces device completion
                if self._watchdog and self._watchdog.expired.is_set():
                    raise TimeoutError(
                        f"step {step} exceeded {self._watchdog.timeout_s}s"
                    )
                if not np.isfinite(loss_val):
                    raise FloatingPointError(f"non-finite loss {loss_val} at step {step}")
            except Exception as e:  # noqa: BLE001 — device faults, NaN, hangs
                self.faults.append({"step": step, "error": f"{type(e).__name__}: {e}"})
                self.on_event("fault", self.faults[-1])
                # per-step fault count: a deterministic fault (same step keeps
                # failing after every rollback) must terminate, not loop
                self._fault_counts[step] = self._fault_counts.get(step, 0) + 1
                if self._fault_counts[step] > self.max_retries:
                    raise
                step, params, opt_state = self._rollback()
                del self.losses[step:]  # replayed steps re-record their losses
                continue
            finally:
                if self._watchdog:
                    self._watchdog.disarm()
            self.losses.append(loss_val)
            step += 1
            if step % self.checkpoint_every == 0 or step == num_steps:
                self._save(step, params, opt_state)
        if self._watchdog:
            self._watchdog.close()
        return params, opt_state
