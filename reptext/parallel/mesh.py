"""Device mesh construction for sharded inference/training.

The reference has no distributed machinery at all (SURVEY.md §2.3); this module
is a green-field design: a named ``jax.sharding.Mesh`` with ``dp``
(data/batch) and ``tp`` (tensor) axes over ``jax.devices()`` in order. The
cards of one host are joined all to all by NVLink, so the layout follows the
algorithm alone. XLA emits all collectives from sharding annotations and
hands them to NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, tp) mesh over the available devices.

    Defaults: all devices on the tp axis (inference-friendly for one image),
    i.e. dp=1, tp=n_devices. Pass explicit sizes to override; dp*tp must equal
    the device count used.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
