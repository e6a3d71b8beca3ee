"""Per-layer activation capture + diffing for weight-conversion validation.

SURVEY.md §7 "Hard parts": conversion errors in a 12B model "surface only as
subtle image degradation; need per-layer activation diffing against recorded
torch activations". This module is that harness:

- :func:`capture_activations`: run a model (nn/module.py) with
  ``capture_intermediates=True`` and return a flat {path: array} dict of every
  module output.
- :func:`diff_activations`: compare against a recorded reference (e.g. torch
  hooks exported to .npz with matching path names) and report per-layer
  max-abs / relative errors, sorted worst-first.
- :func:`save_activations` / :func:`load_activations`: .npz round-trip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import numpy as np


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        arr = np.asarray(tree)
        if arr.dtype != object:  # skip non-numeric leaves (e.g. None in scans)
            out[prefix] = arr
    return out


def capture_activations(model, params, *args, **kwargs) -> Dict[str, np.ndarray]:
    """Forward pass capturing every submodule's output.

    Returns {module_path: activation} with '__call__' markers stripped.
    """
    _, state = model.apply(
        params, *args, capture_intermediates=True, mutable=["intermediates"], **kwargs
    )
    flat = _flatten(state["intermediates"])
    return {k.replace("/__call__", ""): v for k, v in flat.items()}


def diff_activations(
    ours: Dict[str, np.ndarray],
    reference: Dict[str, np.ndarray],
    rtol_warn: float = 1e-2,
) -> List[Tuple[str, float, float]]:
    """Compare activation dicts; returns [(path, max_abs_err, rel_err)] sorted
    worst-first. Paths present in only one dict are reported with inf."""
    report: List[Tuple[str, float, float]] = []
    for path in sorted(set(ours) | set(reference)):
        if path not in ours or path not in reference:
            report.append((path, float("inf"), float("inf")))
            continue
        a = np.asarray(ours[path], np.float32)
        b = np.asarray(reference[path], np.float32)
        if a.shape != b.shape:
            report.append((path, float("inf"), float("inf")))
            continue
        abs_err = float(np.max(np.abs(a - b))) if a.size else 0.0
        denom = float(np.max(np.abs(b))) + 1e-9
        report.append((path, abs_err, abs_err / denom))
    report.sort(key=lambda r: r[2], reverse=True)
    return report


def save_activations(acts: Dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in acts.items()})


def load_activations(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def print_report(report: List[Tuple[str, float, float]], top: int = 20) -> None:
    print(f"{'rel_err':>10} {'max_abs':>10}  path")
    for path, abs_err, rel in report[:top]:
        print(f"{rel:10.3e} {abs_err:10.3e}  {path}")
