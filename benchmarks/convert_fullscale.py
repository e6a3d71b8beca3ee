"""Full-scale converter dry-run: a FLUX.1-dev-sized synthetic checkpoint
through the real conversion CLI.

Real published weights cannot be fetched in this environment (zero egress),
so the converter's *numerics* are pinned by torch parity at tiny config
(tests/test_torch_parity_model.py) — but its *scale* behavior (host memory,
multi-shard reads, 12B-param stacking, orbax write throughput) was unproven.
This harness builds a synthetic HF snapshot with the exact full-model
geometry and key names — FLUX.1-dev transformer (19 double + 38 single,
24x128 heads, bf16, sharded safetensors) and the RepText ControlNet at its
published from_transformer depth (4+10, reference
RepText/controlnet_flux.py:182-214) — runs `python -m reptext.io.
convert_cli`, restores a leaf to prove readability, and reports sizes, wall
times, and peak RSS as one JSON line.

Tensor VALUES are uninitialized memory (np.empty bitcast to bf16): the run
validates layout/memory/scale, not math — generating 12B random values on
this 1-CPU host would dominate the measurement.

Run: python benchmarks/convert_fullscale.py [--scratch DIR]
(~60 GB scratch disk, ~60 GB peak RSS headroom recommended)
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


class _EmptyGen:
    """Stand-in RNG: standard_normal -> uninitialized bf16-viewed memory."""

    def standard_normal(self, shape):
        import ml_dtypes

        # allocate as bf16 directly (half the bytes of fp32); synth state
        # builders do `.astype(np.float32) * 0.02` on the result — override
        # astype to keep bf16 and skip the scale multiply cost via a view
        class _A(np.ndarray):
            def astype(self, dtype, *a, **k):  # noqa: D401
                return self

            def __mul__(self, other):
                return self

        arr = np.empty(shape, ml_dtypes.bfloat16)
        return arr.view(_A)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def dir_gb(path: str) -> float:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total / 1e9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scratch", default="/tmp/reptext_fullscale")
    ap.add_argument("--keep", action="store_true", help="do not delete scratch")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse an existing snapshot in --scratch (a slow "
                         "host makes the 30 GB snapshot build ~20 min; "
                         "conversion itself is the test)")
    args = ap.parse_args()

    import synth_checkpoints as synth

    from reptext.configs import ControlNetConfig, FluxConfig
    from reptext.io import convert_cli
    from reptext.io.checkpoint import LAYOUT_VERSION, checkpoint_layout_version

    scratch = os.path.abspath(args.scratch)
    flux_dir = os.path.join(scratch, "transformer")
    cn_dir = os.path.join(scratch, "controlnet")
    reuse = args.reuse and os.path.isdir(flux_dir) and os.path.isdir(cn_dir)
    if not reuse:
        shutil.rmtree(scratch, ignore_errors=True)
        os.makedirs(scratch)
    shutil.rmtree(os.path.join(scratch, "converted"), ignore_errors=True)
    report = {}
    def phase(msg):
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    flux_cfg = FluxConfig()                       # full 19+38, 24x128
    cn_cfg = ControlNetConfig()                   # published RepText: 4+10

    synth._rng = lambda seed=0: _EmptyGen()       # scale run: no value gen
    t0 = time.time()
    if reuse:
        phase("reusing existing snapshot")
    if not reuse:
      phase("writing full-scale snapshot")
      synth._write_component(
          flux_dir, synth.flux_state(flux_cfg),
          {
              "_class_name": "FluxTransformer2DModel",
              "in_channels": flux_cfg.in_channels,
              "num_layers": flux_cfg.num_layers,
              "num_single_layers": flux_cfg.num_single_layers,
              "attention_head_dim": flux_cfg.attention_head_dim,
              "num_attention_heads": flux_cfg.num_attention_heads,
              "joint_attention_dim": flux_cfg.joint_attention_dim,
              "pooled_projection_dim": flux_cfg.pooled_projection_dim,
              "guidance_embeds": flux_cfg.guidance_embeds,
              "axes_dims_rope": list(flux_cfg.axes_dims_rope),
          },
        shards=3,                                  # hub layout is multi-shard
      )
      synth.write_controlnet_snapshot(cn_dir, cn_cfg)
    report["snapshot_write_s"] = round(time.time() - t0, 1)
    phase(f"snapshot ready ({dir_gb(scratch):.1f} GB)")
    report["snapshot_gb"] = round(dir_gb(scratch), 2)
    report["rss_after_snapshot_gb"] = round(rss_gb(), 2)

    out = os.path.join(scratch, "converted")
    phase("converting (flux then controlnet)")
    t1 = time.time()
    rc = convert_cli.main([
        "--flux-dir", flux_dir, "--controlnet-dir", cn_dir, "--out", out,
    ])
    assert rc == 0
    report["convert_s"] = round(time.time() - t1, 1)
    report["converted_gb"] = round(dir_gb(out), 2)
    report["peak_rss_gb"] = round(rss_gb(), 2)
    assert checkpoint_layout_version(out) == LAYOUT_VERSION

    phase("restoring flux tree")
    # prove the orbax tree restores (metadata + one real leaf read)
    t2 = time.time()
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.restore(os.path.join(out, "flux"))
    leaf = np.asarray(tree["params"]["double_blocks"]["block"]["to_q"]["kernel"])
    assert leaf.shape == (flux_cfg.num_layers, flux_cfg.inner_dim, flux_cfg.inner_dim)
    report["restore_s"] = round(time.time() - t2, 1)
    report["flux_stacked_qkv_shape"] = list(leaf.shape)
    del tree, leaf

    if not args.keep:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
