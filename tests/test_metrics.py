"""Metrics registry tests + sharded-pipeline smoke (multi-device only)."""

import time

import jax
import pytest

from reptext.utils.metrics import Metrics


def test_counters_and_gauges():
    m = Metrics()
    m.inc("requests")
    m.inc("requests", 2)
    m.set("queue_depth", 5)
    snap = m.snapshot()
    assert snap["counters"]["requests"] == 3
    assert snap["gauges"]["queue_depth"] == 5


def test_timings():
    m = Metrics()
    for _ in range(4):
        with m.time("step"):
            time.sleep(0.001)
    t = m.snapshot()["timings"]["step"]
    assert t["count"] == 4
    assert t["mean_s"] >= 0.001
    assert t["p95_s"] >= t["p50_s"]


def test_dump_json_parses():
    import json

    m = Metrics()
    m.inc("x")
    assert json.loads(m.dump_json())["counters"]["x"] == 1


@pytest.mark.slow  # two full tiny-pipeline compiles; sampler-level TP parity
# is in the fast tier via tests/mesh_scenarios.py::check_pipeline_tp_inference
@pytest.mark.skipif(len(jax.devices()) < 8, reason="requires 8 virtual devices")
def test_sharded_pipeline_generation():
    import jax.numpy as jnp
    import numpy as np

    from reptext.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
    )
    from reptext.conditioning import TextLine, build_conditions
    from reptext.parallel import make_mesh
    from reptext.pipelines import FluxRepTextPipeline

    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=64, width=64, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    conds = build_conditions([TextLine("Hi", (8, 16), font_size=24)], 64, 64)
    ids = dict(clip_ids=jnp.asarray([[3, 7, 255, 0, 0, 0, 0, 0]], jnp.int32),
               t5_ids=jnp.asarray([[5, 9, 1, 0, 0, 0]], jnp.int32))
    base = pipe(conds, **ids, seed=11)
    pipe.shard_for_inference(make_mesh(dp=2, tp=4))
    sharded = pipe(conds, **ids, seed=11)
    # tensor-parallel execution must reproduce the single-device result
    np.testing.assert_allclose(
        base.astype(np.float32), sharded.astype(np.float32), atol=2.0
    )  # uint8 images; tiny numeric drift from reduction order allowed
