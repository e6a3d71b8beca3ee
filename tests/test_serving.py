"""Serving layer test: HTTP server + worker over the tiny pipeline."""

import base64
import http.client
import json
import threading

import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.pipelines import FluxRepTextPipeline
from reptext.serving import GenerationServer

H = W = 64


@pytest.fixture(scope="module")
def server():
    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=H, width=W, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    srv = GenerationServer(pipe, host="127.0.0.1", port=0, request_timeout_s=1200)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def _request(server, method, path, payload=None):
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=1200)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_healthz(server):
    status, data = _request(server, "GET", "/healthz")
    assert status == 200 and data["ok"] is True


@pytest.mark.smoke
def test_generate_roundtrip(server):
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a neon sign",
        "lines": [{"text": "Hi", "position": [8, 16], "font_size": 24}],
        "seed": 7,
    })
    assert status == 200, data
    png = base64.b64decode(data["image_png_base64"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert data["shape"] == [H, W, 3]


def test_bad_request(server):
    status, data = _request(server, "POST", "/generate", {"lines": []})
    assert status == 400
    status, _ = _request(server, "POST", "/nope", {})
    assert status == 404


def test_metrics_endpoint(server):
    status, data = _request(server, "GET", "/metrics")
    assert status == 200
    assert "counters" in data and "timings" in data and "gauges" in data
    # the earlier generate test must have been counted
    assert data["counters"].get("serving.requests_completed", 0) >= 1


def test_worker_coalesces_same_signature_batch(server):
    """Two queued same-signature requests are served by ONE batched call."""
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    m = Metrics()
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=m)
    # do NOT start the thread — drive scheduling rounds directly
    r1 = GenerationRequest(prompt="sign A",
                           lines=[{"text": "Hi", "position": [8, 16]}], seed=3)
    r2 = GenerationRequest(prompt="sign B",
                           lines=[{"text": "Yo", "position": [4, 8]}], seed=9)
    worker.submit(r1)
    worker.submit(r2)
    served = worker._process_once()
    assert served == 2
    assert worker.batches == 1 and worker.completed == 2
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    assert r1._result.shape == (H, W, 3) and r2._result.shape == (H, W, 3)
    assert not (r1._result == r2._result).all()  # distinct seeds/conds
    snap = m.snapshot()
    assert snap["timings"]["serving.batch_size"]["max_s"] == 2.0


def test_worker_splits_mismatched_signatures(server):
    """Different (steps, guidance, n_lines) must NOT coalesce."""
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    worker = GenerationWorker(server.worker.pipeline, max_batch=4,
                              metrics=Metrics())
    r1 = GenerationRequest(prompt="a", lines=[{"text": "Hi", "position": [8, 16]}])
    r2 = GenerationRequest(prompt="b", lines=[{"text": "Hi", "position": [8, 16]}],
                           num_steps=1)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 1  # only r1's signature batch
    assert r1._done.is_set() and not r2._done.is_set()
    assert worker._process_once() == 1  # r2 follows
    assert r2._done.is_set() and r2._error is None


def test_unknown_mode_rejected(server):
    status, data = _request(server, "POST", "/generate",
                            {"prompt": "x", "mode": "video"})
    assert status == 400 and "mode" in data["error"]


@pytest.mark.smoke
def test_inpaint_request_roundtrip(server):
    """Served inpaint: dual-ControlNet CFG request through the worker."""
    import io as _io

    import dataclasses
    import numpy as np
    from PIL import Image

    from reptext.pipelines import FluxRepTextInpaintPipeline
    from reptext.serving import GenerationRequest, GenerationWorker

    inpaint_pipe = FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=dataclasses.replace(
            ControlNetConfig().tiny(), extra_condition_channels=4),
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=H, width=W, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    worker = GenerationWorker(server.worker.pipeline,
                              inpaint_pipeline=inpaint_pipe)

    def png_b64(arr):
        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    img = np.full((H, W, 3), 128, np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    req = GenerationRequest(
        prompt="a sign", lines=[{"text": "Hi", "position": [8, 16]}],
        mode="inpaint", image_b64=png_b64(img), mask_b64=png_b64(mask),
    )
    worker.submit(req)
    assert worker._process_once() == 1
    assert req._error is None, req._error
    assert req._result.shape == (H, W, 3)


def test_resolution_bucket_roundtrip(server):
    """Per-request resolution rides a bucket pipeline sharing resident params."""
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a sign",
        "lines": [{"text": "Hi", "position": [8, 16], "font_size": 20}],
        "width": 80,
    })
    assert status == 200, data
    assert data["shape"] == [H, 80, 3]
    # view pipelines share the resident params (no weight duplication)
    view = server.worker._res_pipelines[(H, 80)]
    assert view.params is server.worker.pipeline.params


def test_resolution_must_be_multiple_of_16(server):
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a sign",
        "lines": [{"text": "Hi", "position": [8, 16]}],
        "width": 50,
    })
    assert status == 500 and "x16" in data["error"]


def test_oom_batch_splits_and_requests_survive(server):
    """A RESOURCE_EXHAUSTED batch shrinks the coalescing cap and the same
    requests complete under the smaller cap — no request fails."""
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    real = server.worker.pipeline

    class OOMBatchPipeline:
        pipe_cfg = real.pipe_cfg
        clip = real.clip
        t5 = real.t5

        def generate_batch(self, *a, **k):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Out of memory allocating 12345 bytes")

        def __call__(self, *a, **k):
            return real(*a, **k)

    m = Metrics()
    worker = GenerationWorker(OOMBatchPipeline(), max_batch=4, metrics=m)
    r1 = GenerationRequest(prompt="a", lines=[{"text": "Hi", "position": [8, 16]}])
    r2 = GenerationRequest(prompt="b", lines=[{"text": "Yo", "position": [4, 8]}])
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 0          # OOM -> split, nothing resolves
    assert worker.max_batch == 4                # configured cap untouched
    assert worker._cap_for(r1) == 1             # shrunk only for this bucket
    assert not r1._done.is_set() and not r2._done.is_set()
    assert worker._process_once() == 1          # retried serially
    assert worker._process_once() == 1
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    assert r1._result.shape == (H, W, 3) and r2._result.shape == (H, W, 3)
    assert m.snapshot()["counters"]["serving.oom_batch_splits"] == 1
    assert worker.failed == 0


def test_oom_cap_is_per_resolution_and_restores(server):
    """The OOM shrink only caps the failing resolution bucket, and a cooldown
    of successful rounds doubles the cap back up to the configured max."""
    from reptext.serving import GenerationRequest, GenerationWorker

    worker = GenerationWorker(server.worker.pipeline, max_batch=4)
    worker.oom_restore_after = 2
    r_small = GenerationRequest(
        prompt="a", lines=[{"text": "Hi", "position": [8, 16]}])
    r_big = GenerationRequest(
        prompt="a", lines=[{"text": "Hi", "position": [8, 16]}],
        width=server.worker.pipeline.pipe_cfg.width,
        height=server.worker.pipeline.pipe_cfg.height)
    key = worker._res_key(r_small)
    worker._oom_caps[key] = 1
    worker._oom_success[key] = 0
    assert worker._cap_for(r_small) == 1
    assert worker._cap_for(r_big) == 4          # other bucket unaffected
    worker._note_batch_ok(r_small)
    worker._note_batch_ok(r_small)              # cooldown reached -> cap 2
    assert worker._cap_for(r_small) == 2
    worker._note_batch_ok(r_small)
    worker._note_batch_ok(r_small)              # cap 4 == configured -> drop
    assert worker._cap_for(r_small) == 4
    assert key not in worker._oom_caps


def test_oom_single_request_fails_cleanly(server):
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    real = server.worker.pipeline

    class OOMPipeline:
        pipe_cfg = real.pipe_cfg
        clip = real.clip
        t5 = real.t5

        def __call__(self, *a, **k):
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory")

    m = Metrics()
    worker = GenerationWorker(OOMPipeline(), max_batch=2, metrics=m)
    req = GenerationRequest(prompt="a", lines=[{"text": "Hi", "position": [8, 16]}])
    worker.submit(req)
    assert worker._process_once() == 1
    assert req._done.is_set() and "RESOURCE_EXHAUSTED" in req._error
    assert m.snapshot()["counters"]["serving.oom_failures"] == 1


def test_inpaint_without_pipeline_errors(server):
    from reptext.serving import GenerationRequest, GenerationWorker

    worker = GenerationWorker(server.worker.pipeline)  # no inpaint pipeline
    req = GenerationRequest(prompt="a", lines=[], mode="inpaint",
                            image_b64="eA==", mask_b64="eA==")
    worker.submit(req)
    worker._process_once()
    assert req._error and "inpaint pipeline" in req._error


def test_ip_adapter_batch_coalesces_with_plain(server):
    """An image-prompt request coalesces with a plain one in one batched
    call (per-request ip tokens + [B] scales), and the zero-init adapter is
    an exact no-op: results match the same seeds served without any adapter."""
    import dataclasses
    import io as _io

    import numpy as np
    from PIL import Image

    from reptext.configs import CLIPVisionConfig, IPAdapterConfig
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    # baseline: plain pipeline, no adapter
    base_worker = GenerationWorker(server.worker.pipeline, max_batch=4,
                                   metrics=Metrics())
    lines1 = [{"text": "Hi", "position": [8, 16]}]
    lines2 = [{"text": "Yo", "position": [4, 8]}]
    b1 = GenerationRequest(prompt="sign A", lines=lines1, seed=3)
    b2 = GenerationRequest(prompt="sign B", lines=lines2, seed=9)
    base_worker.submit(b1)
    base_worker.submit(b2)
    assert base_worker._process_once() == 2

    # ip-enabled pipeline (fresh instance; zero-init to_v_ip)
    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=H, width=W, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    pipe.attach_ip_adapter(
        vision_cfg=CLIPVisionConfig().tiny(),
        ip_cfg=dataclasses.replace(
            IPAdapterConfig().tiny(),
            cross_attention_dim=pipe.flux.config.joint_attention_dim),
    )
    worker = GenerationWorker(pipe, max_batch=4, metrics=Metrics())
    style = np.random.default_rng(0).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(style).save(buf, format="PNG")
    ip_b64 = base64.b64encode(buf.getvalue()).decode()

    r1 = GenerationRequest(prompt="sign A", lines=lines1, seed=3,
                           ip_image_b64=ip_b64, ip_scale=0.8)
    r2 = GenerationRequest(prompt="sign B", lines=lines2, seed=9)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 2       # one coalesced batch
    assert worker.batches == 1
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    np.testing.assert_array_equal(r1._result, b1._result)
    np.testing.assert_array_equal(r2._result, b2._result)


def test_worker_coalesces_inpaint_batch(server):
    """Two queued same-signature INPAINT requests are served by ONE batched
    dual-CN CFG sampler call (round 4: inpaint coalescing, previously
    serial)."""
    import dataclasses
    import io as _io

    import numpy as np
    from PIL import Image

    from reptext.pipelines import FluxRepTextInpaintPipeline
    from reptext.serving import GenerationRequest, GenerationWorker
    from reptext.utils.metrics import Metrics

    inpaint_pipe = FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=dataclasses.replace(
            ControlNetConfig().tiny(), extra_condition_channels=4),
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=H, width=W, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    m = Metrics()
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=m,
                              inpaint_pipeline=inpaint_pipe)

    def png_b64(arr):
        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (H, W, 3), np.uint8).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    r1 = GenerationRequest(
        prompt="sign A", lines=[{"text": "Hi", "position": [8, 16]}],
        mode="inpaint", image_b64=png_b64(img), mask_b64=png_b64(mask), seed=3)
    r2 = GenerationRequest(
        prompt="sign B", lines=[{"text": "Yo", "position": [4, 8]}],
        mode="inpaint", image_b64=png_b64(img), mask_b64=png_b64(mask), seed=9)
    worker.submit(r1)
    worker.submit(r2)
    served = worker._process_once()
    assert served == 2
    assert worker.batches == 1 and worker.completed == 2
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    assert r1._result.shape == (H, W, 3) and r2._result.shape == (H, W, 3)
    assert not (r1._result == r2._result).all()  # distinct seeds/conds
