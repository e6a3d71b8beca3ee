"""Production serving layer: coalescing request queue + worker + HTTP JSON API.

The reference is a notebook/script-driven stack with no serving path
(SURVEY.md §1 L4). This module provides the deployment-shaped surface:

- :class:`GenerationWorker`: a background thread draining a request queue
  through one resident pipeline. Queued requests with the same signature
  (steps, guidance scale, number of text lines) are coalesced onto the batch
  axis of a single fused sampler call (``pipeline.generate_batch``), so a
  burst of N compatible requests costs ~one request of wall-clock instead
  of N. Batch sizes are bucketed to powers of two so the compile cache stays
  small (XLA compiles once per (signature, bucket)).
- :class:`GenerationServer`: a stdlib HTTP server exposing
  ``POST /generate`` (JSON: prompt, text lines, seed, steps) returning a
  base64 PNG, ``GET /healthz``, and ``GET /metrics`` (the
  :mod:`reptext.utils.metrics` snapshot: request counters, batch sizes,
  queue depth, latency percentiles).

Single-host scope; multi-host serving rides the same pipeline over a
`jax.sharding.Mesh` (parallel/) and a fleet fronting this API.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from reptext.utils.image import load_image, resize_image
from reptext.utils.metrics import Metrics, default_metrics
from reptext.utils.png import encode_png


@dataclass
class GenerationRequest:
    prompt: str
    lines: List[Dict[str, Any]]            # [{text, position, color?, font_size?}]
    seed: int = 42
    num_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    width: Optional[int] = None            # resolution bucket (x16; default cfg)
    height: Optional[int] = None
    mode: str = "txt2img"                  # "txt2img" | "inpaint"
    image_b64: Optional[str] = None        # inpaint: base64 PNG input image
    mask_b64: Optional[str] = None         # inpaint: base64 PNG white-on-black mask
    negative_prompt: Optional[str] = None  # inpaint true-CFG negative
    ip_image_b64: Optional[str] = None     # image-prompt (IP-Adapter) PNG
    ip_scale: float = 1.0
    # pre-encoded prompt (generate-tier serving): a deployment may encode
    # prompts elsewhere (another card or host) and send the embeddings.
    # [S_txt, D] / [D] numpy arrays; both must be set together and the
    # whole batch must carry them.
    prompt_embeds: Optional[np.ndarray] = None
    pooled_embeds: Optional[np.ndarray] = None
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional[np.ndarray] = None
    _error: Optional[str] = None


def _bucket(n: int, cap: int) -> int:
    """Round batch size up to the next power of two (bounded by cap)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class GenerationWorker:
    """Drains a queue through a resident pipeline on a worker thread,
    coalescing compatible requests into batched sampler calls."""

    def __init__(self, pipeline, tokenizer=None, max_queue: int = 64,
                 max_batch: int = 4, batch_window_s: float = 0.0,
                 metrics: Optional[Metrics] = None, inpaint_pipeline=None):
        self.pipeline = pipeline
        self.inpaint_pipeline = inpaint_pipeline
        self.tokenizer = tokenizer  # callable(prompt) -> (clip_ids, t5_ids)
        self.requests: "queue.Queue[GenerationRequest]" = queue.Queue(max_queue)
        self.max_batch = max(1, max_batch)
        self.batch_window_s = batch_window_s
        # HBM-OOM degradation state: the coalescing cap is shrunk per
        # resolution bucket (OOM is resolution-dependent), never globally,
        # and restored by doubling after a cooldown of successful rounds.
        self._oom_caps: Dict = {}     # (w, h) -> shrunken cap
        self._oom_success: Dict = {}  # (w, h) -> consecutive OK batches
        self.oom_restore_after = 8    # successful rounds before cap doubles
        self.metrics = metrics if metrics is not None else default_metrics
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._pending: List[GenerationRequest] = []  # worker-thread only
        self._res_pipelines: Dict = {}               # (h, w) -> pipeline view
        self.completed = 0
        self.failed = 0
        self.batches = 0

    def start(self):
        self._thread.start()
        return self

    def warmup(self, text: str = "Hi", position=(16, 16),
               prompt_embeds=None, pooled_embeds=None) -> float:
        """Compile all generation graphs with a dummy request; returns seconds.

        Call before accepting traffic so the first real request doesn't pay
        multi-minute XLA compiles. Generate-tier deployments (evicted
        encoders) pass pre-encoded ``prompt_embeds``/``pooled_embeds``.
        """
        req = GenerationRequest(
            prompt="warmup", lines=[{"text": text, "position": list(position)}],
            prompt_embeds=prompt_embeds, pooled_embeds=pooled_embeds,
        )
        t0 = time.time()
        self.submit(req)
        req._done.wait()
        if req._error:
            raise RuntimeError(f"warmup failed: {req._error}")
        return time.time() - t0

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        self.requests.put(req, block=False)
        self.metrics.inc("serving.requests_submitted")
        return req

    # ----------------------------------------------------------- internals

    @staticmethod
    def _signature(req: GenerationRequest):
        # pre-encoded and prompt-string requests never coalesce (mixing
        # would tokenize the embed-carriers' placeholder prompt); the embed
        # sequence length is part of the compiled graph shape
        pe_shape = (None if req.prompt_embeds is None
                    else tuple(np.asarray(req.prompt_embeds).shape))
        return (req.mode, req.num_steps, req.guidance_scale, len(req.lines),
                req.width, req.height, pe_shape)

    @staticmethod
    def _res_key(req: GenerationRequest):
        return (req.width, req.height)

    def _cap_for(self, req: GenerationRequest) -> int:
        """Effective coalescing cap: configured max_batch, tightened by any
        live HBM-OOM shrink for this request's resolution bucket."""
        return min(self.max_batch,
                   self._oom_caps.get(self._res_key(req), self.max_batch))

    def _note_batch_ok(self, req: GenerationRequest) -> None:
        """Cooldown-based cap restore: after `oom_restore_after` successful
        rounds at a shrunken cap, double it; drop the entry once it reaches
        the configured max_batch again."""
        key = self._res_key(req)
        if key not in self._oom_caps:
            return
        self._oom_success[key] = self._oom_success.get(key, 0) + 1
        if self._oom_success[key] >= self.oom_restore_after:
            self._oom_success[key] = 0
            self._oom_caps[key] *= 2
            if self._oom_caps[key] >= self.max_batch:
                del self._oom_caps[key]
                self._oom_success.pop(key, None)

    def _pipeline_for(self, req: GenerationRequest):
        """Resolution-bucket routing: one pipeline view per (height, width),
        all sharing the resident params (FluxRepTextPipeline.with_resolution).
        """
        if req.width is None and req.height is None:
            return self.pipeline
        cfg = self.pipeline.pipe_cfg
        h = int(req.height or cfg.height)
        w = int(req.width or cfg.width)
        key = (h, w)
        if key not in self._res_pipelines:
            self._res_pipelines[key] = self.pipeline.with_resolution(h, w)
        return self._res_pipelines[key]

    def _tokenize(self, prompt: str):
        if self.tokenizer is not None:
            return self.tokenizer(prompt)
        from reptext.cli import _tokenize

        return _tokenize(prompt, self.pipeline.clip.config, self.pipeline.t5.config, None)

    def _collect_batch(self) -> List[GenerationRequest]:
        """Pop one request (blocking briefly), then gather every queued
        request with the same signature, up to max_batch. Non-matching
        requests stay pending in arrival order."""
        if not self._pending:
            try:
                self._pending.append(self.requests.get(timeout=0.2))
            except queue.Empty:
                return []
        if self.batch_window_s > 0:
            time.sleep(self.batch_window_s)  # linger: let a burst arrive
        while True:
            try:
                self._pending.append(self.requests.get_nowait())
            except queue.Empty:
                break
        lead = self._pending[0]
        sig = self._signature(lead)
        cap = self._cap_for(lead)
        batch, rest = [], []
        for r in self._pending:
            if len(batch) < cap and self._signature(r) == sig:
                batch.append(r)
            else:
                rest.append(r)
        self._pending = rest
        return batch

    def _run_batch(self, batch: List[GenerationRequest]) -> None:
        from reptext.conditioning import TextLine, build_conditions

        import jax.numpy as jnp

        pipe = self._pipeline_for(batch[0])  # resolution is in the signature
        cfg = pipe.pipe_cfg
        pre_encoded = all(r.prompt_embeds is not None for r in batch)
        conds_list, clip_l, t5_l, pe_l, pl_l = [], [], [], [], []
        for req in batch:
            lines = [
                TextLine(
                    l["text"], tuple(l["position"]),
                    tuple(l.get("color", (255, 255, 255))),
                    font_size=l.get("font_size"),
                )
                for l in req.lines
            ]
            conds_list.append(build_conditions(lines, cfg.width, cfg.height))
            if pre_encoded:
                pe_l.append(np.asarray(req.prompt_embeds))
                pl_l.append(np.asarray(req.pooled_embeds))
            else:
                cids, tids = self._tokenize(req.prompt)
                clip_l.append(np.asarray(cids)[0])
                t5_l.append(np.asarray(tids)[0])

        if pre_encoded:
            clip_ids = t5_ids = None
        else:
            # Pad t5 ids to the longest in the batch (pad id 0 == T5 <pad>).
            t5_len = max(t.shape[0] for t in t5_l)
            t5_np = np.zeros((len(batch), t5_len), np.int32)
            for i, t in enumerate(t5_l):
                t5_np[i, : t.shape[0]] = t
            clip_ids = jnp.asarray(np.stack(clip_l))
            t5_ids = jnp.asarray(t5_np)

        # Pad the batch to a power-of-two bucket (repeat the last request)
        # so XLA compiles one graph per bucket, not per batch size.
        n = len(batch)
        bucket = _bucket(n, self._cap_for(batch[0]))
        pad = bucket - n
        if pad:
            conds_list = conds_list + [conds_list[-1]] * pad
            if pre_encoded:
                pe_l += [pe_l[-1]] * pad
                pl_l += [pl_l[-1]] * pad
            else:
                clip_ids = jnp.concatenate(
                    [clip_ids, jnp.tile(clip_ids[-1:], (pad, 1))])
                t5_ids = jnp.concatenate(
                    [t5_ids, jnp.tile(t5_ids[-1:], (pad, 1))])
        seeds = [r.seed for r in batch] + [batch[-1].seed] * pad
        embed_kwargs = {}
        if pre_encoded:
            embed_kwargs = {
                "prompt_embeds": jnp.asarray(np.stack(pe_l)),
                "pooled_embeds": jnp.asarray(np.stack(pl_l)),
            }

        lead = batch[0]
        ip_kwargs = {}
        if any(r.ip_image_b64 for r in batch):
            # per-request image prompts coalesce with non-ip requests in the
            # same graph: absent prompts ride as zero tokens at scale 0
            ip_images = [self._decode_ip_image(r) for r in batch]
            ip_scales = [r.ip_scale for r in batch]
            if pad:
                ip_images += [None] * pad
                ip_scales += [0.0] * pad
            ip_kwargs = {"ip_adapter_images": ip_images,
                         "ip_adapter_scales": ip_scales}
        images = pipe.generate_batch(
            conds_list, clip_ids=clip_ids, t5_ids=t5_ids, seeds=seeds,
            num_inference_steps=lead.num_steps,
            guidance_scale=lead.guidance_scale,
            **embed_kwargs, **ip_kwargs,
        )
        for i, req in enumerate(batch):
            req._result = np.asarray(images[i])

    @staticmethod
    def _decode_ip_image(req: GenerationRequest):
        """base64 PNG -> uint8 RGB array (None if the request has none)."""
        if not req.ip_image_b64:
            return None
        return load_image(base64.b64decode(req.ip_image_b64), "RGB")

    @staticmethod
    def _decode_inpaint_inputs(req: GenerationRequest, height: int, width: int):
        """base64 PNG image + mask -> uint8 RGB [H, W, 3] and L [H, W] at
        the pipeline's resolution."""
        if not req.image_b64 or not req.mask_b64:
            raise ValueError("inpaint requires image_b64 and mask_b64 (PNG)")
        image = load_image(base64.b64decode(req.image_b64), "RGB")
        mask = load_image(base64.b64decode(req.mask_b64), "L")
        return (resize_image(image, height, width),
                resize_image(mask, height, width))

    def _run_inpaint(self, req: GenerationRequest) -> None:
        """Text inpainting (reference infer_inpaint.py driver, served)."""
        if self.inpaint_pipeline is None:
            raise RuntimeError(
                "server was started without an inpaint pipeline "
                "(cli: --serve-inpaint)"
            )
        from reptext.conditioning import TextLine, build_conditions
        from reptext.pipelines import DEFAULT_NEGATIVE_PROMPT

        pipe = self.inpaint_pipeline
        cfg = pipe.pipe_cfg
        image, mask = self._decode_inpaint_inputs(req, cfg.height, cfg.width)
        lines = [
            TextLine(
                l["text"], tuple(l["position"]),
                tuple(l.get("color", (255, 255, 255))),
                font_size=l.get("font_size"),
            )
            for l in req.lines
        ]
        conds = build_conditions(lines, cfg.width, cfg.height)
        clip_ids, t5_ids = self._tokenize(req.prompt)
        neg = req.negative_prompt or DEFAULT_NEGATIVE_PROMPT
        neg_clip, neg_t5 = self._tokenize(neg)
        # true CFG concatenates [neg, pos] embeds -> equal seq lengths required
        from reptext.text import pad_to_common_length

        t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
        clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
        images = pipe(
            conds, image=image, mask=mask,
            clip_ids=clip_ids, t5_ids=t5_ids,
            negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
            seed=req.seed, num_inference_steps=req.num_steps,
            guidance_scale=req.guidance_scale,
        )
        req._result = np.asarray(images[0])

    def _run_inpaint_batch(self, batch: List[GenerationRequest]) -> None:
        """Coalesced text inpainting: B same-signature requests in one fused
        dual-CN CFG sampler call (FluxRepTextInpaintPipeline.generate_batch).
        Round-3 served inpaint serially; batch-2 costs ~2x one request's
        step but replaces 2 full sampler invocations (compute-bound regime,
        BASELINE.md), so coalescing still wins on queueing latency."""
        if self.inpaint_pipeline is None:
            raise RuntimeError(
                "server was started without an inpaint pipeline "
                "(cli: --serve-inpaint)"
            )
        import jax.numpy as jnp

        from reptext.conditioning import TextLine, build_conditions
        from reptext.pipelines import DEFAULT_NEGATIVE_PROMPT

        pipe = self.inpaint_pipeline
        cfg = pipe.pipe_cfg
        conds_list, images, masks = [], [], []
        clip_l, t5_l, nclip_l, nt5_l = [], [], [], []
        for req in batch:
            image, mask = self._decode_inpaint_inputs(req, cfg.height, cfg.width)
            images.append(image)
            masks.append(mask)
            lines = [
                TextLine(
                    l["text"], tuple(l["position"]),
                    tuple(l.get("color", (255, 255, 255))),
                    font_size=l.get("font_size"),
                )
                for l in req.lines
            ]
            conds_list.append(build_conditions(lines, cfg.width, cfg.height))
            cids, tids = self._tokenize(req.prompt)
            ncids, ntids = self._tokenize(
                req.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
            clip_l.append(np.asarray(cids)[0])
            t5_l.append(np.asarray(tids)[0])
            nclip_l.append(np.asarray(ncids)[0])
            nt5_l.append(np.asarray(ntids)[0])

        def pad_stack(rows):
            # batch-wide pad (id 0 == pad for both vendored tokenizers); the
            # true-CFG concat needs pos and neg at EQUAL seq length
            width = max(max(r.shape[0] for r in rows), 1)
            out = np.zeros((len(rows), width), np.int32)
            for i, r in enumerate(rows):
                out[i, : r.shape[0]] = r
            return out

        t5_width = max(max(t.shape[0] for t in t5_l + nt5_l), 1)
        t5_ids = np.zeros((len(batch), t5_width), np.int32)
        nt5_ids = np.zeros((len(batch), t5_width), np.int32)
        for i, (t, nt) in enumerate(zip(t5_l, nt5_l)):
            t5_ids[i, : t.shape[0]] = t
            nt5_ids[i, : nt.shape[0]] = nt
        clip_ids = pad_stack(clip_l)
        nclip_ids = pad_stack(nclip_l)

        # power-of-two bucket (repeat the last request): one compiled graph
        # per bucket, same policy as _run_batch
        n = len(batch)
        bucket = _bucket(n, self._cap_for(batch[0]))
        pad = bucket - n
        if pad:
            conds_list += [conds_list[-1]] * pad
            images += [images[-1]] * pad
            masks += [masks[-1]] * pad
            clip_ids = np.concatenate([clip_ids, np.tile(clip_ids[-1:], (pad, 1))])
            t5_ids = np.concatenate([t5_ids, np.tile(t5_ids[-1:], (pad, 1))])
            nclip_ids = np.concatenate([nclip_ids, np.tile(nclip_ids[-1:], (pad, 1))])
            nt5_ids = np.concatenate([nt5_ids, np.tile(nt5_ids[-1:], (pad, 1))])
        seeds = [r.seed for r in batch] + [batch[-1].seed] * pad

        lead = batch[0]
        out = pipe.generate_batch(
            conds_list, images, masks,
            clip_ids=jnp.asarray(clip_ids), t5_ids=jnp.asarray(t5_ids),
            negative_clip_ids=jnp.asarray(nclip_ids),
            negative_t5_ids=jnp.asarray(nt5_ids),
            seeds=seeds, num_inference_steps=lead.num_steps,
            guidance_scale=lead.guidance_scale,
        )
        for i, req in enumerate(batch):
            req._result = np.asarray(out[i])

    @staticmethod
    def _is_oom(e: Exception) -> bool:
        """Device memory exhaustion (XLA RESOURCE_EXHAUSTED / HBM OOM)."""
        msg = f"{type(e).__name__}: {e}"
        return any(s in msg for s in (
            "RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
            "Attempting to allocate", "OOM",
        ))

    def _process_once(self) -> int:
        """One scheduling round: collect a batch, run it, resolve futures.
        Returns the number of requests served (0 if the queue was idle)."""
        batch = self._collect_batch()
        if not batch:
            return 0
        t0 = time.perf_counter()
        try:
            if batch[0].mode == "inpaint":
                if len(batch) == 1:
                    self._run_inpaint(batch[0])
                else:
                    self._run_inpaint_batch(batch)
            elif len(batch) == 1:
                # Single request: keep the exact __call__ semantics
                # (img2img, callbacks live here; also the warmed-up graph).
                req = batch[0]
                from reptext.conditioning import TextLine, build_conditions

                pipe = self._pipeline_for(req)
                cfg = pipe.pipe_cfg
                lines = [
                    TextLine(
                        l["text"], tuple(l["position"]),
                        tuple(l.get("color", (255, 255, 255))),
                        font_size=l.get("font_size"),
                    )
                    for l in req.lines
                ]
                conds = build_conditions(lines, cfg.width, cfg.height)
                if req.prompt_embeds is not None:
                    # generate-tier request: pre-encoded prompt (see
                    # GenerationRequest.prompt_embeds)
                    import jax.numpy as jnp

                    prompt_kwargs = {
                        "prompt_embeds": jnp.asarray(req.prompt_embeds)[None],
                        "pooled_embeds": jnp.asarray(req.pooled_embeds)[None],
                    }
                else:
                    clip_ids, t5_ids = self._tokenize(req.prompt)
                    prompt_kwargs = {"clip_ids": clip_ids, "t5_ids": t5_ids}
                ip_img = self._decode_ip_image(req)
                images = pipe(
                    conds, seed=req.seed,
                    num_inference_steps=req.num_steps,
                    guidance_scale=req.guidance_scale,
                    **prompt_kwargs,
                    **({"ip_adapter_image": ip_img,
                        "ip_adapter_scale": req.ip_scale}
                       if ip_img is not None else {}),
                )
                req._result = images[0]
            else:
                self._run_batch(batch)
            self.completed += len(batch)
            self.batches += 1
            self._note_batch_ok(batch[0])
            self.metrics.inc("serving.requests_completed", len(batch))
            self.metrics.inc("serving.batches")
            self.metrics.observe("serving.batch_size", float(len(batch)))
            self.metrics.observe("serving.generate_s", time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — report to client
            if self._is_oom(e) and len(batch) > 1:
                # Graceful HBM-OOM degradation: shrink the coalescing cap for
                # THIS resolution bucket to half the failed batch and retry
                # the same requests next round (no request fails or resolves;
                # they re-batch under the smaller cap). Other resolutions and
                # future traffic are unaffected; _note_batch_ok restores the
                # cap after a cooldown of successful rounds.
                key = self._res_key(batch[0])
                self._oom_caps[key] = max(1, len(batch) // 2)
                self._oom_success[key] = 0
                self._pending = batch + self._pending
                self.metrics.inc("serving.oom_batch_splits")
                self.metrics.set("serving.max_batch",
                                 float(self._cap_for(batch[0])))
                self.metrics.set("serving.queue_depth",
                                 self.requests.qsize() + len(self._pending))
                return 0
            msg = f"{type(e).__name__}: {e}"
            for req in batch:
                req._error = msg
            self.failed += len(batch)
            self.metrics.inc("serving.requests_failed", len(batch))
            if self._is_oom(e):
                self.metrics.inc("serving.oom_failures")
        self.metrics.set("serving.queue_depth",
                         self.requests.qsize() + len(self._pending))
        for req in batch:
            req._done.set()
        return len(batch)

    def _loop(self):
        while not self._stop.is_set():
            self._process_once()


def _make_handler(worker: GenerationWorker, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "completed": worker.completed,
                    "failed": worker.failed,
                    "queued": worker.requests.qsize(),
                })
            elif self.path == "/metrics":
                self._json(200, worker.metrics.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                mode = payload.get("mode", "txt2img")
                if mode not in ("txt2img", "inpaint"):
                    self._json(400, {"error": f"unknown mode {mode!r}"})
                    return
                req = GenerationRequest(
                    prompt=payload["prompt"],
                    lines=payload.get("lines", []),
                    seed=int(payload.get("seed", 42)),
                    num_steps=payload.get("num_steps"),
                    guidance_scale=payload.get("guidance_scale"),
                    width=payload.get("width"),
                    height=payload.get("height"),
                    mode=mode,
                    image_b64=payload.get("image_png_base64"),
                    mask_b64=payload.get("mask_png_base64"),
                    negative_prompt=payload.get("negative_prompt"),
                    ip_image_b64=payload.get("ip_image_png_base64"),
                    ip_scale=float(payload.get("ip_scale", 1.0)),
                )
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                worker.submit(req)
            except queue.Full:
                self._json(503, {"error": "queue full"})
                return
            if not req._done.wait(timeout=timeout_s):
                self._json(504, {"error": "generation timed out"})
                return
            if req._error:
                self._json(500, {"error": req._error})
                return
            self._json(200, {
                "image_png_base64": base64.b64encode(
                    encode_png(np.asarray(req._result))).decode(),
                "shape": list(req._result.shape),
            })

    return Handler


class GenerationServer:
    """HTTP front over a GenerationWorker. ``serve_forever`` blocks."""

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 8470,
                 tokenizer=None, request_timeout_s: float = 600.0,
                 warmup: bool = False, max_batch: int = 4,
                 batch_window_s: float = 0.0, inpaint_pipeline=None):
        self.worker = GenerationWorker(
            pipeline, tokenizer, max_batch=max_batch,
            batch_window_s=batch_window_s, inpaint_pipeline=inpaint_pipeline,
        ).start()
        if warmup:
            self.worker.warmup()
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.worker, request_timeout_s)
        )

    @property
    def address(self):
        return self.httpd.server_address

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.worker.stop()
