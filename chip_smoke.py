"""Run the RepText main path once on a GPU and check what comes out.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # tensor- and sequence-parallel txt2img

Phases (one card), all in this one process, with random weights from fixed
seeds at the published FLUX.1-dev geometry:

0. device: the card, JAX and CUDA versions, which optional packages import;
1. attention: the chosen route (cuDNN) against the float32 reference;
2. txt2img through ``reptext.cli.main`` at 1024^2 (Arabic + Latin line);
3. inpaint through ``reptext.cli.main`` at 1280x960, dual ControlNet,
   true CFG (batch 2);
4. ``GenerationServer`` over HTTP: txt2img at two buckets and inpaint;
5. three ControlNet training steps through the CLI's ``_train``.

Every phase prints one line of numbers after the card's name and power limit
(``nvidia-smi``). A failed phase exits non-zero. Without a GPU the script
exits non-zero before any phase. The last line is the JSON result.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "results", "chip_smoke")

# Published geometry and the phases' workloads. STEPS is cut to a few: a
# step's cost is what the run measures, not the image.
SIZE = 1024
BUCKET = (1344, 768)            # (height, width): another x16 serving bucket
INPAINT = (960, 1280)           # (height, width): 4,800 image tokens
STEPS = 4
TRUE_CFG = 4.0
TRAIN_SIZE = 512
TRAIN_DEPTH = (4, 10)           # the RepText ControlNet's own depth
ATTENTION_LENGTHS = (4608, 5312, 16896)
LINES = (("مرحبا بكم", (180, 240)), ("OPEN DAILY", (300, 620)))
PROMPT = "a shop sign on a city street at dusk"

# Tolerances, relative to the reference's largest magnitude.
# bf16 keeps 8 significant bits: rounding the output alone costs up to 2^-9
# (~2e-3) of each value, ~4e-3 of the largest after the flash kernel's
# blockwise fp32 accumulation; 1e-2 leaves room for both and no more.
ATTN_FWD_TOL = 1e-2
# The gradients pass through two more bf16 roundings (P and dS) and sums
# over S=4,608 keys; 2e-2 is twice the forward bound.
ATTN_GRAD_TOL = 2e-2


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


CARD = None


def report(phase: str, **numbers) -> None:
    print(f"[{phase}] {CARD} | {json.dumps(numbers, ensure_ascii=False)}", flush=True)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling while active, and
    the backend compile seconds of the costliest functions."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.by_function = {}
        self._on = False
        jax.monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, duration, fun_name="?", **_):
        if self._on and event.startswith("/jax/core/compile/"):
            self.seconds += duration
            if event.endswith("backend_compile_duration"):
                self.by_function[fun_name] = self.by_function.get(fun_name, 0.0) + duration

    def top(self, n: int = 4):
        costly = sorted(self.by_function.items(), key=lambda kv: -kv[1])[:n]
        return {name: round(sec, 1) for name, sec in costly}

    def __enter__(self):
        self.seconds, self.by_function, self._on = 0.0, {}, True
        return self

    def __exit__(self, *exc):
        self._on = False


def peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0))


def timing_sum(name: str) -> float:
    """Total seconds recorded under ``name`` in the process metrics."""
    from reptext.utils.metrics import default_metrics

    t = default_metrics.snapshot()["timings"].get(name)
    return t["mean_s"] * t["count"] if t else 0.0


def check_png(data: bytes, shape) -> np.ndarray:
    from reptext.utils.png import decode_png

    img = decode_png(data)
    if img.shape != tuple(shape):
        raise AssertionError(f"PNG shape {img.shape}, want {tuple(shape)}")
    if float(img.std()) == 0.0:
        raise AssertionError("PNG pixels are constant")
    return img


def model_configs(depth=None):
    from reptext.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig

    flux = FluxConfig()
    if depth is not None:
        flux = dataclasses.replace(flux, num_layers=depth[0], num_single_layers=depth[1])
    return flux, ControlNetConfig(), VAEConfig(), CLIPConfig(), T5Config()


def text_args():
    argv = []
    for text, (x, y) in LINES:
        argv += ["--text", text, "--position", str(x), str(y)]
    return argv


# ------------------------------------------------------------------ phases


def phase_device() -> dict:
    import jax

    dev = jax.devices()[0]
    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("flax", "PIL", "orbax", "safetensors", "torch")}
    numbers = {"jax": jax.__version__, "platform": dev.platform, "kind": dev.device_kind,
               "count": len(jax.devices()),
               "runtime": " ".join(dev.client.platform_version.split()),
               "importable": mods}
    report("phase 0 device", **numbers)
    return numbers


def phase_attention() -> None:
    import jax
    import jax.numpy as jnp

    from reptext.ops.attention import attention, resolve_backend, xla_attention

    if resolve_backend(None, jnp.bfloat16) != "cudnn":
        raise AssertionError("auto attention did not choose cudnn on this GPU")

    @jax.jit
    def reference(q, k, v):
        # float32 at full precision (no TF32), four heads at a time
        with jax.default_matmul_precision("highest"):
            outs = [xla_attention(*(x[:, h:h + 4].astype(jnp.float32) for x in (q, k, v)))
                    for h in range(0, q.shape[1], 4)]
        return jnp.concatenate(outs, axis=1)

    fused = jax.jit(attention)
    for s in ATTENTION_LENGTHS:
        q, k, v = (jax.random.normal(key, (1, 24, s, 128), jnp.float32).astype(jnp.bfloat16)
                   for key in jax.random.split(jax.random.PRNGKey(s), 3))
        got = fused(q, k, v).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(10):
            got = fused(q, k, v)
        got.block_until_ready()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        want = reference(q, k, v)
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)) / jnp.max(jnp.abs(want)))
        report("phase 1 attention", S=s, route="cudnn", fwd_rel_err=err, tol=ATTN_FWD_TOL,
               fwd_ms=ms, tflops=4 * 24 * s * s * 128 / ms / 1e9)
        if not err <= ATTN_FWD_TOL:
            raise AssertionError(f"attention S={s}: {err} > {ATTN_FWD_TOL}")

    s = ATTENTION_LENGTHS[0]
    q, k, v, w = (jax.random.normal(key, (1, 24, s, 128), jnp.float32).astype(jnp.bfloat16)
                  for key in jax.random.split(jax.random.PRNGKey(7), 4))

    def grads(f):
        loss = lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32) * w.astype(jnp.float32))  # noqa: E731
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)

    errs = [float(jnp.max(jnp.abs(a.astype(jnp.float32) - b)) / jnp.max(jnp.abs(b)))
            for a, b in zip(grads(attention), grads(reference))]
    report("phase 1 attention grad", S=s, dq_dk_dv_rel_err=errs, tol=ATTN_GRAD_TOL,
           reason="bf16 output rounding ~4e-3 relative; float32 reference at "
                  "precision=highest, since unstated float32 products may run in TF32")
    if not max(errs) <= ATTN_GRAD_TOL:
        raise AssertionError(f"attention gradient: {errs} > {ATTN_GRAD_TOL}")


def run_cli(phase: str, argv, out_png: str, shape, steps: int, clock: CompileClock) -> None:
    from reptext import cli

    sampled = timing_sum("pipeline.sampler_s")
    t0 = time.perf_counter()
    with clock:
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    with open(out_png, "rb") as f:
        check_png(f.read(), shape)
    sampler_s = timing_sum("pipeline.sampler_s") - sampled
    gc.collect()
    report(phase, wall_s=wall, compile_s=clock.seconds, costliest_compiles_s=clock.top(),
           sampler_s_first_call=sampler_s, steps=steps,
           ms_per_step_first_call=sampler_s / steps * 1e3, peak_bytes_in_use=peak_bytes(),
           png=os.path.relpath(out_png, ROOT))


def phase_txt2img(clock: CompileClock) -> None:
    out = os.path.join(OUT_DIR, "txt2img.png")
    argv = text_args() + ["--prompt", PROMPT, "--size", str(SIZE), "--steps", str(STEPS),
                          "--random-weights", "--seed", "0", "--output", out]
    run_cli("phase 2 txt2img", argv, out, (SIZE, SIZE, 3), STEPS, clock)


def synthetic_photo(height: int, width: int, seed: int = 0):
    """A smooth seeded RGB scene and a white box mask over its middle."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([xx / width, yy / height, 0.5 + 0.5 * np.sin(xx / 37.0 + yy / 53.0)], -1)
    img = np.clip(base * 200 + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)
    mask = np.zeros((height, width), np.uint8)
    mask[height // 4:3 * height // 4, width // 5:4 * width // 5] = 255
    return img, mask


def phase_inpaint(clock: CompileClock) -> None:
    from reptext.utils.png import encode_png

    h, w = INPAINT
    img, mask = synthetic_photo(h, w)
    paths = {}
    for name, arr in (("inpaint_input.png", img), ("inpaint_mask.png", mask)):
        paths[name] = os.path.join(OUT_DIR, name)
        with open(paths[name], "wb") as f:
            f.write(encode_png(arr))
    out = os.path.join(OUT_DIR, "inpaint.png")
    argv = text_args() + ["--mode", "inpaint", "--image", paths["inpaint_input.png"],
                          "--mask", paths["inpaint_mask.png"], "--prompt", PROMPT,
                          "--true-guidance-scale", str(TRUE_CFG), "--steps", str(STEPS),
                          "--random-weights", "--seed", "0", "--output", out]
    run_cli("phase 3 inpaint", argv, out, (h, w, 3), STEPS, clock)


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"POST {url}: HTTP {e.code}: {e.read()[:2000]!r}") from e


def phase_serve(clock: CompileClock) -> None:
    import jax.numpy as jnp

    from reptext import cli
    from reptext.pipelines import FluxRepTextInpaintPipeline, FluxRepTextPipeline
    from reptext.serving import GenerationServer
    from reptext.utils.png import encode_png

    flux, cn, vae, clip, t5 = model_configs()
    # the pipelines `reptext.cli --mode serve --serve-inpaint` builds,
    # with the inpaint pipeline at the inpaint phase's resolution and CFG
    txt_args = cli.build_parser().parse_args(
        ["--mode", "serve", "--steps", str(STEPS), "--random-weights"])
    inp_args = cli.build_parser().parse_args(
        ["--mode", "serve", "--steps", str(STEPS), "--random-weights",
         "--true-guidance-scale", str(TRUE_CFG)])
    common = dict(flux_cfg=flux, cn_cfg=cn, vae_cfg=vae, clip_cfg=clip, t5_cfg=t5,
                  compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    with clock:
        t0 = time.perf_counter()
        pipe = FluxRepTextPipeline.create(
            pipe_cfg=cli.pipeline_config(txt_args, SIZE, SIZE), **common)
        inpaint = FluxRepTextInpaintPipeline.create_inpaint(
            inpaint_cn_cfg=dataclasses.replace(cn, extra_condition_channels=4),
            pipe_cfg=cli.pipeline_config(inp_args, *INPAINT), params=dict(pipe.params), **common)
        build_s = time.perf_counter() - t0
    server = GenerationServer(pipe, host="127.0.0.1", port=0, max_batch=1,
                              inpaint_pipeline=inpaint)
    host, port = server.address
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{host}:{port}"
    lines = [{"text": t, "position": list(p)} for t, p in LINES]
    # the prompt the CLI phases sent, so the 1024^2 and inpaint graphs match
    prompt = cli.build_prompt(PROMPT, [t for t, _ in LINES], txt_args.prompt_suffix)
    img, mask = synthetic_photo(*INPAINT, seed=1)
    inpaint_req = {"mode": "inpaint", "prompt": prompt, "lines": lines, "seed": 3,
                   "image_png_base64": base64.b64encode(encode_png(img)).decode(),
                   "mask_png_base64": base64.b64encode(encode_png(mask)).decode()}
    requests = [
        (f"txt2img {SIZE}^2", {"prompt": prompt, "lines": lines, "seed": 1}, (SIZE, SIZE)),
        (f"txt2img {SIZE}^2 warm", {"prompt": prompt, "lines": lines, "seed": 2}, (SIZE, SIZE)),
        (f"txt2img {BUCKET[0]}x{BUCKET[1]}", {"prompt": prompt, "lines": lines, "seed": 4,
                                              "height": BUCKET[0], "width": BUCKET[1]}, BUCKET),
        (f"inpaint {INPAINT[0]}x{INPAINT[1]}", inpaint_req, INPAINT),
    ] + [(f"inpaint {INPAINT[0]}x{INPAINT[1]} warm", dict(inpaint_req, seed=seed), INPAINT)
         for seed in (5, 6, 7)]
    try:
        report("phase 4 serve", build_s=build_s, compile_s=clock.seconds)
        for name, payload, (h, w) in requests:
            sampled = timing_sum("pipeline.sampler_s")
            t0 = time.perf_counter()
            with clock:
                body = _post(url + "/generate", payload)
            wall = time.perf_counter() - t0
            check_png(base64.b64decode(body["image_png_base64"]), (h, w, 3))
            sampler_s = timing_sum("pipeline.sampler_s") - sampled
            report("phase 4 serve", request=name, status=200, s_per_image=wall,
                   sampler_s=sampler_s, ms_per_step=sampler_s / STEPS * 1e3,
                   compile_s=clock.seconds, costliest_compiles_s=clock.top(2))
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        served = metrics["counters"].get("serving.requests_completed", 0)
        if served < len(requests) or metrics["counters"].get("serving.requests_failed"):
            raise AssertionError(f"server metrics: {metrics['counters']}")
        report("phase 4 serve", metrics=metrics["timings"].get("serving.generate_s"),
               completed=served, peak_bytes_in_use=peak_bytes())
    finally:
        server.shutdown()
        thread.join(timeout=30)
    del pipe, inpaint, server
    gc.collect()


def phase_train(clock: CompileClock) -> None:
    import jax.numpy as jnp

    from reptext import cli
    from reptext.pipelines import FluxRepTextPipeline
    from reptext.utils.metrics import default_metrics

    args = cli.build_parser().parse_args(
        ["--mode", "train", "--random-weights", "--train-steps", "3", "--batch-size", "1",
         "--size", str(TRAIN_SIZE), "--seed", "0"])
    flux, cn, vae, clip, t5 = model_configs(TRAIN_DEPTH)
    before = (default_metrics.snapshot()["timings"].get("train.loss") or {}).get("count", 0)
    t0 = time.perf_counter()
    with clock:
        pipe = FluxRepTextPipeline.create(
            flux_cfg=flux, cn_cfg=cn, vae_cfg=vae, clip_cfg=clip, t5_cfg=t5,
            pipe_cfg=cli.pipeline_config(args, TRAIN_SIZE, TRAIN_SIZE),
            compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        rc = cli._train(args, pipe)
    wall = time.perf_counter() - t0
    loss = default_metrics.snapshot()["timings"]["train.loss"]
    if rc != 0 or loss["count"] - before != 3 or not np.isfinite(loss["max_s"]):
        raise AssertionError(f"training: rc={rc}, losses {loss}")
    report("phase 5 train", steps=3, depth=list(TRAIN_DEPTH), size=TRAIN_SIZE,
           why_depth="the full frozen base (11.9B params, 23.8 GB bf16), the ControlNet's "
                     "weights, grads and AdamW moments (2.95B each, 23.6 GB), its initial "
                     "copy (5.9 GB) and T5-XXL (9.5 GB) come to ~63 GB, more than the 60 GB "
                     "JAX takes of the card; the base is cut to the ControlNet's depth",
           loss_mean=loss["mean_s"], loss_max=loss["max_s"], wall_s=wall,
           compile_s=clock.seconds, costliest_compiles_s=clock.top(),
           peak_bytes_in_use=peak_bytes())
    del pipe
    gc.collect()


# ------------------------------------------------------------- four cards


def four_cards(clock: CompileClock) -> None:
    """txt2img under --shard 1x4 and --shard sp4 (ring, ulysses) against the
    single-card run of the same seeds: first-step velocity and final latents.
    One pipeline runs on one card, then tensor-parallel, then, its weights
    replicated, sequence-parallel with each backend."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from reptext import cli
    from reptext.conditioning import TextLine, build_conditions
    from reptext.parallel import make_mesh, make_sp_mesh
    from reptext.pipelines import FluxRepTextPipeline

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, JAX has {len(jax.devices())}")
    flux, cn, vae, clip, t5 = model_configs()
    args = cli.build_parser().parse_args(["--steps", str(FOUR_CARD_STEPS), "--random-weights"])
    conds = build_conditions([TextLine(t, p) for t, p in LINES], SIZE, SIZE)
    ref = None

    def run(name, pipe, embeds, noise):
        nonlocal ref
        # where the weights live once placed: tp splits them, sp replicates
        placed = [(d.memory_stats() or {}).get("bytes_in_use", 0) for d in jax.devices()[:4]]
        seen = {}

        def keep(step, lat):
            seen[step] = np.asarray(lat, np.float32)

        t0 = time.perf_counter()
        with clock:
            pipe(conds, prompt_embeds=embeds[0], pooled_embeds=embeds[1], latents=noise,
                 seed=0, output_type="latent", callback=keep, callback_steps=1)
        first = seen[1] - np.asarray(noise, np.float32)   # = dt * velocity
        last = seen[FOUR_CARD_STEPS]
        numbers = dict(run=name, wall_s=time.perf_counter() - t0, compile_s=clock.seconds,
                       bytes_in_use_per_device=placed)
        if ref is None:
            ref = (first, last)
            report("four cards", **numbers)
            return
        v_err = float(np.max(np.abs(first - ref[0])) / np.max(np.abs(ref[0])))
        lat_err = float(np.max(np.abs(last - ref[1])) / np.max(np.abs(ref[1])))
        report("four cards", velocity_rel_err=v_err, latents_rel_err=lat_err,
               tol=FOUR_CARD_TOL, **numbers)
        if not (v_err <= FOUR_CARD_TOL and lat_err <= FOUR_CARD_TOL):
            raise AssertionError(f"{name}: velocity {v_err}, latents {lat_err}")

    with clock:
        pipe = FluxRepTextPipeline.create(
            flux_cfg=flux, cn_cfg=cn, vae_cfg=vae, clip_cfg=clip, t5_cfg=t5,
            pipe_cfg=cli.pipeline_config(args, SIZE, SIZE),
            compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        embeds = pipe.encode_prompt(*cli._tokenize(PROMPT, clip, t5, None))
    noise = pipe.prepare_latents(jax.random.PRNGKey(11), 1)
    run("single card", pipe, embeds, noise)
    run("--shard 1x4", pipe.shard_for_inference(make_mesh(dp=1, tp=4)), embeds, noise)
    sp_mesh = make_sp_mesh(4)
    pipe.params = jax.device_put(pipe.params, NamedSharding(sp_mesh, PartitionSpec()))
    for backend in ("ring", "ulysses"):
        run(f"--shard sp4 --sp-backend {backend}",
            pipe.shard_for_sp(sp_mesh, backend=backend), embeds, noise)


# Two steps: the first gives the velocity, the second what it feeds forward.
FOUR_CARD_STEPS = 2
# bf16 activations: splitting the contraction over 4 cards (tp) or the keys
# over 4 blocks with an fp32 online softmax (sp) changes summation order, so
# each matmul output moves by bf16 rounding (~4e-3 relative); two Euler steps
# through 57 blocks let that grow, and 5e-2 of the largest value still
# separates a right result from a wrong shard (which is O(1) off).
FOUR_CARD_TOL = 5e-2


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the tensor- and sequence-parallel txt2img "
                             "comparison on four cards")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    import reptext  # noqa: F401  (fails outside a checkout of the repo)

    CARD = card()
    os.makedirs(OUT_DIR, exist_ok=True)
    clock = CompileClock()
    phase_device()
    if args.four_cards:
        four_cards(clock)
    else:
        phase_attention()
        phase_txt2img(clock)
        phase_inpaint(clock)
        phase_serve(clock)
        phase_train(clock)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
