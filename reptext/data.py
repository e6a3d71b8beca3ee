"""Training data pipeline: step-indexed glyph/text batches through the REAL
conditioning + VAE data path.

The reference ships no training or data code (SURVEY.md §0); the RepText paper
trains its ControlNet on (image, rendered-text condition) pairs. This module
supplies the equivalent here as a *synthetic text-render* dataset — the
standard bootstrap for text-in-image ControlNets when no photo corpus is
wired: deterministic random text lines are rendered through the production
conditioning frontend (conditioning/glyph.py: shape → render → canny +
position + region masks), VAE-encoded and packed exactly like inference
conditions (pipelines/txt2img.py::prepare_control_tokens), and the training
target is the glyph composite over a synthetic background, VAE-encoded to
packed latents. Swapping in a real photo corpus = replacing
``_target_image`` with dataset images (everything else is unchanged).

Batches are **addressed by step** so ElasticTrainer's rollback-and-replay
recovery is deterministic (sampling/elastic.py), and every random draw is
derived from (seed, step), never from global state.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reptext.conditioning import TextLine, build_conditions
from reptext.ops.latents import pack_latents, prepare_latent_image_ids
from reptext.utils.image import preprocess_images

# Arabic-first defaults (this framework's differentiator) with Latin mixed in.
DEFAULT_WORDS: Tuple[str, ...] = (
    "مرحبا", "سلام", "نور", "قهوة", "مدينة", "كتاب", "بحر", "شمس",
    "OPEN", "CAFE", "HELLO", "STOP", "2026", "سوق", "مطعم", "فندق",
)
DEFAULT_PROMPT_TEMPLATES: Tuple[str, ...] = (
    "a street sign in a city",
    "a neon sign on a night street",
    "a shop banner above a storefront",
    "a billboard by the road",
)


class GlyphTextDataset:
    """Deterministic step-indexed (image, glyph-condition) training batches.

    Args:
        pipeline: a ``FluxRepTextPipeline`` — supplies the conditioning
            token builder, VAE encoder, and text encoders (the same modules
            inference uses, so train/serve skew is zero by construction).
        batch_size: samples per batch.
        words / prompt_templates: text pools to draw from.
        tokenize: ``prompt -> (clip_ids [1, L], t5_ids [1, L])``; defaults to
            the CLI tokenizer (vendored BPE/SPM with hash-id fallback).
        seed: dataset-level seed, folded with the step index.
    """

    def __init__(
        self,
        pipeline,
        batch_size: int = 2,
        words: Sequence[str] = DEFAULT_WORDS,
        prompt_templates: Sequence[str] = DEFAULT_PROMPT_TEMPLATES,
        tokenize: Optional[Callable] = None,
        font_path: Optional[str] = None,
        seed: int = 0,
    ):
        self.pipe = pipeline
        self.batch_size = batch_size
        self.words = list(words)
        self.prompt_templates = list(prompt_templates)
        self.font_path = font_path
        self.seed = seed
        if tokenize is None:
            from reptext.cli import _tokenize

            tokenize = lambda p: _tokenize(  # noqa: E731
                p, pipeline.clip.config, pipeline.t5.config, None
            )
        self.tokenize = tokenize

    # ----------------------------------------------------------- host-side

    def sample_spec(self, step: int, index: int) -> Dict:
        """Deterministic (text, position, font_size, colors, prompt) draw."""
        rnd = random.Random((self.seed << 24) ^ (step << 4) ^ index)
        cfg = self.pipe.pipe_cfg
        w, h = cfg.width, cfg.height
        text = rnd.choice(self.words)
        font_size = rnd.randint(max(12, h // 10), max(16, h // 5))
        # keep the line inside the canvas (rough width bound: 0.7*fs per char)
        max_x = max(1, int(w - 0.7 * font_size * max(len(text), 2)))
        max_y = max(1, h - int(1.4 * font_size))
        position = (rnd.randint(0, max_x), rnd.randint(0, max_y))
        color = tuple(rnd.randint(140, 255) for _ in range(3))
        bg = tuple(rnd.randint(0, 110) for _ in range(3))
        prompt = f"{rnd.choice(self.prompt_templates)}, '{text}'"
        return {"text": text, "position": position, "font_size": font_size,
                "color": color, "bg": bg, "prompt": prompt}

    def _target_image(self, conds, spec: Dict) -> np.ndarray:
        """Training target: glyph composite over a flat background.

        Subclasses replace this with corpus photos for real training
        (data_disk.DiskImageTextDataset) — the signature
        (Conditions, spec) -> [H, W, 3] uint8 is the only contract.
        """
        canvas = conds.glyph_canvas
        img = np.empty_like(canvas)
        img[:] = np.asarray(spec["bg"], np.uint8)
        ink = (canvas > 0).any(axis=-1)
        img[ink] = canvas[ink]
        return img

    # -------------------------------------------------------------- batches

    def batch(self, step: int) -> Dict[str, jax.Array]:
        """Build the training batch for ``step`` (replay-deterministic)."""
        from reptext.eval.ocr import CHAR_TO_ID, MAX_LABEL
        from reptext.sampling.ocr_loss import aspect_box, glyph_ink_bbox

        cfg = self.pipe.pipe_cfg
        rng = jax.random.fold_in(jax.random.PRNGKey(self.seed), step)
        cond_l, mask_l, target_l = [], [], []
        clip_l, t5_l = [], []
        ocr_boxes = np.zeros((self.batch_size, 4), np.float32)
        ocr_labels = np.zeros((self.batch_size, MAX_LABEL), np.int32)
        ocr_paddings = np.ones((self.batch_size, MAX_LABEL), np.float32)
        for i in range(self.batch_size):
            spec = self.sample_spec(step, i)
            conds = build_conditions(
                [TextLine(spec["text"], spec["position"], spec["color"],
                          font_size=spec["font_size"])],
                cfg.width, cfg.height, font_path=self.font_path,
                font_size=spec["font_size"],
            )
            r_cond, r_img = jax.random.split(jax.random.fold_in(rng, i))
            ct, tm = self.pipe.prepare_control_tokens(conds, r_cond)
            cond_l.append(ct[0])            # single line per sample
            mask_l.append(tm[0])
            img = preprocess_images(self._target_image(conds, spec))
            lat = self.pipe._encode_scaled(jnp.asarray(img), r_img)
            target_l.append(pack_latents(lat.transpose(0, 3, 1, 2))[0])
            cids, tids = self.tokenize(spec["prompt"])
            clip_l.append(np.asarray(cids)[0])
            t5_l.append(np.asarray(tids)[0])
            # OCR perceptual-term fields (sampling/ocr_loss.py): the judge
            # crop window from the KNOWN glyph bbox + case-folded labels
            bbox = glyph_ink_bbox(conds.glyph_canvas)
            ocr_boxes[i] = (aspect_box(bbox, cfg.height, cfg.width)
                            if bbox else np.asarray([0, 0, 1, 1], np.float32))
            ids = [CHAR_TO_ID[c] for c in spec["text"]
                   if c in CHAR_TO_ID][:MAX_LABEL]  # case-sensitive (judge v2)
            ocr_labels[i, : len(ids)] = ids
            ocr_paddings[i, : len(ids)] = 0.0

        # pad token ids to the longest in the batch (pad id 0)
        def pad_stack(rows: List[np.ndarray]) -> jnp.ndarray:
            n = max(r.shape[0] for r in rows)
            out = np.zeros((len(rows), n), np.int32)
            for j, r in enumerate(rows):
                out[j, : r.shape[0]] = r
            return jnp.asarray(out)

        prompt_embeds, pooled = self.pipe.encode_prompt(
            pad_stack(clip_l), pad_stack(t5_l)
        )
        guidance = (
            jnp.full((self.batch_size,), cfg.guidance_scale, jnp.float32)
            if self.pipe.flux.config.guidance_embeds else None
        )
        return {
            "x0": jnp.stack(target_l),
            "cond_tokens": jnp.stack(cond_l),
            "token_mask": jnp.stack(mask_l),
            "prompt_embeds": prompt_embeds,
            "pooled": pooled,
            "img_ids": prepare_latent_image_ids(cfg.latent_height, cfg.latent_width),
            "txt_ids": jnp.zeros((prompt_embeds.shape[1], 3)),
            "guidance": guidance,
            "ocr_boxes": jnp.asarray(ocr_boxes),
            "ocr_labels": jnp.asarray(ocr_labels),
            "ocr_paddings": jnp.asarray(ocr_paddings),
        }

    __call__ = batch


class PrefetchLoader:
    """Step-indexed prefetch: build batch ``s+1..s+depth`` on a host thread
    while the device runs step ``s``.

    Wraps any step-indexed ``batch_fn`` (GlyphTextDataset or a corpus loader)
    without changing the ElasticTrainer contract: ``loader(step)`` still
    returns the batch for exactly ``step``. Rollback-and-replay works because
    out-of-order requests (a rollback jumps backward) fall through to a
    direct synchronous build; prefetch resumes from the new position.
    """

    def __init__(self, batch_fn: Callable[[int], Dict], depth: int = 2):
        self.batch_fn = batch_fn
        self.depth = max(1, depth)
        self._q: "queue.Queue" = queue.Queue(self.depth)
        self._thread: Optional[threading.Thread] = None
        self._next_to_build = 0
        self._stop = threading.Event()

    def _worker(self, start: int, q: "queue.Queue", stop: threading.Event):
        # q/stop are THIS generation's objects (a restart swaps self._q /
        # self._stop; a stale worker must never feed the new queue)
        step = start
        while not stop.is_set():
            try:
                item = (step, self.batch_fn(step))
            except Exception as e:  # surface build errors at consumption
                item = (step, e)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def _restart(self, start: int):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._q = queue.Queue(self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(start, self._q, self._stop), daemon=True
        )
        self._next_to_build = start
        self._thread.start()

    def __call__(self, step: int) -> Dict:
        if self._thread is None or step < self._next_to_build:
            self._restart(step)  # cold start or rollback replay
        while True:
            got_step, item = self._q.get()
            self._next_to_build = got_step + 1
            if got_step == step:
                if isinstance(item, Exception):
                    raise item
                return item
            if got_step > step:  # shouldn't happen; rebuild directly
                return self.batch_fn(step)
            # got_step < step: stale prefetch (skipped ahead); drop and retry

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
