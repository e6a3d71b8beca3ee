"""On-disk image/text corpus loader for ControlNet training.

The reference ships no training or data code (SURVEY.md §0); the RepText
paper trains on (photo, rendered-text condition) pairs. ``GlyphTextDataset``
(data.py) bootstraps that with synthetic composites; this module is the real
corpus path with the same batch contract, so the training recipe
(sampling/train_controlnet.py), ElasticTrainer replay, and the OCR
perceptual loss all work unchanged on photos.

Corpus layout (one directory):

    corpus/
      annotations.jsonl      one JSON record per line:
        {"image": "imgs/0001.jpg",            # path relative to corpus dir
         "prompt": "a neon sign on a night street",
         "lines": [{"text": "قهوة", "position": [320, 400],
                    "font_size": 96, "color": [255, 40, 40]}, ...]}
      imgs/...               referenced images (PNG/JPEG, any size —
                             resized to the training resolution)

Semantics:

- **Step-indexed determinism** (ElasticTrainer rollback/replay): sample k of
  the global stream maps to record ``perm_epoch[k mod n]`` where
  ``perm_epoch`` is a per-epoch permutation derived from (seed, epoch) —
  every batch is reproducible from (seed, step) alone, like the synthetic
  dataset.
- **One line per visit**: the ControlNet consumes conditions per text line
  (the inference sampler tiles lines through the CN —
  sampling/sampler.py); multi-line records contribute one line per epoch
  visit, chosen deterministically from (seed, epoch, record), so all lines
  of a record are seen across epochs.
- **Data-parallel sharding**: ``shard=(index, count)`` interleaves records
  across hosts BEFORE the epoch permutation, so dp workers stream disjoint
  data with zero coordination (the replacement for a distributed
  sampler).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from reptext.data import GlyphTextDataset

_DEFAULT_COLOR = (255, 255, 255)


def load_annotations(corpus_dir: str) -> list:
    """Read and validate annotations.jsonl; returns the record list."""
    path = os.path.join(corpus_dir, "annotations.jsonl")
    records = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "image" not in rec or "lines" not in rec or not rec["lines"]:
                raise ValueError(f"{path}:{ln}: record needs 'image' and "
                                 f"non-empty 'lines'")
            for entry in rec["lines"]:
                if "text" not in entry or "position" not in entry:
                    raise ValueError(f"{path}:{ln}: line needs 'text' and "
                                     f"'position'")
            records.append(rec)
    if not records:
        raise ValueError(f"{path}: empty corpus")
    return records


class DiskImageTextDataset(GlyphTextDataset):
    """Step-indexed training batches from an annotated photo corpus.

    Same contract as GlyphTextDataset.batch (drop-in for PrefetchLoader /
    ElasticTrainer / the OCR perceptual term); the training target is the
    corpus photo instead of a synthetic composite.
    """

    def __init__(
        self,
        pipeline,
        corpus_dir: str,
        batch_size: int = 2,
        tokenize=None,
        font_path: Optional[str] = None,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
    ):
        super().__init__(
            pipeline, batch_size=batch_size, tokenize=tokenize,
            font_path=font_path, seed=seed,
        )
        self.corpus_dir = os.path.abspath(corpus_dir)
        index, count = shard
        if not (0 <= index < count):
            raise ValueError(f"bad shard {shard}")
        records = load_annotations(self.corpus_dir)
        self.records = records[index::count]
        if not self.records:
            raise ValueError(
                f"shard {index}/{count} of {len(records)} records is empty"
            )
        self._image_cache: Dict[str, np.ndarray] = {}
        self._cache_limit = 64

    # ------------------------------------------------------------ indexing

    def _epoch_perm(self, epoch: int) -> Sequence[int]:
        # memoize the current epoch's permutation (training walks epochs
        # monotonically; batches straddling an epoch boundary keep both)
        cached = getattr(self, "_perm_cache", {})
        if epoch not in cached:
            order = list(range(len(self.records)))
            random.Random((self.seed << 20) ^ epoch).shuffle(order)
            cached = {k: v for k, v in cached.items() if k >= epoch - 1}
            cached[epoch] = order
            self._perm_cache = cached
        return cached[epoch]

    def _image_size(self, path: str) -> Tuple[int, int]:
        """(width, height) of the source image — header read only, memoized."""
        cached = getattr(self, "_size_cache", None)
        if cached is None:
            cached = self._size_cache = {}
        if path not in cached:
            from PIL import Image

            with Image.open(path) as im:
                cached[path] = im.size
        return cached[path]

    def sample_spec(self, step: int, index: int) -> Dict:
        k = step * self.batch_size + index
        n = len(self.records)
        epoch, offset = divmod(k, n)
        rec = self.records[self._epoch_perm(epoch)[offset]]
        lines = rec["lines"]
        pick = random.Random(
            (self.seed << 28) ^ (epoch << 8) ^ (offset & 0xFF)
        ).randrange(len(lines))
        entry = lines[pick]
        cfg = self.pipe.pipe_cfg
        path = os.path.join(self.corpus_dir, rec["image"])
        # annotations are in ORIGINAL-image pixel coordinates; images are
        # resized to the training resolution, so positions/font sizes must
        # rescale identically or conditions, targets, and OCR boxes point at
        # the wrong region of the photo
        src_w, src_h = self._image_size(path)
        sx, sy = cfg.width / src_w, cfg.height / src_h
        x, y = entry["position"]
        default_fs = max(16, int(src_h / 8))
        return {
            "text": entry["text"],
            "position": (int(round(x * sx)), int(round(y * sy))),
            "font_size": max(
                8, int(round(float(entry.get("font_size", default_fs))
                             * (sx + sy) / 2.0))),
            "color": tuple(entry.get("color", _DEFAULT_COLOR)),
            "prompt": rec.get("prompt", ""),
            "image_path": path,
        }

    # ------------------------------------------------------------- images

    def _load_image(self, path: str) -> np.ndarray:
        cached = self._image_cache.get(path)
        if cached is not None:
            return cached
        from PIL import Image

        cfg = self.pipe.pipe_cfg
        with Image.open(path) as im:
            img = np.asarray(
                im.convert("RGB").resize((cfg.width, cfg.height),
                                         Image.BILINEAR),
                np.uint8,
            )
        if len(self._image_cache) >= self._cache_limit:
            self._image_cache.pop(next(iter(self._image_cache)))
        self._image_cache[path] = img
        return img

    def _target_image(self, conds, spec: Dict) -> np.ndarray:
        return self._load_image(spec["image_path"])
