"""OCR judge: a small CTC conv recognizer for glyph-accuracy scoring.

The north star demands "OCR-verified glyph accuracy"; no OCR
engine ships in this environment, and the edge-IoU proxy in
benchmarks/glyph_fidelity.py is nearly non-discriminative on noisy output
(random-weight samples score ~0.59 vs 1.0 perfect — VERDICT r2). This module
closes that gap with a from-scratch recognizer:

- trained purely on SYNTHETIC labeled renders produced by the production
  conditioning frontend (conditioning/glyph.py: Arabic contextual shaping +
  bidi + PIL render — the same path that builds the pipeline's glyph
  conditions, so the judge reads exactly the script forms the pipeline is
  asked to draw);
- charset (v2): Arabic letters + Latin capitals + Latin LOWERCASE (distinct
  classes; labels are case-sensitive) + digits — the data.py word pools and
  the reference demo's mixed-case English strings are covered. The
  reference's CJK demo strings (RepText/infer.py:44,56 via contains_chinese
  :11-14) are NOT coverable in this environment: the only installed fonts
  are DejaVu (no CJK glyphs — every han character renders as the same
  .notdef tofu box, verified), so neither the conditioning frontend nor a
  judge trained on its renders can represent han glyph shapes. The charset
  is embedded in the frozen weights file; with a CJK-capable TTF present,
  extend CHARSET and retrain (benchmarks/train_ocr_judge.py) — no code
  changes needed;
- architecture: 4-conv column encoder -> per-column logits -> CTC
  (optax.ctc_loss), greedy decode;
- heavy train-time augmentation (polarity, background level, noise, blur,
  jitter) so the judge is invariant to the rendering style of sampled
  images and scores INK SHAPE, not contrast statistics;
- frozen weights are committed at benchmarks/ocr_judge.npz (see
  benchmarks/train_ocr_judge.py); `char_accuracy` is the headline metric,
  with demonstrated floor ~0 on noise and ~1 on perfect renders.

The reference has no accuracy metric of any kind (SURVEY.md §6) — this is
the framework's own proof obligation, not a ported component.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp
import numpy as np

# Class 0 is the CTC blank; class i+1 maps to CHARSET[i].
ARABIC = "ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهوىي"
LATIN = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
LATIN_LOWER = "abcdefghijklmnopqrstuvwxyz"
DIGITS = "0123456789"
CHARSET = ARABIC + LATIN + LATIN_LOWER + DIGITS
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARSET)}

IMG_H, IMG_W = 48, 256   # judge input geometry (v2: wider for long lines,
                         # taller so Arabic dot clusters survive the resize —
                         # at 32px height the i'jam dots blur together under
                         # augmentation (measured: arabic augmented 0.92)
FRAMES = 64              # output time steps (IMG_W / 4)
MAX_LABEL = 24


class OCRJudge(nn.Module):
    """Column-wise conv encoder -> per-frame class logits (CTC head).

    v2: wider features + a 1D frame-context conv (±2 columns) between the
    column pool and the head — pure column features confuse visually similar
    glyphs under blur/noise augmentation (measured: per-script augmented
    accuracy 0.80-0.92 without context, gate is >=0.95)."""

    num_classes: int = len(CHARSET) + 1

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        # x: [B, 48, 256, 1] -> logits [B, 64, K]
        # v3 capacity bump (VERDICT r4 #3: latin_upper 0.82 under the harsh
        # augmentation tail): wider features + a second context conv —
        # confusable caps (O/Q/D/G, I/J/L) need more shape detail than the
        # v2 192-wide column code carried
        for feat, stride in ((64, (2, 2)), (128, (2, 2)), (160, (2, 1)), (224, (2, 1))):
            x = nn.Conv(feat, (3, 3), strides=stride)(x)
            x = nn.relu(x)
        x = x.mean(axis=1)                      # [B, W/4, 224]
        x = nn.relu(nn.Conv(224, (5,), padding="SAME")(x))
        x = nn.relu(nn.Conv(224, (3,), padding="SAME")(x))
        x = nn.relu(nn.Dense(192)(x))
        return nn.Dense(self.num_classes)(x)


# ----------------------------------------------------------------- rendering


def _font(size: int, font_path: Optional[str] = None):
    from PIL import ImageFont

    from reptext.conditioning.glyph import default_font_path

    return ImageFont.truetype(font_path or default_font_path(), size)


def render_word(
    text: str,
    font_size: int = 40,
    font_path: Optional[str] = None,
    pad: int = 4,
) -> np.ndarray:
    """Render ``text`` (shaped + bidi'd) white-on-black, tightly cropped.

    Returns a float32 [h, w] image in [0, 1].
    """
    from PIL import Image, ImageDraw

    from reptext.conditioning.arabic import prepare_display_text

    display = prepare_display_text(text)
    font = _font(font_size, font_path)
    canvas_w, canvas_h = 20 * font_size, 3 * font_size
    img = Image.new("L", (canvas_w, canvas_h), 0)
    draw = ImageDraw.Draw(img)
    pos = (font_size // 2, font_size // 2)
    draw.text(pos, display, font=font, fill=255)
    x0, y0, x1, y1 = (int(v) for v in draw.textbbox(pos, display, font=font))
    x0, y0 = max(x0 - pad, 0), max(y0 - pad, 0)
    x1, y1 = min(x1 + pad, canvas_w), min(y1 + pad, canvas_h)
    arr = np.asarray(img, np.float32)[y0:y1, x0:x1] / 255.0
    if arr.size == 0:
        arr = np.zeros((IMG_H, IMG_W), np.float32)
    return arr


def _resize_box(g: np.ndarray) -> np.ndarray:
    """Aspect-preserving resize of a [h, w] grayscale image into the
    IMG_H x IMG_W box (left-aligned, bg-padded), values scaled to [0, 1]."""
    from PIL import Image

    h, w = g.shape
    if h == 0 or w == 0:
        return np.zeros((IMG_H, IMG_W), np.float32)
    scale = min(IMG_H / h, IMG_W / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    peak = float(g.max())
    img = Image.fromarray(
        np.clip(g * (255.0 if peak <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    ).resize((nw, nh), Image.BILINEAR)
    small = np.asarray(img, np.float32) / 255.0
    # pad with the border-estimated background, not 0: for inverted or
    # low-contrast crops a black pad band is an out-of-distribution block
    # that the CTC head reads as spurious ink (measured: inverted renders
    # 0.52 -> ~1.0 char accuracy with bg-pad + dual-polarity decode)
    border = np.concatenate([small[0, :], small[-1, :], small[:, 0], small[:, -1]])
    out = np.full((IMG_H, IMG_W), float(np.median(border)), np.float32)
    out[:nh, :nw] = small
    return out


def _standardize(g: np.ndarray) -> np.ndarray:
    return (g - g.mean()) / (g.std() + 1e-5)


def _canonicalize(g: np.ndarray, pad_frac: float = 0.18) -> np.ndarray:
    """Normalize crop TIGHTNESS: crop to the ink bounding box, then add a
    fixed background-filled margin (``pad_frac`` of the ink height).

    Callers crop text regions at wildly different tightness — render_word
    pads 4px, the pipelines crop at the exact ``draw.textbbox`` box whose
    glyphs touch the edges. The judge is scale-sensitive, so eval and train
    inputs both pass through this canonical form (measured before the fix:
    tight ground-truth bbox crops decoded at 0.51 char accuracy vs 1.0 for
    padded renders of the same words).

    Ink detection: deviation from the border-median background > 25% of the
    crop's peak deviation. Degenerates safely on noise (bbox ~ full crop)
    and flat crops (no ink -> returned unchanged).
    """
    h, w = g.shape
    if h < 4 or w < 4:
        return g
    border = np.concatenate([g[0, :], g[-1, :], g[:, 0], g[:, -1]])
    bg = float(np.median(border))
    dev = np.abs(g - bg)
    peak = float(dev.max())
    if peak <= 1e-6:
        return g
    ink = dev > 0.25 * peak
    rows = np.flatnonzero(ink.any(axis=1))
    cols = np.flatnonzero(ink.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return g
    y0, y1 = rows[0], rows[-1] + 1
    x0, x1 = cols[0], cols[-1] + 1
    tight = g[y0:y1, x0:x1]
    ph = max(2, int(round(pad_frac * (y1 - y0))))
    pw = ph
    out = np.full((y1 - y0 + 2 * ph, x1 - x0 + 2 * pw), bg, np.float32)
    out[ph:ph + y1 - y0, pw:pw + x1 - x0] = tight
    return out


def prepare_crop(region: np.ndarray) -> np.ndarray:
    """Normalize an arbitrary image crop to judge input [IMG_H, IMG_W, 1].

    Grayscale -> tightness canonicalization (:func:`_canonicalize`) ->
    aspect-preserving resize into the 32x128 box (left-aligned) ->
    per-image standardization (mean 0, std 1). Polarity (bright-on-dark vs
    dark-on-bright) is NOT normalized here — the judge is trained
    polarity-invariant. Training batches apply the same canonicalization
    (RenderCache), so train and eval tightness distributions match by
    construction.
    """
    g = region.astype(np.float32)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    return _standardize(_resize_box(_canonicalize(g)))[:, :, None]


def _augment(img: np.ndarray, rng: np.random.Generator,
             harsh: bool = False) -> np.ndarray:
    """Train-time augmentation: background level, contrast, polarity, noise,
    blur — matches the variability of VAE-decoded sampled text regions.

    ``harsh``: draw from the tail of the distribution (low contrast + strong
    blur + strong noise together, SNR ~2) — where nearly all judge errors
    live; the training curriculum oversamples it (train_judge harsh_frac)."""
    from scipy import ndimage

    if harsh:
        ink = rng.uniform(0.5, 0.72)
        bg = rng.uniform(0.22, 0.35)
    else:
        ink = rng.uniform(0.5, 1.0)
        bg = rng.uniform(0.0, 0.35)
    out = bg + img * (ink - bg)
    if rng.random() < 0.5:
        out = 1.0 - out                              # polarity flip
    if harsh or rng.random() < 0.6:
        lo, hi = (0.5, 0.8) if harsh else (0.2, 0.8)
        out = ndimage.gaussian_filter(out, rng.uniform(lo, hi))
    lo_n = 0.04 if harsh else 0.01
    out = out + rng.normal(0.0, rng.uniform(lo_n, 0.07), out.shape)
    return out.astype(np.float32)


def random_word(rng: np.random.Generator) -> str:
    """Uniformly drawn script + length; covers the full charset (v2: labels
    are case-SENSITIVE — lowercase letters are their own classes), with
    occasional two-word phrases so the judge learns to read across word
    gaps on realistic sign lines."""
    script = rng.choice(["ar", "lat", "low", "dig", "mix"],
                        p=[0.33, 0.17, 0.17, 0.2, 0.13])
    n = int(rng.integers(2, 10))
    if script == "ar":
        pool = ARABIC
    elif script == "lat":
        pool = LATIN
    elif script == "low":
        pool = LATIN_LOWER
    elif script == "dig":
        pool = DIGITS
    else:
        pool = LATIN + LATIN_LOWER + DIGITS
    word = "".join(rng.choice(list(pool)) for _ in range(n))
    if script in ("lat", "low") and rng.random() < 0.3:
        word = word[:1].upper() + word[1:].lower()       # Titlecase shapes
    if rng.random() < 0.2:                               # two-word phrase
        second = "".join(
            rng.choice(list(pool)) for _ in range(int(rng.integers(2, 7))))
        word = f"{word} {second}"
    return word


# visually confusable groups under blur/noise (VERDICT r4 #3): training
# oversamples words drawn from these so the judge sees the hard pairs far
# more often than uniform sampling provides
CONFUSION_GROUPS = ["O0QDG", "Il1J", "B8", "S5s", "Z2z", "6Gb", "coCO",
                    "uvUV", "xXkK", "pPqg"]


def confusion_word(rng: np.random.Generator) -> str:
    """A word built from one or two confusion groups (hard-pair practice)."""
    groups = [CONFUSION_GROUPS[int(rng.integers(len(CONFUSION_GROUPS)))]]
    if rng.random() < 0.4:
        groups.append(CONFUSION_GROUPS[int(rng.integers(len(CONFUSION_GROUPS)))])
    pool = "".join(groups)
    n = int(rng.integers(3, 9))
    return "".join(rng.choice(list(pool)) for _ in range(n))


class RenderCache:
    """Pre-rendered (resized, un-augmented) word pool for fast train batches.

    TrueType rendering + shaping dominates per-step cost (~20ms/word); caching
    N rendered words once and re-augmenting small 32x128 crops per step makes
    training render-bound only at startup.
    """

    def __init__(self, n_words: int, rng: np.random.Generator,
                 font_path: Optional[str] = None,
                 words: Optional[Sequence[str]] = None,
                 confusion_frac: float = 0.15):
        self.images: List[np.ndarray] = []
        self.texts: List[str] = []
        for i in range(n_words):
            if words is not None:
                text = words[i % len(words)]
            elif rng.random() < confusion_frac:
                text = confusion_word(rng)
            else:
                text = random_word(rng)
            size = int(rng.integers(24, 56))
            # same tightness canonicalization as eval-time prepare_crop, so
            # the judge never sees a tightness distribution it isn't scored on
            self.images.append(_resize_box(_canonicalize(
                render_word(text, font_size=size, font_path=font_path)
            )))
            self.texts.append(text)


def make_batch(
    rng: np.random.Generator,
    batch_size: int,
    font_path: Optional[str] = None,
    words: Optional[Sequence[str]] = None,
    cache: Optional[RenderCache] = None,
    harsh_frac: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Synthetic labeled batch: (images [B,32,128,1], labels [B,L],
    label_paddings [B,L], texts). With a RenderCache, words are drawn from
    the pre-rendered pool and only augmentation runs per step. ``harsh_frac``
    of samples draw the harsh augmentation tail (see _augment)."""
    images = np.zeros((batch_size, IMG_H, IMG_W, 1), np.float32)
    labels = np.zeros((batch_size, MAX_LABEL), np.int32)
    paddings = np.ones((batch_size, MAX_LABEL), np.float32)
    texts = []
    for b in range(batch_size):
        if cache is not None:
            j = int(rng.integers(len(cache.texts)))
            text, img = cache.texts[j], cache.images[j]
        else:
            text = (words[int(rng.integers(len(words)))] if words
                    else random_word(rng))
            size = int(rng.integers(24, 56))
            img = _resize_box(_canonicalize(
                render_word(text, font_size=size, font_path=font_path)))
        images[b] = _standardize(_augment(
            img, rng, harsh=rng.random() < harsh_frac))[:, :, None]
        # case-SENSITIVE labels (v2); spaces and out-of-charset chars are
        # dropped from the label (a phrase reads as its letters run together)
        ids = [CHAR_TO_ID[c] for c in text if c in CHAR_TO_ID][:MAX_LABEL]
        labels[b, : len(ids)] = ids
        paddings[b, : len(ids)] = 0.0
        texts.append(text)
    return images, labels, paddings, texts


# ------------------------------------------------------------------ training


def train_judge(
    steps: int = 3000,
    batch_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    font_path: Optional[str] = None,
    log_every: int = 200,
    words: Optional[Sequence[str]] = None,
    confusion_frac: float = 0.15,
    harsh_frac: float = 0.3,
) -> Dict:
    """Train the judge on synthetic renders; returns the param tree.

    ``harsh_frac`` of samples draw the harsh augmentation tail (low contrast
    + strong blur + strong noise together) — the regime holding nearly all
    residual eval errors; uniform parameter sampling visits it rarely."""
    import optax

    rng = np.random.default_rng(seed)
    cache = RenderCache(6144 if words is not None else 12288, rng, font_path,
                        words=words, confusion_frac=confusion_frac)
    model = OCRJudge()
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG_H, IMG_W, 1))
    )
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))
    opt_state = tx.init(params)
    ema = params  # exponential moving average of params: the frozen weights
    ema_decay = 0.999

    @jax.jit
    def step_fn(params, ema, opt_state, images, labels, paddings):
        def loss_fn(p):
            logits = model.apply(p, images)
            logit_pad = jnp.zeros(logits.shape[:2], jnp.float32)
            losses = optax.ctc_loss(logits, logit_pad, labels, paddings)
            return losses.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(
            lambda e, q: ema_decay * e + (1.0 - ema_decay) * q, ema, params)
        return params, ema, opt_state, loss

    for i in range(steps):
        images, labels, paddings, _ = make_batch(
            rng, batch_size, font_path, cache=cache, harsh_frac=harsh_frac
        )
        params, ema, opt_state, loss = step_fn(
            params, ema, opt_state, jnp.asarray(images), jnp.asarray(labels),
            jnp.asarray(paddings),
        )
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"ocr-judge step {i}: ctc_loss={float(loss):.4f}", flush=True)
    return ema


# ----------------------------------------------------------------- inference


def decode_logits(logits: np.ndarray) -> List[str]:
    """Greedy CTC decode: argmax per frame, collapse repeats, drop blanks."""
    ids = np.asarray(logits).argmax(axis=-1)  # [B, T]
    out = []
    for row in ids:
        chars, prev = [], 0
        for k in row:
            if k != prev and k != 0:
                chars.append(CHARSET[k - 1])
            prev = k
        out.append("".join(chars))
    return out


def _edit_distance(a: str, b: str) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def char_accuracy(
    regions: Sequence[np.ndarray],
    texts: Sequence[str],
    params,
    apply_fn=None,
) -> float:
    """Mean per-sample character accuracy: 1 - editdist/len(label), floored
    at 0. ``regions`` are raw image crops (any size, [h,w] or [h,w,3]).

    Both polarities of every crop are decoded and the better one scored —
    ink-vs-background polarity is a rendering choice, not a glyph error, and
    standardized crops make inversion an exact negation. Per polarity the
    logits are averaged over {identity, +-1px vertical shift} (edge-padded)
    — standard test-time ensembling that stabilizes the CTC head against
    sub-pixel placement of the resized crop."""
    model = OCRJudge()
    apply_fn = apply_fn or model.apply
    # ``params`` may be one tree or an ENSEMBLE (list of trees,
    # load_judge_ensemble): per member, TTA-averaged logits -> softmax;
    # member probabilities averaged (committee vote) before decoding —
    # independently-seeded members disagree on borderline glyphs and the
    # average fixes single-member confusions.
    members = list(params) if isinstance(params, (list, tuple)) else [params]
    crops = np.stack([prepare_crop(r) for r in regions])

    def vshift(x, k):
        idx = np.clip(np.arange(x.shape[1]) + k, 0, x.shape[1] - 1)
        return x[:, idx]

    # NOTE: horizontal-shift TTA measured NEGATIVE (latin_upper 0.862 ->
    # 0.852): shifting columns moves every CTC frame boundary, so averaging
    # misaligned logit sequences smears adjacent character probabilities.
    # Vertical shifts keep frames aligned and help; don't revisit.
    variants = [crops, vshift(crops, 1), vshift(crops, -1)]
    both = np.concatenate([v * sgn for sgn in (1.0, -1.0) for v in variants])
    k = len(variants)
    n_ = len(regions)
    both_j = jnp.asarray(both)
    probs = None
    for m in members:
        logits = np.asarray(apply_fn(m, both_j))
        pos = logits[: k * n_].reshape(k, n_, *logits.shape[1:]).mean(axis=0)
        neg = logits[k * n_:].reshape(k, n_, *logits.shape[1:]).mean(axis=0)
        lg = np.concatenate([pos, neg], axis=0)
        lg = lg - lg.max(axis=-1, keepdims=True)
        p_ = np.exp(lg)
        p_ /= p_.sum(axis=-1, keepdims=True)
        probs = p_ if probs is None else probs + p_
    decoded = decode_logits(probs)
    n = len(regions)
    accs = []
    for i, want in enumerate(texts):
        want_ids = "".join(c for c in want if c in CHAR_TO_ID)
        best = 0.0
        for got in (decoded[i], decoded[n + i]):
            d = _edit_distance(got, want_ids)
            best = max(best, 1.0 - d / max(len(want_ids), 1))
        accs.append(max(0.0, best))
    return float(np.mean(accs)) if accs else 0.0


# --------------------------------------------------------------- persistence

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.pardir, "benchmarks", "ocr_judge.npz",
)


def save_judge(params, path: str) -> None:
    """Freeze params + the charset they were trained for (class i+1 =
    charset[i]); load_judge refuses weights whose charset doesn't match the
    running CHARSET instead of silently mis-decoding."""
    flat = _flatten(params)
    flat["__charset__"] = np.array([ord(c) for c in CHARSET], np.int32)
    np.savez_compressed(path, **flat)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(val)
    return out


def load_judge(path: Optional[str] = None) -> Dict:
    """Load frozen judge weights (benchmarks/ocr_judge.npz by default)."""
    path = path or os.path.abspath(DEFAULT_WEIGHTS)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    stored = flat.pop("__charset__", None)
    if stored is not None:
        stored_charset = "".join(chr(int(c)) for c in stored)
        if stored_charset != CHARSET:
            raise ValueError(
                f"judge weights at {path} were trained for a different "
                f"charset ({len(stored_charset)} classes vs "
                f"{len(CHARSET)} current); retrain with "
                "benchmarks/train_ocr_judge.py"
            )
    return _unflatten(flat)


def load_judge_ensemble(paths: Optional[Sequence[str]] = None) -> list:
    """Committee of judges for SCORING (char_accuracy averages member
    probabilities). Defaults to benchmarks/ocr_judge.npz plus every sibling
    ocr_judge_m*.npz (independently-seeded members,
    benchmarks/train_ocr_judge.py --seed N --member M). Falls back to the
    single default judge when no members exist. In-graph uses (the CTC
    perceptual loss) keep load_judge(): one member, differentiable apply.

    MEASURED NEGATIVE for independently-trained members (round 5): CTC frame
    alignment is not canonical across models, so frame-wise probability
    averaging smears adjacent characters (latin_upper 0.862 single ->
    0.849 two-member). No ocr_judge_m*.npz is shipped; the machinery stays
    for alignment-sharing members (e.g. EMA snapshots of one run)."""
    import glob as _glob

    if paths is None:
        base = os.path.abspath(DEFAULT_WEIGHTS)
        paths = [base] + sorted(
            _glob.glob(os.path.join(os.path.dirname(base), "ocr_judge_m*.npz")))
    return [load_judge(p) for p in paths]
