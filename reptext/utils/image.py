"""Image array conversion and resizing (the VaeImageProcessor equivalent).

Reference counterpart: diffusers ``VaeImageProcessor`` built at
RepText/pipeline_flux_controlnet.py:222 (preprocess: resize + scale to [-1,1];
postprocess: clamp, [0,1], uint8).
"""

from __future__ import annotations

import numpy as np


def preprocess_images(images: np.ndarray) -> np.ndarray:
    """uint8 [B?, H, W, 3] (or [H, W, 3]) -> float32 NHWC in [-1, 1]."""
    arr = np.asarray(images)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32) * 2.0 - 1.0
    return arr


def postprocess_images(images) -> np.ndarray:
    """float NHWC in [-1, 1] -> uint8 [B, H, W, 3].

    Raises ``FloatingPointError`` on NaN or inf, which would otherwise cast
    to arbitrary pixel values.
    """
    arr = np.asarray(images, dtype=np.float32)
    if not np.isfinite(arr).all():
        raise FloatingPointError(
            f"decoded images hold {int((~np.isfinite(arr)).sum())} non-finite "
            f"values of {arr.size}")
    arr = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
    return (arr * 255.0).round().astype(np.uint8)


def load_image(source, mode: str = "RGB") -> np.ndarray:
    """PNG path or bytes -> uint8 [H, W, 3] (``mode="RGB"``) or [H, W] ("L").

    Alpha is dropped, not composited; gray -> RGB repeats the channel and
    RGB -> L uses the ITU-R 601 luma weights (PIL's ``convert`` rules).
    """
    from reptext.utils.png import decode_png

    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    arr = decode_png(data)
    if arr.ndim == 3:
        arr = arr[:, :, :3]
    if mode == "RGB":
        return np.repeat(arr[:, :, None], 3, axis=2) if arr.ndim == 2 else arr
    if mode == "L":
        if arr.ndim == 2:
            return arr
        r, g, b = (arr[:, :, i].astype(np.uint32) for i in range(3))
        return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")


def resize_image(image: np.ndarray, height: int, width: int,
                 method: str = "cubic") -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 [height, width(, C)].

    ``method`` is a ``jax.image.resize`` method (``linear``, ``cubic``,
    ``lanczos3``, ``nearest``); downsampling is antialiased.
    """
    import jax

    arr = np.asarray(image)
    if arr.shape[:2] == (height, width):
        return arr
    shape = (height, width) + arr.shape[2:]
    out = jax.image.resize(arr.astype(np.float32), shape, method=method)
    return np.clip(np.round(np.asarray(out)), 0, 255).astype(np.uint8)


def resize_to_multiple(
    image: np.ndarray,
    multiple: int = 64,
    max_side: int = 1536,
    min_side: int = 768,
    mode: str = "lanczos3",
) -> np.ndarray:
    """Resize so the long side fits [min_side, max_side] and both dims are
    multiples of ``multiple``.

    Reference counterpart: the inpaint driver's resize_img, which rounds
    working dims to x64 before masking/encoding (RepText/infer_inpaint.py:
    25-46). uint8 [H, W, 3] in, uint8 out.
    """
    h, w = image.shape[:2]
    long_side = max(h, w)
    scale = 1.0
    if long_side > max_side:
        scale = max_side / long_side
    elif long_side < min_side:
        scale = min_side / long_side
    nh, nw = int(round(h * scale)), int(round(w * scale))
    nh = max(multiple, round(nh / multiple) * multiple)
    nw = max(multiple, round(nw / multiple) * multiple)
    return resize_image(image, nh, nw, method=mode)
