"""CLIP ViT vision encoder — the IP-Adapter image-prompt encoder.

The reference README advertises compatibility with the published FLUX
IP-Adapter (RepText/README.md:183), which diffusers drives through a
``CLIPVisionModelWithProjection`` (openai/clip-vit-large-patch14). This is
the equivalent here: patchify-conv + CLS token + learned position
embeddings, pre-LayerNorm transformer (non-causal; same layer math as the
text tower in nn/clip.py), post-LayerNorm on the CLS state, and a linear
visual projection producing the image embedding the IP-Adapter projects
into pseudo-text tokens.

Weight conversion from the transformers checkpoint layout lives in
io/convert.py::convert_clip_vision (torch parity:
tests/test_ip_adapter.py).
"""

from __future__ import annotations

from typing import Any, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import CLIPVisionConfig
from reptext.nn.clip import CLIPEncoderLayer
from reptext.configs import CLIPConfig

Dtype = Any

# OpenAI CLIP preprocessing constants (transformers CLIPImageProcessor).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(image: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] (or [B, H, W, 3]) -> float32 NHWC, CLIP-normalized.

    Center-crop to a square, bicubic resize to ``image_size`` (the
    CLIPImageProcessor shortest-edge resize + center crop), then
    (x/255 - mean) / std.
    """
    from reptext.utils.image import resize_image

    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    out = np.empty((arr.shape[0], image_size, image_size, 3), np.float32)
    for i, img in enumerate(arr):
        h, w = img.shape[:2]
        if (h, w) != (image_size, image_size):
            short = min(h, w)
            y0, x0 = (h - short) // 2, (w - short) // 2
            img = img[y0:y0 + short, x0:x0 + short]
            img = resize_image(img.astype(np.uint8), image_size, image_size, "cubic")
        out[i] = img.astype(np.float32) / 255.0
    mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.asarray(CLIP_IMAGE_STD, np.float32)
    return (out - mean) / std


class CLIPVisionEncoder(nn.Module):
    """Returns (last_hidden_state [B, 1+P, H], image_embeds [B, proj_dim]).

    ``image_embeds`` is the post-LayerNorm CLS state through the visual
    projection — the ``CLIPVisionModelWithProjection.image_embeds`` output
    the FLUX IP-Adapter consumes.
    """

    config: CLIPVisionConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, pixel_values: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.config
        b = pixel_values.shape[0]

        patches = nn.Conv(
            cfg.hidden_size,
            kernel_size=(cfg.patch_size, cfg.patch_size),
            strides=(cfg.patch_size, cfg.patch_size),
            use_bias=False,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="patch_embedding",
        )(pixel_values)                                   # [B, h, w, H]
        patches = patches.reshape(b, -1, cfg.hidden_size)  # [B, P, H]

        cls = self.param(
            "class_embedding", nn.initializers.normal(0.02),
            (cfg.hidden_size,), self.param_dtype,
        )
        cls = jnp.broadcast_to(
            cls.astype(patches.dtype)[None, None], (b, 1, cfg.hidden_size)
        )
        x = jnp.concatenate([cls, patches], axis=1)        # [B, 1+P, H]

        pos = nn.Embed(
            1 + cfg.num_patches, cfg.hidden_size, dtype=self.dtype,
            param_dtype=self.param_dtype, name="position_embedding",
        )(jnp.arange(x.shape[1])[None, :])
        x = x + pos

        x = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=jnp.float32,
            param_dtype=self.param_dtype, name="pre_layrnorm",
        )(x.astype(jnp.float32)).astype(x.dtype)

        # The vision tower reuses the text tower's layer (same math, no
        # causal mask). CLIPEncoderLayer takes a boolean attention mask.
        full = jnp.ones((x.shape[1], x.shape[1]), dtype=bool)[None, None]
        layer_cfg = CLIPConfig(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            layer_norm_eps=cfg.layer_norm_eps,
        )
        for i in range(cfg.num_layers):
            x = CLIPEncoderLayer(
                layer_cfg, self.dtype, self.param_dtype, name=f"layer_{i}"
            )(x, full)

        pooled = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=jnp.float32,
            param_dtype=self.param_dtype, name="post_layernorm",
        )(x[:, 0].astype(jnp.float32)).astype(x.dtype)

        image_embeds = nn.Dense(
            cfg.projection_dim, use_bias=False, dtype=self.dtype,
            param_dtype=self.param_dtype, name="visual_projection",
        )(pooled)
        return x, image_embeds
