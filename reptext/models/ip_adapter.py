"""FLUX IP-Adapter: image-prompt conditioning via decoupled attention.

The reference README advertises compatibility with the published FLUX
IP-Adapter (RepText/README.md:183) but ships no adapter code — diffusers
supplies it. This module is the equivalent here, following the
diffusers FLUX IP-Adapter architecture:

- a CLIP vision encoder (nn/clip_vision.py) produces the image embedding
  (``CLIPVisionModelWithProjection.image_embeds``);
- ``ImageProjection`` (this module) maps it to ``num_tokens`` pseudo-text
  tokens of the T5 joint width (linear + LayerNorm — diffusers
  ``ImageProjection``);
- every DOUBLE transformer block attends to those tokens with its own
  RoPE-free image-stream queries through per-block ``to_k_ip``/``to_v_ip``
  projections (nn/blocks.py JointTransformerBlock.ip_adapter), the result
  added ungated at the end of the image-stream block.

Weight conversion from the diffusers checkpoint layout:
io/convert.py::{convert_ip_adapter, convert_clip_vision}. Torch parity:
tests/test_ip_adapter.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import CLIPVisionConfig, IPAdapterConfig

Dtype = Any


class ImageProjection(nn.Module):
    """[B, image_embed_dim] CLIP image embedding -> [B, N, cross_dim] tokens.

    diffusers ``ImageProjection``: one linear to N*cross_dim, reshape,
    LayerNorm over the token features.
    """

    config: IPAdapterConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, image_embeds: jax.Array) -> jax.Array:
        cfg = self.config
        b = image_embeds.shape[0]
        x = nn.Dense(
            cfg.num_tokens * cfg.cross_attention_dim, dtype=self.dtype,
            param_dtype=self.param_dtype, name="proj",
        )(image_embeds)
        x = x.reshape(b, cfg.num_tokens, cfg.cross_attention_dim)
        return nn.LayerNorm(
            dtype=jnp.float32, param_dtype=self.param_dtype, name="norm"
        )(x.astype(jnp.float32)).astype(x.dtype)


class IPAdapterEncoder:
    """Bundles the vision tower + projection into one image->tokens call.

    Holds modules only; params ride in the pipeline's param dict under
    ``params["ip_adapter"] = {"vision": ..., "proj": ...}`` (the per-block
    to_k_ip/to_v_ip live inside ``params["flux"]`` — they are transformer
    params, exactly as diffusers stores them inside the transformer after
    ``load_ip_adapter``).
    """

    def __init__(
        self,
        vision_cfg: CLIPVisionConfig,
        ip_cfg: IPAdapterConfig,
        dtype: Any = jnp.float32,
        param_dtype: Any = jnp.float32,
    ):
        from reptext.nn.clip_vision import CLIPVisionEncoder

        self.vision_cfg = vision_cfg
        self.ip_cfg = ip_cfg
        self.vision = CLIPVisionEncoder(vision_cfg, dtype, param_dtype)
        self.proj = ImageProjection(ip_cfg, dtype, param_dtype)

    def init(self, rng: jax.Array) -> Dict[str, Any]:
        r1, r2 = jax.random.split(rng)
        cfg = self.vision_cfg
        vision = self.vision.init(
            r1, jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
        )
        proj = self.proj.init(
            r2, jnp.zeros((1, self.ip_cfg.image_embed_dim))
        )
        return {"vision": vision, "proj": proj}

    def __call__(
        self, params: Dict[str, Any], image: np.ndarray
    ) -> jax.Array:
        """uint8 [H, W, 3] (or batch) -> ip tokens [B, N, cross_dim]."""
        from reptext.nn.clip_vision import preprocess_clip_image

        pixels = jnp.asarray(
            preprocess_clip_image(image, self.vision_cfg.image_size)
        )
        _, image_embeds = self.vision.apply(params["vision"], pixels)
        return self.proj.apply(params["proj"], image_embeds)
