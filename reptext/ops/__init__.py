"""Core tensor ops: attention dispatch, RoPE, latent packing."""

from reptext.ops.latents import (  # noqa: F401
    pack_latents,
    unpack_latents,
    prepare_latent_image_ids,
    downsample_region_mask,
)
from reptext.ops.rope import (  # noqa: F401
    rope_cos_sin,
    apply_rope,
    rope_cos_sin_half,
    apply_rope_half,
    deinterleave_perm,
)
