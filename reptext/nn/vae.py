"""FLUX AutoencoderKL (f=8, 16 latent channels), NHWC layout.

The reference gets this model from diffusers (`AutoencoderKL`, used for
condition encoding and final decode, RepText/pipeline_flux_controlnet.py:
663-731, 1132-1140). Choices here: NHWC tensor layout (channels last, as
cuDNN's tensor-core convolutions prefer), GroupNorm in fp32, and the mid-block self-attention expressed
as one batched matmul over spatial tokens.

Architecture (FLUX.1-dev VAE config): encoder conv_in -> 4 down stages
(resnets x layers_per_block, stride-2 downsample between stages) -> mid
(resnet, attention, resnet) -> GroupNorm/silu/conv_out producing 2*latent
moments; decoder mirrors it with (layers_per_block + 1) resnets per up stage
and nearest-neighbor x2 upsampling. Latent distribution is diagonal Gaussian;
``scaling_factor``/``shift_factor`` normalization is applied by callers
(pipeline), matching reference semantics.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.configs import VAEConfig

Dtype = Any


class GroupNorm32(nn.Module):
    """GroupNorm computed in fp32, cast back to compute dtype."""

    num_groups: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        orig = x.dtype
        out = nn.GroupNorm(
            num_groups=self.num_groups, epsilon=1e-6, dtype=jnp.float32,
            param_dtype=self.param_dtype, name="norm",
        )(x.astype(jnp.float32))
        return out.astype(orig)


class ResnetBlock(nn.Module):
    out_channels: int
    norm_num_groups: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        conv = lambda feat, name: nn.Conv(  # noqa: E731
            feat, (3, 3), padding=1, dtype=self.dtype, param_dtype=self.param_dtype,
            name=name,
        )
        h = GroupNorm32(self.norm_num_groups, self.param_dtype, name="norm1")(x)
        h = conv(self.out_channels, "conv1")(nn.silu(h))
        h = GroupNorm32(self.norm_num_groups, self.param_dtype, name="norm2")(h)
        h = conv(self.out_channels, "conv2")(nn.silu(h))
        if x.shape[-1] != self.out_channels:
            x = nn.Conv(
                self.out_channels, (1, 1), dtype=self.dtype,
                param_dtype=self.param_dtype, name="conv_shortcut",
            )(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (VAE mid block)."""

    channels: int
    norm_num_groups: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, h, w, c = x.shape
        dense = lambda name: nn.Dense(  # noqa: E731
            self.channels, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        hidden = GroupNorm32(self.norm_num_groups, self.param_dtype, name="group_norm")(x)
        tokens = hidden.reshape(b, h * w, c)
        q, k, v = dense("to_q")(tokens), dense("to_k")(tokens), dense("to_v")(tokens)
        logits = jnp.einsum("bqc,bkc->bqk", q, k, preferred_element_type=jnp.float32)
        probs = jax.nn.softmax(logits / jnp.sqrt(c).astype(jnp.float32), axis=-1)
        out = jnp.einsum("bqk,bkc->bqc", probs.astype(v.dtype), v)
        out = dense("to_out")(out).reshape(b, h, w, c)
        return x + out


class Encoder(nn.Module):
    config: VAEConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        cfg = self.config
        ch = cfg.block_out_channels
        x = nn.Conv(ch[0], (3, 3), padding=1, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="conv_in")(x)
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                x = ResnetBlock(out_ch, cfg.norm_num_groups, self.dtype,
                                self.param_dtype, name=f"down_{i}_block_{j}")(x)
            if i < len(ch) - 1:
                # asymmetric pad (0,1)x(0,1) then stride-2 conv (diffusers Downsample2D)
                x = jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
                x = nn.Conv(out_ch, (3, 3), strides=2, padding="VALID",
                            dtype=self.dtype, param_dtype=self.param_dtype,
                            name=f"down_{i}_downsample")(x)
        mid_ch = ch[-1]
        x = ResnetBlock(mid_ch, cfg.norm_num_groups, self.dtype, self.param_dtype,
                        name="mid_block_1")(x)
        x = AttnBlock(mid_ch, cfg.norm_num_groups, self.dtype, self.param_dtype,
                      name="mid_attn")(x)
        x = ResnetBlock(mid_ch, cfg.norm_num_groups, self.dtype, self.param_dtype,
                        name="mid_block_2")(x)
        x = GroupNorm32(cfg.norm_num_groups, self.param_dtype, name="norm_out")(x)
        x = nn.Conv(2 * cfg.latent_channels, (3, 3), padding=1, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="conv_out")(nn.silu(x))
        return x  # [B, H/8, W/8, 2*latent]


class Decoder(nn.Module):
    config: VAEConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, z: jax.Array) -> jax.Array:
        cfg = self.config
        ch = cfg.block_out_channels
        x = nn.Conv(ch[-1], (3, 3), padding=1, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="conv_in")(z)
        x = ResnetBlock(ch[-1], cfg.norm_num_groups, self.dtype, self.param_dtype,
                        name="mid_block_1")(x)
        x = AttnBlock(ch[-1], cfg.norm_num_groups, self.dtype, self.param_dtype,
                      name="mid_attn")(x)
        x = ResnetBlock(ch[-1], cfg.norm_num_groups, self.dtype, self.param_dtype,
                        name="mid_block_2")(x)
        for i, out_ch in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                x = ResnetBlock(out_ch, cfg.norm_num_groups, self.dtype,
                                self.param_dtype, name=f"up_{i}_block_{j}")(x)
            if i < len(ch) - 1:
                b, h, w, c = x.shape
                x = jax.image.resize(x, (b, 2 * h, 2 * w, c), method="nearest")
                x = nn.Conv(out_ch, (3, 3), padding=1, dtype=self.dtype,
                            param_dtype=self.param_dtype, name=f"up_{i}_upsample")(x)
        x = GroupNorm32(cfg.norm_num_groups, self.param_dtype, name="norm_out")(x)
        x = nn.Conv(cfg.out_channels, (3, 3), padding=1, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="conv_out")(nn.silu(x))
        return x


class AutoencoderKL(nn.Module):
    """Encode images to diagonal-Gaussian latents and decode back. NHWC."""

    config: VAEConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.encoder = Encoder(self.config, self.dtype, self.param_dtype)
        self.decoder = Decoder(self.config, self.dtype, self.param_dtype)

    def encode_moments(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """images [B, H, W, 3] in [-1, 1] -> (mean, logvar) each [B, H/8, W/8, C]."""
        moments = self.encoder(images)
        mean, logvar = jnp.split(moments, 2, axis=-1)
        return mean, jnp.clip(logvar, -30.0, 20.0)

    def encode(
        self, images: jax.Array, rng: Optional[jax.Array] = None
    ) -> jax.Array:
        """Sample (or take the mode when rng is None) of the latent posterior."""
        mean, logvar = self.encode_moments(images)
        if rng is None:
            return mean
        std = jnp.exp(0.5 * logvar)
        return mean + std * jax.random.normal(rng, mean.shape, dtype=mean.dtype)

    def decode(self, latents: jax.Array) -> jax.Array:
        """latents [B, H/8, W/8, C] (unscaled) -> images [B, H, W, 3] in [-1, 1]."""
        return self.decoder(latents)

    def __call__(self, images: jax.Array, rng: Optional[jax.Array] = None) -> jax.Array:
        return self.decode(self.encode(images, rng))
