"""FLUX MMDiT transformer blocks (double-stream joint + single-stream).

Semantics follow the FLUX architecture the reference composes from diffusers
(`FluxTransformerBlock`, `FluxSingleTransformerBlock`, imported at
RepText/controlnet_flux.py:29):

- Double block: AdaLN-Zero per stream; joint attention where the text stream
  contributes additional K/V/Q projections, sequences concatenated [text; image]
  with 3D RoPE over the combined ids (half-split layout, rotated inside
  ops/attention.py); gated residuals; per-stream gelu-tanh FF.
- Single block: one AdaLN; parallel attention + MLP branches concatenated and
  projected out jointly; gated residual.

Per-head RMS q/k-norm (eps 1e-6) in both. All matmuls run in the module compute
dtype (bf16 on the GPU); softmax and norms accumulate fp32.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from reptext.nn import module as nn
import jax
import jax.numpy as jnp

from reptext.nn.layers import (
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    FeedForward,
    RMSNorm,
    gelu_tanh,
    layer_norm_no_affine,
)
from reptext.ops.attention import attention

Dtype = Any


def _split_heads(x: jax.Array, num_heads: int) -> jax.Array:
    """[B, S, H*D] -> [B, H, S, D]."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(0, 2, 1, 3)


def _merge_heads(x: jax.Array) -> jax.Array:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


class JointTransformerBlock(nn.Module):
    """Double-stream MMDiT block over (image tokens, text tokens)."""

    dim: int
    num_heads: int
    head_dim: int
    mlp_ratio: float = 4.0
    attention_backend: Optional[str] = None
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # IP-Adapter (image prompt): when True the block carries to_k_ip/to_v_ip
    # projections and the image stream additionally attends to the projected
    # image-prompt tokens with its own (pre-RoPE) queries — the decoupled
    # cross-attention of the published FLUX IP-Adapter the reference README
    # advertises compatibility with (RepText/README.md:183; diffusers
    # FluxIPAdapterJointAttnProcessor2_0 semantics).
    ip_adapter: bool = False

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,           # [B, S_img, dim]
        encoder_hidden_states: jax.Array,   # [B, S_txt, dim]
        temb: jax.Array,                    # [B, dim]
        rope_cos: jax.Array,                # [S_txt+S_img, head_dim]
        rope_sin: jax.Array,
        ip_tokens: Optional[jax.Array] = None,   # [B, N_ip, cross_dim]
        ip_scale: Optional[jax.Array] = None,    # scalar
    ) -> Tuple[jax.Array, jax.Array]:
        dense = lambda feat, name: nn.Dense(  # noqa: E731
            feat, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        inner = self.num_heads * self.head_dim
        s_txt = encoder_hidden_states.shape[1]

        norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = AdaLayerNormZero(
            self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="norm1"
        )(hidden_states, temb)
        norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = AdaLayerNormZero(
            self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="norm1_context"
        )(encoder_hidden_states, temb)

        # Image-stream projections
        q_i = _split_heads(dense(inner, "to_q")(norm_img), self.num_heads)
        k_i = _split_heads(dense(inner, "to_k")(norm_img), self.num_heads)
        v_i = _split_heads(dense(inner, "to_v")(norm_img), self.num_heads)
        # Text-stream (added) projections
        q_t = _split_heads(dense(inner, "add_q_proj")(norm_txt), self.num_heads)
        k_t = _split_heads(dense(inner, "add_k_proj")(norm_txt), self.num_heads)
        v_t = _split_heads(dense(inner, "add_v_proj")(norm_txt), self.num_heads)

        rms = lambda name: RMSNorm(self.head_dim, param_dtype=self.param_dtype, name=name)  # noqa: E731
        q_i, k_i = rms("norm_q")(q_i), rms("norm_k")(k_i)
        q_t, k_t = rms("norm_added_q")(q_t), rms("norm_added_k")(k_t)

        # Decoupled image-prompt attention: RoPE-free image-stream queries
        # (post q-norm) over the N_ip projected tokens; no k-norm on the ip
        # keys (diffusers to_k_ip/to_v_ip have none). Result is added to the
        # image stream at the END of the block, ungated (diffusers
        # FluxTransformerBlock adds ip_attn_output after the FF residual).
        ip_attn = None
        if self.ip_adapter:
            if ip_tokens is None:
                raise ValueError("ip_adapter block requires ip_tokens")
            from reptext.ops.attention import xla_attention

            k_ip = _split_heads(dense(inner, "to_k_ip")(ip_tokens), self.num_heads)
            v_ip = _split_heads(dense(inner, "to_v_ip")(ip_tokens), self.num_heads)
            ip_attn = _merge_heads(xla_attention(q_i, k_ip, v_ip))
            scale = jnp.asarray(1.0 if ip_scale is None else ip_scale)
            if scale.ndim == 1:        # per-request scale in a served batch
                scale = scale[:, None, None]
            ip_attn = scale.astype(ip_attn.dtype) * ip_attn

        # Joint sequence: [text; image]. RoPE (half-split layout) is applied
        # inside attention().
        q = jnp.concatenate([q_t, q_i], axis=2)
        k = jnp.concatenate([k_t, k_i], axis=2)
        v = jnp.concatenate([v_t, v_i], axis=2)

        if self.attention_backend in ("ring", "ulysses"):
            # Sequence-parallel path (inside a shard_map over the sp axis):
            # text tokens replicated, image tokens sharded; K/V exchange via
            # the ppermute ring or an all-to-all head swap
            # (parallel/sequence.py). RoPE is applied here (local tables) so
            # roped K blocks travel through the collective.
            from reptext.ops.rope import apply_rope_half
            from reptext.parallel.sequence import (
                joint_ring_attention_local, joint_ulysses_attention_local)

            sp_attn = (joint_ring_attention_local
                       if self.attention_backend == "ring"
                       else joint_ulysses_attention_local)
            q = apply_rope_half(q, rope_cos, rope_sin)
            k = apply_rope_half(k, rope_cos, rope_sin)
            attn_t, attn_i = sp_attn(
                q[:, :, :s_txt], k[:, :, :s_txt], v[:, :, :s_txt],
                q[:, :, s_txt:], k[:, :, s_txt:], v[:, :, s_txt:],
            )
            txt_attn = _merge_heads(attn_t)
            img_attn = _merge_heads(attn_i)
        else:
            attn = _merge_heads(attention(q, k, v, backend=self.attention_backend,
                                          rope_cos=rope_cos, rope_sin=rope_sin))
            txt_attn, img_attn = attn[:, :s_txt], attn[:, s_txt:]

        # Image stream: gated attention + FF
        hidden_states = hidden_states + gate_msa[:, None, :] * dense(self.dim, "to_out")(img_attn)
        norm2 = layer_norm_no_affine(hidden_states)
        norm2 = norm2 * (1.0 + scale_mlp[:, None, :]) + shift_mlp[:, None, :]
        ff_out = FeedForward(
            self.dim, self.mlp_ratio, dtype=self.dtype, param_dtype=self.param_dtype, name="ff"
        )(norm2.astype(hidden_states.dtype))
        hidden_states = hidden_states + gate_mlp[:, None, :] * ff_out
        if ip_attn is not None:
            hidden_states = hidden_states + ip_attn

        # Text stream
        encoder_hidden_states = (
            encoder_hidden_states
            + c_gate_msa[:, None, :] * dense(self.dim, "to_add_out")(txt_attn)
        )
        norm2_c = layer_norm_no_affine(encoder_hidden_states)
        norm2_c = norm2_c * (1.0 + c_scale_mlp[:, None, :]) + c_shift_mlp[:, None, :]
        ff_c_out = FeedForward(
            self.dim, self.mlp_ratio, dtype=self.dtype, param_dtype=self.param_dtype,
            name="ff_context",
        )(norm2_c.astype(encoder_hidden_states.dtype))
        encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None, :] * ff_c_out

        return encoder_hidden_states, hidden_states


class SingleTransformerBlock(nn.Module):
    """Single-stream block over the concatenated [text; image] sequence."""

    dim: int
    num_heads: int
    head_dim: int
    mlp_ratio: float = 4.0
    attention_backend: Optional[str] = None
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # text-token count at the head of the sequence; required by the 'ring'
    # sequence-parallel backend (text replicated, image sharded)
    txt_len: Optional[int] = None

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,  # [B, S, dim]
        temb: jax.Array,           # [B, dim]
        rope_cos: jax.Array,       # [S, head_dim]
        rope_sin: jax.Array,
    ) -> jax.Array:
        dense = lambda feat, name: nn.Dense(  # noqa: E731
            feat, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        inner = self.num_heads * self.head_dim
        mlp_dim = int(self.dim * self.mlp_ratio)

        residual = hidden_states
        normed, gate = AdaLayerNormZeroSingle(
            self.dim, dtype=self.dtype, param_dtype=self.param_dtype, name="norm"
        )(hidden_states, temb)

        mlp = gelu_tanh(dense(mlp_dim, "proj_mlp")(normed))

        q = _split_heads(dense(inner, "to_q")(normed), self.num_heads)
        k = _split_heads(dense(inner, "to_k")(normed), self.num_heads)
        v = _split_heads(dense(inner, "to_v")(normed), self.num_heads)
        q = RMSNorm(self.head_dim, param_dtype=self.param_dtype, name="norm_q")(q)
        k = RMSNorm(self.head_dim, param_dtype=self.param_dtype, name="norm_k")(k)

        if self.attention_backend in ("ring", "ulysses"):
            if self.txt_len is None:
                raise ValueError(
                    f"attention_backend={self.attention_backend!r} needs "
                    "txt_len on the single block"
                )
            from reptext.ops.rope import apply_rope_half
            from reptext.parallel.sequence import (
                joint_ring_attention_local, joint_ulysses_attention_local)

            sp_attn = (joint_ring_attention_local
                       if self.attention_backend == "ring"
                       else joint_ulysses_attention_local)
            s_txt = self.txt_len
            q = apply_rope_half(q, rope_cos, rope_sin)
            k = apply_rope_half(k, rope_cos, rope_sin)
            attn_t, attn_i = sp_attn(
                q[:, :, :s_txt], k[:, :, :s_txt], v[:, :, :s_txt],
                q[:, :, s_txt:], k[:, :, s_txt:], v[:, :, s_txt:],
            )
            attn = jnp.concatenate(
                [_merge_heads(attn_t), _merge_heads(attn_i)], axis=1
            )
        else:
            attn = _merge_heads(attention(q, k, v, backend=self.attention_backend,
                                          rope_cos=rope_cos, rope_sin=rope_sin))

        joint = jnp.concatenate([attn, mlp], axis=-1)
        out = dense(self.dim, "proj_out")(joint)
        return residual + gate[:, None, :] * out
