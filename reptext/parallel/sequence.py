"""Sequence/context parallelism: shard the token axis, exchange K/V blocks.

The reference has no sequence scaling at all (SURVEY.md §2.3/§5 — sequence
length is bounded by design at 4096 image tokens); this module is the
long-context path for >=2048^2 resolutions, where the joint [text; image]
sequence outgrows one card's memory.

Two interchangeable implementations over a named mesh axis (default ``"sp"``):

- ``allgather``: K/V all-gathered once per attention; simple, one collective,
  right choice while K/V still fit per-chip (XLA overlaps the gather with the
  first matmul).
- ``ring``: K/V blocks rotate around the ring via ``lax.ppermute`` with an
  online-softmax accumulator (flash-attention statistics), so per-chip K/V
  memory stays O(S/n). XLA hands the ``ppermute`` to NCCL.

Both are expressed with ``jax.shard_map`` so they compose with the dp/tp
sharding rules (reptext/parallel/partition.py): heads can stay tp-sharded
while tokens shard over sp.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _online_softmax_block(
    q32: jax.Array,           # [B, H, Sq, D] fp32
    k_blk: jax.Array,         # [B, H, Sk, D]
    v_blk: jax.Array,         # [B, H, Sk, D]
    o: jax.Array,             # [B, H, Sq, D] fp32 accumulator
    m: jax.Array,             # [B, H, Sq] running max
    l: jax.Array,             # [B, H, Sq] running denominator
    scale: float,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One flash-attention statistics update against a K/V block."""
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q32, k_blk.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    ) * scale
    m_new = jnp.maximum(m, logits.max(axis=-1))
    correction = jnp.exp(m - m_new)
    p = jnp.exp(logits - m_new[..., None])
    l_new = l * correction + p.sum(axis=-1)
    o_new = o * correction[..., None] + jnp.einsum(
        "bhqk,bhkd->bhqd", p, v_blk.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )
    return o_new, m_new, l_new


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis_name: str = "sp",
) -> jax.Array:
    """Full (non-causal) attention with Q/K/V sharded on the token axis.

    q/k/v: [B, H, S, D] global shapes, S divisible by mesh.shape[axis_name].
    Each device holds one Q block; K/V blocks rotate around the sp ring with
    ``ppermute`` while online-softmax statistics accumulate, so the result is
    bit-for-bit an attention over the full sequence.
    """
    n = mesh.shape[axis_name]
    spec = P(None, None, axis_name, None)

    def local(q_l: jax.Array, k_l: jax.Array, v_l: jax.Array) -> jax.Array:
        scale = 1.0 / (q_l.shape[-1] ** 0.5)
        q32 = q_l.astype(jnp.float32)
        b, h, sq, d = q_l.shape
        perm = [(j, (j + 1) % n) for j in range(n)]

        def body(_, carry):
            o, m, l, k_cur, v_cur = carry
            o, m, l = _online_softmax_block(q32, k_cur, v_cur, o, m, l, scale)
            k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
            v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
            return o, m, l, k_nxt, v_nxt

        # constant-initialized carries must be marked sp-varying to match the
        # loop outputs under shard_map's varying-axis type system.
        def pvary(x):
            return jax.lax.pcast(x, axis_name, to="varying")

        o0 = pvary(jnp.zeros((b, h, sq, d), jnp.float32))
        m0 = pvary(jnp.full((b, h, sq), -jnp.inf, jnp.float32))
        l0 = pvary(jnp.zeros((b, h, sq), jnp.float32))
        o, _, l, _, _ = jax.lax.fori_loop(0, n, body, (o0, m0, l0, k_l, v_l))
        return (o / l[..., None]).astype(q_l.dtype)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec
    )(q, k, v)


def allgather_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis_name: str = "sp",
) -> jax.Array:
    """SP attention that all-gathers K/V once (the simple fallback).

    Same sharded interface as :func:`ring_attention`; per-chip K/V memory is
    O(S) but there is exactly one fused all-gather per call.
    """
    spec = P(None, None, axis_name, None)

    def local(q_l: jax.Array, k_l: jax.Array, v_l: jax.Array) -> jax.Array:
        k_full = jax.lax.all_gather(k_l, axis_name, axis=2, tiled=True)
        v_full = jax.lax.all_gather(v_l, axis_name, axis=2, tiled=True)
        scale = 1.0 / (q_l.shape[-1] ** 0.5)
        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", q_l, k_full, preferred_element_type=jnp.float32
        ) * scale
        probs = jax.nn.softmax(logits, axis=-1).astype(v_full.dtype)
        return jnp.einsum("bhqk,bhkd->bhqd", probs, v_full)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec
    )(q, k, v)


def ulysses_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis_name: str = "sp",
) -> jax.Array:
    """Ulysses-style SP: all-to-all swaps the sequence shard for a head shard.

    Each device exchanges its S/n token slice of all H heads for the FULL
    sequence of H/n heads (one fused all-to-all per tensor), computes plain
    local attention, and swaps back. Two all-to-alls per Q/K/V/O versus ring's
    n-1 ppermutes; the better choice when H is divisible by the mesh axis and
    the per-device full-sequence K/V fits HBM. (SURVEY.md §2.3 table —
    "Ulysses-style all-to-all head swap as alternative".)
    """
    n = mesh.shape[axis_name]
    if q.shape[1] % n:
        raise ValueError(f"ulysses needs heads % sp == 0, got {q.shape[1]} % {n}")
    spec = P(None, None, axis_name, None)

    def swap(x):  # [B, H, S/n, D] -> [B, H/n, S, D]
        return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                                  tiled=True)

    def local(q_l: jax.Array, k_l: jax.Array, v_l: jax.Array) -> jax.Array:
        qh, kh, vh = swap(q_l), swap(k_l), swap(v_l)
        scale = 1.0 / (qh.shape[-1] ** 0.5)
        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", qh, kh, preferred_element_type=jnp.float32
        ) * scale
        probs = jax.nn.softmax(logits, axis=-1).astype(vh.dtype)
        o = jnp.einsum("bhqk,bhkd->bhqd", probs, vh)
        return jax.lax.all_to_all(o, axis_name, split_axis=2, concat_axis=1,
                                  tiled=True)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec
    )(q, k, v)


def sequence_sharded_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis_name: str = "sp",
    impl: str = "ring",
) -> jax.Array:
    """Dispatch: ``impl`` in {'ring', 'allgather', 'ulysses'}."""
    fn = {"ring": ring_attention, "allgather": allgather_attention,
          "ulysses": ulysses_attention}.get(impl)
    if fn is None:
        raise ValueError(f"unknown sp attention impl {impl!r}")
    return fn(q, k, v, mesh, axis_name)


def joint_ring_attention_local(
    q_t: jax.Array,   # [B, H, S_txt, D] text queries (replicated over sp)
    k_t: jax.Array,
    v_t: jax.Array,
    q_i: jax.Array,   # [B, H, S_img/n, D] local image-query shard
    k_i: jax.Array,
    v_i: jax.Array,
    axis_name: str = "sp",
) -> Tuple[jax.Array, jax.Array]:
    """In-context (already inside ``shard_map``) MMDiT joint-sequence ring.

    This is the sp-aware attention the model blocks dispatch to with
    ``attention_backend='ring'`` (nn/blocks.py): the joint [text; image]
    sequence has the TEXT tokens replicated on every device and the IMAGE
    tokens sharded over ``axis_name``. Text K/V are folded into the online-
    softmax statistics exactly once, then the image K/V blocks rotate around
    the ring — after n steps both query sets have attended to the full joint
    sequence. Returns (attn_txt replicated, attn_img local shard); the text
    output is identical on every device by construction (same replicated
    inputs, same full K/V stream).

    The reference's attention is single-device torch SDPA over the whole
    4608-token sequence (SURVEY.md §3.1); this is the green-field >=2048^2
    growth path (SURVEY.md §2.3) actually wired into the model.
    """
    n = jax.lax.axis_size(axis_name)
    scale = 1.0 / (q_t.shape[-1] ** 0.5)
    perm = [(j, (j + 1) % n) for j in range(n)]

    def init(q):
        b, h, s, d = q.shape
        return (
            jnp.zeros((b, h, s, d), jnp.float32),
            jnp.full((b, h, s), -jnp.inf, jnp.float32),
            jnp.zeros((b, h, s), jnp.float32),
        )

    q32_t, q32_i = q_t.astype(jnp.float32), q_i.astype(jnp.float32)
    # text K/V contribute exactly once (replicated block, not part of the ring)
    o_t, m_t, l_t = _online_softmax_block(q32_t, k_t, v_t, *init(q32_t), scale)
    o_i, m_i, l_i = _online_softmax_block(q32_i, k_t, v_t, *init(q32_i), scale)

    def body(_, carry):
        o_t, m_t, l_t, o_i, m_i, l_i, k_cur, v_cur = carry
        o_t, m_t, l_t = _online_softmax_block(q32_t, k_cur, v_cur, o_t, m_t, l_t, scale)
        o_i, m_i, l_i = _online_softmax_block(q32_i, k_cur, v_cur, o_i, m_i, l_i, scale)
        k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
        v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
        return o_t, m_t, l_t, o_i, m_i, l_i, k_nxt, v_nxt

    o_t, m_t, l_t, o_i, m_i, l_i, _, _ = jax.lax.fori_loop(
        0, n, body, (o_t, m_t, l_t, o_i, m_i, l_i, k_i, v_i)
    )
    attn_t = (o_t / l_t[..., None]).astype(q_t.dtype)
    attn_i = (o_i / l_i[..., None]).astype(q_i.dtype)
    return attn_t, attn_i


def joint_ulysses_attention_local(
    q_t: jax.Array,   # [B, H, S_txt, D] text queries (replicated over sp)
    k_t: jax.Array,
    v_t: jax.Array,
    q_i: jax.Array,   # [B, H, S_img/n, D] local image shard
    k_i: jax.Array,
    v_i: jax.Array,
    axis_name: str = "sp",
) -> Tuple[jax.Array, jax.Array]:
    """In-context MMDiT joint-sequence Ulysses (all-to-all head swap).

    The SP alternative to :func:`joint_ring_attention_local` the blocks
    dispatch to with ``attention_backend='ulysses'``: one all-to-all trades
    each device's S_img/n token slice of all H heads for the FULL image
    sequence of H/n heads; the replicated text tensors are sliced to the
    local head group; attention over the whole joint sequence is then plain
    (exact, single softmax — no online-softmax accumulation), and the
    outputs swap back (all-to-all for image tokens, all-gather over heads
    for the replicated text output). Two all-to-alls + one all-gather per
    attention vs the ring's n-1 ppermutes per K/V — the better trade when
    H % sp == 0 and the full-sequence K/V of H/n heads fits HBM; the ring
    wins when n is large or heads don't divide. Numerics: exact softmax, so
    parity with the single-device backend is limited only by dtype.
    """
    n = jax.lax.axis_size(axis_name)
    h = q_t.shape[1]
    if h % n:
        raise ValueError(f"ulysses needs heads % sp == 0, got {h} % {n}")
    hn = h // n
    r = jax.lax.axis_index(axis_name)

    def a2a_in(x):   # [B, H, S_img/n, D] -> [B, H/n, S_img, D]
        return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                                  tiled=True)

    def slice_heads(x):  # local head group of a replicated text tensor
        return jax.lax.dynamic_slice_in_dim(x, r * hn, hn, axis=1)

    q = jnp.concatenate([slice_heads(q_t), a2a_in(q_i)], axis=2)
    k = jnp.concatenate([slice_heads(k_t), a2a_in(k_i)], axis=2)
    v = jnp.concatenate([slice_heads(v_t), a2a_in(v_i)], axis=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    o = jnp.einsum("bhqk,bhkd->bhqd", probs, v)

    s_txt = q_t.shape[2]
    # image tokens: back to the sequence shard; text tokens: every device
    # needs ALL heads (the text stream is replicated) — gather head groups
    # in device order, matching the slice order above.
    attn_i = jax.lax.all_to_all(o[:, :, s_txt:], axis_name, split_axis=2,
                                concat_axis=1, tiled=True).astype(q_i.dtype)
    attn_t = jax.lax.all_gather(o[:, :, :s_txt].astype(q_t.dtype), axis_name,
                                axis=1, tiled=True)
    return attn_t, attn_i


def sequence_parallel_forward(
    model,
    params,
    hidden_states: jax.Array,          # [B, S_img, C] packed latents (global)
    encoder_hidden_states: jax.Array,  # [B, S_txt, joint_dim]
    pooled_projections: jax.Array,
    timestep: jax.Array,
    img_ids: jax.Array,                # [S_img, 3]
    txt_ids: jax.Array,
    guidance=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = "sp",
    controlnet_block_samples=None,          # [L, B, S_img, D] or None
    controlnet_single_block_samples=None,   # [L1, B, S_img, D] or None
):
    """Run a FluxTransformer2D forward with the IMAGE SEQUENCE sharded.

    ``model`` must be constructed with ``attention_backend='ring'`` or
    ``'ulysses'`` (both block-level SP paths, nn/blocks.py:131). Params
    and text-side inputs are replicated; packed latents, image RoPE ids, and
    any ControlNet residual stacks shard over ``axis_name`` (residual
    injection is per-token, so token-sharded stacks compose with the ring
    attention without extra collectives); inside the shard_map the blocks'
    ring path (joint_ring_attention_local) exchanges K/V over the ring. The
    output (velocity prediction per image token) comes back sequence-sharded.
    """
    tok = P(None, axis_name, None)
    ids = P(axis_name, None)
    res = P(None, None, axis_name, None)

    def local(params, hidden_l, ctx, pooled, t, img_ids_l, txt_ids_l,
              guidance_l, block_res_l, single_res_l):
        return model.apply(
            params, hidden_l, ctx, pooled, t, img_ids_l, txt_ids_l, guidance_l,
            controlnet_block_samples=block_res_l,
            controlnet_single_block_samples=single_res_l,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), tok, P(), P(), P(), ids, P(), P(), res, res),
        out_specs=tok,
        check_vma=False,
    )(params, hidden_states, encoder_hidden_states, pooled_projections,
      timestep, img_ids, txt_ids, guidance,
      controlnet_block_samples, controlnet_single_block_samples)


def make_sp_mesh(sp: int, devices=None) -> Mesh:
    """A 1-axis sequence-parallel mesh (composable helper for tests/serving)."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    if len(devices) < sp:
        raise ValueError(f"need {sp} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:sp]), axis_names=("sp",))
