"""Tiled VAE encode/decode — bounded-activation-memory image<->latent maps.

Why this exists: a full 1024^2 VAE decode peaks at several GB of conv
activations, and more at higher resolutions. Decoding in overlapping tiles
caps the activation footprint at the tile size, so it fits beside resident
models with little memory to spare.

Mechanism: clamped full-size tiles over the input grid (one XLA program
signature — every tile has the same shape), each output tile multiplied by
a separable ramp window (linear ramps over the overlap borders), accumulated
into a host float32 canvas and normalized by the accumulated weight. The
ramp never reaches zero (min weight 1/(overlap+1)) so normalization is
well-defined everywhere, including image borders.

Fidelity: convs see a truncated receptive field at tile borders and
GroupNorm statistics are per-tile, so tiled != full bitwise; with
overlap >= 16 latent px the blended seams are visually and numerically
small (tests/test_vae_tiling.py pins tolerances). This is the same
trade the standard diffusers `AutoencoderKL.enable_tiling()` memory
mechanism makes; the reference never needs it because its GPU host
offloads whole models instead (RepText/pipeline_flux_controlnet.py:190).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

__all__ = ["tile_positions", "blend_weights_1d", "tiled_apply"]


def tile_positions(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets of full-size tiles covering [0, size).

    Tiles are clamped to the grid (last start = size - tile), so every tile
    has the same shape — one compiled program per tile family instead of a
    ragged edge shape.
    """
    if tile >= size:
        return [0]
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return pos


def blend_weights_1d(tile: int, overlap: int, pos: int, size: int) -> np.ndarray:
    """Per-axis blending weights for a tile at `pos` in a `size` grid.

    1.0 in the interior; a linear ramp (k+1)/(overlap+1) over the first/last
    `overlap` samples on sides that have a neighbouring tile (i.e. not at the
    grid border). Strictly positive everywhere so the weight-sum
    normalization in tiled_apply never divides by zero.
    """
    w = np.ones(tile, np.float32)
    if overlap <= 0:
        return w
    ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
    if pos > 0:
        w[:overlap] = np.minimum(w[:overlap], ramp)
    if pos + tile < size:
        w[-overlap:] = np.minimum(w[-overlap:], ramp[::-1])
    return w


def tiled_apply(
    tile_fn: Callable,
    x: np.ndarray,
    tile: int,
    overlap: int,
    out_num: int,
    out_den: int,
    out_channels: int,
) -> np.ndarray:
    """Apply an NHWC spatial map tile-by-tile with blended overlaps.

    tile_fn: ([B, tile, tile, C_in], tile_index) ->
      [B, tile*out_num/out_den, ..., C_out] (a jitted VAE decode step:
      out_num/out_den = 8/1; encode: 1/8). `tile_index` lets stochastic
      encoders fold a per-tile rng; deterministic fns ignore it.
    x: [B, H, W, C_in] host array. tile/overlap in INPUT units; for encode
      they must be multiples of out_den so output indices stay integral.
    Returns a float32 [B, H*out_num/out_den, W*..., out_channels] array.
    """
    b, h, w, _ = x.shape
    if (tile * out_num) % out_den or (overlap * out_num) % out_den:
        raise ValueError(
            f"tile ({tile}) and overlap ({overlap}) must map to whole output "
            f"samples under x{out_num}/{out_den}"
        )
    stride = tile - overlap
    ys = tile_positions(h, tile, stride)
    xs = tile_positions(w, tile, stride)

    def to_out(v: int) -> int:
        return v * out_num // out_den

    oh, ow, ot = to_out(h), to_out(w), to_out(tile)
    o_overlap = to_out(overlap)
    accum = np.zeros((b, oh, ow, out_channels), np.float32)
    weight = np.zeros((oh, ow, 1), np.float32)
    # dispatch EVERY tile before fetching any: JAX async dispatch queues the
    # device programs back-to-back, so tile i+1's host->device input
    # transfer overlaps tile i's compute instead of serializing
    # (upload, compute, download) per tile. Live device
    # memory is bounded by the T output tiles (tiny for encode, ~3MB/tile
    # fp32 for a 512px decode tile).
    pending = []
    idx = 0
    for y in ys:
        for xpos in xs:
            pending.append((y, xpos,
                            tile_fn(x[:, y:y + tile, xpos:xpos + tile, :], idx)))
            idx += 1
    for y, xpos, out_dev in pending:
        out = np.asarray(out_dev, np.float32)
        wy = blend_weights_1d(ot, o_overlap, to_out(y), oh)
        wx = blend_weights_1d(ot, o_overlap, to_out(xpos), ow)
        w2d = (wy[:, None] * wx[None, :])[:, :, None]
        oy, ox = to_out(y), to_out(xpos)
        accum[:, oy:oy + ot, ox:ox + ot, :] += out * w2d
        weight[oy:oy + ot, ox:ox + ot, :] += w2d
    return accum / weight
