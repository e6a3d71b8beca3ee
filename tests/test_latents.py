"""Pack/unpack, image ids, mask downsampling — golden-value unit tests.

Golden semantics derived from the reference's torch view/permute sequences
(RepText/pipeline_flux_controlnet.py:535-570) re-derived independently with
explicit loops.
"""

import jax.numpy as jnp
import numpy as np

from reptext.ops import (
    pack_latents,
    unpack_latents,
    prepare_latent_image_ids,
    downsample_region_mask,
)
from reptext.ops.latents import glyph_latent_blend, binarize_glyph_mask_to_latent


def reference_pack(x: np.ndarray) -> np.ndarray:
    """Loop-based reimplementation of the packing order: feature = c*4 + dy*2 + dx."""
    b, c, h, w = x.shape
    out = np.zeros((b, (h // 2) * (w // 2), c * 4), dtype=x.dtype)
    for bi in range(b):
        for r in range(h // 2):
            for cc in range(w // 2):
                tok = r * (w // 2) + cc
                for ch in range(c):
                    for dy in range(2):
                        for dx in range(2):
                            out[bi, tok, ch * 4 + dy * 2 + dx] = x[bi, ch, 2 * r + dy, 2 * cc + dx]
    return out


def test_pack_matches_reference_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    got = np.asarray(pack_latents(jnp.asarray(x)))
    want = reference_pack(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 64, 64)).astype(np.float32)
    packed = pack_latents(jnp.asarray(x))
    assert packed.shape == (1, 32 * 32, 64)
    back = unpack_latents(packed, 64, 64)
    np.testing.assert_allclose(np.asarray(back), x)


def test_latent_image_ids():
    ids = np.asarray(prepare_latent_image_ids(8, 12))  # latent 8x12 -> 4x6 tokens
    assert ids.shape == (24, 3)
    # token (r, c) -> ids (0, r, c), row-major
    assert ids[0].tolist() == [0, 0, 0]
    assert ids[5].tolist() == [0, 0, 5]
    assert ids[6].tolist() == [0, 1, 0]
    assert ids[23].tolist() == [0, 3, 5]
    assert (ids[:, 0] == 0).all()


def test_region_mask_downsample_shapes_and_range():
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    tok = np.asarray(downsample_region_mask(jnp.asarray(mask), 4, 4))  # latent 4x4 -> 2x2 tokens
    assert tok.shape == (4, 1)
    assert (tok >= 0).all() and (tok <= 1).all()

    # A full mask stays all-ones after bilinear downsample.
    full = np.asarray(downsample_region_mask(jnp.ones((32, 32), np.float32), 8, 8))
    np.testing.assert_allclose(full, 1.0)


def test_glyph_latent_blend():
    noise = jnp.ones((1, 2, 4, 4))
    glyph = jnp.full((1, 2, 4, 4), 2.0)
    mask = jnp.zeros((1, 1, 4, 4)).at[0, 0, :2].set(1.0)
    out = np.asarray(glyph_latent_blend(noise, glyph, mask, scale=0.1))
    # inside mask: 0.1*2 + 1 = 1.2 ; outside: 1.0
    np.testing.assert_allclose(out[0, :, :2, :], 1.2, rtol=1e-6)
    np.testing.assert_allclose(out[0, :, 2:, :], 1.0)


def test_binarize_glyph_mask():
    glyph = np.zeros((32, 32), np.float32)
    glyph[0:16, :] = 0.7
    m = np.asarray(binarize_glyph_mask_to_latent(jnp.asarray(glyph), 8, 8))
    assert m.shape == (1, 8, 8)
    assert set(np.unique(m)).issubset({0.0, 1.0})
    assert m[0, :3].all()  # top rows fully inked
    assert not m[0, 6:].any()
