"""Differentiable OCR text-perceptual loss: crop op numerics, judge-path
agreement with the eval-time preprocessing, discrimination, and gradient flow
through the training step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.ops.crop import crop_and_resize
from reptext.sampling.ocr_loss import (
    aspect_box,
    glyph_ink_bbox,
    ocr_ctc_loss,
    ocr_logits_from_images,
    standardize_crops,
)


# ------------------------------------------------------------------ crop op


def test_crop_identity_box_constant_image():
    img = jnp.full((1, 16, 20, 3), 0.7)
    out = crop_and_resize(img, jnp.asarray([[0.0, 0.0, 1.0, 1.0]]), 8, 10)
    np.testing.assert_allclose(np.asarray(out), 0.7, rtol=1e-6)


def test_crop_linear_ramp_exact():
    """Bilinear sampling of a linear field reproduces it exactly."""
    h, w = 32, 64
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (2.0 * ys + 3.0 * xs)[None, :, :, None]
    box = np.asarray([[0.25, 0.125, 0.75, 0.625]], np.float32)
    oh, ow = 8, 16
    out = np.asarray(crop_and_resize(jnp.asarray(img), jnp.asarray(box), oh, ow))[0, :, :, 0]
    # expected: field evaluated at the sample coordinates
    y0, x0, y1, x1 = box[0]
    ey = (y0 + (np.arange(oh) + 0.5) / oh * (y1 - y0)) * h - 0.5
    ex = (x0 + (np.arange(ow) + 0.5) / ow * (x1 - x0)) * w - 0.5
    expected = 2.0 * ey[:, None] + 3.0 * ex[None, :]
    np.testing.assert_allclose(out, expected, rtol=1e-5)


def test_crop_per_sample_boxes():
    img = np.zeros((2, 8, 8, 1), np.float32)
    img[0, :4] = 1.0          # top half bright
    img[1, :, 4:] = 1.0       # right half bright
    boxes = jnp.asarray([[0.0, 0.0, 0.5, 1.0],   # top half
                         [0.0, 0.5, 1.0, 1.0]])  # right half
    out = np.asarray(crop_and_resize(jnp.asarray(img), boxes, 4, 4))
    np.testing.assert_allclose(out[0], 1.0, atol=1e-5)
    np.testing.assert_allclose(out[1], 1.0, atol=1e-5)


def test_crop_gradients_flow():
    img = jnp.asarray(np.random.default_rng(0).standard_normal((1, 16, 16, 1)),
                      jnp.float32)
    box = jnp.asarray([[0.2, 0.2, 0.8, 0.9]])

    g_img = jax.grad(lambda im: crop_and_resize(im, box, 8, 8).sum())(img)
    assert float(jnp.abs(g_img).sum()) > 0.0
    g_box = jax.grad(lambda b: (crop_and_resize(img, b, 8, 8) ** 2).sum())(box)
    assert np.all(np.isfinite(np.asarray(g_box)))


# ------------------------------------------------------- judge-path parity


def _scene_with_word(text="CAFE", font_size=40):
    """Render ``text`` into a larger grayscale scene; returns (scene_rgb
    [H,W,3] float in [-1,1], normalized judge box)."""
    from reptext.eval.ocr import render_word

    word = render_word(text, font_size=font_size)          # [h, w] in [0,1]
    H, W = 128, 256
    scene = np.full((H, W), 0.1, np.float32)
    oy, ox = 40, 60
    h, w = word.shape
    scene[oy:oy + h, ox:ox + w] = np.maximum(scene[oy:oy + h, ox:ox + w], word)
    canvas = (np.repeat(scene[:, :, None], 3, axis=2) * 255).astype(np.uint8)
    bbox = glyph_ink_bbox(np.where(canvas > 40, canvas, 0))
    box = aspect_box(bbox, H, W)
    rgb = np.repeat(scene[:, :, None], 3, axis=2) * 2.0 - 1.0
    return rgb, box


def test_ingraph_preprocess_decodes_like_eval():
    """The jittable crop->standardize path feeds the judge well enough to
    decode the same string as the host-side prepare_crop path."""
    from reptext.eval.ocr import OCRJudge, decode_logits, load_judge, prepare_crop

    try:
        params = load_judge()
    except FileNotFoundError:
        pytest.skip("no frozen judge weights")
    text = "CAFE"
    rgb, box = _scene_with_word(text)
    logits = ocr_logits_from_images(
        jnp.asarray(rgb[None]), jnp.asarray(box[None]), params
    )
    assert decode_logits(np.asarray(logits)) == [text]

    # host-side eval path on the raw scene crop agrees
    gray = (rgb.mean(axis=-1) + 1.0) / 2.0
    crop = prepare_crop(gray)
    ref_logits = OCRJudge().apply(params, jnp.asarray(crop[None]))
    assert decode_logits(np.asarray(ref_logits)) == [text]


def test_ctc_loss_discriminates_text_from_noise():
    from reptext.eval.ocr import CHAR_TO_ID, MAX_LABEL, load_judge

    try:
        params = load_judge()
    except FileNotFoundError:
        pytest.skip("no frozen judge weights")
    text = "CAFE"
    rgb, box = _scene_with_word(text)
    labels = np.zeros((1, MAX_LABEL), np.int32)
    paddings = np.ones((1, MAX_LABEL), np.float32)
    ids = [CHAR_TO_ID[c] for c in text]
    labels[0, : len(ids)] = ids
    paddings[0, : len(ids)] = 0.0

    good = float(ocr_ctc_loss(
        jnp.asarray(rgb[None]), jnp.asarray(box[None]),
        jnp.asarray(labels), jnp.asarray(paddings), params,
    ))
    noise = np.random.default_rng(0).standard_normal(rgb.shape).astype(np.float32)
    bad = float(ocr_ctc_loss(
        jnp.asarray(noise[None]), jnp.asarray(box[None]),
        jnp.asarray(labels), jnp.asarray(paddings), params,
    ))
    assert np.isfinite(good) and np.isfinite(bad)
    assert good < bad - 1.0, (good, bad)


def test_ctc_loss_sample_weights_zero_out():
    from reptext.eval.ocr import CHAR_TO_ID, MAX_LABEL, load_judge

    try:
        params = load_judge()
    except FileNotFoundError:
        pytest.skip("no frozen judge weights")
    rgb, box = _scene_with_word("STOP")
    labels = np.zeros((2, MAX_LABEL), np.int32)
    paddings = np.ones((2, MAX_LABEL), np.float32)
    ids = [CHAR_TO_ID[c] for c in "STOP"]
    for b in range(2):
        labels[b, : len(ids)] = ids
        paddings[b, : len(ids)] = 0.0
    imgs = jnp.asarray(np.stack([rgb, rgb]))
    boxes = jnp.asarray(np.stack([box, box]))
    full = ocr_ctc_loss(imgs, boxes, jnp.asarray(labels), jnp.asarray(paddings),
                        params, sample_weights=jnp.asarray([1.0, 1.0]))
    half = ocr_ctc_loss(imgs, boxes, jnp.asarray(labels), jnp.asarray(paddings),
                        params, sample_weights=jnp.asarray([1.0, 0.0]))
    np.testing.assert_allclose(float(full), float(half), rtol=1e-5)


# ----------------------------------------------- aspect box / bbox helpers


def test_aspect_box_is_judge_aspect():
    from reptext.eval.ocr import IMG_H, IMG_W

    box = aspect_box((10, 20, 30, 100), 128, 256)
    y0, x0, y1, x1 = box
    bh, bw = (y1 - y0) * 128, (x1 - x0) * 256
    np.testing.assert_allclose(bw / bh, IMG_W / IMG_H, rtol=1e-5)


def test_glyph_ink_bbox():
    canvas = np.zeros((10, 10, 3), np.uint8)
    canvas[2:5, 3:8] = 200
    assert glyph_ink_bbox(canvas) == (2, 3, 5, 8)
    assert glyph_ink_bbox(np.zeros((4, 4, 3), np.uint8)) is None


def test_standardize_crops():
    crops = jnp.asarray(np.random.default_rng(1).uniform(2, 9, (3, 8, 8, 1)),
                        jnp.float32)
    out = standardize_crops(crops)
    m = np.asarray(out).mean(axis=(1, 2, 3))
    s = np.asarray(out).std(axis=(1, 2, 3))
    np.testing.assert_allclose(m, 0.0, atol=1e-4)
    np.testing.assert_allclose(s, 1.0, atol=1e-3)


# -------------------------------------------- training-step integration


@pytest.mark.slow
def test_train_step_with_perceptual_term():
    """make_controlnet_train_step with the OCR perceptual term: grads flow
    through decode -> crop -> judge -> CTC and the loss includes the term."""
    import optax

    from reptext.configs import ControlNetConfig, FluxConfig
    from reptext.eval.ocr import CHAR_TO_ID, MAX_LABEL, OCRJudge, load_judge
    from reptext.models import FluxTransformer2D, RepTextControlNet
    from reptext.ops.latents import prepare_latent_image_ids, unpack_latents
    from reptext.sampling.train_controlnet import (
        bind_frozen_base, controlnet_flow_match_loss, make_controlnet_train_step,
    )

    try:
        judge_params = load_judge()
    except FileNotFoundError:
        pytest.skip("no frozen judge weights")

    flux_cfg, cn_cfg = FluxConfig().tiny(), ControlNetConfig().tiny()
    flux, cn = FluxTransformer2D(flux_cfg), RepTextControlNet(cn_cfg)
    b, s_txt, lat_h, lat_w = 2, 4, 8, 8
    s_img = (lat_h // 2) * (lat_w // 2)     # 2x2-packed tokens
    rng = jax.random.PRNGKey(0)
    img_ids = prepare_latent_image_ids(lat_h, lat_w)
    txt_ids = jnp.zeros((s_txt, 3))
    labels = np.zeros((b, MAX_LABEL), np.int32)
    paddings = np.ones((b, MAX_LABEL), np.float32)
    ids = [CHAR_TO_ID[c] for c in "HI"]
    for i in range(b):
        labels[i, : len(ids)] = ids
        paddings[i, : len(ids)] = 0.0
    batch = {
        "x0": jax.random.normal(rng, (b, s_img, flux_cfg.in_channels)),
        "cond_tokens": jax.random.normal(
            rng, (b, s_img, cn_cfg.in_channels + cn_cfg.extra_condition_channels)),
        "token_mask": jnp.ones((b, s_img, 1)),
        "prompt_embeds": jax.random.normal(rng, (b, s_txt, flux_cfg.joint_attention_dim)),
        "pooled": jax.random.normal(rng, (b, flux_cfg.pooled_projection_dim)),
        "img_ids": img_ids, "txt_ids": txt_ids,
        "guidance": jnp.full((b,), 3.5),
        "ocr_boxes": jnp.tile(jnp.asarray([[0.0, 0.0, 1.0, 1.0]]), (b, 1)),
        "ocr_labels": jnp.asarray(labels),
        "ocr_paddings": jnp.asarray(paddings),
    }
    t0 = jnp.zeros((b,))
    flux_params = flux.init(rng, batch["x0"], batch["prompt_embeds"],
                            batch["pooled"], t0, img_ids, txt_ids, batch["guidance"])
    cn_params = cn.init(rng, batch["x0"], batch["cond_tokens"],
                        batch["prompt_embeds"], batch["pooled"], t0,
                        img_ids, txt_ids, batch["guidance"])

    def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return flux.apply(p, x, ctx, pooled, t, iid, tid, g,
                          controlnet_block_samples=br,
                          controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, t, iid, tid, g, scale):
        return cn.apply(p, x, cnd, ctx, pooled, t, iid, tid, g,
                        conditioning_scale=scale)

    # cheap differentiable stand-in for the VAE decoder: unpack + widen
    def decode_apply(vae_params, x0_packed):
        lat = unpack_latents(x0_packed, lat_h, lat_w)          # [B, C, h, w]
        img = jnp.repeat(jnp.repeat(lat[:, :3], 8, axis=2), 8, axis=3)
        return img.transpose(0, 2, 3, 1)                       # [B, H, W, 3]

    perceptual = {"decode_apply": decode_apply, "judge_apply": OCRJudge().apply,
                  "weight": 0.3}

    rng_step = jax.random.PRNGKey(42)
    base = controlnet_flow_match_loss(
        flux_apply, cn_apply, cn_params, flux_params, batch, rng_step)
    with_term = controlnet_flow_match_loss(
        flux_apply, cn_apply, cn_params, flux_params, batch, rng_step,
        perceptual=perceptual, vae_params=None, judge_params=judge_params)
    assert float(with_term) > float(base)      # CTC on noise is positive

    optimizer = optax.sgd(1e-3)
    step = jax.jit(make_controlnet_train_step(
        flux_apply, cn_apply, optimizer, perceptual=perceptual))
    bound = bind_frozen_base(step, flux_params, None, judge_params)
    new_params, _, loss = bound(cn_params, optimizer.init(cn_params),
                                batch, rng_step)
    assert np.isfinite(float(loss))
    # gradient reached the ControlNet through the perceptual path too
    changed = jax.tree_util.tree_map(
        lambda a, c: bool(jnp.any(a != c)), cn_params, new_params)
    assert any(jax.tree_util.tree_leaves(changed))
