"""Text-inpainting example — the `infer_inpaint.py` driver equivalent.

Mirrors the reference inpaint flow (RepText/infer_inpaint.py:54-155): take an
input photo + a region mask, render replacement text into the masked region
with the RepText ControlNet while the alimama-style inpaint ControlNet keeps
the rest of the photo intact, under true CFG with the default negative prompt.

Run (demo mode, random weights, synthetic photo):
    python examples/inpaint.py
With converted real weights:
    python -m reptext.cli --mode inpaint --checkpoint-dir CKPT \
        --image photo.png --mask mask.png --text "مرحبا" --position 100,200
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from PIL import Image, ImageDraw

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.conditioning import TextLine, build_conditions
from reptext.pipelines import DEFAULT_NEGATIVE_PROMPT, FluxRepTextInpaintPipeline
from reptext.utils.image import resize_to_multiple


def build_inpaint_pipeline(size: int = 256, steps: int = 4,
                           tiny: bool = True) -> FluxRepTextInpaintPipeline:
    mk = (lambda c: c.tiny()) if tiny else (lambda c: c)
    return FluxRepTextInpaintPipeline.create_inpaint(
        # inpaint CN conditioning: 16ch masked-image latent + 1ch mask -> 68
        # packed features/token at full config (4 at tiny VAE width); see
        # RepText/pipeline_flux_controlnet_inpaint.py:796-826
        inpaint_cn_cfg=dataclasses.replace(
            mk(ControlNetConfig()), extra_condition_channels=4,
        ),
        flux_cfg=mk(FluxConfig()), cn_cfg=mk(ControlNetConfig()),
        vae_cfg=mk(VAEConfig()),
        pipe_cfg=PipelineConfig(height=size, width=size,
                                num_inference_steps=steps,
                                controlnet_conditioning_step=steps),
        clip_cfg=mk(CLIPConfig()), t5_cfg=mk(T5Config()),
    )


def inpaint_text(
    pipe: FluxRepTextInpaintPipeline,
    image: np.ndarray,          # [H, W, 3] uint8 photo
    mask: np.ndarray,           # [H, W] uint8, 255 = region to replace
    text: str,
    prompt: str,
    position=(60, 100),
    font_size: int = 48,
    seed: int = 42,
    negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
) -> np.ndarray:
    h, w = pipe.pipe_cfg.height, pipe.pipe_cfg.width
    image = np.asarray(Image.fromarray(image).resize((w, h)), np.uint8)
    mask = np.asarray(Image.fromarray(mask).resize((w, h)), np.uint8)
    conds = build_conditions(
        [TextLine(text, position, font_size=font_size)], w, h
    )
    from reptext.cli import _tokenize
    from reptext.text import pad_to_common_length

    clip_ids, t5_ids = _tokenize(f"{prompt}, '{text}'",
                                 pipe.clip.config, pipe.t5.config, None)
    neg_clip, neg_t5 = _tokenize(negative_prompt,
                                 pipe.clip.config, pipe.t5.config, None)
    t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
    clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
    return pipe(
        conds, image=image, mask=mask,
        clip_ids=clip_ids, t5_ids=t5_ids,
        negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
        seed=seed,
    )[0]


def _synthetic_photo(size: int) -> tuple[np.ndarray, np.ndarray]:
    """A gradient 'photo' with a board, and a mask over the board."""
    img = Image.new("RGB", (size, size))
    d = ImageDraw.Draw(img)
    for y in range(size):
        d.line([(0, y), (size, y)], fill=(40 + y // 3, 70 + y // 4, 110))
    board = (size // 5, size // 3, 4 * size // 5, 2 * size // 3)
    d.rectangle(board, fill=(200, 195, 180))
    mask = Image.new("L", (size, size), 0)
    ImageDraw.Draw(mask).rectangle(board, fill=255)
    return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)


if __name__ == "__main__":
    size = 256
    # the reference driver rounds dims to x64 multiples (infer_inpaint.py:25-46)
    photo, mask = _synthetic_photo(size)
    photo = resize_to_multiple(photo, 64, max_side=size, min_side=64)
    mask = resize_to_multiple(mask, 64, max_side=size, min_side=64)
    pipe = build_inpaint_pipeline(size=size, steps=4, tiny=True)
    img = inpaint_text(
        pipe, photo, mask, "مرحبا", "a wooden sign in a park",
        position=(size // 4, int(size * 0.42)),
    )
    out = Path("results"); out.mkdir(exist_ok=True)
    Image.fromarray(img).save(out / "example_inpaint.png")
    print(f"saved {out / 'example_inpaint.png'} ({img.shape})")
