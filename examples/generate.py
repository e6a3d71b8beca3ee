"""One-call generation example — the notebook `predict()` equivalent.

The reference ships a Colab notebook whose cell 10 defines
``predict(text, prompt)`` over a pre-built pipeline (SURVEY.md §3.5; the
committed cell is broken — indentation + undefined `font`). This is the
maintained equivalent: build the pipeline once, call ``predict`` many times.

Run (demo mode, random weights):
    python examples/generate.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np
from PIL import Image

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.conditioning import TextLine, build_conditions
from reptext.pipelines import FluxRepTextPipeline


def build_pipeline(size: int = 512, steps: int = 20, tiny: bool = True,
                   checkpoint_dir: str | None = None) -> FluxRepTextPipeline:
    pipe_cfg = PipelineConfig(
        height=size, width=size, num_inference_steps=steps,
        controlnet_conditioning_step=steps,
    )
    mk = (lambda c: c.tiny()) if tiny else (lambda c: c)
    params = None
    if checkpoint_dir:
        from reptext.io.checkpoint import load_pipeline_params
        params = load_pipeline_params(checkpoint_dir)
    return FluxRepTextPipeline.create(
        flux_cfg=mk(FluxConfig()), cn_cfg=mk(ControlNetConfig()),
        vae_cfg=mk(VAEConfig()), pipe_cfg=pipe_cfg, params=params,
        clip_cfg=mk(CLIPConfig()), t5_cfg=mk(T5Config()),
        compute_dtype=jnp.float32 if tiny else jnp.bfloat16,
        param_dtype=jnp.float32 if tiny else jnp.bfloat16,
    )


def predict(
    pipe: FluxRepTextPipeline,
    text: str,
    prompt: str,
    position=(100, 200),
    font_size: int = 60,
    seed: int = 42,
) -> np.ndarray:
    """Render `text` into a generated image described by `prompt`."""
    size = pipe.pipe_cfg.width
    conds = build_conditions(
        [TextLine(text, position, font_size=font_size)], size, size
    )
    # demo tokenization (hash ids); with a checkpoint dir, use the CLI which
    # loads the real tokenizers
    from reptext.cli import _tokenize
    clip_cfg = pipe.clip.config
    t5_cfg = pipe.t5.config
    clip_ids, t5_ids = _tokenize(f"{prompt}, '{text}'", clip_cfg, t5_cfg, None)
    return pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=seed)[0]


if __name__ == "__main__":
    pipe = build_pipeline(size=256, steps=4, tiny=True)
    img = predict(pipe, "مرحبا", "a neon sign on a night street", position=(60, 100))
    out = Path("results"); out.mkdir(exist_ok=True)
    Image.fromarray(img).save(out / "example.png")
    print(f"saved {out / 'example.png'} ({img.shape})")
