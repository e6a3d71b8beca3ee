"""Record every model's parameter tree (path -> shape, dtype) at tiny config.

The fixture pins the checkpoint layout: weight conversion (io/convert.py),
checkpoints, LoRA merging, fp8 storage and the tensor-parallel rules all
address parameters by these paths. ``tests/test_module.py`` holds the module
layer to it. Regenerate only for a deliberate layout change:

    JAX_PLATFORMS=cpu python tests/record_param_trees.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "param_trees.json")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = [list(v.shape), str(v.dtype)]
    return out


def model_cases():
    """name -> (module, init args) at tiny geometry."""
    from reptext.configs import (
        CLIPConfig, CLIPVisionConfig, ControlNetConfig, FluxConfig,
        IPAdapterConfig, T5Config, VAEConfig)
    from reptext.eval.ocr import OCRJudge
    from reptext.models import FluxTransformer2D, RepTextControlNet
    from reptext.models.ip_adapter import ImageProjection
    from reptext.nn.clip import CLIPTextEncoder
    from reptext.nn.clip_vision import CLIPVisionEncoder
    from reptext.nn.t5 import T5Encoder
    from reptext.nn.vae import AutoencoderKL

    fc, cc = FluxConfig().tiny(), ControlNetConfig().tiny()
    s_img, s_txt = 4, 3
    img_ids, txt_ids = jnp.zeros((s_img, 3)), jnp.zeros((s_txt, 3))
    one = jnp.ones((1,))
    flux_args = (jnp.zeros((1, s_img, fc.in_channels)),
                 jnp.zeros((1, s_txt, fc.joint_attention_dim)),
                 jnp.zeros((1, fc.pooled_projection_dim)), one, img_ids,
                 txt_ids, one)

    def cn_args(cfg):
        return (jnp.zeros((1, s_img, cfg.in_channels)),
                jnp.zeros((1, s_img, cfg.in_channels
                           + cfg.extra_condition_channels)),
                jnp.zeros((1, s_txt, cfg.joint_attention_dim)),
                jnp.zeros((1, cfg.pooled_projection_dim)), one, img_ids,
                txt_ids, one)

    union = dataclasses.replace(cc, num_mode=3)
    inpaint = dataclasses.replace(cc, extra_condition_channels=4)
    vc, ic = CLIPVisionConfig().tiny(), IPAdapterConfig().tiny()
    ip_tokens = jnp.zeros((1, ic.num_tokens, fc.joint_attention_dim))
    return {
        "flux": (FluxTransformer2D(fc), flux_args, {}),
        "flux_bf16": (FluxTransformer2D(fc, param_dtype=jnp.bfloat16),
                      flux_args, {}),
        "flux_ip_adapter": (FluxTransformer2D(fc, ip_adapter=True), flux_args,
                            {"ip_tokens": ip_tokens}),
        "controlnet": (RepTextControlNet(cc), cn_args(cc), {}),
        "controlnet_union": (RepTextControlNet(union), cn_args(union),
                             {"mode": jnp.zeros((1,), jnp.int32)}),
        "controlnet_inpaint": (RepTextControlNet(inpaint), cn_args(inpaint),
                               {}),
        "vae": (AutoencoderKL(VAEConfig().tiny()),
                (jnp.zeros((1, 16, 16, 3)),), {}),
        "clip": (CLIPTextEncoder(CLIPConfig().tiny()),
                 (jnp.zeros((1, 16), jnp.int32),), {}),
        "t5": (T5Encoder(T5Config().tiny()), (jnp.zeros((1, 8), jnp.int32),),
               {}),
        "clip_vision": (CLIPVisionEncoder(vc),
                        (jnp.zeros((1, vc.image_size, vc.image_size, 3)),), {}),
        "ip_projection": (ImageProjection(ic),
                          (jnp.zeros((1, ic.image_embed_dim)),), {}),
        "ocr_judge": (OCRJudge(), (jnp.zeros((1, 48, 256, 1)),), {}),
    }


def param_trees():
    out = {}
    for name, (model, args, kwargs) in model_cases().items():
        shapes = jax.eval_shape(
            lambda a, kw, m=model: m.init(jax.random.PRNGKey(0), *a, **kw),
            args, kwargs)
        out[name] = _flat(shapes)
    return out


if __name__ == "__main__":
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(param_trees(), f, indent=1, sort_keys=True)
    print(f"wrote {FIXTURE}")
