"""RepText inpainting pipeline: dual ControlNet + true CFG.

Mirrors the reference inpaint pipeline surface
(RepText/pipeline_flux_controlnet_inpaint.py:844-1313): edits text into an
existing image using the RepText ControlNet (glyph conditions, step-gated,
regionally masked) plus an inpainting ControlNet (masked-image + mask
conditioning, every step) with true classifier-free guidance over a negative
prompt. Key reference semantics preserved:

- masked image: pixels under the mask set to -1 before VAE encode (:797-798);
- inpaint conditioning: 16ch masked-image latent concat (1 - mask) nearest-
  resized to the latent grid -> 17ch -> packed 68 features/token (:806-816);
- default negative prompt (:416), CFG embeds [neg; pos], step-0 zero velocity
  (:1264-1270) — see sampling/sampler_inpaint.py;
- glyph-latent init ACTIVE (:635-649) — default in PipelineConfig.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import ControlNetConfig, PipelineConfig
from reptext.conditioning.glyph import Conditions
from reptext.models import RepTextControlNet
from reptext.ops.latents import pack_latents, prepare_latent_image_ids
from reptext.pipelines.outputs import FluxPipelineOutput, to_pil_images
from reptext.pipelines.txt2img import (
    INIT_LATENT_GRID,
    INIT_TEXT_TOKENS,
    FluxRepTextPipeline,
    _normalize_custom_schedule,
)
from reptext.sampling.flow_match import build_schedule
from reptext.sampling.sampler_inpaint import make_inpaint_sampler
from reptext.utils import compiler
from reptext.utils.image import postprocess_images, preprocess_images

DEFAULT_NEGATIVE_PROMPT = (
    "bad quality, worst quality, text, signature, watermark, extra words"
)


def default_inpaint_controlnet_config() -> ControlNetConfig:
    """Geometry of the FLUX inpainting ControlNet (alimama-beta style):
    17-channel conditioning -> 68 packed features = in_channels + 4 extra."""
    return dataclasses.replace(ControlNetConfig(), extra_condition_channels=4)


@dataclasses.dataclass
class FluxRepTextInpaintPipeline(FluxRepTextPipeline):
    """Text inpainting with RepText + inpaint ControlNets."""

    inpaint_controlnet: Optional[RepTextControlNet] = None
    inpaint_conditioning_scale: float = 1.0

    @classmethod
    def create_inpaint(
        cls,
        inpaint_cn_cfg: Optional[ControlNetConfig] = None,
        **kwargs,
    ) -> "FluxRepTextInpaintPipeline":
        """Build on top of FluxRepTextPipeline.create; adds the inpaint net."""
        base = FluxRepTextPipeline.create(**kwargs)
        icfg = inpaint_cn_cfg or default_inpaint_controlnet_config()
        inpaint_cn = RepTextControlNet(
            icfg, attention_backend=base.controlnet.attention_backend,
            dtype=base.compute_dtype, param_dtype=base.controlnet.param_dtype,
        )
        params = dict(base.params)
        if "inpaint_controlnet" not in params:
            img_ids = prepare_latent_image_ids(*INIT_LATENT_GRID)
            s_img, s_txt = img_ids.shape[0], INIT_TEXT_TOKENS
            params["inpaint_controlnet"] = inpaint_cn.init(
                jax.random.PRNGKey(7),
                jnp.zeros((1, s_img, icfg.in_channels)),
                jnp.zeros((1, s_img, icfg.in_channels + icfg.extra_condition_channels)),
                jnp.zeros((1, s_txt, icfg.joint_attention_dim)),
                jnp.zeros((1, icfg.pooled_projection_dim)),
                jnp.zeros((1,)),
                img_ids, jnp.zeros((s_txt, 3)),
                jnp.ones((1,)) if icfg.guidance_embeds else None,
            )
        return cls(
            flux=base.flux, controlnet=base.controlnet, vae=base.vae,
            params=params, pipe_cfg=base.pipe_cfg, clip=base.clip, t5=base.t5,
            compute_dtype=base.compute_dtype, inpaint_controlnet=inpaint_cn,
        )

    # ------------------------------------------------------------- cond prep

    def prepare_inpaint_cond(
        self, image: np.ndarray, mask: np.ndarray, rng: jax.Array
    ) -> jax.Array:
        """(image uint8 [H,W,3], mask uint8/float [H,W]) -> packed [1, S, 68].

        Reference: prepare_image_with_mask
        (RepText/pipeline_flux_controlnet_inpaint.py:761-826).
        """
        cfg = self.pipe_cfg
        img = preprocess_images(image)                     # [1, H, W, 3] in [-1,1]
        m = np.asarray(mask, np.float32)
        if m.max() > 1.0:
            m = m / 255.0
        m = (m > 0.5).astype(np.float32)                   # binarize (mask_processor)
        masked = np.where(m[None, :, :, None] > 0.5, -1.0, img)

        lat = self._encode_scaled(jnp.asarray(masked), rng)  # [1, h, w, 16] NHWC
        # nearest-resize mask to the latent grid, invert (reference :806-809)
        mlat = jax.image.resize(
            jnp.asarray(m), (cfg.latent_height, cfg.latent_width), "nearest"
        )
        mlat = 1.0 - mlat
        cond = jnp.concatenate(
            [lat, jnp.broadcast_to(mlat[None, :, :, None], lat.shape[:3] + (1,))],
            axis=-1,
        )  # [1, h, w, 17]
        return pack_latents(cond.transpose(0, 3, 1, 2))

    # ----------------------------------------------------------------- call

    def __call__(  # type: ignore[override]
        self,
        conditions: Conditions,
        image: np.ndarray = None,
        mask: np.ndarray = None,
        prompt_embeds: Optional[jax.Array] = None,
        pooled_embeds: Optional[jax.Array] = None,
        negative_prompt_embeds: Optional[jax.Array] = None,
        negative_pooled_embeds: Optional[jax.Array] = None,
        clip_ids: Optional[jax.Array] = None,
        t5_ids: Optional[jax.Array] = None,
        negative_clip_ids: Optional[jax.Array] = None,
        negative_t5_ids: Optional[jax.Array] = None,
        seed: int = 42,
        num_images: int = 1,
        guidance_scale: Optional[float] = None,
        true_guidance_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        output_type: str = "np",
        latents: Optional[jax.Array] = None,
        timesteps=None,
        sigmas=None,
        return_dict: bool = False,
    ) -> np.ndarray:
        if image is None or mask is None:
            raise ValueError("inpaint pipeline requires `image` and `mask`")
        cfg = self.pipe_cfg
        steps = num_inference_steps or cfg.num_inference_steps
        custom_schedule = _normalize_custom_schedule(timesteps, sigmas)
        if custom_schedule is not None:
            # caller schedule override (reference retrieve_timesteps routing,
            # RepText/pipeline_flux_controlnet_inpaint.py:1074-1081)
            steps = len(custom_schedule[1])
        gscale = guidance_scale if guidance_scale is not None else cfg.guidance_scale
        tscale = (
            true_guidance_scale if true_guidance_scale is not None
            else cfg.true_guidance_scale
        )

        if prompt_embeds is None:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        if negative_prompt_embeds is None:
            if negative_clip_ids is None:
                raise ValueError(
                    "provide negative embeddings or negative token ids "
                    f"(reference default negative prompt: {DEFAULT_NEGATIVE_PROMPT!r})"
                )
            negative_prompt_embeds, negative_pooled_embeds = self.encode_prompt(
                negative_clip_ids, negative_t5_ids
            )
        if num_images > 1 and prompt_embeds.shape[0] == 1:
            # one prompt, several images: tile BOTH halves of the CFG pair to
            # the image batch (reference num_images_per_prompt,
            # RepText/pipeline_flux_controlnet_inpaint.py:373-377) so the
            # concat below yields [neg*N; pos*N] matching latents batch N
            prompt_embeds = jnp.repeat(prompt_embeds, num_images, axis=0)
            pooled_embeds = jnp.repeat(pooled_embeds, num_images, axis=0)
            negative_prompt_embeds = jnp.repeat(
                negative_prompt_embeds, num_images, axis=0)
            negative_pooled_embeds = jnp.repeat(
                negative_pooled_embeds, num_images, axis=0)

        ctx_cfg = jnp.concatenate([negative_prompt_embeds, prompt_embeds], axis=0)
        pooled_cfg = jnp.concatenate([negative_pooled_embeds, pooled_embeds], axis=0)

        rng = jax.random.PRNGKey(seed)
        r_lat, r_cond, r_glyph, r_inp = jax.random.split(rng, 4)
        cond_tokens, token_masks = self.prepare_control_tokens(conditions, r_cond)
        inpaint_cond = self.prepare_inpaint_cond(image, mask, r_inp)
        if num_images > 1:
            # one source image edited N ways: the 68-feat inpaint conditioning
            # rides the batch axis like the reference's conds ×batch repeat
            # (RepText/pipeline_flux_controlnet_inpaint.py:823-824)
            inpaint_cond = jnp.tile(inpaint_cond, (num_images, 1, 1))
        if latents is None:
            # pre-made packed noise (reference `latents` kwarg,
            # RepText/pipeline_flux_controlnet_inpaint.py:891) overrides
            # seed-derived noise — reproducible across frameworks
            latents = self.prepare_latents(
                r_lat, num_images, conditions.glyph_canvas, r_glyph)
        else:
            expect = (num_images, cfg.image_seq_len,
                      4 * self.vae.config.latent_channels)
            if tuple(latents.shape) != expect:
                raise ValueError(
                    f"latents must be PACKED noise of shape {expect} "
                    f"(= [num_images, (H/16)*(W/16), 4*latent_channels] for "
                    f"{cfg.height}x{cfg.width}); got {tuple(latents.shape)}. "
                    "Use reptext.ops.latents.pack_latents on "
                    "[B, C, H/8, W/8] latents."
                )
            latents = jnp.asarray(latents, jnp.float32)

        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width)
        txt_ids = jnp.zeros((prompt_embeds.shape[1], 3))
        guidance = (
            jnp.full((num_images,), gscale, jnp.float32)
            if self.flux.config.guidance_embeds else None
        )

        sampler = self._get_inpaint_sampler(steps, tscale, custom_schedule)
        latents = self._run_sampler(
            sampler, self.params["flux"], self.params["controlnet"],
            self.params["inpaint_controlnet"], latents,
            cond_tokens, token_masks, inpaint_cond,
            ctx_cfg, pooled_cfg, txt_ids, img_ids, guidance,
        )

        if output_type == "latent":
            return FluxPipelineOutput(images=latents) if return_dict else latents
        images = postprocess_images(self._decode(latents))
        if output_type == "pil":
            images = to_pil_images(images)
        return FluxPipelineOutput(images=images) if return_dict else images

    # ------------------------------------------------------- batched serving

    def generate_batch(
        self,
        conditions_list,
        images,                          # list of uint8 [H, W, 3]
        masks,                           # list of uint8/float [H, W]
        clip_ids: jax.Array,             # [B, 77]
        t5_ids: jax.Array,               # [B, S_txt]
        negative_clip_ids: jax.Array,    # [B, 77]
        negative_t5_ids: jax.Array,      # [B, S_txt]
        seeds,
        guidance_scale: Optional[float] = None,
        true_guidance_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        output_type: str = "np",
    ) -> np.ndarray:
        """B independent inpaint requests in ONE fused dual-CN CFG sampler
        call (serving's coalescing path — txt2img's generate_batch extended
        to text editing; the reference serves nothing and batches only
        num_images_per_prompt copies of one request,
        RepText/pipeline_flux_controlnet_inpaint.py:373-377). All requests
        must share num_lines, steps, and the true-CFG scale (the coalescing
        signature)."""
        cfg = self.pipe_cfg
        n_lines = {c.num_lines for c in conditions_list}
        if len(n_lines) != 1:
            raise ValueError(f"batch requests must share num_lines, got {n_lines}")
        b = len(conditions_list)
        if not (b == len(images) == len(masks) == len(seeds)
                == clip_ids.shape[0] == t5_ids.shape[0]):
            raise ValueError("batch inputs have mismatched lengths")
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = guidance_scale if guidance_scale is not None else cfg.guidance_scale
        tscale = (true_guidance_scale if true_guidance_scale is not None
                  else cfg.true_guidance_scale)

        prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        neg_embeds, neg_pooled = self.encode_prompt(
            negative_clip_ids, negative_t5_ids)
        ctx_cfg = jnp.concatenate([neg_embeds, prompt_embeds], axis=0)
        pooled_cfg = jnp.concatenate([neg_pooled, pooled_embeds], axis=0)

        cond_l, mask_l, lat_l, inp_l = [], [], [], []
        for conds, image, mask, seed in zip(conditions_list, images, masks, seeds):
            rng = jax.random.PRNGKey(int(seed))
            r_lat, r_cond, r_glyph, r_inp = jax.random.split(rng, 4)
            ct, tm = self.prepare_control_tokens(conds, r_cond)
            cond_l.append(ct)
            mask_l.append(tm)
            inp_l.append(self.prepare_inpaint_cond(image, mask, r_inp))
            lat_l.append(self.prepare_latents(r_lat, 1, conds.glyph_canvas, r_glyph))
        cond_tokens = jnp.stack(cond_l, axis=1)    # [N, B, S, F]
        token_masks = jnp.stack(mask_l, axis=1)    # [N, B, S, 1]
        inpaint_cond = jnp.concatenate(inp_l, axis=0)  # [B, S, 68]
        latents = jnp.concatenate(lat_l, axis=0)   # [B, S, C]

        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width)
        txt_ids = jnp.zeros((prompt_embeds.shape[1], 3))
        guidance = (
            jnp.full((b,), gscale, jnp.float32)
            if self.flux.config.guidance_embeds else None
        )
        sampler = self._get_inpaint_sampler(steps, tscale)
        latents = self._run_sampler(
            sampler, self.params["flux"], self.params["controlnet"],
            self.params["inpaint_controlnet"], latents,
            cond_tokens, token_masks, inpaint_cond,
            ctx_cfg, pooled_cfg, txt_ids, img_ids, guidance,
        )
        if output_type == "latent":
            return latents
        return postprocess_images(self._decode(latents))

    def _get_inpaint_sampler(self, steps: int, true_scale: float,
                             custom_schedule=None):
        key = ("inpaint", steps, true_scale, custom_schedule)
        if not hasattr(self, "_samplers"):
            self._samplers = {}
        if key not in self._samplers:
            cfg = dataclasses.replace(self.pipe_cfg, true_guidance_scale=true_scale)
            sched_kw = {}
            if custom_schedule is not None:
                sched_kw[custom_schedule[0]] = list(custom_schedule[1])
            schedule = build_schedule(
                steps, cfg.image_seq_len, cfg.base_image_seq_len,
                cfg.max_image_seq_len, cfg.base_shift, cfg.max_shift,
                cfg.use_dynamic_shifting, **sched_kw,
            )

            def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
                return self.flux.apply(
                    p, x, ctx, pooled, t, iid, tid, g,
                    controlnet_block_samples=br,
                    controlnet_single_block_samples=sr,
                )

            def rt_apply(p, x, cond, ctx, pooled, t, iid, tid, g, scale):
                kw = {}
                if self.controlnet.config.union:
                    # (reference: RepText/pipeline_flux_controlnet.py:763,1046)
                    if cfg.control_mode is None:
                        raise ValueError(
                            "union-mode ControlNet loaded; set "
                            "PipelineConfig.control_mode (CLI: --controlnet-mode)"
                        )
                    kw["mode"] = jnp.full((x.shape[0],), cfg.control_mode, jnp.int32)
                return self.controlnet.apply(
                    p, x, cond, ctx, pooled, t, iid, tid, g,
                    conditioning_scale=scale, **kw,
                )

            def inp_apply(p, x, cond, ctx, pooled, t, iid, tid, g, scale):
                return self.inpaint_controlnet.apply(
                    p, x, cond, ctx, pooled, t, iid, tid, g,
                    conditioning_scale=scale,
                )

            if getattr(self, "sp_mesh", None) is not None:
                from reptext.sampling.sampler_inpaint import (
                    make_sp_inpaint_sampler,
                )

                sample = make_sp_inpaint_sampler(
                    flux_apply, rt_apply, inp_apply, schedule, cfg,
                    self.flux.config.num_layers,
                    self.flux.config.num_single_layers,
                    self.sp_mesh, self.inpaint_conditioning_scale,
                    self.sp_axis, self.compute_dtype,
                )
            else:
                sample = make_inpaint_sampler(
                    flux_apply, rt_apply, inp_apply, schedule, cfg,
                    self.flux.config.num_layers,
                    self.flux.config.num_single_layers,
                    self.inpaint_conditioning_scale, self.compute_dtype,
                )
            self._samplers[key] = compiler.jit(sample)
        return self._samplers[key]

    def shard_for_sp(self, mesh=None, axis_name: str = "sp",
                     backend: str = "ring") -> "FluxRepTextInpaintPipeline":
        """Sequence-parallel text editing: same as the txt2img pipeline's
        mode (tokens sharded, params replicated), extended to the dual-
        ControlNet true-CFG scan (make_sp_inpaint_sampler). The inpaint
        ControlNet is rebuilt with the SP attention backend alongside the
        base transformer and RepText net."""
        super().shard_for_sp(mesh, axis_name, backend=backend)
        self.inpaint_controlnet = self.inpaint_controlnet.clone(
            attention_backend=backend)
        return self
