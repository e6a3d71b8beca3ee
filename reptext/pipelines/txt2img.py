"""RepText text-to-image pipeline (FLUX + ControlNet).

Mirrors the reference ``FluxControlNetPipeline.__call__`` surface
(RepText/pipeline_flux_controlnet.py:749-1148): canny/position/region-mask
conditioning per text line, glyph canvas for latent init, embedded guidance,
FlowMatch Euler loop with step-gated, regionally-masked ControlNet residual
injection. Structural differences (same semantics):

- prompt encoding, condition VAE-encoding, the full denoise loop, and the
  final decode are each ONE jitted XLA computation; the loop itself is a
  lax.scan (see reptext.sampling.sampler);
- text lines are batched through the ControlNet, not Python-looped;
- the glyph-latent init blend is applied when `PipelineConfig.glyph_latent_init`
  (the reference txt2img computes-but-drops it — upstream bug, SURVEY.md §2.1;
  the inpaint pipeline applies it at pipeline_flux_controlnet_inpaint.py:647);
- randomness comes from explicit jax PRNG keys (`seed`), replacing
  torch.Generator.

Weights come from `reptext.io.convert` (HF safetensors) or random init for
smoke tests.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import (
    CLIPConfig,
    ControlNetConfig,
    FluxConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
)
from reptext.conditioning.glyph import Conditions
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.nn.clip import CLIPTextEncoder
from reptext.nn.t5 import T5Encoder
from reptext.nn.vae import AutoencoderKL
from reptext.ops.latents import (
    downsample_region_mask,
    pack_latents,
    prepare_latent_image_ids,
    unpack_latents,
)
from reptext.pipelines.outputs import FluxPipelineOutput, to_pil_images
from reptext.sampling.flow_match import build_schedule
from reptext.sampling.sampler import make_txt2img_sampler
from reptext.utils import compiler
from reptext.utils.image import postprocess_images, preprocess_images
from reptext.utils.metrics import default_metrics


# Token counts the random-weight inits trace with (any length gives the same
# parameter shapes): 8 text tokens and an 8x8 latent grid (16 image tokens).
INIT_TEXT_TOKENS = 8
INIT_LATENT_GRID = (8, 8)


def _normalize_custom_schedule(timesteps, sigmas):
    """Caller timesteps/sigmas -> hashable ("timesteps"|"sigmas", tuple) key
    (or None). Mutual exclusivity is re-checked in build_schedule."""
    if timesteps is None and sigmas is None:
        return None
    if timesteps is not None and sigmas is not None:
        raise ValueError(
            "Only one of `timesteps` or `sigmas` can be passed. "
            "Please choose one to set custom values"
        )
    if timesteps is not None:
        return ("timesteps", tuple(float(t) for t in np.asarray(timesteps).ravel()))
    return ("sigmas", tuple(float(s) for s in np.asarray(sigmas).ravel()))


@dataclasses.dataclass
class FluxRepTextPipeline:
    """Holds models + params and exposes the generation entry point."""

    flux: FluxTransformer2D
    controlnet: RepTextControlNet
    vae: AutoencoderKL
    params: Dict[str, Any]                      # keys: flux, controlnet, vae[, clip, t5]
    pipe_cfg: PipelineConfig
    clip: Optional[CLIPTextEncoder] = None
    t5: Optional[T5Encoder] = None
    compute_dtype: Any = jnp.float32
    # sequence-parallel state (shard_for_sp) — dataclass FIELDS so
    # with_resolution views (serving resolution buckets) inherit them
    sp_mesh: Any = None
    sp_axis: str = "sp"
    # IP-Adapter image encoder (attach_ip_adapter) — a field for the same
    # reason: image-prompt requests must work on resolution views
    ip_encoder: Any = None
    # tiled VAE (ops/vae_tiling.py): (tile_latent, overlap_latent) or None.
    # A FIELD so resolution views inherit it: serving buckets at any size
    # keep the bounded-activation decode (see enable_vae_tiling)
    vae_tiling: Any = None

    # ---------------------------------------------------------------- build

    @classmethod
    def create(
        cls,
        flux_cfg: FluxConfig,
        cn_cfg: ControlNetConfig,
        vae_cfg: VAEConfig,
        pipe_cfg: PipelineConfig,
        params: Optional[Dict[str, Any]] = None,
        clip_cfg: Optional[CLIPConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        seed: int = 0,
        compute_dtype: Any = jnp.float32,
        param_dtype: Any = jnp.float32,
        attention_backend: Optional[str] = None,
    ) -> "FluxRepTextPipeline":
        """Construct models; if ``params`` is None, random-init from ``seed``
        (smoke tests and random-weight runs at full geometry)."""
        flux = FluxTransformer2D(
            flux_cfg, attention_backend=attention_backend,
            dtype=compute_dtype, param_dtype=param_dtype,
        )
        cn = RepTextControlNet(
            cn_cfg, attention_backend=attention_backend,
            dtype=compute_dtype, param_dtype=param_dtype,
        )
        vae = AutoencoderKL(vae_cfg, dtype=compute_dtype, param_dtype=param_dtype)
        clip = CLIPTextEncoder(clip_cfg, compute_dtype, param_dtype) if clip_cfg else None
        t5 = T5Encoder(t5_cfg, compute_dtype, param_dtype) if t5_cfg else None

        if params is None:
            params = cls._random_init(
                flux, cn, vae, clip, t5, flux_cfg, cn_cfg, vae_cfg,
                pipe_cfg, seed
            )
        return cls(
            flux=flux, controlnet=cn, vae=vae, params=params, pipe_cfg=pipe_cfg,
            clip=clip, t5=t5, compute_dtype=compute_dtype,
        )

    @staticmethod
    def _random_init(flux, cn, vae, clip, t5, flux_cfg, cn_cfg, vae_cfg, pipe_cfg, seed):
        """Every model's params from ``seed``. ``init`` traces each model
        abstractly and runs only the initializers, op by op: compiled once
        per distinct parameter shape, where one jitted program would compile
        a kernel per parameter."""
        rng = jax.random.PRNGKey(seed)
        k_flux, k_cn, k_vae, k_clip, k_t5 = jax.random.split(rng, 5)
        # init-time trace lengths: modules are length-agnostic, so one small
        # probe serves every resolution (and one compiled init program)
        s_txt, img_ids = INIT_TEXT_TOKENS, prepare_latent_image_ids(*INIT_LATENT_GRID)
        s_img = img_ids.shape[0]
        txt_ids = jnp.zeros((s_txt, 3))
        guidance = jnp.ones((1,)) if flux_cfg.guidance_embeds else None

        params: Dict[str, Any] = {}
        params["flux"] = flux.init(
            k_flux,
            jnp.zeros((1, s_img, flux_cfg.in_channels)),
            jnp.zeros((1, s_txt, flux_cfg.joint_attention_dim)),
            jnp.zeros((1, flux_cfg.pooled_projection_dim)),
            jnp.zeros((1,)),
            img_ids, txt_ids, guidance,
        )
        params["controlnet"] = cn.init(
            k_cn,
            jnp.zeros((1, s_img, cn_cfg.in_channels)),
            jnp.zeros((1, s_img, cn_cfg.in_channels + cn_cfg.extra_condition_channels)),
            jnp.zeros((1, s_txt, cn_cfg.joint_attention_dim)),
            jnp.zeros((1, cn_cfg.pooled_projection_dim)),
            jnp.zeros((1,)),
            img_ids, txt_ids,
            jnp.ones((1,)) if cn_cfg.guidance_embeds else None,
        )
        params["vae"] = vae.init(
            k_vae, jnp.zeros((1, 8 * vae_cfg.scale_factor, 8 * vae_cfg.scale_factor, 3))
        )
        if clip is not None:
            params["clip"] = clip.init(
                k_clip, jnp.zeros((1, clip.config.max_position_embeddings), jnp.int32)
            )
        if t5 is not None:
            params["t5"] = t5.init(k_t5, jnp.zeros((1, 16), jnp.int32))
        return params

    # ------------------------------------------------------------ vae tiling

    def enable_vae_tiling(self, tile_latent: int = 72,
                          overlap_latent: int = 16) -> "FluxRepTextPipeline":
        """Run VAE encode/decode in overlapping tiles (ops/vae_tiling.py).

        Caps VAE activation memory at the tile size. `tile_latent`/
        `overlap_latent` are in latent units (x8 in pixels); inputs no larger
        than a tile take the untiled path unchanged. In place; returns self.

        Default 72/16: a 1024^2 image (128^2 latents) maps to 2x2 clamped
        tiles — vs 3x3 at tile 64, i.e. 30% less redundant overlap compute
        and half the per-tile dispatches, at the same 16-latent blend
        overlap (seam tolerance pinned in tests/test_vae_tiling.py).
        """
        if overlap_latent >= tile_latent:
            raise ValueError(
                f"overlap ({overlap_latent}) must be < tile ({tile_latent})")
        self.vae_tiling = (int(tile_latent), int(overlap_latent))
        return self

    # ----------------------------------------------------------- resolutions

    def with_resolution(self, height: int, width: int) -> "FluxRepTextPipeline":
        """A pipeline view at another resolution SHARING this one's params.

        All modules are shape-agnostic (convs + token-length-free attention),
        so only ``pipe_cfg`` changes — no weight duplication; XLA compiles one
        sampler per (resolution, steps) on first use. This is the serving
        resolution-bucket mechanism (the reference fixes resolution in its
        driver, RepText/infer.py:36).
        """
        if height % 16 or width % 16:
            raise ValueError(f"height/width must be x16 (VAE f=8, 2x2 packing), "
                             f"got {height}x{width}")
        if (height, width) == (self.pipe_cfg.height, self.pipe_cfg.width):
            return self
        cfg = dataclasses.replace(self.pipe_cfg, height=height, width=width)
        return dataclasses.replace(self, pipe_cfg=cfg)

    # -------------------------------------------------------------- sharding

    def shard_for_inference(self, mesh=None) -> "FluxRepTextPipeline":
        """Shard transformer/ControlNet params over a (dp, tp) mesh.

        After this, the already-jitted samplers run tensor-parallel: XLA
        propagates the NamedSharding of the param arguments through the whole
        fused sampling graph and inserts the block all-reduces (parallel/
        partition.py rules). VAE/text-encoder params are replicated (small).
        Returns self.
        """
        from reptext.parallel import make_mesh, shard_params

        if mesh is None:
            mesh = make_mesh()
        self.mesh = mesh
        for name in ("flux", "controlnet", "inpaint_controlnet"):
            if name in self.params:
                self.params[name] = shard_params(self.params[name], mesh)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        for name in ("vae", "clip", "t5", "ip_adapter"):
            if name in self.params:
                self.params[name] = jax.device_put(
                    self.params[name], NamedSharding(mesh, P())
                )
        return self

    def shard_for_sp(self, mesh=None, axis_name: str = "sp",
                     backend: str = "ring") -> "FluxRepTextPipeline":
        """Sequence-parallel inference: the fused denoise scan runs under one
        shard_map with the image-token axis sharded over ``axis_name``.

        Rebuilds both models with ``attention_backend='ring'`` (per-block K/V
        ppermute ring is the only communication — parallel/sequence.py) or
        ``'ulysses'`` (all-to-all head swap; needs heads % sp == 0) and
        switches ``_get_sampler`` to ``make_sp_txt2img_sampler``. This is the
        >=2048^2 growth path: tokens scale with resolution^2, so sharding the
        sequence (not the weights) keeps per-chip attention memory flat.
        Params stay replicated. An attached IP-Adapter works under SP (the
        ip tokens are replicated per shard; the decoupled ip attention is
        collective-free), as do callbacks/img2img (chunked shard_map scans).
        Parity scenario: tests/mesh_scenarios.py::check_sp_pipeline.
        Returns self.
        """
        from reptext.parallel import make_sp_mesh

        import jax

        if mesh is None:
            mesh = make_sp_mesh(len(jax.devices()))
        n = mesh.devices.size
        s_img = self.pipe_cfg.image_seq_len
        if s_img % n:
            raise ValueError(
                f"image sequence ({s_img} tokens) must divide the sp axis ({n})"
            )
        if backend not in ("ring", "ulysses"):
            raise ValueError(f"sp backend must be ring|ulysses, got {backend!r}")
        if backend == "ulysses" and self.flux.config.num_attention_heads % n:
            raise ValueError(
                f"ulysses needs heads % sp == 0 "
                f"({self.flux.config.num_attention_heads} % {n})"
            )
        self.sp_mesh, self.sp_axis = mesh, axis_name
        self.flux = self.flux.clone(attention_backend=backend)
        self.controlnet = self.controlnet.clone(attention_backend=backend)
        for attr in ("_samplers", "_raw_samplers", "_chunk_samplers"):
            if hasattr(self, attr):
                delattr(self, attr)
        return self

    # ---------------------------------------------------------- quantization

    def quantize_weights(self) -> "FluxRepTextPipeline":
        """Switch the transformer + ControlNet(s) to fp8 weight-only storage.

        io/quantize.py: block-stack kernels become fp8-e4m3 with per-channel
        scales (half the weight bytes); each scan iteration dequantizes one
        layer slice to bf16, so the matmuls and activations are unchanged.
        VAE/text encoders stay bf16 (small). In place; returns self.
        """
        from reptext.io.quantize import quantize_params

        # new outer dict: pipelines sharing this params dict (resolution
        # views, fidelity A/B runs) must not see the quantized entries
        self.params = dict(self.params)
        for name in ("flux", "controlnet", "inpaint_controlnet"):
            if name in self.params:
                tree = dict(self.params[name])
                tree["params"] = jax.device_put(quantize_params(tree["params"]))
                self.params[name] = tree
        self.flux = self.flux.clone(weight_quant=True)
        self.controlnet = self.controlnet.clone(weight_quant=True)
        if getattr(self, "inpaint_controlnet", None) is not None:
            self.inpaint_controlnet = self.inpaint_controlnet.clone(
                weight_quant=True)
        return self

    # ------------------------------------------------------------ ip-adapter

    def attach_ip_adapter(
        self,
        vision_cfg=None,
        ip_cfg=None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
    ) -> "FluxRepTextPipeline":
        """Enable FLUX IP-Adapter image-prompting on this pipeline.

        Rebuilds ``self.flux`` with per-double-block to_k_ip/to_v_ip
        projections (nn/blocks.py) and installs the CLIP vision encoder +
        ImageProjection (models/ip_adapter.py). ``params`` may carry any of
        {"vision", "proj", "flux"} (from io/convert.py::{convert_clip_vision,
        convert_ip_adapter, merge_ip_adapter_into_flux}); missing pieces are
        random-init — with to_v_ip ZERO-init so an untrained adapter is an
        exact no-op (mirrors ControlNet zero-init semantics).

        Reference surface: RepText/README.md:183 (compatibility with the
        published FLUX.1-dev IP-Adapter via diffusers ``load_ip_adapter``).
        """
        from reptext.configs import CLIPVisionConfig, IPAdapterConfig
        from reptext.models.ip_adapter import IPAdapterEncoder

        if getattr(self.flux, "weight_quant", False):
            # grafting dense adapter kernels into an fp8-quantized block
            # stack would mix storage formats inside one scan collection
            raise ValueError(
                "attach_ip_adapter() must run BEFORE quantize_weights(); "
                "attach first, then quantize (the adapter kernels are then "
                "quantized with the rest of the double-block stack)"
            )
        if vision_cfg is None:
            vision_cfg = CLIPVisionConfig()
        if ip_cfg is None:
            ip_cfg = IPAdapterConfig(
                image_embed_dim=vision_cfg.projection_dim,
                cross_attention_dim=self.flux.config.joint_attention_dim,
            )
        params = params or {}

        self.ip_encoder = IPAdapterEncoder(
            vision_cfg, ip_cfg, self.compute_dtype, self.flux.param_dtype,
        )
        enc_params = self.ip_encoder.init(jax.random.PRNGKey(seed))
        self.params["ip_adapter"] = {
            "vision": params.get("vision", enc_params["vision"]),
            "proj": params.get("proj", enc_params["proj"]),
        }

        flux_ip = FluxTransformer2D(
            self.flux.config, attention_backend=self.flux.attention_backend,
            dtype=self.flux.dtype, param_dtype=self.flux.param_dtype,
            remat=self.flux.remat, ip_adapter=True,
        )
        if "flux" in params:
            self.params["flux"] = params["flux"]
        elif "blocks" in params:
            # converter-CLI layout (io/convert_cli.py): stacked to_k_ip /
            # to_v_ip saved standalone, merged into the RESIDENT flux params
            # here — avoids duplicating the 24 GB transformer on disk
            from reptext.io.convert import merge_ip_adapter_into_flux

            blocks = params["blocks"]
            if "params" in blocks:      # orbax component wraps under params
                blocks = blocks["params"]
            self.params["flux"] = merge_ip_adapter_into_flux(
                self.params["flux"], blocks
            )
        else:
            # graft random to_k_ip + ZERO to_v_ip onto the existing weights
            cfg = self.flux.config
            s_probe = 8
            probe_tokens = jnp.zeros((1, ip_cfg.num_tokens,
                                      ip_cfg.cross_attention_dim))
            # param structure is backend-independent; the SP backends (ring/
            # ulysses) contain collectives and cannot trace outside a
            # shard_map, so probe-init through the xla backend
            init_probe = (
                flux_ip.clone(attention_backend="xla")
                if flux_ip.attention_backend in ("ring", "ulysses")
                else flux_ip
            )
            ip_vars = init_probe.init(
                jax.random.PRNGKey(seed + 1),
                jnp.zeros((1, 4, cfg.in_channels)),
                jnp.zeros((1, s_probe, cfg.joint_attention_dim)),
                jnp.zeros((1, cfg.pooled_projection_dim)),
                jnp.zeros((1,)),
                jnp.zeros((4, 3)), jnp.zeros((s_probe, 3)),
                jnp.ones((1,)) if cfg.guidance_embeds else None,
                ip_tokens=probe_tokens,
            )
            import copy

            merged = copy.deepcopy(self.params["flux"])
            blk = ip_vars["params"]["double_blocks"]["block"]
            merged["params"]["double_blocks"]["block"]["to_k_ip"] = blk["to_k_ip"]
            merged["params"]["double_blocks"]["block"]["to_v_ip"] = (
                jax.tree_util.tree_map(jnp.zeros_like, blk["to_v_ip"])
            )
            self.params["flux"] = merged
        self.flux = flux_ip
        # sampler caches were built against the non-IP flux module
        for attr in ("_samplers", "_raw_samplers", "_chunk_samplers"):
            if hasattr(self, attr):
                delattr(self, attr)
        return self

    def encode_ip_image(self, image: np.ndarray) -> jax.Array:
        """uint8 image -> IP tokens [B, N, cross_dim] via the attached adapter."""
        if getattr(self, "ip_encoder", None) is None:
            raise ValueError("call attach_ip_adapter() first")
        return self.ip_encoder(self.params["ip_adapter"], image)

    # ------------------------------------------------------------- encoders

    def encode_prompt(
        self, clip_ids: jax.Array, t5_ids: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """(clip token ids [B, 77], t5 token ids [B, <=512]) ->
        (prompt_embeds [B, S_txt, 4096], pooled [B, 768]).

        Reference: encode_prompt (RepText/pipeline_flux_controlnet.py:349-456).
        """
        if self.clip is None or self.t5 is None:
            raise ValueError("pipeline built without text encoders; pass embeddings directly")
        if t5_ids.shape[1] > self.pipe_cfg.max_sequence_length:
            raise ValueError(
                f"T5 sequence {t5_ids.shape[1]} exceeds max "
                f"{self.pipe_cfg.max_sequence_length}"
            )
        _, pooled = self._clip_apply(self.params["clip"], clip_ids)
        seq = self._t5_apply(self.params["t5"], t5_ids)
        return seq, pooled

    # -------------------------------------------------------- cond building

    def prepare_control_tokens(
        self, conditions: Conditions, rng: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """Conditions -> (cond_tokens [N, S, 2*4*C], token_masks [N, S, 1]).

        Per line: VAE-encode canny image and 3-channel-replicated position
        mask, scale/shift, channel-concat, 2x2-pack (reference prepare_image,
        RepText/pipeline_flux_controlnet.py:663-731); region mask bilinearly
        downsampled to tokens (reference :1007-1013).
        """
        cfg = self.pipe_cfg
        n = conditions.num_lines
        canny = jnp.asarray(
            preprocess_images(np.stack([lc.canny_image for lc in conditions.lines]))
        )
        pos = np.stack(
            [np.repeat(lc.position_mask[:, :, None], 3, axis=2) for lc in conditions.lines]
        )
        pos = jnp.asarray(preprocess_images(pos))
        # canny + pos ride ONE encode call stacked on the batch axis: same
        # total conv work, half the (tiled) dispatch round-trips
        both = self._encode_scaled(jnp.concatenate([canny, pos], axis=0), rng)
        canny_lat, pos_lat = both[:n], both[n:]             # [N, h, w, C] NHWC
        cond = jnp.concatenate([canny_lat, pos_lat], axis=-1)
        cond_tokens = pack_latents(cond.transpose(0, 3, 1, 2))

        masks = np.stack([lc.region_mask for lc in conditions.lines]).astype(np.float32) / 255.0
        token_masks = jax.vmap(
            lambda m: downsample_region_mask(m, cfg.latent_height, cfg.latent_width)
        )(jnp.asarray(masks))
        return cond_tokens, token_masks

    def prepare_latents(
        self,
        rng: jax.Array,
        batch_size: int,
        glyph_canvas: Optional[np.ndarray] = None,
        glyph_rng: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Initial packed latents [B, S, 4*C]; optional glyph-latent init blend.

        Reference: prepare_latents_reptext
        (RepText/pipeline_flux_controlnet.py:608-660) with the blend actually
        applied when cfg.glyph_latent_init (see module docstring).
        """
        cfg = self.pipe_cfg
        c = self.vae.config.latent_channels
        h, w = cfg.latent_height, cfg.latent_width
        noise = jax.random.normal(rng, (batch_size, c, h, w), jnp.float32)

        if glyph_canvas is not None and cfg.glyph_latent_init:
            img = jnp.asarray(preprocess_images(glyph_canvas))
            glyph_lat = self._encode_scaled(
                img, glyph_rng if glyph_rng is not None else jax.random.PRNGKey(0)
            )
            glyph_lat = jnp.broadcast_to(
                glyph_lat.transpose(0, 3, 1, 2), noise.shape
            )
            ink = (jnp.asarray(glyph_canvas).astype(jnp.float32) > 0).any(axis=-1)
            mask = jax.image.resize(ink.astype(jnp.float32), (h, w), "linear")
            mask = (mask > 0).astype(jnp.float32)[None, None]
            noise = jnp.where(
                mask > 0.5, cfg.glyph_latent_scale * glyph_lat + noise, noise
            )
        return pack_latents(noise)

    # --------------------------------------------------------------- call

    def __call__(
        self,
        conditions: Conditions,
        prompt_embeds: Optional[jax.Array] = None,
        pooled_embeds: Optional[jax.Array] = None,
        clip_ids: Optional[jax.Array] = None,
        t5_ids: Optional[jax.Array] = None,
        seed: int = 42,
        num_images: int = 1,
        guidance_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        init_image: Optional[np.ndarray] = None,
        strength: float = 1.0,
        callback=None,
        callback_steps: int = 1,
        output_type: str = "np",
        ip_adapter_image: Optional[np.ndarray] = None,
        ip_adapter_scale: float = 1.0,
        latents: Optional[jax.Array] = None,
        timesteps=None,
        sigmas=None,
        return_dict: bool = False,
    ) -> np.ndarray:
        """Generate images. Either embeddings or token ids must be provided.

        ``timesteps``/``sigmas`` (mutually exclusive) override the linspace
        schedule (reference ``timesteps`` kwarg routed through
        ``retrieve_timesteps``, RepText/pipeline_flux_controlnet.py:758,91-160;
        semantics documented on :func:`build_schedule`). ``num_inference_steps``
        is then ignored in favor of their length.

        ``output_type``: "np" (uint8 array, this framework's native), "pil"
        (list of PIL images — the reference's public contract,
        RepText/pipeline_flux_controlnet.py:1132-1148), or "latent".
        ``return_dict=True`` wraps the result in :class:`FluxPipelineOutput`.

        ``init_image``/``strength`` give img2img: denoising starts from the
        VAE latent of the image noised to sigma[t0], t0 = steps*(1-strength)
        (the reference carries this as unused `get_timesteps`,
        RepText/pipeline_flux_controlnet.py:474-483; functional here).

        ``callback(step_index, latents) -> bool|None`` runs every
        ``callback_steps`` steps; returning False aborts sampling (the
        reference's cooperative `_interrupt`,
        RepText/pipeline_flux_controlnet.py:1019-1020). Sampling inside each
        chunk stays one fused graph.
        """
        cfg = self.pipe_cfg
        steps = num_inference_steps or cfg.num_inference_steps
        custom_schedule = _normalize_custom_schedule(timesteps, sigmas)
        if custom_schedule is not None:
            steps = len(custom_schedule[1])
        gscale = guidance_scale if guidance_scale is not None else cfg.guidance_scale

        if prompt_embeds is None:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        if num_images > 1 and prompt_embeds.shape[0] == 1:
            # one prompt, several images: tile the text stream to the image
            # batch (reference num_images_per_prompt,
            # RepText/pipeline_flux_controlnet.py:381-385) — the flux scan
            # carries the text stream, so its batch must match the latents
            prompt_embeds = jnp.repeat(prompt_embeds, num_images, axis=0)
            pooled_embeds = jnp.repeat(pooled_embeds, num_images, axis=0)

        rng = jax.random.PRNGKey(seed)
        r_lat, r_cond, r_glyph = jax.random.split(rng, 3)
        cond_tokens, token_masks = self.prepare_control_tokens(conditions, r_cond)

        sampler = self._get_sampler(steps, custom_schedule)
        skey = steps if custom_schedule is None else (steps,) + custom_schedule
        schedule = self._schedules[skey]

        if latents is not None:
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

        t_start = 0
        if init_image is not None and strength < 1.0:
            t_start = min(int(steps * (1.0 - strength)), steps - 1)
            noise = (latents if latents is not None
                     else self.prepare_latents(r_lat, num_images, None, None))
            img = jnp.asarray(preprocess_images(init_image))
            img_lat = self._encode_scaled(img, r_glyph).transpose(0, 3, 1, 2)
            img_packed = pack_latents(jnp.broadcast_to(
                img_lat, (num_images,) + img_lat.shape[1:]))
            sigma0 = float(schedule.sigmas[t_start])
            latents = sigma0 * noise + (1.0 - sigma0) * img_packed
        elif latents is None:
            # `latents` kwarg: pre-made packed noise (reference
            # pipeline_flux_controlnet.py:768) replaces seed-derived noise
            # (and the glyph-latent init, which the caller owns in that case)
            latents = self.prepare_latents(
                r_lat, num_images, conditions.glyph_canvas, r_glyph
            )

        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width)
        txt_ids = jnp.zeros((prompt_embeds.shape[1], 3))
        guidance = (
            jnp.full((num_images,), gscale, jnp.float32)
            if self.flux.config.guidance_embeds else None
        )

        margs = (
            self.params["flux"], self.params["controlnet"],
        )
        sargs = (
            cond_tokens, token_masks, prompt_embeds, pooled_embeds,
            txt_ids, img_ids, guidance,
        )
        flux_extra = None
        if ip_adapter_image is not None:
            if self.flux.ip_adapter is False:
                raise ValueError(
                    "ip_adapter_image given but no adapter attached "
                    "(call attach_ip_adapter() first)"
                )
            flux_extra = {
                "ip_tokens": self.encode_ip_image(ip_adapter_image),
                "ip_scale": jnp.asarray(ip_adapter_scale, jnp.float32),
            }
        elif self.flux.ip_adapter:
            # adapter attached but no image this call: neutral zero tokens
            # with scale 0 keep one compiled graph signature
            ipc = self.ip_encoder.ip_cfg
            flux_extra = {
                "ip_tokens": jnp.zeros(
                    (1, ipc.num_tokens, ipc.cross_attention_dim)),
                "ip_scale": jnp.asarray(0.0, jnp.float32),
            }

        remaining = steps - t_start
        if callback is None:
            if t_start == 0:
                latents = self._run_sampler(
                    sampler, *margs, latents, *sargs, flux_extra=flux_extra)
            else:
                latents = self._get_chunk_sampler(
                    steps, remaining, custom_schedule)(
                    *margs, latents, *sargs, t_start, flux_extra=flux_extra
                )
        else:
            i = t_start
            while i < steps:
                k = min(callback_steps, steps - i)
                latents = self._get_chunk_sampler(steps, k, custom_schedule)(
                    *margs, latents, *sargs, i, flux_extra=flux_extra
                )
                i += k
                if callback(i, latents) is False:
                    break

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
        clip_ids: Optional[jax.Array] = None,   # [B, 77]
        t5_ids: Optional[jax.Array] = None,     # [B, S_txt]
        seeds=None,
        guidance_scale: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        output_type: str = "np",
        ip_adapter_images=None,   # per-request images (None entries allowed)
        ip_adapter_scales=None,   # per-request floats
        prompt_embeds: Optional[jax.Array] = None,  # [B, S_txt, D] pre-encoded
        pooled_embeds: Optional[jax.Array] = None,  # [B, D_pooled]
    ) -> np.ndarray:
        """Generate one image per request in a single fused sampler call.

        Serving's coalescing path: B independent requests — each with its own
        conditions, prompt ids, and seed — ride the batch axis of one compiled
        graph. All requests must share the number of text lines (that, plus
        steps and guidance, is the coalescing signature). The reference has no
        batched serving at all (SURVEY.md §5); its pipeline batches only
        ``num_images_per_prompt`` copies of one request
        (RepText/pipeline_flux_controlnet.py:608-660).
        """
        cfg = self.pipe_cfg
        n_lines = {c.num_lines for c in conditions_list}
        if len(n_lines) != 1:
            raise ValueError(f"batch requests must share num_lines, got {n_lines}")
        pre_encoded = prompt_embeds is not None
        lead_dim = (prompt_embeds if pre_encoded else clip_ids).shape[0]
        if not (len(conditions_list) == len(seeds) == lead_dim
                == (pooled_embeds if pre_encoded else t5_ids).shape[0]):
            raise ValueError(
                "conditions_list, seeds, and prompt inputs lengths differ")
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = guidance_scale if guidance_scale is not None else cfg.guidance_scale

        if not pre_encoded:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)

        cond_l, mask_l, lat_l = [], [], []
        for conds, seed in zip(conditions_list, seeds):
            rng = jax.random.PRNGKey(int(seed))
            r_lat, r_cond, r_glyph = jax.random.split(rng, 3)
            ct, tm = self.prepare_control_tokens(conds, r_cond)
            cond_l.append(ct)
            mask_l.append(tm)
            lat_l.append(self.prepare_latents(r_lat, 1, conds.glyph_canvas, r_glyph))
        cond_tokens = jnp.stack(cond_l, axis=1)   # [N, B, S, F] per-image conds
        token_masks = jnp.stack(mask_l, axis=1)   # [N, B, S, 1]
        latents = jnp.concatenate(lat_l, axis=0)  # [B, S, C]

        b = latents.shape[0]
        sampler = self._get_sampler(steps)
        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width)
        txt_ids = jnp.zeros((prompt_embeds.shape[1], 3))
        guidance = (
            jnp.full((b,), gscale, jnp.float32)
            if self.flux.config.guidance_embeds else None
        )
        flux_extra = None
        if self.flux.ip_adapter:
            # per-request image prompts ride the batch axis: [B, N, D] tokens
            # + [B] scales (scale 0 / zero tokens for requests without one)
            ipc = self.ip_encoder.ip_cfg
            tok_l, scale_l = [], []
            for i in range(b):
                img = (ip_adapter_images[i]
                       if ip_adapter_images is not None else None)
                if img is None:
                    tok_l.append(jnp.zeros(
                        (1, ipc.num_tokens, ipc.cross_attention_dim)))
                    scale_l.append(0.0)
                else:
                    tok_l.append(self.encode_ip_image(img))
                    scale_l.append(
                        1.0 if ip_adapter_scales is None
                        else float(ip_adapter_scales[i]))
            flux_extra = {
                "ip_tokens": jnp.concatenate(tok_l, axis=0),
                "ip_scale": jnp.asarray(scale_l, jnp.float32),
            }
        elif ip_adapter_images is not None and any(
                im is not None for im in ip_adapter_images):
            raise ValueError("ip_adapter_images given but no adapter attached")
        latents = self._run_sampler(
            sampler, self.params["flux"], self.params["controlnet"], latents,
            cond_tokens, token_masks, prompt_embeds, pooled_embeds,
            txt_ids, img_ids, guidance, flux_extra=flux_extra)
        if output_type == "latent":
            return latents
        return postprocess_images(self._decode(latents))

    # ------------------------------------------------------------ internals

    @staticmethod
    def _run_sampler(sampler, *args, **kwargs):
        """One sampler call, retried once after device memory exhaustion.

        The retry runs outside the ``except`` clause: the live exception's
        traceback pins the failed attempt's buffers, so they can only be
        freed once the handler has exited. Records ``pipeline.sampler_s``
        (host seconds until the latents are ready, compilation included on
        a signature's first call) in the process metrics.
        """
        t0 = time.perf_counter()
        try:
            out = jax.block_until_ready(sampler(*args, **kwargs))
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            out = None
        if out is None:
            import gc

            gc.collect()
            out = jax.block_until_ready(sampler(*args, **kwargs))
        default_metrics.observe("pipeline.sampler_s", time.perf_counter() - t0)
        return out

    def _encode_scaled(self, images_nhwc: jax.Array, rng: jax.Array) -> jax.Array:
        """VAE-encode and apply (x - shift) * scale (reference :715-726)."""
        vcfg = self.vae.config
        tiling = self.vae_tiling
        f = vcfg.scale_factor
        h, w = int(images_nhwc.shape[1]), int(images_nhwc.shape[2])
        if tiling is not None and (h > f * tiling[0] or w > f * tiling[0]):
            from reptext.ops.vae_tiling import tiled_apply

            tile_px, overlap_px = f * tiling[0], f * tiling[1]
            params = self.params["vae"]
            host = np.asarray(images_nhwc, np.float32)

            def tile_fn(img_tile, idx):
                return self._vae_encode(
                    params, jnp.asarray(img_tile), jax.random.fold_in(rng, idx))

            # chunk large stacked batches (multi-line conds ride one call,
            # 2N images): per-tile activations scale with the batch
            chunks = []
            for s0 in range(0, host.shape[0], 4):
                chunks.append(tiled_apply(
                    tile_fn, host[s0:s0 + 4],
                    tile_px, overlap_px, 1, f, vcfg.latent_channels))
            lat = jnp.asarray(np.concatenate(chunks, axis=0)
                              if len(chunks) > 1 else chunks[0])
        else:
            lat = self._vae_encode(self.params["vae"], images_nhwc, rng)
        return (lat - vcfg.shift_factor) * vcfg.scaling_factor

    def _decode(self, packed_latents: jax.Array) -> jax.Array:
        cfg = self.pipe_cfg
        tiling = self.vae_tiling
        h, w = cfg.latent_height, cfg.latent_width
        if tiling is not None and (h > tiling[0] or w > tiling[0]):
            from reptext.ops.vae_tiling import tiled_apply

            # unpack on device (tiny), tile the decoder over the latent grid
            lat = np.asarray(
                self._unpack_jit(packed_latents, h, w),
                np.float32).transpose(0, 2, 3, 1)          # [B, h, w, C] NHWC
            params = self.params["vae"]

            def tile_fn(lat_tile, idx):
                return self._vae_decode_tile(params, jnp.asarray(lat_tile))

            return tiled_apply(tile_fn, lat, tiling[0], tiling[1],
                               self.vae.config.scale_factor, 1,
                               self.vae.config.out_channels)
        return self._vae_decode(self.params["vae"], packed_latents, h, w)

    # jitted apply fns (cached per instance)

    @functools.cached_property
    def _vae_encode(self):
        @compiler.jit
        def f(params, images, rng):
            return self.vae.apply(
                params, images.astype(self.compute_dtype), rng, method="encode"
            )
        return f

    @functools.cached_property
    def _vae_decode(self):
        @functools.partial(compiler.jit, static_argnums=(2, 3))
        def f(params, packed, h, w):
            vcfg = self.vae.config
            lat = unpack_latents(packed.astype(self.compute_dtype), h, w)
            lat = lat / vcfg.scaling_factor + vcfg.shift_factor
            return self.vae.apply(params, lat.transpose(0, 2, 3, 1), method="decode")
        return f

    @functools.cached_property
    def _unpack_jit(self):
        return jax.jit(unpack_latents, static_argnums=(1, 2))

    @functools.cached_property
    def _vae_decode_tile(self):
        """One SCALED latent tile [B, th, tw, C] NHWC -> pixels (vae_tiling)."""
        @compiler.jit
        def f(params, lat_tile):
            vcfg = self.vae.config
            lat = lat_tile.astype(self.compute_dtype)
            lat = lat / vcfg.scaling_factor + vcfg.shift_factor
            return self.vae.apply(params, lat, method="decode")
        return f

    @functools.cached_property
    def _clip_apply(self):
        return compiler.jit(lambda p, ids: self.clip.apply(p, ids))

    @functools.cached_property
    def _t5_apply(self):
        return compiler.jit(lambda p, ids: self.t5.apply(p, ids))

    def _get_sampler(self, steps: int, custom_schedule=None):
        """custom_schedule: None, or ("timesteps"|"sigmas", tuple-of-floats) —
        a caller schedule override (reference retrieve_timesteps,
        RepText/pipeline_flux_controlnet.py:91-160,758); becomes part of the
        compiled-sampler cache key."""
        key = steps if custom_schedule is None else (steps,) + custom_schedule
        if not hasattr(self, "_samplers"):
            self._samplers = {}
            self._raw_samplers = {}
            self._schedules = {}
        if key not in self._samplers:
            cfg = self.pipe_cfg
            sched_kw = {}
            if custom_schedule is not None:
                sched_kw[custom_schedule[0]] = list(custom_schedule[1])
            schedule = build_schedule(
                steps, cfg.image_seq_len,
                cfg.base_image_seq_len, cfg.max_image_seq_len,
                cfg.base_shift, cfg.max_shift, cfg.use_dynamic_shifting,
                **sched_kw,
            )
            self._schedules[key] = schedule

            def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr, extra=None):
                kw = {}
                if extra is not None:  # IP-Adapter image-prompt tokens
                    kw = {"ip_tokens": extra["ip_tokens"],
                          "ip_scale": extra["ip_scale"]}
                return self.flux.apply(
                    p, x, ctx, pooled, t, iid, tid, g,
                    controlnet_block_samples=br,
                    controlnet_single_block_samples=sr,
                    **kw,
                )

            def cn_apply(p, x, cond, ctx, pooled, t, iid, tid, g, scale):
                kw = {}
                if self.controlnet.config.union:
                    # union nets select a conditioning-type token per call
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

            if getattr(self, "sp_mesh", None) is not None:
                from reptext.sampling.sampler import make_sp_txt2img_sampler

                n_sp = self.sp_mesh.devices.size
                if cfg.image_seq_len % n_sp:
                    # resolution views inherit sp_mesh; validate HERE so an
                    # incompatible serving bucket fails with a clear error,
                    # not an opaque shard_map trace failure
                    raise ValueError(
                        f"image sequence ({cfg.image_seq_len} tokens at "
                        f"{cfg.height}x{cfg.width}) must divide the sp axis "
                        f"({n_sp})"
                    )
                sample = make_sp_txt2img_sampler(
                    flux_apply, cn_apply, schedule, cfg, self.sp_mesh,
                    self.sp_axis, self.compute_dtype,
                )
            else:
                sample = make_txt2img_sampler(
                    flux_apply, cn_apply, schedule, cfg, self.compute_dtype
                )
            self._raw_samplers[key] = sample
            self._samplers[key] = compiler.jit(sample)
        return self._samplers[key]

    def _get_chunk_sampler(self, steps: int, chunk_len: int, custom_schedule=None):
        """Jitted fixed-length chunk of the denoise loop (traced start_step)."""
        if not hasattr(self, "_chunk_samplers"):
            self._chunk_samplers = {}
        skey = steps if custom_schedule is None else (steps,) + custom_schedule
        key = (skey, chunk_len)
        if key not in self._chunk_samplers:
            self._get_sampler(steps, custom_schedule)
            chunked = self._raw_samplers[skey].chunked
            self._chunk_samplers[key] = compiler.jit(
                lambda *args, flux_extra=None: chunked(
                    *args, chunk_len, flux_extra=flux_extra
                )
            )
        return self._chunk_samplers[key]
