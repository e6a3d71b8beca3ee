"""WHOLE-model numerical parity vs a hand-written torch reference.

Extends tests/test_torch_parity_blocks.py from block level to the complete
graph: torch FluxTransformer2D + RepText ControlNet forwards written out with
exact diffusers state-dict naming (the reference composes these from diffusers
modules — RepText/controlnet_flux.py:216-413 for the ControlNet forward,
RepText/pipeline_flux_controlnet.py:1092-1104 for the base-model invocation
with residual injection), converted through the REAL converter paths
(io/convert.py::convert_flux_transformer / convert_controlnet), and compared
against the JAX models end to end. Covers:

- base-only forward (time_text_embed + guidance + RoPE-from-ids + norm_out);
- base + ControlNet with depth mismatch (pins the ceil-interval residual
  spread AND the after-block injection point);
- union-mode ControlNet (mode-token prepend);
- inpaint-style ControlNet (17ch -> 68-feature conditioning width);
- two full fused sampler steps (timestep/1000 convention, conditioning scale,
  regional token mask, Euler update) vs a hand-rolled torch step loop.

This is SURVEY.md §7's top hard part ("weight conversion fidelity ... errors
surface only as subtle image degradation") made into a hard test.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
nn = torch.nn

from test_torch_parity_blocks import (  # noqa: E402
    TFluxDoubleBlock,
    TFluxSingleBlock,
    _randomize,
)

import dataclasses  # noqa: E402

from reptext.configs import ControlNetConfig, FluxConfig  # noqa: E402
from reptext.io.convert import convert_controlnet, convert_flux_transformer  # noqa: E402
from reptext.models.controlnet import RepTextControlNet  # noqa: E402
from reptext.models.flux import FluxTransformer2D  # noqa: E402

# tiny geometry shared by both sides
DIM, HEADS, HEAD_DIM = 64, 4, 16
AXES = (4, 6, 6)
IN_CH = 8
JOINT_DIM = 12
POOLED_DIM = 10
TIME_DIM = 16
S_TXT, S_IMG, B = 4, 16, 2

FLUX_CFG = dataclasses.replace(
    FluxConfig().tiny(),
    in_channels=IN_CH,
    num_layers=2,
    num_single_layers=4,
    attention_head_dim=HEAD_DIM,
    num_attention_heads=HEADS,
    joint_attention_dim=JOINT_DIM,
    pooled_projection_dim=POOLED_DIM,
    axes_dims_rope=AXES,
    time_embed_dim=TIME_DIM,
)
# depth-mismatched ControlNet (1 double, 2 single vs base 2+4) pins the
# ceil-interval spread (RepText/pipeline_flux_controlnet.py residual mapping)
CN_CFG = dataclasses.replace(
    ControlNetConfig().tiny(),
    in_channels=IN_CH,
    num_layers=1,
    num_single_layers=2,
    attention_head_dim=HEAD_DIM,
    num_attention_heads=HEADS,
    joint_attention_dim=JOINT_DIM,
    pooled_projection_dim=POOLED_DIM,
    axes_dims_rope=AXES,
    time_embed_dim=TIME_DIM,
    extra_condition_channels=IN_CH,  # canny+position -> 2*in packed features
)


# ------------------------------------------------------- torch reference side


def t_rope_from_ids(ids: np.ndarray, axes=AXES, theta=10000.0):
    """diffusers FluxPosEmbed: per-axis freqs 1/theta^(2i/d), interleaved
    repeat — computed independently of ops/rope.py to pin the id handling."""
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = ids[:, axis : axis + 1].astype(np.float64) * freqs[None, :]
        cos_parts.append(np.repeat(np.cos(ang), 2, axis=-1))
        sin_parts.append(np.repeat(np.sin(ang), 2, axis=-1))
    cos = np.concatenate(cos_parts, -1).astype(np.float32)
    sin = np.concatenate(sin_parts, -1).astype(np.float32)
    return torch.tensor(cos), torch.tensor(sin)


def t_sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TMLPEmbedder(nn.Module):
    """diffusers TimestepEmbedding / PixArtAlphaTextProjection naming."""

    def __init__(self, in_dim, hidden):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden)
        self.linear_2 = nn.Linear(hidden, hidden)

    def forward(self, x):
        return self.linear_2(nn.functional.silu(self.linear_1(x)))


class TTimeTextEmbed(nn.Module):
    """CombinedTimestepGuidanceTextProjEmbeddings: temb = t + g + pooled."""

    def __init__(self, inner, time_dim, pooled_dim):
        super().__init__()
        self.timestep_embedder = TMLPEmbedder(time_dim, inner)
        self.guidance_embedder = TMLPEmbedder(time_dim, inner)
        self.text_embedder = TMLPEmbedder(pooled_dim, inner)
        self.time_dim = time_dim

    def forward(self, t, pooled, guidance):
        # the model scales sigma-units by 1000 (RepText/controlnet_flux.py:282)
        emb = self.timestep_embedder(t_sinusoid(t * 1000.0, self.time_dim))
        emb = emb + self.guidance_embedder(t_sinusoid(guidance * 1000.0, self.time_dim))
        return emb + self.text_embedder(pooled)


class TAdaLNContinuous(nn.Module):
    """diffusers AdaLayerNormContinuous (norm_out naming: .linear)."""

    def __init__(self, dim):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)
        self.norm = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)

    def forward(self, x, temb):
        scale, shift = self.linear(nn.functional.silu(temb)).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class TFluxModel(nn.Module):
    """Full torch FluxTransformer2DModel semantics + state-dict naming."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        inner = cfg.inner_dim
        self.cfg = cfg
        self.x_embedder = nn.Linear(cfg.in_channels, inner)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, inner)
        self.time_text_embed = TTimeTextEmbed(
            inner, cfg.time_embed_dim, cfg.pooled_projection_dim
        )
        self.transformer_blocks = nn.ModuleList(
            [TFluxDoubleBlock(inner, cfg.num_attention_heads, cfg.attention_head_dim)
             for _ in range(cfg.num_layers)]
        )
        self.single_transformer_blocks = nn.ModuleList(
            [TFluxSingleBlock(inner, cfg.num_attention_heads, cfg.attention_head_dim)
             for _ in range(cfg.num_single_layers)]
        )
        self.norm_out = TAdaLNContinuous(inner)
        self.proj_out = nn.Linear(inner, cfg.out_channels)

    def forward(
        self, hidden_states, encoder_hidden_states, pooled, timestep,
        img_ids, txt_ids, guidance,
        controlnet_block_samples=None, controlnet_single_block_samples=None,
    ):
        x = self.x_embedder(hidden_states)
        temb = self.time_text_embed(timestep, pooled, guidance)
        ctx = self.context_embedder(encoder_hidden_states)
        ids = np.concatenate([txt_ids, img_ids], axis=0)
        cos, sin = t_rope_from_ids(ids, self.cfg.axes_dims_rope)

        for i, block in enumerate(self.transformer_blocks):
            ctx, x = block(x, ctx, temb, cos, sin)
            if controlnet_block_samples is not None:
                # diffusers: residual added AFTER the block, index i//ceil(L/n)
                interval = int(np.ceil(
                    len(self.transformer_blocks) / len(controlnet_block_samples)
                ))
                x = x + controlnet_block_samples[i // interval]
        h = torch.cat([ctx, x], dim=1)
        s_txt = encoder_hidden_states.shape[1]
        for i, block in enumerate(self.single_transformer_blocks):
            h = block(h, temb, cos, sin)
            if controlnet_single_block_samples is not None:
                interval = int(np.ceil(
                    len(self.single_transformer_blocks)
                    / len(controlnet_single_block_samples)
                ))
                h = torch.cat(
                    [h[:, :s_txt],
                     h[:, s_txt:] + controlnet_single_block_samples[i // interval]],
                    dim=1,
                )
        x = h[:, s_txt:]
        return self.proj_out(self.norm_out(x, temb))


class TControlNetModel(nn.Module):
    """Full torch FluxControlNetModel (RepText/controlnet_flux.py:41-413)."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        inner = cfg.inner_dim
        self.cfg = cfg
        self.x_embedder = nn.Linear(cfg.in_channels, inner)
        self.controlnet_x_embedder = nn.Linear(
            cfg.in_channels + cfg.extra_condition_channels, inner
        )
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, inner)
        self.time_text_embed = TTimeTextEmbed(
            inner, cfg.time_embed_dim, cfg.pooled_projection_dim
        )
        self.transformer_blocks = nn.ModuleList(
            [TFluxDoubleBlock(inner, cfg.num_attention_heads, cfg.attention_head_dim)
             for _ in range(cfg.num_layers)]
        )
        self.single_transformer_blocks = nn.ModuleList(
            [TFluxSingleBlock(inner, cfg.num_attention_heads, cfg.attention_head_dim)
             for _ in range(cfg.num_single_layers)]
        )
        self.controlnet_blocks = nn.ModuleList(
            [nn.Linear(inner, inner) for _ in range(cfg.num_layers)]
        )
        self.controlnet_single_blocks = nn.ModuleList(
            [nn.Linear(inner, inner) for _ in range(cfg.num_single_layers)]
        )
        if cfg.union:
            self.controlnet_mode_embedder = nn.Embedding(cfg.num_mode, inner)

    def forward(
        self, hidden_states, controlnet_cond, encoder_hidden_states, pooled,
        timestep, img_ids, txt_ids, guidance, conditioning_scale=1.0, mode=None,
    ):
        x = self.x_embedder(hidden_states) + self.controlnet_x_embedder(controlnet_cond)
        temb = self.time_text_embed(timestep, pooled, guidance)
        ctx = self.context_embedder(encoder_hidden_states)
        if self.cfg.union:
            mode_tok = self.controlnet_mode_embedder(mode.reshape(-1, 1))  # [B,1,D]
            ctx = torch.cat([mode_tok, ctx], dim=1)
            txt_ids = np.concatenate([txt_ids[:1], txt_ids], axis=0)
        ids = np.concatenate([txt_ids, img_ids], axis=0)
        cos, sin = t_rope_from_ids(ids, self.cfg.axes_dims_rope)

        block_samples = []
        for block in self.transformer_blocks:
            ctx, x = block(x, ctx, temb, cos, sin)
            block_samples.append(x)
        h = torch.cat([ctx, x], dim=1)
        s_txt = ctx.shape[1]
        single_samples = []
        for block in self.single_transformer_blocks:
            h = block(h, temb, cos, sin)
            single_samples.append(h[:, s_txt:])
        block_samples = [
            proj(s) * conditioning_scale
            for proj, s in zip(self.controlnet_blocks, block_samples)
        ]
        single_samples = [
            proj(s) * conditioning_scale
            for proj, s in zip(self.controlnet_single_blocks, single_samples)
        ]
        return block_samples, single_samples


# ------------------------------------------------------------------ fixtures


def _state_np(module):
    return {k: v.detach().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


def _make_ids(s_txt=S_TXT, s_img=S_IMG):
    txt_ids = np.zeros((s_txt, 3), np.float32)
    side = int(math.isqrt(s_img))
    grid = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1
    )
    img_ids = np.zeros((s_img, 3), np.float32)
    img_ids[:, 1:] = grid.reshape(-1, 2)
    return txt_ids, img_ids


def _inputs(seed=0, b=B):
    r = np.random.default_rng(seed)
    return {
        "hidden": r.standard_normal((b, S_IMG, IN_CH)).astype(np.float32),
        "ctx": r.standard_normal((b, S_TXT, JOINT_DIM)).astype(np.float32),
        "pooled": r.standard_normal((b, POOLED_DIM)).astype(np.float32),
        "t": np.full((b,), 0.73, np.float32),
        "guidance": np.full((b,), 3.5, np.float32),
        "cond": r.standard_normal((b, S_IMG, 2 * IN_CH)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def tmodels():
    tflux = _randomize(TFluxModel(FLUX_CFG), seed=10)
    tcn = _randomize(TControlNetModel(CN_CFG), seed=11)
    return tflux, tcn


@pytest.fixture(scope="module")
def jparams(tmodels):
    tflux, tcn = tmodels
    flux_params = jax.tree_util.tree_map(
        jnp.asarray, convert_flux_transformer(_state_np(tflux), FLUX_CFG)
    )
    cn_params = jax.tree_util.tree_map(
        jnp.asarray, convert_controlnet(_state_np(tcn), CN_CFG)
    )
    return flux_params, cn_params


TOL = dict(rtol=5e-4, atol=5e-4)


def test_full_flux_forward_parity(tmodels, jparams):
    """Base model alone: embeds, RoPE-from-ids, 2+4 blocks, norm_out."""
    tflux, _ = tmodels
    flux_params, _ = jparams
    x = _inputs()
    txt_ids, img_ids = _make_ids()

    with torch.no_grad():
        want = tflux(
            torch.tensor(x["hidden"]), torch.tensor(x["ctx"]),
            torch.tensor(x["pooled"]), torch.tensor(x["t"]),
            img_ids, txt_ids, torch.tensor(x["guidance"]),
        ).numpy()

    model = FluxTransformer2D(config=FLUX_CFG, attention_backend="xla")
    got = model.apply(
        flux_params, jnp.asarray(x["hidden"]), jnp.asarray(x["ctx"]),
        jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
    )
    np.testing.assert_allclose(np.asarray(got), want, **TOL)


def test_controlnet_forward_parity(tmodels, jparams):
    """ControlNet alone: cond embedder, trimmed stacks, residual heads, scale."""
    _, tcn = tmodels
    _, cn_params = jparams
    x = _inputs(seed=1)
    txt_ids, img_ids = _make_ids()
    scale = 0.8

    with torch.no_grad():
        want_blocks, want_singles = tcn(
            torch.tensor(x["hidden"]), torch.tensor(x["cond"]),
            torch.tensor(x["ctx"]), torch.tensor(x["pooled"]),
            torch.tensor(x["t"]), img_ids, txt_ids,
            torch.tensor(x["guidance"]), conditioning_scale=scale,
        )

    model = RepTextControlNet(config=CN_CFG, attention_backend="xla")
    got_blocks, got_singles = model.apply(
        cn_params, jnp.asarray(x["hidden"]), jnp.asarray(x["cond"]),
        jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
        conditioning_scale=scale,
    )
    assert got_blocks.shape[0] == len(want_blocks)
    assert got_singles.shape[0] == len(want_singles)
    for i, want in enumerate(want_blocks):
        np.testing.assert_allclose(np.asarray(got_blocks[i]), want.numpy(), **TOL)
    for i, want in enumerate(want_singles):
        np.testing.assert_allclose(np.asarray(got_singles[i]), want.numpy(), **TOL)


def test_composed_injection_parity(tmodels, jparams):
    """Base + depth-mismatched ControlNet: the full RepText composition.

    1 double residual spread over 2 base blocks and 2 single residuals over 4
    single blocks pins BOTH the ceil-interval mapping and the after-block
    injection point (a pre-block injection passes the base-only test but
    fails here)."""
    tflux, tcn = tmodels
    flux_params, cn_params = jparams
    x = _inputs(seed=2)
    txt_ids, img_ids = _make_ids()
    scale = 0.7

    with torch.no_grad():
        blocks, singles = tcn(
            torch.tensor(x["hidden"]), torch.tensor(x["cond"]),
            torch.tensor(x["ctx"]), torch.tensor(x["pooled"]),
            torch.tensor(x["t"]), img_ids, txt_ids,
            torch.tensor(x["guidance"]), conditioning_scale=scale,
        )
        want = tflux(
            torch.tensor(x["hidden"]), torch.tensor(x["ctx"]),
            torch.tensor(x["pooled"]), torch.tensor(x["t"]),
            img_ids, txt_ids, torch.tensor(x["guidance"]),
            controlnet_block_samples=blocks,
            controlnet_single_block_samples=singles,
        ).numpy()

    cn = RepTextControlNet(config=CN_CFG, attention_backend="xla")
    jblocks, jsingles = cn.apply(
        cn_params, jnp.asarray(x["hidden"]), jnp.asarray(x["cond"]),
        jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
        conditioning_scale=scale,
    )
    model = FluxTransformer2D(config=FLUX_CFG, attention_backend="xla")
    got = model.apply(
        flux_params, jnp.asarray(x["hidden"]), jnp.asarray(x["ctx"]),
        jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
        controlnet_block_samples=jblocks,
        controlnet_single_block_samples=jsingles,
    )
    np.testing.assert_allclose(np.asarray(got), want, **TOL)


def test_union_mode_controlnet_parity():
    """Union mode: learned mode token prepended to the context
    (RepText/controlnet_flux.py:294-301)."""
    cfg = dataclasses.replace(CN_CFG, num_mode=3)
    tcn = _randomize(TControlNetModel(cfg), seed=12)
    cn_params = jax.tree_util.tree_map(
        jnp.asarray, convert_controlnet(_state_np(tcn), cfg)
    )
    x = _inputs(seed=3)
    txt_ids, img_ids = _make_ids()
    mode = np.array([1, 2], np.int32)

    with torch.no_grad():
        want_blocks, want_singles = tcn(
            torch.tensor(x["hidden"]), torch.tensor(x["cond"]),
            torch.tensor(x["ctx"]), torch.tensor(x["pooled"]),
            torch.tensor(x["t"]), img_ids, txt_ids,
            torch.tensor(x["guidance"]), mode=torch.tensor(mode, dtype=torch.long),
        )

    model = RepTextControlNet(config=cfg, attention_backend="xla")
    got_blocks, got_singles = model.apply(
        cn_params, jnp.asarray(x["hidden"]), jnp.asarray(x["cond"]),
        jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
        mode=jnp.asarray(mode),
    )
    for i, want in enumerate(want_blocks):
        np.testing.assert_allclose(np.asarray(got_blocks[i]), want.numpy(), **TOL)
    for i, want in enumerate(want_singles):
        np.testing.assert_allclose(np.asarray(got_singles[i]), want.numpy(), **TOL)


def test_inpaint_controlnet_parity():
    """Inpaint-width conditioning (17ch latent+mask -> packed 4x width;
    RepText/pipeline_flux_controlnet_inpaint.py:796-826). Tiny equivalent:
    extra_condition_channels != in_channels exercises the distinct embedder
    width through the converter."""
    cfg = dataclasses.replace(CN_CFG, extra_condition_channels=IN_CH // 2 + 1)
    tcn = _randomize(TControlNetModel(cfg), seed=13)
    cn_params = jax.tree_util.tree_map(
        jnp.asarray, convert_controlnet(_state_np(tcn), cfg)
    )
    x = _inputs(seed=4)
    r = np.random.default_rng(44)
    cond = r.standard_normal(
        (B, S_IMG, cfg.in_channels + cfg.extra_condition_channels)
    ).astype(np.float32)
    txt_ids, img_ids = _make_ids()

    with torch.no_grad():
        want_blocks, want_singles = tcn(
            torch.tensor(x["hidden"]), torch.tensor(cond),
            torch.tensor(x["ctx"]), torch.tensor(x["pooled"]),
            torch.tensor(x["t"]), img_ids, txt_ids, torch.tensor(x["guidance"]),
        )

    model = RepTextControlNet(config=cfg, attention_backend="xla")
    got_blocks, got_singles = model.apply(
        cn_params, jnp.asarray(x["hidden"]), jnp.asarray(cond),
        jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(x["guidance"]),
    )
    for i, want in enumerate(want_blocks):
        np.testing.assert_allclose(np.asarray(got_blocks[i]), want.numpy(), **TOL)
    for i, want in enumerate(want_singles):
        np.testing.assert_allclose(np.asarray(got_singles[i]), want.numpy(), **TOL)


def test_sampler_steps_parity(tmodels, jparams):
    """Two fused sampler steps vs a hand-rolled torch denoising loop: pins the
    timestep/1000 convention, ControlNet gating, regional token masking,
    conditioning scale, and the FlowMatch Euler update in composition
    (RepText/pipeline_flux_controlnet.py:1016-1130)."""
    import functools

    from reptext.configs import PipelineConfig
    from reptext.sampling.flow_match import build_schedule
    from reptext.sampling.sampler import make_txt2img_sampler

    tflux, tcn = tmodels
    flux_params, cn_params = jparams
    x = _inputs(seed=5, b=1)
    txt_ids, img_ids = _make_ids()
    steps = 2
    scale = 0.9
    schedule = build_schedule(steps, S_IMG)
    r = np.random.default_rng(55)
    # a nontrivial per-token regional mask (reference :1060-1069)
    mask = (r.random((1, S_IMG, 1)) > 0.4).astype(np.float32)

    # torch loop
    lat = torch.tensor(x["hidden"])
    tmask = torch.tensor(mask[0])
    with torch.no_grad():
        for i in range(steps):
            t = torch.full((1,), float(schedule.timesteps[i]) / 1000.0)
            blocks, singles = tcn(
                lat.float(), torch.tensor(x["cond"][:1]),
                torch.tensor(x["ctx"][:1]), torch.tensor(x["pooled"][:1]),
                t, img_ids, txt_ids, torch.tensor(x["guidance"][:1]),
                conditioning_scale=scale,
            )
            blocks = [s * tmask for s in blocks]
            singles = [s * tmask for s in singles]
            v = tflux(
                lat.float(), torch.tensor(x["ctx"][:1]),
                torch.tensor(x["pooled"][:1]), t, img_ids, txt_ids,
                torch.tensor(x["guidance"][:1]),
                controlnet_block_samples=blocks,
                controlnet_single_block_samples=singles,
            )
            dt = float(schedule.sigmas[i + 1] - schedule.sigmas[i])
            lat = lat + dt * v
    want = lat.numpy()

    # fused JAX sampler
    pipe_cfg = PipelineConfig(
        num_inference_steps=steps,
        controlnet_conditioning_step=steps,
        controlnet_conditioning_scale=scale,
    )
    flux = FluxTransformer2D(config=FLUX_CFG, attention_backend="xla")
    cn = RepTextControlNet(config=CN_CFG, attention_backend="xla")
    sampler = make_txt2img_sampler(
        functools.partial(flux.apply),
        functools.partial(cn.apply),
        schedule, pipe_cfg,
    )
    got = sampler(
        flux_params, cn_params,
        jnp.asarray(x["hidden"][:1]),
        jnp.asarray(x["cond"][:1]),       # [N=1, S, F]
        jnp.asarray(mask),                # [N=1, S, 1]
        jnp.asarray(x["ctx"][:1]), jnp.asarray(x["pooled"][:1]),
        jnp.asarray(txt_ids), jnp.asarray(img_ids),
        jnp.asarray(x["guidance"][:1]),
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=2e-3)
