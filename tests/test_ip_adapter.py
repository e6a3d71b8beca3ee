"""FLUX IP-Adapter: torch parity + no-op invariance + pipeline smoke.

The reference README advertises compatibility with the published FLUX
IP-Adapter (RepText/README.md:183) via diffusers; the adapter itself lives
in diffusers, not the reference repo. This build implements it natively
(nn/clip_vision.py, models/ip_adapter.py, nn/blocks.py ip_adapter path) and
these tests pin:

- the CLIP vision tower + converter against the REAL transformers
  ``CLIPVisionModelWithProjection`` (tiny config);
- the ImageProjection + decoupled-attention block against a hand-written
  torch replica of the diffusers semantics (diffusers itself is not
  installed here), through the real converters;
- zero to_v_ip == exact no-op (the attach-time init guarantee);
- the end-to-end pipeline path with an image prompt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import (
    CLIPConfig, CLIPVisionConfig, ControlNetConfig, FluxConfig,
    IPAdapterConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.io.convert import (
    _double_block, _lin, _lin_rope, convert_clip_vision,
    convert_flux_transformer, convert_ip_adapter, merge_ip_adapter_into_flux,
)
from reptext.models import FluxTransformer2D
from reptext.models.ip_adapter import ImageProjection
from reptext.nn.blocks import JointTransformerBlock
from reptext.nn.clip_vision import CLIPVisionEncoder
from reptext.ops.latents import prepare_latent_image_ids
from reptext.ops.rope import rope_cos_sin, rope_cos_sin_half

torch = pytest.importorskip("torch")
tnn = torch.nn

VCFG = CLIPVisionConfig().tiny()


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------- CLIP vision


def test_clip_vision_torch_parity():
    """Converted transformers CLIPVisionModelWithProjection == our tower."""
    from transformers import CLIPVisionConfig as HFVisionConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(0)
    hf_cfg = HFVisionConfig(
        image_size=VCFG.image_size, patch_size=VCFG.patch_size,
        hidden_size=VCFG.hidden_size, intermediate_size=VCFG.intermediate_size,
        num_hidden_layers=VCFG.num_layers, num_attention_heads=VCFG.num_heads,
        projection_dim=VCFG.projection_dim, layer_norm_eps=VCFG.layer_norm_eps,
        hidden_act="quick_gelu",
    )
    tm = CLIPVisionModelWithProjection(hf_cfg).eval()
    state = {k: _np(v) for k, v in tm.state_dict().items()}
    variables = jax.tree_util.tree_map(
        jnp.asarray, convert_clip_vision(state, VCFG)
    )

    rng = np.random.default_rng(1)
    pixels = rng.normal(size=(2, VCFG.image_size, VCFG.image_size, 3)).astype(
        np.float32
    )
    with torch.no_grad():
        t_out = tm(pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2))
    j_hidden, j_embeds = CLIPVisionEncoder(VCFG).apply(
        variables, jnp.asarray(pixels)
    )
    np.testing.assert_allclose(
        np.asarray(j_embeds), _np(t_out.image_embeds), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(j_hidden), _np(t_out.last_hidden_state), rtol=2e-4, atol=2e-5
    )


# ----------------------------------------------------------- ImageProjection


class TImageProjection(tnn.Module):
    """diffusers ImageProjection: linear -> reshape [B,N,D] -> LayerNorm."""

    def __init__(self, embed_dim, cross_dim, num_tokens):
        super().__init__()
        self.num_tokens = num_tokens
        self.cross_dim = cross_dim
        self.proj = tnn.Linear(embed_dim, num_tokens * cross_dim)
        self.norm = tnn.LayerNorm(cross_dim)

    def forward(self, x):
        x = self.proj(x).reshape(-1, self.num_tokens, self.cross_dim)
        return self.norm(x)


def test_image_projection_torch_parity():
    ip_cfg = IPAdapterConfig().tiny()
    torch.manual_seed(2)
    tm = TImageProjection(
        ip_cfg.image_embed_dim, ip_cfg.cross_attention_dim, ip_cfg.num_tokens
    ).eval()
    state = {f"image_proj.{k}": _np(v) for k, v in tm.state_dict().items()}
    # single layer of fake per-block projections to satisfy the converter
    inner = 8
    state.update({
        "ip_adapter.0.to_k_ip.weight": np.zeros(
            (inner, ip_cfg.cross_attention_dim), np.float32),
        "ip_adapter.0.to_k_ip.bias": np.zeros((inner,), np.float32),
        "ip_adapter.0.to_v_ip.weight": np.zeros(
            (inner, ip_cfg.cross_attention_dim), np.float32),
        "ip_adapter.0.to_v_ip.bias": np.zeros((inner,), np.float32),
    })
    converted = convert_ip_adapter(state, num_layers=1, head_dim=inner)

    x = np.random.default_rng(3).normal(
        size=(2, ip_cfg.image_embed_dim)
    ).astype(np.float32)
    with torch.no_grad():
        t_out = _np(tm(torch.from_numpy(x)))
    j_out = ImageProjection(ip_cfg).apply(
        jax.tree_util.tree_map(jnp.asarray, converted["proj"]), jnp.asarray(x)
    )
    np.testing.assert_allclose(np.asarray(j_out), t_out, rtol=2e-4, atol=2e-5)
    assert converted["blocks"]["to_k_ip"]["kernel"].shape == (
        1, ip_cfg.cross_attention_dim, inner)


# ------------------------------------------------- decoupled-attention block


class TIPDoubleBlock(tnn.Module):
    """Torch replica of the IP-extended double block (diffusers
    FluxTransformerBlock + FluxIPAdapterJointAttnProcessor2_0 semantics:
    RoPE-free post-q-norm image queries over the ip tokens, no k-norm on ip
    keys, scaled result added UNGATED after the FF residual)."""

    def __init__(self, base_block, dim, heads, head_dim, cross_dim):
        super().__init__()
        self.base = base_block
        inner = heads * head_dim
        self.heads = heads
        self.to_k_ip = tnn.Linear(cross_dim, inner)
        self.to_v_ip = tnn.Linear(cross_dim, inner)

    def forward(self, img, txt, temb, cos, sin, ip_tokens, ip_scale):
        b = self.base
        n_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = b.norm1(img, temb)
        n_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = (
            b.norm1_context(txt, temb))
        attn_img, attn_txt = b.attn(n_img, n_txt, cos, sin)

        def split(x):
            bsz, s, _ = x.shape
            return x.view(bsz, s, self.heads, -1).transpose(1, 2)

        ip_q = b.attn.norm_q(split(b.attn.to_q(n_img)))  # pre-RoPE
        ip_k = split(self.to_k_ip(ip_tokens))
        ip_v = split(self.to_v_ip(ip_tokens))
        ip_attn = tnn.functional.scaled_dot_product_attention(ip_q, ip_k, ip_v)
        bsz, h, s, d = ip_attn.shape
        ip_attn = ip_attn.transpose(1, 2).reshape(bsz, s, h * d)

        img = img + gate_msa[:, None] * attn_img
        hh = b.norm2(img) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        img = img + gate_mlp[:, None] * b.ff(hh)
        img = img + ip_scale * ip_attn

        txt = txt + c_gate_msa[:, None] * attn_txt
        hc = b.norm2_context(txt) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        txt = txt + c_gate_mlp[:, None] * b.ff_context(hc)
        return txt, img


def test_ip_double_block_torch_parity():
    from tests.test_torch_parity_blocks import TFluxDoubleBlock

    dim, heads, head_dim, cross = 64, 4, 16, 24
    torch.manual_seed(4)
    tm = TIPDoubleBlock(
        TFluxDoubleBlock(dim, heads, head_dim), dim, heads, head_dim, cross
    ).eval()

    state = {f"blk.{k}": _np(v) for k, v in tm.base.state_dict().items()}
    jx = _double_block(state, "blk", head_dim=head_dim)
    ip_state = {f"ip.{k}": _np(v) for k, v in tm.state_dict().items()
                if k.startswith("to_")}
    # to_k_ip takes the same RoPE-deinterleave fold as the base q/k: the ip
    # attention reuses the model's permuted-layout queries (convert_ip_adapter
    # does the same for real checkpoints)
    jx["to_k_ip"] = _lin_rope(ip_state, "ip.to_k_ip", head_dim)
    jx["to_v_ip"] = _lin(ip_state, "ip.to_v_ip")
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, jx)}

    rng = np.random.default_rng(5)
    s_txt, s_img, n_ip, bsz = 3, 8, 2, 2
    img = rng.normal(size=(bsz, s_img, dim)).astype(np.float32)
    txt = rng.normal(size=(bsz, s_txt, dim)).astype(np.float32)
    temb = rng.normal(size=(bsz, dim)).astype(np.float32)
    ip_tokens = rng.normal(size=(bsz, n_ip, cross)).astype(np.float32)
    scale = 0.7

    ids = np.concatenate(
        [np.zeros((s_txt, 3), np.float32),
         np.asarray(prepare_latent_image_ids(8, 8))[:s_img]], axis=0)
    axes = (4, 6, 6)
    cos_i, sin_i = rope_cos_sin(jnp.asarray(ids), axes, 10000)
    cos_h, sin_h = rope_cos_sin_half(jnp.asarray(ids), axes, 10000)

    with torch.no_grad():
        t_txt, t_img = tm(
            torch.from_numpy(img), torch.from_numpy(txt),
            torch.from_numpy(temb),
            torch.from_numpy(np.asarray(cos_i)),
            torch.from_numpy(np.asarray(sin_i)),
            torch.from_numpy(ip_tokens), scale,
        )

    j_txt, j_img = JointTransformerBlock(
        dim=dim, num_heads=heads, head_dim=head_dim, ip_adapter=True,
    ).apply(
        variables, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(temb),
        cos_h, sin_h, jnp.asarray(ip_tokens), jnp.asarray(scale),
    )
    np.testing.assert_allclose(np.asarray(j_img), _np(t_img), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(j_txt), _np(t_txt), rtol=2e-4, atol=2e-4)


# -------------------------------------------------- whole-model + invariance


def _tiny_flux_inputs(cfg, rng_seed=0, s_txt=4):
    rng = np.random.default_rng(rng_seed)
    s_img = 16
    return dict(
        hidden_states=jnp.asarray(
            rng.normal(size=(1, s_img, cfg.in_channels)).astype(np.float32)),
        encoder_hidden_states=jnp.asarray(
            rng.normal(size=(1, s_txt, cfg.joint_attention_dim)).astype(np.float32)),
        pooled_projections=jnp.asarray(
            rng.normal(size=(1, cfg.pooled_projection_dim)).astype(np.float32)),
        timestep=jnp.asarray([0.5]),
        img_ids=prepare_latent_image_ids(8, 8)[:s_img],
        txt_ids=jnp.zeros((s_txt, 3)),
        guidance=jnp.asarray([3.5]) if cfg.guidance_embeds else None,
    )


def test_zero_to_v_ip_is_noop():
    """ip model with zero to_v_ip == plain model on identical base weights."""
    cfg = FluxConfig().tiny()
    ip_cfg = IPAdapterConfig().tiny()
    base = FluxTransformer2D(cfg)
    ip_model = FluxTransformer2D(cfg, ip_adapter=True)
    inp = _tiny_flux_inputs(cfg)
    ip_tokens = jnp.asarray(
        np.random.default_rng(7).normal(size=(1, ip_cfg.num_tokens,
                                              ip_cfg.cross_attention_dim))
        .astype(np.float32))

    ip_vars = ip_model.init(jax.random.PRNGKey(0), **inp, ip_tokens=ip_tokens)
    blk = ip_vars["params"]["double_blocks"]["block"]
    blk["to_v_ip"] = jax.tree_util.tree_map(jnp.zeros_like, blk["to_v_ip"])
    base_params = jax.tree_util.tree_map(lambda x: x, ip_vars)
    del base_params["params"]["double_blocks"]["block"]["to_k_ip"]
    del base_params["params"]["double_blocks"]["block"]["to_v_ip"]

    out_ip = ip_model.apply(ip_vars, **inp, ip_tokens=ip_tokens,
                            ip_scale=jnp.asarray(1.0))
    out_base = base.apply(base_params, **inp)
    np.testing.assert_allclose(
        np.asarray(out_ip), np.asarray(out_base), rtol=1e-6, atol=1e-6
    )


def test_convert_and_merge_roundtrip():
    """Converted flux + merged ip blocks load into the ip_adapter model."""
    from test_torch_parity_blocks import _randomize
    from test_torch_parity_model import TFluxModel, _state_np

    cfg = dataclasses.replace(FluxConfig().tiny(), num_layers=2)
    ip_cfg = IPAdapterConfig().tiny()
    state = _state_np(_randomize(TFluxModel(cfg), seed=8))
    inner = cfg.inner_dim
    rng = np.random.default_rng(8)
    nt, cd, ed = ip_cfg.num_tokens, ip_cfg.cross_attention_dim, ip_cfg.image_embed_dim
    state["image_proj.proj.weight"] = rng.normal(size=(nt * cd, ed)).astype(np.float32)
    state["image_proj.proj.bias"] = np.zeros((nt * cd,), np.float32)
    state["image_proj.norm.weight"] = np.ones((cd,), np.float32)
    state["image_proj.norm.bias"] = np.zeros((cd,), np.float32)
    for i in range(cfg.num_layers):
        state[f"ip_adapter.{i}.to_k_ip.weight"] = rng.normal(
            size=(inner, ip_cfg.cross_attention_dim)).astype(np.float32)
        state[f"ip_adapter.{i}.to_k_ip.bias"] = rng.normal(
            size=(inner,)).astype(np.float32)
        state[f"ip_adapter.{i}.to_v_ip.weight"] = rng.normal(
            size=(inner, ip_cfg.cross_attention_dim)).astype(np.float32) * 0.01
        state[f"ip_adapter.{i}.to_v_ip.bias"] = np.zeros((inner,), np.float32)

    flux_vars = convert_flux_transformer(state, cfg)
    converted = convert_ip_adapter(
        state, num_layers=cfg.num_layers, head_dim=cfg.attention_head_dim)
    merged = merge_ip_adapter_into_flux(flux_vars, converted["blocks"])
    merged = jax.tree_util.tree_map(jnp.asarray, merged)

    model = FluxTransformer2D(cfg, ip_adapter=True)
    inp = _tiny_flux_inputs(cfg)
    ip_tokens = jnp.asarray(rng.normal(
        size=(1, ip_cfg.num_tokens, ip_cfg.cross_attention_dim)
    ).astype(np.float32))
    out0 = model.apply(merged, **inp, ip_tokens=ip_tokens,
                       ip_scale=jnp.asarray(0.0))
    out1 = model.apply(merged, **inp, ip_tokens=ip_tokens,
                       ip_scale=jnp.asarray(1.0))
    assert np.isfinite(np.asarray(out1)).all()
    # nonzero to_v_ip at scale 1 must change the output; scale 0 must not
    assert float(np.abs(np.asarray(out1) - np.asarray(out0)).max()) > 1e-7


# ------------------------------------------------------------ pipeline smoke


@pytest.mark.slow
def test_pipeline_ip_adapter_smoke():
    from reptext.conditioning import TextLine, build_conditions
    from reptext.pipelines import FluxRepTextPipeline

    size, steps = 64, 2
    pipe_cfg = PipelineConfig(height=size, width=size,
                              num_inference_steps=steps,
                              controlnet_conditioning_step=steps)
    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(), pipe_cfg=pipe_cfg,
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    pipe.attach_ip_adapter(
        vision_cfg=VCFG,
        ip_cfg=dataclasses.replace(
            IPAdapterConfig().tiny(),
            cross_attention_dim=pipe.flux.config.joint_attention_dim),
    )
    conds = build_conditions([TextLine("Hi", (8, 20), font_size=20)], size, size)
    from reptext.cli import _tokenize

    clip_ids, t5_ids = _tokenize("a sign", pipe.clip.config, pipe.t5.config, None)
    style = np.random.default_rng(0).integers(
        0, 256, (size, size, 3)).astype(np.uint8)

    img_with = pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=3,
                    ip_adapter_image=style, ip_adapter_scale=1.0)
    assert img_with.shape == (1, size, size, 3)

    # zero-init to_v_ip: image prompt at ANY scale is a no-op vs no image
    img_without = pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=3)
    np.testing.assert_array_equal(img_with, img_without)

    # resolution views (serving buckets) inherit the attached adapter —
    # ip_encoder is a dataclass field, not an ad-hoc attribute
    view = pipe.with_resolution(128, 128)
    assert view.ip_encoder is pipe.ip_encoder
    assert view.flux.ip_adapter


# ------------------------------------------------ WHOLE-model ip torch parity


def test_whole_model_ip_torch_parity():
    """Complete converted IP-Adapter graph vs torch: TFluxModel with every
    double block wrapped in the decoupled-ip attention + ImageProjection,
    state-dict named exactly like the diffusers checkpoint
    (transformer_blocks.* / ip_adapter.{i}.* / image_proj.*), through
    convert_flux_transformer + convert_ip_adapter + merge_ip_adapter_into_flux.
    Pins the scan-carry ip plumbing, the ungated post-FF add, and the scale
    broadcast at full-graph level (block-level parity alone would miss a
    mis-wired carry or a residual applied to the wrong stream)."""
    from test_torch_parity_blocks import _randomize
    from test_torch_parity_model import (
        FLUX_CFG, TFluxModel, _inputs, _make_ids, _state_np,
    )

    ip_cfg = dataclasses.replace(
        IPAdapterConfig().tiny(), image_embed_dim=12, num_tokens=3,
        cross_attention_dim=16)
    cfg = FLUX_CFG
    torch.manual_seed(20)
    tm = _randomize(TFluxModel(cfg), seed=21)
    heads, head_dim = cfg.num_attention_heads, cfg.attention_head_dim
    ip_wraps = [
        TIPDoubleBlock(blk, cfg.inner_dim, heads, head_dim,
                       ip_cfg.cross_attention_dim).eval()
        for blk in tm.transformer_blocks
    ]
    for w in ip_wraps:
        torch.nn.init.normal_(w.to_k_ip.weight, std=0.3)
        torch.nn.init.normal_(w.to_k_ip.bias, std=0.1)
        torch.nn.init.normal_(w.to_v_ip.weight, std=0.3)
        torch.nn.init.normal_(w.to_v_ip.bias, std=0.1)
    tproj = TImageProjection(
        ip_cfg.image_embed_dim, ip_cfg.cross_attention_dim, ip_cfg.num_tokens
    ).eval()

    # diffusers-checkpoint naming for the converters
    state = _state_np(tm)
    for i, w in enumerate(ip_wraps):
        for nm in ("to_k_ip", "to_v_ip"):
            lin = getattr(w, nm)
            state[f"ip_adapter.{i}.{nm}.weight"] = _np(lin.weight)
            state[f"ip_adapter.{i}.{nm}.bias"] = _np(lin.bias)
    for k, v in tproj.state_dict().items():
        state[f"image_proj.{k}"] = _np(v)

    flux_vars = convert_flux_transformer(state, cfg)
    converted = convert_ip_adapter(
        state, num_layers=cfg.num_layers, head_dim=head_dim)
    merged = jax.tree_util.tree_map(
        jnp.asarray, merge_ip_adapter_into_flux(flux_vars, converted["blocks"]))
    proj_vars = jax.tree_util.tree_map(jnp.asarray, converted["proj"])

    inp = _inputs(seed=30)
    txt_ids, img_ids = _make_ids()
    rng = np.random.default_rng(31)
    image_embeds = rng.standard_normal(
        (inp["hidden"].shape[0], ip_cfg.image_embed_dim)).astype(np.float32)
    scale = 0.6

    # torch forward: TFluxModel.forward with ip-wrapped double blocks
    from test_torch_parity_model import t_rope_from_ids

    with torch.no_grad():
        tokens = tproj(torch.from_numpy(image_embeds))
        x = tm.x_embedder(torch.from_numpy(inp["hidden"]))
        temb = tm.time_text_embed(
            torch.from_numpy(inp["t"]), torch.from_numpy(inp["pooled"]),
            torch.from_numpy(inp["guidance"]))
        ctx = tm.context_embedder(torch.from_numpy(inp["ctx"]))
        ids = np.concatenate([txt_ids, img_ids], axis=0)
        cos, sin = t_rope_from_ids(ids, cfg.axes_dims_rope)
        for w in ip_wraps:
            ctx, x = w(x, ctx, temb, cos, sin, tokens, scale)
        h = torch.cat([ctx, x], dim=1)
        s_txt = inp["ctx"].shape[1]
        for blk in tm.single_transformer_blocks:
            h = blk(h, temb, cos, sin)
        x = h[:, s_txt:]
        t_out = _np(tm.proj_out(tm.norm_out(x, temb)))

    model = FluxTransformer2D(cfg, ip_adapter=True)
    ip_tokens = ImageProjection(ip_cfg).apply(
        proj_vars, jnp.asarray(image_embeds))
    np.testing.assert_allclose(
        np.asarray(ip_tokens), _np(tokens), rtol=5e-4, atol=5e-4)
    j_out = model.apply(
        merged,
        hidden_states=jnp.asarray(inp["hidden"]),
        encoder_hidden_states=jnp.asarray(inp["ctx"]),
        pooled_projections=jnp.asarray(inp["pooled"]),
        timestep=jnp.asarray(inp["t"]),
        img_ids=jnp.asarray(img_ids), txt_ids=jnp.asarray(txt_ids),
        guidance=jnp.asarray(inp["guidance"]),
        ip_tokens=ip_tokens, ip_scale=jnp.asarray(scale),
    )
    np.testing.assert_allclose(np.asarray(j_out), t_out, rtol=5e-4, atol=5e-4)
