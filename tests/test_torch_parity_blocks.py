"""FLUX-block + VAE-block numerical parity vs hand-written torch references.

The reference composes its model from diffusers blocks
(RepText/controlnet_flux.py:29 imports FluxTransformerBlock /
FluxSingleTransformerBlock; the VAE comes from diffusers AutoencoderKL).
diffusers is not installed here, so the torch side is written out below from
the documented semantics (SURVEY.md §2.2) with diffusers' state-dict naming —
which pins both the math AND every converter layout transpose
(io/convert.py::_double_block/_single_block/_resnet/_vae_attn) against a real
torch forward pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import VAEConfig
from reptext.io.convert import _double_block, _resnet, _single_block, _vae_attn
from reptext.nn.blocks import JointTransformerBlock, SingleTransformerBlock
from reptext.nn.vae import AttnBlock, ResnetBlock
from reptext.ops.rope import rope_cos_sin, rope_cos_sin_half

torch = pytest.importorskip("torch")
nn = torch.nn

DIM, HEADS, HEAD_DIM = 64, 4, 16


# ------------------------------------------------------- torch reference side


class TRMSNorm(nn.Module):
    """diffusers RMSNorm (eps 1e-6, learned weight, fp32 variance)."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


class TAdaLNZero(nn.Module):
    """AdaLayerNormZero: silu(temb) -> linear -> 6 chunks; LN without affine."""

    def __init__(self, dim):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)
        self.norm = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)

    def forward(self, x, temb):
        emb = self.linear(nn.functional.silu(temb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        out = self.norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return out, gate_msa, shift_mlp, scale_mlp, gate_mlp


class TAdaLNZeroSingle(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim)
        self.norm = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)

    def forward(self, x, temb):
        emb = self.linear(nn.functional.silu(temb))
        shift_msa, scale_msa, gate_msa = emb.chunk(3, dim=-1)
        return self.norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None], gate_msa


class TActProj(nn.Module):
    """diffusers GELU(approximate='tanh') wrapper: .proj then act."""

    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return nn.functional.gelu(self.proj(x), approximate="tanh")


class TFeedForward(nn.Module):
    """diffusers FeedForward: net.0.proj (gelu-tanh), net.1 dropout, net.2 linear."""

    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList(
            [TActProj(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


def t_apply_rope(x, cos, sin):
    """diffusers apply_rotary_emb(use_real=True, use_real_unbind_dim=-1).

    x: [B, H, S, D]; cos/sin: [S, D] (values repeated in interleaved pairs).
    """
    x_real, x_imag = x.float().reshape(*x.shape[:-1], -1, 2).unbind(-1)
    x_rot = torch.stack([-x_imag, x_real], dim=-1).flatten(3)
    return (x.float() * cos + x_rot * sin).to(x.dtype)


def _split_heads(x, heads):
    b, s, _ = x.shape
    return x.view(b, s, heads, -1).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class TAttnOut(nn.Module):
    """to_out as ModuleList so the state dict has attn.to_out.0.*."""

    def __init__(self, dim):
        super().__init__()
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])


class TDoubleAttn(nn.Module):
    def __init__(self, dim, heads, head_dim):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, nm, nn.Linear(dim, inner))
        self.norm_q = TRMSNorm(head_dim)
        self.norm_k = TRMSNorm(head_dim)
        self.norm_added_q = TRMSNorm(head_dim)
        self.norm_added_k = TRMSNorm(head_dim)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        self.to_add_out = nn.Linear(inner, dim)

    def forward(self, img, txt, cos, sin):
        q_i = self.norm_q(_split_heads(self.to_q(img), self.heads))
        k_i = self.norm_k(_split_heads(self.to_k(img), self.heads))
        v_i = _split_heads(self.to_v(img), self.heads)
        q_t = self.norm_added_q(_split_heads(self.add_q_proj(txt), self.heads))
        k_t = self.norm_added_k(_split_heads(self.add_k_proj(txt), self.heads))
        v_t = _split_heads(self.add_v_proj(txt), self.heads)
        q = t_apply_rope(torch.cat([q_t, q_i], dim=2), cos, sin)
        k = t_apply_rope(torch.cat([k_t, k_i], dim=2), cos, sin)
        v = torch.cat([v_t, v_i], dim=2)
        attn = _merge_heads(nn.functional.scaled_dot_product_attention(q, k, v))
        s_txt = txt.shape[1]
        return self.to_out[0](attn[:, s_txt:]), self.to_add_out(attn[:, :s_txt])


class TFluxDoubleBlock(nn.Module):
    """diffusers FluxTransformerBlock semantics + state-dict naming."""

    def __init__(self, dim, heads, head_dim):
        super().__init__()
        self.norm1 = TAdaLNZero(dim)
        self.norm1_context = TAdaLNZero(dim)
        self.attn = TDoubleAttn(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.norm2_context = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.ff = TFeedForward(dim)
        self.ff_context = TFeedForward(dim)

    def forward(self, img, txt, temb, cos, sin):
        n_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(img, temb)
        n_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(txt, temb)
        attn_img, attn_txt = self.attn(n_img, n_txt, cos, sin)

        img = img + gate_msa[:, None] * attn_img
        h = self.norm2(img) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        img = img + gate_mlp[:, None] * self.ff(h)

        txt = txt + c_gate_msa[:, None] * attn_txt
        hc = self.norm2_context(txt) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        txt = txt + c_gate_mlp[:, None] * self.ff_context(hc)
        return txt, img


class TSingleAttn(nn.Module):
    def __init__(self, dim, heads, head_dim):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.norm_q = TRMSNorm(head_dim)
        self.norm_k = TRMSNorm(head_dim)

    def forward(self, x, cos, sin):
        q = t_apply_rope(self.norm_q(_split_heads(self.to_q(x), self.heads)), cos, sin)
        k = t_apply_rope(self.norm_k(_split_heads(self.to_k(x), self.heads)), cos, sin)
        v = _split_heads(self.to_v(x), self.heads)
        return _merge_heads(nn.functional.scaled_dot_product_attention(q, k, v))


class TFluxSingleBlock(nn.Module):
    """diffusers FluxSingleTransformerBlock semantics + naming."""

    def __init__(self, dim, heads, head_dim, mlp_ratio=4):
        super().__init__()
        self.norm = TAdaLNZeroSingle(dim)
        self.proj_mlp = nn.Linear(dim, dim * mlp_ratio)
        self.proj_out = nn.Linear(dim + dim * mlp_ratio + (heads * head_dim - dim), dim)
        self.attn = TSingleAttn(dim, heads, head_dim)

    def forward(self, x, temb, cos, sin):
        residual = x
        normed, gate = self.norm(x, temb)
        mlp = nn.functional.gelu(self.proj_mlp(normed), approximate="tanh")
        attn = self.attn(normed, cos, sin)
        return residual + gate[:, None] * self.proj_out(torch.cat([attn, mlp], dim=-1))


class TResnetBlock(nn.Module):
    """diffusers ResnetBlock2D (silu, eps 1e-6, output_scale_factor 1)."""

    def __init__(self, in_ch, out_ch, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(nn.functional.silu(self.norm1(x)))
        h = self.conv2(nn.functional.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TVaeAttn(nn.Module):
    """diffusers Attention as used in the VAE mid block (1 head, residual)."""

    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.group_norm(x).view(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(hid), self.to_k(hid), self.to_v(hid)
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1) @ v
        out = self.to_out[0](attn).transpose(1, 2).view(b, c, h, w)
        return x + out


# ------------------------------------------------------------------ fixtures


def _randomize(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn_like(p) * 0.08)
    return module.eval()


def _state_np(module, prefix):
    return {f"{prefix}.{k}": v.detach().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


def _rope_tables(s_txt, s_img):
    """Mixed zero/nonzero 3-axis ids at head_dim 16 -> (cos, sin) [S, 16]."""
    ids = np.zeros((s_txt + s_img, 3), np.float32)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(s_img // 4), indexing="ij"), -1)
    ids[s_txt:, 1:] = grid.reshape(-1, 2)
    cos, sin = rope_cos_sin(jnp.asarray(ids), (4, 6, 6))
    cos_h, sin_h = rope_cos_sin_half(jnp.asarray(ids), (4, 6, 6))
    # torch side rotates interleaved; the JAX blocks take half-split tables
    # (the converter folds the matching channel permutation into q/k weights)
    return (np.asarray(cos), np.asarray(sin),
            np.asarray(cos_h), np.asarray(sin_h))


def test_double_block_parity():
    tblock = _randomize(TFluxDoubleBlock(DIM, HEADS, HEAD_DIM), seed=0)
    state = _state_np(tblock, "transformer_blocks.0")
    params = {"params": jax.tree_util.tree_map(jnp.asarray,
                                               _double_block(state, "transformer_blocks.0", HEAD_DIM))}

    r = np.random.default_rng(1)
    b, s_txt, s_img = 2, 6, 16
    img = r.standard_normal((b, s_img, DIM)).astype(np.float32)
    txt = r.standard_normal((b, s_txt, DIM)).astype(np.float32)
    temb = r.standard_normal((b, DIM)).astype(np.float32)
    cos, sin, cos_h, sin_h = _rope_tables(s_txt, s_img)

    with torch.no_grad():
        want_txt, want_img = tblock(
            torch.tensor(img), torch.tensor(txt), torch.tensor(temb),
            torch.tensor(cos), torch.tensor(sin))

    block = JointTransformerBlock(dim=DIM, num_heads=HEADS, head_dim=HEAD_DIM,
                                  attention_backend="xla")
    got_txt, got_img = block.apply(
        params, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(temb),
        jnp.asarray(cos_h), jnp.asarray(sin_h))
    np.testing.assert_allclose(np.asarray(got_img), want_img.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_txt), want_txt.numpy(), rtol=2e-4, atol=2e-4)


def test_single_block_parity():
    tblock = _randomize(TFluxSingleBlock(DIM, HEADS, HEAD_DIM), seed=2)
    state = _state_np(tblock, "single_transformer_blocks.0")
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, _single_block(state, "single_transformer_blocks.0", HEAD_DIM))}

    r = np.random.default_rng(3)
    b, s = 2, 20
    x = r.standard_normal((b, s, DIM)).astype(np.float32)
    temb = r.standard_normal((b, DIM)).astype(np.float32)
    cos, sin, cos_h, sin_h = _rope_tables(4, s - 4)

    with torch.no_grad():
        want = tblock(torch.tensor(x), torch.tensor(temb),
                      torch.tensor(cos), torch.tensor(sin))

    block = SingleTransformerBlock(dim=DIM, num_heads=HEADS, head_dim=HEAD_DIM,
                                   attention_backend="xla")
    got = block.apply(params, jnp.asarray(x), jnp.asarray(temb),
                      jnp.asarray(cos_h), jnp.asarray(sin_h))
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("in_ch,out_ch", [(8, 8), (8, 16)])
def test_vae_resnet_parity(in_ch, out_ch):
    tblock = _randomize(TResnetBlock(in_ch, out_ch, groups=4), seed=4)
    state = _state_np(tblock, "r")
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, _resnet(state, "r", in_ch != out_ch))}

    r = np.random.default_rng(5)
    x = r.standard_normal((2, in_ch, 8, 8)).astype(np.float32)
    with torch.no_grad():
        want = tblock(torch.tensor(x)).numpy()

    block = ResnetBlock(out_channels=out_ch, norm_num_groups=4)
    got = block.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want, rtol=2e-4, atol=2e-4)


def test_vae_attn_parity():
    ch = 16
    tblock = _randomize(TVaeAttn(ch, groups=4), seed=6)
    state = _state_np(tblock, "a")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, _vae_attn(state, "a"))}

    r = np.random.default_rng(7)
    x = r.standard_normal((2, ch, 6, 6)).astype(np.float32)
    with torch.no_grad():
        want = tblock(torch.tensor(x)).numpy()

    block = AttnBlock(channels=ch, norm_num_groups=4)
    got = block.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want, rtol=2e-4, atol=2e-4)


def test_vae_downsample_parity():
    """diffusers Downsample2D: pad (0,1,0,1) + stride-2 VALID conv — pins the
    encoder's asymmetric-pad choice (nn/vae.py Encoder)."""
    torch.manual_seed(8)
    conv = nn.Conv2d(8, 8, 3, stride=2, padding=0).eval()
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    r = np.random.default_rng(9)
    x = r.standard_normal((1, 8, 8, 8)).astype(np.float32)
    with torch.no_grad():
        want = conv(nn.functional.pad(torch.tensor(x), (0, 1, 0, 1))).numpy()

    kernel = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
    xn = jnp.pad(jnp.asarray(x.transpose(0, 2, 3, 1)), ((0, 0), (0, 1), (0, 1), (0, 0)))
    got = jax.lax.conv_general_dilated(
        xn, jnp.asarray(kernel), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + conv.bias.detach().numpy()
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want, rtol=1e-4, atol=1e-4)
