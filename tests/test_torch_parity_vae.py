"""WHOLE-VAE numerical parity vs a hand-written torch reference.

Completes the converter-parity surface (tests/test_torch_parity_model.py
covers FLUX+ControlNet whole-model; blocks are covered in
test_torch_parity_blocks.py): the full diffusers AutoencoderKL encoder and
decoder forwards written out in torch with exact state-dict naming
(the reference loads this VAE via diffusers from_pretrained,
RepText/pipeline_flux_controlnet.py:7-31), converted through the REAL
io/convert.py::convert_vae, and compared against nn/vae.py end to end —
pinning the down/up block ordering, channel flow, asymmetric downsample
padding, nearest-upsample placement, and mid-block wiring in composition.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
nn = torch.nn

from test_torch_parity_blocks import TResnetBlock, TVaeAttn, _randomize  # noqa: E402

from reptext.configs import VAEConfig  # noqa: E402
from reptext.io.convert import convert_vae  # noqa: E402
from reptext.nn.vae import Decoder, Encoder  # noqa: E402

CFG = dataclasses.replace(
    VAEConfig().tiny(),
    block_out_channels=(8, 12, 16),
    latent_channels=4,
    layers_per_block=1,
    norm_num_groups=4,
)


class TDownBlock(nn.Module):
    """diffusers DownEncoderBlock2D: resnets + optional downsamplers."""

    def __init__(self, in_ch, out_ch, layers, groups, add_down):
        super().__init__()
        self.resnets = nn.ModuleList(
            [TResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups)
             for j in range(layers)]
        )
        if add_down:
            down = nn.Module()
            down.conv = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=0)
            self.downsamplers = nn.ModuleList([down])
        else:
            self.downsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = nn.functional.pad(x, (0, 1, 0, 1))
            x = self.downsamplers[0].conv(x)
        return x


class TUpBlock(nn.Module):
    """diffusers UpDecoderBlock2D: resnets + optional nearest-up + conv."""

    def __init__(self, in_ch, out_ch, layers, groups, add_up):
        super().__init__()
        self.resnets = nn.ModuleList(
            [TResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups)
             for j in range(layers)]
        )
        if add_up:
            up = nn.Module()
            up.conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
            self.upsamplers = nn.ModuleList([up])
        else:
            self.upsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = nn.functional.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class TMidBlock(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList(
            [TResnetBlock(ch, ch, groups), TResnetBlock(ch, ch, groups)]
        )
        self.attentions = nn.ModuleList([TVaeAttn(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class TVAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, in_ch = [], ch[0]
        for i, out_ch in enumerate(ch):
            blocks.append(TDownBlock(in_ch, out_ch, cfg.layers_per_block,
                                     cfg.norm_num_groups, i < len(ch) - 1))
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = TMidBlock(ch[-1], cfg.norm_num_groups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        x = self.mid_block(x)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(x)))


class TVAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[-1], 3, padding=1)
        self.mid_block = TMidBlock(ch[-1], cfg.norm_num_groups)
        blocks, in_ch = [], ch[-1]
        rev = list(reversed(ch))
        for i, out_ch in enumerate(rev):
            blocks.append(TUpBlock(in_ch, out_ch, cfg.layers_per_block + 1,
                                   cfg.norm_num_groups, i < len(ch) - 1))
            in_ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x)
        for b in self.up_blocks:
            x = b(x)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(x)))


def _merged_state(encoder, decoder):
    state = {f"encoder.{k}": v.detach().numpy().astype(np.float32)
             for k, v in encoder.state_dict().items()}
    state.update({f"decoder.{k}": v.detach().numpy().astype(np.float32)
                  for k, v in decoder.state_dict().items()})
    return state


@pytest.fixture(scope="module")
def vae_pair():
    enc = _randomize(TVAEEncoder(CFG), seed=20)
    dec = _randomize(TVAEDecoder(CFG), seed=21)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_vae(_merged_state(enc, dec), CFG))
    return enc, dec, params


def test_full_encoder_parity(vae_pair):
    enc, _, params = vae_pair
    r = np.random.default_rng(22)
    x = r.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        want = enc(torch.tensor(x)).numpy()
    got = Encoder(CFG).apply(
        {"params": params["params"]["encoder"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want, rtol=5e-4, atol=5e-4)


def test_full_decoder_parity(vae_pair):
    _, dec, params = vae_pair
    r = np.random.default_rng(23)
    z = r.standard_normal((2, CFG.latent_channels, 4, 4)).astype(np.float32)
    with torch.no_grad():
        want = dec(torch.tensor(z)).numpy()
    got = Decoder(CFG).apply(
        {"params": params["params"]["decoder"]},
        jnp.asarray(z.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want, rtol=5e-4, atol=5e-4)
