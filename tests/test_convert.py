"""Weight-converter tests.

Structure: converted trees must match model.init trees leaf-for-leaf.
Numerics: CLIP/T5 converted from *real torch modules* (transformers, random
weights) must reproduce the torch forward outputs — this pins every layout
transpose and activation choice against the actual upstream implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig
from reptext.io.convert import (
    convert_clip,
    convert_controlnet,
    convert_flux_transformer,
    convert_t5,
    convert_vae,
)
from reptext.models import FluxTransformer2D, RepTextControlNet
from reptext.nn.clip import CLIPTextEncoder
from reptext.nn.t5 import T5Encoder
from reptext.nn.vae import AutoencoderKL
from reptext.ops.latents import prepare_latent_image_ids


def tree_paths_and_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for kp, v in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out[key] = tuple(v.shape)
    return out


def _torch_state_to_numpy(module):
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


# --------------------------------------------------------- structure checks


def _fake_state_for(shapes_needed):
    """Given {torch_name: shape}, build a random state dict."""
    r = np.random.default_rng(0)
    return {k: r.standard_normal(s).astype(np.float32) for k, s in shapes_needed.items()}


def test_flux_converter_structure():
    cfg = FluxConfig().tiny()
    model = FluxTransformer2D(cfg)
    img_ids = prepare_latent_image_ids(4, 4)
    init = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 4, cfg.in_channels)),
        jnp.zeros((1, 3, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)),
        jnp.zeros((1,)), img_ids, jnp.zeros((3, 3)), jnp.ones((1,)),
    )
    # build a torch-style state dict with exactly the shapes diffusers would have
    d = cfg.inner_dim
    state = {}
    def lin(name, i, o, bias=True):
        state[f"{name}.weight"] = np.zeros((o, i), np.float32)
        if bias:
            state[f"{name}.bias"] = np.zeros((o,), np.float32)
    lin("x_embedder", cfg.in_channels, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    for emb, width in [("timestep_embedder", cfg.time_embed_dim),
                       ("guidance_embedder", cfg.time_embed_dim),
                       ("text_embedder", cfg.pooled_projection_dim)]:
        lin(f"time_text_embed.{emb}.linear_1", width, d)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for nm in ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k", "norm_added_q", "norm_added_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"{p}.attn.to_out.0", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        lin(f"{p}.ff.net.0.proj", d, 4 * d)
        lin(f"{p}.ff.net.2", 4 * d, d)
        lin(f"{p}.ff_context.net.0.proj", d, 4 * d)
        lin(f"{p}.ff_context.net.2", 4 * d, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        lin(f"{p}.proj_mlp", d, 4 * d)
        lin(f"{p}.proj_out", 5 * d, d)
        for nm in ["to_q", "to_k", "to_v"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.out_channels)

    converted = convert_flux_transformer(state, cfg)
    assert tree_paths_and_shapes(converted) == tree_paths_and_shapes(init)


def test_vae_converter_structure():
    cfg = VAEConfig().tiny()
    vae = AutoencoderKL(cfg)
    init = vae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    ch = cfg.block_out_channels
    state = {}
    def conv(name, i, o, k=3):
        state[f"{name}.weight"] = np.zeros((o, i, k, k), np.float32)
        state[f"{name}.bias"] = np.zeros((o,), np.float32)
    def norm(name, c):
        state[f"{name}.weight"] = np.ones((c,), np.float32)
        state[f"{name}.bias"] = np.zeros((c,), np.float32)
    def resnet(prefix, i, o):
        norm(f"{prefix}.norm1", i); conv(f"{prefix}.conv1", i, o)
        norm(f"{prefix}.norm2", o); conv(f"{prefix}.conv2", o, o)
        if i != o:
            conv(f"{prefix}.conv_shortcut", i, o, 1)
    def attn(prefix, c):
        norm(f"{prefix}.group_norm", c)
        for nm in ["to_q", "to_k", "to_v", "to_out.0"]:
            state[f"{prefix}.{nm}.weight"] = np.zeros((c, c), np.float32)
            state[f"{prefix}.{nm}.bias"] = np.zeros((c,), np.float32)

    conv("encoder.conv_in", 3, ch[0])
    in_c = ch[0]
    for i, out_c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out_c, out_c)
        in_c = out_c
    resnet("encoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("encoder.mid_block.attentions.0", ch[-1])
    resnet("encoder.mid_block.resnets.1", ch[-1], ch[-1])
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", ch[-1], 2 * cfg.latent_channels)

    conv("decoder.conv_in", cfg.latent_channels, ch[-1])
    resnet("decoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("decoder.mid_block.attentions.0", ch[-1])
    resnet("decoder.mid_block.resnets.1", ch[-1], ch[-1])
    rev = list(reversed(ch))
    in_c = rev[0]
    for i, out_c in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
        in_c = out_c
    norm("decoder.conv_norm_out", ch[0])
    conv("decoder.conv_out", ch[0], 3)

    converted = convert_vae(state, cfg)
    assert tree_paths_and_shapes(converted) == tree_paths_and_shapes(init)


# ----------------------------------------------------- torch parity (CLIP/T5)


@pytest.mark.smoke
def test_clip_parity_with_transformers():
    torch = pytest.importorskip("torch")
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = CLIPConfig().tiny()
    hf_cfg = CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        hidden_act="quick_gelu", eos_token_id=cfg.eos_token_id,
        bos_token_id=0,
    )
    torch.manual_seed(0)
    hf = CLIPTextModel(hf_cfg).eval()
    state = _torch_state_to_numpy(hf)

    ids_np = np.array([[1, 17, 93, cfg.eos_token_id, 0, 0, 0, 0]], np.int64)
    with torch.no_grad():
        out = hf(torch.tensor(ids_np))
    want_hidden = out.last_hidden_state.numpy()
    want_pooled = out.pooler_output.numpy()

    ours = CLIPTextEncoder(cfg)
    params = convert_clip(state, cfg)
    got_hidden, got_pooled = ours.apply(params, jnp.asarray(ids_np, jnp.int32))
    np.testing.assert_allclose(np.asarray(got_hidden), want_hidden, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_pooled), want_pooled, rtol=2e-4, atol=2e-4)


def test_t5_parity_with_transformers():
    torch = pytest.importorskip("torch")
    from transformers import T5Config as HFT5Config, T5EncoderModel

    cfg = T5Config().tiny()
    hf_cfg = HFT5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
        d_ff=cfg.d_ff, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", dropout_rate=0.0,
    )
    torch.manual_seed(0)
    hf = T5EncoderModel(hf_cfg).eval()
    state = _torch_state_to_numpy(hf)

    ids_np = np.array([[3, 41, 99, 7, 1, 0]], np.int64)
    with torch.no_grad():
        want = hf(torch.tensor(ids_np)).last_hidden_state.numpy()

    ours = T5Encoder(cfg)
    params = convert_t5(state, cfg)
    got = ours.apply(params, jnp.asarray(ids_np, jnp.int32))
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_controlnet_converter_structure():
    cfg = ControlNetConfig().tiny()
    model = RepTextControlNet(cfg)
    img_ids = prepare_latent_image_ids(4, 4)
    init = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 4, cfg.in_channels)),
        jnp.zeros((1, 4, cfg.in_channels + cfg.extra_condition_channels)),
        jnp.zeros((1, 3, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)),
        jnp.zeros((1,)), img_ids, jnp.zeros((3, 3)), jnp.ones((1,)),
    )
    d = cfg.inner_dim
    state = {}
    def lin(name, i, o):
        state[f"{name}.weight"] = np.zeros((o, i), np.float32)
        state[f"{name}.bias"] = np.zeros((o,), np.float32)
    lin("x_embedder", cfg.in_channels, d)
    lin("controlnet_x_embedder", cfg.in_channels + cfg.extra_condition_channels, d)
    lin("context_embedder", cfg.joint_attention_dim, d)
    for emb, width in [("timestep_embedder", cfg.time_embed_dim),
                       ("guidance_embedder", cfg.time_embed_dim),
                       ("text_embedder", cfg.pooled_projection_dim)]:
        lin(f"time_text_embed.{emb}.linear_1", width, d)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for nm in ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k", "norm_added_q", "norm_added_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"{p}.attn.to_out.0", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        lin(f"{p}.ff.net.0.proj", d, 4 * d)
        lin(f"{p}.ff.net.2", 4 * d, d)
        lin(f"{p}.ff_context.net.0.proj", d, 4 * d)
        lin(f"{p}.ff_context.net.2", 4 * d, d)
        lin(f"controlnet_blocks.{i}", d, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        lin(f"{p}.proj_mlp", d, 4 * d)
        lin(f"{p}.proj_out", 5 * d, d)
        for nm in ["to_q", "to_k", "to_v"]:
            lin(f"{p}.attn.{nm}", d, d)
        for nm in ["norm_q", "norm_k"]:
            state[f"{p}.attn.{nm}.weight"] = np.ones((cfg.attention_head_dim,), np.float32)
        lin(f"controlnet_single_blocks.{i}", d, d)

    converted = convert_controlnet(state, cfg)
    assert tree_paths_and_shapes(converted) == tree_paths_and_shapes(init)
