"""LoRA conversion/merge tests against the scanned param layout."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

# heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import FluxConfig
from reptext.io.lora import apply_lora, parse_lora_state
from reptext.models import FluxTransformer2D
from reptext.ops.latents import prepare_latent_image_ids

CFG = FluxConfig().tiny()
D = CFG.inner_dim
R = 4  # lora rank


def _params():
    model = FluxTransformer2D(CFG)
    img_ids = prepare_latent_image_ids(4, 4)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 4, CFG.in_channels)),
        jnp.zeros((1, 3, CFG.joint_attention_dim)),
        jnp.zeros((1, CFG.pooled_projection_dim)),
        jnp.zeros((1,)), img_ids, jnp.zeros((3, 3)), jnp.ones((1,)),
    )
    return model, params, img_ids


def _lora_state():
    r = np.random.default_rng(0)
    state = {}
    # layer 1 double to_q + top-level proj_out
    state["transformer.transformer_blocks.1.attn.to_q.lora_A.weight"] = (
        r.standard_normal((R, D)).astype(np.float32))
    state["transformer.transformer_blocks.1.attn.to_q.lora_B.weight"] = (
        r.standard_normal((D, R)).astype(np.float32))
    state["transformer.single_transformer_blocks.0.proj_mlp.lora_A.weight"] = (
        r.standard_normal((R, D)).astype(np.float32))
    state["transformer.single_transformer_blocks.0.proj_mlp.lora_B.weight"] = (
        r.standard_normal((4 * D, R)).astype(np.float32))
    return state


def test_parse_groups_pairs():
    grouped = parse_lora_state(_lora_state())
    assert ("double_blocks", "block", "to_q") in grouped
    assert 1 in grouped[("double_blocks", "block", "to_q")]
    a, b = grouped[("double_blocks", "block", "to_q")][1]
    assert a.shape == (R, D) and b.shape == (D, R)


def test_apply_lora_changes_only_target_layer():
    _, params, _ = _params()
    state = _lora_state()
    hd = CFG.attention_head_dim
    merged = apply_lora(params, state, scale=1.0, head_dim=hd)

    base_k = np.asarray(params["params"]["double_blocks"]["block"]["to_q"]["kernel"])
    new_k = np.asarray(merged["params"]["double_blocks"]["block"]["to_q"]["kernel"])
    # layer 1 changed by exactly (B@A)^T with the RoPE half-split channel
    # permutation applied (q/k kernels live in half-split order,
    # io/convert.py::_lin_rope)
    a = state["transformer.transformer_blocks.1.attn.to_q.lora_A.weight"]
    b = state["transformer.transformer_blocks.1.attn.to_q.lora_B.weight"]
    delta = (b @ a).T
    perm = np.concatenate([np.arange(0, hd, 2), np.arange(1, hd, 2)])
    in_dim, out_dim = delta.shape
    delta = delta.reshape(in_dim, out_dim // hd, hd)[:, :, perm].reshape(
        in_dim, out_dim)
    np.testing.assert_allclose(new_k[1] - base_k[1], delta, rtol=1e-5, atol=1e-5)
    # layer 0 untouched
    np.testing.assert_array_equal(new_k[0], base_k[0])
    # unrelated module untouched
    np.testing.assert_array_equal(
        np.asarray(merged["params"]["x_embedder"]["kernel"]),
        np.asarray(params["params"]["x_embedder"]["kernel"]),
    )


def test_apply_lora_scale_linear():
    _, params, _ = _params()
    state = _lora_state()
    m1 = apply_lora(params, state, scale=1.0)
    m2 = apply_lora(params, state, scale=0.5)
    base = np.asarray(params["params"]["single_blocks"]["block"]["proj_mlp"]["kernel"])
    d1 = np.asarray(m1["params"]["single_blocks"]["block"]["proj_mlp"]["kernel"]) - base
    d2 = np.asarray(m2["params"]["single_blocks"]["block"]["proj_mlp"]["kernel"]) - base
    np.testing.assert_allclose(d2, 0.5 * d1, rtol=1e-5, atol=1e-6)


def test_apply_lora_model_output_changes():
    model, params, img_ids = _params()
    inputs = dict(
        hidden_states=jnp.ones((1, 4, CFG.in_channels)),
        encoder_hidden_states=jnp.ones((1, 3, CFG.joint_attention_dim)),
        pooled_projections=jnp.ones((1, CFG.pooled_projection_dim)),
        timestep=jnp.full((1,), 0.5),
        img_ids=img_ids, txt_ids=jnp.zeros((3, 3)), guidance=jnp.ones((1,)),
    )
    base_out = np.asarray(model.apply(params, **inputs))
    merged = apply_lora(params, _lora_state(), scale=0.1)
    lora_out = np.asarray(model.apply(merged, **inputs))
    assert np.abs(lora_out - base_out).max() > 1e-5


def test_unknown_module_raises():
    bad = {"transformer.bogus_module.lora_A.weight": np.zeros((2, 2), np.float32),
           "transformer.bogus_module.lora_B.weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        parse_lora_state(bad)
