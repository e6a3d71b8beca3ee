"""Activation capture/diff harness tests (self-referential)."""

import pytest

# heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from reptext.configs import FluxConfig
from reptext.io.verify_activations import (
    capture_activations,
    diff_activations,
    load_activations,
    save_activations,
)
from reptext.models import FluxTransformer2D
from reptext.ops.latents import prepare_latent_image_ids

CFG = FluxConfig().tiny()


def _setup():
    model = FluxTransformer2D(CFG)
    img_ids = prepare_latent_image_ids(4, 4)
    inputs = (
        jnp.ones((1, 4, CFG.in_channels)),
        jnp.ones((1, 3, CFG.joint_attention_dim)),
        jnp.ones((1, CFG.pooled_projection_dim)),
        jnp.full((1,), 0.5),
        img_ids,
        jnp.zeros((3, 3)),
        jnp.ones((1,)),
    )
    params = model.init(jax.random.PRNGKey(0), *inputs)
    return model, params, inputs


def test_capture_has_block_outputs():
    model, params, inputs = _setup()
    acts = capture_activations(model, params, *inputs)
    assert any("x_embedder" in k for k in acts)
    assert any("double_blocks" in k for k in acts)
    assert any("norm_out" in k for k in acts)


def test_diff_self_is_zero_and_roundtrip(tmp_path):
    model, params, inputs = _setup()
    acts = capture_activations(model, params, *inputs)
    save_activations(acts, str(tmp_path / "acts.npz"))
    loaded = load_activations(str(tmp_path / "acts.npz"))
    report = diff_activations(acts, loaded)
    assert max(r[1] for r in report) == 0.0


def test_diff_flags_perturbed_layer():
    model, params, inputs = _setup()
    acts = capture_activations(model, params, *inputs)
    p2 = jax.tree_util.tree_map(lambda x: x, params)
    kern = np.array(p2["params"]["proj_out"]["kernel"])
    kern += 0.5
    p2["params"]["proj_out"]["kernel"] = jnp.asarray(kern)
    acts2 = capture_activations(model, p2, *inputs)
    report = diff_activations(acts2, acts)
    worst = report[0]
    assert worst[1] > 0.0
    # the perturbed projection (or its downstream output) must rank worst
    assert "proj_out" in worst[0] or worst[0] == "__call__" or "norm_out" not in worst[0]
