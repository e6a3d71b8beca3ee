"""VAE / CLIP / T5 encoder tests at tiny config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import CLIPConfig, T5Config, VAEConfig
from reptext.nn.clip import CLIPTextEncoder
from reptext.nn.t5 import T5Encoder, relative_position_bucket
from reptext.nn.vae import AutoencoderKL

VAE_CFG = VAEConfig().tiny()


@pytest.fixture(scope="module")
def vae_and_params():
    vae = AutoencoderKL(VAE_CFG)
    params = vae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return vae, params


def test_vae_encode_shapes(vae_and_params):
    vae, params = vae_and_params
    img = jnp.zeros((2, 32, 32, 3))
    lat = vae.apply(params, img, method="encode")  # mode (no rng)
    assert lat.shape == (2, 4, 4, VAE_CFG.latent_channels)


def test_vae_decode_shapes(vae_and_params):
    vae, params = vae_and_params
    z = jnp.zeros((1, 4, 4, VAE_CFG.latent_channels))
    img = vae.apply(params, z, method="decode")
    assert img.shape == (1, 32, 32, 3)


@pytest.mark.smoke
def test_vae_sample_vs_mode(vae_and_params):
    vae, params = vae_and_params
    img = jnp.ones((1, 32, 32, 3)) * 0.5
    mode = vae.apply(params, img, method="encode")
    s1 = vae.apply(params, img, jax.random.PRNGKey(1), method="encode")
    s2 = vae.apply(params, img, jax.random.PRNGKey(2), method="encode")
    assert np.abs(np.asarray(s1 - mode)).max() > 0
    assert np.abs(np.asarray(s1 - s2)).max() > 0


def test_clip_shapes_and_pooled():
    cfg = CLIPConfig().tiny()
    model = CLIPTextEncoder(cfg)
    # eos (max id) at position 3
    ids = jnp.asarray([[5, 10, 20, cfg.eos_token_id, 0, 0, 0, 0]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids)
    hidden, pooled = model.apply(params, ids)
    assert hidden.shape == (1, 8, cfg.hidden_size)
    assert pooled.shape == (1, cfg.hidden_size)
    # pooled equals the hidden state at the eos position
    np.testing.assert_allclose(np.asarray(pooled[0]), np.asarray(hidden[0, 3]))


def test_clip_causality():
    cfg = CLIPConfig().tiny()
    model = CLIPTextEncoder(cfg)
    ids1 = jnp.asarray([[5, 10, 20, 30, 40, 50, 60, 70]], jnp.int32)
    ids2 = jnp.asarray([[5, 10, 20, 30, 99, 99, 99, 99]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids1)
    h1, _ = model.apply(params, ids1)
    h2, _ = model.apply(params, ids2)
    # positions before the first difference must be identical (causal mask)
    np.testing.assert_allclose(np.asarray(h1[0, :4]), np.asarray(h2[0, :4]), atol=1e-6)
    assert np.abs(np.asarray(h1[0, 4:] - h2[0, 4:])).max() > 1e-4


def test_t5_shapes():
    cfg = T5Config().tiny()
    model = T5Encoder(cfg)
    ids = jnp.asarray([[3, 7, 11, 2, 0, 0]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids)
    out = model.apply(params, ids)
    assert out.shape == (1, 6, cfg.d_model)
    assert np.isfinite(np.asarray(out)).all()


def test_t5_relative_buckets():
    rel = jnp.asarray([[-130, -64, -3, 0, 3, 64, 130]])
    buckets = np.asarray(relative_position_bucket(rel, 32, 128))[0]
    assert buckets[3] == 0                      # zero distance
    assert buckets[4] == 16 + 3                 # small positive: offset 16 + exact
    assert buckets[2] == 3                      # small negative: exact, no offset
    assert buckets[0] <= 15 and buckets[-1] <= 31  # clipped at extremes
    # monotonic in distance on each side
    assert buckets[5] > buckets[4]
    assert buckets[1] > buckets[2]
