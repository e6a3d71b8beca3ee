"""Orbax checkpoint save/load roundtrip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.io.checkpoint import load_pipeline_params, save_pipeline_params


def test_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    params = {
        "flux": {"params": {"x_embedder": {"kernel": jnp.arange(6.0).reshape(2, 3),
                                           "bias": jnp.zeros((3,))}}},
        "vae": {"params": {"encoder": {"conv_in": {"kernel": jnp.ones((3, 3, 3, 8))}}}},
    }
    save_pipeline_params(params, str(tmp_path / "ckpt"))
    loaded = load_pipeline_params(str(tmp_path / "ckpt"))
    assert set(loaded) == {"flux", "vae"}
    np.testing.assert_array_equal(
        np.asarray(loaded["flux"]["params"]["x_embedder"]["kernel"]),
        np.arange(6.0).reshape(2, 3),
    )
    np.testing.assert_array_equal(
        np.asarray(loaded["vae"]["params"]["encoder"]["conv_in"]["kernel"]),
        np.ones((3, 3, 3, 8)),
    )


def test_load_missing_raises(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    with pytest.raises(FileNotFoundError):
        load_pipeline_params(str(tmp_path / "nothing"))


def test_layout_version_written_and_checked(tmp_path):
    """Pre-RoPE-fold (v1) checkpoints must fail loudly, not load silently."""
    pytest.importorskip("orbax.checkpoint")
    from reptext.io.checkpoint import (
        LAYOUT_VERSION, checkpoint_layout_version)

    params = {"flux": {"params": {"w": jnp.ones((2, 2))}}}
    ckpt = tmp_path / "ckpt"
    save_pipeline_params(params, str(ckpt))
    assert checkpoint_layout_version(str(ckpt)) == LAYOUT_VERSION
    load_pipeline_params(str(ckpt))  # current layout loads fine

    # Simulate a legacy cache converted before the permutation fold: the
    # marker is absent -> version 1 -> refuse to load.
    (ckpt / "LAYOUT_VERSION").unlink()
    assert checkpoint_layout_version(str(ckpt)) == 1
    with pytest.raises(ValueError, match="layout v1"):
        load_pipeline_params(str(ckpt))
