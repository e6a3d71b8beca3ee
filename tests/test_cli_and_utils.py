"""CLI argument handling, prompt building, image utils, profiling utils."""

import numpy as np
import pytest

from reptext.cli import build_prompt, contains_cjk
from reptext.utils.image import postprocess_images, preprocess_images
from reptext.utils.profiling import StepTimer


def test_contains_cjk():
    assert contains_cjk("哩布")
    assert not contains_cjk("Shakker")
    assert not contains_cjk("مرحبا")


def test_build_prompt_quotes_non_cjk():
    p = build_prompt("a street sign", ["哩布", "Hello", "مرحبا"], ", film")
    assert "'Hello'" in p
    assert "'مرحبا'" in p       # Arabic is quoted (not CJK)
    assert "哩布" not in p       # CJK not quoted into prompt
    assert p.endswith(", film")


def test_preprocess_postprocess_roundtrip():
    img = np.random.default_rng(0).integers(0, 255, (2, 8, 8, 3), np.uint8)
    x = preprocess_images(img)
    assert x.shape == (2, 8, 8, 3)
    assert x.min() >= -1.0 and x.max() <= 1.0
    back = postprocess_images(x)
    np.testing.assert_array_equal(back, img)


def test_preprocess_single_image_adds_batch():
    img = np.zeros((8, 8, 3), np.uint8)
    assert preprocess_images(img).shape == (1, 8, 8, 3)


def test_postprocess_clamps():
    x = np.asarray([[[[2.0, -2.0, 0.0]]]])
    out = postprocess_images(x)
    assert out[0, 0, 0].tolist() == [255, 0, 128]


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_postprocess_refuses_non_finite(bad):
    x = np.zeros((1, 2, 2, 3), np.float32)
    x[0, 1, 1, 2] = bad
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        postprocess_images(x)


def test_step_timer():
    timer = StepTimer(warmup=1)
    for _ in range(4):
        with timer.step():
            pass
    s = timer.summary()
    assert s["steps"] == 3
    assert s["mean_s"] >= 0


def test_cli_argument_validation():
    from reptext.cli import main
    with pytest.raises(SystemExit):
        main(["--text", "a", "--position", "1", "2", "--position", "3", "4"])
    with pytest.raises(SystemExit):  # no weights source
        main(["--text", "a", "--position", "1", "2"])
    with pytest.raises(SystemExit):  # malformed --shard
        main(["--text", "a", "--position", "1", "2", "--random-weights",
              "--tiny", "--shard", "2by4"])


@pytest.mark.slow
def test_cli_sp_inpaint_generation(tmp_path):
    """End-to-end CLI inpaint with --shard sp8: the sequence-parallel dual-CN
    CFG sampler runs on the 8-device CPU mesh and writes an image."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import numpy as np
    from PIL import Image

    from reptext.cli import main

    img = tmp_path / "in.png"
    msk = tmp_path / "mask.png"
    Image.fromarray(
        np.random.default_rng(0).integers(60, 200, (64, 64, 3)).astype(np.uint8)
    ).save(img)
    m = np.zeros((64, 64), np.uint8)
    m[16:48, 16:48] = 255
    Image.fromarray(m).save(msk)
    out = tmp_path / "out.png"
    rc = main(["--compile-cache", "off",
        "--mode", "inpaint", "--tiny", "--random-weights",
        "--image", str(img), "--mask", str(msk),
        "--text", "Hi", "--position", "20", "24", "--steps", "2",
        "--font-size", "24", "--shard", "sp8", "--output", str(out),
    ])
    assert rc == 0 and out.exists() and out.stat().st_size > 0


@pytest.mark.slow
def test_cli_sharded_generation(tmp_path):
    """End-to-end CLI txt2img with --shard 2x4: the sharded sampler runs on
    the 8-device CPU mesh and writes an image."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from reptext.cli import main

    out = tmp_path / "out.png"
    rc = main(["--compile-cache", "off",
        "--text", "Hi", "--position", "8", "16", "--tiny", "--random-weights",
        "--size", "64", "--steps", "2", "--controlnet-step", "1",
        "--font-size", "24", "--shard", "2x4", "--output", str(out),
    ])
    assert rc == 0 and out.exists() and out.stat().st_size > 0


@pytest.mark.slow
def test_cli_num_images(tmp_path):
    """--num-images N: one batched sampler call, siblings saved with a
    _K suffix next to --output."""
    from reptext.cli import main

    out = tmp_path / "multi.png"
    rc = main(["--compile-cache", "off",
        "--text", "Hi", "--position", "8", "16", "--tiny", "--random-weights",
        "--size", "64", "--steps", "2", "--controlnet-step", "1",
        "--font-size", "24", "--num-images", "2", "--output", str(out),
    ])
    sib = tmp_path / "multi_1.png"
    assert rc == 0 and out.exists() and sib.exists()
    assert sib.stat().st_size > 0


def test_compile_cache_toggle(tmp_path, monkeypatch):
    """utils/compile_cache: off (``--compile-cache off``) leaves JAX's setting
    alone; on turns the persistent cache on at the chosen directory."""
    import jax

    from reptext.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla_cache"))
    assert compile_cache.enable_compile_cache(False) is None
    assert jax.config.jax_compilation_cache_dir == before
    try:
        assert compile_cache.enable_compile_cache(True) == str(tmp_path / "xla_cache")
        assert (tmp_path / "xla_cache").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env", [False, True])
def test_compile_cache_location(tmp_path, monkeypatch, env):
    """utils/compile_cache: $JAX_COMPILATION_CACHE_DIR when set, else the
    fixed <checkout>/.cache/xla."""
    import os

    import jax

    from reptext.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        want = str(tmp_path / "env")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "repo" / ".cache" / "xla"))
        want = compile_cache.DEFAULT_DIR
    try:
        assert compile_cache.enable_compile_cache() == want
        assert os.path.isdir(want)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_compile_cache_is_inside_the_checkout():
    import os

    from reptext.utils import compile_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.DEFAULT_DIR == os.path.join(root, ".cache", "xla")
