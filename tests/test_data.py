"""Training data pipeline: determinism, shapes, and trainability."""

import jax
import numpy as np
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext.data import GlyphTextDataset
from reptext.pipelines import FluxRepTextPipeline

H = W = 64


@pytest.fixture(scope="module")
def dataset():
    pipe = FluxRepTextPipeline.create(
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(),
        pipe_cfg=PipelineConfig(height=H, width=W, num_inference_steps=2,
                                controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
    )
    return GlyphTextDataset(pipe, batch_size=2, seed=7)


def test_batch_shapes(dataset):
    cfg = dataset.pipe.pipe_cfg
    s_img = cfg.image_seq_len
    b = dataset.batch(0)
    assert b["x0"].shape == (2, s_img, 64)
    cn_cfg = dataset.pipe.controlnet.config
    assert b["cond_tokens"].shape == (
        2, s_img, cn_cfg.in_channels + cn_cfg.extra_condition_channels
    )
    assert b["token_mask"].shape == (2, s_img, 1)
    assert b["prompt_embeds"].shape[0] == 2
    assert b["guidance"].shape == (2,)
    # masks are real text regions: nonzero somewhere, not everywhere
    m = np.asarray(b["token_mask"])
    assert 0 < m.sum() < m.size
    # OCR perceptual-term fields (sampling/ocr_loss.py)
    from reptext.eval.ocr import MAX_LABEL

    assert b["ocr_boxes"].shape == (2, 4)
    boxes = np.asarray(b["ocr_boxes"])
    assert np.all(boxes[:, 2] > boxes[:, 0]) and np.all(boxes[:, 3] > boxes[:, 1])
    assert b["ocr_labels"].shape == (2, MAX_LABEL)
    assert b["ocr_paddings"].shape == (2, MAX_LABEL)
    # every sample has at least one labeled character
    assert np.all((1.0 - np.asarray(b["ocr_paddings"])).sum(axis=1) >= 1)


def test_step_indexed_determinism(dataset):
    b1 = dataset.batch(3)
    b2 = dataset.batch(3)
    for k in ("x0", "cond_tokens", "token_mask", "prompt_embeds"):
        np.testing.assert_array_equal(np.asarray(b1[k]), np.asarray(b2[k]))
    b3 = dataset.batch(4)
    assert not np.array_equal(np.asarray(b1["x0"]), np.asarray(b3["x0"]))


def test_prefetch_loader_sequential_and_rollback():
    from reptext.data import PrefetchLoader

    calls = []

    def batch_fn(step):
        calls.append(step)
        return {"step": step}

    loader = PrefetchLoader(batch_fn, depth=2)
    try:
        assert [loader(i)["step"] for i in range(5)] == list(range(5))
        # rollback replay: jumping backward restarts prefetch at that step
        assert loader(2)["step"] == 2
        assert loader(3)["step"] == 3
        # skipping forward drains stale prefetched steps
        assert loader(6)["step"] == 6
    finally:
        loader.close()


def test_prefetch_loader_propagates_errors():
    from reptext.data import PrefetchLoader

    def batch_fn(step):
        if step == 1:
            raise RuntimeError("bad batch")
        return step

    loader = PrefetchLoader(batch_fn, depth=1)
    try:
        assert loader(0) == 0
        import pytest as _pytest

        with _pytest.raises(RuntimeError, match="bad batch"):
            loader(1)
    finally:
        loader.close()


def test_trainable_with_controlnet_step(dataset):
    import optax

    from reptext.sampling.train_controlnet import (
        make_controlnet_train_step,
    )

    pipe = dataset.pipe
    opt = optax.adam(1e-3)
    cn_params = pipe.params["controlnet"]
    opt_state = opt.init(cn_params)

    def flux_apply(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return pipe.flux.apply(p, x, ctx, pooled, t, iid, tid, g,
                               controlnet_block_samples=br,
                               controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, t, iid, tid, g, scale):
        return pipe.controlnet.apply(p, x, cnd, ctx, pooled, t, iid, tid, g,
                                     conditioning_scale=scale)

    step = jax.jit(make_controlnet_train_step(flux_apply, cn_apply, opt))
    batch = dataset.batch(0)
    _, _, loss = step(cn_params, opt_state, pipe.params["flux"], batch,
                      jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))


# ------------------------------------------------------------- disk corpus


def _write_corpus(root, n=5):
    """Synthetic photo corpus: flat-color 'photos' + annotations.jsonl."""
    import json
    import os

    from PIL import Image

    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    rng = np.random.default_rng(3)
    words = ["CAFE", "STOP", "سوق", "نور", "2026"]
    with open(os.path.join(root, "annotations.jsonl"), "w") as f:
        for i in range(n):
            arr = np.full((96, 80, 3), rng.integers(0, 255, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(root, f"imgs/{i}.png"))
            rec = {
                "image": f"imgs/{i}.png",
                "prompt": f"a sign number {i}",
                "lines": [
                    {"text": words[i % len(words)], "position": [4, 10],
                     "font_size": 20, "color": [255, 255, 255]},
                    {"text": words[(i + 1) % len(words)], "position": [4, 36],
                     "font_size": 18},
                ],
            }
            f.write(json.dumps(rec) + "\n")
    return root


def test_disk_dataset_batch_contract(dataset, tmp_path):
    from reptext.data_disk import DiskImageTextDataset

    corpus = _write_corpus(str(tmp_path))
    ds = DiskImageTextDataset(dataset.pipe, corpus, batch_size=2, seed=5)
    b = ds.batch(0)
    ref = dataset.batch(0)
    for key in ref:
        if ref[key] is None:
            assert b[key] is None
        else:
            assert b[key].shape[0] == ref[key].shape[0] or key in ("img_ids", "txt_ids")
    assert b["x0"].shape == ref["x0"].shape
    assert b["ocr_labels"].shape == ref["ocr_labels"].shape


def test_disk_dataset_deterministic_and_epoch_coverage(dataset, tmp_path):
    from reptext.data_disk import DiskImageTextDataset

    corpus = _write_corpus(str(tmp_path), n=4)
    ds = DiskImageTextDataset(dataset.pipe, corpus, batch_size=2, seed=5)
    s1, s2 = ds.sample_spec(1, 0), ds.sample_spec(1, 0)
    assert s1 == s2
    # one epoch visits every record exactly once
    n = len(ds.records)
    paths = {ds.sample_spec(k // 2, k % 2)["image_path"] for k in range(n)}
    assert len(paths) == n


def test_disk_dataset_sharding_disjoint(dataset, tmp_path):
    from reptext.data_disk import DiskImageTextDataset

    corpus = _write_corpus(str(tmp_path), n=6)
    a = DiskImageTextDataset(dataset.pipe, corpus, batch_size=1, shard=(0, 2))
    b = DiskImageTextDataset(dataset.pipe, corpus, batch_size=1, shard=(1, 2))
    ia = {r["image"] for r in a.records}
    ib = {r["image"] for r in b.records}
    assert ia.isdisjoint(ib) and len(ia | ib) == 6


def test_disk_dataset_validation(tmp_path):
    import json

    from reptext.data_disk import load_annotations

    with open(tmp_path / "annotations.jsonl", "w") as f:
        f.write(json.dumps({"image": "x.png", "lines": []}) + "\n")
    with pytest.raises(ValueError):
        load_annotations(str(tmp_path))


def test_disk_dataset_rescales_annotations(dataset, tmp_path):
    """Annotation coords are original-image pixels; specs must rescale to
    the training resolution (here 64x64 from 96h x 80w photos)."""
    from reptext.data_disk import DiskImageTextDataset

    corpus = _write_corpus(str(tmp_path), n=2)
    ds = DiskImageTextDataset(dataset.pipe, corpus, batch_size=1, seed=0)
    cfg = dataset.pipe.pipe_cfg
    sx, sy = cfg.width / 80.0, cfg.height / 96.0
    seen = set()
    for k in range(4):
        spec = ds.sample_spec(k, 0)
        x, y = spec["position"]
        # corpus positions are (4, 10) or (4, 36) in 80x96 source pixels
        assert (x, y) in {(round(4 * sx), round(10 * sy)),
                          (round(4 * sx), round(36 * sy))}
        assert spec["font_size"] < 20      # 18/20 px scaled down by ~0.7
        seen.add((x, y))
    assert seen  # at least one line seen
