"""The port's data pipeline, native bindings and train CLI, on the CPU.

* Data: the port's ``StereoTrainDataLoaderPipeline`` against the JAX
  package's on a small dataset written here: the same global seed gives the
  same batches bit for bit (both built on this thread, no load workers), and
  a corrupt sample becomes the invalid instance in both.
* Native bindings: the port's library (built from the shared
  ``native/stereo_io.cpp`` into ``foundationstereo_torch/_build``) against
  the pipeline's numpy fallbacks.
* ``flash_attention`` refuses a qkv that requires grad while grad is enabled.
* The train CLI (``python -m foundationstereo_torch.train.cli``) with
  ``--device cpu`` at vits, max_disp 64, 64x96 crops, 1 iteration: 2 steps
  (with a visualisation panel and a profiler trace), a resume from
  ``latest`` for 1 more, then the demo on the checkpoint
  directory with ``--ema 1``. The models are built without their seeded
  initialiser (the run's numbers do not depend on it), to keep the test
  short.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from foundationstereo_torch import native
from foundationstereo_torch.inference import demo
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.ops import kernels
from foundationstereo_torch.train import cli
from foundationstereo_torch.train import dataloader as tdl
from foundationstereo_torch.utils.misc import depth_uint8_decoding, depth_uint8_encoding
from foundationstereo_tpu import native as jax_native
from foundationstereo_tpu.train import dataloader as jdl


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs its files in
    parallel workers, and torch's default of one thread per core in each
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_dataset(root, rng, n=4, h=64, w=96):
    for sub in ("left/rgb", "right/rgb", "left/disparity"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "left/rgb" / f"{i}.jpg")
        Image.fromarray(np.roll(img, -2, 1)).save(root / "right/rgb" / f"{i}.jpg")
        disp = rng.uniform(1, 30, (h, w)).astype(np.float32)
        Image.fromarray(depth_uint8_encoding(disp)).save(root / "left/disparity" / f"{i}.png")
    return root


def data_config(root, sizes=((96, 64),)):
    aug = ["jittering", "flipping", "disparity_stretching"]
    return {"datasets": [{"name": "syn", "path": str(root), "weight": 1.0,
                          "label_type": "stereo", "image_augmentation": aug}],
            "image_sizes": [list(s) for s in sizes], "max_disparity": 64,
            "image_augmentation": aug, "stereo_augmentation": True}


def test_pipeline_matches_jax_bit_for_bit(tmp_path, rng):
    root = write_dataset(tmp_path / "ds", rng)
    (root / "left/rgb/9.jpg").write_bytes(b"not a jpeg")           # a corrupt sample
    (root / "right/rgb/9.jpg").write_bytes(b"not a jpeg")
    Image.fromarray(np.zeros((64, 96, 3), np.uint8)).save(root / "left/disparity/9.png")
    assert native.available() == jax_native.available()
    cfg = data_config(root, sizes=((96, 64), (64, 96)))
    batches = {}
    for name, mod in (("jax", jdl), ("torch", tdl)):
        pipe = mod.StereoTrainDataLoaderPipeline(cfg, batch_size=3)
        random.seed(7)
        batches[name] = [pipe.get() for _ in range(4)]
    labels = set()
    for bj, bt in zip(batches["jax"], batches["torch"]):
        assert bj["label_type"] == bt["label_type"] and bj["info"] == bt["info"]
        labels.update(bt["label_type"])
        for k in ("left_image", "right_image", "disparity", "disparity_mask"):
            assert bj[k].dtype == bt[k].dtype and np.array_equal(bj[k], bt[k]), k
    assert labels == {"stereo", "invalid"}


def test_native_matches_fallbacks(rng):
    assert native.available() and native.library_path().exists()
    d = rng.uniform(0, 400, (37, 53)).astype(np.float32)
    enc = native.encode_disparity(d)
    np.testing.assert_array_equal(enc, depth_uint8_encoding(d))
    np.testing.assert_allclose(native.decode_disparity(enc), depth_uint8_decoding(enc),
                               rtol=1e-6)
    img = rng.uniform(0, 255, (31, 47, 3)).astype(np.float32)
    h, w = 17, 23
    ys = np.minimum((np.arange(h) * 31 / h).astype(np.int64), 30)
    xs = np.minimum((np.arange(w) * 47 / w).astype(np.int64), 46)
    np.testing.assert_array_equal(native.resize_nearest(img, (w, h)), img[ys][:, xs])
    np.testing.assert_allclose(native.resize_bilinear(img, (47, 31)), img, atol=1e-4)
    np.testing.assert_allclose(native.warp_affine_reflect(img, 1.5, -0.7, 0.3),
                               tdl.warp_affine_reflect(img.astype(np.float64), 1.5, -0.7, 0.3),
                               atol=1e-2)


def test_flash_attention_refuses_grad():
    qkv = torch.randn(1, 8, 3, 2, 64, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        kernels.flash_attention(qkv, 0.125)
    with torch.no_grad():
        out = kernels.flash_attention(qkv, 0.125)
    assert out.shape == (1, 8, 2, 64) and not out.requires_grad
    assert kernels.flash_attention(qkv.detach(), 0.125).shape == (1, 8, 2, 64)


def test_train_cli_runs_resumes_and_serves(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(FoundationStereo, "init_weights", lambda self, gen: None)
    data = write_dataset(tmp_path / "data", rng)
    repo = Path(__file__).resolve().parent.parent
    config = json.loads((repo / "configs/train/stereo_v1.json").read_text())
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    ws = tmp_path / "ws"

    def run(steps, ckpt, *extra):
        return cli.main([
            "--config", str(cfg_path), "--workspace", str(ws), "--device", "cpu",
            "--num_iterations", str(steps), "--batch_size", "2", "--save_every", "1",
            "--log_every", "1", "--checkpoint", ckpt,
            "--override", "model.vit_size=vits", "--override", "model.max_disp=64",
            "--override", "model.train_iters=1", "--override", "model.valid_iters=1",
            "--override", "model.mixed_precision=false",
            "--override", "data.image_sizes=[[96,64]]", "--override", "data.max_disparity=64",
            "--override", f"data.datasets.0.path={data}", *extra])

    run(2, "none", "--vis_every", "2", "--profile_steps", "1,1")
    assert (ws / "vis" / "00000000.png").exists() and (ws / "profile.json").exists()
    lines = [json.loads(x) for x in (ws / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    for x in lines:
        assert np.isfinite(x["loss"]) and x["skipped_nonfinite"] == 0.0
        assert {"grad_norm", "t_dispatch", "t_get", "t_data", "t_fence"} <= set(x)
    ckpts = ws / "checkpoints"
    assert {"1.pt", "2.pt", "2_ema.pt", "2_optimizer.pt", "latest.pt"} <= \
        {p.name for p in ckpts.iterdir()}

    run(3, "latest")
    lines = [json.loads(x) for x in (ws / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert json.loads((ckpts / "config.json").read_text())["model"]["vit_size"] == "vits"

    img = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    for side in ("L", "R"):
        Image.fromarray(img).save(tmp_path / f"{side}.png")
    (tmp_path / "K.txt").write_text("100 0 48 0 100 32 0 0 1\n0.1\n")
    out = demo.main(["--left_file", str(tmp_path / "L.png"), "--right_file", str(tmp_path / "R.png"),
                     "--intrinsic_file", str(tmp_path / "K.txt"), "--out_dir", str(tmp_path / "out"),
                     "--ckpt_dir", str(ckpts), "--ema", "1", "--valid_iters", "2",
                     "--device", "cpu", "--denoise_cloud", "0"])
    assert out["disp"].shape == (64, 96) and np.isfinite(out["disp"]).all()
    assert (tmp_path / "out" / "vis.png").exists()
