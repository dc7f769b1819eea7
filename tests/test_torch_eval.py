"""The port's benchmark evaluation against the JAX package's, on the CPU
(~45 s serially, on one torch thread).

* ``scripts.make_synth_data.make_pair`` and the three fixture layouts of
  ``scripts.make_eval_fixtures`` are bit for bit (byte for byte on disk)
  those of the JAX package's scripts, run as a subprocess.
* Each of the five ``DATASET_ITERATORS`` gives the JAX iterator's samples.
* ``stereo_eval_metrics`` and ``read_pfm``/``write_pfm`` equal the JAX ones.
* The eval CLI with ``--device cpu`` (vits, max_disp 64, 64x96 fixtures, 1
  iteration, seeded random weights or a checkpoint through
  ``from_pretrained``) writes a frame row per frame and a summary row, and
  each row's metrics equal the JAX ``stereo_eval_metrics`` of that frame's
  ``run_pair`` disparity; ``--hiera 1`` and ``--scale 0.5`` run too.
* ``scripts.vis_depth`` and ``scripts.vis_dataset`` write the JAX scripts'
  PNG pixels.
* The CLIs' default device raises without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.inference import datasets as tds
from foundationstereo_torch.inference.demo import run_pair
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.pretrained import save_pretrained
from foundationstereo_torch.scripts import eval as teval
from foundationstereo_torch.scripts import make_eval_fixtures, make_synth_data, vis_dataset, vis_depth
from foundationstereo_tpu.inference import datasets as jds
from scripts.make_synth_data import make_pair as jax_make_pair

REPO = Path(__file__).resolve().parent.parent
H, W = 64, 96
CFG = ModelConfig(vit_size="vits", max_disp=64)
EVAL_FLAGS = ["--vit_size", "vits", "--max_disp", "64", "--valid_iters", "1", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this file: its tensors are small, and the
    suite runs several files at once, where a thread pool per process
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _script(name: str, *args) -> None:
    subprocess.run([sys.executable, str(REPO / "scripts" / name), *map(str, args)], cwd=REPO,
                   check=True, capture_output=True, timeout=300)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The port's fixtures (and FSD data) beside the JAX scripts' own."""
    root = tmp_path_factory.mktemp("fixtures")
    flags = ["--n", "2", "--height", H, "--width", W, "--max_disp", "24"]
    make_eval_fixtures.main(["--out", str(root / "port"), *map(str, flags)])
    _script("make_eval_fixtures.py", "--out", root / "jax", *flags)
    make_synth_data.main(["--out", str(root / "port_fsd"), "--n", "2", "--height", str(H),
                          "--width", str(W), "--max_disp", "24", "--seed", "3"])
    _script("make_synth_data.py", "--out", root / "jax_fsd", "--n", 2, "--height", H, "--width", W,
            "--max_disp", 24, "--seed", 3)
    return root


def test_make_pair_is_the_jax_scripts(tmp_path):
    for h, w, d in ((64, 96, 24), (37, 53, 16)):
        got = make_synth_data.make_pair(np.random.default_rng(5), h, w, d)
        want = jax_make_pair(np.random.default_rng(5), h, w, d)
        for g, e in zip(got, want):
            assert g.dtype == e.dtype and np.array_equal(g, e)


def test_fixtures_are_the_jax_scripts(fixtures):
    port, jax_files = _files(fixtures / "port"), _files(fixtures / "jax")
    assert len(port) == 2 * 2 * 4 + 2 * 3 and port.keys() == jax_files.keys()
    assert all(port[k] == jax_files[k] for k in port)
    assert _files(fixtures / "port_fsd") == _files(fixtures / "jax_fsd")


@pytest.mark.parametrize("dataset", sorted(tds.DATASET_ITERATORS))
def test_iterators_give_the_jax_samples(fixtures, dataset):
    root = fixtures / ("port_fsd" if dataset == "fsd" else
                       f"port/{dataset.replace('kitti2012', 'kitti2015')}")
    got = list(tds.DATASET_ITERATORS[dataset](root))
    want = list(jds.DATASET_ITERATORS[dataset](root))
    assert len(got) == len(want) == (0 if dataset == "kitti2012" else 2)
    for g, e in zip(got, want):
        assert g.keys() == e.keys() and g["name"] == e["name"]
        for k in ("left", "right", "disparity", "mask"):
            assert g[k].dtype == e[k].dtype and np.array_equal(g[k], e[k]), k


def test_metrics_and_pfm_are_the_jax_ones(tmp_path):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 40, (30, 50)).astype(np.float32)
    gt = (pred + rng.normal(0, 2, pred.shape)).astype(np.float32)
    pred[0, :5] = np.nan
    mask = rng.uniform(size=pred.shape) > 0.2
    for m in (mask, np.zeros_like(mask)):
        got, want = tds.stereo_eval_metrics(pred, gt, m), jds.stereo_eval_metrics(pred, gt, m)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k], equal_nan=True) for k in got)
    tds.write_pfm(tmp_path / "a.pfm", gt)
    jds.write_pfm(tmp_path / "b.pfm", gt)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    assert np.array_equal(tds.read_pfm(tmp_path / "a.pfm"), jds.read_pfm(tmp_path / "a.pfm"))


@pytest.fixture(scope="module")
def model():
    """The eval CLI's model without --ckpt_dir: seeded random weights."""
    return FoundationStereo(CFG, device="cpu", seed=0)


@pytest.mark.parametrize("dataset", ["middlebury", "eth3d", "kitti2015"])
def test_eval_cli_rows_are_the_jax_metrics(fixtures, tmp_path, dataset, model):
    root = fixtures / "port" / dataset
    out = tmp_path / "m.jsonl"
    rows, summary = teval.main(["--dataset", dataset, "--root", str(root), "--out", str(out),
                                *EVAL_FLAGS])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["type"] for r in lines] == ["frame", "frame", "summary"]
    for row, sample in zip(lines, jds.DATASET_ITERATORS[dataset](root)):
        disp = run_pair(model, sample["left"], sample["right"], iters=1)[0].numpy()
        want = jds.stereo_eval_metrics(disp, sample["disparity"], sample["mask"])
        assert row["name"] == sample["name"] and row["time_s"] >= 0
        assert {k: row[k] for k in want} == want
    assert rows == [{k: v for k, v in r.items() if k != "type"} for r in lines[:2]]
    assert summary["frames"] == 2 and summary["dataset"] == dataset
    assert summary["epe"] == pytest.approx(np.mean([r["epe"] for r in rows]))


def test_eval_cli_hiera_scale_and_checkpoint(fixtures, tmp_path, model):
    """One frame with --hiera 1 and --scale 0.5, from seeded weights and from
    the same weights through --ckpt_dir: finite metrics, the same rows."""
    ckpt = tmp_path / "ckpt"
    save_pretrained(ckpt, model, CFG)
    flags = ["--dataset", "kitti2015", "--root", str(fixtures / "port" / "kitti2015"),
             "--max_frames", "1", "--hiera", "1", "--scale", "0.5", *EVAL_FLAGS]
    runs = [teval.main(flags + extra) for extra in ([], ["--ckpt_dir", str(ckpt)])]
    for rows, summary in runs:
        assert summary["frames"] == len(rows) == 1
        assert all(np.isfinite(summary[k]) for k in ("epe", "bad3", "d1_all", "rmse"))
    seeded, loaded = ({k: v for k, v in rows[0].items() if k != "time_s"} for rows, _ in runs)
    assert seeded == loaded


def test_vis_scripts_write_the_jax_pixels(fixtures, tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 20, (40, 60)).astype(np.float32)
    depth[0, 0], depth[1, 1] = np.nan, np.inf
    np.save(tmp_path / "depth.npy", depth)
    vis_depth.main(["--path", str(tmp_path / "depth.npy"), "--out_prefix", str(tmp_path / "port")])
    _script("vis_depth.py", "--path", tmp_path / "depth.npy", "--out_prefix", tmp_path / "jax")
    vis_dataset.main(["--dataset_dir", str(fixtures / "port_fsd"), "--index", "1",
                      "--out", str(tmp_path / "port_ds.png")])
    _script("vis_dataset.py", "--dataset_dir", fixtures / "port_fsd", "--index", 1,
            "--out", tmp_path / "jax_ds.png")
    for port, jax_png in [(f"port_{k}.png", f"jax_{k}.png") for k in ("linear", "log", "hist")] + \
            [("port_ds.png", "jax_ds.png")]:
        got = np.asarray(Image.open(tmp_path / port))
        assert np.array_equal(got, np.asarray(Image.open(tmp_path / jax_png))), port
    assert got.shape == (H, 3 * W, 3)


def test_eval_cli_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--dataset", "middlebury", "--root", str(tmp_path)])
