"""The port's inference surface against the JAX package's, on the CPU.

* The whole forward with K4 routing (``pallas_conv3x3``, through the twin on
  the CPU) against the JAX forward (its XLA convs: the twin is held against
  the Pallas kernel in ``test_torch_conv3x3.py``), at vits, max_disp 64,
  64x96, fp32: max abs <= 1e-2 px, the bound of ``test_torch_forward.py``.
* ``run_hierarchical`` (two-pass, coarse-to-fine) with the same K4-routed
  model against the JAX package's with the same weights (bridged), at
  128x176: the width is not a multiple of 32, so the left pad (8) offsets
  the initial disparity; the half-size pass pads to 64x96 and shares the
  JAX compile above. 1 iteration per pass: max abs <= 1e-2 px.
* ``InputPadder`` in every mode, ``geometry3d`` and ``vis`` against the JAX
  package's on the same arrays: exact (the same numpy code on the same
  inputs).
* The demo CLI end to end with ``--device cpu`` on tiny PNGs, pinhole with
  ``--hiera 1`` and panorama.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from foundationstereo_torch.convert.from_jax import load_jax_variables
from foundationstereo_torch.inference import demo
from foundationstereo_torch.inference import geometry3d as tg3d
from foundationstereo_torch.inference.hierarchical import run_hierarchical
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.ops import kernels
from foundationstereo_torch.ops.pad import InputPadder
from foundationstereo_torch.utils import vis as tvis
from foundationstereo_tpu.inference import geometry3d as jg3d
from foundationstereo_tpu.inference.hierarchical import run_hierarchical as jax_run_hierarchical
from foundationstereo_tpu.models.foundation_stereo import FoundationStereo as JaxFoundationStereo
from foundationstereo_tpu.ops.pad import InputPadder as JaxInputPadder
from foundationstereo_tpu.utils import vis as jvis
from test_torch_modules import CFG, JCFG, random_variables

ITERS = 1


@pytest.fixture(scope="module")
def models():
    """JAX apply_fn (jitted without and with init_disp) and the K4-routed
    port model with the same (bridged) weights."""
    jm = JaxFoundationStereo(JCFG)
    z = np.zeros((1, 64, 96, 3), np.float32)
    v = random_variables(jm, z, z, iters=1, test_mode=True)
    fwd = jax.jit(lambda vv, a, b: jm.apply(vv, a, b, iters=ITERS, test_mode=True))
    fwd_init = jax.jit(lambda vv, a, b, init: jm.apply(vv, a, b, iters=ITERS, test_mode=True,
                                                       init_disp=init))

    def apply_fn(a, b, iters, init_disp):
        return fwd(v, a, b) if init_disp is None else fwd_init(v, a, b, init_disp)

    model = FoundationStereo(CFG.replace(pallas_conv3x3=True), device="cpu")
    load_jax_variables(model, v)
    return apply_fn, model


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2)]


def test_whole_forward_with_k4_routing_matches_jax(models):
    apply_fn, model = models
    left, right = _pair(64, 96, 0)
    want = np.asarray(apply_fn(left, right, ITERS, None))
    kernels.reset_launches()
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS,
                    test_mode=True).numpy()
    assert got.shape == want.shape == (1, 64, 96)
    assert float(np.abs(got - want).max()) <= 1e-2
    assert not any(kernels.LAUNCHES.values())                          # CPU: twins only


def test_run_hierarchical_matches_jax(models):
    apply_fn, model = models
    h, w = 128, 176
    left, right = _pair(h, w, 3)
    assert InputPadder(left.shape, divis_by=32).pad_left == 8
    want = np.asarray(jax_run_hierarchical(apply_fn, left, right, iters=ITERS))
    with torch.no_grad():
        got = run_hierarchical(model, torch.from_numpy(left), torch.from_numpy(right),
                               iters=ITERS).numpy()
    assert got.shape == want.shape == (1, h, w)
    assert float(np.abs(got - want).max()) <= 1e-2


@pytest.mark.parametrize("shape,mode,divis_by,force_square", [
    ((1, 60, 90, 3), "sintel", 32, False),
    ((2, 61, 93, 1), "kitti", 32, False),
    ((1, 64, 96, 3), "sintel", 32, False),
    ((1, 50, 70, 3), "sintel", 8, True),
    ((1, 70, 50, 2), "other", 16, True),
])
def test_input_padder_matches_jax(shape, mode, divis_by, force_square):
    x = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    ours = InputPadder(shape, mode=mode, divis_by=divis_by, force_square=force_square)
    ref = JaxInputPadder(shape, mode=mode, divis_by=divis_by, force_square=force_square)
    assert ours.pads == ref.pads and ours.pad_left == ref.pad_left
    assert ours.padded_shape() == ref.padded_shape()
    want = np.asarray(ref.pad(x))
    np.testing.assert_array_equal(ours.pad(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(ours.pad_np(x), ref.pad_np(x))
    np.testing.assert_array_equal(ours.unpad(torch.from_numpy(want)).numpy(),
                                  np.asarray(ref.unpad(want)))
    a, b = ours.pad(torch.from_numpy(x), torch.from_numpy(x))
    assert torch.equal(a, b)


def _disp():
    rng = np.random.default_rng(5)
    d = rng.uniform(0.5, 40, (24, 32))
    d[0, :3] = [50.0, np.inf, 0.0]
    return d


K = np.array([[100, 0, 16], [0, 100, 12], [0, 0, 1]], np.float32)


def _ply_round_trip(m, tmp_path):
    rng = np.random.default_rng(6)
    pts, cols = rng.standard_normal((50, 3)), rng.integers(0, 255, (50, 3), dtype=np.uint8)
    m.write_ply(tmp_path / "a.ply", pts, cols)
    m.write_ply(tmp_path / "b.ply", pts)
    return (tmp_path / "a.ply").read_bytes() + (tmp_path / "b.ply").read_bytes()


CASES = {
    "remove_invisible": lambda m, _: m.remove_invisible(_disp()),
    "depth_from_disparity": lambda m, _: m.depth_from_disparity(_disp(), K, 0.063),
    "depth2xyzmap": lambda m, _: m.depth2xyzmap(100 * 0.063 / _disp(), K),
    "erp_pointcloud": lambda m, _: m.erp_pointcloud(_disp(), 0.1),
    "read_intrinsics": lambda m, p: np.concatenate(
        [m.read_intrinsics(p / "K.txt")[0].ravel(), [m.read_intrinsics(p / "K.txt")[1]]]),
    "write_ply": _ply_round_trip,
    "read_ply": lambda m, p: np.concatenate(
        [a.ravel().astype(np.float64) for a in m.read_ply(p / "c.ply")]),
    "radius_outlier_removal": lambda m, _: m.radius_outlier_removal(
        np.concatenate([np.random.default_rng(7).uniform(0, 0.05, (200, 3)),
                        np.random.default_rng(8).uniform(5, 50, (20, 3))]), 10, 0.03),
    "turbo_colormap": lambda m, _: m.turbo_colormap(np.linspace(-0.2, 1.2, 101)),
    "vis_disparity": lambda m, _: m.vis_disparity(_disp()),
    "vis_disparity_invalid": lambda m, _: m.vis_disparity(_disp(), invalid_thres=45.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_and_vis_match_jax(name, tmp_path):
    (tmp_path / "K.txt").write_text("100 0 16 0 100 12 0 0 1\n0.063\n")
    jg3d.write_ply(tmp_path / "c.ply", np.random.default_rng(9).standard_normal((30, 3)),
                   np.random.default_rng(9).integers(0, 255, (30, 3), dtype=np.uint8))
    ours_mod = tvis if name.startswith(("turbo", "vis")) else tg3d
    ref_mod = jvis if name.startswith(("turbo", "vis")) else jg3d
    ours, ref = CASES[name](ours_mod, tmp_path), CASES[name](ref_mod, tmp_path)
    if isinstance(ours, bytes):
        assert ours == ref
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.fixture
def demo_assets(tmp_path):
    rng = np.random.default_rng(10)
    left = rng.integers(0, 255, (64, 80, 3), dtype=np.uint8)
    Image.fromarray(left).save(tmp_path / "left.png")
    Image.fromarray(np.roll(left, -3, axis=1)).save(tmp_path / "right.png")
    (tmp_path / "K.txt").write_text("100 0 40 0 100 32 0 0 1\n0.063\n")
    return tmp_path


def _cli(assets, out, *extra):
    return demo.main(["--left_file", str(assets / "left.png"),
                      "--right_file", str(assets / "right.png"),
                      "--intrinsic_file", str(assets / "K.txt"), "--out_dir", str(out),
                      "--valid_iters", "1", "--max_disp", "64", "--vit_size", "vits",
                      "--device", "cpu", *extra])


def test_demo_cli_pinhole_hierarchical(demo_assets):
    out_dir = demo_assets / "out"
    out = _cli(demo_assets, out_dir, "--hiera", "1", "--denoise_cloud", "1",
               "--denoise_nb_points", "2", "--denoise_radius", "0.5", "--z_far", "1e9")
    for f in ("vis.png", "depth_meter.npy", "cloud.ply", "cloud_denoise.ply"):
        assert (out_dir / f).exists(), f
    assert out["disp"].shape == (64, 80) and np.isfinite(out["disp"]).all()
    assert np.asarray(Image.open(out_dir / "vis.png")).shape == (64, 160, 3)
    pts, cols = tg3d.read_ply(out_dir / "cloud.ply")
    assert len(pts) == len(out["points"]) > 0 and cols.dtype == np.uint8
    assert np.load(out_dir / "depth_meter.npy").shape == (64, 80)


def test_demo_cli_panorama_scaled(demo_assets):
    out_dir = demo_assets / "out_pano"
    out = _cli(demo_assets, out_dir, "--camera_type", "panorama", "--scale", "0.75",
               "--denoise_cloud", "0")
    assert (out_dir / "vis.png").exists() and (out_dir / "cloud.ply").exists()
    assert not (out_dir / "depth_meter.npy").exists()
    assert out["disp"].shape == (48, 60) and np.isfinite(out["disp"]).all()


def test_demo_cli_refuses_checkpoints(tmp_path):
    """The demo reads only the port's own checkpoints: an empty directory
    and the JAX package's orbax layout (a numbered step directory) raise."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        demo.main(["--ckpt_dir", str(tmp_path), "--device", "cpu"])
    (tmp_path / "2").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        demo.main(["--ckpt_dir", str(tmp_path), "--device", "cpu", "--ema", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo.main(["--out_dir", str(tmp_path), "--device", "cuda"])
