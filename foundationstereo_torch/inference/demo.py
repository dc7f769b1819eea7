"""The demo: a stereo pair -> disparity, depth and a point cloud.

The port of the JAX package's ``inference/demo.py`` (the reference's
``scripts/run_demo.py``), with its flag surface and K.txt formats::

    python -m foundationstereo_torch.inference.demo --left_file L.png \\
        --right_file R.png --intrinsic_file K.txt --out_dir out [--hiera 1] \\
        [--camera_type panorama] [--device cpu]

``run_pair`` serves one pair (pad to 32, forward, unpad); ``infer`` is one
request of the demo on numpy images (optional ``--scale``, one pass or the
``--hiera`` two-pass, the visualisation, and for pinhole or panorama
cameras the depth and the point cloud with outlier removal), writing
``depth_meter.npy``, ``cloud.ply`` and ``cloud_denoise.ply``; ``main`` adds
the image and ``vis.png`` I/O (PIL, imported only there) and builds the
model: from a checkpoint directory of the port's trainer (``--ckpt_dir``,
its ``config.json`` and latest step, ``--ema 1`` for the EMA weights), or
with seeded random weights.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from foundationstereo_torch.inference import geometry3d as g3d
from foundationstereo_torch.inference.hierarchical import run_hierarchical
from foundationstereo_torch.ops.pad import InputPadder
from foundationstereo_torch.ops.resize import resize2d
from foundationstereo_torch.utils.vis import vis_disparity

log = logging.getLogger(__name__)


def _as_batch(img, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img,
                        device=device).float()
    return t[None] if t.ndim == 3 else t


def run_pair(model: torch.nn.Module, left, right, iters: int = 32) -> torch.Tensor:
    """left/right: (B, H, W, 3) or (H, W, 3) RGB in 0-255 (arrays or tensors),
    moved to the model's device. Returns the (B, H, W) disparity there."""
    device = next(model.parameters()).device
    pair = [_as_batch(img, device) for img in (left, right)]
    padder = InputPadder(pair[0].shape, divis_by=32)
    lp, rp = padder.pad(*pair)
    with torch.inference_mode():
        disp = model(lp, rp, iters=iters, test_mode=True)
    return padder.unpad(disp[..., None])[..., 0]


def _rescale(img: np.ndarray, scale: float) -> np.ndarray:
    h, w = img.shape[:2]
    x = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)
    y = resize2d(x, (int(h * scale), int(w * scale)), "bilinear")
    return y.permute(1, 2, 0).numpy().astype(np.uint8)


def infer(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray, *,
          camera_type: str = "pinhole", K: np.ndarray | None = None, baseline: float = 0.0,
          scale: float = 1.0, hiera: bool = False, valid_iters: int = 32,
          z_far: float = 10.0, remove_invisible: bool = True, get_pc: bool = True,
          denoise_cloud: bool = True, denoise_nb_points: int = 30,
          denoise_radius: float = 0.03, out_dir: str | None = None) -> dict:
    """One demo request on (H, W, 3) uint8 RGB images.

    Returns ``disp`` (the network's (H', W') disparity at the scaled size),
    ``vis`` (the left image beside the disparity's colour map), ``seconds``
    (host clock: ``network`` until the disparity is on the host, ``host``
    the numpy work after it), and with
    ``get_pc`` the point cloud: ``points`` (N, 3) float64 and ``colors``
    (N, 3) uint8 after the invisible-pixel and ``z_far`` cuts, ``keep`` the
    outlier-removal mask over them (all True without ``denoise_cloud``),
    and for a pinhole camera ``depth`` in metres (``K`` the 3x3
    intrinsics, ``baseline`` in metres). Writes ``depth_meter.npy``,
    ``cloud.ply`` and ``cloud_denoise.ply`` into ``out_dir`` when given.
    """
    if camera_type not in ("pinhole", "panorama"):
        raise ValueError(f"camera_type {camera_type!r}")
    if scale != 1.0:
        if scale > 1.0:
            raise ValueError("scale must be <= 1")
        img0, img1 = _rescale(img0, scale), _rescale(img1, scale)
    t0 = time.perf_counter()
    H, W = img0.shape[:2]
    device = next(model.parameters()).device
    left, right = _as_batch(img0, device), _as_batch(img1, device)
    if hiera:
        with torch.inference_mode():
            disp = run_hierarchical(model, left, right, iters=valid_iters, small_ratio=0.5)
    else:
        disp = run_pair(model, left, right, iters=valid_iters)
    disp = disp.float().cpu().numpy().reshape(H, W)
    t1 = time.perf_counter()
    out = {"disp": disp, "vis": np.concatenate([img0, vis_disparity(disp)], axis=1),
           "seconds": {"network": t1 - t0}}
    if not get_pc:
        out["seconds"]["host"] = time.perf_counter() - t1
        return out

    d = g3d.remove_invisible(disp) if remove_invisible else disp
    if camera_type == "panorama":
        points = g3d.erp_pointcloud(d, baseline)
        invalid = ~np.isfinite(points).all(axis=-1) | np.isinf(d)
    else:
        K = np.array(K, np.float32)
        K[:2] *= scale
        out["depth"] = g3d.depth_from_disparity(d, K, baseline)
        points = g3d.depth2xyzmap(out["depth"], K)
        invalid = np.isinf(d)
    pts = points[~invalid].astype(np.float64)
    cols = img0[~invalid]
    if camera_type == "pinhole":
        keep = (pts[:, 2] > 0) & (pts[:, 2] <= z_far)
        pts, cols = pts[keep], cols[keep]
    keep = np.ones(len(pts), bool)
    if denoise_cloud and len(pts):
        keep = g3d.radius_outlier_removal(pts, denoise_nb_points, denoise_radius)
    out.update(points=pts, colors=cols, keep=keep)
    if out_dir is not None:
        if "depth" in out:
            np.save(f"{out_dir}/depth_meter.npy", out["depth"])
        g3d.write_ply(f"{out_dir}/cloud.ply", pts, cols)
        if denoise_cloud and len(pts):
            g3d.write_ply(f"{out_dir}/cloud_denoise.ply", pts[keep], cols[keep])
    out["seconds"]["host"] = time.perf_counter() - t1
    return out


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def main(argv=None) -> dict:
    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo, resolve_device

    ap = argparse.ArgumentParser(description="FoundationStereo demo on PyTorch")
    ap.add_argument("--left_file", default=None, type=str)
    ap.add_argument("--right_file", default=None, type=str)
    ap.add_argument("--intrinsic_file", default=None, type=str,
                    help="3x3 K row-major + baseline (pinhole) or baseline on line 2 (panorama)")
    ap.add_argument("--ckpt_dir", default=None, type=str,
                    help="the train CLI's checkpoint directory (with config.json); seeded "
                         "random weights if omitted")
    ap.add_argument("--out_dir", default=None, type=str)
    ap.add_argument("--camera_type", type=str, default="pinhole", choices=["pinhole", "panorama"])
    ap.add_argument("--scale", default=1.0, type=float)
    ap.add_argument("--hiera", default=0, type=int)
    ap.add_argument("--z_far", default=10.0, type=float)
    ap.add_argument("--valid_iters", type=int, default=32)
    ap.add_argument("--get_pc", type=int, default=1)
    ap.add_argument("--remove_invisible", default=1, type=int)
    ap.add_argument("--denoise_cloud", type=int, default=1)
    ap.add_argument("--denoise_nb_points", type=int, default=30)
    ap.add_argument("--denoise_radius", type=float, default=0.03)
    ap.add_argument("--vit_size", type=str, default=None)
    ap.add_argument("--max_disp", type=int, default=None)
    ap.add_argument("--ema", type=int, default=0, help="serve the checkpoint's EMA weights")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.ema and not args.ckpt_dir:
        raise ValueError("--ema needs --ckpt_dir")

    assets = Path(__file__).resolve().parents[2] / "assets"
    if args.camera_type == "panorama":
        args.left_file = args.left_file or str(assets / "blender/up_erp.png")
        args.right_file = args.right_file or str(assets / "blender/down_erp.png")
        args.intrinsic_file = args.intrinsic_file or str(assets / "blender/K.txt")
    else:
        args.left_file = args.left_file or str(assets / "left.png")
        args.right_file = args.right_file or str(assets / "right.png")
        args.intrinsic_file = args.intrinsic_file or str(assets / "K.txt")
    if args.out_dir is None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        args.out_dir = str(Path(__file__).resolve().parents[2] / "test_outputs"
                           / f"{args.camera_type}_{stamp}")
    os.makedirs(args.out_dir, exist_ok=True)

    overrides = {k: v for k, v in (("vit_size", args.vit_size), ("max_disp", args.max_disp)) if v}
    base, sd = {"vit_size": "vits", "max_disp": 192}, None
    if args.ckpt_dir:
        from foundationstereo_torch.train.checkpoints import CheckpointManager

        sd, step = CheckpointManager(args.ckpt_dir).restore_inference(
            "latest", use_ema=bool(args.ema))
        cfg_path = Path(args.ckpt_dir) / "config.json"
        base = json.loads(cfg_path.read_text()).get("model", {}) if cfg_path.exists() else {}
    cfg = ModelConfig.from_dict({**base, **overrides})
    model = FoundationStereo(cfg, device=resolve_device(args.device), seed=0)
    if sd is not None:
        model.load_state_dict(sd)
        log.info(f"restored checkpoint step {step} from {args.ckpt_dir}"
                 f"{' (EMA weights)' if args.ema else ''}")
    else:
        log.info("no checkpoint: seeded random weights")

    img0, img1 = load_image(args.left_file), load_image(args.right_file)
    log.info(f"img0: {img0.shape}")
    if args.camera_type == "panorama":
        K = None
        baseline = float(Path(args.intrinsic_file).read_text().splitlines()[1])
    else:
        K, baseline = g3d.read_intrinsics(args.intrinsic_file)
    out = infer(model, img0, img1, camera_type=args.camera_type, K=K, baseline=baseline,
                scale=args.scale, hiera=bool(args.hiera), valid_iters=args.valid_iters,
                z_far=args.z_far, remove_invisible=bool(args.remove_invisible),
                get_pc=bool(args.get_pc), denoise_cloud=bool(args.denoise_cloud),
                denoise_nb_points=args.denoise_nb_points,
                denoise_radius=args.denoise_radius, out_dir=args.out_dir)

    from PIL import Image

    Image.fromarray(out["vis"]).save(f"{args.out_dir}/vis.png")
    log.info(f"Output saved to {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
