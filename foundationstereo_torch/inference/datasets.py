"""Benchmark dataset readers + leaderboard metrics.

The port's own copy of the JAX package's ``inference/datasets.py`` (numpy
and PIL only), with the same names and outputs. Covers the evaluation
protocols behind the reference's headline numbers (BASELINE.md):
Middlebury (im0/im1.png + disp0.pfm + mask0nocc.png), ETH3D (im0/im1.png +
disp0GT.pfm + mask0nocc.png), KITTI 2012/2015 (colored/image_2 +
disp_occ/disp_occ_0 uint16/256), and the native FSD layout (left|right/rgb +
left/disparity base-255 png).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator

import numpy as np
from PIL import Image

from foundationstereo_torch.utils.misc import depth_uint8_decoding


def read_pfm(path: str | Path) -> np.ndarray:
    """Read a PFM file (Middlebury/ETH3D disparity format)."""
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path}")
        channels = 3 if header == "PF" else 1
        dims = f.readline().decode()
        while dims.startswith("#"):
            dims = f.readline().decode()
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"bad PFM dims in {path}: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4", count=h * w * channels)
        img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
        return np.flipud(img).astype(np.float32).copy()  # PFM rows are bottom-up


def write_pfm(path: str | Path, data: np.ndarray):
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(data).tobytes())


def _img(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def iter_middlebury(root: str | Path) -> Iterator[dict]:
    """Scenes with im0.png/im1.png/disp0.pfm (+ optional mask0nocc.png)."""
    root = Path(root)
    for scene in sorted(p for p in root.iterdir() if (p / "im0.png").exists()):
        gt = read_pfm(scene / "disp0.pfm") if (scene / "disp0.pfm").exists() else \
            read_pfm(scene / "disp0GT.pfm")
        mask = np.isfinite(gt) & (gt > 0)
        nocc = scene / "mask0nocc.png"
        if nocc.exists():
            mask &= np.asarray(Image.open(nocc)) == 255
        yield {"name": scene.name, "left": _img(scene / "im0.png"),
               "right": _img(scene / "im1.png"), "disparity": gt, "mask": mask}


def iter_eth3d(root: str | Path) -> Iterator[dict]:
    """ETH3D two-view: same on-disk shape as Middlebury (disp0GT.pfm)."""
    yield from iter_middlebury(root)


def iter_kitti(root: str | Path, split: str = "2015") -> Iterator[dict]:
    """KITTI 2012/2015 training layout with disp_occ uint16/256 PNGs."""
    root = Path(root)
    if split == "2015":
        left_dir, right_dir, disp_dir = "image_2", "image_3", "disp_occ_0"
    else:
        left_dir, right_dir, disp_dir = "colored_0", "colored_1", "disp_occ"
    for lp in sorted((root / left_dir).glob("*_10.png")):
        name = lp.stem
        dp = root / disp_dir / lp.name
        if not dp.exists():
            continue
        gt = np.asarray(Image.open(dp)).astype(np.float32) / 256.0
        yield {"name": name, "left": _img(lp),
               "right": _img(root / right_dir / lp.name),
               "disparity": gt, "mask": gt > 0}


def iter_fsd(root: str | Path) -> Iterator[dict]:
    """This framework's/reference's training layout (SURVEY §7.4)."""
    root = Path(root)
    for lp in sorted((root / "left" / "rgb").glob("*.jpg")):
        dp = root / "left" / "disparity" / f"{lp.stem}.png"
        rp = root / "right" / "rgb" / lp.name
        if not (dp.exists() and rp.exists()):
            continue
        d8 = np.asarray(Image.open(dp))
        gt = depth_uint8_decoding(d8).astype(np.float32) if d8.ndim == 3 else \
            d8.astype(np.float32)
        yield {"name": lp.stem, "left": _img(lp), "right": _img(rp),
               "disparity": gt, "mask": gt > 0}


DATASET_ITERATORS = {
    "middlebury": iter_middlebury,
    "eth3d": iter_eth3d,
    "kitti2015": lambda r: iter_kitti(r, "2015"),
    "kitti2012": lambda r: iter_kitti(r, "2012"),
    "fsd": iter_fsd,
}


def stereo_eval_metrics(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> dict:
    """Leaderboard metric pack: EPE, bad-0.5/1/2/3 (%), D1-all (%)."""
    m = mask & np.isfinite(pred)
    if m.sum() == 0:
        return {k: float("nan") for k in
                ("epe", "bad05", "bad1", "bad2", "bad3", "d1_all", "rmse")}
    err = np.abs(pred - gt)[m]
    gtv = gt[m]
    return {
        "epe": float(err.mean()),
        "bad05": float((err > 0.5).mean() * 100),
        "bad1": float((err > 1.0).mean() * 100),
        "bad2": float((err > 2.0).mean() * 100),
        "bad3": float((err > 3.0).mean() * 100),
        # KITTI D1: error > 3px AND > 5% of gt
        "d1_all": float(((err > 3.0) & (err > 0.05 * gtv)).mean() * 100),
        "rmse": float(np.sqrt((err ** 2).mean())),
        "density": float(m.mean()),
    }
