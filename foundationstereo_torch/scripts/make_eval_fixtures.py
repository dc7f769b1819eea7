"""Write small Middlebury / ETH3D / KITTI-2015 benchmark-layout fixtures from
the synthetic stereo generator, so the eval CLI can be driven end to end per
on-disk format.

The port's own copy of the JAX package's ``scripts/make_eval_fixtures.py``:
the same files, byte for byte, from the same flags. Layouts follow the real
benchmarks' training-split conventions (``inference/datasets.py``):
  middlebury: <root>/<scene>/{im0.png,im1.png,disp0.pfm,mask0nocc.png}
  eth3d:      <root>/<scene>/{im0.png,im1.png,disp0GT.pfm,mask0nocc.png}
  kitti2015:  <root>/{image_2,image_3,disp_occ_0}/<frame>_10.png (uint16/256)

Usage: python -m foundationstereo_torch.scripts.make_eval_fixtures \\
         --out /tmp/evalfix --n 2 --height 160 --width 224 --max_disp 48
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image

from foundationstereo_torch.inference.datasets import write_pfm
from foundationstereo_torch.scripts.make_synth_data import make_pair


def _occlusion_mask(disp: np.ndarray) -> np.ndarray:
    """Non-occluded = pixels whose target column x - d survives the
    nearest-surface-wins forward splat (same convention as make_pair)."""
    h, w = disp.shape
    xx = np.arange(w, dtype=np.float32)[None].repeat(h, 0)
    xr = np.round(xx - disp).astype(np.int64)
    valid = (xr >= 0) & (xr < w)
    winner = np.full((h, w), -1.0, np.float32)  # per target column: max disp
    for y in range(h):
        np.maximum.at(winner[y], xr[y][valid[y]], disp[y][valid[y]])
    nocc = np.zeros((h, w), bool)
    nocc[valid] = disp[valid] >= winner[np.arange(h)[:, None].repeat(w, 1)[valid],
                                        xr[valid]] - 1e-3
    return nocc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="benchmark-layout eval fixtures")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--width", type=int, default=224)
    ap.add_argument("--max_disp", type=int, default=48)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    out = Path(args.out)
    rng = np.random.default_rng(args.seed)
    kroot = out / "kitti2015"
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (kroot / sub).mkdir(parents=True, exist_ok=True)

    for i in range(args.n):
        left, right, disp = make_pair(rng, args.height, args.width, args.max_disp)
        nocc = _occlusion_mask(disp)

        for fmt, gt_name in (("middlebury", "disp0.pfm"), ("eth3d", "disp0GT.pfm")):
            scene = out / fmt / f"scene{i:02d}"
            scene.mkdir(parents=True, exist_ok=True)
            Image.fromarray(left).save(scene / "im0.png")
            Image.fromarray(right).save(scene / "im1.png")
            write_pfm(scene / gt_name, disp)
            Image.fromarray((nocc * 255).astype(np.uint8)).save(scene / "mask0nocc.png")

        name = f"{i:06d}_10.png"
        Image.fromarray(left).save(kroot / "image_2" / name)
        Image.fromarray(right).save(kroot / "image_3" / name)
        d16 = np.clip(disp * 256.0, 1, 65535).astype(np.uint16)
        Image.fromarray(d16).save(kroot / "disp_occ_0" / name)

    print(f"wrote {args.n} frames per format under {out}")


if __name__ == "__main__":
    main()
