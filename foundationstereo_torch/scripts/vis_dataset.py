"""Dataset sample viewer (reference scripts/vis_dataset.py analog, headless).

The port of the JAX package's ``scripts/vis_dataset.py``: reads one
FSD-format sample (left/right jpg + 3-channel uint8 disparity png), decodes
it and writes a triptych PNG (left | right | disparity in turbo).

Usage: python -m foundationstereo_torch.scripts.vis_dataset --dataset_dir DATA \\
         [--index 0] [--out vis.png]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image

from foundationstereo_torch.utils.misc import depth_uint8_decoding
from foundationstereo_torch.utils.vis import vis_disparity


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="FSD dataset sample viewer")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--out", default="dataset_vis.png")
    args = ap.parse_args(argv)

    root = Path(args.dataset_dir)
    names = sorted(p.stem for p in (root / "left/rgb").glob("*.jpg"))
    name = names[args.index]
    left = np.asarray(Image.open(root / "left/rgb" / f"{name}.jpg").convert("RGB"))
    right = np.asarray(Image.open(root / "right/rgb" / f"{name}.jpg").convert("RGB"))
    disp_u8 = np.asarray(Image.open(root / "left/disparity" / f"{name}.png"))
    disp = depth_uint8_decoding(disp_u8) if disp_u8.ndim == 3 else disp_u8.astype(float)
    panel = np.concatenate([left, right, vis_disparity(disp)], axis=1)
    Image.fromarray(panel).save(args.out)
    print(f"sample {name}: disp range [{disp.min():.2f}, {disp.max():.2f}] -> {args.out}")


if __name__ == "__main__":
    main()
