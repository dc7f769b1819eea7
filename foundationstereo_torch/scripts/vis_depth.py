"""Depth .npz/.npy inspector (reference scripts/vis_depth.py analog, headless).

The port of the JAX package's ``scripts/vis_depth.py`` (numpy, PIL and,
where installed, matplotlib): prints stats and a NaN/Inf audit and writes
linear/log/histogram visualisations as PNGs (matplotlib for the histogram,
when available; turbo maps otherwise).

Usage: python -m foundationstereo_torch.scripts.vis_depth --path depth.npy \\
         [--out_prefix depth_vis] [--key KEY]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="depth map inspector")
    ap.add_argument("--path", required=True)
    ap.add_argument("--out_prefix", default="depth_vis")
    ap.add_argument("--key", default=None, help=".npz array key (default: first)")
    args = ap.parse_args(argv)

    p = Path(args.path)
    if p.suffix == ".npz":
        data = np.load(p)
        key = args.key or list(data.keys())[0]
        depth = data[key]
    else:
        depth = np.load(p)
    depth = np.squeeze(depth)

    finite = np.isfinite(depth)
    print(f"shape: {depth.shape}, dtype: {depth.dtype}")
    print(f"nan: {np.isnan(depth).sum()}, inf: {np.isinf(depth).sum()}, "
          f"zero: {(depth == 0).sum()}")
    if finite.any():
        vals = depth[finite]
        print(f"min/mean/max: {vals.min():.4f} / {vals.mean():.4f} / {vals.max():.4f}")
        print(f"percentiles 1/50/99: {np.percentile(vals, [1, 50, 99])}")

    from PIL import Image

    from foundationstereo_torch.utils.vis import turbo_colormap

    safe = np.where(finite, depth, 0)
    rng = safe.max() - safe.min() or 1.0
    lin = turbo_colormap((safe - safe.min()) / rng)
    Image.fromarray(lin).save(f"{args.out_prefix}_linear.png")
    logd = np.log1p(np.clip(safe, 0, None))
    lrng = logd.max() or 1.0
    Image.fromarray(turbo_colormap(logd / lrng)).save(f"{args.out_prefix}_log.png")

    try:
        import matplotlib
    except ImportError:
        print(f"wrote {args.out_prefix}_{{linear,log}}.png (matplotlib unavailable)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(depth[finite].ravel(), bins=100)
    ax.set_xlabel("depth")
    ax.set_ylabel("count")
    fig.savefig(f"{args.out_prefix}_hist.png", dpi=120)
    plt.close(fig)
    print(f"wrote {args.out_prefix}_{{linear,log,hist}}.png")


if __name__ == "__main__":
    main()
