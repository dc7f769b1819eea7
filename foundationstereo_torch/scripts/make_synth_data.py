"""Generate a synthetic FSD-format stereo dataset for throughput/training
runs without real data.

The port's own copy of the JAX package's ``scripts/make_synth_data.py``
(numpy and PIL only): ``make_pair`` gives the same arrays from the same
``numpy.random.default_rng`` state.

Layout (reference contract, train/dataloader.py:51-64 + Utils.py:137-140):
  <out>/left/rgb/*.jpg  <out>/right/rgb/*.jpg  <out>/left/disparity/*.png
with 3-channel base-255 uint8 disparity encoding. Images are textured noise
(Gaussian blobs + gradients) so JPEG/aug paths see non-degenerate content;
the right view is the left forward-splatted by the disparity (nearest), so
the data is geometrically self-consistent enough for loss curves to move.

Usage: python -m foundationstereo_torch.scripts.make_synth_data \
         --out /tmp/fsd_synth --n 32 --height 512 --width 960 --max_disp 160
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image

from foundationstereo_torch.utils.misc import depth_uint8_encoding


def _texture(rng, h, w, yy, xx):
    """Left-image texture: mixed families so matching can't key on one cue."""
    img = np.zeros((h, w, 3), np.float32)
    # Gaussian blobs with per-blob color.
    for _ in range(rng.integers(6, 16)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(h / 16, h / 3)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img += blob[..., None] * rng.uniform(20, 140, 3)
    # Sinusoidal gratings at random orientation/frequency.
    for _ in range(rng.integers(1, 4)):
        th = rng.uniform(0, np.pi)
        fr = rng.uniform(2, 40) * 2 * np.pi / w
        ph = rng.uniform(0, 2 * np.pi)
        wave = np.sin((np.cos(th) * xx + np.sin(th) * yy) * fr + ph)
        img += wave[..., None] * rng.uniform(5, 35, 3)
    # Piecewise-constant rectangles (sharp luminance edges).
    for _ in range(rng.integers(2, 8)):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        hh = int(rng.uniform(h / 16, h / 3))
        ww = int(rng.uniform(w / 16, w / 3))
        img[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-50, 50, 3)
    img += rng.normal(0, rng.uniform(4, 20), (h, w, 3))
    img += (xx / w * rng.uniform(-40, 40))[..., None]
    img += (yy / h * rng.uniform(-40, 40))[..., None]
    img += rng.uniform(40, 140, 3)
    return np.clip(img, 0, 255)


def _disparity(rng, h, w, yy, xx, max_disp):
    """Disparity: slanted base plane + smooth blobs + hard step regions
    (rectangles/ellipses at distinct depths -> depth discontinuities and
    real occlusions in the warped right view)."""
    disp = (rng.uniform(2, max_disp * 0.25)
            + (1 - yy / h) * rng.uniform(0, max_disp * 0.3)
            + (xx / w) * rng.uniform(-0.1, 0.1) * max_disp)
    for _ in range(rng.integers(2, 6)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(h / 8, h / 2)
        disp = disp + np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)) \
            * rng.uniform(0, max_disp * 0.35)
    for _ in range(rng.integers(1, 5)):  # foreground objects: step edges
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry = rng.uniform(h / 12, h / 3)
        rx = rng.uniform(w / 12, w / 3)
        if rng.random() < 0.5:
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
        else:
            m = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        disp = np.where(m, np.minimum(disp + rng.uniform(0.1, 0.5) * max_disp,
                                      max_disp - 1), disp)
    return np.clip(disp, 0.5, max_disp - 1).astype(np.float32)


def make_pair(rng, h, w, max_disp):
    """Geometrically consistent pair under the standard rectified convention
    left[x] == right[x - d(x)] (the convention of ops/cost_volume.py:
    gwc[d, w] = <L[w], R[w-d]>): the right view is a FORWARD splat of the
    left image to x - d, nearest-surface-wins at collisions (splat in
    ascending-disparity order so the largest disparity, i.e. the nearest
    surface, lands last). Disocclusion holes are filled with an independent
    background texture. Returns (left, right) uint8 (h, w, 3) and the
    float32 (h, w) disparity.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = _texture(rng, h, w, yy, xx)
    disp = _disparity(rng, h, w, yy, xx, max_disp)

    # Forward splat left -> right at xr = xl - d. Sort each image's pixels
    # by disparity ascending; assigning in that order makes the nearest
    # surface win collisions. Holes keep the background texture.
    right = _texture(rng, h, w, yy, xx)  # disocclusion background
    xr = (xx - disp).round().astype(np.int64)
    valid = (xr >= 0) & (xr < w)
    flat_t = (yy.astype(np.int64) * w + xr)[valid]
    flat_s = (yy.astype(np.int64) * w + xx.astype(np.int64))[valid]
    order = np.argsort(disp[valid], kind="stable")
    r2 = right.reshape(h * w, 3)
    r2[flat_t[order]] = img.reshape(h * w, 3)[flat_s[order]]
    right = r2.reshape(h, w, 3)
    return img.astype(np.uint8), right.astype(np.uint8), disp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="synthetic FSD-format stereo dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--max_disp", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    out = Path(args.out)
    for sub in ("left/rgb", "right/rgb", "left/disparity"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.n):
        left, right, disp = make_pair(rng, args.height, args.width, args.max_disp)
        Image.fromarray(left).save(out / "left/rgb" / f"{i:05d}.jpg", quality=92)
        Image.fromarray(right).save(out / "right/rgb" / f"{i:05d}.jpg", quality=92)
        Image.fromarray(depth_uint8_encoding(disp)).save(out / "left/disparity" / f"{i:05d}.png")
    print(f"wrote {args.n} pairs to {out}")


if __name__ == "__main__":
    main()
