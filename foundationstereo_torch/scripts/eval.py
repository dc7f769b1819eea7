"""Benchmark evaluation: run the model over a dataset and report metrics.

The port of the JAX package's ``scripts/eval.py``, with its flags and
output, plus ``--device`` (``cuda`` by default; ``cpu`` to run on the CPU).
It covers the reference's headline evaluation axes (Middlebury BP-2, ETH3D
bad-1, KITTI D1) on locally available data::

    python -m foundationstereo_torch.scripts.eval --dataset middlebury \\
        --root /data/middlebury [--ckpt_dir DIR_OR_PTH [--step N] [--ema 1]] \\
        [--valid_iters 32] [--scale 1.0] [--hiera 0] [--max_frames N] \\
        [--vit_size vitl] [--max_disp 416] [--out metrics.jsonl]

The model comes from ``pretrained.from_pretrained`` with ``--ckpt_dir`` (a
checkpoint directory or a reference ``.pth``; ``--vit_size`` and
``--max_disp`` are laid over its config, as in the JAX script), else it
has seeded random weights. Each frame is served through
``inference.demo.run_pair``, or ``inference.hierarchical.run_hierarchical``
with ``--hiera 1``; ``--scale`` resizes the images before and the disparity
back to the ground truth's size after (divided by the scale). Each frame's
metrics (``inference.datasets.stereo_eval_metrics``, its name and its
seconds) go to stderr as a JSON line, the mean over the frames to stdout;
``--out`` writes them as JSONL rows of ``type`` ``frame`` and ``summary``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

METRICS = ("epe", "bad05", "bad1", "bad2", "bad3", "d1_all", "rmse", "time_s")


def main(argv=None) -> tuple[list[dict], dict]:
    """Returns the frames' metric rows and the summary."""
    ap = argparse.ArgumentParser(description="benchmark evaluation on PyTorch")
    ap.add_argument("--dataset", required=True,
                    choices=["middlebury", "eth3d", "kitti2015", "kitti2012", "fsd"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--valid_iters", type=int, default=32)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--hiera", type=int, default=0)
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--vit_size", default="vitl")
    ap.add_argument("--max_disp", type=int, default=416)
    ap.add_argument("--step", default="latest",
                    help="checkpoint step to evaluate (default latest)")
    ap.add_argument("--ema", type=int, default=0,
                    help="evaluate the checkpoint's EMA weights")
    ap.add_argument("--out", default=None, help="write per-frame metrics JSONL")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.inference.datasets import DATASET_ITERATORS, stereo_eval_metrics
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.inference.hierarchical import run_hierarchical
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo, resolve_device
    from foundationstereo_torch.ops.resize import resize2d
    from foundationstereo_torch.pretrained import from_pretrained

    device = resolve_device(args.device)
    overrides = {"vit_size": args.vit_size, "max_disp": args.max_disp}
    if args.ckpt_dir:
        model, _ = from_pretrained(args.ckpt_dir, ema=bool(args.ema), step=args.step,
                                   device=device, **overrides)
        print(f"restored {args.ckpt_dir} (step {args.step})"
              f"{' (EMA weights)' if args.ema else ''}", file=sys.stderr)
    else:
        model = FoundationStereo(ModelConfig.from_dict(overrides), device=device, seed=0)

    rows = []
    out_f = open(args.out, "w") if args.out else None
    try:
        for i, sample in enumerate(DATASET_ITERATORS[args.dataset](args.root)):
            if args.max_frames and i >= args.max_frames:
                break
            left, right = (torch.from_numpy(sample[k].astype(np.float32))[None].to(device)
                           for k in ("left", "right"))
            if args.scale != 1.0:
                h, w = left.shape[1:3]
                size = (int(h * args.scale), int(w * args.scale))
                left, right = (resize2d(x.permute(0, 3, 1, 2), size, "bilinear").permute(0, 2, 3, 1)
                               for x in (left, right))

            t0 = time.perf_counter()
            if args.hiera:
                with torch.inference_mode():
                    disp = run_hierarchical(model, left, right, iters=args.valid_iters)
            else:
                disp = run_pair(model, left, right, iters=args.valid_iters)
            disp = disp[0].float().cpu()
            dt = time.perf_counter() - t0

            if args.scale != 1.0:
                disp = resize2d(disp, sample["disparity"].shape, "bilinear") / args.scale
            m = stereo_eval_metrics(disp.numpy(), sample["disparity"], sample["mask"])
            m["name"], m["time_s"] = sample["name"], round(dt, 3)
            rows.append(m)
            print(json.dumps(m), file=sys.stderr)
            if out_f:
                out_f.write(json.dumps({"type": "frame", **m}) + "\n")

        agg = {k: float(np.nanmean([r[k] for r in rows])) for k in METRICS}
        agg["frames"] = len(rows)
        agg["dataset"] = args.dataset
        print(json.dumps(agg))
        if out_f:
            out_f.write(json.dumps({"type": "summary", **agg}) + "\n")
    finally:
        if out_f:
            out_f.close()
    return rows, agg


if __name__ == "__main__":
    main()
