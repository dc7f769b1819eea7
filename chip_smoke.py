#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``foundationstereo_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one CUDA card

Phases:

1. env     -- the card's name and power limit (nvidia-smi), torch / CUDA
              versions, the TF32 settings this run uses (both off).
2. build   -- compile the four CUDA kernels from ``foundationstereo_torch/csrc``
              (one nvcc per source, in parallel) and print the build seconds.
3. kernels -- each kernel against its plain PyTorch twin on the card, at the
              shapes of the main path (ViT-L, max_disp 416, 736x1280): max abs
              error against the stated tolerance (and relative to max |twin|),
              kernel / plain / library times (CUDA events) and the least time
              the card could take (``bound_ms``, from the bytes and operations
              of this run's inputs). The lookups' log lines (K2 here, K5's
              lookup in the mesh phase) add their sector floor: the unique
              32-byte sectors the run's windows touch, plus the disparities
              and the output, at the card's memory rate (K2's line also with
              the geometry pyramid's channels innermost, a layout the port
              does not use yet); their ``library_ms`` is
              ``F.grid_sample`` once per level and volume. The lookup and
              cost-volume rows carry the grid their C entry points report
              (``kernels.LOOKUP_LAUNCHED``, ``kernels.COST_VOLUME_LAUNCHED``),
              checked against ``kernels.lookup_grid`` and
              ``kernels.cost_volume_grid``. For the attention rows (K3 here, K3s in
              the mesh phase) the operations are of two kinds, the products
              at the bf16 tensor-core peak and one ex2 per score on the SFUs
              (16 per SM per clock at the SM clock nvidia-smi reads; the log
              line gives this exp time), and the rows carry the grid they
              launched (``kernels.FLASH_ATTENTION_LAUNCHED``; the log adds
              its waves); the fp32 variant is timed beside SDPA in fp32. The 3x3 conv (K4) is
              held at six shapes of the main path (the largest refinement
              conv, a ragged
              F = 127, the 1/16 level, the hourglass's (1, 3, 3) conv on the
              5D volume, the F = 64 mask conv, the 1/8 level), each in bf16
              and in fp32, each with its grid's size. The fp32 rows (K3, K4,
              K3s) carry two bounds: the FMA one (``fp32_bound_ms``, at the
              fp32 peak) and the three-pass TF32 one the kernels are judged
              against (``fp32_tf32x3_bound_ms``, 3 x the products at the TF32
              peak).
4. path    -- the whole forward at a reduced size (448x672, 4 iterations)
              through the kernels, through the kernels with the 3x3 conv
              kernel (``pallas_conv3x3``), and through the plain twins, with
              the same weights and bf16 pyramids; both kernel runs must agree
              with the plain one. Then the model without mixed precision
              through the fp32 kernels with the 3x3 conv kernel against the
              plain twins (fp32 pyramids on both): max |d disp| <= 1e-2 px,
              launches counted.
5. serve   -- the full configuration (ViT-L, max_disp 416, bf16, seeded
              random weights) answers 3 requests of 736x1280 pairs through
              ``inference.demo.run_pair`` with 32 iterations; the output must
              be finite and of the right shape, and the launch counts must be
              1 cost-volume, 24 attention and 32 lookup launches per pair (no conv
              launches: the served configuration keeps pallas_conv3x3 off).
6. demo    -- the same configuration with ``pallas_conv3x3`` answers demo
              requests through ``inference.demo.infer``: 2 pinhole pairs of
              736x1280 with the hierarchical two-pass (depth and a point cloud
              with outlier removal, written to a temporary directory) and 1
              panorama pair of 640x1280 in one pass; disparities finite and of
              the input's shape, clouds non-empty, and per pass 1 cost-volume,
              24 attention, 32 lookup and K4_OUTSIDE + 32 x K4_PER_ITER conv
              launches.
7. mesh    -- the multi-device path on a data 1 x spatial 4 mesh that names
              the first card four times (``make_mesh(devices=[cuda:0] * 4)``:
              each shard runs at the per-device shapes of a 4-card mesh).
              The width-sharded cost-volume build and lookup (K5) and the
              head-sharded ViT attention (K3s) against their plain twins for
              every shard at the main-path shapes, with times and bounds
              per shard, and their stitched outputs against K1, K2 and K3
              (bit for bit); then the served configuration answers 3
              requests through ``run_pair`` under ``mesh_context``: per pair
              4 build, 128 lookup and 96 attention launches, no K1-K4
              launches, and the disparity of the unsharded forward on the
              same pairs, served before and after (their seconds and peak
              memory are printed beside). K3s's fp32 variant is held per
              shard (1e-5) and stitched (bit for bit) on the same values.
              With two or more cards the same requests run with the shards
              on distinct cards and must give the same disparity.
8. train   -- the train CLI on configs/train/stereo_v1.json (see
              ``train_phase``).
9. offline -- the offline entry points on the served configuration, from
              seeded weights written by ``save_pretrained``: the directory
              and a ``.pth`` through ``from_pretrained`` (disparity bit for
              bit the in-memory model's); eval fixtures at the KITTI 2015
              frame size (375x1242) through ``scripts.eval`` over the
              Middlebury, ETH3D and KITTI 2015 layouts (32 iterations), one
              ``--hiera 1`` and one ``--scale 0.5`` frame, with exact K1/K2/K3
              launches per frame (``pass_launches``), finite summaries and
              the JSONL rows; ``scripts.make_export`` at 448x672, 22
              iterations, symbolic batch, whose loaded program at batch 1
              and 2 launches what the eager forward launches and gives its
              disparity (bit for bit, else mean <= 0.05 px, p99 <= 0.5 px);
              the export's seconds and bytes, warm seconds per call of the
              loaded program and the eager forward in turns, and the host's
              microseconds per call of each ``torch.ops.fs`` operator.

``--profile`` adds a per-module and per-op time breakdown of one 736x1280 pair
for the served configuration, for the one with the 3x3 conv kernel (with
K4's launches, device time and bound per conv shape) and for the served
configuration under the mesh, each with the device time and launches of
K1 / K5's build, K2 / K5's lookup and K3 / K3s under the profiler; and, in
the demo phase, one fp32 pair (``mixed_precision=False``) with the 3x3 conv
kernel: K4's per-shape accounting and the fp32 K3 and K4 device time and
launches (24 and 565).

It then prints the ``{"kernels": [...]}`` line (``launches`` counted over the
phase a row's kernel runs in: the demo phase for K1-K4, the mesh phase's
sharded requests for K5 and K3s; ``offline_launches`` over the offline
phase) and, last, the ``{"ok": true, "device":
{...}}`` line. Any failed check raises, so the exit code is non-zero and no
result line is printed. Without a CUDA device it exits with code 1 before
any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# and TF32 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
FP32_FLOPS = 67e12

MAIN = dict(vit_size="vitl", max_disp=416, height=736, width=1280, iters=32)
# The reduced whole-path comparison: 448x672 still gives the ViT 1537 > 1024
# tokens, so the attention kernel runs.
PATH = dict(height=448, width=672, iters=4)
REQUESTS = 3
# Demo phase: pinhole pairs through the hierarchical two-pass, then one
# equirectangular (2:1) panorama pair in one pass.
DEMO = dict(pinhole=2, panorama_hw=(640, 1280), fx=1000.0, baseline=0.12)
# Routed 3x3 convs of ViT-L per pass, outside the refinement loop and per
# iteration: the counts tests/test_torch_conv3x3.py holds against the JAX
# package's routing.
K4_OUTSIDE, K4_PER_ITER = 53, 16
# The mesh phase: data 1 x spatial 4 (make_mesh's factoring of 4 devices).
MESH_SHARDS = 4
# ViT tokens at the main path: 736x1280 is resized to 784x1344 patches of 14.
VIT_TOKENS = (784 // 14) * (1344 // 14) + 1
# The train phase: the train CLI on configs/train/stereo_v1.json (ViT-L,
# max_disp 192, 22 iterations, bf16, AdamW, EMA) over a dataset written
# here; its 736x320 crops reach the ViT as 784x336, 1345 tokens
# (7 x 192 + 1 query rows, 21 x 64 + 1 keys: one-row tails).
TRAIN = dict(config="configs/train/stereo_v1.json", batch=2, steps=4, save_every=2,
             resume_steps=2, pairs=8, pair_hw=(400, 800))
TRAIN_VIT_TOKENS = (784 // 14) * (336 // 14) + 1
# The offline phase: eval fixtures at the KITTI 2015 frame size (2 frames per
# layout, disparities up to 192), and the export at scripts/make_export.py's
# shape and iteration count.
OFFLINE = dict(eval_hw=(375, 1242), eval_frames=2, fixture_max_disp=192,
               export_hw=(448, 672), export_iters=22)
# The kernels the offline path runs (the served configuration: no K4).
OFFLINE_KERNELS = ("cost_volume_parts", "disparity_lookup", "flash_attention")
# K4 at the main path's shapes: (name, C, F, spatial after the channel axis,
# dtype). Every tile path of either type is among them.
_H4, _W4 = MAIN["height"] // 4, MAIN["width"] // 4
_K4_SHAPES = [
    ("gru04.conv1 512->512", 512, 512, (_H4, _W4)),
    ("encoder.conv 320->127", 320, 127, (_H4, _W4)),
    ("gru16 z/r 384->256", 384, 256, (_H4 // 4, _W4 // 4)),
    ("hourglass (1,3,3) 168->168, 5D", 168, 168,
     (MAIN["max_disp"] // 32, MAIN["height"] // 32, MAIN["width"] // 32)),
    ("mask.0 128->64", 128, 64, (_H4, _W4)),
    ("gru08.conv1 512->512", 512, 512, (_H4 // 2, _W4 // 2)),
]
K4_CASES = ([(n, c, f, sp, "bfloat16") for n, c, f, sp in _K4_SHAPES]
            + [(f"{n} fp32", c, f, sp, "float32") for n, c, f, sp in _K4_SHAPES])
# K4's kernels in a profiler's kernel names.
K4_KERNEL = re.compile(r"conv3x3_\w+(<[^>]*>)?")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call over ``reps`` calls, timed with CUDA
    events. The calls queue behind a device sleep (~1.5 ms per call at the
    card's clock), so that the host's launch overhead does not leave the card
    idle between them: the time is the device's, not the host's."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e6 * reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host microseconds per call over ``calls`` calls that queue on the card
    without a synchronisation between them (the host's own cost where the
    kernel is shorter)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fp32_bounds(nbytes: float, flops: float) -> tuple[float, float, str]:
    """(FMA bound ms, three-pass TF32 bound ms, what bounds the latter) of
    an fp32 product: the FLOPs on the fp32 FMA units, or three times them
    on the TF32 tensor cores (the kernels' hi/lo split), each against the
    bytes. The kernels are judged against the second."""
    fma_ms, _ = bound(nbytes, flops, FP32_FLOPS)
    tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS)
    return fma_ms, tc_ms, tc_by


def bf16_ulp(x):
    import torch

    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sm_clock_mhz() -> float:
    """The first card's maximum SM clock as nvidia-smi reads it (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def exp_ms(scores: float, sms: int, clock_mhz: float) -> float:
    """The least time of one ex2 per attention score on the SFUs: 16 per SM
    per clock at the given SM clock."""
    return scores / (16.0 * sms * clock_mhz * 1e6) * 1e3


def attention_bound(nbytes: float, flops: float, scores: float, sms: int,
                    clock_mhz: float) -> tuple[float, str, float]:
    """(bound ms, bound by, exp ms) of bf16 attention: ``bound`` with the
    softmax's exponentials as a second kind of operation, so the larger of
    the bytes, the products at the tensor-core peak and the exp time."""
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    e_ms = exp_ms(scores, sms, clock_mhz)
    return max(b_ms, e_ms), ("operations" if e_ms > b_ms else b_by), e_ms


def attention_launched() -> dict:
    """The last K3 / K3s launch's grid size and block tile, as its C entry
    point reported them."""
    from foundationstereo_torch.ops import kernels

    (gx, gy, gz), (rows, keys, threads) = (kernels.FLASH_ATTENTION_LAUNCHED[k] for k in ("grid", "tile"))
    return dict(blocks=gx * gy * gz, tile=f"{rows} query rows x {keys} keys, {threads} threads")


def attention_errors(out, ref) -> tuple[float, float, float, float, float, float, bool]:
    """(max abs err, its tolerance, mean abs err, its tolerance, max |ref|,
    mean |ref|, within both) of bf16 attention against the fp32 dense
    reference. bf16 output rounding costs half an ulp, the bf16 probabilities
    in P @ V a little more: max error <= 2 bf16 ulps of max |ref|, mean error
    <= 1 bf16 ulp of the typical |ref| (a skipped key tile, a wrong scale or a
    bad tail mask moves the mean by far more)."""
    import torch

    diff = (out.float() - ref).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    ref_max, ref_mean = float(ref.abs().max()), float(ref.abs().mean())
    del diff
    tol_max = 2 * float(bf16_ulp(torch.tensor(ref_max)))
    tol_mean = float(bf16_ulp(torch.tensor(ref_mean)))
    return err, tol_max, mean_err, tol_mean, ref_max, ref_mean, err <= tol_max and mean_err <= tol_mean


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins at the main-path shapes
# ---------------------------------------------------------------------------


def cost_volume_inputs(dev, gen):
    """K1's inputs at the main path's shapes: bf16 left / right features
    (B, 224, H/4, W/4), the right projection (B, 12, H/4, W/4), and (D,
    G, P)."""
    import torch

    B, C, H, W, G, P, D = 1, 224, MAIN["height"] // 4, MAIN["width"] // 4, 8, 12, MAIN["max_disp"] // 4
    left, right = (torch.randn(B, C, H, W, device=dev, generator=gen).bfloat16() for _ in range(2))
    rp = torch.randn(B, P, H, W, device=dev, generator=gen).bfloat16()
    return left, right, rp, D, G, P


def cost_volume_errors(gk, rk, gp, rpp) -> tuple[float, bool]:
    """(max abs err, within tolerance) of the kernel's parts against the
    twin's: gwc within 1 bf16 ulp of the larger value plus 2e-6 for the fp32
    sums over cg = 28 products taken in another order (it matters only where
    they cancel); rps exact."""
    import torch

    gk32, gp32 = gk.float(), gp.float()
    err = (gk32 - gp32).abs()
    ok = bool((err <= bf16_ulp(torch.maximum(gk32.abs(), gp32.abs())) + 2e-6).all())
    ok = ok and bool(torch.equal(rk, rpp))
    return max(float(err.max()), float((rk.float() - rpp.float()).abs().max())), ok


def lookup_errors(out, ref) -> tuple[float, bool]:
    """(max abs err, within tolerance) of the lookup against its twin: both
    accumulate in fp32 and round once to bf16, so 1 bf16 ulp of the larger
    value, plus 1e-6 for the fp32 sums taken in another order."""
    import torch

    o32, r32 = out.float(), ref.float()
    diff = (o32 - r32).abs()
    return float(diff.max()), bool((diff <= bf16_ulp(torch.maximum(o32.abs(), r32.abs())) + 1e-6).all())


def check_cost_volume(dev, gen) -> dict:
    import torch

    from foundationstereo_torch.ops import cost_volume, kernels

    left, right, rp, D, G, P = cost_volume_inputs(dev, gen)
    B, C, H, W = left.shape
    gk, rk = kernels.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16)
    grid = cost_volume_launched(left, D, G, P)
    gp, rpp = cost_volume.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    max_err, ok = cost_volume_errors(gk, rk, gp, rpp)
    rel = max_err / float(gp.float().abs().max())
    log(f"[kernels] cost_volume_parts: max abs err {max_err:.3g}, rel {rel:.3g} (tolerance: gwc "
        f"1 bf16 ulp + 2e-6 per element, rps exact -> {ok})")
    check(ok, "cost_volume_parts disagrees with its twin")

    ms = cuda_ms(lambda: kernels.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16), 20)
    plain_ms = cuda_ms(lambda: cost_volume.cost_volume_parts(left, right, rp, D, G,
                                                             out_dtype=torch.bfloat16), 3)
    nbytes = sum(t.numel() * t.element_size() for t in (left, right, rp, gk, rk))
    flops = 2.0 * C * B * H * sum(max(W - d, 0) for d in range(D))
    b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
    log(f"[kernels] cost_volume_parts: {ms:.4g} ms, bound {b_ms:.4g} ms ({b_by}), "
        f"{nbytes / ms / 1e9:.4g} TB/s; grid {grid['blocks']} blocks ({grid['tile']})")
    return dict(name="cost_volume_parts", route="cuda",
                source="foundationstereo_torch/csrc/cost_volume.cu",
                replaces="foundationstereo_tpu/ops/pallas_kernels.py:598",
                max_abs_err=max_err, max_rel_err=rel,
                tolerance="1 bf16 ulp + 2e-6 per element (rps exact)",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                grid=grid)


def cost_volume_launched(left, d, groups, p) -> dict:
    """The last cost-volume launch's blocks and block tile, as its C entry
    point reported them, checked against ``kernels.cost_volume_grid``."""
    from foundationstereo_torch.ops import kernels

    (gx, gy, gz), (threads, cols, disps) = (kernels.COST_VOLUME_LAUNCHED[k] for k in ("grid", "tile"))
    b, _, h, w = left.shape
    want = kernels.cost_volume_grid(b, h, w, d, groups, p)
    check(((gx, gy, gz), threads) == want, f"cost volume launched {((gx, gy, gz), threads)}, "
                                           f"helper {want}")
    return dict(blocks=gx * gy * gz, grid=[gx, gy, gz],
                tile=f"{threads} threads, {cols} columns x {disps} disparities, 8x8 per thread")


def _pyramids(dev, gen, levels, dtype):
    import torch

    from foundationstereo_torch.ops.sampler import pool_last_axis

    B, C, H, W, D = 1, 28, MAIN["height"] // 4, MAIN["width"] // 4, MAIN["max_disp"] // 4
    geo = torch.rand(B, H, W, C, D, device=dev, generator=gen) * 2 - 1
    corr = torch.rand(B, H, W, W, device=dev, generator=gen) * 2 - 1
    geo_p = [g.to(dtype).contiguous() for g in pool_last_axis(geo, levels - 1)]
    corr_p = [c.to(dtype).contiguous() for c in pool_last_axis(corr, levels - 1)]
    disp = torch.rand(B, H, W, device=dev, generator=gen) * (D + 8) - 4
    disp[0, 0, :16] = torch.arange(16, device=dev, dtype=torch.float32)    # exact integers
    disp[0, 1, :4] = torch.tensor([-100.0, 1e4, -0.5, D - 0.5], device=dev)  # extremes
    return geo_p, corr_p, disp


def check_lookup(dev, gen) -> dict:
    import torch

    from foundationstereo_torch.ops import kernels, sampler

    r, levels = 4, 4
    geo, corr, disp = _pyramids(dev, gen, levels, torch.bfloat16)
    out = kernels.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16)
    grid = lookup_launched(geo, disp)
    ref = sampler.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err, ok = lookup_errors(out, ref)
    rel = err / float(ref.float().abs().max())
    log(f"[kernels] disparity_lookup: out {tuple(out.shape)}, max abs err {err:.3g}, rel {rel:.3g} "
        f"(tolerance: 1 bf16 ulp + 1e-6 per element -> {ok}; inputs in [-1, 1])")
    check(ok, "disparity_lookup disagrees with its twin")

    ms = cuda_ms(lambda: kernels.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16), 20)
    plain_ms = cuda_ms(lambda: sampler.disparity_lookup(geo, corr, disp, r,
                                                        out_dtype=torch.bfloat16), 3)

    library_ms = cuda_ms(lookup_library(geo, corr, disp, r), 5)
    b_ms, b_by = lookup_bound(geo, corr, disp, r, out)
    sector_ms = lookup_sector_bound(geo, corr, disp, r, out)
    cl_ms = lookup_sector_bound(geo, corr, disp, r, out, channels_last=True)
    log(f"[kernels] disparity_lookup: {ms:.4g} ms, bound {b_ms:.4g} ms ({b_by}), sector floor "
        f"{sector_ms:.4g} ms ({cl_ms:.4g} ms were the geometry channels innermost), "
        f"F.grid_sample x {2 * levels} {library_ms:.4g} ms; grid "
        f"{grid['blocks']} blocks ({grid['tile']})")
    return dict(name="disparity_lookup", route="cuda",
                source="foundationstereo_torch/csrc/lookup.cu",
                replaces="foundationstereo_tpu/ops/pallas_kernels.py:112",
                max_abs_err=err, max_rel_err=rel, tolerance="1 bf16 ulp + 1e-6 per element",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, grid=grid)


def lookup_library(geo, corr, disp, r, x_offset=0):
    """One library call per level and volume computing the lookup:
    ``F.grid_sample`` over (pixel, 1, L) rows at the same positions (the
    correlation's with the global x offset). Returns the callable."""
    import torch
    import torch.nn.functional as F

    B, H, W, C = geo[0].shape[:4]
    n = B * H * W
    k = torch.arange(-r, r + 1, device=disp.device, dtype=torch.float32)
    xs = torch.arange(W, device=disp.device, dtype=torch.float32) + x_offset
    grids = []
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for x, L in (((disp * s)[..., None] + k, g.shape[-1]),
                     (((xs - disp) * s)[..., None] + k, c.shape[-1])):
            gx = (2.0 * x / (L - 1) - 1.0).reshape(n, 1, 2 * r + 1, 1)
            grids.append(torch.cat([gx, torch.zeros_like(gx)], dim=-1).to(g.dtype))

    def library():
        for i, (g, c) in enumerate(zip(geo, corr)):
            F.grid_sample(g.view(n, C, 1, g.shape[-1]), grids[2 * i], align_corners=True)
            F.grid_sample(c.view(n, 1, 1, c.shape[-1]), grids[2 * i + 1], align_corners=True)

    return library


def lookup_launched(geo, disp) -> dict:
    """The last lookup launch's blocks and block tile, as its C entry point
    reported them, checked against ``kernels.lookup_grid``."""
    from foundationstereo_torch.ops import kernels

    (gx, gy, gz), (threads, pixels, radius) = (kernels.LOOKUP_LAUNCHED[k] for k in ("grid", "tile"))
    want = kernels.lookup_grid(*disp.shape, len(geo), geo[0].shape[3])
    check((gx, gy, gz) == want, f"lookup launched grid {(gx, gy, gz)}, helper {want}")
    return dict(blocks=gx * gy * gz, grid=[gx, gy, gz],
                tile=f"{threads} threads x {pixels} pixels, radius {radius}")


def lookup_sectors(geo, corr, disp, r, x_offset=0, channels_last=False) -> int:
    """The unique 32-byte sectors of the pyramids that this run's windows
    touch: for each level, volume, pixel (and geometry channel), the
    in-range part of the 2r+2 values from floor(position) - r, as bytes at
    the tensors' own addresses. With ``channels_last`` the geometry levels
    are counted as if laid out (B, H, W, D_l, C) in the same allocation: a
    pixel's C windows are then one run of (2r+2) C values."""
    import torch

    C = geo[0].shape[3]
    xs = torch.arange(disp.shape[-1], device=disp.device, dtype=torch.float32) + x_offset
    total = 0
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for vol, x, ch in ((g, disp * s, C), (c, (xs - disp) * s, 1)):
            L, es = vol.shape[-1], vol.element_size()
            i0 = torch.floor(x.clamp(-(L + 2 * r + 2), L + 2 * r + 2)).long().reshape(-1)
            lo, hi = (i0 - r).clamp(0, L), (i0 + r + 2).clamp(0, L)
            # ch runs of span-value elements per pixel, each row L * span long
            ch, span = (1, ch) if channels_last and vol is g else (ch, 1)
            rows = (torch.arange(i0.numel(), device=x.device)[:, None] * ch
                    + torch.arange(ch, device=x.device)[None, :])         # (pixels, ch)
            keep = (hi > lo)[:, None].expand_as(rows)
            start = vol.data_ptr() + (rows * L + lo[:, None]) * span * es
            end = vol.data_ptr() + (rows * L + hi[:, None]) * span * es - 1
            s0, s1 = (start[keep] >> 5), (end[keep] >> 5)
            base = vol.data_ptr() >> 5
            marks = torch.zeros(((vol.data_ptr() + vol.numel() * es - 1) >> 5) - base + 1,
                                dtype=torch.bool, device=x.device)
            for k in range(int((s1 - s0).max()) + 1 if s0.numel() else 0):
                sec = s0 + k
                marks[(sec[sec <= s1] - base)] = True
            total += int(marks.sum())
    return total


def lookup_sector_bound(geo, corr, disp, r, out, x_offset=0, channels_last=False) -> float:
    """The lookup's floor in ms at the card's memory rate: the unique
    32-byte sectors its windows touch (``lookup_sectors``), plus the
    disparities and the output."""
    nbytes = (32 * lookup_sectors(geo, corr, disp, r, x_offset, channels_last)
              + disp.numel() * 4 + out.numel() * out.element_size())
    return nbytes / HBM_BPS * 1e3


def lookup_bound(geo, corr, disp, r, out, x_offset=0) -> tuple[float, str]:
    """The lookup's bound from the bytes this run's positions need: the
    in-range part of each 2r+2 window, the disparities and the output."""
    import torch

    C = geo[0].shape[3]
    xs = torch.arange(disp.shape[-1], device=disp.device, dtype=torch.float32) + x_offset
    touched = 0
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for x, L, ch in ((disp * s, g.shape[-1], C), ((xs - disp) * s, c.shape[-1], 1)):
            i0 = torch.floor(x.clamp(-(L + 2 * r + 2), L + 2 * r + 2))
            lo, hi = (i0 - r).clamp(0, L), (i0 + r + 2).clamp(0, L)
            touched += float((hi - lo).clamp_min(0).sum()) * ch
    nbytes = touched * geo[0].element_size() + disp.numel() * 4 + out.numel() * out.element_size()
    return bound(nbytes, 4.0 * out.numel(), FP32_FLOPS)


def check_attention(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    B, N, Hh, hd = 2, VIT_TOKENS, 16, 64
    scale = 1.0 / math.sqrt(hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qkv = torch.randn(B, N, 3, Hh, hd, device=dev, generator=gen).bfloat16()
    out = kernels.flash_attention(qkv, scale)
    grid = attention_launched()
    ref = kernels.flash_attention_plain(qkv.float(), scale)    # dense, fp32 throughout
    torch.cuda.synchronize()
    err, tol_max, mean_err, tol_mean, ref_max, ref_mean, ok = attention_errors(out, ref)
    log(f"[kernels] flash_attention bf16: N={N}, max abs err {err:.3g} (tolerance {tol_max:.3g} "
        f"= 2 bf16 ulps of max |ref| {ref_max:.3g}), mean abs err {mean_err:.3g} (tolerance "
        f"{tol_mean:.3g} = 1 bf16 ulp of mean |ref| {ref_mean:.3g}) vs fp32 dense")
    check(ok, "flash_attention disagrees with the fp32 dense reference")

    # The fp32 kernel (the model without mixed precision) on the same inputs.
    qkv32 = qkv.float()
    out32 = kernels.flash_attention(qkv32, scale)
    grid32 = attention_launched()
    torch.cuda.synchronize()
    err32, mean32 = float((out32 - ref).abs().max()), float((out32 - ref).abs().mean())
    del ref, out32
    log(f"[kernels] flash_attention fp32: N={N}, max abs err {err32:.3g}, mean abs err {mean32:.3g} "
        f"vs fp32 dense (tolerance 1e-5: three-pass TF32 products, ~2^-21 of each, and sums "
        f"in another order)")
    check(err32 <= 1e-5, "fp32 flash_attention disagrees with the fp32 dense reference")
    fp32_ms = cuda_ms(lambda: kernels.flash_attention(qkv32, scale), 5)
    fp32_bound_ms, fp32_tc_ms, _ = fp32_bounds(qkv32.numel() * 4 * 4 / 3, 4.0 * B * Hh * N * N * hd)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in qkv32.unbind(2))
    fp32_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 3)
    del qkv32, qs, ks, vs

    ms = cuda_ms(lambda: kernels.flash_attention(qkv, scale), 10)
    plain_ms = cuda_ms(lambda: kernels.flash_attention_plain(qkv, scale), 3)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 10)
    nbytes = qkv.numel() * 2 + out.numel() * 2
    flops = 4.0 * B * Hh * N * N * hd
    clock = sm_clock_mhz()
    b_ms, b_by, e_ms = attention_bound(nbytes, flops, B * Hh * N * N, sms, clock)
    log(f"[kernels] flash_attention fp32: {fp32_ms:.4g} ms, three-pass TF32 bound {fp32_tc_ms:.4g} ms "
        f"(3 x products at the TF32 peak), FMA bound {fp32_bound_ms:.4g} ms (at the fp32 peak); "
        f"SDPA in fp32 {fp32_library_ms:.4g} ms; grid {grid32['blocks']} blocks ({grid32['tile']}), "
        f"{grid32['blocks'] / sms:.2f} waves")
    log(f"[kernels] flash_attention bf16: {ms:.4g} ms, {flops / ms / 1e9:.4g} TF/s; bound "
        f"{b_ms:.4g} ms ({b_by}), exp {e_ms:.4g} ms (one ex2 per score, 16 per SM per clock at "
        f"{clock:.0f} MHz); SDPA {library_ms:.4g} ms; grid {grid['blocks']} blocks "
        f"({grid['tile']}), {grid['blocks'] / sms:.2f} waves on {sms} SMs")
    return dict(name="flash_attention", route="cuda",
                source="foundationstereo_torch/csrc/flash_attention.cu",
                replaces="foundationstereo_tpu/models/dinov2.py:71",
                max_abs_err=err, max_rel_err=err / ref_max, mean_abs_err=mean_err,
                ref_max_abs=ref_max, ref_mean_abs=ref_mean,
                tolerance="max <= 2 bf16 ulps of max |ref|, mean <= 1 bf16 ulp of mean |ref|, "
                          "vs fp32 dense",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                grid=grid, fp32_max_abs_err=err32, fp32_mean_abs_err=mean32, fp32_ms=fp32_ms,
                fp32_bound_ms=fp32_bound_ms, fp32_tf32x3_bound_ms=fp32_tc_ms,
                fp32_library_ms=fp32_library_ms, fp32_grid=grid32)


def check_attention_train_shape(dev, gen) -> dict:
    """K3 at the train phase's shape: both views of a batch of 2 through the
    ViT, (4, 1345, 3, 16, 64) bf16, against the fp32 dense twin, with its
    time, bound and SDPA's time. Its row's launches are the train phase's."""
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    B, N, Hh, hd = 2 * TRAIN["batch"], TRAIN_VIT_TOKENS, 16, 64
    scale = 1.0 / math.sqrt(hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qkv = torch.randn(B, N, 3, Hh, hd, device=dev, generator=gen).bfloat16()
    out = kernels.flash_attention(qkv, scale)
    grid = attention_launched()
    ref = kernels.flash_attention_plain(qkv.float(), scale)
    torch.cuda.synchronize()
    err, tol_max, mean_err, tol_mean, ref_max, ref_mean, ok = attention_errors(out, ref)
    # The rows of the last query tile and the last key, alone: the one-row tails.
    tail_err = float((out[:, -1].float() - ref[:, -1]).abs().max())
    del ref
    log(f"[kernels] flash_attention bf16 at the training shape: B={B}, N={N}, max abs err {err:.3g} "
        f"(tolerance {tol_max:.3g}), mean abs err {mean_err:.3g} (tolerance {tol_mean:.3g}), "
        f"last query row max abs err {tail_err:.3g}; grid {grid['blocks']} blocks "
        f"(expected {kernels.flash_attention_blocks(N, B * Hh)})")
    check(ok and tail_err <= tol_max, "flash_attention disagrees at the training shape")
    check(grid["blocks"] == kernels.flash_attention_blocks(N, B * Hh), f"grid {grid}")
    ms = cuda_ms(lambda: kernels.flash_attention(qkv, scale), 10)
    plain_ms = cuda_ms(lambda: kernels.flash_attention_plain(qkv, scale), 3)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 10)
    nbytes = qkv.numel() * 2 + out.numel() * 2
    flops = 4.0 * B * Hh * N * N * hd
    b_ms, b_by, e_ms = attention_bound(nbytes, flops, B * Hh * N * N, sms, sm_clock_mhz())
    log(f"[kernels] flash_attention bf16 at the training shape: {ms:.4g} ms, "
        f"{flops / ms / 1e9:.4g} TF/s; bound {b_ms:.4g} ms ({b_by}), exp {e_ms:.4g} ms; plain "
        f"{plain_ms:.4g} ms; SDPA {library_ms:.4g} ms")
    return dict(name="flash_attention", route="cuda",
                source="foundationstereo_torch/csrc/flash_attention.cu",
                replaces="foundationstereo_tpu/models/dinov2.py:71", phase="train",
                shape=f"qkv ({B}, {N}, 3, {Hh}, {hd}) bf16", max_abs_err=err,
                max_rel_err=err / ref_max, mean_abs_err=mean_err, tail_row_max_abs_err=tail_err,
                tolerance="max <= 2 bf16 ulps of max |ref|, mean <= 1 bf16 ulp of mean |ref|, "
                          "vs fp32 dense",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                grid=grid)


def _conv_case(dev, gen, c, f, spatial, dtype):
    import torch

    x = torch.randn(1, c, *spatial, device=dev, generator=gen).to(dtype)
    w = torch.randn(f, c, 3, 3, device=dev, generator=gen) / math.sqrt(9 * c)
    bias = 0.1 * torch.randn(f, device=dev, generator=gen)
    return x, w, bias


def _conv_errors(x, w, bias, out, ref):
    """(max abs err, mean abs err, per-element check, mean check) of the
    kernel's output against the twin's.

    Per element: both sum the same 9*C exact products in fp32 in another
    order, so each is within (K - 1) * 2^-24 * S of the exact sum (K = 9*C
    terms, S = sum of |x * w| + |bias|, recursive summation); the two within
    twice that. bf16 outputs then round once each: 1 bf16 ulp of the larger.

    fp32: the kernel's products are no longer exact fp32 products. Each is
    the three-pass TF32 sum lo_x hi_w + hi_x lo_w + hi_x hi_w, within
    3 * 2^-22 of x * w (the dropped lo_x lo_w and the two split residuals),
    so 12 * 2^-24 * S in all. The tensor cores add each 8-channel K step
    into a partial sum of one 16-channel chunk (3 * 18 steps, each rounded
    toward zero: 2^-23 of the sums it touches) and the C / 16 partials are
    added in fp32 to nearest: within (108 + C / 16) * 2^-24 * S. With the
    twin's (K - 1) * 2^-24 * S the two stay within the same limit for every
    C >= 16, since 108 + C / 16 + 12 <= K - 1 = 9C - 1.

    Mean: a skipped tap, row or channel moves the mean error by a sizeable
    part of mean |ref|; rounding and order alone keep it under half the
    mean bf16 ulp of |ref| (bf16) or 1e-5 x mean |ref| (fp32; a model of
    the round-toward-zero adds puts one accumulator over all K terms at ~4x
    this, one per chunk at ~0.13x).
    """
    import torch

    from foundationstereo_torch.ops import kernels

    k = 9 * x.shape[1]
    s = kernels.conv3x3_plain(x.float().abs(), w.to(x.dtype).float().abs(), bias.abs())
    o32, r32 = out.float(), ref.float()
    diff = (o32 - r32).abs()
    tol = 2 * (k - 1) * 2.0 ** -24 * s
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(o32.abs(), r32.abs()))
        mean_tol = 0.5 * float(bf16_ulp(r32).mean())
    else:
        mean_tol = 1e-5 * float(r32.abs().mean())
    mean_err = float(diff.mean())
    return float(diff.max()), mean_err, bool((diff <= tol).all()), mean_err <= mean_tol


def k4_launched() -> dict:
    """The last K4 launch's blocks and block tile, as its C entry point
    reported them."""
    from foundationstereo_torch.ops import kernels

    (gx, gy, gz), (rows, cols, ch) = (kernels.CONV3X3_LAUNCHED[k] for k in ("grid", "tile"))
    return dict(blocks=gx * gy * gz, tile=f"{rows}x{cols} px x {ch} ch")


def check_conv3x3(dev, gen) -> dict:
    """K4 at every case of ``K4_CASES`` against its twin; the row is the
    first (largest) bf16 conv's, with the fp32 variant of the same shape in
    its ``fp32_*`` keys and every case under ``cases``."""
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = None
    for name, c, f, spatial, dtype in K4_CASES:
        dtype = getattr(torch, dtype)
        x, w, bias = _conv_case(dev, gen, c, f, spatial, dtype)
        packed = kernels.pack_conv3x3_weight(w, dtype)
        out = kernels.conv3x3(x, w, bias, packed)
        grid = k4_launched()
        ref = kernels.conv3x3_plain(x, w, bias)
        torch.cuda.synchronize()
        err, mean_err, ok, mean_ok = _conv_errors(x, w, bias, out, ref)
        ms = cuda_ms(lambda: kernels.conv3x3(x, w, bias, packed), 10)
        x4 = x if x.ndim == 4 else x.transpose(1, 2).reshape(-1, c, *spatial[1:])
        wl, bl = w.to(dtype), bias.to(dtype)
        library_ms = cuda_ms(lambda: F.conv2d(x4, wl, bl, padding=1), 10)
        flops = 2.0 * 9 * c * f * x[0, 0].numel()
        nbytes = (x.numel() + 9 * c * f + out.numel()) * x.element_size() + 4 * f
        bounds = {}
        if dtype == torch.bfloat16:
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            text = f"bound {b_ms:.4g} ms ({b_by})"
        else:
            fma_ms, b_ms, b_by = fp32_bounds(nbytes, flops)
            bounds = dict(fma_bound_ms=fma_ms)
            text = (f"three-pass TF32 bound {b_ms:.4g} ms ({b_by}), FMA bound {fma_ms:.4g} ms, "
                    f"{3 * flops / ms / 1e9:.4g} TF/s in TF32 passes")
        log(f"[kernels] conv3x3 {name} {tuple(x.shape)}: max abs err {err:.3g}, mean abs err "
            f"{mean_err:.3g} (per element <= {'1 bf16 ulp + ' if dtype == torch.bfloat16 else ''}"
            f"2(9C-1) 2^-24 sum|x w| -> {ok}; mean -> {mean_ok}); {ms:.4g} ms, F.conv2d "
            f"{library_ms:.4g} ms, {text}, {flops / ms / 1e9:.4g} TFLOP/s; grid {grid['blocks']} "
            f"blocks ({grid['tile']}) on {sms} SMs")
        check(ok and mean_ok, f"conv3x3 {name} disagrees with its twin")
        if row is None:                              # the largest bf16 conv is the row's shape
            plain_ms = cuda_ms(lambda: kernels.conv3x3_plain(x, w, bias), 2)
            row = dict(name="conv3x3", route="cuda", source="foundationstereo_torch/csrc/conv3x3.cu",
                       replaces="foundationstereo_tpu/ops/conv3x3.py:86", shape=list(x.shape) + [f],
                       max_abs_err=err, max_rel_err=err / float(ref.float().abs().max()),
                       mean_abs_err=mean_err,
                       tolerance="per element 1 bf16 ulp + 2(9C-1) 2^-24 sum|x w|; mean <= 0.5 "
                                 "mean bf16 ulp",
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms, cases={})
        row["cases"][name] = dict(max_abs_err=err, mean_abs_err=mean_err, ms=ms,
                                  library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                                  grid=grid, **bounds)
        if dtype == torch.float32 and "fp32_ms" not in row:     # the row's shape in fp32
            row.update(fp32_max_abs_err=err, fp32_mean_abs_err=mean_err, fp32_ms=ms,
                       fp32_bound_ms=bounds["fma_bound_ms"], fp32_tf32x3_bound_ms=b_ms,
                       fp32_library_ms=library_ms, fp32_grid=grid,
                       fp32_tolerance="per element 2(9C-1) 2^-24 sum|x w|; mean <= 1e-5 mean |ref|")
        del x, out, ref, packed
        torch.cuda.empty_cache()
    # The host's own cost per call, at the 1/16-level z/r conv's channels on
    # an 8x64 image: the kernel is shorter than it, so the card idles.
    x, w, bias = _conv_case(dev, gen, 384, 256, (8, 64), torch.bfloat16)
    packed, wl, bl = kernels.pack_conv3x3_weight(w, x.dtype), w.to(x.dtype), bias.to(x.dtype)
    host_us = host_us_per_call(lambda: kernels.conv3x3(x, w, bias, packed))
    conv2d_us = host_us_per_call(lambda: F.conv2d(x, wl, bl, padding=1))
    log(f"[kernels] conv3x3 384->256 on 8x64: host time per call {host_us:.1f} us, F.conv2d "
        f"{conv2d_us:.1f} us")
    return row


# ---------------------------------------------------------------------------
# phases 4, 5 and 6
# ---------------------------------------------------------------------------


def make_pair(h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))


def check_path(dev) -> None:
    """Kernels (without and with the 3x3 conv kernel) against the plain
    twins through the whole forward, same weights."""
    import torch

    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo

    h, w, iters = PATH["height"], PATH["width"], PATH["iters"]
    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True)
    left, right = make_pair(h, w, 1)
    runs = {"kernels": cfg, "kernels + conv3x3": cfg.replace(pallas_conv3x3=True),
            "plain": cfg.replace(use_pallas=False)}
    outs = {}
    for name, c in runs.items():
        model = FoundationStereo(c, device=dev, seed=0)
        model.pyramid_dtype = torch.bfloat16     # every path stores the pyramids in bf16
        outs[name] = run_pair(model, left, right, iters=iters).float()
        del model
        torch.cuda.empty_cache()
    for name in ("kernels", "kernels + conv3x3"):
        diff = (outs[name] - outs["plain"]).abs()
        mean, p99 = float(diff.mean()), float(torch.quantile(diff.flatten(), 0.99))
        log(f"[path] {h}x{w}, {iters} iterations: {name} vs plain twins |d disp| mean {mean:.4g} px, "
            f"p99 {p99:.4g} px, max {float(diff.max()):.4g} px; disparity mean "
            f"{float(outs['plain'].mean()):.4g} px (tolerance: mean <= 0.05 px, p99 <= 0.5 px)")
        check(bool(torch.isfinite(outs[name]).all()), f"non-finite disparity on the {name} path")
        check(mean <= 0.05 and p99 <= 0.5, f"the {name} path disagrees with the plain path")
    check_path_fp32(dev, left, right)


def check_path_fp32(dev, left, right) -> None:
    """The model without mixed precision, the fp32 kernels with the 3x3
    conv kernel, against the plain twins (fp32 throughout, TF32 off, fp32
    pyramids on both): max |d disp| <= 1e-2 px, and the fp32 K3 and K4
    launched as often as one pass routes them."""
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels

    iters = PATH["iters"]
    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=False)
    outs = {}
    for name, c in (("fp32 kernels + conv3x3", cfg.replace(pallas_conv3x3=True)),
                    ("fp32 plain", cfg.replace(use_pallas=False))):
        model = FoundationStereo(c, device=dev, seed=0)
        model.pyramid_dtype = torch.float32
        kernels.reset_launches()
        outs[name] = run_pair(model, left, right, iters=iters).float()
        launches = dict(kernels.LAUNCHES)
        del model
        torch.cuda.empty_cache()
        if name != "fp32 plain":
            want = dict.fromkeys(launches, 0)
            want.update(cost_volume_parts=1, disparity_lookup=iters,
                        flash_attention=VIT_CONFIGS[MAIN["vit_size"]]["depth"],
                        conv3x3=K4_OUTSIDE + iters * K4_PER_ITER)
            log(f"[path] fp32 launches {launches}")
            check(launches == want, f"fp32 launch counts {launches}, expected {want}")
    diff = (outs["fp32 kernels + conv3x3"] - outs["fp32 plain"]).abs()
    log(f"[path] {PATH['height']}x{PATH['width']}, {iters} iterations, mixed_precision=False: fp32 "
        f"kernels + conv3x3 vs plain twins |d disp| max {float(diff.max()):.4g} px, mean "
        f"{float(diff.mean()):.4g} px (tolerance: max <= 1e-2 px)")
    check(bool(torch.isfinite(outs["fp32 kernels + conv3x3"]).all()), "non-finite fp32 disparity")
    check(float(diff.max()) <= 1e-2, "the fp32 kernel path disagrees with the plain path")


def serve(dev, requests: int, profile: bool = False) -> dict:
    """The main path: full configuration, requests through run_pair."""
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels

    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True)
    t0 = time.perf_counter()
    model = FoundationStereo(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    pairs = [make_pair(MAIN["height"], MAIN["width"], 100 + i) for i in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for left, right in pairs:
        t0 = time.perf_counter()
        disp = run_pair(model, left, right, iters=MAIN["iters"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(tuple(disp.shape) == (1, MAIN["height"], MAIN["width"]), f"shape {tuple(disp.shape)}")
        check(bool(torch.isfinite(disp).all()), "non-finite disparity")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[serve] {requests} requests of {MAIN['height']}x{MAIN['width']}, {MAIN['iters']} iterations: "
        f"seconds per pair {[round(t, 4) for t in times]}, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(cost_volume_parts=requests,
                flash_attention=requests * VIT_CONFIGS[MAIN["vit_size"]]["depth"],
                disparity_lookup=requests * MAIN["iters"])
    check(launches == want, f"launch counts {launches}, expected {want}")
    if profile:
        log("[profile] the served configuration (pallas_conv3x3=False: convs through cuDNN):")
        profile_pair(model, pairs[0])
    return launches


def demo(dev, profile: bool = False) -> dict:
    """This slice's path: demo requests through ``inference.demo.infer`` with
    the 3x3 conv kernel on, hierarchical pinhole pairs and a panorama."""
    import tempfile

    import numpy as np
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import infer
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels

    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True,
                      pallas_conv3x3=True)
    model = FoundationStereo(cfg, device=dev, seed=0)
    H, W = MAIN["height"], MAIN["width"]
    K = np.array([[DEMO["fx"], 0, W / 2], [0, DEMO["fx"], H / 2], [0, 0, 1]], np.float32)
    requests = []
    for i in range(DEMO["pinhole"]):
        left, right = (a[0].astype(np.uint8) for a in make_pair(H, W, 200 + i))
        requests.append(("pinhole", left, right, dict(K=K, baseline=DEMO["baseline"], hiera=True)))
    left, right = (a[0].astype(np.uint8) for a in make_pair(*DEMO["panorama_hw"], 300))
    requests.append(("panorama", left, right, dict(baseline=DEMO["baseline"], hiera=False)))

    per_pass = {"cost_volume_parts": 1, "flash_attention": VIT_CONFIGS[MAIN["vit_size"]]["depth"],
                "disparity_lookup": MAIN["iters"], "conv3x3": K4_OUTSIDE + MAIN["iters"] * K4_PER_ITER}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for kind, left, right, kw in requests:
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            out = infer(model, left, right, camera_type=kind, valid_iters=MAIN["iters"], out_dir=tmp,
                        **kw)
            secs = time.perf_counter() - t0
            got = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
            passes = 2 if kw["hiera"] else 1
            want = {k: per_pass.get(k, 0) * passes for k in got}
            pts = out["points"]
            log(f"[demo] {kind} {left.shape[0]}x{left.shape[1]}{' hierarchical' if passes == 2 else ''}: "
                f"{secs:.4f} s (network {out['seconds']['network']:.4f} s, host numpy "
                f"{out['seconds']['host']:.4f} s), disparity mean {float(np.mean(out['disp'])):.4g} px, "
                f"{len(pts)} points ({int(out['keep'].sum())} after outlier removal), "
                f"launches {got}")
            check(out["disp"].shape == left.shape[:2], f"disparity shape {out['disp'].shape}")
            check(bool(np.isfinite(out["disp"]).all()), "non-finite disparity")
            check(len(pts) > 0 and bool(np.isfinite(pts).all()), "empty or non-finite point cloud")
            if kind == "pinhole":
                check(out["depth"].shape == left.shape[:2], "depth shape")
            check(got == want, f"launch counts {got}, expected {want}")
    launches = dict(kernels.LAUNCHES)
    log(f"[demo] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
        f"launches {launches}")
    if profile:
        log("[profile] the configuration with the 3x3 conv kernel (pallas_conv3x3=True):")
        profile_pair(model, make_pair(H, W, 100))
        del model
        torch.cuda.empty_cache()
        profile_fp32_pair(dev, make_pair(H, W, 100))
    return launches


def profile_fp32_pair(dev, pair) -> None:
    """One 736x1280 pair of the model without mixed precision, with the 3x3
    conv kernel: K4's per-shape accounting, then the fp32 K3 and K4 device
    time and launches under torch.profiler (24 and K4_OUTSIDE + 32 x
    K4_PER_ITER per pass)."""
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo

    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=False,
                      pallas_conv3x3=True)
    model = FoundationStereo(cfg, device=dev, seed=0)
    log("[profile] fp32 (mixed_precision=False) with the 3x3 conv kernel:")
    run_pair(model, *pair, iters=MAIN["iters"])
    with K4Account() as k4:
        run_pair(model, *pair, iters=MAIN["iters"])
    torch.cuda.synchronize()
    k4.report()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_pair(model, *pair, iters=MAIN["iters"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] fp32 pair under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %)")
    want = {"conv3x3_fp32": K4_OUTSIDE + MAIN["iters"] * K4_PER_ITER,
            "flash_fwd_f32": VIT_CONFIGS[MAIN["vit_size"]]["depth"]}
    for pattern, n in want.items():
        ev = [e for e in kern if pattern in e.key]
        count = sum(e.count for e in ev)
        log(f"[profile] {pattern} kernels under the profiler: "
            f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms of device time over {count} "
            f"launches (expected {n})")
        check(count == n, f"{pattern}: {count} launches in the fp32 pair, expected {n}")


# ---------------------------------------------------------------------------
# phase 7: the multi-device path on a 4-shard mesh
# ---------------------------------------------------------------------------


def _shard_row(name, source, replaces, shards, stitched_equal, **extra) -> dict:
    """A kernels-line row for a sharded kernel: the per-shard numbers and,
    at the top level, their means (one launch of a shard)."""
    def mean(key):
        return sum(sh[key] for sh in shards) / len(shards)

    by = [sh["bound_by"] for sh in shards]
    return dict(name=name, route="cuda", source=source, replaces=replaces, phase="mesh",
                max_abs_err=max(sh["max_abs_err"] for sh in shards), ms=mean("ms"),
                plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                bound_by=max(set(by), key=by.count), stitched_equal=stitched_equal,
                per="one shard's launch (mean over the shards)", shards=shards, **extra)


def check_cost_volume_sharded(dev, gen, mesh) -> dict:
    """K5's build for each width shard against its twin (K1's tolerance), and
    the stitched parts against K1's."""
    import torch

    from foundationstereo_torch.ops import cost_volume, kernels, sharded

    left, right, rp, D, G, P = cost_volume_inputs(dev, gen)
    B, C, H, W = left.shape
    wl, bf = W // MESH_SHARDS, torch.bfloat16
    shards = []
    for j in range(MESH_SHARDS):
        x0 = j * wl
        lj = left[..., x0:x0 + wl].contiguous()
        gk, rk = kernels.cost_volume_parts_haloed(lj, right, rp, D, G, x0, out_dtype=bf)
        grid = cost_volume_launched(lj, D, G, P)
        gp, rpp = cost_volume.cost_volume_parts_haloed(lj, right, rp, D, G, x0, out_dtype=bf)
        torch.cuda.synchronize()
        max_err, ok = cost_volume_errors(gk, rk, gp, rpp)
        ms = cuda_ms(lambda: kernels.cost_volume_parts_haloed(lj, right, rp, D, G, x0, out_dtype=bf), 20)
        plain_ms = cuda_ms(lambda: cost_volume.cost_volume_parts_haloed(lj, right, rp, D, G, x0,
                                                                        out_dtype=bf), 3)
        ws = max(x0 - (D - 1), 0)                     # the right columns this shard reads
        nbytes = (lj.numel() + B * (C + P) * H * (x0 + wl - ws)) * 2 + (gk.numel() + rk.numel()) * 2
        pairs = sum(min(D, x0 + w + 1) for w in range(wl))   # (w, d) with x0 + w - d >= 0
        b_ms, b_by = bound(nbytes, 2.0 * C * B * H * pairs, FP32_FLOPS)
        log(f"[mesh] cost_volume_parts_haloed shard {j}: x_offset {x0}, {x0 - ws} halo columns, "
            f"max abs err {max_err:.3g} (tolerance: 1 bf16 ulp + 2e-6 per element, rps exact -> "
            f"{ok}); {ms:.4g} ms, plain {plain_ms:.4g} ms, bound {b_ms:.4g} ms ({b_by}); grid "
            f"{grid['blocks']} blocks ({grid['tile']})")
        check(ok, f"cost_volume_parts_haloed shard {j} disagrees with its twin")
        shards.append(dict(shard=j, x_offset=x0, halo_columns=x0 - ws, max_abs_err=max_err, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, grid=grid))
        del gk, rk, gp, rpp
    got = sharded.cost_volume_parts_sharded(left, right, rp, D, G, mesh, out_dtype=bf)
    want = kernels.cost_volume_parts(left, right, rp, D, G, out_dtype=bf)
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    sharded_ms = cuda_ms(lambda: sharded.cost_volume_parts_sharded(left, right, rp, D, G, mesh,
                                                                   out_dtype=bf), 10)
    log(f"[mesh] cost_volume_parts_sharded ({MESH_SHARDS} shards, stitched on the card) equals K1 "
        f"bit for bit: {equal}; {sharded_ms:.4g} ms for the whole sharded build")
    check(equal, "the stitched sharded build differs from K1")
    return _shard_row("cost_volume_parts_haloed", "foundationstereo_torch/csrc/cost_volume.cu",
                      "foundationstereo_tpu/ops/pallas_kernels.py:538", shards, equal,
                      tolerance="1 bf16 ulp + 2e-6 per element (rps exact)", library_ms=None,
                      sharded_call_ms=sharded_ms)


def check_lookup_sharded(dev, gen, mesh) -> dict:
    """K5's lookup for each width shard against its twin (K2's tolerance),
    and the stitched output against K2's."""
    import torch

    from foundationstereo_torch.ops import kernels, sampler, sharded

    r, bf = 4, torch.bfloat16
    geo, corr, disp = _pyramids(dev, gen, 4, bf)
    wl = disp.shape[-1] // MESH_SHARDS
    shards = []
    for j in range(MESH_SHARDS):
        x0 = j * wl
        gj = [g[:, :, x0:x0 + wl].contiguous() for g in geo]
        cj = [c[:, :, x0:x0 + wl].contiguous() for c in corr]
        dj = disp[..., x0:x0 + wl].contiguous()
        out = kernels.disparity_lookup_shard(gj, cj, dj, r, x0, out_dtype=bf)
        grid = lookup_launched(gj, dj)
        ref = sampler.disparity_lookup(gj, cj, dj, r, out_dtype=bf, x_offset=x0)
        torch.cuda.synchronize()
        err, ok = lookup_errors(out, ref)
        ms = cuda_ms(lambda: kernels.disparity_lookup_shard(gj, cj, dj, r, x0, out_dtype=bf), 20)
        plain_ms = cuda_ms(lambda: sampler.disparity_lookup(gj, cj, dj, r, out_dtype=bf,
                                                            x_offset=x0), 3)
        library_ms = cuda_ms(lookup_library(gj, cj, dj, r, x0), 5)
        b_ms, b_by = lookup_bound(gj, cj, dj, r, out, x0)
        sector_ms = lookup_sector_bound(gj, cj, dj, r, out, x0)
        log(f"[mesh] disparity_lookup_shard shard {j}: x_offset {x0}, out {tuple(out.shape)}, max abs "
            f"err {err:.3g} (tolerance: 1 bf16 ulp + 1e-6 per element -> {ok}); {ms:.4g} ms, plain "
            f"{plain_ms:.4g} ms, F.grid_sample x 8 {library_ms:.4g} ms, bound {b_ms:.4g} ms "
            f"({b_by}), sector floor {sector_ms:.4g} ms; grid {grid['blocks']} blocks")
        check(ok, f"disparity_lookup_shard shard {j} disagrees with its twin")
        shards.append(dict(shard=j, x_offset=x0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, grid=grid))
        del gj, cj, out, ref
    pyr = sharded.shard_pyramids(geo, corr, mesh)
    got = sharded.disparity_lookup_sharded(pyr, disp, r, bf)
    equal = bool(torch.equal(got, kernels.disparity_lookup(geo, corr, disp, r, bf)))
    sharded_ms = cuda_ms(lambda: sharded.disparity_lookup_sharded(pyr, disp, r, bf), 20)
    cut_ms = cuda_ms(lambda: sharded.shard_pyramids(geo, corr, mesh), 3)
    log(f"[mesh] disparity_lookup_sharded ({MESH_SHARDS} shards) equals K2 bit for bit: {equal}; "
        f"{sharded_ms:.4g} ms per iteration (launches, disparity cuts and the gather), "
        f"{cut_ms:.4g} ms to cut the pyramids (once per pair)")
    check(equal, "the stitched sharded lookup differs from K2")
    return _shard_row("disparity_lookup_shard", "foundationstereo_torch/csrc/lookup.cu",
                      "foundationstereo_tpu/ops/pallas_kernels.py:321", shards, equal,
                      tolerance="1 bf16 ulp + 1e-6 per element",
                      library_ms=sum(sh["library_ms"] for sh in shards) / len(shards),
                      sharded_call_ms=sharded_ms, pyramid_cut_ms=cut_ms)


def check_attention_sharded(dev, gen, mesh) -> dict:
    """K3s for each head shard against the fp32 dense twin (K3's tolerance),
    and the stitched output against K3's; the same for the fp32 variant
    (tolerance 1e-5) on the same values in fp32."""
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels, sharded

    B, N, Hh, hd = 2, VIT_TOKENS, 16, 64
    hl, scale = Hh // MESH_SHARDS, 1.0 / math.sqrt(hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    qkv = torch.randn(B, N, 3, Hh, hd, device=dev, generator=gen).bfloat16()
    qkv32 = qkv.float()
    shards = []
    for j in range(MESH_SHARDS):
        h0 = j * hl
        out = kernels.flash_attention_heads(qkv, scale, h0, hl)
        grid = attention_launched()
        part = qkv[:, :, :, h0:h0 + hl]
        ref = kernels.flash_attention_plain(part.float(), scale)
        torch.cuda.synchronize()
        err, tol_max, mean_err, tol_mean, _, _, ok = attention_errors(out, ref)
        fp32 = check_attention_shard_fp32(qkv32, scale, h0, hl, ref, sms)
        del ref
        ms = cuda_ms(lambda: kernels.flash_attention_heads(qkv, scale, h0, hl), 10)
        plain_ms = cuda_ms(lambda: kernels.flash_attention_plain(part, scale), 3)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in part.unbind(2))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 10)
        del qs, ks, vs
        b_ms, b_by, e_ms = attention_bound((part.numel() + out.numel()) * 2, 4.0 * B * hl * N * N * hd,
                                           B * hl * N * N, sms, clock)
        log(f"[mesh] flash_attention_heads shard {j}: heads [{h0}, {h0 + hl}), max abs err {err:.3g} "
            f"(tolerance {tol_max:.3g}), mean abs err {mean_err:.3g} (tolerance {tol_mean:.3g}) vs "
            f"fp32 dense -> {ok}; {ms:.4g} ms, plain {plain_ms:.4g} ms, SDPA on the slice "
            f"{library_ms:.4g} ms, bound {b_ms:.4g} ms ({b_by}), exp {e_ms:.4g} ms; grid "
            f"{grid['blocks']} blocks ({grid['tile']}), {grid['blocks'] / sms:.2f} waves")
        check(ok, f"flash_attention_heads shard {j} disagrees with the fp32 dense reference")
        shards.append(dict(shard=j, heads=[h0, h0 + hl], max_abs_err=err, mean_abs_err=mean_err,
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                           bound_by=b_by, grid=grid, **fp32))
        del out
    got = sharded.flash_attention_sharded(qkv, scale, mesh)
    equal = bool(torch.equal(got, kernels.flash_attention(qkv, scale)))
    sharded_ms = cuda_ms(lambda: sharded.flash_attention_sharded(qkv, scale, mesh), 10)
    log(f"[mesh] flash_attention_sharded ({MESH_SHARDS} head shards) equals K3 bit for bit: {equal}; "
        f"{sharded_ms:.4g} ms for the whole sharded call")
    check(equal, "the stitched sharded attention differs from K3")
    equal32 = bool(torch.equal(sharded.flash_attention_sharded(qkv32, scale, mesh),
                               kernels.flash_attention(qkv32, scale)))
    log(f"[mesh] fp32 flash_attention_sharded ({MESH_SHARDS} head shards) equals fp32 K3 bit for "
        f"bit: {equal32}")
    check(equal32, "the stitched sharded fp32 attention differs from fp32 K3")
    del qkv32
    return _shard_row("flash_attention_heads", "foundationstereo_torch/csrc/flash_attention.cu",
                      "foundationstereo_tpu/models/dinov2.py:106", shards, equal,
                      tolerance="max <= 2 bf16 ulps of max |ref|, mean <= 1 bf16 ulp of mean |ref|, "
                                "vs fp32 dense",
                      library_ms=sum(sh["library_ms"] for sh in shards) / len(shards),
                      grid=shards[0]["grid"], sharded_call_ms=sharded_ms,
                      fp32_stitched_equal=equal32,
                      **{k: sum(sh[k] for sh in shards) / len(shards)
                         for k in ("fp32_max_abs_err", "fp32_ms", "fp32_bound_ms",
                                   "fp32_tf32x3_bound_ms", "fp32_library_ms")})


def check_attention_shard_fp32(qkv32, scale, h0, hl, ref, sms) -> dict:
    """One fp32 K3s shard against the fp32 dense twin ``ref`` (1e-5), timed
    beside SDPA in fp32 on the slice, with both fp32 bounds."""
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    B, N, _, _, hd = qkv32.shape
    out = kernels.flash_attention_heads(qkv32, scale, h0, hl)
    grid = attention_launched()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f"fp32 flash_attention_heads at head {h0} disagrees with the fp32 dense twin")
    ms = cuda_ms(lambda: kernels.flash_attention_heads(qkv32, scale, h0, hl), 5)
    part = qkv32[:, :, :, h0:h0 + hl]
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in part.unbind(2))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 3)
    fma_ms, tc_ms, _ = fp32_bounds((part.numel() + out.numel()) * 4, 4.0 * B * hl * N * N * hd)
    log(f"[mesh] fp32 flash_attention_heads heads [{h0}, {h0 + hl}): max abs err {err:.3g} (tolerance "
        f"1e-5) vs fp32 dense; {ms:.4g} ms, SDPA in fp32 on the slice {library_ms:.4g} ms, "
        f"three-pass TF32 bound {tc_ms:.4g} ms, FMA bound {fma_ms:.4g} ms; grid {grid['blocks']} "
        f"blocks, {grid['blocks'] / sms:.2f} waves")
    return dict(fp32_max_abs_err=err, fp32_ms=ms, fp32_bound_ms=fma_ms, fp32_tf32x3_bound_ms=tc_ms,
                fp32_library_ms=library_ms, fp32_grid=grid)


def serve_pairs(model, pairs, label: str) -> tuple[list, list, float]:
    """The pairs through ``run_pair``: (disparities, seconds, peak GiB)."""
    import torch

    from foundationstereo_torch.inference.demo import run_pair

    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    for left, right in pairs:
        t0 = time.perf_counter()
        disp = run_pair(model, left, right, iters=MAIN["iters"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(tuple(disp.shape) == (1, MAIN["height"], MAIN["width"]), f"shape {tuple(disp.shape)}")
        check(bool(torch.isfinite(disp).all()), f"non-finite disparity ({label})")
        outs.append(disp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[mesh] {label}: seconds per pair {[round(t, 4) for t in times]}, peak memory {peak:.2f} GiB")
    return outs, times, peak


def compare_disparities(label: str, got: list, want: list) -> None:
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        diff = (a.float() - b.float()).abs()
        mean, p99 = float(diff.mean()), float(torch.quantile(diff.flatten(), 0.99))
        log(f"[mesh] pair {i}: {label} |d disp| mean {mean:.4g} px, p99 {p99:.4g} px, max "
            f"{float(diff.max()):.4g} px, equal bit for bit {bool(torch.equal(a, b))} (tolerance: "
            f"mean <= 0.05 px, p99 <= 0.5 px)")
        check(mean <= 0.05 and p99 <= 0.5, f"pair {i}: {label} disagree")


def mesh_phase(dev, requests: int, profile: bool = False) -> tuple[list, dict]:
    """The multi-device path: the sharded kernels against their twins and
    K1-K3, then the served configuration under a 4-shard mesh on one card.
    Returns the kernels-line rows and the launches of the sharded requests."""
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels
    from foundationstereo_torch.parallel import make_mesh, mesh_context
    from foundationstereo_torch.parallel.sharding import ShardPlan

    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    log(f"[mesh] {mesh}")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for fn in (check_cost_volume_sharded, check_lookup_sharded, check_attention_sharded):
        rows.append(fn(dev, gen, mesh))
        torch.cuda.empty_cache()

    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True)
    model = FoundationStereo(cfg, device=dev, seed=0)
    pairs = [make_pair(MAIN["height"], MAIN["width"], 100 + i) for i in range(requests)]
    # In turns (unsharded, sharded, unsharded), so that drift shows.
    serve_pairs(model, pairs, "unsharded, before (the same model and pairs)")
    kernels.reset_launches()
    with mesh_context(mesh):
        outs, _, _ = serve_pairs(model, pairs, f"{MESH_SHARDS}-shard mesh on one card")
    launches = dict(kernels.LAUNCHES)
    log(f"[mesh] launches of the {requests} sharded requests: {launches}")
    vit = VIT_CONFIGS[MAIN["vit_size"]]
    attn = ShardPlan(mesh, 2, vit["num_heads"], dev)          # both views' tokens, all heads
    want = dict.fromkeys(launches, 0)
    want.update(cost_volume_parts_haloed=requests * MESH_SHARDS,
                disparity_lookup_shard=requests * MESH_SHARDS * MAIN["iters"],
                flash_attention_heads=requests * attn.n_batch * attn.n_split * vit["depth"])
    check(launches == want, f"launch counts {launches}, expected {want}")

    ref, _, _ = serve_pairs(model, pairs, "unsharded, after")
    compare_disparities("sharded vs unsharded", outs, ref)
    n = torch.cuda.device_count()
    if n >= 2:
        cards = make_mesh(devices=[torch.device("cuda", i % n) for i in range(MESH_SHARDS)])
        log(f"[mesh] shards on distinct cards: {cards}")
        with mesh_context(cards):
            spread, _, _ = serve_pairs(model, pairs, f"{MESH_SHARDS}-shard mesh on {min(n, MESH_SHARDS)} cards")
        compare_disparities("distinct cards vs one card", spread, outs)
    else:
        log("[mesh] one card: the run with the shards on distinct cards did not run")
    if profile:
        log("[profile] the served configuration without a mesh (the mesh phase's model):")
        profile_pair(model, pairs[0])
        log(f"[profile] the served configuration under the {MESH_SHARDS}-shard mesh on one card:")
        with mesh_context(mesh):
            profile_pair(model, pairs[0])
    return rows, launches


class K4Account:
    """Times every K4 call of a run with CUDA events around it, grouped by
    shape (C, F, H, W, images), beside each group's summed bound (bytes:
    input, weight and output once; operations: 2 * 9 * C * F per output
    pixel, at the bf16 peak, or three times that at the TF32 peak for
    fp32). Wraps ``kernels.conv3x3`` while it is entered, which is where the
    routed convs look it up. The events time the call on the pair's
    timeline, host gaps included where the card waits for the launch;
    ``report`` also re-times one call of each shape alone (``cuda_ms``, the
    kernel's device time) and multiplies by its launches."""

    def __init__(self):
        self.calls = []          # (shape key, bound ms, flop, start event, end event)
        self.first = {}          # shape key -> the first call's arguments
        self.grid = {}           # shape key -> k4_launched() of its last call

    def __enter__(self):
        import torch

        from foundationstereo_torch.ops import kernels

        self._kernels, self._wrapped = kernels, kernels.conv3x3

        def timed(x, weight, *args, **kwargs):
            f, c = weight.shape[:2]
            h, w = x.shape[-2:]
            images = x.numel() // (c * h * w)
            esize = x.element_size()
            flop = 2.0 * 9 * c * f * images * h * w
            nbytes = (x.numel() + 9 * c * f + f * images * h * w) * esize
            # bf16: one tensor-core pass; fp32: three TF32 passes
            b_ms = bound(nbytes, flop, BF16_FLOPS)[0] if esize == 2 else fp32_bounds(nbytes, flop)[1]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._wrapped(x, weight, *args, **kwargs)
            end.record()
            self.calls.append(((c, f, h, w, images), b_ms, flop, start, end))
            self.first.setdefault((c, f, h, w, images), (x, weight, args, kwargs))
            self.grid[(c, f, h, w, images)] = k4_launched()
            return out

        kernels.conv3x3 = timed
        return self

    def __exit__(self, *exc):
        self._kernels.conv3x3 = self._wrapped

    def report(self) -> None:
        """Per shape: launches, ms on the pair's timeline, kernel ms (alone x
        launches), summed bound, TF/s of the kernel ms, grid; then totals."""
        if not self.calls:
            return
        groups: dict = {}
        for key, b_ms, flop, start, end in self.calls:
            g = groups.setdefault(key, [0, 0.0, 0.0, 0.0])
            g[0] += 1
            g[1] += start.elapsed_time(end)
            g[2] += b_ms
            g[3] += flop
        alone = {}
        for key, (x, weight, args, kwargs) in self.first.items():
            alone[key] = groups[key][0] * cuda_ms(lambda: self._wrapped(x, weight, *args, **kwargs), 5)
        self.first.clear()
        log("[profile] conv3x3 (K4) by shape over the pair: ms on the pair's timeline (CUDA events "
            "around each call) and kernel ms (one call re-timed alone x launches):")
        log(f"[profile]   {'C->F':>9s} {'H x W':>9s} {'images':>6s} {'launches':>8s} {'timeline':>9s} "
            f"{'kernel':>8s} {'bound':>8s} {'TF/s':>6s}  grid")
        for key, (k, ms, b_ms, flop) in sorted(groups.items(), key=lambda kv: -alone[kv[0]]):
            c, f, h, w, n = key
            grid = self.grid[key]
            log(f"[profile]   {f'{c}->{f}':>9s} {f'{h}x{w}':>9s} {n:6d} {k:8d} {ms:9.3f} "
                f"{alone[key]:8.3f} {b_ms:8.4f} {flop / alone[key] / 1e9:6.1f}  "
                f"{grid['blocks']} x {grid['tile']}")
        log(f"[profile] conv3x3 work of the pair: {len(self.calls)} launches, "
            f"{sum(g[3] for g in groups.values()) / 1e12:.4g} TFLOP, "
            f"{sum(g[1] for g in groups.values()):.2f} ms on the pair's timeline, "
            f"{sum(alone.values()):.2f} ms of kernel time, least time "
            f"{sum(g[2] for g in groups.values()):.4g} ms (the sum of each launch's bound)")


def profile_pair(model, pair) -> None:
    """One more request, timed per top-level module with CUDA events (what
    no module covers -- the cost-volume build, the pyramids, the lookups --
    is the remainder); then, where K4 runs, one with K4's per-shape
    accounting; then one under torch.profiler for the top device ops."""
    import torch

    from foundationstereo_torch.inference.demo import run_pair

    spans: dict[str, list] = {}

    def pre(name):
        def hook(_m, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.setdefault(name, []).append([ev, None])
        return hook

    def post(name):
        def hook(_m, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev
        return hook

    handles = []
    for name, child in model.named_children():
        handles += [child.register_forward_pre_hook(pre(name)),
                    child.register_forward_hook(post(name))]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run_pair(model, *pair, iters=MAIN["iters"])
    end.record()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    total = start.elapsed_time(end)
    per = {n: sum(a.elapsed_time(b) for a, b in evs) for n, evs in spans.items()}
    per["(outside modules: cost volume, pyramids, lookups, glue)"] = total - sum(per.values())
    log(f"[profile] one pair: {total:.2f} ms on the card's clock")
    for n, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {n:58s} {ms:9.2f} ms  {100 * ms / total:5.1f} %  "
            f"({len(spans.get(n, [None]))} calls)")

    # K4's accounting in a pass of its own: its events and bookkeeping per
    # call cost host time, which the pair's time above does not carry.
    with K4Account() as k4:
        run_pair(model, *pair, iters=MAIN["iters"])
    torch.cuda.synchronize()
    k4.report()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_pair(model, *pair, iters=MAIN["iters"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]   # kernels only
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %)")
    k4 = [e for e in kern if "conv3x3" in e.key]
    if k4:
        log(f"[profile] K4 kernels under the profiler: "
            f"{sum(e.self_device_time_total for e in k4) / 1e3:.2f} ms of device time over "
            f"{sum(e.count for e in k4)} launches ("
            + ", ".join(f"{K4_KERNEL.search(e.key).group(0)}: "
                        f"{e.self_device_time_total / 1e3:.2f} ms / {e.count}" for e in k4) + ")")
    for label, pattern in (("K1 / K5 build", "cost_volume_parts_kernel"),
                           ("K2 / K5 lookup", "lookup_kernel"), ("K3 / K3s", "flash_fwd")):
        ev = [e for e in kern if pattern in e.key]
        log(f"[profile] {label} kernels under the profiler: "
            f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms of device time over "
            f"{sum(e.count for e in ev)} launches")
    log(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


# ---------------------------------------------------------------------------
# phase 8: training through the train CLI
# ---------------------------------------------------------------------------


def write_train_dataset(root, pairs: int, hw: tuple[int, int], seed: int = 0) -> None:
    """A dataset in the training layout (left/rgb, right/rgb JPEGs, base-255
    uint8 disparity PNGs): smooth random scenes, the right view the left
    shifted by the disparity."""
    import numpy as np
    from PIL import Image

    from foundationstereo_torch.utils.misc import depth_uint8_encoding

    rng = np.random.default_rng(seed)
    h, w = hw
    for sub in ("left/rgb", "right/rgb", "left/disparity"):
        (root / sub).mkdir(parents=True)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(pairs):
        coarse = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
        left = np.asarray(Image.fromarray(coarse.astype(np.uint8)).resize((w, h), Image.BILINEAR),
                          np.float32) + rng.normal(0, 8, (h, w, 3))
        disp = 8 + 40 * (xs / w) + 10 * np.sin(ys / 37.0 + i)
        src = np.clip(np.round(xs + disp).astype(np.int64), 0, w - 1)
        right = left[ys.astype(np.int64), src]
        Image.fromarray(np.clip(left, 0, 255).astype(np.uint8)).save(root / "left/rgb" / f"{i}.jpg")
        Image.fromarray(np.clip(right, 0, 255).astype(np.uint8)).save(root / "right/rgb" / f"{i}.jpg")
        Image.fromarray(depth_uint8_encoding(disp)).save(root / "left/disparity" / f"{i}.png")


def _train_cli(ws, data, steps: int, checkpoint: str) -> None:
    from foundationstereo_torch.train import cli

    cli.main(["--config", TRAIN["config"], "--workspace", str(ws), "--device", "cuda",
              "--num_iterations", str(steps), "--batch_size", str(TRAIN["batch"]),
              "--save_every", str(TRAIN["save_every"]), "--log_every", "1",
              "--checkpoint", checkpoint, "--override", f"data.datasets.0.path={data}"])


def train_phase(dev, profile: bool = False) -> dict:
    """The training path: the train CLI takes TRAIN["steps"] steps and saves,
    resumes from ``latest`` for TRAIN["resume_steps"] more, and ``infer``
    serves a 736x1280 pair from the EMA weights. Checks: finite metrics and
    no skipped step, the frozen ViT bit for bit and a trainable tensor moved,
    24 K3 launches per step and no other kernel; a non-finite batch skipped
    with the parameters bit for bit; one step's loss and gradient norm
    through K3 against the same step through its plain twin. Returns the
    launches of the CLI's steps."""
    import json as _json
    import statistics
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from foundationstereo_torch import native
    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import infer
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels
    from foundationstereo_torch.train.checkpoints import CheckpointManager

    config = _json.loads(Path(TRAIN["config"]).read_text())
    cfg = ModelConfig.from_dict(config["model"])
    depth = VIT_CONFIGS[cfg.vit_size]["depth"]
    steps = TRAIN["steps"] + TRAIN["resume_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_train_dataset(tmp / "data", TRAIN["pairs"], TRAIN["pair_hw"])
        check(native.available(), "the native data-path library did not build")
        log(f"[train] dataset of {TRAIN['pairs']} pairs at {TRAIN['pair_hw']} written and the "
            f"native library built in {time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        _train_cli(tmp / "ws", tmp / "data", TRAIN["steps"], "none")
        first = dict(kernels.LAUNCHES)
        _train_cli(tmp / "ws", tmp / "data", steps, "latest")
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        lines = [_json.loads(x) for x in (tmp / "ws" / "metrics.jsonl").read_text().splitlines()]
        check([x["step"] for x in lines] == list(range(steps)), f"steps {[x['step'] for x in lines]}")
        for x in lines:
            check(all(math.isfinite(v) for v in x.values() if isinstance(v, float)),
                  f"non-finite metric at step {x['step']}: {x}")
            check(x["skipped_nonfinite"] == 0.0, f"step {x['step']} skipped")
        secs = [x["t_dispatch"] for x in lines]
        loop = [x["t_dispatch"] + x["t_get"] + x["t_data"] + x["t_fence"] for x in lines]
        log(f"[train] {steps} steps ({TRAIN['steps']} + {TRAIN['resume_steps']} resumed) of batch "
            f"{TRAIN['batch']} at {config['data']['image_sizes'][0]} (width, height), "
            f"{cfg.vit_size}, max_disp {cfg.max_disp}, {cfg.train_iters} iterations, "
            f"mixed_precision={cfg.mixed_precision}: loss {[round(x['loss'], 4) for x in lines]}, "
            f"grad_norm {[round(x['grad_norm'], 4) for x in lines]}")
        log(f"[train] seconds per step (the step up to its synchronisation): first "
            f"{secs[0]:.4f}, first after the resume {secs[TRAIN['steps']]:.4f}, median of the "
            f"others {statistics.median(secs[1:TRAIN['steps']] + secs[TRAIN['steps'] + 1:]):.4f}; "
            f"whole loop per step (with the data wait and copy) median "
            f"{statistics.median(loop[1:]):.4f}; peak memory {peak:.2f} GiB")
        log(f"[train] launches: first run {first}, both runs {launches}")
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = depth * steps
        check(launches == want, f"train launches {launches}, expected {want} ({depth} K3 per step)")

        ckpt = CheckpointManager(tmp / "ws" / "checkpoints")
        check(ckpt.latest_step() == steps, f"latest checkpoint {ckpt.latest_step()}")
        trained, _ = ckpt.restore_inference("latest")
        init = FoundationStereo(cfg, device=dev, seed=0).state_dict()
        dino = [k for k in init if k.startswith("feature.dino.")]
        check(all(torch.equal(trained[k].to(dev), init[k]) for k in dino),
              "the frozen ViT moved")
        key = "update_block.disp_head.conv.0.weight"
        moved = float((trained[key].to(dev) - init[key]).abs().max())
        check(moved > 0, f"{key} did not move")
        log(f"[train] the frozen ViT's {len(dino)} tensors equal bit for bit after {steps} steps; "
            f"{key} moved by up to {moved:.3g}")
        del init, trained

        ema, step = ckpt.restore_inference("latest", use_ema=True)
        model = FoundationStereo(cfg, device=dev, seed=0)
        model.load_state_dict(ema)
        del ema
        left, right = (a[0].astype(np.uint8) for a in make_pair(MAIN["height"], MAIN["width"], 400))
        kernels.reset_launches()
        out = infer(model, left, right, valid_iters=cfg.valid_iters, get_pc=False)
        served = dict(kernels.LAUNCHES)
        log(f"[train] infer on the EMA weights of step {step}: {MAIN['height']}x{MAIN['width']}, "
            f"{cfg.valid_iters} iterations, network {out['seconds']['network']:.4f} s, disparity "
            f"mean {float(np.mean(out['disp'])):.4g} px, launches {served}")
        check(out["disp"].shape == left.shape[:2] and bool(np.isfinite(out["disp"]).all()),
              "the EMA model's disparity is not finite or of the wrong shape")
        check(served["cost_volume_parts"] == 1 and served["flash_attention"] == depth
              and served["disparity_lookup"] == cfg.valid_iters, f"infer launches {served}")
        del model
        torch.cuda.empty_cache()
        train_step_checks(dev, config, tmp / "data", profile)
    return launches


def train_step_checks(dev, config, data, profile: bool) -> None:
    """On a fresh trainer state: one step's loss and gradient norm through K3
    against the same step through the plain twin (the same weights, batch
    and dropout masks); then a non-finite batch, skipped with every
    parameter bit for bit."""
    import copy

    import torch

    from foundationstereo_torch.models.dinov2 import Attention
    from foundationstereo_torch.ops import kernels
    from foundationstereo_torch.train.cli import host_batch, to_device
    from foundationstereo_torch.train.dataloader import StereoTrainDataLoaderPipeline
    from foundationstereo_torch.train.trainer import Trainer

    config = copy.deepcopy(config)
    config["data"]["datasets"][0]["path"] = str(data)
    pipe = StereoTrainDataLoaderPipeline(config["data"], TRAIN["batch"])
    batch = to_device(host_batch(pipe.get(), config["loss"]), dev)
    trainer = Trainer(config, seed=0, device=dev)
    state = trainer.init_state()
    attn = [m for m in state.model.modules() if isinstance(m, Attention)]

    def loss_gnorm(use_kernel: bool):
        for m in attn:
            m.use_kernel = use_kernel
        kernels.reset_launches()
        loss, _ = trainer.loss_and_grads(state, batch)
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        state.model.zero_grad(set_to_none=True)
        return float(loss), gnorm, kernels.LAUNCHES["flash_attention"]

    k3 = loss_gnorm(True)
    twin = loss_gnorm(False)
    twin2 = loss_gnorm(False)
    for m in attn:
        m.use_kernel = True
    d_loss, d_g = abs(k3[0] - twin[0]) / abs(twin[0]), abs(k3[1] - twin[1]) / twin[1]
    log(f"[train] one step through K3 ({k3[2]} launches) vs the plain twin ({twin[2]}): loss "
        f"{k3[0]:.6g} vs {twin[0]:.6g} (relative {d_loss:.3g}), gradient norm {k3[1]:.6g} vs "
        f"{twin[1]:.6g} (relative {d_g:.3g}); the twin run again: loss {twin2[0]:.6g}, "
        f"gradient norm {twin2[1]:.6g} (tolerance: 2^-6 of the loss and 2^-4 of the gradient "
        f"norm, a few bf16 ulps of the ViT's output carried through the bf16 network)")
    check(k3[2] == len(attn) and twin[2] == 0, "K3 launches in the comparison")
    check(d_loss <= 2 ** -6 and d_g <= 2 ** -4, "the step through K3 disagrees with the twin's")

    if profile:
        profile_train_step(trainer, state, batch)

    bad = dict(batch)
    bad["left"] = batch["left"].clone()
    bad["left"][0, 0, 0, 0] = float("nan")
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    step0, count0 = state.step, state.optimizer.count
    state, metrics = trainer.train_step(state, bad)
    check(float(metrics["skipped_nonfinite"]) == 1.0, "the non-finite batch was not skipped")
    check(all(torch.equal(p, before[k]) for k, p in state.model.named_parameters()),
          "a skipped step moved the parameters")
    check(state.step == step0 + 1 and state.optimizer.count == count0,
          "a skipped step advanced the optimizer")
    log(f"[train] a batch with a NaN pixel: skipped, loss {float(metrics['loss'])}, all "
        f"{len(before)} parameter tensors equal bit for bit, the optimizer's count still {count0}")


def profile_train_step(trainer, state, batch) -> None:
    """The trainer's own step (``Trainer.train_step``) timed on the card's
    clock: the forward per top-level module (CUDA events from forward hooks;
    with checkpointing a region's recompute falls in the backward), the loss
    and the backward up to the last gradient accumulated, and the update
    after it; then the step under torch.profiler for the top device ops."""
    import torch

    model = state.model
    spans: dict[str, list] = {}
    marks: dict[str, object] = {}
    forward = [False]     # the hooks time the forward, not the backward's recompute

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def root_pre(_m, _a):
        marks["start"] = event()
        forward[0] = True

    def root_post(_m, _a, _o):
        forward[0] = False
        marks["forward"] = event()

    def grad_accumulated(_p):
        marks["backward"] = event()

    def hooks(name):
        def pre(_m, _a):
            if forward[0]:
                spans.setdefault(name, []).append([event(), None])

        def post(_m, _a, _o):
            if forward[0]:
                spans[name][-1][1] = event()
        return pre, post

    def step():
        trainer.train_step(state, batch)

    step()                                          # warm
    handles = [model.register_forward_pre_hook(root_pre), model.register_forward_hook(root_post)]
    for name, child in model.named_children():
        pre, post = hooks(name)
        handles += [child.register_forward_pre_hook(pre), child.register_forward_hook(post)]
    handles += [p.register_post_accumulate_grad_hook(grad_accumulated)
                for p in model.parameters() if p.requires_grad]
    step()
    marks["end"] = event()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    start = marks["start"]
    total = start.elapsed_time(marks["end"])
    fwd = start.elapsed_time(marks["forward"])
    per = {f"forward: {n}": sum(a.elapsed_time(b) for a, b in e) for n, e in spans.items()}
    per["forward: outside modules (cost volume, pyramids, lookups, glue)"] = fwd - sum(per.values())
    per["loss and backward (with the checkpointed regions' recompute)"] = (
        marks["forward"].elapsed_time(marks["backward"]))
    per["update (norm, clip, AdamW, EMA)"] = marks["backward"].elapsed_time(marks["end"])
    log(f"[profile] one train step (Trainer.train_step): {total:.2f} ms on the card's clock")
    for n, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {n:70s} {ms:9.2f} ms  {100 * ms / total:5.1f} %")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    k3 = [e for e in kern if "flash_fwd" in e.key]
    log(f"[profile] a train step under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %); K3 {sum(e.self_device_time_total for e in k3) / 1e3:.3f} ms "
        f"over {sum(e.count for e in k3)} launches")
    log(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


# ---------------------------------------------------------------------------
# phase 9: the offline entry points
# ---------------------------------------------------------------------------


def op_calls(kernels, dev) -> dict:
    """One call of each kernel operator of ``kernels`` (this tree's module
    or another checkout's) at a small bf16 shape, whose kernel is shorter
    than the host's work per call: {name: fn}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    feat, proj = rand(1, 32, 4, 64), rand(1, 12, 4, 64)
    half = feat[..., 32:].contiguous()
    geo = [rand(1, 4, 32, 8, 26 >> lv) for lv in range(4)]
    corr = [rand(1, 4, 32, 32 >> lv) for lv in range(4)]
    disp = torch.rand((1, 4, 32), device=dev, generator=gen) * 20
    qkv = rand(1, 64, 3, 4, 64)
    x, w, bias = rand(1, 128, 8, 64), rand(64, 128, 3, 3, dtype=torch.float32), rand(64)
    packed = kernels.pack_conv3x3_weight(w, bf)
    return {
        "cost_volume_parts": lambda: kernels.cost_volume_parts(feat, feat, proj, 8, 8, out_dtype=bf),
        "cost_volume_parts_haloed": lambda: kernels.cost_volume_parts_haloed(
            half, feat, proj, 8, 8, 32, out_dtype=bf),
        "disparity_lookup": lambda: kernels.disparity_lookup(geo, corr, disp, 4, out_dtype=bf),
        "disparity_lookup_shard": lambda: kernels.disparity_lookup_shard(
            geo, corr, disp, 4, 0, out_dtype=bf),
        "flash_attention": lambda: kernels.flash_attention(qkv, 0.125),
        "flash_attention_heads": lambda: kernels.flash_attention_heads(qkv, 0.125, 1, 2),
        "conv3x3": lambda: kernels.conv3x3(x, w, bias, packed),
    }


def pass_launches(h: int, w: int, iters: int, depth: int) -> dict:
    """K1, K2 and K3 launches of one test-mode pass on a padded h x w pair:
    the ViT runs K3 in each of its ``depth`` layers only where its input,
    rounded up to multiples of 112 (at most 1344), has over 1024 patches
    of 14 (``models/extractor.py``, ``models/dinov2.py``)."""
    from foundationstereo_torch.utils.misc import get_resize_keep_aspect_ratio

    hr, wr = get_resize_keep_aspect_ratio(h, w, divider=112, max_H=1344, max_W=1344)
    tokens = (hr // 14) * (wr // 14) + 1
    return {"cost_volume_parts": 1, "disparity_lookup": iters,
            "flash_attention": depth if tokens > 1024 else 0}


def _launched_since(before: dict) -> dict:
    from foundationstereo_torch.ops import kernels

    return {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v - before[k]}


def profile_call(label: str, fn) -> None:
    """One call under torch.profiler: wall ms, device busy ms, kernel
    launches on the card and aten operator calls on the host."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    aten = sum(e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"))
    log(f"[profile] {label} under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %), {sum(e.count for e in kern)} kernel launches, {aten} aten "
        f"calls on the host")


def offline_phase(dev, profile: bool = False) -> dict:
    """This slice's path: the offline entry points on the served
    configuration (ViT-L, max_disp 416, bf16) with seeded random weights
    written by ``save_pretrained``. Checkpoints: the directory and a
    ``.pth`` beside a ``config.json`` load through ``from_pretrained`` to a
    model whose disparity equals the in-memory model's bit for bit.
    Evaluation: fixtures at the KITTI 2015 frame size through the eval CLI
    over three layouts (32 iterations), one ``--hiera 1`` and one ``--scale
    0.5`` frame, with exact K1/K2/K3 launches per frame, finite summaries and
    the JSONL rows. Export: ``make_export`` with a symbolic batch; the loaded
    program at batch 1 and 2 launches what the eager forward launches and
    gives its disparity. Then the host's cost per call of each operator.
    ``profile`` adds one eager and one loaded call at batch 1 under
    torch.profiler. Returns the phase's launches."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from foundationstereo_torch.config import VIT_CONFIGS, ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.inference.export import load_exported
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo
    from foundationstereo_torch.ops import kernels
    from foundationstereo_torch.pretrained import from_pretrained, save_pretrained
    from foundationstereo_torch.scripts import eval as eval_cli
    from foundationstereo_torch.scripts import make_eval_fixtures, make_export

    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True)
    depth = VIT_CONFIGS[cfg.vit_size]["depth"]
    kernels.reset_launches()
    model = FoundationStereo(cfg, device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # Checkpoints: the directory route and a reference-layout .pth.
        t0 = time.perf_counter()
        save_pretrained(tmp / "ckpt", model, cfg)
        (tmp / "pth").mkdir()
        torch.save({"model": model.state_dict()}, tmp / "pth" / "model.pth")
        (tmp / "pth" / "config.json").write_text(json.dumps({"model": dataclasses.asdict(cfg)}))
        log(f"[offline] checkpoints written in {time.perf_counter() - t0:.1f} s "
            f"({(tmp / 'pth' / 'model.pth').stat().st_size / 2 ** 30:.2f} GiB each)")
        h, w = OFFLINE["eval_hw"]
        left, right = make_pair(h, w, 400)
        want = run_pair(model, left, right, iters=MAIN["iters"])
        for route, path in (("directory", tmp / "ckpt"), (".pth", tmp / "pth" / "model.pth")):
            t0 = time.perf_counter()
            loaded, loaded_cfg = from_pretrained(path, device=dev)
            secs = time.perf_counter() - t0
            got = run_pair(loaded, left, right, iters=MAIN["iters"])
            equal = bool(torch.equal(got, want))
            log(f"[offline] from_pretrained({route}) in {secs:.1f} s: disparity of a {h}x{w} pair "
                f"equal to the in-memory model's bit for bit {equal}")
            check(loaded_cfg == cfg, f"{route}: config {loaded_cfg}")
            check(equal, f"{route}: the loaded model's disparity differs")
            del loaded
        torch.cuda.empty_cache()

        # Evaluation over the benchmark layouts.
        fix = tmp / "fixtures"
        t0 = time.perf_counter()
        make_eval_fixtures.main(["--out", str(fix), "--n", str(OFFLINE["eval_frames"]),
                                 "--height", str(h), "--width", str(w),
                                 "--max_disp", str(OFFLINE["fixture_max_disp"])])
        log(f"[offline] fixtures {h}x{w} written in {time.perf_counter() - t0:.1f} s")
        hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
        one = pass_launches(hp, wp, MAIN["iters"], depth)
        sh, sw = int(h * 0.5), int(w * 0.5)
        half = pass_launches(-(-sh // 32) * 32, -(-sw // 32) * 32, MAIN["iters"], depth)
        runs = [(ds, [], OFFLINE["eval_frames"], one) for ds in ("middlebury", "eth3d", "kitti2015")]
        runs += [("kitti2015", ["--hiera", "1"], 1, {k: one[k] + half[k] for k in one}),
                 ("middlebury", ["--scale", "0.5"], 1, half)]
        for ds, extra, frames, per_frame in runs:
            out = tmp / f"{ds}{''.join(extra)}.jsonl"
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            rows, summary = eval_cli.main(
                ["--dataset", ds, "--root", str(fix / ds), "--ckpt_dir", str(tmp / "ckpt"),
                 "--valid_iters", str(MAIN["iters"]), "--vit_size", cfg.vit_size,
                 "--max_disp", str(cfg.max_disp), "--max_frames", str(frames), "--out", str(out),
                 "--device", str(dev), *extra])
            secs = time.perf_counter() - t0
            got = _launched_since(before)
            want_l = {k: v * frames for k, v in per_frame.items() if v}
            lines = [json.loads(line) for line in out.read_text().splitlines()]
            log(f"[offline] eval {ds} {' '.join(extra)}: {len(rows)} frames of {h}x{w}, s per frame "
                f"{[r['time_s'] for r in rows]} ({secs:.1f} s with the model's load), epe "
                f"{summary['epe']:.4g}, bad3 {summary['bad3']:.4g}, d1_all {summary['d1_all']:.4g}, "
                f"launches {got}")
            check(got == want_l, f"eval {ds} {extra}: launches {got}, expected {want_l}")
            check(summary["frames"] == frames and all(
                math.isfinite(summary[k]) for k in eval_cli.METRICS), f"eval summary {summary}")
            check([r["type"] for r in lines] == ["frame"] * frames + ["summary"],
                  f"eval {ds}: JSONL rows {[r['type'] for r in lines]}")

        # Export with a symbolic batch, loaded and run against the eager forward.
        eh, ew, iters = OFFLINE["export_hw"] + (OFFLINE["export_iters"],)
        path = tmp / "export" / "model.pt2"
        t0 = time.perf_counter()
        make_export.main(["--save_path", str(path), "--ckpt_dir", str(tmp / "ckpt"),
                          "--height", str(eh), "--width", str(ew), "--iters", str(iters),
                          "--vit_size", cfg.vit_size, "--max_disp", str(cfg.max_disp),
                          "--dynamic_batch", "1", "--device", str(dev)])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - t0
        calls = [n for n in program.graph.nodes if n.op == "call_function"]
        nodes = sum(1 for n in calls if str(n.target).startswith("fs."))
        log(f"[offline] export {eh}x{ew}, {iters} iterations, symbolic batch: {export_s:.1f} s, "
            f"{path.stat().st_size} bytes, loaded in {load_s:.1f} s, {len(calls)} operator calls "
            f"in the graph, {nodes} of them fs::")
        per_call = {k: v for k, v in pass_launches(eh, ew, iters, depth).items() if v}
        for b in (1, 2):
            pairs = [make_pair(eh, ew, 500 + i) for i in range(b)]
            pair = [torch.from_numpy(np.concatenate([p[j] for p in pairs])).to(dev) for j in (0, 1)]
            with torch.inference_mode():
                before = dict(kernels.LAUNCHES)
                eager = model(*pair, iters=iters, test_mode=True)
                eager_l = _launched_since(before)
                before = dict(kernels.LAUNCHES)
                got = program(*pair)
                loaded_l = _launched_since(before)
                times = {"eager": [], "loaded": []}
                for label in ("eager", "loaded", "loaded", "eager"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (model(*pair, iters=iters, test_mode=True) if label == "eager"
                     else program(*pair))
                    torch.cuda.synchronize()
                    times[label].append(time.perf_counter() - t0)
            diff = (got.float() - eager.float()).abs()
            equal = bool(torch.equal(got, eager))
            mean, p99 = float(diff.mean()), float(torch.quantile(diff.flatten(), 0.99))
            log(f"[offline] batch {b}: loaded program launches {loaded_l}, eager {eager_l}; "
                f"disparity equal bit for bit {equal} (max |d disp| {float(diff.max()):.4g} px, mean "
                f"{mean:.4g}, p99 {p99:.4g}); warm s per call in turns (eager, loaded, loaded, "
                f"eager) {[round(t, 4) for t in (times['eager'][0], *times['loaded'], times['eager'][1])]}")
            check(tuple(got.shape) == (b, eh, ew) and bool(torch.isfinite(got).all()),
                  f"loaded program output {tuple(got.shape)}")
            check(loaded_l == eager_l == per_call, f"batch {b}: launches loaded {loaded_l}, eager "
                  f"{eager_l}, expected {per_call}")
            check(equal or (mean <= 0.05 and p99 <= 0.5), f"batch {b}: loaded program disagrees")
            if profile and b == 1:
                with torch.inference_mode():
                    profile_call("eager forward, batch 1",
                                 lambda: model(*pair, iters=iters, test_mode=True))
                    profile_call("loaded program, batch 1", lambda: program(*pair))
        del program
    launches = dict(kernels.LAUNCHES)
    log(f"[offline] launches {launches}")
    for name, fn in op_calls(kernels, dev).items():
        log(f"[offline] host time per call of fs::{name}: {host_us_per_call(fn):.1f} us")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,path,serve,demo,mesh,train,offline",
                    help="comma-separated subset of "
                         "env,build,kernels,path,serve,demo,mesh,train,offline")
    ap.add_argument("--profile", action="store_true",
                    help="time one more 736x1280 pair per module and under torch.profiler, for "
                         "the served configuration, the one with the 3x3 conv kernel and the "
                         "served one under the mesh; one train step per module; one eager and "
                         "one exported call under torch.profiler")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    from foundationstereo_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    kernels.build_all(verbose="build" in phases)
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")

    rows = []
    if "kernels" in phases:
        gen = torch.Generator(device=dev).manual_seed(0)
        for fn in (check_cost_volume, check_lookup, check_attention, check_attention_train_shape,
                   check_conv3x3):
            rows.append(fn(dev, gen))
            torch.cuda.empty_cache()
    if "path" in phases:
        t0 = time.perf_counter()
        check_path(dev)
        log(f"[path] {time.perf_counter() - t0:.1f} s")
    served = {}
    if "serve" in phases:
        t0 = time.perf_counter()
        served = serve(dev, REQUESTS, args.profile)
        log(f"[serve] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    launches = {}
    if "demo" in phases:
        t0 = time.perf_counter()
        launches = demo(dev, args.profile)
        log(f"[demo] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    mesh_launches = {}
    if "mesh" in phases:
        t0 = time.perf_counter()
        mesh_rows, mesh_launches = mesh_phase(dev, REQUESTS, args.profile)
        rows += mesh_rows
        log(f"[mesh] {time.perf_counter() - t0:.1f} s")
    train_launches = {}
    if "train" in phases:
        t0 = time.perf_counter()
        train_launches = train_phase(dev, args.profile)
        log(f"[train] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    offline_launches = {}
    if "offline" in phases:
        t0 = time.perf_counter()
        offline_launches = offline_phase(dev, args.profile)
        log(f"[offline] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    by_phase = {"demo": launches, "mesh": mesh_launches, "train": train_launches}
    for row in rows:
        row.setdefault("phase", "demo")
        row["launches"] = by_phase[row["phase"]].get(row["name"], 0)
        row["serve_launches"] = served.get(row["name"], 0)
        row["offline_launches"] = offline_launches.get(row["name"], 0)
        if row["phase"] in phases:
            check(row["launches"] > 0, f"{row['name']} never launched on the {row['phase']} path")
        if "offline" in phases and row["name"] in OFFLINE_KERNELS and row["phase"] == "demo":
            check(row["offline_launches"] > 0, f"{row['name']} never launched on the offline path")
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
