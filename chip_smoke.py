#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``foundationstereo_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one CUDA card

Phases:

1. env     -- the card's name and power limit (nvidia-smi), torch / CUDA
              versions, the TF32 settings this run uses (both off).
2. build   -- compile the three CUDA kernels from ``foundationstereo_torch/csrc``
              (one nvcc per source, in parallel) and print the build seconds.
3. kernels -- each kernel against its plain PyTorch twin on the card, at the
              shapes of the main path (ViT-L, max_disp 416, 736x1280): max abs
              error against the stated tolerance (and relative to max |twin|), kernel / plain / library
              times (CUDA events) and the least time the card could take
              (``bound_ms``, from the bytes and operations of this run's inputs).
4. path    -- the whole forward at a reduced size (448x672, 4 iterations),
              once through the kernels and once through the plain twins with
              the same weights and bf16 pyramids on both; the disparities
              must agree.
5. serve   -- the full configuration (ViT-L, max_disp 416, bf16, seeded
              random weights) answers 3 requests of 736x1280 pairs through
              ``inference.demo.run_pair`` with 32 iterations; the output must
              be finite and of the right shape, and the launch counts must be
              1 cost-volume, 24 attention and 32 lookup launches per pair.

It then prints the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Any failed check raises, so the exit
code is non-zero and no result line is printed. Without a CUDA device it exits
with code 1 before any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

MAIN = dict(vit_size="vitl", max_disp=416, height=736, width=1280, iters=32)
# The reduced whole-path comparison: 448x672 still gives the ViT 1537 > 1024
# tokens, so the attention kernel runs.
PATH = dict(height=448, width=672, iters=4)
REQUESTS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    import torch

    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins at the main-path shapes
# ---------------------------------------------------------------------------


def check_cost_volume(dev, gen) -> dict:
    import torch

    from foundationstereo_torch.ops import cost_volume, kernels

    B, C, H, W, G, P, D = 1, 224, MAIN["height"] // 4, MAIN["width"] // 4, 8, 12, MAIN["max_disp"] // 4
    left, right = (torch.randn(B, C, H, W, device=dev, generator=gen).bfloat16() for _ in range(2))
    rp = torch.randn(B, P, H, W, device=dev, generator=gen).bfloat16()
    gk, rk = kernels.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16)
    gp, rpp = cost_volume.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gk32, gp32 = gk.float(), gp.float()
    err = (gk32 - gp32).abs()
    # 1 bf16 ulp of the larger value, plus 2e-6 for the fp32 sums over cg = 28
    # products taken in another order (it matters only where they cancel).
    ulp_ok = bool((err <= bf16_ulp(torch.maximum(gk32.abs(), gp32.abs())) + 2e-6).all())
    rps_exact = bool(torch.equal(rk, rpp))
    max_err = max(float(err.max()), float((rk.float() - rpp.float()).abs().max()))
    rel = max_err / float(gp32.abs().max())
    log(f"[kernels] cost_volume_parts: gwc max abs err {float(err.max()):.3g}, rel {rel:.3g} "
        f"(tolerance: 1 bf16 ulp + 2e-6 per element -> {ulp_ok}), rps exact {rps_exact}")
    check(ulp_ok and rps_exact, "cost_volume_parts disagrees with its twin")

    ms = cuda_ms(lambda: kernels.cost_volume_parts(left, right, rp, D, G, out_dtype=torch.bfloat16), 20)
    plain_ms = cuda_ms(lambda: cost_volume.cost_volume_parts(left, right, rp, D, G,
                                                             out_dtype=torch.bfloat16), 3)
    nbytes = sum(t.numel() * t.element_size() for t in (left, right, rp, gk, rk))
    flops = 2.0 * C * B * H * sum(max(W - d, 0) for d in range(D))
    b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
    return dict(name="cost_volume_parts", route="cuda",
                source="foundationstereo_torch/csrc/cost_volume.cu",
                replaces="foundationstereo_tpu/ops/pallas_kernels.py:598",
                max_abs_err=max_err, max_rel_err=rel,
                tolerance="1 bf16 ulp + 2e-6 per element (rps exact)",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


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
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels, sampler

    r, levels = 4, 4
    geo, corr, disp = _pyramids(dev, gen, levels, torch.bfloat16)
    out = kernels.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16)
    ref = sampler.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    o32, r32 = out.float(), ref.float()
    diff = (o32 - r32).abs()
    err = float(diff.max())
    rel = err / float(r32.abs().max())
    # Both accumulate in fp32 and round once to bf16: 1 bf16 ulp of the larger
    # value, plus 1e-6 for the fp32 sums taken in another order.
    ulp_ok = bool((diff <= bf16_ulp(torch.maximum(o32.abs(), r32.abs())) + 1e-6).all())
    del o32, r32, diff
    log(f"[kernels] disparity_lookup: out {tuple(out.shape)}, max abs err {err:.3g}, rel {rel:.3g} "
        f"(tolerance: 1 bf16 ulp + 1e-6 per element -> {ulp_ok}; inputs in [-1, 1])")
    check(ulp_ok, "disparity_lookup disagrees with its twin")

    ms = cuda_ms(lambda: kernels.disparity_lookup(geo, corr, disp, r, out_dtype=torch.bfloat16), 20)
    plain_ms = cuda_ms(lambda: sampler.disparity_lookup(geo, corr, disp, r,
                                                        out_dtype=torch.bfloat16), 3)

    # One library call per level and volume: grid_sample over (pixel, 1, L) rows.
    B, H, W, C = geo[0].shape[:4]
    n = B * H * W
    k = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    grids = []
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for x, L in (((disp * s)[..., None] + k, g.shape[-1]),
                     (((xs - disp) * s)[..., None] + k, c.shape[-1])):
            gx = (2.0 * x / (L - 1) - 1.0).reshape(n, 1, 2 * r + 1, 1)
            grids.append(torch.cat([gx, torch.zeros_like(gx)], dim=-1).to(torch.bfloat16))

    def library():
        for i, (g, c) in enumerate(zip(geo, corr)):
            F.grid_sample(g.view(n, C, 1, g.shape[-1]), grids[2 * i], align_corners=True)
            F.grid_sample(c.view(n, 1, 1, c.shape[-1]), grids[2 * i + 1], align_corners=True)

    library_ms = cuda_ms(library, 5)

    # Bytes this run's positions need: the in-range part of each 2r+2 window.
    touched = 0
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for x, L, ch in ((disp * s, g.shape[-1], C), ((xs - disp) * s, c.shape[-1], 1)):
            i0 = torch.floor(x.clamp(-(L + 2 * r + 2), L + 2 * r + 2))
            lo, hi = (i0 - r).clamp(0, L), (i0 + r + 2).clamp(0, L)
            touched += float((hi - lo).clamp_min(0).sum()) * ch
    nbytes = touched * 2 + disp.numel() * 4 + out.numel() * out.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * out.numel(), FP32_FLOPS)
    return dict(name="disparity_lookup", route="cuda",
                source="foundationstereo_torch/csrc/lookup.cu",
                replaces="foundationstereo_tpu/ops/pallas_kernels.py:112",
                max_abs_err=err, max_rel_err=rel, tolerance="1 bf16 ulp + 1e-6 per element",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def check_attention(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    B, N, Hh, hd = 2, (784 // 14) * (1344 // 14) + 1, 16, 64
    scale = 1.0 / math.sqrt(hd)
    qkv = torch.randn(B, N, 3, Hh, hd, device=dev, generator=gen).bfloat16()
    out = kernels.flash_attention(qkv, scale)
    ref = kernels.flash_attention_plain(qkv.float(), scale)    # dense, fp32 throughout
    torch.cuda.synchronize()
    diff = (out.float() - ref).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    ref_max, ref_mean = float(ref.abs().max()), float(ref.abs().mean())
    del diff
    # bf16 output rounding costs half an ulp, the bf16 probabilities in P @ V
    # a little more: max error <= 2 bf16 ulps of max |ref|, mean error <= 1
    # bf16 ulp of the typical |ref| (a skipped key tile, a wrong scale or a bad
    # tail mask moves the mean by far more).
    tol_max = 2 * float(bf16_ulp(torch.tensor(ref_max)))
    tol_mean = float(bf16_ulp(torch.tensor(ref_mean)))
    log(f"[kernels] flash_attention bf16: N={N}, max abs err {err:.3g} (tolerance {tol_max:.3g} "
        f"= 2 bf16 ulps of max |ref| {ref_max:.3g}), mean abs err {mean_err:.3g} (tolerance "
        f"{tol_mean:.3g} = 1 bf16 ulp of mean |ref| {ref_mean:.3g}) vs fp32 dense")
    check(err <= tol_max and mean_err <= tol_mean,
          "flash_attention disagrees with the fp32 dense reference")

    # The fp32 kernel (the model without mixed precision) on the same inputs.
    qkv32 = qkv.float()
    out32 = kernels.flash_attention(qkv32, scale)
    torch.cuda.synchronize()
    err32 = float((out32 - ref).abs().max())
    del ref, out32
    log(f"[kernels] flash_attention fp32: N={N}, max abs err {err32:.3g} vs fp32 dense "
        f"(tolerance 1e-5: summation order)")
    check(err32 <= 1e-5, "fp32 flash_attention disagrees with the fp32 dense reference")
    fp32_ms = cuda_ms(lambda: kernels.flash_attention(qkv32, scale), 3)
    fp32_bound_ms, _ = bound(qkv32.numel() * 4 * 4 / 3, 4.0 * B * Hh * N * N * hd, FP32_FLOPS)
    del qkv32

    ms = cuda_ms(lambda: kernels.flash_attention(qkv, scale), 10)
    plain_ms = cuda_ms(lambda: kernels.flash_attention_plain(qkv, scale), 3)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 10)
    nbytes = qkv.numel() * 2 + out.numel() * 2
    b_ms, b_by = bound(nbytes, 4.0 * B * Hh * N * N * hd, BF16_FLOPS)
    log(f"[kernels] flash_attention fp32: {fp32_ms:.4g} ms (bound {fp32_bound_ms:.4g} ms at "
        f"the fp32 peak)")
    return dict(name="flash_attention", route="cuda",
                source="foundationstereo_torch/csrc/flash_attention.cu",
                replaces="foundationstereo_tpu/models/dinov2.py:71",
                max_abs_err=err, max_rel_err=err / ref_max, mean_abs_err=mean_err,
                ref_max_abs=ref_max, ref_mean_abs=ref_mean,
                tolerance="max <= 2 bf16 ulps of max |ref|, mean <= 1 bf16 ulp of mean |ref|, "
                          "vs fp32 dense",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                fp32_max_abs_err=err32, fp32_ms=fp32_ms, fp32_bound_ms=fp32_bound_ms)


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------


def make_pair(h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))


def check_path(dev) -> None:
    """Kernels against plain twins through the whole forward, same weights."""
    import torch

    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.inference.demo import run_pair
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo

    h, w, iters = PATH["height"], PATH["width"], PATH["iters"]
    cfg = ModelConfig(vit_size=MAIN["vit_size"], max_disp=MAIN["max_disp"], mixed_precision=True)
    left, right = make_pair(h, w, 1)
    outs = {}
    for use_pallas in (True, False):
        model = FoundationStereo(cfg.replace(use_pallas=use_pallas), device=dev, seed=0)
        model.pyramid_dtype = torch.bfloat16     # both paths store the pyramids in bf16
        outs[use_pallas] = run_pair(model, left, right, iters=iters).float()
        del model
        torch.cuda.empty_cache()
    diff = (outs[True] - outs[False]).abs()
    mean, p99, mx = float(diff.mean()), float(torch.quantile(diff.flatten(), 0.99)), float(diff.max())
    log(f"[path] {h}x{w}, {iters} iterations: kernels vs plain twins |d disp| mean {mean:.4g} px, "
        f"p99 {p99:.4g} px, max {mx:.4g} px; disparity mean {float(outs[False].mean()):.4g} px "
        f"(tolerance: mean <= 0.05 px, p99 <= 0.5 px)")
    check(bool(torch.isfinite(outs[True]).all()), "non-finite disparity on the kernel path")
    check(mean <= 0.05 and p99 <= 0.5, "kernel path disagrees with the plain path")


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
    want = {"cost_volume_parts": requests,
            "flash_attention": requests * VIT_CONFIGS[MAIN["vit_size"]]["depth"],
            "disparity_lookup": requests * MAIN["iters"]}
    check(launches == want, f"launch counts {launches}, expected {want}")
    if profile:
        profile_pair(model, pairs[0])
    return launches


def profile_pair(model, pair) -> None:
    """One more request, timed per top-level module with CUDA events (what
    no module covers -- the cost-volume build, the pyramids, the lookups --
    is the remainder), then under torch.profiler for the top device ops."""
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

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_pair(model, *pair, iters=MAIN["iters"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3   # kernels only
    log(f"[profile] under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %)")
    log(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,path,serve",
                    help="comma-separated subset of env,build,kernels,path,serve")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, time one more pair per module and under torch.profiler")
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
        for fn in (check_cost_volume, check_lookup, check_attention):
            rows.append(fn(dev, gen))
            torch.cuda.empty_cache()
    if "path" in phases:
        t0 = time.perf_counter()
        check_path(dev)
        log(f"[path] {time.perf_counter() - t0:.1f} s")
    launches = {}
    if "serve" in phases:
        t0 = time.perf_counter()
        launches = serve(dev, REQUESTS, args.profile)
        log(f"[serve] {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        if "serve" in phases:
            check(row["launches"] > 0, f"{row['name']} never launched on the main path")
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
