"""Times the cost-volume build (K1, and K5's build per width shard) and the
disparity lookup (K2, and K5's lookup per width shard) at the main path's
shapes on one card.

    python3 tools/k1_k2_timing.py [--against DIR]

After the card's name and power limit it prints, for K1 (224 channels in 8
groups, 12 projection channels, 104 disparities at 184x320), for each of
the four 80-column shards of K5's build (``chip_smoke.py``'s mesh shards),
for K2 (4 levels, 28 channels, radius 4 at 184x320) and for each of the
four shards of K5's lookup (and K2 again at radius 1 and 6, which run the
kernel's generic instantiation, and on its first 1, 2 and 3 levels alone,
which splits its time by level):

- ``kernel``: the kernel held against its plain twin (``chip_smoke.py``'s
  tolerances) and timed with ``chip_smoke.cuda_ms`` (launches queued behind
  a device sleep: device time), with the grid it launched (checked against
  the helpers in ``ops/kernels.py``), its bound and, for the lookups, the
  sector floor (the unique 32-byte sectors its windows touch, plus the
  disparities and the output, at 3.35 TB/s) and ``F.grid_sample`` (one call
  per level and volume, the library call the port never makes);
- with ``--against DIR``, ``turn``: the wrapper of the checkout at DIR (its
  own ``foundationstereo_torch/ops/kernels.py`` and kernel sources) and this
  tree's, in turns (DIR, this, this, DIR), each held against the twin.

It exits non-zero without a CUDA device, or if a kernel or a turn disagrees
with the twin.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (imports torch only inside its functions)
from tools.k4_timing import load_kernels  # noqa: E402

RADIUS, LEVELS = 4, 4


def cost_volume_cases(dev, gen):
    """(name, call(kernels module), twin outputs, bound ms, bound by) for K1
    and each K5 build shard."""
    import torch

    from foundationstereo_torch.ops import cost_volume

    left, right, rp, D, G, P = chip_smoke.cost_volume_inputs(dev, gen)
    B, C, H, W = left.shape
    bf = torch.bfloat16
    nbytes = sum(t.numel() * 2 for t in (left, right, rp)) + B * (G + P) * D * H * W * 2
    flops = 2.0 * C * B * H * sum(max(W - d, 0) for d in range(D))
    cases = [("K1", lambda k: k.cost_volume_parts(left, right, rp, D, G, out_dtype=bf),
              lambda: cost_volume.cost_volume_parts(left, right, rp, D, G, out_dtype=bf),
              *chip_smoke.bound(nbytes, flops, chip_smoke.FP32_FLOPS))]
    wl = W // chip_smoke.MESH_SHARDS
    for j in range(chip_smoke.MESH_SHARDS):
        x0 = j * wl
        lj = left[..., x0:x0 + wl].contiguous()
        ws = max(x0 - (D - 1), 0)
        nbytes = (lj.numel() + B * (C + P) * H * (x0 + wl - ws)) * 2 + B * (G + P) * D * H * wl * 2
        pairs = sum(min(D, x0 + w + 1) for w in range(wl))
        cases.append((f"K5 build shard {j}",
                      lambda k, lj=lj, x0=x0: k.cost_volume_parts_haloed(lj, right, rp, D, G, x0,
                                                                         out_dtype=bf),
                      lambda lj=lj, x0=x0: cost_volume.cost_volume_parts_haloed(
                          lj, right, rp, D, G, x0, out_dtype=bf),
                      *chip_smoke.bound(nbytes, 2.0 * C * B * H * pairs, chip_smoke.FP32_FLOPS)))
    return cases, (left, D, G, P)


def lookup_cases(dev, gen):
    """(name, call(kernels module), twin, geo, corr, disp, x offset) for K2
    and each K5 lookup shard."""
    import torch

    from foundationstereo_torch.ops import sampler

    geo, corr, disp = chip_smoke._pyramids(dev, gen, LEVELS, torch.bfloat16)
    bf = torch.bfloat16
    cases = [("K2", lambda k: k.disparity_lookup(geo, corr, disp, RADIUS, out_dtype=bf),
              lambda: sampler.disparity_lookup(geo, corr, disp, RADIUS, out_dtype=bf),
              geo, corr, disp, 0)]
    wl = disp.shape[-1] // chip_smoke.MESH_SHARDS
    for j in range(chip_smoke.MESH_SHARDS):
        x0 = j * wl
        gj = [g[:, :, x0:x0 + wl].contiguous() for g in geo]
        cj = [c[:, :, x0:x0 + wl].contiguous() for c in corr]
        dj = disp[..., x0:x0 + wl].contiguous()
        cases.append((f"K5 lookup shard {j}",
                      lambda k, gj=gj, cj=cj, dj=dj, x0=x0: k.disparity_lookup_shard(
                          gj, cj, dj, RADIUS, x0, out_dtype=bf),
                      lambda gj=gj, cj=cj, dj=dj, x0=x0: sampler.disparity_lookup(
                          gj, cj, dj, RADIUS, out_dtype=bf, x_offset=x0),
                      gj, cj, dj, x0))
    return cases


def turns(other, kernels, call, agrees, name, failed) -> None:
    """The checkout at --against and this tree's kernel in turns (DIR,
    this, this, DIR), each held against the twin and timed."""
    import torch

    for label, mod in (("against", other), ("this", kernels), ("this", kernels), ("against", other)):
        out = call(mod)
        torch.cuda.synchronize()
        ok = agrees(out)
        ms = chip_smoke.cuda_ms(lambda: call(mod), 20)
        print(f"turn {name:19s} {label:8s} {ms:9.4f} ms  {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failed.append(f"{name} {label}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout whose K1 and K2 to time in turns")
    args = ap.parse_args()

    import torch

    from foundationstereo_torch.ops import kernels, sampler

    if not torch.cuda.is_available():
        print("k1_k2_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    dev = torch.device("cuda")
    other = load_kernels(args.against) if args.against else None
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []

    cases, (left, D, G, P) = cost_volume_cases(dev, gen)
    for name, call, twin, b_ms, b_by in cases:
        want = twin()
        out = call(kernels)
        torch.cuda.synchronize()
        lj = left if name == "K1" else left[..., :out[0].shape[-1]]
        grid = chip_smoke.cost_volume_launched(lj, D, G, P)

        def agrees(got, want=want):
            return chip_smoke.cost_volume_errors(*got, *want)[1]

        ok = agrees(out)
        ms = chip_smoke.cuda_ms(lambda: call(kernels), 20)
        print(f"kernel {name:19s} {ms:9.4f} ms  bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of it)  "
              f"grid {grid['blocks']} ({grid['tile']})  {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failed.append(name)
        if other is not None:
            turns(other, kernels, call, agrees, name, failed)
        del want, out
    del cases
    torch.cuda.empty_cache()

    cases = lookup_cases(dev, gen)
    for name, call, twin, geo, corr, disp, x0 in cases:
        want = twin()
        out = call(kernels)
        torch.cuda.synchronize()
        grid = chip_smoke.lookup_launched(geo, disp)

        def agrees(got, want=want):
            return chip_smoke.lookup_errors(got, want)[1]

        ok = agrees(out)
        ms = chip_smoke.cuda_ms(lambda: call(kernels), 20)
        b_ms, b_by = chip_smoke.lookup_bound(geo, corr, disp, RADIUS, out, x0)
        sector_ms = chip_smoke.lookup_sector_bound(geo, corr, disp, RADIUS, out, x0)
        library_ms = chip_smoke.cuda_ms(chip_smoke.lookup_library(geo, corr, disp, RADIUS, x0), 5)
        print(f"kernel {name:19s} {ms:9.4f} ms  bound {b_ms:.4f} ms ({b_by}), sector floor "
              f"{sector_ms:.4f} ms ({sector_ms / ms:.0%} of it)  F.grid_sample x {2 * LEVELS} "
              f"{library_ms:.4f} ms  grid {grid['blocks']} ({grid['tile']})  "
              f"{'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failed.append(name)
        if other is not None:
            turns(other, kernels, call, agrees, name, failed)
        del want, out

    _, _, _, geo, corr, disp, _ = cases[0]
    # K2 at the other radii the card tests hold (r = 4 on every path the
    # model drives; the others run the generic instantiation), then on the
    # first levels alone: how its time follows the windows, and by level.
    variants = [(f"K2 radius {r}", geo, corr, r) for r in (1, 6)]
    variants += [(f"K2 levels 0..{n - 1}", geo[:n], corr[:n], RADIUS) for n in (1, 2, 3)]
    for name, g, c, r in variants:
        out = kernels.disparity_lookup(g, c, disp, r, out_dtype=torch.bfloat16)
        ok = chip_smoke.lookup_errors(out, sampler.disparity_lookup(g, c, disp, r,
                                                                    out_dtype=torch.bfloat16))[1]
        ms = chip_smoke.cuda_ms(lambda: kernels.disparity_lookup(g, c, disp, r,
                                                                 out_dtype=torch.bfloat16), 20)
        b_ms, b_by = chip_smoke.lookup_bound(g, c, disp, r, out)
        sector_ms = chip_smoke.lookup_sector_bound(g, c, disp, r, out)
        print(f"kernel {name:19s} {ms:9.4f} ms  bound {b_ms:.4f} ms ({b_by}), sector floor "
              f"{sector_ms:.4f} ms ({sector_ms / ms:.0%} of it)  {'ok' if ok else 'DISAGREES'}",
              flush=True)
        if not ok:
            failed.append(name)
        del out
    if failed:
        print(f"k1_k2_timing: disagrees with the twin: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
