"""Times the 3x3 conv kernel (K4) at the main path's shapes on one card.

    python3 tools/k4_timing.py [--against DIR]

For each case of ``chip_smoke.K4_CASES`` it prints, after the card's name
and power limit:

- ``tile``: every tile the kernel has -- bf16: 64 or 128 output channels by
  2 or 4 output rows; fp32: 64 channels by 4 rows or 128 by 2 -- the one
  the wrapper picks marked ``*``, each held against the plain twin and
  timed with ``chip_smoke.cuda_ms`` (launches queued behind a device sleep:
  device time), with the grid it launched;
- with ``--against DIR``, ``turn``: the K4 wrapper of the checkout at DIR
  (its own ``foundationstereo_torch/ops/kernels.py`` and kernel sources)
  and this tree's, in turns (DIR, this, this, DIR), each timed both ways:
  queued, and with the launches issued back to back from the host and not
  queued (``unqueued_ms``, the timer ``chip_smoke.py`` used before).

It exits non-zero if a tile or a turn disagrees with the twin.
"""

from __future__ import annotations

import argparse
import contextlib
import types
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (imports torch only inside its functions)


def unqueued_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls issued back to back,
    timed with CUDA events: where a call is shorter than the host's launch,
    the host's gaps count."""
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


def load_kernels(checkout: Path):
    """The ``kernels`` module of another checkout, loaded by path (its plain
    twins come from this tree's package); where it defines operators, they
    go into a namespace of their own (``fs_against``)."""
    path = checkout.resolve() / "foundationstereo_torch" / "ops" / "kernels.py"
    source = path.read_text().replace('\nNAMESPACE = "fs"\n', '\nNAMESPACE = "fs_against"\n')
    mod = types.ModuleType("k4_timing_other_kernels")
    mod.__file__ = str(path)
    exec(compile(source, str(path), "exec"), mod.__dict__)
    return mod


@contextlib.contextmanager
def tile(kernels, bn: int, rows: int):
    """The kernel forced to ``bn`` output channels by ``2 * rows`` rows."""
    saved = kernels._pack_rows, kernels.conv3x3_rows
    kernels._pack_rows, kernels.conv3x3_rows = (lambda *args: bn), (lambda *args: rows)
    try:
        yield
    finally:
        kernels._pack_rows, kernels.conv3x3_rows = saved


def held(kernels, x, w, bias, ref) -> tuple[bool, float, object]:
    """One call of ``kernels.conv3x3`` held against the twin's ``ref``:
    (agrees, max abs err, the packed weight)."""
    import torch

    packed = kernels.pack_conv3x3_weight(w, x.dtype)
    out = kernels.conv3x3(x, w, bias, packed)
    torch.cuda.synchronize()
    err, _mean, ok, mean_ok = chip_smoke._conv_errors(x, w, bias, out, ref)
    return ok and mean_ok, err, packed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout whose K4 to time in turns")
    args = ap.parse_args()

    import torch

    from foundationstereo_torch.ops import kernels

    if not torch.cuda.is_available():
        print("k4_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    other = load_kernels(args.against) if args.against else None
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []
    for name, c, f, spatial, dtype in chip_smoke.K4_CASES:
        dtype = getattr(torch, dtype)
        x, w, bias = chip_smoke._conv_case(dev, gen, c, f, spatial, dtype)
        ref = kernels.conv3x3_plain(x, w, bias)
        flop = 2.0 * 9 * c * f * x[0, 0].numel()
        h, wd = x.shape[-2:]
        picked = (kernels._pack_rows(f, dtype),
                  kernels.conv3x3_rows(f, h, wd, x.numel() // (c * h * wd), sms, dtype))
        tiles = ([(bn, rows) for bn in (64, 128) for rows in (1, 2)] if dtype == torch.bfloat16
                 else [(64, 2), (128, 1)])
        for bn, rows in tiles:
            with tile(kernels, bn, rows):
                ok, err, packed = held(kernels, x, w, bias, ref)
                grid = chip_smoke.k4_launched()
                ms = chip_smoke.cuda_ms(lambda: kernels.conv3x3(x, w, bias, packed), 10)
            mark = "*" if (bn, rows) == picked else " "
            print(f"tile {name:37s} {bn:3d} ch x {2 * rows} rows{mark} {ms:9.4f} ms "
                  f"{flop / ms / 1e9:6.1f} TF/s  grid {grid['blocks']:5d}  max err {err:.3g} "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                failed.append(f"{name} tile {bn}x{rows}")
        if other is None:
            continue
        for label, mod in (("against", other), ("this", kernels), ("this", kernels),
                           ("against", other)):
            ok, err, packed = held(mod, x, w, bias, ref)
            queued = chip_smoke.cuda_ms(lambda: mod.conv3x3(x, w, bias, packed), 10)
            back_to_back = unqueued_ms(lambda: mod.conv3x3(x, w, bias, packed), 10)
            print(f"turn {name:37s} {label:8s} queued {queued:9.4f} ms  unqueued "
                  f"{back_to_back:9.4f} ms  max err {err:.3g} {'ok' if ok else 'DISAGREES'}",
                  flush=True)
            if not ok:
                failed.append(f"{name} {label}")
        del x, w, bias, ref
        torch.cuda.empty_cache()
    if failed:
        print(f"k4_timing: disagrees with the twin: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
