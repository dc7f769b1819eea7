"""Times the ViT flash-attention kernel (K3, and K3s per head shard) at the
main path's shapes on one card.

    python3 tools/k3_timing.py [--against DIR]

After the card's name, power limit and SM clock it prints, for K3 (2 views
x 16 heads of 64 over 5377 tokens) and for each of the four 4-head shards
of K3s (the mesh phase's shards), in bf16 and then in fp32 (the same
values):

- ``kernel``: the kernel (bf16: 192 query rows per block, 3 consumer
  warpgroups; fp32: 128 rows, 2 consumer warpgroups, three TF32 passes)
  held against the fp32 dense twin (``chip_smoke.py``'s tolerances: bf16
  ulps, or 1e-5 for fp32) and timed with ``chip_smoke.cuda_ms`` (launches
  queued behind a device sleep: device time), with the grid it launched,
  its waves and TF/s, beside its bound (fp32: the three-pass TF32 one);
- ``sdpa``: ``F.scaled_dot_product_attention`` on the same heads in the
  same type (TF32 off), the library call the port never makes, timed the
  same way;
- with ``--against DIR``, ``turn``: the wrapper of the checkout at DIR (its
  own ``foundationstereo_torch/ops/kernels.py`` and kernel sources) and this
  tree's, in turns (DIR, this, this, DIR).

It exits non-zero if the kernel or a turn disagrees with the twin.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (imports torch only inside its functions)
from tools.k4_timing import load_kernels  # noqa: E402

B, N, HEADS, HD = 2, chip_smoke.VIT_TOKENS, 16, 64
SHARD_HEADS = HEADS // chip_smoke.MESH_SHARDS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout whose K3 to time in turns")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from foundationstereo_torch.ops import kernels

    if not torch.cuda.is_available():
        print("k3_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = chip_smoke.sm_clock_mhz()
    print(f"{sms} SMs, SM clock {clock} MHz", flush=True)
    other = load_kernels(args.against) if args.against else None
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv16 = torch.randn(B, N, 3, HEADS, HD, device=dev, generator=gen).bfloat16()
    scale = 1.0 / math.sqrt(HD)
    failed = []
    cases = [("K3", 0, HEADS)] + [(f"K3s shard {j}", j * SHARD_HEADS, SHARD_HEADS)
                                  for j in range(chip_smoke.MESH_SHARDS)]
    qkv32 = qkv16.float()
    for qkv, name, h0, heads in ([(qkv16, *c) for c in cases]
                                 + [(qkv32, f"{c[0]} fp32", *c[1:]) for c in cases]):
        part = qkv[:, :, :, h0:h0 + heads]
        ref = kernels.flash_attention_plain(part.float(), scale)
        flop = 4.0 * B * heads * N * N * HD
        nbytes = (part.numel() + ref.numel()) * part.element_size()
        if qkv.dtype == torch.bfloat16:
            b_ms, b_by, exp_ms = chip_smoke.attention_bound(nbytes, flop, B * heads * N * N, sms, clock)
            print(f"case {name}: heads [{h0}, {h0 + heads}), bound {b_ms:.4f} ms ({b_by}), "
                  f"exp {exp_ms:.4f} ms (16 ex2 / SM / clock)", flush=True)
        else:
            fma_ms, b_ms, b_by = chip_smoke.fp32_bounds(nbytes, flop)
            print(f"case {name}: heads [{h0}, {h0 + heads}), three-pass TF32 bound {b_ms:.4f} ms "
                  f"({b_by}), FMA bound {fma_ms:.4f} ms", flush=True)

        def call(mod):
            return mod.flash_attention_heads(qkv, scale, h0, heads)

        def agrees(out):
            if out.dtype == torch.bfloat16:
                return chip_smoke.attention_errors(out, ref)[-1]
            return float((out - ref).abs().max()) <= 1e-5

        out = call(kernels)
        torch.cuda.synchronize()
        grid = chip_smoke.attention_launched()
        ok = agrees(out)
        ms = chip_smoke.cuda_ms(lambda: call(kernels), 10)
        print(f"kernel {name:18s} {ms:9.4f} ms {flop / ms / 1e9:6.1f} TF/s  grid {grid['blocks']:5d} "
              f"({grid['tile']}; {grid['blocks'] / sms:.2f} waves)  {'ok' if ok else 'DISAGREES'}",
              flush=True)
        if not ok:
            failed.append(name)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in part.unbind(2))
        sdpa_ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale), 10)
        print(f"sdpa {name:18s} {sdpa_ms:9.4f} ms {flop / sdpa_ms / 1e9:6.1f} TF/s", flush=True)
        del qs, ks, vs
        if other is not None:
            for label, mod in (("against", other), ("this", kernels), ("this", kernels),
                               ("against", other)):
                out = call(mod)
                torch.cuda.synchronize()
                ok = agrees(out)
                ms = chip_smoke.cuda_ms(lambda: call(mod), 10)
                print(f"turn {name:18s} {label:8s} {ms:9.4f} ms {flop / ms / 1e9:6.1f} TF/s  "
                      f"{'ok' if ok else 'DISAGREES'}", flush=True)
                if not ok:
                    failed.append(f"{name} {label}")
        del ref
        torch.cuda.empty_cache()
    if failed:
        print(f"k3_timing: disagrees with the twin: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
