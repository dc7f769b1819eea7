"""Host cost per call of the kernels' operators on one card.

    python3 tools/op_overhead.py [--against DIR]

After the card's name and power limit it prints, for each of the seven
kernel wrappers at a small bf16 shape whose kernel is shorter than the
host's work per call (``chip_smoke.op_calls``), the host microseconds per
call over calls queued without a synchronisation between them
(``chip_smoke.host_us_per_call``):

- ``op``: the ``torch.ops.fs`` operator (``torch.library.Library``: the
  dispatcher picks the CUDA kernel) through its module name;
- for ``flash_attention`` also ``impl``, its CUDA kernel's Python function
  called directly (the cost without the dispatcher), and ``custom_op``, the
  same function behind ``torch.library.custom_op`` (the other way to define
  an operator, with its Python autograd layer);
- with ``--against DIR``, the wrapper of the checkout at DIR (its own
  ``foundationstereo_torch/ops/kernels.py`` and kernel sources), in turns
  with this tree's (DIR, this, this, DIR, twice over).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout whose wrappers to time in turns")
    args = ap.parse_args()

    import torch

    from foundationstereo_torch.ops import kernels

    if not torch.cuda.is_available():
        print("op_overhead: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    dev = torch.device("cuda")
    kernels.build_all()
    other = load_kernels(args.against) if args.against else None
    if other is not None:
        other.build_all()
    this_calls = chip_smoke.op_calls(kernels, dev)
    other_calls = chip_smoke.op_calls(other, dev) if other is not None else None
    for name, fn in this_calls.items():
        if other_calls is None:
            print(f"{name}: op {chip_smoke.host_us_per_call(fn):.2f} us", flush=True)
            continue
        turns = [(label, chip_smoke.host_us_per_call(f)) for label, f in
                 (("against", other_calls[name]), ("this", fn), ("this", fn),
                  ("against", other_calls[name])) * 2]
        print(f"{name}: in turns " + ", ".join(f"{label} {us:.2f} us" for label, us in turns),
              flush=True)

    @torch.library.custom_op("fs_probe::flash_attention", mutates_args=(),
                             schema="(Tensor qkv, float scale) -> Tensor")
    def probe(qkv, scale):
        return kernels._flash_attention_cuda(qkv, scale)

    qkv = torch.randn((1, 64, 3, 4, 64), device=dev).to(torch.bfloat16)
    forms = {"op": lambda: kernels.flash_attention(qkv, 0.125),
             "impl": lambda: kernels._flash_attention_cuda(qkv, 0.125),
             "custom_op": lambda: probe(qkv, 0.125)}
    for turn in range(2):
        print(f"flash_attention, turn {turn}: " + ", ".join(
            f"{label} {chip_smoke.host_us_per_call(fn):.2f} us" for label, fn in forms.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
