"""The controls that the limits of ``correct`` are set against, at a cell's
own size: the reference in the precision below the configuration's (fp8,
``float8_e4m3fn`` with one scale per tensor, for the bf16 configurations)
put in the program's place and compared with the fp32 reference by the
cell's own numbers, and the other faults the cell's kind knows (for
training also the reference on half of each batch, and on N ranks each
rank's update from its own gradient). Each kind's ``control`` computes them
(``kinds/<kind>.py``); a cell of N chips runs it on N ranks, and each number
is the largest over the ranks.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--fault fp8 half_batch]

Prints one JSON line per seed and fault. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import ranks, spec


def controls(name: str, seeds: list[int], faults: list[str], device,
             overrides: dict | None = None, log=lambda msg: None) -> dict:
    """{seed: {fault: numbers}} for the cell ``name``, on the cell's chips."""
    chips = spec.cell(name)["chips"]
    if chips > 1:
        return ranks.spawn(_on_ranks, chips, torch.device(device).type,
                           args=(name, seeds, faults, overrides))
    return _on_ranks(torch.device(device), name, seeds, faults, overrides, log)


def _on_ranks(device, name, seeds, faults, overrides=None, log=None) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(name)
    kind = spec.kind(cell["mix"]["kind"])
    if log is None:
        log = (lambda msg: print(msg, file=sys.stderr, flush=True)) if ranks.rank() == 0 \
            else (lambda msg: None)
    out = {}
    for seed in seeds:
        mine = kind.control(cell, seed, device, faults, overrides, log)
        out[seed] = {f: ranks.largest([row[f] for row in ranks.gather(mine)]) for f in faults}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="+", default=["fp8"])
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    known = spec.kind(cell["mix"]["kind"]).FAULTS
    if set(args.fault) - set(known):
        raise SystemExit(f"portbench.control: the cell's kind knows the faults {known}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        raise SystemExit(f"portbench.control: needs {cell['chips']} CUDA device(s)")
    by_seed = controls(args.workload, args.seeds, args.fault, torch.device("cuda"),
                       log=lambda msg: print(msg, file=sys.stderr, flush=True))
    for seed, by_fault in by_seed.items():
        for fault, numbers in by_fault.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
