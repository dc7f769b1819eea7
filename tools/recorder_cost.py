"""Pairs per second of a benchmark cell with the program's span recorder
open against closed, in turns on one card.

    python3 tools/recorder_cost.py --workload pair-vitl-b1 --seed 7 --seconds 20 --turns 2

Sets the cell up as ``python3 -m portbench.run`` does (kernels, weights from
the seed, the cell's traffic, warm-up), then times windows of ``--seconds``
each as the benchmark's window does (closed-loop calls, the last one
finishing), in the order closed, open, open, closed, ``--turns`` times
over; each open window inside ``utils.trace.recording()``, synchronized and
summarised before the next. Prints the card's name and power limit, one line
per window, and last one JSON line: each side's pairs/s, their medians, and
the spans recorded per call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="pair-vitl-b1")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import torch

    from foundationstereo_torch.ops import kernels
    from foundationstereo_torch.utils.trace import recording
    from portbench import run, spec

    if not torch.cuda.is_available():
        print("recorder_cost: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cell = spec.cell(args.workload)
    kind = run.kind_class(cell["mix"]["kind"])(cell, args.seed, "cuda")
    kernels.build_all()
    kind.setup(run.Parts())
    rates = {"closed": [], "open": []}
    spans_per_call = []
    start = 0
    for side in ["closed", "open", "open", "closed"] * args.turns:
        torch.cuda.synchronize()
        if side == "open":
            with recording() as rec:
                w = run.window(kind, args.seconds, start)
            torch.cuda.synchronize()
            rec.summary()
            spans_per_call.append(len(rec.spans) / w["calls"])
        else:
            w = run.window(kind, args.seconds, start)
        start = w["next"]
        rates[side].append(w["items"] / w["seconds"])
        print(f"{side}: {rates[side][-1]:.4f} pairs/s over {w['calls']} calls", flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "pairs_per_s": rates,
                      "median": {k: statistics.median(v) for k, v in rates.items()},
                      "spans_per_call": spans_per_call}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
