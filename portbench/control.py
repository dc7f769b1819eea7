"""The controls that the limits of ``correct`` are set against, at a cell's
own size: the reference in the precision below the configuration's (fp8,
``float8_e4m3fn`` with one scale per tensor, for the bf16 configurations)
put in the program's place and compared with the fp32 reference by the
cell's own numbers; for a training cell also the reference on half of each
batch (the mean taken over the rest).

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--fault fp8 half_batch]

Prints one JSON line per seed and fault. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import compare, spec, traffic
from portbench.reference import model as reference
from portbench.reference.ops import pad_to

FP8 = torch.float8_e4m3fn


def pairs_control(cell: dict, seed: int, device, overrides: dict | None = None) -> dict:
    """The cell's numbers for the fp8 reference against the fp32 one, on the
    requests a run with ``seed`` samples."""
    from portbench.pairs import Pairs

    kind = Pairs(cell, seed, device, overrides)
    pool = traffic.pairs(kind.mix, seed, device)
    ref = reference.build(kind.model_cfg, device, kind.weights_seed)
    low = reference.build(kind.model_cfg, device, kind.weights_seed, cdt=FP8)
    rows = []
    with torch.no_grad():
        for k in kind.sample:
            for b in range(pool[k][0].shape[0]):
                pair = [pad_to(torch.as_tensor(x[b:b + 1], device=device).float())[0]
                        for x in pool[k]]
                t32, t8 = {}, {}
                d32 = ref(*pair, kind.iters, test_mode=True, taps=t32)
                d8 = low(*pair, kind.iters, test_mode=True, taps=t8)
                rows.append({"disp_mae_px": compare.mean_abs(d8, d32),
                             **compare.filter_numbers(t8["classifier"], t32["classifier"])})
    return {n: max(r[n] for r in rows) for n in rows[0]}


def train_control(cell: dict, seed: int, device, faults: list[str],
                  overrides: dict | None = None, log=lambda msg: None) -> dict:
    """The training cell's numbers for a faulty reference in the program's
    place against the fp32 reference over the steps set-up takes (the first
    step's forward outputs, its judged blocks and the steps' numbers), by
    fault: ``fp8`` (the reference in fp8) or ``half_batch`` (each step on
    the first half of its batch, the mean taken over it). ``log`` receives
    each judged block's gap."""
    from portbench.training import Training, forward_numbers, reference_steps, step_numbers

    kind = Training(cell, seed, device, overrides)
    pool = traffic.train_batches(kind.mix, seed, device, list(kind.recipe["loss"]))
    bad = {fault: reference_steps(kind.recipe, pool, device, kind.weights_seed,
                                  cdt=FP8 if fault == "fp8" else torch.float32,
                                  half_batch=fault == "half_batch", catch=True)
           for fault in faults}
    ref = reference_steps(kind.recipe, pool, device, kind.weights_seed,
                          judge=tuple(bad[f]["outputs"] for f in faults), log=log)
    quiet = lambda msg: None  # noqa: E731
    return {fault: dict(forward_numbers(bad[fault]["outputs"], ref["outputs"], quiet),
                        **ref["blocks"][i], **step_numbers(bad[fault], ref, quiet))
            for i, fault in enumerate(faults)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="+", default=["fp8"], choices=["fp8", "half_batch"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.control: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        if cell["mix"]["kind"] == "pairs":
            by_fault = {"fp8": pairs_control(cell, seed, device)}
        else:
            by_fault = train_control(cell, seed, device, args.fault,
                                     log=lambda msg: print(msg, file=sys.stderr, flush=True))
        for fault, numbers in by_fault.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
