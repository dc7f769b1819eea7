"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run sets up (imports, CUDA context, the program's kernels, weights from
the seed, the cell's traffic, warm-up at the cell's own shapes), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit. Earlier lines give the set-up by part, kernel launches
per call and the card's name, clocks and power limit.

With ``--trace 1`` the window's first half is timed plainly (the rate the
``mfu`` metrics read), its second half under CUDA-event hooks on the
model's top-level modules, and then a few calls under ``torch.profiler``.

A run fails without a result where there is no CUDA card, fewer cards than
the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "foundationstereo_tpu"}
KINDS = {"pairs": "portbench.pairs:Pairs", "train_batches": "portbench.training:Training"}
TRACED_CALLS = {"pairs": 3, "train_batches": 2}


def log(msg: str) -> None:
    print(f"[portbench] {msg}", flush=True)


class Parts:
    """Wall seconds of the set-up's parts, in order."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = time.perf_counter() - t


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def kind_class(mix_kind: str):
    import importlib

    module, name = KINDS[mix_kind].split(":")
    return getattr(importlib.import_module(module), name)


def window(kind, seconds: float, start: int) -> dict:
    """Closed-loop calls from index ``start`` until ``seconds`` have passed
    (the last call started before that finishes and counts)."""
    lat, items, i = [], 0, start
    t0 = t = time.perf_counter()
    while t - t0 < seconds:
        a = time.perf_counter()
        items += kind.call(i)
        t = time.perf_counter()
        lat.append(t - a)
        i += 1
    return {"seconds": t - t0, "items": items, "calls": len(lat), "latencies_s": lat, "next": i}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, parts: Parts | None = None,
             t0: float | None = None, bench: dict | None = None) -> dict:
    """One run of the cell; returns the result object (not yet printed).
    ``t0`` is when the set-up began (the process's start when run as a
    command); ``overrides`` shrinks the cell and ``bench`` stands for
    ``BENCHMARK.json`` in tests on the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from portbench import compare, spec

    parts = parts or Parts()
    bench = bench or spec.benchmark()
    cell = spec.cell(name, bench)
    kind = kind_class(cell["mix"]["kind"])(cell, seed, device, overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from foundationstereo_torch.ops import kernels

        with parts("kernels"):
            kernels.build_all()
    kind.setup(parts)
    setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{n} {s:.3f} s" for n, s in parts.seconds.items())
        + f"; setup_s {setup_s:.3f}")

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
    record = {"kind": cell["mix"]["kind"], "setup_s": setup_s, "shape": kind.shape(),
              "config": (cell["configuration"]["body"].get("model")), "cell": name}
    half = seconds / 2 if trace else seconds
    record["window"] = window(kind, half, 0)
    if cuda:
        calls = record["window"]["calls"]
        log("kernel launches per call: " + ", ".join(
            f"{k} {v / calls:g}" for k, v in kernels.LAUNCHES.items() if v))
    breakdown = None
    if trace:
        from portbench import timers
        from portbench.trace import profile

        model = kind.hooked_module()
        mt = split = None
        with contextlib.ExitStack() as stack:
            if cuda:        # CUDA events: the card's clock
                mt = stack.enter_context(timers.ModuleTimes(model, forward_only=model.training))
                if model.training:
                    split = stack.enter_context(timers.StepSplit(model))
            hooked = window(kind, seconds - half, record["window"]["next"])
        if cuda:
            torch.cuda.synchronize()
        record["hooked"] = dict(hooked, module_ms=mt.ms() if mt else {},
                                backward_ms=split.backward_ms() if split else [])
        if cuda:
            n = TRACED_CALLS[record["kind"]]
            start = hooked["next"]
            counter = iter(range(start, start + n))
            record["trace"] = dict(profile(lambda: kind.call(next(counter)), n), calls=n,
                                   items=n * kind.items_per_call())
            breakdown = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
        record["flops_per_item"] = kind.flops_per_item()
    if cuda:
        torch.cuda.synchronize()
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    else:
        record["memory_peak_bytes"] = 0
    kind.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    numbers, diag = kind.check(log)
    log(f"reference check: {time.perf_counter() - t:.2f} s"
        + (f", peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB" if cuda else "")
        + f", {diag}; numbers " + ", ".join(f"{n} {v:.6g}" for n, v in numbers.items()))
    correct, checks = compare.judge(numbers, cell["details"]["checks"])

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")
    metrics = {}
    for m in spec.metrics(name, trace, bench):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    if trace and "trace" in record:
        dev["busy_s"], dev["window_s"] = record["trace"]["busy_s"], record["trace"]["window_s"]
    attempted = record["window"]["calls"] + record.get("hooked", {}).get("calls", 0)
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    parts = Parts()
    with parts("import"):
        import torch

        import foundationstereo_torch  # noqa: F401
        from portbench import spec

    chips = next(w["chips"] for w in spec.benchmark()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    with parts("cuda context"):
        torch.cuda.init()
        torch.zeros(1, device="cuda").sum().item()
    log(f"card: {card_info()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), parts=parts, t0=T0)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
