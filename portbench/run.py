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

The cell's traffic kind (``kinds/<kind>.py``, named by its mix) sets it up,
calls it and checks it. A cell of N > 1 chips runs in N processes, one per
card (``ranks.py``): every rank sets up, then the ranks make the same
calls, rank 0 deciding before each whether the window is still open; every
rank hooks and profiles the same calls alike, so that each carries their
cost; each rank checks its own part, and rank 0 reports: the items of every
rank's calls, the set-up up to the slowest rank's end of warm-up, the
largest peak, each checked number's largest over the ranks, and each
rank's traced readings beside its own (``over_ranks``).

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
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "foundationstereo_tpu"}


def log(msg: str) -> None:
    """A line on standard output; a rank other than 0 writes to standard
    error, so that the last line of standard output stays the result."""
    dist = sys.modules.get("torch.distributed")
    r = dist.get_rank() if dist is not None and dist.is_initialized() else 0
    if r:
        print(f"[portbench rank {r}] {msg}", file=sys.stderr, flush=True)
    else:
        print(f"[portbench] {msg}", flush=True)


class Parts:
    """Wall seconds of the set-up's parts, in order."""

    def __init__(self, seconds: dict[str, float] | None = None):
        self.seconds: dict[str, float] = dict(seconds or {})

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


def window(kind, seconds: float, start: int, device="cpu") -> dict:
    """Closed-loop calls from index ``start`` until ``seconds`` have passed
    on rank 0's clock (the last call started before that finishes and
    counts); on N ranks rank 0 tells the others before each call."""
    from portbench import ranks

    lat, items, i = [], 0, start
    t0 = t = time.perf_counter()
    while ranks.lead(t - t0 < seconds, device):
        a = time.perf_counter()
        items += kind.call(i)
        t = time.perf_counter()
        lat.append(t - a)
        i += 1
    return {"seconds": t - t0, "items": items, "calls": len(lat), "latencies_s": lat, "next": i}


def over_ranks(trace: dict, backward_ms: list[float]) -> dict:
    """The traced readings of a run on N ranks, each of which hooked and
    profiled the same calls: this rank's reduction with every rank's
    readings beside it (``by_rank``, in rank order: busy and window seconds,
    device time by name, the hooked half's backward ms per step), and
    ``busy_s`` the mean over the ranks' cards. Rank 0 logs them side by side."""
    from portbench import ranks
    from portbench.trace import collectives_s

    rows = ranks.gather({"busy_s": trace["busy_s"], "window_s": trace["window_s"],
                         "device_time_by_name": trace["device_time_by_name"],
                         "backward_ms": backward_ms})
    if ranks.rank() == 0:
        log("by rank: busy s / window s / collectives ms per call / backward ms per step "
            "(median, max): " + "; ".join(
                f"{r}: {row['busy_s']:.4f} / {row['window_s']:.4f} / "
                f"{1e3 * collectives_s(row['device_time_by_name']) / trace['calls']:.3f} / "
                + (f"{statistics.median(row['backward_ms']):.1f}, {max(row['backward_ms']):.1f}"
                   if row["backward_ms"] else "-")
                for r, row in enumerate(rows)))
    return dict(trace, by_rank=rows, busy_s=sum(row["busy_s"] for row in rows) / len(rows))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, parts: Parts | None = None,
             t0: float | None = None, bench: dict | None = None) -> dict:
    """One run of the cell; returns the result object (not yet printed).
    ``t0`` is when the set-up began (the process's start when run as a
    command); ``overrides`` shrinks the cell and ``bench`` stands for
    ``BENCHMARK.json`` in tests on the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from portbench import compare, ranks, spec

    parts = parts or Parts()
    bench = bench or spec.benchmark()
    cell = spec.cell(name, bench)
    kinds = spec.kind(cell["mix"]["kind"])
    kind = kinds.Kind(cell, seed, device, overrides)
    world, lead = ranks.world(), ranks.rank() == 0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from foundationstereo_torch.ops import kernels

        with parts("kernels"):
            kernels.build_all()
    kind.setup(parts)
    ranks.barrier(device)
    setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{n} {s:.3f} s" for n, s in parts.seconds.items())
        + f"; setup_s {setup_s:.3f}" + (f" (the slowest of {world} ranks)" if world > 1 else ""))

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
    record = {"kind": cell["mix"]["kind"], "setup_s": setup_s, "shape": kind.shape(),
              "config": (cell["configuration"]["body"].get("model")), "cell": name,
              "chips": world}
    half = seconds / 2 if trace else seconds
    record["window"] = window(kind, half, 0, device)
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
            hooked = window(kind, seconds - half, record["window"]["next"], device)
        if cuda:
            torch.cuda.synchronize()
        record["hooked"] = dict(hooked, module_ms=mt.ms() if mt else {},
                                backward_ms=split.backward_ms() if split else [])
        if cuda:
            n = kinds.traced_calls
            start = hooked["next"]
            counter = iter(range(start, start + n))
            record["trace"] = dict(profile(lambda: kind.call(next(counter)), n), calls=n,
                                   items=n * kind.items_per_call())
            if world > 1:
                record["trace"] = over_ranks(record["trace"], record["hooked"]["backward_ms"])
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
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")
    rows = ranks.gather({"numbers": numbers, "peak": record["memory_peak_bytes"]})
    if world > 1:
        numbers = ranks.largest([row["numbers"] for row in rows])
        record["memory_peak_bytes"] = max(row["peak"] for row in rows)
        if lead:
            log("the largest over the ranks: "
                + ", ".join(f"{n} {v:.6g}" for n, v in numbers.items()))
    correct, checks = compare.judge(numbers, cell["details"]["checks"])
    metrics = {}
    for m in spec.metrics(name, trace, bench):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": world, "memory_peak_bytes": record["memory_peak_bytes"]}
    if trace and "trace" in record:
        dev["busy_s"], dev["window_s"] = record["trace"]["busy_s"], record["trace"]["window_s"]
    attempted = record["window"]["calls"] + record.get("hooked", {}).get("calls", 0)
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def on_rank(device, name: str, seed: int, seconds: float, trace: bool, parts: dict,
            t0: float, spawned: float, overrides: dict | None = None,
            bench: dict | None = None) -> dict:
    """One rank's run of a cell of N chips (``ranks.spawn`` calls it in each
    rank's process, with the parent's set-up parts so far, its start ``t0``
    and when it started the ranks); rank 0's result is the run's."""
    import torch

    from portbench import ranks

    parts = Parts(dict(parts, **{"ranks start": time.perf_counter() - spawned}))
    with parts("rank import"):
        import foundationstereo_torch  # noqa: F401
    if device.type == "cuda":
        with parts("cuda context"):
            torch.zeros(1, device=device).sum().item()
        if ranks.rank() == 0:
            log(f"cards: {card_info()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return run_cell(name, seed, seconds, trace, device=device, overrides=overrides, parts=parts,
                    t0=t0, bench=bench)


def run_ranks(name: str, seed: int, seconds: float, trace: bool, chips: int, device: str = "cuda",
              overrides: dict | None = None, parts: Parts | None = None, t0: float | None = None,
              bench: dict | None = None, prepare=None) -> dict:
    """One run of the cell on ``chips`` ranks, one process each; returns rank
    0's result. ``prepare()`` runs in each rank's process first (tests plant
    faults with it)."""
    from portbench import ranks
    from portbench.run import on_rank      # by the module's name, for the ranks to find

    t0 = time.perf_counter() if t0 is None else t0
    seconds_so_far = (parts or Parts()).seconds
    return ranks.spawn(on_rank, chips, device, prepare=prepare, args=(
        name, seed, seconds, trace, seconds_so_far, t0, time.perf_counter(), overrides, bench))


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
    if chips > 1:
        from foundationstereo_torch.ops import kernels

        with parts("build"):        # once, before the ranks start
            kernels.build_all()
        result = run_ranks(args.workload, args.seed, args.seconds, bool(args.trace), chips,
                           parts=parts, t0=T0)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"forbidden modules loaded in the run: {found}")
    else:
        with parts("cuda context"):
            torch.cuda.init()
            torch.zeros(1, device="cuda").sum().item()
        log(f"card: {card_info()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), parts=parts,
                          t0=T0)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
