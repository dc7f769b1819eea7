"""Cells of N chips on the CPU: a tiny data-parallel training cell run on 2
ranks over ``gloo`` (one process each), its result line, the data-parallel
reference against the one-process reference on the global batch, and a run
driven with the timed path broken underneath in each rank's process,
failing a named check: batch statistics taken per rank, gradients left
unaveraged, every rank on rank 0's rows.

    python3 -m pytest portbench/tests -p no:cacheprovider -o addopts="" -q
"""

from __future__ import annotations

import json
import math

import pytest
import torch

from portbench import ranks, run, spec
from portbench.kinds import train_batches

CELL = "train-vitl-dp4"
# The four-chip cell's entries, as BENCHMARK.json would take them: its
# details and mix are files under portbench/, its entries wait for its runs
# on four cards (PERF.md).
DP4 = {"name": CELL, "config": "fs-vitl-train-v1", "traffic": "train-320x736-b16-dp4",
       "chips": 4, "why": "the stereo_v1 step data-parallel on 4 H100s: the recipe's 4 crops of "
                          "320x736 per card on 4 ranks, a global 16; batch-norm and gradient "
                          "all-reduces among 4 host-bound ranks"}
COMM = {"name": "comm_ms.train", "unit": "ms/step", "better": "lower", "source": "device_trace",
        "layer": "collectives", "moves": "train_samples_per_s", "workloads": [CELL]}


def bench() -> dict:
    b = spec.benchmark()
    b["workloads"].append(DP4)
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("train_samples_per_s", "step_ms.backward", "mfu.train",
                         "idle_share.train"):
            m["workloads"].append(CELL)
    b["per_layer"].append(COMM)
    return b


BENCH = bench()
TINY_MODEL = {"vit_size": "vits", "max_disp": 64, "mixed_precision": False}
TRAIN = {"model": dict(TINY_MODEL, train_iters=2),
         "mix": {"crop_wh": [96, 64], "max_disparity": 64, "pool": 3, "batch": 4}}
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(prepare=None, trace=False):
    return run.run_ranks(CELL, 2 ** 31 + 7, 1.0, trace, chips=2, device="cpu", overrides=TRAIN,
                         bench=BENCH, prepare=prepare)


def _failed(result) -> set[str]:
    return {n for n, c in result["checks"].items() if not c["value"] <= c["limit"]}


def test_two_ranks_print_one_correct_result_line():
    result = _run()
    assert set(result) == CONTRACT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 2
    assert set(result["checks"]) == set(spec.cell(CELL, BENCH)["details"]["checks"])
    assert result["checks"]["replica_gap"]["value"] == 0.0
    names = {m["name"] for m in spec.metrics(CELL, False, BENCH)} - {"peak_gib"}     # no card: no peak
    assert set(result["metrics"]) == names
    assert all(math.isfinite(m["value"]) for m in result["metrics"].values())
    json.loads(json.dumps(result))


def _traced(device):
    """A rank's profiled readings as the reduction gives them: rank r's NCCL
    kernels take (r + 1) times rank 0's, its card is busy 1 + r seconds."""
    r = ranks.rank()
    trace = {"calls": 2, "busy_s": 1.0 + r, "window_s": 4.0, "device_ops": [], "idle_gaps": [],
             "device_time_by_name": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.002 * (r + 1),
                                     "nccl:all_reduce": 0.5, "flash_fwd_kernel": 1.0}}
    return run.over_ranks(trace, [100.0 + r])


def test_every_rank_is_traced_and_the_collectives_read_the_longest():
    """Each rank's traced readings reach rank 0's record; the device's busy
    time is the mean over the cards, and ``comm_ms.train`` the rank whose
    collectives took longest (the one that waited on the others)."""
    trace = ranks.spawn(_traced, 2, "cpu")
    assert [row["backward_ms"] for row in trace["by_rank"]] == [[100.0], [101.0]]
    assert trace["busy_s"] == pytest.approx(1.5)
    read = spec.reader("comm_ms.train")
    assert read({"kind": "train_batches", "trace": trace}) == pytest.approx(2.0)


# -- the data-parallel reference ------------------------------------------------------


def _reference_steps(device, pool_seed):
    """The reference's steps on this rank: losses and per-leaf gradient norms."""
    kind = train_batches.Training(spec.cell(CELL, BENCH), pool_seed, device, TRAIN)
    out = train_batches.reference_steps(kind.recipe, kind._global_pool(), device,
                                        kind.weights_seed)
    return {"loss": out["loss"], "replica_gap": out.get("replica_gap"),
            "grad": {n: float(g.double().norm()) for n, g in out["grad"].items()}}


def test_data_parallel_reference_is_the_one_process_step_on_the_global_batch():
    """Two ranks of 2 rows each step as one process on the 4 rows: the same
    first loss, and the same first gradient leaf by leaf, summation order
    aside (over the leaves the checks hold: a bias before a batch norm has
    a gradient of rounding alone). The second loss is not compared: AdamW's
    first step moves each weight by about its learning rate whatever the
    size of its gradient, so rounding moves it, and train mode's batch
    statistics amplify that (PERF.md)."""
    two = ranks.spawn(_reference_steps, 2, "cpu", args=(11,))
    one = _reference_steps(torch.device("cpu"), 11)
    assert two["replica_gap"] == 0.0
    assert abs(two["loss"][0] - one["loss"][0]) <= 1e-5 * abs(one["loss"][0])
    med = sorted(one["grad"].values())[len(one["grad"]) // 2]
    gaps = sorted(abs(two["grad"][n] - v) / max(v, med) for n, v in one["grad"].items()
                  if v >= 1e-3 * med)
    assert gaps[len(gaps) // 2] < 1e-2, gaps


# -- faults of the timed path, planted in each rank's process ----------------------


def per_rank_statistics():
    """Batch norm on the rank's own rows only."""
    from foundationstereo_torch.models import layers

    orig = layers.BatchNorm.forward

    def forward(self, x):
        saved, layers._GLOBAL_GROUP[0] = layers._GLOBAL_GROUP[0], None
        try:
            return orig(self, x)
        finally:
            layers._GLOBAL_GROUP[0] = saved

    layers.BatchNorm.forward = forward


def unaveraged_gradients():
    """Each rank updates from its own gradient."""
    from foundationstereo_torch.train.trainer import Trainer

    Trainer._average_over_ranks = lambda self, state, loss, metrics: (loss, metrics)


def rank_zero_rows():
    """Every rank takes rank 0's rows of the global batch."""
    from foundationstereo_torch.parallel import distributed

    def rows(batch, mesh=None):
        n = distributed.world_size()
        return {k: v if k == "rng" else v[:v.shape[0] // n] for k, v in batch.items()}

    distributed.local_slice = rows


@pytest.mark.parametrize("fault, number", [
    (per_rank_statistics, "filter_block_rel"),
    (unaveraged_gradients, "replica_gap"),
    (rank_zero_rows, "volume_rel")])
def test_a_broken_data_parallel_step_fails(fault, number):
    result = _run(prepare=fault)
    assert result["correct"] is False and number in _failed(result), result["checks"]
