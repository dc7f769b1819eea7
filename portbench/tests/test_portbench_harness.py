"""The harness on the CPU: cells, configurations, mixes and metrics found by
name as data, the result line's keys, the yardstick's counts, the trace
reduction, and what the benchmark imports.

    python3 -m pytest portbench/tests -p no:cacheprovider -o addopts="" -q
"""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import counting, spec, trace

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TINY_MODEL = {"vit_size": "vits", "max_disp": 64, "mixed_precision": False}
TINY = {
    "pairs": {"model": TINY_MODEL, "iters": 2, "mix": {"height": 64, "width": 96, "pool": 3}},
    "train_batches": {"model": dict(TINY_MODEL, train_iters=2),
                      "mix": {"crop_wh": [96, 64], "max_disparity": 64, "pool": 3,
                                              "batch": 2}},
}
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
FORBIDDEN = {"jax", "jaxlib", "flax", "foundationstereo_tpu"}


def tiny(cell_name: str) -> dict:
    return TINY[spec.cell(cell_name)["mix"]["kind"]]


# -- found by name, as data -------------------------------------------------------


def test_every_name_in_benchmark_json_has_its_files():
    bench = spec.benchmark()
    for cell in bench["workloads"]:
        c = spec.cell(cell["name"], bench)
        kind = spec.kind(c["mix"]["kind"])
        assert callable(kind.Kind) and callable(kind.control) and kind.traced_calls >= 1
        assert kind.FAULTS
        assert set(c["details"]["checks"]), cell["name"]
        reported = spec.metrics(cell["name"], False, bench)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2 and spec.metrics(cell["name"], True, bench)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for conf in bench["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith("portbench/")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    bench = spec.benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """A cell with its own mix of a kind of its own, details and a per-layer
    metric of its own, added to a copy of the benchmark as files and
    entries, runs without an edit to any file already there."""
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench["workloads"].append({"name": "pair-new", "config": "fs-vitl", "traffic": "pairs-new",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "the whole pair",
                               "moves": "pairs_per_s", "workloads": ["pair-new"]})
    bench["end_to_end"][0]["workloads"].append("pair-new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/traffic/pairs-new.json").write_text(json.dumps(
        {"kind": "pairs_counted_twice", "batch": 2, "height": 64, "width": 96, "pool": 2}))
    (tmp_path / "portbench/kinds/pairs_counted_twice.py").write_text(
        "from portbench.kinds.pairs import FAULTS, Pairs, control  # noqa: F401\n"
        "traced_calls = 1\n"
        "class Kind(Pairs):\n"
        "    def call(self, i, probe=False):\n"
        "        return 2 * super().call(i, probe)\n")
    (tmp_path / "portbench/workloads/pair-new.json").write_text(json.dumps(
        {"sample": 1, "checks": {"disp_mae_px": 1.0, "logits_rel": 1.0}}))
    (tmp_path / "portbench/metrics/calls_in_window.py").write_text(
        "def read(rec):\n    return float(rec['window']['calls'])\n")
    bench["per_layer"].append({"name": "items_per_call", "unit": "pairs", "better": "higher",
                               "source": "host_clock", "layer": "the whole pair",
                               "moves": "pairs_per_s", "workloads": ["pair-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/metrics/items_per_call.py").write_text(
        "def read(rec):\n    return rec['window']['items'] / rec['window']['calls']\n")
    code = ("import json; from portbench import run; r = run.run_cell('pair-new', 7, 1.0, True, "
            f"device='cpu', overrides={{'model': {TINY_MODEL!r}, 'iters': 1}}); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["calls_in_window"]["value"] >= 1
    assert result["metrics"]["items_per_call"]["value"] == 4      # the new kind's count
    assert result["correct"] is True
    after = {p: p.read_bytes() for p in before}
    assert after == before


# -- the result line ------------------------------------------------------------


@pytest.mark.parametrize("cell", ["pair-vitl-b1", "train-vitl-b4"])
def test_result_line_has_the_contract_keys(cell):
    from portbench import run

    bench = spec.benchmark()
    result = run.run_cell(cell, 2 ** 31 + 99, 0.1, False, device="cpu", overrides=tiny(cell),
                          bench=bench)
    assert set(result) == CONTRACT_KEYS
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    names = {m["name"] for m in spec.metrics(cell, False, bench)} - {"peak_gib"}   # no card: no peak
    assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(result["checks"]) == set(spec.cell(cell, bench)["details"]["checks"])
    json.dumps(result)


def test_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "pair-vitl-b1",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[-1].startswith("{")


def test_run_outside_a_checkout_of_the_program_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "pair-vitl-b1",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "{" not in out.stdout


# -- the yardstick's arithmetic -------------------------------------------------------


def test_attention_count_at_the_served_shape():
    n = counting.vit_tokens(736, 1280)
    assert n == 5377
    assert counting.attention_flops(2, 16, n, 64) == pytest.approx(2.368e11, rel=1e-3)
    assert counting.attention_bound_s(2, 16, n, 64) * 1e3 == pytest.approx(0.2395, rel=1e-3)
    # bytes: q, k, v and the output, bf16, once each
    assert counting.attention_bytes(2, 16, n, 64) == 4 * 2 * n * 1024 * 2


def test_k4_eligible_conv_flops_per_pair():
    cfg = json.loads((HERE / "configs/fs-vitl.json").read_text())["model"]
    assert counting.k4_conv_flops(cfg, 736, 1280, 32) / 1e12 == pytest.approx(33.58, abs=0.01)


def test_model_flops_count_the_matrix_work():
    cfg = dict(json.loads((HERE / "configs/fs-vitl.json").read_text())["model"], **TINY_MODEL)
    f1 = counting.forward_flops(cfg, 64, 96, 1, 1)
    f2 = counting.forward_flops(cfg, 64, 96, 2, 1)
    assert f2 > f1 > 0                              # each refinement step adds its convs
    # per pair at batch 2, less the work on weights alone (the position table)
    assert counting.forward_flops(cfg, 64, 96, 1, 2) == pytest.approx(2 * f1, rel=1e-3)


def test_shares_cannot_pass_100_by_construction():
    """A roofline share counts each call once, whatever the launches; no
    match reads nothing, never 0."""
    read = spec.reader("roofline.k3")
    rec = {"kind": "pairs", "config": {"vit_size": "vitl"},
           "shape": {"batch": 1, "height": 736, "width": 1280},
           "trace": {"calls": 1, "device_time_by_name": {"flash_fwd_kernel": 48 * 0.2395e-3},
                     "launches_by_name": {"flash_fwd_kernel": 48}}}
    assert read(rec) == pytest.approx(50.0, rel=1e-3)
    rec["trace"]["device_time_by_name"] = {"other": 1.0}
    assert read(rec) is None
    for name in ("mfu.serve", "mfu.train", "idle_share.serve", "module_ms.update_block",
                 "step_ms.backward", "comm_ms.train"):
        assert spec.reader(name)({"kind": "none", "window": {}}) is None


def test_mfu_divides_by_the_cells_chips():
    read = spec.reader("mfu.train")
    rec = {"kind": "train_batches", "flops_per_item": counting.PEAK_BF16_FLOPS / 100,
           "window": {"items": 8, "seconds": 2.0}}
    assert read(rec) == pytest.approx(4.0)
    assert read(dict(rec, chips=4)) == pytest.approx(1.0)


def test_collectives_read_the_nccl_kernels_per_step():
    read = spec.reader("comm_ms.train")
    times = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 0.003,
             "ncclKernel_Broadcast_RING_LL_Sum_int8_t(ncclDevComm*, unsigned long, ncclWork*)": 0.001,
             "nccl:all_reduce": 0.5, "flash_fwd_kernel": 1.0}
    rec = {"kind": "train_batches", "trace": {"calls": 2, "device_time_by_name": times}}
    assert read(rec) == pytest.approx(2.0)
    rec["trace"]["device_time_by_name"] = {"nccl:all_reduce": 0.5, "flash_fwd_kernel": 1.0}
    assert read(rec) is None


def test_run_names_no_kind():
    text = (HERE / "run.py").read_text()
    for name in ("pairs", "train_batches"):
        assert f'"{name}"' not in text and f"'{name}'" not in text


# -- the trace reduction --------------------------------------------------------


def test_busy_is_the_union_of_device_intervals_and_gaps_are_labelled():
    device = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k3", 5.0, 6.0)]
    host = [("aten::conv2d", 2.5, 5.5), ("cudaLaunchKernel", 3.0, 4.0)]
    r = trace.reduce(device, host, 0.0, 10.0)
    assert r["busy_s"] == pytest.approx(4.0)
    assert r["window_s"] == pytest.approx(10.0)
    assert r["idle_gaps"][0] == ["(no host operation: Python between calls)", 4.0]
    assert r["idle_gaps"][1] == ["aten::conv2d", 2.0]
    assert r["device_ops"][0][0] in ("k1", "k2")


# -- imports ---------------------------------------------------------------------


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "foundationstereo_torch" not in _imported_tops(path), path
    code = ("import sys, portbench.reference.model, portbench.reference.train, portbench.counting; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "foundationstereo_torch" not in tops and not tops & FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import sys, json; from portbench import run; "
            f"r = run.run_cell('pair-vitl-b1', 5, 0.1, False, device='cpu', overrides={TINY['pairs']!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN


def test_nothing_reads_the_jax_packages_records():
    for path in HERE.rglob("*.py"):
        text = path.read_text()
        for name in ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE.json", "bench_logs"):
            assert name not in text or path.name == Path(__file__).name, (path, name)
