"""Finds what ``BENCHMARK.json`` names, by name, as files under ``portbench/``:

- a cell's details (what it compares and at which limits): ``workloads/<cell>.json``
- a configuration: the ``file`` its entry names
- a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names its kind
- a kind of traffic: ``kinds/<kind>.py`` (a Python name), with ``Kind``, the
  class that sets a cell of the kind up, calls it and checks it, its
  ``control`` and ``traced_calls``, the calls ``--trace 1`` profiles
- a metric's reader: ``metrics/<metric>.py``, whose ``read(record)`` returns
  the metric's value or None where the run has nothing to read.

A later cell, configuration, mix, kind or metric is new files and new
entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's ``workloads`` entry with its ``details``, its
    ``configuration`` (the entry with its file's content under ``body``) and
    its ``mix`` (the traffic file)."""
    bench = bench or benchmark()
    c = dict(_entry(bench["workloads"], name, "cell"))
    conf = dict(_entry(bench["configs"], c["config"], "configuration"))
    conf["body"] = load_json(ROOT / conf["file"])
    c["configuration"] = conf
    c["mix"] = load_json(HERE / "traffic" / f"{c['traffic']}.json")
    c["details"] = load_json(HERE / "workloads" / f"{name}.json")
    return c


def metrics(cell_name: str, trace: bool, bench: dict | None = None) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced; each where its ``workloads`` list names the
    cell, or everywhere without one."""
    bench = bench or benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """``read(record)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind(name: str):
    """The module ``kinds/<name>.py`` of a traffic kind."""
    if not name.isidentifier():
        raise ValueError(f"a kind is named as a Python module, not {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}")
