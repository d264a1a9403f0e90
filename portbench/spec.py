"""What BENCHMARK.json and the files beside it say about a cell.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by name:

- a configuration: the `file` that BENCHMARK.json's `configs` entry names
  (portbench/configs/<name>.json);
- a traffic mix: portbench/mixes/<traffic>.json;
- a cell's limits on the numbers that decide `correct`:
  portbench/limits/<cell>.json;
- a metric, end-to-end or per-layer: portbench/metrics/<name>.py, whose
  `read(run)` takes the run's record (portbench/run.py) and returns a
  number, or None where the run holds nothing to read.

A cell reports an end-to-end metric where the metric has no `workloads`
key or lists the cell, and a per-layer metric likewise.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, here: str = HERE) -> dict:
    """The cell `name`: its BENCHMARK.json entry, its configuration and mix
    (parsed), and the end-to-end and per-layer metric entries it reports."""
    bench = bench or benchmark(os.path.dirname(here))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(os.path.dirname(here), conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(here, "mixes", f"{entry['traffic']}.json")) as f:
        mix = json.load(f)
    return dict(
        entry=entry, config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def limits(name: str, here: str = HERE) -> dict:
    """The limit of each number the cell's comparison reads
    (portbench/limits/<cell>.json), set from the readings in PERF.md."""
    with open(os.path.join(here, "limits", f"{name}.json")) as f:
        return json.load(f)


def reader(name: str, here: str = HERE):
    """The `read` function of portbench/metrics/<name>.py."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
