"""The benchmark is driven by its data files: every cell resolves to its
configuration, mix, limits and metric readers by name, and a new
configuration, mix or metric is found as new files plus new entries."""

import json
import os
import shutil

import pytest

from portbench import spec


def test_every_cell_resolves():
    bench = spec.benchmark()
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert cell["mix"]["kind"] in ("render", "frame")
        assert set(spec.limits(w["name"])) == (
            {"pixel_wrong_pct"} if cell["mix"]["kind"] == "frame" else {"count_wrong_pct", "sum_wrong_pct"})
        names = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.reader(m["name"]))


def test_per_layer_metrics_report_what_they_move():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_config_files_hold_source_and_cuts():
    bench = spec.benchmark()
    for c in bench["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            config = json.load(f)
        assert 0 < len(config["source"]) <= 200
        assert config["reduced"] == c["reduced"] == []
        assert config["assumed"]


def test_new_files_alone_add_a_cell(tmp_path):
    here = tmp_path / "portbench"
    for sub in ("configs", "mixes", "metrics", "limits"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    bench = spec.benchmark()
    # a configuration, a mix, a limits file and a metric, each a new file
    with open(here / "configs" / "house_far.json", "w") as f:
        json.dump(dict(spec.cell("house.render", bench)["config"], name="house_far"), f)
    with open(here / "mixes" / "render_small.json", "w") as f:
        json.dump(dict(spec.cell("house.render", bench)["mix"], width=512, height=512), f)
    with open(here / "limits" / "house_far.render_small.json", "w") as f:
        json.dump({"count_wrong_pct": 1.0, "sum_wrong_pct": 1.0}, f)
    with open(here / "metrics" / "calls_per_s.py", "w") as f:
        f.write("def read(run):\n    return len(run['calls']) / (run['window'][1] - run['window'][0])\n")
    bench["configs"].append(dict(name="house_far", source="x", file="portbench/configs/house_far.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="house_far.render_small", config="house_far", traffic="render_small",
                                   chips=1, why="x"))
    bench["per_layer"].append(dict(name="calls_per_s", unit="calls/s", better="higher", source="host_clock",
                                   layer="entry and renderer", moves="msamples_per_s",
                                   workloads=["house_far.render_small"]))
    bench["end_to_end"][0]["workloads"].append("house_far.render_small")
    cell = spec.cell("house_far.render_small", bench, here=str(here))
    assert cell["mix"]["width"] == 512 and cell["config"]["name"] == "house_far"
    assert [m["name"] for m in cell["per_layer"] if m["name"] == "calls_per_s"] == ["calls_per_s"]
    assert spec.limits("house_far.render_small", here=str(here))["count_wrong_pct"] == 1.0
    assert spec.reader("calls_per_s", here=str(here))({"calls": [1, 2], "window": (0.0, 4.0)}) == 0.5


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
