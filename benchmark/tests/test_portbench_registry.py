"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric found by its name; a
throwaway cell added as new files only is found and loaded."""

import json
import os
import re

import pytest

import portbench_toy
from benchmark import harness

ROOT = portbench_toy.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in
                                       bench["workloads"]}
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["workloads", "configs"])
def test_each_entry_names_files_that_exist(bench, kind):
    for entry in bench[kind]:
        if kind == "configs":
            path = os.path.join(ROOT, entry["file"])
            assert entry["file"].startswith("benchmark/")
            with open(path) as f:
                cfg = json.load(f)
            assert cfg["name"] == entry["name"]
            assert cfg["source"] == entry["source"]
            assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
            assert os.path.isfile(os.path.join(
                ROOT, "benchmark", "paths", f"{cfg['path']}.py"))
        else:
            cell, config, traffic, _ = harness.load_cell(entry["name"], ROOT)
            assert cell["chips"] == 1
            assert traffic["batch"] >= 1 and traffic["check_frames"] >= 1
            assert harness.load_path(config).Cell is not None


def test_every_metric_has_a_reader(bench):
    for cell in bench["workloads"]:
        readers = harness.metric_readers(bench, cell["name"])
        assert readers, cell["name"]
        assert all(callable(read) for read, _ in readers.values())


def test_a_throwaway_cell_is_new_files_only(tmp_path):
    root = portbench_toy.make_root(tmp_path, "switch-ctb32")
    cell, config, traffic, bench = harness.load_cell("toy", root)
    assert config["name"] == "switch-ctb32"
    assert (traffic["height"], traffic["width"]) == (64, 96)
    assert harness.load_path(config).__name__.endswith("wavefront2_stream")
    assert set(harness.metric_readers(bench, "toy")) == {
        m["name"] for m in bench["per_layer"]}
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell", root)


def test_readers_report_nothing_where_nothing_was_read():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    empty = {"spans": {}, "counters": {"frames": 16}, "least_s": {},
             "trace": None}
    for cell in bench["workloads"]:
        for name, (read, _) in harness.metric_readers(
                bench, cell["name"]).items():
            assert read(empty) is None, name
