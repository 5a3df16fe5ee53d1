"""BENCHMARK.json against the contract's shape, and finding cells,
configurations, mixes and metric readers by name."""

import json
import os
import re

import pytest

from benchmark import spec
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and key != "source" or key == "source" and e in bench["configs"]:
                text = e[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_files_and_sources(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = spec.load_config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert set(cfg["limits"]) == {"bad_rows", "start_gap", "end_gap", "end_bulk_gap"}
        assert cfg["limits"]["bad_rows"] == 0
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_mixes_and_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = bench["workloads"]
    # a cell takes 1 card, or 4 for an engine whose mesh spans them (ranks.py)
    # and for at most a quarter of the cells, rounded down, or one
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        if w["chips"] == 4:
            assert spec.load_config(w["config"])["engine"].startswith("sharded")
        mix = spec.load_mix(w["traffic"])
        assert mix["nsteps"] > mix["check_savefreq"] > 0
        e2e_here = [m["name"] for m in spec.metrics_for(bench, w["name"], False)]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert spec.metrics_for(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in spec.metrics_for(bench, cell, False)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_tree_of_the_test_finds_its_own_config_and_mix(tmp_path):
    root = tiny.make_tree(tmp_path)
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, "tiny3d.short10")
    assert spec.load_config(cell["config"], root)["sim"]["num_parts"] == 400
    assert spec.load_mix(cell["traffic"], root)["savefreq"] == 10
    with pytest.raises(KeyError):
        spec.find_cell(bench, "hw2_2d_16m.unsaved")
    with pytest.raises(FileNotFoundError):
        spec.load_config("no_such_config", root)


def test_metrics_for_follows_workloads_and_moves():
    bench = {
        "end_to_end": [{"name": "a", "unit": "s"}, {"name": "b", "unit": "s", "workloads": ["x"]}],
        "per_layer": [{"name": "pa", "moves": "a"}, {"name": "pb", "moves": "b"},
                      {"name": "pc", "moves": "a", "workloads": ["y"]}],
    }
    assert [m["name"] for m in spec.metrics_for(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", False)] == ["a"]
    assert [m["name"] for m in spec.metrics_for(bench, "x", True)] == ["pa", "pb"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", True)] == ["pa", "pc"]


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["ppsim_tpu_torch", "ppsim_tpu_torch.engines", "jaxtyping", "numpy",
            "ppsim_tpu", "ppsim_tpu.engines.grid", "jax.numpy", "jaxlib", "flax.linen"]
    assert spec.forbidden_modules(dict.fromkeys(mods)) == [
        "flax.linen", "jax.numpy", "jaxlib", "ppsim_tpu", "ppsim_tpu.engines.grid"]


def test_benchmark_json_is_json():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        json.load(f)
