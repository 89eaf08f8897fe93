"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import os
import re

import pytest

from portbench.cells import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


def test_keys_and_sizes(bench):
    spec = bench.spec
    assert set(spec) == KEYS["top"]
    assert len(json.dumps(spec)) < 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[part]:
            extra = set(e) - KEYS[part]
            assert extra <= ({"workloads"} if part in ("end_to_end",
                                                       "per_layer")
                             else set()), (part, e["name"], extra)
            assert KEYS[part] <= set(e), (part, e["name"])
    assert 1 <= spec["run_seconds"] <= 51
    assert 1 <= len(spec["configs"]) <= 24
    assert 1 <= len(spec["workloads"]) <= 24


def test_names_and_units(bench):
    spec = bench.spec
    names = [e["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in spec[part]]
    for n in names:
        assert NAME.match(n), n
    for part in ("workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in spec[part]]
        assert len(ns) == len(set(ns)), part
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in spec["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources(bench):
    spec = bench.spec
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_paths_and_command(bench):
    spec = bench.spec
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(spec["command"]) <= 32
    for word in spec["command"]:
        assert not word.startswith("/") and ".." not in word


KIND_API = ("make", "warm", "keeper", "loop", "check", "work")


@pytest.mark.parametrize("cell", ["ptm-story", "ptm-chapters"])
def test_cell_files_found_by_name(bench, cell):
    w = bench.cell(cell)
    assert w["config_file"]["name"] == w["config"]
    kind = bench.module("kinds", w["traffic_params"]["kind"])
    assert all(callable(getattr(kind, f)) for f in KIND_API)
    writer = bench.module("writers", w["config_file"]["writer"]["kind"])
    assert callable(writer.write)
    assert isinstance(w["settings"].get("env", {}), dict)
    for m in w["end_to_end"] + w["per_layer"]:
        assert callable(bench.reader(m["name"]))
    e2e = {m["name"] for m in w["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and w["per_layer"]


def test_config_files(bench):
    for c in bench.spec["configs"]:
        assert c["file"].startswith(bench.spec["paths"][0] + "/")
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        for k in c["reduced"]:
            assert k in conf
    files = [c["file"] for c in bench.spec["configs"]]
    assert len(files) == len(set(files))


def test_every_config_has_a_cell(bench):
    used = {w["config"] for w in bench.spec["workloads"]}
    assert used == set(bench.configs)


def test_per_layer_cells_report_what_they_move(bench):
    spec = bench.spec
    for m in spec["per_layer"]:
        for cell in m.get("workloads", bench.cells):
            reported = {e["name"] for e in bench.cell(cell)["end_to_end"]}
            assert m["moves"] in reported, (m["name"], cell)
    layers = {}
    for m in spec["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in bench.cells:
        assert bench.cell(cell)["per_layer"]
