"""BENCHMARK.json against the format's rules for names, units and shapes; every file it names is there."""

import json
import os
import re

import pytest

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(line_ok(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(tiny.REPO, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(tiny.REPO, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(tiny.REPO, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(tiny.BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(tiny.BENCH, "limits", f"{w['name']}.json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(tiny.BENCH, "metrics", f"{m['name']}.py"))
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells and ("workloads" not in moved or cell in moved["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer metric
        mine = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
