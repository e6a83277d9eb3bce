"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by it."""

from __future__ import annotations

import json
import re

import pytest

import bench_small as bs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bm():
    return bs.manifest().data


def test_top_level_keys_and_limits(bm):
    assert set(bm) == TOP_KEYS
    assert len((bs.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bm["run_seconds"] <= 51 and isinstance(bm["run_seconds"], int)
    assert 1 <= len(bm["paths"]) <= 16
    for p in bm["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p) and ".." not in p
        assert (bs.ROOT / p).is_dir()
    assert 1 <= len(bm["command"]) <= 32
    for w in bm["command"]:
        assert not w.startswith("/") and ".." not in w and "\n" not in w
    # the full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (bm["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_one_line_texts(bm):
    entries = (bm["configs"] + bm["workloads"] + bm["end_to_end"]
               + bm["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bm[kind]]
        assert len(names) == len(set(names)), kind
    metric_names = [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    texts = ([c["why"] for c in bm["configs"] + bm["workloads"]]
             + [c["source"] for c in bm["configs"]]
             + [m["layer"] for m in bm["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_entry_keys(bm):
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    pairs = [(w["config"], w["traffic"]) for w in bm["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bm["workloads"])
    assert four <= max(1, len(bm["workloads"]) // 4)


def test_every_cell_reports_what_its_metrics_need(bm):
    m = bs.manifest()
    cells = {w["name"] for w in bm["workloads"]}
    e2e = {e["name"]: e for e in bm["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        reported = {x["name"] for x in m.metrics_for(cell, False)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert m.metrics_for(cell, True), cell
    for pl in bm["per_layer"]:
        assert pl["moves"] in e2e
        for cell in pl["workloads"]:
            assert cell in cells
            ok = e2e[pl["moves"]].get("workloads", cells)
            assert cell in ok, (pl["name"], cell)
    # a kernel roofline is a share, and a model's step has an mfu beside
    # every roofline that moves an end-to-end metric, in the same cells
    for pl in bm["per_layer"]:
        if pl["name"].split(".")[0].endswith("_roofline"):
            assert pl["unit"] == "%"
            mfus = [x for x in bm["per_layer"]
                    if "mfu" in x["name"] and x["moves"] == pl["moves"]]
            covered = {c for x in mfus for c in x["workloads"]}
            assert set(pl["workloads"]) <= covered, pl["name"]


def test_every_name_has_its_file(bm):
    m = bs.manifest()
    files = {c["name"]: c["file"] for c in bm["configs"]}
    used = {w["config"] for w in bm["workloads"]}
    assert used == set(files)
    for name, f in files.items():
        assert any(f.startswith(p + "/") for p in bm["paths"])
        cfg = json.loads((bs.ROOT / f).read_text())
        assert cfg["name"] == name and cfg["reduced"] == next(
            c["reduced"] for c in bm["configs"] if c["name"] == name)
        m.system(cfg["system"])
        assert (bs.BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    for w in bm["workloads"]:
        mix = m.mix(w["traffic"])
        m.generator(mix["kind"])
        assert m.limits(w["name"])["checks"]
    for metric in bm["end_to_end"] + bm["per_layer"]:
        assert callable(m.reader(metric["name"]).read)
