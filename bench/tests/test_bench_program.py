"""The readers of what the program reports of itself (its host-phase
ranges, its counters over the traced slice, its requests' queue wait and
its set-up seconds), on the CPU cells at small sizes, and
``benchlib.program``'s split of a slice by range on hand-made traces."""

from __future__ import annotations

import importlib.util
import types

import pytest

import bench_small as bs
from benchlib import program
from benchlib.stats import union_length
from benchlib.trace import Trace
from benchlib.work import ceil_pow2

NEW = {
    "knot-kan1-bulk": ["h2d_host_ms_per_mrow.knot", "h2d_bytes_per_row.knot",
                       "pad_share.knot", "deploy_share.setup"],
    "qwen25-kanffn-rag": ["pad_share.prefill", "queue_share.ttft",
                          "deploy_share.setup"],
    "qwen25-kanffn-reason": ["attn_host_ms.decode", "ffn_host_ms.decode",
                             "sample_wait_ms.decode", "emit_ms.decode",
                             "deploy_share.setup"],
}


def idle_split_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_idle_split", bs.BENCH / "idle_split.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def run_keep(cell: str, **kw):
    """One traced small CPU run of ``cell``; returns (result, record)."""
    kept = []
    keep = idle_split_tool().keeping(type(bs.manifest()), kept)
    out = bs.run(cell, trace=True, manifest=keep(bs.ROOT), **kw)
    return out, kept[-1]


@pytest.fixture(scope="module")
def runs():
    from repro_torch.obs.metrics import SETUP_SECONDS

    out = {}
    for cell in NEW:
        SETUP_SECONDS.clear()      # one run per process, as run.py makes
        out[cell] = run_keep(cell)
    return out


@pytest.mark.parametrize("cell", sorted(NEW))
def test_new_readers_read_the_cpu_cells(runs, cell):
    out, _ = runs[cell]
    m = bs.manifest()
    names = [x["name"] for x in m.metrics_for(cell, True)]
    assert set(NEW[cell]) <= set(names)
    assert out["correct"]
    for name in NEW[cell]:
        v = out["metrics"][name]["value"]
        assert v >= 0 and v == v, (name, v)
    # the device's metrics read nothing without device operations
    source = {x["name"]: x["source"] for x in m.data["per_layer"]}
    for name in names:
        if source[name] == "device_trace":
            assert name not in out["metrics"], name


def test_pad_share_knot_equals_the_rows_sent(runs):
    out, rec = runs["knot-kan1-bulk"]
    real = sum(rec.traced_rows)
    pad = sum(ceil_pow2(n) - n for n in rec.traced_rows)
    assert real > 0
    assert out["metrics"]["pad_share.knot"]["value"] == pytest.approx(
        100.0 * pad / (real + pad), rel=1e-12)
    assert out["metrics"]["h2d_bytes_per_row.knot"]["value"] == 17 * 4


def test_pad_share_prefill_equals_the_prompts_sent(runs):
    out, rec = runs["qwen25-kanffn-rag"]
    plens = [n for step in rec.traced_steps for n in step["prefills"]]
    cap = rec.mix["max_len"] - 1
    pad = sum(ceil_pow2(n) - n for n in plens if ceil_pow2(n) <= cap)
    assert plens
    assert out["metrics"]["pad_share.prefill"]["value"] == pytest.approx(
        100.0 * pad / (sum(plens) + pad), rel=1e-12)


def test_queue_share_reads_the_tail_requests(runs):
    _, rec = runs["qwen25-kanffn-rag"]
    reqs = [s.req for s in rec.streams.values()
            if rec.first_rid <= s.rid < rec.end_rid and s.times]
    assert all(0 <= r.queue_s <= r.ttft_s for r in reqs)
    v = bs.manifest().reader("queue_share.ttft").read(rec)
    assert 0 <= v < 100


def test_decode_split_fits_inside_the_decode_steps(runs):
    out, rec = runs["qwen25-kanffn-reason"]
    t = rec.trace
    step = 1e3 * t.host_s("serve.decode_step") / rec.traced_decode_calls
    parts = (out["metrics"]["attn_host_ms.decode"]["value"]
             + out["metrics"]["ffn_host_ms.decode"]["value"])
    assert 0 < parts <= step
    assert out["metrics"]["sample_wait_ms.decode"]["value"] > 0
    assert out["metrics"]["emit_ms.decode"]["value"] > 0


def test_deploy_share_is_a_share_of_setup(runs):
    for cell in NEW:
        v = runs[cell][0]["metrics"]["deploy_share.setup"]["value"]
        assert 0 < v <= 100, (cell, v)


def test_readers_read_nothing_from_a_program_without_them(runs, monkeypatch):
    """A program with none of the ranges, counters or queue wait (the
    benchmark's older parents) gives None from every new reader."""
    from repro_torch import obs

    m = bs.manifest()
    monkeypatch.delattr(obs, "profiled_counts")
    monkeypatch.setattr(obs.REGISTRY, "snapshot", lambda: {"metrics": {}})
    for cell, names in NEW.items():
        _, rec = runs[cell]
        bare = types.SimpleNamespace(**vars(rec))
        t = rec.trace
        bare.trace = Trace(t.ops, {"serve.prefill": [(0.0, 0.1)],
                                   "serve.decode_step": [(0.1, 0.2)]},
                           {}, t.window_s)
        if hasattr(rec, "streams"):
            bare.streams = {k: types.SimpleNamespace(
                rid=s.rid, times=s.times,
                req=types.SimpleNamespace(ttft_s=s.req.ttft_s))
                for k, s in rec.streams.items()}
        for name in names:
            assert m.reader(name).read(bare) is None, name


def _trace(host, ops, window=10.0):
    return Trace([(s, e, "k", "kernel") for s, e in ops], host, {}, window)


def test_timeline_follows_the_innermost_range():
    t = _trace({"serve.round": [(1.0, 9.0)],
                "serve.decode_step": [(2.0, 6.0)],
                "model.ffn": [(3.0, 4.0), (4.5, 5.5)],
                "serve.emit": [(7.0, 8.0)]}, ops=[])
    pieces = program.timeline(t)
    assert [(a, b, s[-1] if s else None) for a, b, s in pieces] == [
        (0.0, 1.0, None), (1.0, 2.0, "serve.round"),
        (2.0, 3.0, "serve.decode_step"), (3.0, 4.0, "model.ffn"),
        (4.0, 4.5, "serve.decode_step"), (4.5, 5.5, "model.ffn"),
        (5.5, 6.0, "serve.decode_step"), (6.0, 7.0, "serve.round"),
        (7.0, 8.0, "serve.emit"), (8.0, 9.0, "serve.round"),
        (9.0, 10.0, None)]
    assert pieces[3][2] == ("serve.round", "serve.decode_step", "model.ffn")


def test_timeline_names_each_piece_as_host_at_does():
    # "a" and "b" overlap without nesting; "c" nests in both
    t = _trace({"a": [(1.0, 5.0)], "b": [(3.0, 7.0)], "c": [(3.5, 4.0)],
                "d": [(6.0, 9.0)], "e": [(6.5, 6.8)]}, ops=[])
    pieces = program.timeline(t)
    assert [(a, b) for a, b, _ in pieces] == [
        (0.0, 1.0), (1.0, 3.0), (3.0, 3.5), (3.5, 4.0), (4.0, 5.0),
        (5.0, 6.0), (6.0, 6.5), (6.5, 6.8), (6.8, 7.0), (7.0, 9.0),
        (9.0, 10.0)]
    for a, b, stack in pieces:
        assert program.innermost(stack) == t.host_at((a + b) / 2)


def test_idle_and_host_split_add_up():
    host = {"serve.round": [(1.0, 9.0)], "serve.prefill": [(1.5, 3.0)],
            "model.ffn": [(2.0, 2.5), (4.0, 5.0)],
            "serve.decode_step": [(3.5, 6.0)]}
    ops = [(0.5, 1.2), (2.2, 4.5), (8.0, 9.5)]
    t = _trace(host, ops)
    idle = program.idle_by_range(t)
    busy = union_length(ops)
    assert sum(idle.values()) == pytest.approx(10.0 - busy)
    # idle: [0, 0.5] [1.2, 2.2] [4.5, 8] [9.5, 10]
    assert idle == pytest.approx({
        program.OUTSIDE: 0.5 + 0.5, "serve.round": 0.3 + 2.0,
        "serve.prefill": 0.5, "model.ffn": 0.2 + 0.5,
        "serve.decode_step": 1.0})
    whole = program.host_by_range(t)
    assert sum(whole.values()) == pytest.approx(10.0)
    assert whole["serve.prefill"] == pytest.approx(1.5)
    assert whole["model.ffn"] == pytest.approx(1.0)
    assert program.host_s_within(t, "model.ffn", "serve.decode_step") == \
        pytest.approx(1.0)
    assert program.host_s_within(t, "model.ffn", "serve.prefill") == \
        pytest.approx(0.5)
    assert program.host_s_within(t, "model.attention", "serve.prefill") \
        is None


def test_idle_split_tool_prints_the_split(monkeypatch, capsys):
    import json

    import benchlib.harness as harness

    tool = idle_split_tool()
    run_cell = harness.run_cell

    def small(cell, seed, seconds, trace, device, **kw):
        kw.setdefault("mix", bs.lm_mix(cell))
        kw.setdefault("cfg", bs.lm_config())
        return run_cell(cell, seed, 1.0, trace, device, **kw)

    monkeypatch.setattr(harness, "run_cell", small)
    assert tool.main(["--workload", "qwen25-kanffn-rag", "--seed",
                      str(bs.SEED), "--seconds", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["result"]["correct"]
    assert sum(line["host_by_range"].values()) == pytest.approx(
        line["window_s"])
    assert line["decode_calls"] > 0
    assert line["pad_sent"]["share"] == pytest.approx(
        line["result"]["metrics"]["pad_share.prefill"]["value"], rel=1e-12)
    assert line["host_ms_per_decode"]["model.attention"] > 0
