"""The port's dry-run tools against the reference's.

  * ``scripts.roofline_md``: its copies of ``param_counts`` /
    ``model_flops`` equal ``benchmarks/roofline.py``'s for every arch and
    shape, and its table equals the reference script's on the same
    reports; ``main`` patches EXPERIMENTS.md in the working directory;
  * ``scripts.top_ops``: its totals equal the dry-run's FLOPs and bytes;
  * ``launch.op_analysis.roofline`` is the reference's formula;
  * ``scripts.check_obs`` gives the reference's verdict on the port's
    serve artifacts and on malformed ones.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import SHAPES as J_SHAPES
from repro.configs.registry import get_config as j_get_config
from repro.launch import hlo_analysis as jhlo
from repro_torch.configs.registry import ARCHS, SHAPES, get_config, smoke_config
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import DryMesh
from repro_torch.scripts import check_obs, roofline_md, top_ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_roofline():
    return _load("ref_benchmarks_roofline", ROOT / "benchmarks" / "roofline.py")


@pytest.fixture(scope="module")
def ref_check_obs():
    return _load("ref_check_obs", ROOT / "scripts" / "check_obs.py")


def _run(fn, *args):
    """``fn(*args)`` with its output captured: (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Two smoke-size dry-run reports (train and decode of qwen2.5-14b on a
    (2, 4) stand-in mesh, named as registry cells) and their op files."""
    d = tmp_path_factory.mktemp("dryrun")
    cfg = dataclasses.asdict(dataclasses.replace(smoke_config("qwen2.5-14b"),
                                                 microbatch=2))
    out = {}
    for shape in ("train_4k", "decode_32k"):
        sh = {**SHAPES[shape], "seq_len": 32,
              "global_batch": 4 if shape == "train_4k" else 8}
        ops = d / f"qwen2.5-14b__{shape}__single.ops.jsonl"
        r = dryrun.run_cell("qwen2.5-14b", sh, DryMesh((2, 4)),
                            save_ops=str(ops), overrides=cfg)
        r["shape"] = shape
        (d / f"qwen2.5-14b__{shape}__single.json").write_text(json.dumps(r))
        out[shape] = (r, ops)
    return d, out


def test_param_counts_and_model_flops_equal_the_references(ref_roofline):
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for arch in ARCHS:
        for kan in (False, True):
            cfg, jcfg = get_config(arch), j_get_config(arch)
            if kan:
                cfg, jcfg = cfg.kan_variant(), jcfg.kan_variant()
            assert roofline_md.param_counts(cfg) == \
                ref_roofline.param_counts(jcfg), (arch, kan)
            for shape in J_SHAPES:
                assert roofline_md.model_flops(cfg, shape) == \
                    ref_roofline.model_flops(jcfg, shape), (arch, shape)


def test_render_equals_the_reference_scripts_table(reports, monkeypatch,
                                                   tmp_path):
    """The reference's ``render`` over the same reports gives the same
    table; ``main`` puts it between the markers of EXPERIMENTS.md in the
    working directory, replacing the last one."""
    d, _ = reports
    monkeypatch.syspath_prepend(str(ROOT))
    ref = _load("ref_roofline_md", ROOT / "scripts" / "roofline_md.py")
    table = roofline_md.render(str(d))
    assert table == ref.render(str(d))
    lines = table.splitlines()
    assert lines[2].count("|") == 13 and len(lines) == 4 + 2 + 2
    monkeypatch.chdir(tmp_path)
    (tmp_path / "EXPERIMENTS.md").write_text("# x\n\nFINAL_TABLE_PLACEHOLDER\n")
    _, out = _run(roofline_md.main, [str(d)])
    assert "updated with 2 rows" in out
    text = (tmp_path / "EXPERIMENTS.md").read_text()
    assert table in text and "PLACEHOLDER" not in text
    _run(roofline_md.main, [str(d)])
    assert (tmp_path / "EXPERIMENTS.md").read_text() == text


@pytest.mark.parametrize("mode", ("flops", "bytes"))
def test_top_ops_totals_equal_the_dryrun(reports, mode):
    _, cells = reports
    for shape, (r, ops) in cells.items():
        total, out = _run(top_ops.main, str(ops), mode, 5)
        assert total == r[f"{mode}_per_dev"] > 0, shape
        lines = out.splitlines()
        assert lines[0] == f"total {mode}: {total:.4e}"
        assert 1 < len(lines) <= 6
        ranked = top_ops.rank(top_ops.load(str(ops)), mode)
        assert [v for v, *_ in ranked] == sorted((v for v, *_ in ranked),
                                                 reverse=True)
        assert sum(n for _, n, *_ in ranked) == sum(
            1 for rec in top_ops.load(str(ops)) if rec[mode])


@pytest.mark.parametrize("terms", [(1e12, 1e9, 0.0), (1e9, 1e12, 5e8),
                                   (1e6, 1e3, 1e12), (0.0, 0.0, 0.0)])
def test_roofline_is_the_references_formula(terms, monkeypatch):
    monkeypatch.setattr(jhlo, "PEAK_FLOPS", op_analysis.PEAK_FLOPS)
    monkeypatch.setattr(jhlo, "HBM_BW", op_analysis.HBM_BW)
    monkeypatch.setattr(jhlo, "ICI_BW", op_analysis.NVLINK_BW)
    assert op_analysis.roofline(*terms) == jhlo.roofline(*terms)


@pytest.fixture(scope="module")
def serve_artifacts(tmp_path_factory):
    """The files ``launch.serve --metrics-dump / --trace-out`` writes at
    smoke size on the CPU."""
    from repro_torch import obs
    from repro_torch.launch import serve as cli

    d = tmp_path_factory.mktemp("obs")
    files = {"prom": d / "m.prom", "json": d / "m.json",
             "trace": d / "t.jsonl"}
    try:
        _run(cli.main, ["--arch", "qwen2.5-14b", "--kan-ffn", "--requests",
                        "3", "--slots", "2", "--max-new", "3", "--device",
                        "cpu", "--metrics-dump", str(files["prom"]),
                        "--metrics-dump", str(files["json"]), "--trace-out",
                        str(files["trace"])])
    finally:
        # --metrics-dump turned the process's registry on: later tests in
        # this worker must not count into it
        obs.disable()
        obs.REGISTRY.reset()
    return files


def _verdicts(mod, kind: str, path: str):
    check = {"prom": mod.check_prom, "json": mod.check_json,
             "trace": mod.check_trace}[kind]
    return _run(check, path)[0]


def test_check_obs_passes_the_ports_serve_artifacts(serve_artifacts,
                                                     ref_check_obs):
    for kind, path in serve_artifacts.items():
        got = _verdicts(check_obs, kind, str(path))
        assert got == [] == _verdicts(ref_check_obs, kind, str(path)), kind
    argv = [f"--{k}={p}" for k, p in serve_artifacts.items()]
    rc, out = _run(check_obs.main, argv)
    assert rc == 0 and "obs artifacts OK" in out


SUFFIX = {"prom": "prom", "json": "json", "trace": "jsonl"}
# malformed inputs, one for each check the reference's validator names
MALFORMED = {
    "prom_unparsable": ("prom", "serve_requests 1\nnot a sample line here\n"),
    "prom_empty": ("prom", "# only a comment\n"),
    "prom_no_plan_cache": ("prom", "serve_requests_total 3\n"),
    "prom_inf_bucket": ("prom", (
        "serve_requests_total 3\nplan_cache_hits_total 1\n"
        'serve_ttft_seconds_bucket{le="+Inf"} 2\n'
        "serve_ttft_seconds_count 3\n")),
    "prom_no_count": ("prom", (
        "serve_requests_total 3\nplan_cache_hits_total 1\n"
        'serve_ttft_seconds_bucket{le="+Inf"} 2\n')),
    "json_no_metrics": ("json", json.dumps({"metrics": {}})),
    "json_bad_kind": ("json", json.dumps(
        {"metrics": {"a": {"kind": "summary", "value": 1}}})),
    "json_bad_hist": ("json", json.dumps({"metrics": {"h": {
        "kind": "histogram",
        "value": {"edges": [1.0], "counts": [1, 1], "count": 3}}}})),
    "json_non_numeric": ("json", json.dumps(
        {"metrics": {"c": {"kind": "counter", "value": "3"}}})),
    "trace_not_json": ("trace", "{not json\n"),
    "trace_bad_shape": ("trace", json.dumps(
        {"type": "span", "name": "request", "id": 0}) + "\n"),
    "trace_ids_and_parents": ("trace", "\n".join(json.dumps(r) for r in [
        {"type": "span", "name": "request", "id": 1, "parent": None,
         "rid": 0, "t0": 0.0, "t1": 1.0, "attrs": {"status": "done"}},
        {"type": "span", "name": "queued", "id": 1, "parent": 7, "rid": 0,
         "t0": 0.0, "t1": 0.5, "attrs": {}}]) + "\n"),
    "trace_open_span": ("trace", json.dumps(
        {"type": "span", "name": "request", "id": 0, "parent": None,
         "rid": 0, "t0": 1.0, "t1": None, "attrs": {"status": "done"}})
        + "\n"),
    "trace_bad_status": ("trace", "\n".join(json.dumps(r) for r in [
        {"type": "span", "name": "request", "id": 0, "parent": None,
         "rid": 0, "t0": 0.0, "t1": 1.0, "attrs": {"status": "lost"}},
        {"type": "span", "name": "queued", "id": 1, "parent": 0, "rid": 0,
         "t0": 0.0, "t1": 0.5, "attrs": {}}]) + "\n"),
    "trace_served_incomplete": ("trace", "\n".join(json.dumps(r) for r in [
        {"type": "span", "name": "request", "id": 0, "parent": None,
         "rid": 0, "t0": 0.0, "t1": 1.0, "attrs": {"status": "done"}},
        {"type": "span", "name": "queued", "id": 1, "parent": 0, "rid": 0,
         "t0": 0.0, "t1": 0.5, "attrs": {}}]) + "\n"),
    "trace_no_requests": ("trace", json.dumps(
        {"type": "meta", "name": "x"}) + "\n"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_check_obs_refuses_what_the_reference_refuses(case, tmp_path,
                                                      ref_check_obs):
    kind, text = MALFORMED[case]
    path = tmp_path / f"{case}.{SUFFIX[kind]}"
    path.write_text(text)
    got = _verdicts(check_obs, kind, str(path))
    assert got and got == _verdicts(ref_check_obs, kind, str(path)), got
    rc, out = _run(check_obs.main, [f"--{kind}={path}"])
    assert rc == 1 and "FAIL:" in out
