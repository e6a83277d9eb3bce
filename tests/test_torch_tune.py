"""The port's co-design search (``tune/space.py``, ``tune/search.py``),
tuning artifacts (``tune/artifact.py``) and ``serve --tuned-config``
against the JAX package's.

  * ``space_hash`` equals the reference's for the same space, and
    ``DesignSpace.sample`` / ``neighbors`` propose the same candidates in
    the same order for one numpy seed;
  * each package's own ``make_knot_task`` (own initialization, own
    permutations) reaches a validation accuracy within 0.05 of the other's
    at seeds 0 and 1 (the chip's budgets: 8192 / 1024 rows, 120 epochs);
  * ``pareto_search`` on a ``KnotTask`` carrying the reference's trained
    base network (1024 / 128 rows, 10 epochs, budget 6) with both
    packages' ``Candidate.cim_config`` patched to ``deterministic=True``
    (IR-drop on, no noise) evaluates the same candidates in the same
    order, with cost metrics exactly equal; each accuracy equals the
    reference's or differs by counted rows whose ASP weight codes moved
    at a rounding tie (the port's float64 pinv refit against the
    reference's SVD lstsq), and the front is equal when no accuracy
    differs;
  * artifacts written by either package load in the other and resolve to
    the same ``Candidate``, ``ASPQuantSpec``, ``TMDVConfig``, ``CIMConfig``
    and tile geometry; built from the same search and tile results, the
    two files are byte-identical;
  * ``serve --tuned-config --device cpu`` deploys the chosen point;
  * the reference's single-device tune tests (``tests/test_tune.py``) on
    the port alone: front invariants, determinism, constraints, PowerGap
    rejection, SAM candidates, serialization and the artifact round trip.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro import tune as jtune
from repro.core.neurosim import evaluate_accuracy as j_evaluate_accuracy
from repro.tune import space as jspace
from repro_torch import convert, runtime, tune
from repro_torch.core.asp_quant import max_ld
from repro_torch.core.kan_network_deploy import kan_network_deploy_apply
from repro_torch.core.neurosim import (
    HardwareConstraints,
    evaluate_accuracy,
    kan_cost,
)
from repro_torch.launch import serve as cli
from repro_torch.tune import space as tspace

torch.set_num_threads(1)

SPACE_KW = dict(grid_size=(3, 5, 8), voltage_bits=(3, 4, 5), array_rows=(128,))
SPACE = tune.DesignSpace(**SPACE_KW)


@pytest.fixture(autouse=True)
def _fresh_cache():
    runtime.reset_cache()
    jrt.reset_cache()
    yield
    runtime.reset_cache()
    jrt.reset_cache()


# ----------------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, SPACE_KW,
                                dict(n_bits=(8, 16), layer_bits=((), (8, 4)),
                                     use_sam=(False,))])
def test_space_hash_and_proposals_equal_the_reference(kw):
    tsp, jsp = tune.DesignSpace(**kw), jtune.DesignSpace(**kw)
    assert tune.space_hash(tsp) == jtune.space_hash(jsp)
    tr, jr = np.random.default_rng(11), np.random.default_rng(11)
    ts, js = tsp.sample(tr, 24), jsp.sample(jr, 24)
    assert [c.to_dict() for c in ts] == [c.to_dict() for c in js]
    for tc, jc in zip(ts, js):
        tn, jn = tsp.neighbors(tc, tr, 3), jsp.neighbors(jc, jr, 3)
        assert [c.to_dict() for c in tn] == [c.to_dict() for c in jn]
        assert repr(tc) == repr(jc)  # the noise seeds' digest input


@pytest.mark.parametrize("seed", (0, 1))
def test_each_package_trains_its_own_knot_task_to_the_same_accuracy(seed):
    kw = dict(n_train=8192, n_val=1024, epochs=120, seed=seed)
    jt = jtune.make_knot_task(**kw)
    tt = tune.make_knot_task(device="cpu", **kw)
    ja = j_evaluate_accuracy(jt.base_params, jt.x_val, jt.y_val,
                               jt.base_kspec)
    ta = evaluate_accuracy(tt.base_params, tt.x_val, tt.y_val,
                               tt.base_kspec)
    np.testing.assert_array_equal(tt.y_val, np.asarray(jt.y_val))
    assert abs(ta - ja) <= 0.05, (ta, ja)
    assert ta > 1.0 / 14 + 0.3  # well above chance


@pytest.fixture(scope="module")
def carried():
    """The reference's trained base network as a task of both packages."""
    jt = jtune.make_knot_task(n_train=1024, n_val=128, epochs=10, seed=0,
                              calib_n=64)
    return jt, convert.knot_task_from_reference(jt, device="cpu")


@pytest.fixture()
def deterministic_acim(monkeypatch):
    """Both packages' candidates score on IR-drop only (no noise draws)."""
    for cls in (jspace.Candidate, tspace.Candidate):
        orig = cls.cim_config

        def cim_config(self, *a, _orig=orig, **kw):
            return dataclasses.replace(_orig(self, *a, **kw),
                                       deterministic=True)

        monkeypatch.setattr(cls, "cim_config", cim_config)


def _moved_weight_codes(jt, pt, cand) -> int:
    """ASP weight codes of a candidate that differ between the packages
    (refits of the base network at a rounding tie)."""
    _, jq, _ = jtune.deploy_candidate(jt, jspace.candidate_from_dict(
        cand.to_dict()))
    _, tq, _ = tune.deploy_candidate(pt, cand)
    return sum(int((np.asarray(a["c_q"]) != b["c_q"].numpy()).sum())
               for a, b in zip(jq, tq))


def test_pareto_search_matches_the_reference_on_carried_params(
        carried, deterministic_acim):
    jt, pt = carried
    jres = jtune.pareto_search(jt, jtune.DesignSpace(), config=jtune.SearchConfig(
        budget=6, seed=0, acim_seeds=1))
    tres = tune.pareto_search(pt, tune.DesignSpace(), config=tune.SearchConfig(
        budget=6, seed=0, acim_seeds=1))
    assert [p.candidate.to_dict() for p in tres.evaluated] == \
        [p.candidate.to_dict() for p in jres.evaluated]
    n_val = len(pt.y_val)
    differing = 0
    for tp, jp in zip(tres.evaluated, jres.evaluated):
        for k in ("area_mm2", "energy_pj", "latency_ns", "phases"):
            assert tp.metrics[k] == jp.metrics[k], k
        assert tp.feasible == jp.feasible
        if tp.metrics["accuracy"] != jp.metrics["accuracy"]:
            differing += 1
            # counted: only a refit whose weight codes moved may differ
            rows = abs(tp.metrics["accuracy"] - jp.metrics["accuracy"]) * n_val
            moved = _moved_weight_codes(jt, pt, tp.candidate)
            assert moved > 0, (tp.candidate, rows)
    if differing == 0:
        assert tres.to_dict() == jres.to_dict()
    assert tres.space_hash == jres.space_hash


def _tile_result(mod, dep, **kw):
    """A tuned (non-heuristic) tile result: smaller batch blocks win."""
    return mod.tune_tiles(dep, batch=16, max_candidates=6, seed=0,
                          register=True, warm=False,
                          score_fn=lambda p: p.layers[0].bb, **kw)


def _resolved_fields(res) -> dict:
    """What an applied artifact resolves to, as plain values."""
    cand = res["candidate"]
    dims, specs, residual_raw = res["tile_geometry"]
    asd = dataclasses.asdict
    return {
        "candidate": cand.to_dict(), "spec": asd(res["spec"]),
        "input_gen": asd(res["input_gen"]), "cim": asd(res["cim"]),
        "geometry": (tuple(dims), [asd(s) for s in specs], residual_raw),
        "overrides": res["tile_overrides"],
    }


def test_artifacts_load_across_the_packages_and_match_byte_for_byte(
        carried, tmp_path):
    jt, pt = carried
    jres = jtune.pareto_search(jt, jtune.DesignSpace(**SPACE_KW),
                               config=jtune.SearchConfig(budget=3, n_init=2,
                                                         seed=3, acim_seeds=1))
    jchosen = jtune.select_point(jres.front)
    _, _, jdep = jtune.deploy_candidate(jt, jchosen.candidate)
    jtile = _tile_result(jtune, jdep, interpret=True)
    assert jtile.tuned
    jart = jtune.build_tuning_artifact(search=jres, chosen=jchosen,
                                       tile=jtile, task=jt.name)
    jpath = tmp_path / "ref.json"
    jtune.save_tuning_artifact(str(jpath), jart)

    # the port's artifact from the same search and its own tile tuner
    tres = convert.search_result_from_dict(jres.to_dict())
    tchosen = tune.select_point(tres.front)
    assert tchosen.to_dict() == jchosen.to_dict()
    _, _, tdep = tune.deploy_candidate(pt, tchosen.candidate)
    ttile = _tile_result(tune, tdep)
    assert ttile.to_dict() == jtile.to_dict()
    tart = tune.build_tuning_artifact(search=tres, chosen=tchosen,
                                      tile=ttile, task=pt.name)
    tpath = tmp_path / "port.json"
    tune.save_tuning_artifact(str(tpath), tart)
    assert tpath.read_bytes() == jpath.read_bytes()

    # each file in the other package resolves to the same objects
    runtime.reset_cache()
    jrt.reset_cache()
    from_ref = tune.apply_tuning_artifact(tune.load_tuning_artifact(str(jpath)))
    from_port = jtune.apply_tuning_artifact(
        jtune.load_tuning_artifact(str(tpath)))
    assert _resolved_fields(from_ref) == _resolved_fields(from_port)
    assert from_ref["plan"] == ttile.chosen_plan
    assert from_ref["plan"].row_tile == 16  # bb 8 -> B1's smallest tile
    assert runtime.PLAN_CACHE.get_tile_overrides(
        *from_ref["tile_geometry"]) == from_ref["tile_overrides"]


# ----------------------------------------------------------------------------
# serve --tuned-config
# ----------------------------------------------------------------------------


def _serve(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_cli_serves_a_tuned_config_on_the_cpu(tmp_path):
    cand = tune.Candidate(grid_size=12, order=2, n_bits=8,
                          layer_bits=(8, 4), voltage_bits=3)
    art = tune.build_tuning_artifact(
        chosen=tune.EvaluatedPoint(candidate=cand, metrics={"accuracy": 0.5}))
    art["tile_plan"] = {"dims": [17, 1, 14], "residual_raw": False,
                        "bucket": 16, "mode": "proxy",
                        "specs": [dataclasses.asdict(cand.spec())] * 2,
                        "overrides": [[8, 128, 32], [8, 128, 128]]}
    path = tmp_path / "tuned.json"
    tune.save_tuning_artifact(str(path), art)
    out = _serve(["--arch", "qwen2.5-14b", "--kan-ffn", "--requests", "2",
                  "--slots", "2", "--max-new", "3", "--tuned-config",
                  str(path), "--device", "cpu"])
    assert "served requests=2" in out, out
    assert "G=12 K=2 n_bits=8 layer_bits=8,4" in out, out
    assert f"[artifact {path}: task=knot" in out and "tile mode=proxy" in out
    # the knot geometry's tile plan is registered (the LM's FFN is not it)
    assert "plan_source='heuristic [artifact" in out, out
    spec = cand.spec()
    assert runtime.PLAN_CACHE.get_tile_overrides(
        (17, 1, 14), (spec, spec), False) == ((8, 128, 32), (8, 128, 128))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({**art, "chosen": {"config": {
        **cand.to_dict(), "grid_size": 40, "layer_bits": [4, 4]}}}))
    with pytest.raises(SystemExit, match="invalid KAN bit allocation"):
        _serve(["--arch", "qwen2.5-14b", "--kan-ffn", "--tuned-config",
                str(bad), "--device", "cpu"])


# ----------------------------------------------------------------------------
# the reference's single-device tune cases (tests/test_tune.py), on the port
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def task():
    """One base network trained by the port, shared by the searches."""
    return tune.make_knot_task(n_train=4096, n_val=512, epochs=60, seed=0,
                               calib_n=128, device="cpu")


@pytest.fixture(scope="module")
def search_result(task):
    return tune.pareto_search(
        task, SPACE,
        config=tune.SearchConfig(budget=12, n_init=5, seed=0, acim_seeds=2))


def test_front_is_mutually_non_dominated(search_result):
    res = search_result
    assert len(res.front) > 0 and res.n_evals == 12
    for p in res.front:
        assert p.feasible
        for q in res.front:
            assert not tune.dominates(q.metrics, p.metrics, res.objectives)


def test_front_covers_every_feasible_point(search_result):
    res = search_result
    front = set(id(p) for p in res.front)
    for p in res.evaluated:
        if p.feasible and id(p) not in front:
            assert any(tune.dominates(q.metrics, p.metrics, res.objectives)
                       for q in res.front), p.candidate


def test_some_point_dominates_the_unsearched_default(search_result):
    res = search_result
    assert res.baseline is not None
    assert res.baseline.candidate == tune.default_candidate()
    dom = res.dominating_baseline(on=("energy_pj", "accuracy"))
    assert len(dom) > 0, [p.to_dict() for p in res.front]


def test_search_is_deterministic_under_a_fixed_seed(task):
    cfg = tune.SearchConfig(budget=5, n_init=3, seed=7, acim_seeds=1)
    r1 = tune.pareto_search(task, SPACE, config=cfg)
    r2 = tune.pareto_search(task, SPACE, config=cfg)
    assert r1.to_dict() == r2.to_dict()
    assert [p.candidate for p in r1.evaluated] == \
        [p.candidate for p in r2.evaluated]


def test_candidate_noise_generators_are_deterministic_and_distinct():
    a, b = tune.Candidate(grid_size=5), tune.Candidate(grid_size=8)
    gen = tune.search.candidate_generator
    draw = lambda g: torch.randn(4, generator=g)
    assert torch.equal(draw(gen(a, 0, 0, "cpu")), draw(gen(a, 0, 0, "cpu")))
    assert not torch.equal(draw(gen(a, 0, 0, "cpu")),
                           draw(gen(a, 0, 1, "cpu")))
    assert not torch.equal(draw(gen(a, 0, 0, "cpu")),
                           draw(gen(b, 0, 0, "cpu")))
    assert not torch.equal(draw(gen(a, 0, 0, "cpu")),
                           draw(gen(a, 1, 0, "cpu")))


def test_constraint_violators_never_enter_the_front():
    space = tune.DesignSpace(grid_size=(3, 5, 8, 16, 32),
                             voltage_bits=(3, 4, 5), array_rows=(128,),
                             use_sam=(False,))
    hc = HardwareConstraints(max_energy_pj=260.0)
    res = tune.pareto_search(None, space, constraints=hc,
                             config=tune.SearchConfig(budget=20, n_init=10,
                                                      seed=1))
    infeasible = [p for p in res.evaluated if not p.feasible]
    assert infeasible, "constraint was never exercised"
    for p in infeasible:
        assert p.metrics["energy_pj"] > hc.max_energy_pj
        assert p not in res.front
    for p in res.front:
        assert p.metrics["energy_pj"] <= hc.max_energy_pj


def test_sampling_rejects_powergap_invalid_bit_allocations():
    space = tune.DesignSpace(grid_size=(5, 32), n_bits=(8, 16),
                             layer_bits=((), (8, 4), (4, 4)),
                             voltage_bits=(3, 4), array_rows=(128,),
                             use_sam=(False,))
    rng = np.random.default_rng(0)
    cands = space.sample(rng, 200)
    assert len(cands) == 200
    seen = set()
    for cand in cands:
        assert space.is_valid(cand)
        for b in (cand.n_bits,) + cand.layer_bits:
            assert max_ld(cand.grid_size, b) >= 0, cand
        seen.add((cand.grid_size, cand.layer_bits))
        for nb in space.neighbors(cand, rng, n=2):
            assert space.is_valid(nb), (cand, nb)
    assert (5, (4, 4)) in seen and (5, (8, 4)) in seen
    assert not any(g == 32 and 4 in lb for g, lb in seen)


def test_invalid_bit_allocations_never_reach_the_front():
    space = tune.DesignSpace(grid_size=(5, 8, 32), n_bits=(8,),
                             layer_bits=((), (8, 4), (4, 4)),
                             voltage_bits=(3, 4), array_rows=(128,),
                             use_sam=(False,))
    res = tune.pareto_search(None, space, config=tune.SearchConfig(
        budget=24, n_init=12, seed=3))
    assert res.evaluated
    for p in tuple(res.evaluated) + tuple(res.front):
        assert space.is_valid(p.candidate), p.candidate


def test_cost_only_metrics_match_the_neurosim_cost_model():
    cand = tune.Candidate(grid_size=8, voltage_bits=3)
    m = tune.evaluate_candidate(None, cand, dims=(17, 1, 14))
    assert m == kan_cost((17, 1, 14), 8, 3, 8, cand.input_gen(), 128, 8)
    assert "accuracy" not in m


def test_sam_candidates_use_the_acim_backend_with_placement(task):
    base = tune.Candidate(grid_size=5, voltage_bits=4)
    sam = dataclasses.replace(base, use_sam=True)
    m0 = tune.evaluate_candidate(task, base, acim_seeds=1)
    m1 = tune.evaluate_candidate(task, sam, acim_seeds=1)
    for k in ("area_mm2", "energy_pj", "latency_ns"):
        assert m0[k] == m1[k]
    assert 0.0 <= m1["accuracy"] <= 1.0
    assert m1 == tune.evaluate_candidate(task, sam, acim_seeds=1)


def test_artifact_roundtrip_reproduces_the_deployment(task, tmp_path):
    res = tune.pareto_search(task, SPACE, config=tune.SearchConfig(
        budget=3, n_init=2, seed=3, acim_seeds=1))
    chosen = tune.select_point(res.front)
    _, _, dep = tune.deploy_candidate(task, chosen.candidate)
    tile = _tile_result(tune, dep)
    assert tile.tuned
    art = tune.build_tuning_artifact(search=res, chosen=chosen, tile=tile,
                                     task=task.name)
    path = tmp_path / "artifact.json"
    tune.save_tuning_artifact(str(path), art)

    runtime.reset_cache()  # cold runtime: only the file remains
    loaded = tune.load_tuning_artifact(str(path))
    assert loaded["version"] == tune.ARTIFACT_VERSION
    assert loaded["space_hash"] == tune.space_hash(SPACE)
    assert loaded["seed"] == 3
    resolved = tune.apply_tuning_artifact(loaded)
    assert resolved["candidate"] == chosen.candidate
    assert resolved["spec"] == chosen.candidate.spec()
    assert resolved["plan"] == tile.chosen_plan
    _, _, dep2 = tune.deploy_candidate(task, resolved["candidate"])
    x = np.random.default_rng(5).uniform(-1, 1, (10, task.dims[0]))
    y1 = kan_network_deploy_apply(dep, x)
    y2 = kan_network_deploy_apply(dep2, x)
    assert torch.equal(y1, y2)


def test_artifact_schema_validation(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "something-else"}))
    with pytest.raises(ValueError):
        tune.load_tuning_artifact(str(bad))
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps({"kind": tune.ARTIFACT_KIND,
                                 "version": tune.ARTIFACT_VERSION + 1}))
    with pytest.raises(ValueError):
        tune.load_tuning_artifact(str(newer))
    with pytest.raises(ValueError):
        tune.save_tuning_artifact(str(tmp_path / "x.json"), {"kind": "nope"})


def test_candidate_and_space_serialization():
    cand = tune.Candidate(grid_size=8, voltage_bits=5, use_sam=True)
    assert tune.candidate_from_dict(cand.to_dict()) == cand
    assert tune.space_hash(SPACE) == tune.space_hash(
        tune.DesignSpace(**SPACE_KW))
    assert tune.space_hash(SPACE) != tune.space_hash(tune.DesignSpace())
    assert not SPACE.is_valid(tune.Candidate(grid_size=200, n_bits=6))
    assert not SPACE.is_valid(tune.Candidate(voltage_bits=9))
