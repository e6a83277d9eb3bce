"""The port's co-design examples (``repro_torch.examples.neurosim_search``
and ``tune_deploy``) against the reference's library calls in the
example's order, at smoke sizes.

  * neurosim_search: step 1's fronts equal to the reference's under both
    budgets; step 2's G sequence and costs equal wherever both runs accept
    a G (the budget decides where the sequence ends unless a val loss
    stops falling first); final accuracy within 0.05 of the reference's own
    run, the rule of ``test_torch_neurosim.py``'s MLP baseline;
  * tune_deploy: ``--smoke`` exits 0; its artifact resolves in the
    reference to the same candidate and tile plan; an artifact whose plan
    is perturbed on disk fails the reload check (status 1).
"""

import dataclasses
import json

import pytest
import torch

from repro import runtime as jrt
from repro import tune as jtune
from repro.core import neurosim as jns
from repro.core.tmdv import TMDVConfig as JTMDV
from repro_torch.core import neurosim as tns
from repro_torch.data.knot import make_knot_dataset
from repro_torch.examples import neurosim_search, tune_deploy

torch.set_num_threads(1)
quiet = lambda *_: None  # noqa: E731


# ----------------------------------------------------------------------------
# neurosim_search
# ----------------------------------------------------------------------------

# rounds enough for the minimal budget to stop the extension (G = 11 is
# its largest feasible grid, G = 13 is over its energy and latency)
STEP2 = dict(n=2048, epochs_per_round=10, max_rounds=5)
BUDGET_G = 11


@pytest.fixture(scope="module")
def search_run():
    return neurosim_search.run(**STEP2, device="cpu", log=quiet)


def test_search_fronts_match_the_reference(search_run):
    jspace = jtune.DesignSpace(**dataclasses.asdict(neurosim_search.SPACE))
    for name, hc in neurosim_search.BUDGETS.items():
        jhc = jns.HardwareConstraints(**dataclasses.asdict(hc))
        jres = jtune.pareto_search(
            None, jspace, constraints=jhc, dims=(17, 1, 14),
            config=jtune.SearchConfig(budget=40, n_init=16, seed=0))
        tres = search_run["searches"][name]
        assert [p.to_dict() for p in tres.front] == \
            [p.to_dict() for p in jres.front], name
        assert [p.feasible for p in tres.evaluated] == \
            [p.feasible for p in jres.evaluated], name
        feas = [p.candidate.grid_size for p in jres.evaluated if p.feasible]
        assert search_run["gmax"][name] == (max(feas) if feas else None)


def test_search_grid_extension_matches_the_reference(search_run):
    xt, yt, xv, yv = make_knot_dataset(STEP2["n"], 2048, seed=0,
                                       label_noise=0.04)
    hc = neurosim_search.BUDGETS["minimal (KAN1-like)"]
    jhc = jns.HardwareConstraints(**dataclasses.asdict(hc))
    jout = jns.grid_extension_train(
        (17, 1, 14), jhc, xt, yt, xv, yv, g_init=3, extend_by=2,
        epochs_per_round=STEP2["epochs_per_round"],
        max_rounds=STEP2["max_rounds"])
    tout = search_run["extension"]
    for out in (tout, jout):
        gs = [r["G"] for r in out["log"]]
        assert gs == list(range(3, 3 + 2 * len(gs), 2)), gs
        if out["G"] != gs[-1]:
            # the last G tried was refused by its val loss, not the budget
            assert out["G"] == gs[-2]
            assert out["log"][-1]["val_loss"] >= out["log"][-2]["val_loss"]
        else:
            assert out["G"] == BUDGET_G, gs
    # where both runs accept a G, its cost is the reference's
    if tout["G"] == jout["G"]:
        assert tout["cost"] == pytest.approx(jout["cost"], rel=1e-12)
    cost = jns._cost_for((17, 1, 14), BUDGET_G + 2, 3, 8, JTMDV(8, 4), 128, 8)
    assert not jns.check_constraints(cost, jhc)
    assert tns.check_constraints(tout["cost"], hc)
    print(f"G: port {tout['G']}, reference {jout['G']}")
    jacc = jns.evaluate_accuracy(jout["params"], xv, yv, jout["kspec"])
    assert abs(search_run["accuracy"] - jacc) <= 0.05, \
        (search_run["accuracy"], jacc)


# ----------------------------------------------------------------------------
# tune_deploy
# ----------------------------------------------------------------------------


def test_tune_deploy_smoke_exits_zero(tmp_path, capsys):
    out = tmp_path / "a.json"
    assert tune_deploy.main(["--smoke", "--out", str(out),
                             "--device", "cpu"]) == 0
    assert "artifact round trip OK" in capsys.readouterr().out
    assert out.is_file()


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    path = tmp_path_factory.mktemp("tune") / "art.json"
    out = tune_deploy.run(smoke=True, out=str(path), n_train=1024, n_val=128,
                          epochs=5, budget=4, n_init=2, device="cpu",
                          log=quiet)
    assert out["status"] == 0
    return path, out


def test_tune_deploy_artifact_resolves_alike_in_the_reference(tuned):
    path, out = tuned
    jrt.reset_cache()
    res = jtune.apply_tuning_artifact(jtune.load_tuning_artifact(str(path)))
    assert res["candidate"].to_dict() == out["chosen"].candidate.to_dict()
    got, want = out["tile"].chosen_plan, res["plan"]
    fields = lambda plan: (plan.b, plan.bp, [  # noqa: E731
        (dataclasses.asdict(lp.spec), lp.f, lp.o, lp.fp, lp.op, lp.bb,
         lp.bo, lp.bf, lp.residual_raw, lp.emit_codes)
        for lp in plan.layers])
    assert fields(got) == fields(want)


def test_tune_deploy_reload_check_fails_on_a_perturbed_plan(tuned, tmp_path):
    path, out = tuned
    art = json.loads(path.read_text())
    plan = out["tile"].chosen_plan
    # a smaller batch block than the chosen plan's first layer: a valid
    # plan, but another one
    art["tile_plan"]["overrides"] = [[8, lp.bo, lp.bf] for lp in plan.layers]
    assert plan.layers[0].bb != 8
    bad = tmp_path / "perturbed.json"
    bad.write_text(json.dumps(art))
    assert tune_deploy.check_reload(str(bad), out["task"], out["chosen"],
                                    out["tile"], out["x_probe"],
                                    out["y_tuned"], log=quiet) == 1
    assert tune_deploy.check_reload(str(path), out["task"], out["chosen"],
                                    out["tile"], out["x_probe"],
                                    out["y_tuned"], log=quiet) == 0
