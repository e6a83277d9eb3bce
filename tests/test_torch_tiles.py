"""The port's tile tuner (``tune/tiles.py``), the plan cache's tuned-tile
registry (``runtime/plancache.py``) and kernel B1's row tile
(``PipelinePlan.row_tile``), against the JAX package's where it has them.

  * ``row_tile`` is 64 in every plan made without overrides and
    ``min(64, max(16, bb))`` with them (rounded down to 16, 32 or 64), so
    no path that runs today changes its launch; the plain version ignores
    the tile (the same bits at 16, 32 and 64) and an unknown tile raises;
  * ``tune_tiles`` in proxy mode (the CPU) on converted bundles (KAN1 and
    the ``residual_raw`` FFN stack) gives the reference's trials and
    verdicts: the same candidates in order, the same validity, exactness,
    proxy scores and rejection reasons, and the same winner.  One verdict
    differs by design: where the reference's Pallas kernel splits the
    FFN's 128-wide contraction by a shrunk ``bf``, its f32 sums change and
    it rejects the candidate as not bit-exact; the port's schedule never
    reads ``bf``, so the same candidate is exact and scored;
  * the registry: ``set_tile_overrides`` / ``get_tile_overrides`` /
    ``tile_overrides`` under the reference's geometry key, registration
    drops the geometry's cached plans and entries, clearing an
    unregistered geometry drops nothing, and ``reset_cache`` clears it;
  * the reference's single-device tile cases (``tests/test_tune.py``) on
    the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import kan1_bundle
from repro import runtime as jrt
from repro import tune as jtune
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.core.kan_network_deploy import quantize_kan_network as j_quantize
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro_torch import convert, runtime, tune
from repro_torch.core.kan_layer import KANSpec, init_kan_network
from repro_torch.core.kan_network_deploy import (
    deploy_kan_network,
    kan_network_deploy_apply,
    quantize_kan_network,
)
from repro_torch.kernels.kan_spline import pipeline as tpl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache():
    runtime.reset_cache()
    jrt.reset_cache()
    yield
    runtime.reset_cache()
    jrt.reset_cache()


def _kan1(batch=32, grid=5, n_bits=8):
    kspec = KANSpec(dims=(17, 1, 14), grid_size=grid, n_bits=n_bits)
    params = init_kan_network(torch.Generator().manual_seed(0), kspec,
                              device="cpu")
    qparams = quantize_kan_network(params, kspec)
    return kspec, deploy_kan_network(qparams, kspec, batch=batch,
                                     device="cpu")


# ----------------------------------------------------------------------------
# B1's row tile in the plan
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("bb,want", [(8, 16), (16, 16), (24, 16), (32, 32),
                                     (40, 32), (64, 64), (128, 64)])
def test_row_tile_follows_the_tuned_batch_block(bb, want):
    spec = KANSpec(dims=(17, 1, 14), grid_size=5).layer_spec()
    plan = tpl.make_pipeline_plan(1024, (17, 1, 14), (spec, spec),
                                  tile_overrides=(bb, 128, 32))
    assert plan.layers[0].bb == bb and plan.row_tile == want
    tpl.validate_plan(plan)
    # untuned plans, at any batch, keep the 64-row launch
    for batch in (1, 8, 1000, 65536):
        assert tpl.make_pipeline_plan(batch, (17, 1, 14),
                                      (spec, spec)).row_tile == 64
    # a batch-clipped block maps to the clipped size
    small = tpl.make_pipeline_plan(8, (17, 1, 14), (spec, spec),
                                   tile_overrides=(bb, 128, 32))
    assert small.row_tile == 16


def test_plain_version_ignores_the_row_tile_and_bad_tiles_raise():
    _, dep = _kan1(batch=40)
    lp, lw = dep.plan.layers[0], dep.layers[0]
    rng = np.random.default_rng(0)
    codes = torch.as_tensor(rng.integers(0, lp.spec.num_codes, (40, lp.fp)),
                            dtype=torch.int32)
    outs = [tpl.run_pipeline_layer(codes, None, lw, lp, 40, row_tile=t)
            for t in tpl.ROW_TILES]
    for y, c in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(c, outs[0][1])
    with pytest.raises(ValueError, match="row tile"):
        tpl.run_pipeline_layer(codes, None, lw, lp, 40, row_tile=48)
    with pytest.raises(ValueError, match="row tile"):
        tpl.validate_plan(dataclasses.replace(dep.plan, row_tile=8))


# ----------------------------------------------------------------------------
# the tuner in proxy mode against the reference
# ----------------------------------------------------------------------------


def _ffn_bundle(batch=16):
    jk = JKANSpec(dims=(64, 128, 64), grid_size=8)
    import jax

    qp = j_quantize(j_init(jax.random.PRNGKey(0), jk), jk)
    return j_deploy_ffn(qp, jk.dims, jk.layer_spec(), batch=batch)


def _trial(t):
    return (tuple(map(tuple, t.overrides)), t.valid, t.exact, t.score,
            t.reason)


@pytest.mark.parametrize("model", ["kan1", "ffn"])
def test_proxy_tuning_gives_the_reference_trials_and_verdicts(model):
    if model == "kan1":
        _, _, jdep = kan1_bundle(batch=32)
        kw = dict(batch=32, max_candidates=8)
    else:
        jdep = _ffn_bundle()
        kw = dict(batch=16, max_candidates=6)
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    jres = jtune.tune_tiles(jdep, seed=0, register=False, interpret=True, **kw)
    tres = tune.tune_tiles(tdep, seed=0, register=False, **kw)
    assert tres.mode == jres.mode == "proxy"
    assert len(tres.trials) == len(jres.trials)
    split_sums = 0
    for tt, jt in zip(tres.trials, jres.trials):
        if jt.reason == "not bit-exact vs heuristic":
            # the reference's bf split moved its sums; the port's did not
            split_sums += 1
            assert tt.exact and tt.overrides == jt.overrides
            assert tt.score == tune.plan_cost_proxy(tpl.make_pipeline_plan(
                tres.bucket, tres.dims, tres.specs,
                residual_raw=tres.residual_raw, tile_overrides=tt.overrides))
        else:
            assert _trial(tt) == _trial(jt)
    assert split_sums == 0 or model == "ffn"
    assert tres.heuristic_score == jres.heuristic_score
    assert tres.chosen_overrides == jres.chosen_overrides
    assert tres.to_dict() == jres.to_dict()
    for t in tres.trials:
        if t.valid:
            bb = min(t.overrides[0][0], tres.bucket)  # clipped to the batch
            assert t.row_tile == tpl.row_tile_for(bb)


# ----------------------------------------------------------------------------
# the tuned-tile registry
# ----------------------------------------------------------------------------


def test_registry_sets_gets_invalidates_and_clears():
    kspec, dep = _kan1()
    geom = (tuple(dep.dims), tuple(dep.specs), dep.residual_raw)
    cache = runtime.PLAN_CACHE
    x = np.random.default_rng(1).uniform(-1, 1, (32, 17))
    kan_network_deploy_apply(dep, x)
    assert cache.plan(32, *geom[:2]).row_tile == 64
    assert cache.get_tile_overrides(*geom) is None
    builds = runtime.cache_stats()["builds"]
    cache.set_tile_overrides(*geom, (16, 128, 32))
    assert cache.get_tile_overrides(*geom) == ((16, 128, 32),) * 2
    assert cache.tile_overrides() == {geom: ((16, 128, 32),) * 2}
    assert runtime.cache_stats()["entries"] == 0  # the entry was dropped
    assert cache.plan(32, *geom[:2]).row_tile == 16
    assert dep.replan(16).plan.row_tile == 16
    kan_network_deploy_apply(dep, x)
    assert runtime.cache_stats()["builds"] == builds + 1
    runtime.reset_cache()
    assert cache.tile_overrides() == {}
    assert cache.plan(32, *geom[:2]).row_tile == 64


def test_clearing_unregistered_overrides_does_not_invalidate():
    _, dep = _kan1()
    x = np.random.default_rng(4).uniform(-1, 1, (8, 17))
    kan_network_deploy_apply(dep, x, backend="fused")
    stats0 = runtime.cache_stats()
    runtime.PLAN_CACHE.set_tile_overrides(tuple(dep.dims), tuple(dep.specs),
                                          dep.residual_raw, None)
    kan_network_deploy_apply(dep, x, backend="fused")
    stats1 = runtime.cache_stats()
    assert stats1["builds"] == stats0["builds"]
    assert stats1["hits"] == stats0["hits"] + 1


# ----------------------------------------------------------------------------
# the reference's single-device tile cases (tests/test_tune.py), on the port
# ----------------------------------------------------------------------------


def test_tile_candidates_valid_and_bit_exact():
    _, dep = _kan1()
    res = tune.tune_tiles(dep, batch=32, max_candidates=8, seed=0,
                          register=False)
    kept = [t for t in res.trials if t.valid]
    assert len(kept) >= 4
    for t in kept:
        plan = tpl.make_pipeline_plan(res.bucket, res.dims, res.specs,
                                      residual_raw=res.residual_raw,
                                      tile_overrides=t.overrides)
        tpl.validate_plan(plan)
        for lp, hp in zip(plan.layers, res.heuristic_plan.layers):
            assert (lp.fp, lp.op) == (hp.fp, hp.op)
    assert all(t.exact for t in kept if np.isfinite(t.score))
    codes = torch.as_tensor(np.random.default_rng(0).integers(
        0, res.specs[0].num_codes, size=(res.bucket, res.dims[0])),
        dtype=torch.int32)
    y_a = tpl.kan_pipeline_impl(codes, None, dep.layers, res.heuristic_plan)
    y_b = tpl.kan_pipeline_impl(codes, None, dep.layers, res.chosen_plan)
    assert torch.equal(y_a, y_b)


def test_invalid_tile_overrides_are_rejected():
    spec = tune.Candidate(grid_size=5).spec()
    for ov in ((32, 96, 32), (32, 128, 24), (12, 128, 32),
               ((8, 128, 32), (16, 128, 128))):
        with pytest.raises(ValueError):
            tpl.make_pipeline_plan(32, (17, 1, 14), (spec, spec),
                                   tile_overrides=ov)


def test_tuned_plan_is_picked_up_without_rebuilding_consumers():
    _, dep = _kan1(batch=8)
    res = tune.tune_tiles(dep, batch=32, max_candidates=8, seed=0,
                          register=True, warm=True,
                          score_fn=lambda p: p.layers[0].bb)
    assert res.tuned and res.registered
    assert res.chosen_overrides[0][0] < res.heuristic_plan.layers[0].bb
    assert res.chosen_plan.row_tile < res.heuristic_plan.row_tile == 64
    tuned_plan = runtime.PLAN_CACHE.plan(res.bucket, res.dims, res.specs,
                                         residual_raw=res.residual_raw)
    assert tuned_plan == res.chosen_plan
    assert dep.replan(res.bucket).plan == res.chosen_plan
    builds0 = runtime.cache_stats()["builds"]
    x = np.random.default_rng(3).uniform(-1, 1, (32, res.dims[0]))
    y_tuned = kan_network_deploy_apply(dep, x, backend="fused")
    assert runtime.cache_stats()["builds"] == builds0  # warm entry hit
    runtime.PLAN_CACHE.set_tile_overrides(res.dims, res.specs,
                                          res.residual_raw, None)
    y_heur = kan_network_deploy_apply(dep, x, backend="fused")
    assert torch.equal(y_tuned, y_heur)


def test_heuristic_win_registers_nothing():
    _, dep = _kan1()
    res = tune.tune_tiles(dep, batch=32, max_candidates=8, seed=0)
    assert res.mode == "proxy" and not res.tuned and not res.registered
    assert res.chosen_plan == res.heuristic_plan
    assert runtime.PLAN_CACHE.tile_overrides() == {}
    assert res.to_dict()["overrides"] is None
