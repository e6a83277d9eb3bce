"""repro_torch.runtime: resolution, bucketing, cache counters, and the slice.

  * backend precedence (argument > ``use_backend`` > ``REPRO_KAN_BACKEND`` >
    default) and the ``"pallas"`` alias of ``"fused"``;
  * the plan cache cases of ``test_runtime.py``: ragged batches share one
    bucket and one built entry, keys separate specs / residual_raw /
    backends, replan is a lookup;
  * the slice end to end: KAN1, KAN2, mixed (8, 4) and the FFN stack, each
    deployed by the JAX package, converted, and run through
    ``repro_torch.runtime.execute`` against the reference's
    ``runtime.execute`` (Pallas interpret mode) on the same input.  Outputs
    within 1e-5; boundary codes (and the FFN's tanh entry codes, computed
    by each package) equal up to the excused near-ties of
    ``repro_torch.parity``, whose count the test prints.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import kan1_bundle
from repro import runtime as jrt
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.core.kan_network_deploy import quantize_kan_network as j_quantize
from repro.runtime.executor import _entry_codes as j_entry_codes
from repro_torch import convert, parity, runtime
from repro_torch.core.kan_layer import KANSpec, init_kan_network, kan_network_apply
from repro_torch.core.kan_network_deploy import (
    deploy_kan_ffn_stack,
    deploy_kan_network,
    kan_network_apply_ref,
    kan_network_deploy_apply,
    quantize_kan_network,
)
from repro_torch.data.knot import make_knot_dataset
from repro_torch.runtime.executor import _entry_codes as t_entry_codes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache():
    runtime.reset_cache()
    runtime.reset_dispatch_counts()
    yield
    runtime.reset_cache()


def _kan1(grid=5, bits=8, dims=(17, 1, 14), seed=0):
    kspec = KANSpec(dims=dims, grid_size=grid, n_bits=bits)
    params = init_kan_network(torch.Generator().manual_seed(seed), kspec,
                              device="cpu")
    qparams = quantize_kan_network(params, kspec)
    return kspec, qparams, deploy_kan_network(qparams, kspec, batch=8,
                                              device="cpu")


def _x(b, f=17, seed=1):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, (b, f)).astype(np.float32))


# ----------------------------------------------------------------------------
# registry / resolution
# ----------------------------------------------------------------------------


def test_registry_and_pallas_alias():
    assert set(runtime.available_backends()) == {"ref", "fused", "pallas",
                                                 "acim"}
    assert runtime.resolve_backend("pallas") == "fused"
    assert runtime.get_executor("pallas") is runtime.get_executor("fused")


def test_resolution_precedence(monkeypatch):
    assert runtime.resolve_backend("ref") == "ref"
    assert runtime.resolve_backend(None) == "fused"
    monkeypatch.setenv(runtime.ENV_BACKEND_VAR, "ref")
    assert runtime.resolve_backend(None, default="fused") == "ref"
    with runtime.use_backend("pallas"):        # scope beats env
        assert runtime.resolve_backend(None) == "fused"
        with runtime.use_backend(None):        # None scope is a passthrough
            assert runtime.resolve_backend(None) == "fused"
        assert runtime.resolve_backend("ref") == "ref"  # arg beats all
    assert runtime.resolve_backend(None) == "ref"
    monkeypatch.setenv(runtime.ENV_BACKEND_VAR, "pallas")
    assert runtime.resolve_backend(None, default="ref") == "fused"
    monkeypatch.setenv(runtime.ENV_BACKEND_VAR, "")
    assert runtime.resolve_backend(None, default="ref") == "ref"


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        runtime.resolve_backend("tpu-magic")
    with pytest.raises(ValueError):
        with runtime.use_backend("no-such-backend"):
            pass
    kspec, qparams, _ = _kan1()
    with pytest.raises(ValueError):
        kan_network_apply(None, _x(4), kspec, quantized=True,
                          qparams_list=qparams, backend="tpu-magic",
                          device="cpu")


def test_env_var_reroutes_kan_network_apply(monkeypatch):
    kspec, qparams, _ = _kan1()
    x = _x(6)
    monkeypatch.setenv(runtime.ENV_BACKEND_VAR, "pallas")
    y = kan_network_apply(None, x, kspec, quantized=True, qparams_list=qparams,
                          device="cpu")
    assert runtime.dispatch_counts() == {"fused": 1}
    ref = kan_network_apply_ref(qparams, x, kspec)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------------
# plan cache
# ----------------------------------------------------------------------------


def test_ragged_batches_share_one_bucket_and_one_build():
    kspec, qparams, dep = _kan1()
    for bsz in (3, 5, 7, 8):
        x = _x(bsz, seed=bsz)
        y = kan_network_deploy_apply(dep, x)
        assert y.shape == (bsz, 14)
        ref = kan_network_apply_ref(qparams, x, kspec)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert runtime.cache_stats() == {"hits": 3, "misses": 1, "builds": 1,
                                     "entries": 1}
    assert runtime.dispatch_counts() == {"fused": 4}


def test_bucket_batch_rounds_to_powers_of_two():
    assert [runtime.bucket_batch(b) for b in (1, 3, 8, 9, 130)] == \
        [8, 8, 8, 16, 256]
    with pytest.raises(ValueError):
        runtime.bucket_batch(0)


def test_cache_keys_distinguish_spec_residual_and_backend():
    x = _x(4)
    _, _, dep_g5 = _kan1(grid=5)
    _, _, dep_g8 = _kan1(grid=8)
    kan_network_deploy_apply(dep_g5, x)
    kan_network_deploy_apply(dep_g8, x)
    stats = runtime.cache_stats()
    assert stats["entries"] == 2 and stats["builds"] == 2, stats

    kspec = KANSpec(dims=(17, 17, 17), grid_size=5)
    qparams = quantize_kan_network(init_kan_network(
        torch.Generator().manual_seed(1), kspec, device="cpu"), kspec)
    dep_kan = deploy_kan_network(qparams, kspec, batch=4, device="cpu")
    dep_ffn = deploy_kan_ffn_stack(qparams, kspec.dims, kspec.layer_spec(),
                                   batch=4, device="cpu")
    runtime.reset_cache()
    kan_network_deploy_apply(dep_kan, x)
    kan_network_deploy_apply(dep_ffn, x)
    stats = runtime.cache_stats()
    assert stats["entries"] == 2 and stats["hits"] == 0, stats

    runtime.reset_cache()
    kan_network_deploy_apply(dep_g5, x, backend="fused")
    kan_network_deploy_apply(dep_g5, x, backend="ref")
    kan_network_deploy_apply(dep_g5, x, backend="pallas")
    stats = runtime.cache_stats()
    assert stats["entries"] == 2 and stats["hits"] == 1, stats


def test_replan_is_a_cache_lookup():
    _, _, dep = _kan1()
    dep2, dep3 = dep.replan(640), dep.replan(640)
    assert dep2.plan is dep3.plan
    assert dep2.layers is dep.layers
    assert dep2.plan.b == 640


def test_input_on_another_device_is_refused():
    _, _, dep = _kan1()
    with pytest.raises(ValueError, match="bundle on"):
        kan_network_deploy_apply(dep, _x(3).to("meta"))


# ----------------------------------------------------------------------------
# the slice against the reference
# ----------------------------------------------------------------------------


def _jax_ffn_bundle(batch):
    jk = JKANSpec(dims=(64, 128, 64), grid_size=8)
    qparams = j_quantize(j_init(jax.random.PRNGKey(0), jk), jk)
    return j_deploy_ffn(qparams, jk.dims, jk.layer_spec(), batch=batch)


SLICE = {
    "kan1": lambda b: kan1_bundle(batch=b)[2],
    "kan2": lambda b: kan1_bundle(batch=b, grid=68)[2],
    "kan1_mixed_8_4": lambda b: kan1_bundle(n_bits=(8, 4), batch=b)[2],
    "ffn_64_128_64_g8": _jax_ffn_bundle,
}


def _requests(name, b, seed):
    if name.startswith("ffn"):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(b, 64)) * 0.7).astype(np.float32)
    x, _, _, _ = make_knot_dataset(n_train=b, n_test=1, seed=seed)
    return x


@pytest.mark.parametrize("name", sorted(SLICE))
@pytest.mark.parametrize("batch", [3, 130])
def test_slice_matches_reference_runtime(name, batch):
    jdep = SLICE[name](batch)
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    x = _requests(name, batch, seed=batch)
    jy, jcodes = jrt.execute(jdep, x, backend="pallas", interpret=True,
                             return_intermediates=True)
    ty, tcodes = runtime.execute(tdep, x, return_intermediates=True)
    assert runtime.dispatch_counts() == {"fused": 1}
    assert ty.shape == (batch, tdep.dims[-1]) and ty.dtype == torch.float32
    j_entry, j_raw = j_entry_codes(jdep, jax.numpy.asarray(x), None)
    t_entry, _ = t_entry_codes(tdep, torch.from_numpy(x), None)
    want_codes = [torch.tensor(np.asarray(c)) for c in (j_entry, *jcodes)]
    pre = [parity.entry_preround(tdep, x)] + parity.boundary_prerounds(
        tdep, want_codes[0], None if j_raw is None else torch.tensor(np.asarray(j_raw)),
        want_codes[1:])
    stats = parity.compare_runs([t_entry, *tcodes], want_codes, pre, ty,
                                np.asarray(jy))
    print(f"{name} b={batch}: {stats}")
    assert stats["rows_left_out"] <= max(1, batch // 50), stats


@pytest.mark.parametrize("name", ["kan1", "kan1_mixed_8_4"])
def test_ref_backend_matches_reference_ref(name):
    jdep = SLICE[name](9)
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    x = _requests(name, 9, seed=4)
    jy, jcodes = jrt.execute(jdep, x, backend="ref", return_intermediates=True)
    ty, tcodes = runtime.execute(tdep, x, backend="ref", return_intermediates=True)
    want = [torch.tensor(np.asarray(c)) for c in jcodes]
    j_entry, _ = j_entry_codes(jdep, jax.numpy.asarray(x), None)
    pre = parity.boundary_prerounds(tdep, torch.tensor(np.asarray(j_entry)),
                                    None, want)
    parity.compare_runs(tcodes, want, pre, ty, np.asarray(jy))


def test_fused_and_ref_agree_within_the_port():
    kspec, qparams, dep = _kan1(dims=(5, 9, 3, 2), grid=8)
    x = _x(40, f=5)
    got = runtime.execute(dep, x, return_intermediates=True)
    want = runtime.execute(dep, x, backend="ref", return_intermediates=True)
    t_entry, _ = t_entry_codes(dep, x, None)
    pre = parity.boundary_prerounds(dep, t_entry, None, want[1])
    parity.compare_runs(got[1], want[1], pre, got[0], want[0])
    assert runtime.dispatch_counts() == {"fused": 1, "ref": 1}
