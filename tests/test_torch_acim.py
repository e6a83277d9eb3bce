"""The port's "acim" backend vs its "fused" backend and the JAX package.

  * a quiet ``CIMConfig`` (every non-ideality zeroed) is bit-identical to
    "fused" within the port (outputs and boundary codes), and matches the
    reference's quiet acim under the ``repro_torch.parity`` gate;
  * the IR-drop-only config (``deterministic=True``), in natural order and
    at KAN-SAM placements, matches the reference's acim on the converted
    bundle under the parity gate, with the pre-round values of the gained
    weights (``parity.irdrop_bundle``);
  * ``_irdrop_row_gain`` equals the reference's and ``_layer_psum_std``
    is within 1e-6 relative;
  * noise is reproducible under one generator, differs under another,
    and ``generator=None`` is deterministic for one input (the serving
    path's digest seed);
  * the partial-sum noise reaches the output with the analytic sigma
    (within 5% at 16384 rows, sampling error ~0.6%);
  * the smoke ``kan_variant()`` served with ``kan_backend="acim"``: quiet
    streams equal "fused", the default config streams the same tokens
    twice, and ``--backend acim`` serves from the CLI.

Bundles are deployed by the JAX package and converted through numpy;
inputs are made with numpy from a seed.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kan1_bundle
from repro import runtime as jrt
from repro.core.cim import CIMConfig as JCIMConfig
from repro.core.kan_network_deploy import kan_network_deploy_apply as j_apply
from repro.runtime.executor import ACIMExecutor as JACIMExecutor
from repro.runtime.executor import _irdrop_row_gain as j_row_gain
from repro_torch import convert, parity, runtime
from repro_torch.core.cim import CIMConfig
from repro_torch.core.kan_layer import KANSpec, init_kan_network
from repro_torch.core.kan_network_deploy import (
    deploy_kan_network,
    kan_network_deploy_apply,
    quantize_kan_network,
)
from repro_torch.core.sam import row_activation_weight, sam_permutation
from repro_torch.runtime.executor import (
    ACIMExecutor,
    _entry_codes,
    _irdrop_row_gain,
)

torch.set_num_threads(1)

MODELS = {"kan1": dict(grid=5), "kan2": dict(grid=68),
          "kan1_mixed_8_4": dict(grid=5, n_bits=(8, 4))}
IR_ONLY = dict(ir_gamma=0.06, deterministic=True)


@pytest.fixture(autouse=True)
def _fresh_cache():
    runtime.reset_cache()
    yield
    runtime.reset_cache()


@pytest.fixture(scope="module")
def bundles():
    """name -> (reference bundle, port bundle on the CPU)."""
    out = {}
    for name, kw in MODELS.items():
        _, _, jdep = kan1_bundle(**kw)
        out[name] = (jdep, convert.deployed_from_reference(jdep, device="cpu"))
    return out


def _x(b, f=17, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (b, f)) \
        .astype(np.float32)


def _sam_perms(dep, x, cfg):
    """Per-layer KAN-SAM placements from each layer's inputs: the request
    rows for layer 0, the fused run's dequantized boundary codes after."""
    _, codes = runtime.execute(dep, x, backend="fused",
                               return_intermediates=True)
    inputs = [torch.from_numpy(x)] + [
        lp.spec.lo + c.to(torch.float32) * lp.spec.code_step
        for lp, c in zip(dep.plan.layers[1:], codes)]
    return tuple(
        sam_permutation(row_activation_weight(h, lp.spec, lp.f),
                        cfg.array_rows)
        for lp, h in zip(dep.plan.layers, inputs))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------------
# quiet and deterministic configs
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_quiet_acim_is_fused_bit_for_bit_and_matches_reference(bundles, name):
    jdep, dep = bundles[name]
    x = _x(37, seed=3)
    y_f, c_f = runtime.execute(dep, x, backend="fused",
                               return_intermediates=True)
    y_a, c_a = kan_network_deploy_apply(
        dep, x, backend="acim", cim=runtime.quiet_cim_config(),
        generator=_gen(9), return_intermediates=True)
    assert torch.equal(y_a, y_f)
    assert all(torch.equal(a, f) for a, f in zip(c_a, c_f))
    jy, jc = j_apply(jdep, jnp.asarray(x), interpret=True, backend="acim",
                     cim=jrt.quiet_cim_config(), return_intermediates=True)
    assert convert.cim_config_from_reference(jrt.quiet_cim_config()) \
        == runtime.quiet_cim_config()
    want = [np.asarray(c) for c in jc]
    pre = parity.boundary_prerounds(dep, _entry(dep, x), None, want)
    parity.compare_runs(c_a, want, pre, y_a, np.asarray(jy))


def _entry(dep, x):
    return _entry_codes(dep, torch.from_numpy(x), None)[0]


@pytest.mark.parametrize("sam", [False, True], ids=["natural", "sam"])
@pytest.mark.parametrize("name", list(MODELS))
def test_irdrop_only_matches_reference(bundles, name, sam):
    jdep, dep = bundles[name]
    x = _x(41, seed=5)
    cfg = CIMConfig(**IR_ONLY)
    perms = _sam_perms(dep, x, cfg) if sam else None
    y, codes = kan_network_deploy_apply(dep, x, backend="acim", cim=cfg,
                                        sam_perms=perms,
                                        return_intermediates=True)
    y_f = runtime.execute(dep, x, backend="fused")
    assert (y - y_f).abs().max() > 0  # the gains are applied
    jy, jc = j_apply(jdep, jnp.asarray(x), interpret=True, backend="acim",
                     cim=JCIMConfig(**IR_ONLY), sam_perms=perms,
                     return_intermediates=True)
    want = [np.asarray(c) for c in jc]
    gained = parity.irdrop_bundle(dep, cfg, perms)
    pre = parity.boundary_prerounds(gained, _entry(dep, x), None, want)
    st = parity.compare_runs(codes, want, pre, y, np.asarray(jy))
    print(f"{name} sam={sam}: {st}")


def test_irdrop_row_gain_and_psum_std_match_reference(bundles):
    for jdep, dep in bundles.values():
        for cfg_kw in (dict(ir_gamma=0.06), dict(ir_gamma=0.1, array_rows=512),
                       dict(ir_gamma=0.0)):
            tcfg, jcfg = CIMConfig(**cfg_kw), JCIMConfig(**cfg_kw)
            for lp, jlp in zip(dep.plan.layers, jdep.plan.layers):
                n = lp.f * lp.spec.num_basis
                perm = np.random.default_rng(n).permutation(n)
                for p in (None, perm):
                    got, want = _irdrop_row_gain(lp, tcfg, p), \
                        j_row_gain(jlp, jcfg, p)
                    if want is None:
                        assert got is None
                    else:
                        np.testing.assert_array_equal(got, want)
            cfg_ps = dict(sigma_ps_ref=0.05, **cfg_kw)
            for lp, jlp, lw, jlw in zip(dep.plan.layers, jdep.plan.layers,
                                        dep.layers, jdep.layers):
                got = ACIMExecutor._layer_psum_std(CIMConfig(**cfg_ps), lp, lw)
                want = np.asarray(JACIMExecutor._layer_psum_std(
                    JCIMConfig(**cfg_ps), jlp, jlw))
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=0)


# ----------------------------------------------------------------------------
# noise
# ----------------------------------------------------------------------------


def test_noise_is_seeded_and_reproducible(bundles):
    _, dep = bundles["kan1"]
    x = _x(6, seed=4)
    cim = CIMConfig(ir_gamma=0.06, sigma_ps_ref=0.05)
    y_f = runtime.execute(dep, x, backend="fused")

    def run(gen=None, xx=x):
        return kan_network_deploy_apply(dep, xx, backend="acim", cim=cim,
                                        generator=gen)

    y1, y2, y3 = run(_gen(0)), run(_gen(0)), run(_gen(1))
    assert torch.equal(y1, y2)
    assert (y1 - y3).abs().max() > 0
    assert (y1 - y_f).abs().max() > 0  # noise actually injected
    # no generator: seeded from the entry codes, so one input reproduces
    # and another decorrelates
    assert torch.equal(run(), run())
    assert not torch.equal(run(), run(xx=_x(6, seed=5)))
    # the default executor's config is the one named in its docstring
    assert runtime.get_executor("acim").cim \
        == CIMConfig(ir_gamma=0.06, sigma_ps_ref=0.05)


def test_deterministic_flag_keeps_irdrop_only(bundles):
    _, dep = bundles["kan1"]
    x = _x(6, seed=5)
    cim = CIMConfig(ir_gamma=0.06, sigma_ps_ref=0.05, deterministic=True)
    y1 = kan_network_deploy_apply(dep, x, backend="acim", cim=cim,
                                  generator=_gen(0))
    y2 = kan_network_deploy_apply(dep, x, backend="acim", cim=cim)
    assert torch.equal(y1, y2)
    assert (y1 - runtime.execute(dep, x, backend="fused")).abs().max() > 0


def test_psum_noise_has_the_analytic_sigma():
    """One (17, 14) layer, psum noise only: y_acim - y_fused is the noise,
    whose per-channel std must be ``_layer_psum_std`` (within 5%)."""
    kspec = KANSpec(dims=(17, 14), grid_size=5)
    qp = quantize_kan_network(
        init_kan_network(_gen(0), kspec, device="cpu"), kspec)
    dep = deploy_kan_network(qp, kspec, device="cpu")
    cfg = CIMConfig(ir_gamma=0.0, sigma_ps_ref=0.05,
                    input_gen=runtime.quiet_cim_config().input_gen)
    x = _x(16384, seed=7)
    diff = (kan_network_deploy_apply(dep, x, backend="acim", cim=cfg,
                                     generator=_gen(3))
            - runtime.execute(dep, x, backend="fused")).double()
    lp = dep.plan.layers[0]
    want = ACIMExecutor._layer_psum_std(cfg, lp, dep.layers[0])[: lp.o]
    got = diff.std(dim=0)
    assert (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=0.05)


def test_packed_layer_with_irdrop_runs_unpacked_weights(bundles):
    """IR-drop on an int4-packed layer: the gained f32 weights replace the
    packed codes, equal to the unpacked-bundle run bit for bit."""
    _, dep = bundles["kan1_mixed_8_4"]
    assert "wcp" in dep.layers[1]
    x = _x(19, seed=8)
    cfg = CIMConfig(**IR_ONLY)
    y = kan_network_deploy_apply(dep, x, backend="acim", cim=cfg)
    y_g = runtime.execute(parity.irdrop_bundle(dep, cfg), x, backend="fused")
    assert torch.equal(y, y_g)


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params

    cfg = smoke_config("qwen2.5-14b").kan_variant()
    return cfg, init_params(_gen(0), cfg, device="cpu")


def _serve(lm, backend):
    from repro_torch.serve import Request, ServeEngine

    cfg, params = lm
    eng = ServeEngine(params, cfg, slots=2, max_len=48, kan_deploy=True,
                      kan_backend=backend, device="cpu")
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, n).tolist(),
                    max_new_tokens=5) for i, n in enumerate((6, 13, 9))]
    return {r.rid: list(r.output) for r in eng.run(reqs)}


@contextlib.contextmanager
def _acim_registered_as(executor):
    """Register ``executor`` under "acim" and restore the default after."""
    default = runtime.get_executor("acim")
    runtime.register_executor("acim", executor)
    try:
        yield
    finally:
        runtime.register_executor("acim", default)


def test_served_acim_streams(lm):
    """Quiet acim serves the fused tokens; the default config is a
    function of the requests (two runs, one stream)."""
    fused = _serve(lm, "fused")
    with _acim_registered_as(ACIMExecutor(cim=runtime.quiet_cim_config())):
        runtime.reset_dispatch_counts()
        assert _serve(lm, "acim") == fused
        assert set(runtime.dispatch_counts()) == {"acim"}
    assert runtime.get_executor("acim").cim.ir_gamma == 0.06
    noisy = _serve(lm, "acim")
    assert _serve(lm, "acim") == noisy
    assert sorted(map(len, noisy.values())) == [5, 5, 5]


def test_cli_serves_with_the_acim_backend():
    from repro_torch.launch import serve as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--arch", "qwen2.5-14b", "--kan-ffn", "--backend", "acim",
                  "--requests", "2", "--slots", "2", "--max-new", "3",
                  "--device", "cpu"])
    out = buf.getvalue()
    assert "served requests=2" in out and "kan_backend=acim" in out, out
