"""The port's ACIM non-ideality models (TM-DV, cim, KAN-SAM) vs the JAX package.

  * the behavioral properties of ``tests/test_tmdv_cim_sam.py`` on the
    port: the noiseless TM-DV identity, the latency and noise orderings of
    the input generators, IR-drop error growing with array size, K+1
    active bases, SAM's heavy rows at the compensated mean, SAM lowering
    the MAC error;
  * ``basis_activation_probability`` / ``row_activation_weight`` equal the
    reference's within 1e-6 and ``sam_permutation`` exactly;
  * deterministic ``cim_matmul`` (both ADC rangings, natural and SAM
    placement) against the reference's under its ADC contract
    (``_assert_adc_close`` of ``tests/test_kernels_cim_mac.py``: every
    element within one ADC LSB per array, >= 95% tight);
  * ``apply_input_noise``: Threefry and Philox draw different numbers, so
    the mean and variance of ``eff - codes`` over 1e5 codes are held to
    the reference's within 5 standard errors, per TM-DV mode.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.core import sam as jsam
from repro.core import tmdv as jtmdv
from repro.core.asp_quant import ASPQuantSpec as JSpec
from repro_torch import convert
from repro_torch.core.asp_quant import (
    ASPQuantSpec,
    build_lut,
    dense_basis_from_codes,
    quantize_input,
)
from repro_torch.core.cim import CIMConfig, cim_matmul, ideal_matmul
from repro_torch.core.sam import (
    apply_row_permutation,
    basis_activation_probability,
    identity_permutation,
    row_activation_weight,
    sam_permutation,
)
from repro_torch.core.tmdv import (
    PURE_PWM,
    PURE_VOLTAGE,
    TD_A,
    TD_P,
    TMDVConfig,
    apply_input_noise,
    wl_latency_units,
)
from repro_torch.kernels.cim_mac.cardcheck import assert_adc_close

torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _mac_operands(b, r, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255.0, (b, r)).astype(np.float32)
    w = rng.integers(-127, 128, (r, c)).astype(np.float32)
    return x, w


# ----------------------------------------------------------------------------
# TM-DV input generator
# ----------------------------------------------------------------------------


def test_tmdv_noiseless_is_linear_identity():
    cfg = dataclasses.replace(TD_A(8), sigma_v_ref=0.0, sigma_t=0.0)
    q = apply_input_noise(torch.arange(256), cfg, _gen())
    np.testing.assert_allclose(q.numpy(), np.arange(256), atol=1e-5)


def test_tmdv_latency_ordering():
    assert wl_latency_units(PURE_VOLTAGE(8)) == 1
    assert wl_latency_units(TMDVConfig(8, 4)) == 16
    assert wl_latency_units(PURE_PWM(8)) == 256
    for make in (TD_A, TD_P, PURE_VOLTAGE, PURE_PWM):
        assert wl_latency_units(make(8)) \
            == jtmdv.wl_latency_units(getattr(jtmdv, make.__name__)(8))


@pytest.mark.parametrize("noisier,quieter", [
    (TD_P(8), TD_A(8)), (PURE_VOLTAGE(8), TMDVConfig(8, 4)),
])
def test_input_generator_noise_ordering(noisier, quieter):
    """TD-A is cleaner than TD-P, TM-DV cleaner than pure voltage."""
    codes = torch.arange(256).repeat(200)
    err = [float((apply_input_noise(codes, cfg, _gen(1)) - codes).abs().mean())
           for cfg in (noisier, quieter)]
    assert err[0] > err[1], err


@pytest.mark.parametrize("mode", ["TD_A", "TD_P", "PURE_VOLTAGE", "PURE_PWM",
                                  "TMDV_4_4"])
def test_input_noise_statistics_match_reference(mode):
    if mode == "TMDV_4_4":
        tcfg, jcfg = TMDVConfig(8, 4), jtmdv.TMDVConfig(8, 4)
    else:
        tcfg = globals()[mode](8)
        jcfg = getattr(jtmdv, mode)(8)
    assert convert.tmdv_config_from_reference(jcfg) == tcfg
    codes = np.random.default_rng(3).integers(0, 256, 100_000)
    e_t = (apply_input_noise(torch.from_numpy(codes), tcfg, _gen(5)).numpy()
           - codes).astype(np.float64)
    e_j = (np.asarray(jtmdv.apply_input_noise(jnp.asarray(codes), jcfg,
                                              jax.random.PRNGKey(5)))
           - codes).astype(np.float64)
    n = len(codes)
    se_mean = np.sqrt(e_t.var() / n + e_j.var() / n)
    assert abs(e_t.mean() - e_j.mean()) < 5 * se_mean, (e_t.mean(), e_j.mean())
    # variance of a mixture (the level noise scales with the code): its
    # standard error from the fourth moment of each sample
    v_t, v_j = (e_t ** 2).mean(), (e_j ** 2).mean()
    se_var = np.sqrt((e_t ** 2).var() / n + (e_j ** 2).var() / n)
    assert abs(v_t - v_j) < 5 * se_var, (v_t, v_j, se_var)


# ----------------------------------------------------------------------------
# cim_matmul
# ----------------------------------------------------------------------------


def test_ir_drop_error_grows_with_array_size():
    """Monotone in array size (paper Fig. 12), over a 64x64 MAC with
    independent draws per size."""
    errs = []
    for rows in [128, 256, 512, 1024]:
        x, w = (torch.from_numpy(a) for a in _mac_operands(64, rows, 64, rows))
        cfg = CIMConfig(array_rows=rows, adc_bits=12, ir_gamma=0.04,
                        deterministic=True)
        y = cim_matmul(x, w, cfg)
        yi = ideal_matmul(x, w)
        errs.append(float((y - yi).abs().mean() / yi.abs().mean()))
    assert errs == sorted(errs), errs


def test_noisy_cim_matmul_needs_a_generator_and_reproduces():
    x, w = (torch.from_numpy(a) for a in _mac_operands(8, 200, 5, 0))
    cfg = CIMConfig(array_rows=128)
    with pytest.raises(ValueError, match="Generator"):
        cim_matmul(x, w, cfg)
    a, b = (cim_matmul(x, w, cfg, _gen(2)) for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, cim_matmul(x, w, cfg, _gen(3)))


@pytest.mark.parametrize("case", [(16, 300, 20, 128), (8, 1024, 14, 256),
                                  (130, 136, 1, 128), (4, 50, 3, 512)])
@pytest.mark.parametrize("calibrate", [False, True])
@pytest.mark.parametrize("sam_perm", [False, True])
def test_deterministic_cim_matmul_matches_reference(case, calibrate, sam_perm):
    bsz, r, c, rows = case
    x, w = _mac_operands(bsz, r, c, seed=r + c)
    perm = None
    if sam_perm:
        perm = sam_permutation(np.random.default_rng(1).random(r), rows)
    tcfg = CIMConfig(array_rows=rows, adc_bits=10, ir_gamma=0.04,
                     deterministic=True)
    jcfg = jcim.CIMConfig(array_rows=rows, adc_bits=10, ir_gamma=0.04,
                          deterministic=True)
    assert convert.cim_config_from_reference(jcfg) == tcfg
    out = cim_matmul(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                     row_perm=perm, adc_calibrate=calibrate)
    ref = jcim.cim_matmul(jnp.asarray(x), jnp.asarray(w), jcfg,
                          jax.random.PRNGKey(0), row_perm=perm,
                          adc_calibrate=calibrate)
    wp = w if perm is None else w[perm]
    assert_adc_close(out.numpy(), np.asarray(ref), wp, rows, 10)


# ----------------------------------------------------------------------------
# KAN-SAM
# ----------------------------------------------------------------------------


def test_activation_probability_k_plus_1_active():
    spec = ASPQuantSpec(grid_size=8, order=3, n_bits=8, lo=-1.0, hi=1.0)
    x = torch.from_numpy(
        np.random.default_rng(0).uniform(-1, 1, 4000).astype(np.float32))
    p = basis_activation_probability(x, spec)
    assert p.shape == (11,)
    np.testing.assert_allclose(float(p.sum()), spec.order + 1, atol=1e-5)
    assert p[0] < p[5] and p[-1] < p[5]


@pytest.mark.parametrize("grid,f", [(8, 3), (5, 17), (30, 17), (68, 17)])
def test_sam_statistics_match_reference(grid, f):
    spec = ASPQuantSpec(grid_size=grid, order=3, n_bits=8, lo=-1.0, hi=1.0)
    jspec = JSpec(grid_size=grid, order=3, n_bits=8, lo=-1.0, hi=1.0)
    x = np.clip(np.random.default_rng(grid).normal(0, 0.4, (2000, f)),
                -1, 1).astype(np.float32)
    p_t = basis_activation_probability(torch.from_numpy(x[:, 0]), spec)
    p_j = jsam.basis_activation_probability(jnp.asarray(x[:, 0]), jspec)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    rw_t = row_activation_weight(torch.from_numpy(x), spec, f)
    rw_j = jsam.row_activation_weight(jnp.asarray(x), jspec, f)
    np.testing.assert_allclose(rw_t.numpy(), np.asarray(rw_j), atol=1e-6)
    for rows in (None, 128, 1024):
        np.testing.assert_array_equal(sam_permutation(rw_j, rows),
                                      jsam.sam_permutation(rw_j, rows))
        np.testing.assert_array_equal(sam_permutation(rw_t, rows),
                                      jsam.sam_permutation(rw_t.numpy(), rows))


def test_sam_puts_probable_rows_at_compensated_mean():
    spec = ASPQuantSpec(grid_size=8, order=3, n_bits=8, lo=-1.0, hi=1.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        np.clip(rng.normal(0, 0.3, (4000, 3)), -1, 1).astype(np.float32))
    rw = row_activation_weight(x, spec, 3)
    perm = sam_permutation(rw)
    w = rw.numpy()
    r = len(w)
    dist = (np.arange(r) + 1.0) / r
    order = np.argsort(np.abs(dist - (r + 1.0) / (2.0 * r)), kind="stable")
    assert w[perm[order[0]]] == w.max()
    assert (np.diff(w[perm[order]]) <= 1e-9).all()
    assert sorted(perm) == list(range(r))
    rows = torch.arange(r * 2, dtype=torch.float32).reshape(r, 2)
    assert torch.equal(apply_row_permutation(rows, perm), rows[perm])
    assert torch.equal(apply_row_permutation(rows, identity_permutation(r)),
                       rows)


def test_sam_improves_accuracy_under_ir_drop():
    """The Fig. 12 mechanism: same MAC, SAM placement, lower error."""
    spec = ASPQuantSpec(grid_size=30, order=3, n_bits=8, lo=-1.0, hi=1.0)
    rng = np.random.default_rng(0)
    f = 17
    xs = torch.from_numpy(
        np.clip(rng.normal(0, 0.35, (256, f)), -1, 1).astype(np.float32))
    e = build_lut(spec)
    lut = torch.from_numpy((e["lut_q"] * e["scale"]).astype(np.float32))
    basis = dense_basis_from_codes(quantize_input(xs, spec), lut, spec)
    drives = basis.reshape(256, -1) * 255.0
    w = torch.from_numpy(
        rng.integers(-127, 128, (f * spec.num_basis, 14)).astype(np.float32))
    ideal = ideal_matmul(drives, w)
    cfg = CIMConfig(array_rows=512, adc_bits=10, ir_gamma=0.08,
                    deterministic=True)
    base = cim_matmul(drives, w, cfg, x_max=255.0, adc_calibrate=True)
    perm = sam_permutation(row_activation_weight(xs, spec, f), 512)
    sam = cim_matmul(drives, w, cfg, row_perm=perm, x_max=255.0,
                     adc_calibrate=True)
    err_base = float((base - ideal).abs().mean())
    err_sam = float((sam - ideal).abs().mean())
    assert err_sam < err_base, (err_sam, err_base)
