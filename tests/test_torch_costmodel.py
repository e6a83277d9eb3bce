"""The port's cost model (``core/costmodel.py``, ``neurosim.kan_cost``)
against the JAX package's, and the reference's own cost-model cases.

  * every cost function returns the same float as the reference's (exact
    equality, no tolerance: the port is the same Python arithmetic) on the
    Fig. 10, 11 and 13 cases of ``tests/test_costmodel_neurosim.py`` and on
    a sweep of G 1..60, n_bits {4, 6, 8}, voltage bits 2..5 and array rows
    {128, 256, 512, 1024}; where the reference raises (a G that does not
    fit the bit budget), the port raises the same ``ValueError``;
  * the port passes the reference's single-device cost-model tests itself
    (the paper bands, monotonicity, the step-1 constraint loop).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import costmodel as jcm
from repro.core import neurosim as jns
from repro.core.asp_quant import ASPQuantSpec as JSpec
from repro.core.tmdv import PURE_PWM as J_PWM
from repro.core.tmdv import PURE_VOLTAGE as J_PV
from repro.core.tmdv import TMDVConfig as JTMDV
from repro_torch.core import costmodel as tcm
from repro_torch.core import neurosim as tns
from repro_torch.core.asp_quant import ASPQuantSpec
from repro_torch.core.tmdv import PURE_PWM, PURE_VOLTAGE, TMDVConfig

KAN1 = (17, 1, 14)
MLP = (17, 420, 420, 14)


def _both(fn_name, *args, **kw):
    """(reference result or its ValueError text, port result or text)."""
    out = []
    for mod, spec_t, tm_t in ((jcm, JSpec, JTMDV), (tcm, ASPQuantSpec, TMDVConfig)):
        conv = [a(spec_t, tm_t) if callable(a) else a for a in args]
        try:
            out.append(getattr(mod, fn_name)(*conv, **kw))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def _spec(*a, **kw):
    return lambda S, T: S(*a, **kw)


@pytest.mark.parametrize("g", (8, 16, 32, 64))
def test_fig10_bx_paths_equal_the_reference(g):
    for fn in ("bx_path_conventional", "bx_path_asp", "bx_retrieval_latency_ns"):
        ref, port = _both(fn, _spec(grid_size=g, order=3, n_bits=8, lo=0.0,
                                    hi=1.0))
        assert port == ref, (fn, g)


def test_fig11_input_generators_equal_the_reference():
    cases = [(J_PV(6), PURE_VOLTAGE(6)), (J_PWM(6), PURE_PWM(6)),
             (JTMDV(6, 3), TMDVConfig(6, 3)), (J_PV(8), PURE_VOLTAGE(8)),
             (J_PWM(8), PURE_PWM(8))]
    for jc, tc in cases:
        assert tcm.input_generator_cost(tc) == jcm.input_generator_cost(jc)


def test_fig13_accelerators_equal_the_reference():
    ref_mlp = jcm.accelerator_cost(jcm.mlp_accelerator(MLP, J_PWM(8)))
    port_mlp = tcm.accelerator_cost(tcm.mlp_accelerator(MLP, PURE_PWM(8)))
    assert port_mlp == ref_mlp
    for g, rows, adc in ((5, 128, 8), (68, 1024, 10)):
        ref = jcm.accelerator_cost(jcm.kan_accelerator(
            KAN1, JSpec(g, 3, 8, 8, -1.0, 1.0), JTMDV(8, 4), rows,
            adc_bits=adc))
        port = tcm.accelerator_cost(tcm.kan_accelerator(
            KAN1, ASPQuantSpec(g, 3, 8, 8, -1.0, 1.0), TMDVConfig(8, 4),
            rows, adc_bits=adc))
        assert port == ref, g
    # the layer geometry the cost is built from, field for field
    ja = jcm.kan_accelerator(KAN1, JSpec(5, 3, 8), JTMDV(8, 4), 128,
                             layer_bits=(8, 4))
    ta = tcm.kan_accelerator(KAN1, ASPQuantSpec(5, 3, 8), TMDVConfig(8, 4),
                             128, layer_bits=(8, 4))
    assert [dataclasses.asdict(l) for l in ta.layers] == \
        [dataclasses.asdict(l) for l in ja.layers]


@pytest.mark.parametrize("n_bits", (4, 6, 8))
def test_kan_cost_sweep_equals_the_reference(n_bits):
    """G 1..60 x voltage bits 2..5 x array rows 128..1024: kan_cost and
    accelerator_cost equal, and invalid G raise the same error."""
    checked = raised = 0
    for g in range(1, 61):
        for vb in range(2, 6):
            for rows in (128, 256, 512, 1024):
                jt, tt = JTMDV(n_bits, vb), TMDVConfig(n_bits, vb)
                try:
                    ref = jns.kan_cost(KAN1, g, 3, n_bits, jt, rows, 8)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:30]):
                        tns.kan_cost(KAN1, g, 3, n_bits, tt, rows, 8)
                    raised += 1
                    continue
                port = tns.kan_cost(KAN1, g, 3, n_bits, tt, rows, 8)
                assert port == ref, (g, vb, rows)
                assert tcm.input_generator_cost(tt) == \
                    jcm.input_generator_cost(jt)
                spec_j = JSpec(g, 3, n_bits, n_bits, -1.0, 1.0)
                spec_t = ASPQuantSpec(g, 3, n_bits, n_bits, -1.0, 1.0)
                assert tcm.bx_path_asp(spec_t) == jcm.bx_path_asp(spec_j)
                assert tcm.bx_path_conventional(spec_t) == \
                    jcm.bx_path_conventional(spec_j)
                checked += 1
    assert checked > 0
    # G > 2**n_bits cannot fit (eq. (6)): at 4 bits the error path runs
    assert (raised > 0) == (60 > 2**n_bits)


def test_mixed_precision_kan_cost_equals_the_reference():
    for g, bits in ((5, (8, 4)), (5, (4, 4)), (12, (8, 6))):
        assert tns.kan_cost(KAN1, g, 3, 8, TMDVConfig(8, 4), 128, 8,
                            layer_bits=bits) == \
            jns.kan_cost(KAN1, g, 3, 8, JTMDV(8, 4), 128, 8, layer_bits=bits)


# ----------------------------------------------------------------------------
# the reference's single-device cost-model cases, on the port alone
# ----------------------------------------------------------------------------


def test_fig10_ratios_in_paper_band():
    ra, re_ = [], []
    for g in (8, 16, 32, 64):
        s = ASPQuantSpec(grid_size=g, order=3, n_bits=8, lo=0.0, hi=1.0)
        c, a = tcm.bx_path_conventional(s), tcm.bx_path_asp(s)
        ra.append(c["area_um2"] / a["area_um2"])
        re_.append(c["energy_pj"] / a["energy_pj"])
    assert 30 < np.mean(ra) < 55, np.mean(ra)      # paper: 40.14x
    assert 3.5 < np.mean(re_) < 8, np.mean(re_)    # paper: 5.59x
    assert ra == sorted(ra)                        # improvement grows with G


def test_fig11_ratios_in_paper_band():
    v = tcm.input_generator_cost(PURE_VOLTAGE(6))
    p = tcm.input_generator_cost(PURE_PWM(6))
    t = tcm.input_generator_cost(TMDVConfig(total_bits=6, voltage_bits=3))
    assert 1.7 < v["area_um2"] / t["area_um2"] < 2.3        # 1.96
    assert 9 < v["power_uw"] / t["power_uw"] < 15           # 11.9
    assert p["latency_ns"] / t["latency_ns"] == 8.0         # 8x
    assert 0.9 < p["area_um2"] / t["area_um2"] < 1.3        # 1.07
    assert 2.3 < t["fom"] / v["fom"] < 3.8                  # 3x
    assert 3.2 < t["fom"] / p["fom"] < 5.2                  # 4.1x


def test_fig13_headline_ratios():
    mlp = tcm.accelerator_cost(tcm.mlp_accelerator(MLP, PURE_PWM(8)))
    k1 = tcm.accelerator_cost(tcm.kan_accelerator(
        KAN1, ASPQuantSpec(5, 3, 8, 8, -1.0, 1.0), TMDVConfig(8, 4), 128,
        adc_bits=8))
    assert 30 < mlp["area_mm2"] / k1["area_mm2"] < 55         # paper 41.78x
    assert 55 < mlp["energy_pj"] / k1["energy_pj"] < 105      # paper 77.97x
    assert 20 < mlp["latency_ns"] / k1["latency_ns"] < 40     # 23.6-29.6x


def test_cost_monotonicity():
    """More grid -> never cheaper B(X) area at fixed n (demux grows)."""
    areas = [tcm.bx_path_asp(ASPQuantSpec(g, 3, 8, 8, 0.0, 1.0))["area_um2"]
             for g in (32, 48, 64)]
    assert areas == sorted(areas)
    c8 = tcm.bx_path_conventional(ASPQuantSpec(8, 3, 8, 8, 0.0, 1.0))
    c64 = tcm.bx_path_conventional(ASPQuantSpec(64, 3, 8, 8, 0.0, 1.0))
    assert 4 < c64["area_um2"] / c8["area_um2"] < 8  # (64+3)/(8+3) ~ 6.1


def test_search_max_grid_respects_constraints_and_equals_the_reference():
    hc = tns.HardwareConstraints(max_area_mm2=0.02, max_energy_pj=300,
                                 max_latency_ns=700)
    g, cost = tns.search_max_grid(KAN1, hc)
    assert g is not None
    assert tns.check_constraints(cost, hc)
    try:  # the next G up must violate (maximality) or be infeasible
        nxt = tns.kan_cost(KAN1, g + 1, 3, 8, TMDVConfig(8, 4), 128, 8)
        assert not tns.check_constraints(nxt, hc)
    except ValueError:
        pass  # G+1 doesn't satisfy eq. (6)
    jhc = jns.HardwareConstraints(max_area_mm2=0.02, max_energy_pj=300,
                                  max_latency_ns=700)
    assert (g, cost) == jns.search_max_grid(KAN1, jhc)


def test_search_infeasible_returns_none():
    hc = tns.HardwareConstraints(max_area_mm2=1e-9)
    assert tns.search_max_grid(KAN1, hc) == (None, None)


def test_kan_cost_raises_on_invalid_layer_bits_never_clamps():
    with pytest.raises(ValueError, match="PowerGap-invalid"):
        tns.kan_cost(KAN1, 32, 3, 8, TMDVConfig(8, 4), 128, 8,
                     layer_bits=(4, 8))
