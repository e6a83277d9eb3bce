"""The port's ASP quantization core against the JAX reference.

Codes, SH-LUTs, hemi storage and PowerGap validation are discrete or built
on the host in numpy float64 by the same code, so every comparison here is
exact (no tolerance): the sweeps are those of ``test_asp_quant.py`` and
``test_mixed_precision.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asp_quant as jq
from repro_torch.core import asp_quant as tq

torch.set_num_threads(1)

# (G, n_bits, order, lut_bits): test_asp_quant's alignment sweep, the
# mixed-precision widths and the orders its property test draws
SPECS = [
    (5, 8, 3, 8), (8, 8, 3, 8), (16, 8, 3, 8), (64, 8, 3, 8), (68, 10, 3, 16),
    (3, 6, 3, 8), (68, 8, 3, 8), (5, 4, 3, 4), (7, 5, 3, 5), (11, 6, 2, 4),
    (6, 8, 1, 8), (9, 10, 4, 8), (40, 10, 3, 4),
]


def _pair(g, n, order, lut_bits, lo=-1.0, hi=1.0):
    kw = dict(grid_size=g, order=order, n_bits=n, lut_bits=lut_bits, lo=lo, hi=hi)
    return jq.ASPQuantSpec(**kw), tq.ASPQuantSpec(**kw)


def test_max_ld_and_powergap_validation_match():
    for g in range(1, 41):
        for b in range(2, 17):
            assert tq.max_ld(g, b) == jq.max_ld(g, b)
            try:
                want = jq.resolve_layer_bits(b, 3, g)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e).split(":")[0]):
                    tq.resolve_layer_bits(b, 3, g)
            else:
                assert tq.resolve_layer_bits(b, 3, g) == want


@pytest.mark.parametrize("bits,n_layers,g", [
    ((8, 4), 2, 5), ((4, 4), 2, 5), ((16, 4), 2, 17), ((8,), 2, 5),
    ((8, 8, 8), 2, 5), ((1, 8), 2, 5), (17, 1, 5),
], ids=str)
def test_resolve_layer_bits_raises_alike(bits, n_layers, g):
    """Valid allocations come back verbatim, invalid ones raise the same
    message (never clamped)."""
    try:
        want = jq.resolve_layer_bits(bits, n_layers, g)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tq.resolve_layer_bits(bits, n_layers, g)
        assert str(got.value) == str(e)
    else:
        assert tq.resolve_layer_bits(bits, n_layers, g) == want


@pytest.mark.parametrize("g,n,order,lut_bits", SPECS)
def test_spec_properties_and_lut_equal(g, n, order, lut_bits):
    js, ts = _pair(g, n, order, lut_bits)
    for name in ("ld", "codes_per_interval", "num_codes", "num_basis",
                 "global_bits", "knot_step", "code_step"):
        assert getattr(ts, name) == getattr(js, name), name
    assert tq.lut_scale(ts) == jq.lut_scale(js)
    je, te = jq.build_lut(js), tq.build_lut(ts)
    assert te["scale"] == je["scale"]
    for k in ("lut", "lut_q", "hemi", "flat_q"):
        assert te[k].dtype == je[k].dtype, k
        np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    np.testing.assert_array_equal(tq.hemi_unfold(te["hemi"], ts),
                                  jq.hemi_unfold(je["hemi"], js))


@pytest.mark.parametrize("g,n,order,lut_bits", SPECS)
def test_quantize_dequantize_codes_equal(g, n, order, lut_bits):
    """Entry codes are bit-identical: the same f32 ops on the same
    f32 constants, including inputs outside [lo, hi] that clip."""
    js, ts = _pair(g, n, order, lut_bits)
    x = np.random.default_rng(g * 100 + n).uniform(-1.3, 1.3, 4096)
    x = np.concatenate([x, [-1.0, 1.0, 0.0, np.nextafter(1.0, 0)]]).astype(np.float32)
    jc = np.asarray(jq.quantize_input(jnp.asarray(x), js))
    tc = tq.quantize_input(torch.from_numpy(x), ts).numpy()
    assert tc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(
        tq.dequantize_input(torch.from_numpy(tc), ts).numpy(),
        np.asarray(jq.dequantize_input(jnp.asarray(jc), js)),
    )


@pytest.mark.parametrize("g,n,order,lut_bits", SPECS)
def test_lookup_and_dense_basis_equal(g, n, order, lut_bits):
    """Every code, plus out-of-range and negative ones (the logical shift
    puts them past every band), retrieves the same band."""
    js, ts = _pair(g, n, order, lut_bits)
    e = jq.build_lut(js)
    lut = np.asarray(e["lut_q"] * e["scale"], np.float32)
    codes = np.concatenate([np.arange(js.num_codes),
                            [js.num_codes, js.num_codes + 5, -1, -7]])
    codes = codes.astype(np.int32).reshape(-1, 1)
    jg, jv = jq.lookup_active(jnp.asarray(codes), jnp.asarray(lut), js)
    tg, tv = tq.lookup_active(torch.from_numpy(codes), torch.from_numpy(lut), ts)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg).astype(np.uint32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tq.dense_basis_from_codes(torch.from_numpy(codes), torch.from_numpy(lut), ts).numpy(),
        np.asarray(jq.dense_basis_from_codes(jnp.asarray(codes), jnp.asarray(lut), js)),
    )


def test_invalid_spec_raises_alike():
    for kw in (dict(grid_size=0), dict(grid_size=257, n_bits=8)):
        with pytest.raises(ValueError):
            jq.ASPQuantSpec(**kw)
        with pytest.raises(ValueError):
            tq.ASPQuantSpec(**kw)


# -- the PACT baseline and quantized_dense_basis ------------------------------

# (G, n_bits, lo, hi): the grids of test_asp_quant.py's sweep at both input
# widths, on the unsigned [0, 1] and the signed [-1, 1] domain
PACT_SPECS = [(g, n, lo, hi) for g in (5, 8, 68) for n in (8, 10)
              for lo, hi in ((0.0, 1.0), (-1.0, 1.0))]


def _pact_pair(g, n, lo, hi):
    kw = dict(grid_size=g, order=3, n_bits=n, lo=lo, hi=hi, signed=lo < 0)
    return jq.ASPQuantSpec(**kw), tq.ASPQuantSpec(**kw)


def _pact_inputs(g, n, lo, hi, alpha=None):
    """Every exact half step lo + (q + 0.5) * alpha / (2**n - 1), both clip
    edges (lo, lo + alpha) and points past them, and seeded uniform draws,
    as f32."""
    alpha = hi - lo if alpha is None else alpha
    half = lo + (np.arange(2**n - 1) + 0.5) * alpha / (2**n - 1)
    rng = np.random.default_rng(g * 100 + n + int(lo < 0))
    top = lo + alpha
    edges = [lo, top, np.nextafter(lo, top), np.nextafter(top, lo), lo - 0.3,
             top + 0.3]
    x = np.concatenate([half, edges, rng.uniform(lo - 0.2, hi + 0.2, 2048)])
    return x.astype(np.float32), len(half)


@pytest.mark.parametrize("g,n,lo,hi", PACT_SPECS, ids=str)
def test_pact_quantize_codes_equal(g, n, lo, hi):
    """Codes bit for bit, half steps and clip edges included: the same f32
    ops in the same order, an IEEE division and round half to even; at the
    spec's clip and at a clip whose reciprocal is not exact."""
    for alpha in (hi - lo, 0.75 * (hi - lo)):
        x, n_half = _pact_inputs(g, n, lo, hi, alpha)
        jc = np.asarray(jq.pact_quantize(jnp.asarray(x) - lo, alpha, n))
        tc = tq.pact_quantize(torch.from_numpy(x) - tq.f32(lo), alpha, n)
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), jc)
        # a half step's code is its lower or upper neighbour; on [0, 1]
        # the f32 quotient lands on the tie itself and rounds to even
        assert np.isin(jc[:n_half] - np.arange(n_half), (0, 1)).all()
        assert jc[n_half] == 0 and jc[n_half + 1] == 2**n - 1
        if lo == 0.0 and alpha == 1.0:
            assert not (jc[:n_half] % 2).any()


@pytest.mark.parametrize("g,n,lo,hi", PACT_SPECS, ids=str)
def test_pact_basis_tables_equal(g, n, lo, hi):
    js, ts = _pact_pair(g, n, lo, hi)
    for alpha in (None, 0.75 * (hi - lo)):
        jt, tt = jq.pact_basis_tables(js, alpha), tq.pact_basis_tables(ts, alpha)
        assert tt.dtype == jt.dtype and tt.shape == (js.num_basis, 2**n)
        assert tt.tobytes() == jt.tobytes()


@pytest.mark.parametrize("g,n,lo,hi", PACT_SPECS, ids=str)
def test_pact_and_quantized_dense_basis_equal(g, n, lo, hi):
    """Both bases are gathers of equal tables: tolerance 0, in the
    reference's axis order (..., G+K), on a 2-D input."""
    js, ts = _pact_pair(g, n, lo, hi)
    x, _ = _pact_inputs(g, n, lo, hi)
    x = x[: x.size // 4 * 4].reshape(4, -1)
    tables = jq.pact_basis_tables(js)
    jb = np.asarray(jq.pact_dense_basis(jnp.asarray(x), js, tables))
    tb = tq.pact_dense_basis(torch.from_numpy(x), ts, tables)
    assert tb.dtype == torch.float32 and tuple(tb.shape) == jb.shape
    np.testing.assert_array_equal(tb.numpy(), jb)
    jd = np.asarray(jq.quantized_dense_basis(jnp.asarray(x), js))
    td = tq.quantized_dense_basis(torch.from_numpy(x), ts)
    assert td.dtype == torch.float32 and tuple(td.shape) == jd.shape
    np.testing.assert_array_equal(td.numpy(), jd)
    entry = jq.build_lut(js)
    np.testing.assert_array_equal(
        tq.quantized_dense_basis(torch.from_numpy(x), ts, entry).numpy(), jd)


def test_pact_baseline_needs_distinct_tables():
    """The port's twin of test_asp_quant.py's: every B_i has its own table
    (misaligned grids), and the baseline stays within 0.02 of the float
    basis."""
    from repro.core.bspline import bspline_basis

    spec = tq.ASPQuantSpec(grid_size=5, order=3, n_bits=8, lo=0.0, hi=1.0)
    tables = tq.pact_basis_tables(spec)
    assert len({tables[i].tobytes() for i in range(spec.num_basis)}) == \
        spec.num_basis
    x = np.linspace(0.0, 1.0, 97, dtype=np.float32)
    pb = tq.pact_dense_basis(torch.from_numpy(x), spec, tables).numpy()
    fb = np.asarray(bspline_basis(jnp.asarray(x), 0.0, 1.0, 5, 3))
    assert np.abs(pb - fb).max() < 0.02
