"""Kernel B3 (single-layer kan_spline) of the port against the reference.

The plain version is held against the reference's Pallas kernel in
interpret mode on ragged shapes: the same dense SH-LUT basis and banded
product, summed in another order, so outputs agree within 1e-5 at the
O(1) magnitudes the init-scale weights give.  The CUDA kernel is held
against the plain version in ``test_torch_gpu.py`` (card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asp_quant as jq
from repro.core.kan_layer import quantize_kan_layer as j_quantize_layer
from repro.kernels.kan_spline.ops import kan_spline as j_kan_spline
from repro.kernels.kan_spline.ops import kan_spline_from_qparams as j_from_qparams
from repro_torch import convert
from repro_torch.core.asp_quant import ASPQuantSpec, quantize_input
from repro_torch.kernels import cuda
from repro_torch.kernels.kan_spline.ops import kan_spline, kan_spline_from_qparams
from repro_torch.kernels.kan_spline.ref import kan_spline_ref

torch.set_num_threads(1)

# (B, F, O, G): test_kernels_kan_spline's SHAPES, cut to a CPU budget
SHAPES = [(32, 17, 14, 5), (8, 3, 5, 8), (33, 40, 130, 16), (1, 1, 1, 64),
          (19, 17, 1, 68)]


def _case(b, f, o, g, order=3, seed=0):
    js = jq.ASPQuantSpec(grid_size=g, order=order)
    e = jq.build_lut(js)
    lut = np.asarray(e["lut_q"] * e["scale"], np.float32)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, js.num_codes, (b, f)).astype(np.int32)
    wc = (rng.normal(size=(f, js.num_basis, o)) * 0.3 / np.sqrt(f)).astype(np.float32)
    wb = (rng.normal(size=(f, o)) / np.sqrt(f)).astype(np.float32)
    return js, codes, lut, wc, wb


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kan_spline_plain_matches_reference(shape):
    js, codes, lut, wc, wb = _case(*shape)
    want = np.asarray(j_kan_spline(jnp.asarray(codes), jnp.asarray(lut),
                                   jnp.asarray(wc), jnp.asarray(wb), js,
                                   interpret=True))
    ts = convert.spec_from_reference(js)
    got = kan_spline(*(torch.from_numpy(a) for a in (codes, lut, wc, wb)), ts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        kan_spline_ref(*(torch.from_numpy(a) for a in (codes, lut, wc, wb)), ts).numpy(),
        got.numpy())


@pytest.mark.parametrize("order", [1, 2, 4, 5])
def test_kan_spline_orders_match_reference(order):
    js, codes, lut, wc, wb = _case(16, 8, 8, 6, order=order)
    want = np.asarray(j_kan_spline(jnp.asarray(codes), jnp.asarray(lut),
                                   jnp.asarray(wc), jnp.asarray(wb), js,
                                   interpret=True))
    got = kan_spline(*(torch.from_numpy(a) for a in (codes, lut, wc, wb)),
                     convert.spec_from_reference(js))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_kan_spline_from_qparams_matches_reference():
    """quickstart's path: quantize a layer, code the input, run B3."""
    js = jq.ASPQuantSpec(grid_size=5)
    rng = np.random.default_rng(2)
    p = {"c": (rng.normal(size=(17, 8, 14)) * 0.1 / np.sqrt(17)).astype(np.float32),
         "w_b": (rng.normal(size=(17, 14)) / np.sqrt(17)).astype(np.float32)}
    jqp = j_quantize_layer({k: jnp.asarray(v) for k, v in p.items()}, js)
    x = rng.uniform(-1, 1, (33, 17)).astype(np.float32)
    jc = jq.quantize_input(jnp.asarray(x), js)
    want = np.asarray(j_from_qparams(jc, jqp, js, interpret=True))
    ts = convert.spec_from_reference(js)
    tqp = convert.qparams_from_numpy({k: np.asarray(v) for k, v in jqp.items()},
                                     device="cpu")
    tc = quantize_input(torch.from_numpy(x), ts)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = kan_spline_from_qparams(tc, tqp, ts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("order", [0, 1, 3, 5, 6])
def test_kernel_spec_check_admits_orders_1_to_5(order):
    """The kernel library has instances (each held against its plain
    version on the card) for orders 1..5 only; any other order is refused
    before a launch, not run."""
    spec = ASPQuantSpec(grid_size=5, order=order)
    if 1 <= order <= 5:
        cuda.check_spec(spec)
    else:
        with pytest.raises(ValueError, match="orders 1..5"):
            cuda.check_spec(spec)
