"""The port's KAN layers against the JAX reference on the same weights.

Weights are drawn with numpy from a seed and handed to both packages
(``repro_torch.convert``).  Tolerances:

  * float path 1e-6: the same f32 Cox-de Boor ops, but the two BLAS/XLA
    matmuls sum the spline terms in different orders (a few f32 ulps at
    these O(1) outputs);
  * quantization: qparams bit-equal, since both quantize in numpy float64
    with the same code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bspline as jb
from repro.core import kan_layer as jk
from repro_torch import convert
from repro_torch.core import bspline as tb
from repro_torch.core import kan_layer as tk

torch.set_num_threads(1)

NETS = [((17, 1, 14), 5, 8), ((17, 1, 14), 68, 8), ((17, 1, 14), 5, (8, 4)),
        ((5, 9, 3, 2), 8, 8), ((6, 4), 16, 4)]


def _params(dims, g, order=3, seed=0):
    """pykan-scale float params from numpy, as the reference's pytree."""
    rng = np.random.default_rng(seed)
    nb = g + order
    return [
        {"c": (rng.normal(size=(a, nb, b)) * 0.1 / np.sqrt(a)).astype(np.float32),
         "w_b": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _x(b, f, seed=1, lim=1.0):
    return np.random.default_rng(seed).uniform(-lim, lim, (b, f)).astype(np.float32)


@pytest.mark.parametrize("g,order", [(5, 3), (68, 3), (8, 1), (6, 4)])
def test_bspline_basis_matches(g, order):
    x = _x(257, 1, seed=g, lim=1.2)[:, 0]
    want = np.asarray(jb.bspline_basis(jnp.asarray(x), -1.0, 1.0, g, order))
    got = tb.bspline_basis(torch.from_numpy(x), -1.0, 1.0, g, order).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tb.extended_knots(-1.0, 1.0, g, order),
                                  jb.extended_knots(-1.0, 1.0, g, order))
    t = np.linspace(-0.5, order + 1.5, 301)
    np.testing.assert_array_equal(tb.cardinal_bump(t, order),
                                  jb.cardinal_bump(t, order))


@pytest.mark.parametrize("dims,g,bits", NETS[:2] + NETS[3:4], ids=str)
def test_float_network_matches(dims, g, bits):
    jspec = jk.KANSpec(dims=dims, grid_size=g, n_bits=bits)
    tspec = tk.KANSpec(dims=dims, grid_size=g, n_bits=bits)
    p = _params(dims, g)
    x = _x(33, dims[0])
    apply = jax.jit(lambda p, x: jk.kan_network_apply(p, x, jspec))
    want = np.asarray(apply(p, x))
    got = tk.kan_network_apply(convert.params_from_numpy(p, device="cpu"),
                               torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dims,g,bits", NETS, ids=str)
def test_quantize_kan_layer_bit_equal(dims, g, bits):
    jspec = jk.KANSpec(dims=dims, grid_size=g, n_bits=bits)
    tspec = tk.KANSpec(dims=dims, grid_size=g, n_bits=bits)
    assert tspec.layer_bits == jspec.layer_bits
    tparams = convert.params_from_numpy(_params(dims, g), device="cpu")
    for li, p in enumerate(_params(dims, g)):
        js, ts = jspec.layer_spec(li), tspec.layer_spec(li)
        assert convert.spec_from_reference(js) == ts
        want = jk.quantize_kan_layer({k: jnp.asarray(v) for k, v in p.items()}, js)
        got = tk.quantize_kan_layer(tparams[li], ts)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            gk = got[k].numpy()
            assert gk.dtype == w.dtype, k
            np.testing.assert_array_equal(gk, w, err_msg=k)


@pytest.mark.parametrize("dims,g,bits", NETS[:3], ids=str)
def test_quantized_layer_apply_matches(dims, g, bits):
    """The quantized single-layer path: identical codes and dense basis,
    matmul order differs -> 1e-6."""
    jspec = jk.KANSpec(dims=dims, grid_size=g, n_bits=bits).layer_spec()
    tspec = convert.spec_from_reference(jspec)
    p = _params(dims, g)[0]
    jqp = jk.quantize_kan_layer({k: jnp.asarray(v) for k, v in p.items()}, jspec)
    tqp = convert.qparams_from_numpy({k: np.asarray(v) for k, v in jqp.items()},
                                     device="cpu")
    x = _x(40, dims[0], lim=1.1)
    want = np.asarray(jk.kan_layer_apply_quantized(jqp, jnp.asarray(x), jspec))
    got = tk.kan_layer_apply_quantized(tqp, torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_param_count_and_invalid_specs_match():
    for dims, g, bits in NETS:
        assert tk.param_count(tk.KANSpec(dims=dims, grid_size=g)) == \
            jk.param_count(jk.KANSpec(dims=dims, grid_size=g))
    assert tk.param_count(tk.KANSpec(dims=(17, 1, 14), grid_size=5)) == 279
    assert tk.param_count(tk.KANSpec(dims=(17, 1, 14), grid_size=68)) == 2232
    for bits in ((8, 2), (8,), (8, 8, 8)):
        with pytest.raises(ValueError):
            jk.KANSpec(dims=(17, 1, 14), grid_size=5, n_bits=bits)
        with pytest.raises(ValueError):
            tk.KANSpec(dims=(17, 1, 14), grid_size=5, n_bits=bits)


def test_init_is_seeded_and_shaped():
    kspec = tk.KANSpec(dims=(17, 1, 14), grid_size=5)
    a = tk.init_kan_network(torch.Generator().manual_seed(3), kspec, device="cpu")
    b = tk.init_kan_network(torch.Generator().manual_seed(3), kspec, device="cpu")
    assert [tuple(l["c"].shape) for l in a] == [(17, 8, 1), (1, 8, 14)]
    assert [tuple(l["w_b"].shape) for l in a] == [(17, 1), (1, 14)]
    for la, lb in zip(a, b):
        assert torch.equal(la["c"], lb["c"]) and torch.equal(la["w_b"], lb["w_b"])


def test_float_path_rejects_quantized_backend():
    kspec = tk.KANSpec(dims=(3, 2), grid_size=4)
    p = tk.init_kan_network(torch.Generator().manual_seed(0), kspec, device="cpu")
    with pytest.raises(ValueError):
        tk.kan_network_apply(p, torch.zeros(2, 3), kspec, backend="fused")
