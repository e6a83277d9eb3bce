"""Kernel B4's entry points on the CPU (its plain version) vs the JAX package.

  * ``cim_mac_arrays`` (the plain version ``cim_mac_plain`` on CPU
    tensors) on pre-tiled operands against the reference's oracle
    ``cim_mac_ref`` (the same formula and op order);
  * the port's ``cim_mac`` (column load, ADC range, then the plain
    version on these CPU tensors) against the reference's ``cim_mac`` in
    Pallas interpret mode on a few of ``tests/test_kernels_cim_mac.py``'s
    CASES, and against the reference simulator ``cim_matmul``;
  * every comparison under the reference's ADC contract (within one ADC
    LSB per array, >= 95% of elements tight); the zero-IR, 24-bit case is
    the plain matmul within 1e-3 relative plus half an LSB per array;
  * the wrapper refuses malformed operands, and a CPU call launches no
    kernel;
  * the kernel's shape-only plan (``mac_plan``): stream tiles of a multiple
    of 4 rows whose ring fits an H100 block's shared memory, the wide
    path's R-chunks, nothing taken from the batch.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cim import CIMConfig as JCIMConfig
from repro.core.cim import cim_matmul as j_cim_matmul
from repro.kernels.cim_mac.ops import cim_mac as j_cim_mac
from repro.kernels.cim_mac.ref import cim_mac_ref as j_cim_mac_ref
from repro_torch.kernels import cuda
from repro_torch.kernels.cim_mac import cim_mac, cim_mac_arrays, cim_mac_plain
from repro_torch.kernels.cim_mac.cardcheck import (
    PATH_SHAPES,
    adc_close,
    assert_adc_close,
    zero_ir_atol,
)
from repro_torch.kernels.cim_mac.kernel import (
    SMEM_BYTES,
    STAGES,
    MacPlan,
    mac_plan,
    stream_smem_bytes,
)
from repro_torch.kernels.cim_mac.ops import array_stats
from repro_torch.kernels.cim_mac.ref import tile_rows

torch.set_num_threads(1)

# a few of the reference's CASES (B, R, C, array rows); the Pallas runs in
# interpret mode are slow, so the 2048-row case stays on the card
CASES = [(16, 300, 20, 128), (130, 136, 1, 128), (4, 50, 3, 512)]


def _operands(b, r, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255.0, (b, r)).astype(np.float32)
    w = rng.integers(-127, 128, (r, c)).astype(np.float32)
    return x, w


def test_plain_matches_reference_oracle_on_tiled_operands():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255.0, (16, 3, 128)).astype(np.float32)
    w = rng.integers(-127, 128, (3, 128, 40)).astype(np.float32)
    load = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    fs = (255.0 * np.abs(w).sum(axis=1)).astype(np.float32)
    out = cim_mac_arrays(torch.from_numpy(x.reshape(16, -1)),
                         torch.from_numpy(w.reshape(-1, 40)),
                         torch.from_numpy(load), torch.from_numpy(fs),
                         array_rows=128, ir_scale=0.05, adc_bits=8)
    ref = j_cim_mac_ref(*(jnp.asarray(a) for a in (x, w, load, fs)),
                        ir_scale=0.05, adc_bits=8)
    st = adc_close(out, np.asarray(ref), fs, 8, rtol=1e-6)
    assert st["tight"] >= 0.95


@pytest.mark.parametrize("case", CASES)
def test_cim_mac_matches_reference_kernel_and_simulator(case):
    b, r, c, rows = case
    x, w = _operands(b, r, c, seed=r)
    ir = 0.04 * (rows / 128) ** 0.5
    out = cim_mac(torch.from_numpy(x), torch.from_numpy(w), array_rows=rows,
                  ir_scale=ir, adc_bits=10, x_max=255.0)
    assert out.shape == (b, c) and out.dtype == torch.float32
    ref_kernel = j_cim_mac(jnp.asarray(x), jnp.asarray(w), array_rows=rows,
                           ir_scale=ir, adc_bits=10, x_max=255.0,
                           interpret=True)
    ref_sim = j_cim_matmul(
        jnp.asarray(x), jnp.asarray(w),
        JCIMConfig(array_rows=rows, adc_bits=10, ir_gamma=0.04,
                   deterministic=True), jax.random.PRNGKey(0))
    for ref in (ref_kernel, ref_sim):
        assert_adc_close(out.numpy(), np.asarray(ref), w, rows, 10)


@pytest.mark.parametrize("b,r,c,rows,adc", [(1, 1, 1, 128, 8),
                                            (7, 400, 48, 256, 6),
                                            (32, 129, 33, 128, 12)])
def test_cim_mac_matches_reference_simulator_on_ragged_shapes(b, r, c, rows, adc):
    x, w = _operands(b, r, c, seed=b * r * c)
    out = cim_mac(torch.from_numpy(x), torch.from_numpy(w), array_rows=rows,
                  ir_scale=0.03, adc_bits=adc, x_max=255.0)
    ref = j_cim_matmul(
        jnp.asarray(x), jnp.asarray(w),
        JCIMConfig(array_rows=rows, adc_bits=adc,
                   ir_gamma=0.03 / (rows / 128) ** 0.5, deterministic=True),
        jax.random.PRNGKey(0))
    assert_adc_close(out.numpy(), np.asarray(ref), w, rows, adc)


def test_zero_ir_high_adc_is_exact_matmul():
    """No IR-drop, 24-bit ADC: the plain matmul within 1e-3 relative, plus
    the rounding itself, half an LSB of the worst-case full scale per
    array (an output near zero has no relative bound); the reference's
    kernel lands within the same bound on the same data."""
    x, w = _operands(8, 256, 16, seed=2)
    out = cim_mac(torch.from_numpy(x), torch.from_numpy(w), array_rows=128,
                  ir_scale=0.0, adc_bits=24, x_max=255.0)
    ref = j_cim_mac(jnp.asarray(x), jnp.asarray(w), array_rows=128,
                    ir_scale=0.0, adc_bits=24, x_max=255.0, interpret=True)
    for got in (out.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(got, x @ w, rtol=1e-3,
                                   atol=zero_ir_atol(w, 128, 24))


def test_tile_operands_normalize_on_real_batch_and_columns():
    """col_load has mean 1 over the real (A, C) and is the reference's
    load; fs = x_max * sum |w| per array; the plain version's tiles pad
    with zero rows."""
    x, w = _operands(5, 300, 3, seed=4)
    load, fs = array_stats(torch.from_numpy(x), torch.from_numpy(w),
                           array_rows=128, x_max=255.0)
    x_t, w_t = tile_rows(torch.from_numpy(x), torch.from_numpy(w), 128)
    assert x_t.shape == (5, 3, 128) and w_t.shape == (3, 128, 3)
    assert load.shape == fs.shape == (3, 3)
    np.testing.assert_allclose(float(load.mean()), 1.0, rtol=1e-6)
    assert not x_t.reshape(5, -1)[:, 300:].any()
    assert not w_t.reshape(-1, 3)[300:].any()
    want = np.einsum("bar,arc->ac", x_t.numpy().astype(np.float64) / 255.0,
                     np.abs(w_t.numpy()) / np.abs(w).max()) / (128 * 5)
    np.testing.assert_allclose(load.numpy(), want / want.mean(), rtol=1e-5)
    np.testing.assert_allclose(fs.numpy(),
                               255.0 * np.abs(w_t.numpy()).sum(axis=1),
                               rtol=1e-6)


def test_wrapper_refuses_bad_operands_and_launches_nothing_on_cpu():
    x = torch.zeros(4, 200)
    w = torch.zeros(200, 3)
    load = torch.zeros(2, 3)
    kw = dict(array_rows=128, ir_scale=0.0, adc_bits=8)
    with pytest.raises(ValueError, match="w"):
        cim_mac_arrays(x, w[:64], load, load, **kw)
    with pytest.raises(ValueError, match="fs"):
        cim_mac_arrays(x, w, load, load.double(), **kw)
    with pytest.raises(ValueError, match="col_load"):
        cim_mac_arrays(x, w, load[:1], load, **kw)
    before = cuda.launch_counts()
    out = cim_mac_arrays(x, w, load, load + 1.0, **kw)
    assert out.shape == (4, 3) and not out.any()
    assert cuda.launch_counts() == before
    assert torch.equal(out, cim_mac_plain(*tile_rows(x, w, 128), load,
                                          load + 1.0, 0.0, 8))


@pytest.mark.parametrize("r_total,rows", [(b[2], b[4]) for b in PATH_SHAPES
                                          if b[3] == 1] + [(1, 128), (77, 128)])
def test_stream_plan_tiles_are_16_byte_runs_within_shared_memory(r_total,
                                                                  rows):
    plan = mac_plan(r_total, 1, rows)
    assert plan.tile_rows > 0 and plan.tile_rows % 4 == 0
    assert plan.tile_rows * r_total * 4 % 16 == 0
    n_arrays = -(-r_total // rows)
    assert stream_smem_bytes(r_total, n_arrays, plan.tile_rows) <= SMEM_BYTES


def test_stream_plan_fits_kan2_where_a_64_row_tile_would_not():
    """KAN2's layer-1 row is 1207 floats: a 64-row tile (309 KB) is over
    the 227 KB a block may have, so the plan takes fewer rows and keeps
    a ring of STAGES stages."""
    assert 64 * 1207 * 4 > SMEM_BYTES
    plan = mac_plan(1207, 1, 1024)
    assert plan.tile_rows == 4 and STAGES >= 2
    assert stream_smem_bytes(1207, 2, 4) <= SMEM_BYTES


@pytest.mark.parametrize("r_total,cols,rows,chunks", [
    (2048, 64, 1024, 8), (300, 20, 128, 1), (400, 48, 256, 2),
    (7000, 1, 1024, 8)])
def test_wide_plan_splits_each_array_into_128_row_chunks(r_total, cols, rows,
                                                         chunks):
    """C > 1, and a C = 1 row too long for two stages of 4 rows, take the
    wide path with ceil(R / 128) chunks per array."""
    assert mac_plan(r_total, cols, rows) == MacPlan(0, chunks)


def test_plan_is_a_function_of_the_widths_alone():
    """No batch size enters the plan, so a row's reduction order, and its
    bits, are the same in any batch."""
    assert list(inspect.signature(mac_plan).parameters) == [
        "r_total", "cols", "array_rows"]
