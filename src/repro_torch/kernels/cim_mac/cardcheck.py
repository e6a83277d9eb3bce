"""Kernel B4 held against its plain version on the card.

The one definition of the card check, shared by ``chip_smoke.py`` (phases
3 and 7) and ``tests/test_torch_gpu.py``; the CPU tests use its ADC
contract too.  Each check draws operands from a seeded ``torch.Generator``
on the card, runs the kernel and the plain PyTorch version on the same
tensors and raises on disagreement beyond the reference's own contract
(``tests/test_kernels_cim_mac.py::_assert_adc_close``): the two quantize
the same math, but the f32 sum inside an array is taken in another order,
which can move a partial across an ADC rounding boundary.  So every
element lies within one ADC LSB per array (x 1.01) of the plain result,
and at least 95% are tight (within 1e-5 relative + 1e-3).  Each kernel
call adds exactly one to ``cuda.LAUNCHES["cim_mac_fwd"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.cim import CIMConfig
from .. import cuda
from .kernel import cim_mac_arrays
from .ops import array_stats, cim_mac
from .ref import cim_mac_plain, tile_rows

__all__ = ["CASES", "PROPERTY_CASES", "PATH_SHAPES", "RAGGED_CASES",
           "ROW_CASES", "SPLIT_CASES", "adc_close", "assert_adc_close",
           "zero_ir_atol", "mac_operands", "check_case", "check_tiled",
           "check_zero_ir", "path_operands", "check_path", "check_rows"]

X_MAX = 255.0
# (B, R, C, array rows): the reference's CASES, (130, 136, 1, 128) being
# the paper's KAN layer-1 geometry
CASES = ((16, 300, 20, 128), (8, 1024, 14, 256), (130, 136, 1, 128),
         (4, 50, 3, 512), (32, 2048, 64, 1024))
# ragged shapes in the reference property test's ranges, adc 6 / 8 / 12:
# (B, R, C, array rows, adc bits)
PROPERTY_CASES = ((1, 1, 1, 128, 8), (7, 400, 48, 256, 6),
                  (32, 129, 33, 128, 12), (5, 257, 9, 256, 8),
                  (300, 77, 2, 128, 12), (3, 399, 17, 128, 6))
# the shapes the acim study gives the kernel: (name, B, R, C, array rows,
# adc bits): the simulator path's six layer-1 MACs (17 features x G+3
# bases, one column) at 65536 rows, KAN2 and KAN1 at Fig. 13's arrays and
# Fig. 12's G = 7 / 15 / 30 / 60 sweep, and the largest reference case
PATH_SHAPES = (("kan2_l1_65536", 65536, 17 * 71, 1, 1024, 10),
               ("kan1_l1_65536", 65536, 17 * 8, 1, 128, 8),
               ("g7_l1_65536", 65536, 17 * 10, 1, 128, 10),
               ("g15_l1_65536", 65536, 17 * 18, 1, 256, 10),
               ("g30_l1_65536", 65536, 17 * 33, 1, 512, 10),
               ("g60_l1_65536", 65536, 17 * 63, 1, 1024, 10),
               ("ref_32x2048x64", 32, 2048, 64, 1024, 10))
# stream tiles that end ragged, one of them 1 row of 1207 floats (4828
# bytes, not a multiple of 16): (name, B, R, C, array rows, adc bits)
RAGGED_CASES = (("kan2_l1_65537", 65537, 17 * 71, 1, 1024, 10),
                ("g7_l1_1001", 1001, 17 * 10, 1, 128, 10))
# rows whose bits must not depend on B: the stream path at KAN2 and KAN1
# layer 1, the wide path at the reference's C = 64
ROW_CASES = (("kan2_l1_65536", 65536, 17 * 71, 1, 1024, 10),
             ("kan1_l1_65536", 65536, 17 * 8, 1, 128, 8),
             ("ref_4096x2048x64", 4096, 2048, 64, 1024, 10))
# the wide path's R-chunks added in order before the ADC: (B, R, C, array
# rows, adc bits), a C = 1 row too long to stage among them
SPLIT_CASES = ((33, 2048, 64, 1024, 10), (64, 7000, 1, 1024, 10),
               (40, 1500, 5, 512, 8))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def adc_close(out, ref, fs, adc_bits: int, *, rtol: float = 1e-5,
              tight_frac: float = 0.95) -> dict:
    """Hold ``out`` to ``ref`` (both (B, C)) under the ADC contract, with
    the ADC full scale ``fs`` (A, C).  Raises AssertionError; returns
    ``{"max_abs_err", "tight", "max_err_over_allow"}``."""
    lsb = 2.0 * _np(fs).astype(np.float64) / 2**adc_bits
    allow = 1.01 * lsb.sum(axis=0)                               # (C,)
    ref = _np(ref).astype(np.float64)
    diff = np.abs(_np(out).astype(np.float64) - ref)
    assert (diff <= allow[None, :]).all(), \
        f"B4 beyond one ADC LSB per array: max |err| {diff.max():.4e}"
    tight = float((diff <= rtol * np.abs(ref) + 1e-3).mean()) \
        if diff.size else 1.0
    assert tight >= tight_frac, f"only {tight:.4f} of B4's outputs are tight"
    return {"max_abs_err": float(diff.max()) if diff.size else 0.0,
            "tight": tight,
            "max_err_over_allow": float((diff / allow[None, :]).max())
            if diff.size else 0.0}


def _worst_fs(w, rows: int, x_max: float) -> np.ndarray:
    """The worst-case ranging ``fs = x_max * sum_r |w|`` (A, C), float64,
    of w (R_total, C) on arrays of ``rows``."""
    w_t = np.abs(_np(w).astype(np.float64))
    n = -(-w_t.shape[0] // rows)
    w_t = np.pad(w_t, ((0, n * rows - w_t.shape[0]), (0, 0))) \
        .reshape(n, rows, -1)
    return x_max * w_t.sum(axis=1)


def assert_adc_close(out, ref, w, rows: int, adc_bits: int,
                     x_max: float = X_MAX, tight_frac: float = 0.95) -> dict:
    """The reference's contract with the worst-case ranging of w
    (R_total, C) on arrays of ``rows``."""
    return adc_close(out, ref, _worst_fs(w, rows, x_max), adc_bits,
                     tight_frac=tight_frac)


def mac_operands(dev, gen, b, r, c):
    """x (b, r) uniform WL drives in [0, 255) and w (r, c) int8-range
    weights, f32 on the card."""
    x = torch.rand(b, r, generator=gen, device=dev) * X_MAX
    w = torch.randint(-127, 128, (r, c), generator=gen, device=dev)
    return x, w.to(torch.float32)


def _launch(x, w, load, fs, rows, ir, adc):
    before = cuda.launch_counts().get("cim_mac_fwd", 0)
    out = cim_mac_arrays(x, w, load, fs, array_rows=rows, ir_scale=ir,
                         adc_bits=adc)
    torch.cuda.synchronize()
    if cuda.launch_counts()["cim_mac_fwd"] != before + 1:
        raise AssertionError("B4 did not count exactly one launch")
    return out


def check_case(dev, gen, b, r, c, rows, adc=10, ir=None) -> dict:
    """B4 vs plain on flat operands with the column load and ADC range
    ``cim_mac`` gives them; the IR coefficient of
    ``CIMConfig(ir_gamma=0.04)`` at these rows unless given."""
    ir = 0.04 * (rows / 128) ** 0.5 if ir is None else ir
    x, w = mac_operands(dev, gen, b, r, c)
    return check_path(dev, (x, w, *array_stats(x, w, array_rows=rows,
                                                x_max=X_MAX)),
                      rows, ir, adc)


def check_tiled(dev, gen) -> dict:
    """The reference's tiled-identity case: pre-tiled (16, 3, 128) x
    (3, 128, 128) operands with a random column load, adc 8, ir 0.05, held
    at the explicit fs with the tighter 1e-6 relative criterion."""
    x_t = torch.rand(16, 3, 128, generator=gen, device=dev) * X_MAX
    w_t = torch.randint(-127, 128, (3, 128, 128), generator=gen,
                        device=dev).to(torch.float32)
    load = torch.rand(3, 128, generator=gen, device=dev)
    fs = X_MAX * w_t.abs().sum(dim=1)
    out = _launch(x_t.reshape(16, -1), w_t.reshape(-1, 128), load, fs, 128,
                  0.05, 8)
    return adc_close(out, cim_mac_plain(x_t, w_t, load, fs, 0.05, 8), fs, 8,
                     rtol=1e-6)


def zero_ir_atol(w, rows: int, adc_bits: int, x_max: float = X_MAX) -> float:
    """The largest rounding error a zero-IR run can carry per output: half
    an ADC LSB of the worst-case full scale, summed over the arrays."""
    fs = _worst_fs(w, rows, x_max)
    return float((fs / 2**adc_bits).sum(axis=0).max())


def check_zero_ir(dev, gen) -> float:
    """No IR-drop and a 24-bit ADC: B4 through ``cim_mac`` is the plain
    matmul within 1e-3 relative (24-bit rounding of the worst-case full
    scale leaves about 2e-4 of a typical output) plus half an LSB per
    array in absolute terms (outputs near zero).  Returns the max absolute
    error."""
    x, w = mac_operands(dev, gen, 8, 256, 16)
    before = cuda.launch_counts().get("cim_mac_fwd", 0)
    out = cim_mac(x, w, array_rows=128, ir_scale=0.0, adc_bits=24,
                  x_max=X_MAX)
    torch.cuda.synchronize()
    if cuda.launch_counts()["cim_mac_fwd"] != before + 1:
        raise AssertionError("B4 did not count exactly one launch")
    want = x @ w
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-3,
                               atol=zero_ir_atol(w, 128, 24))
    return float((out - want).abs().max())


def path_operands(dev, gen, b, r, c, rows):
    """(x, w, col_load, fs) at one of PATH_SHAPES: sparse KAN-like drives
    (K+1 = 4 of every 8-71 rows of a feature active, values 0..255) for
    C = 1, dense uniform drives otherwise."""
    x, w = mac_operands(dev, gen, b, r, c)
    if c == 1:
        x = torch.floor(x) * (torch.rand(b, r, generator=gen, device=dev)
                              < 4.0 * 17 / r)
    return (x, w, *array_stats(x, w, array_rows=rows, x_max=X_MAX))


def check_path(dev, operands, rows, ir, adc) -> dict:
    """B4 vs plain (on the operands tiled as the reference tiles them) on
    prepared (x, w, col_load, fs) (``path_operands``)."""
    x, w, load, fs = operands
    out = _launch(x, w, load, fs, rows, ir, adc)
    want = cim_mac_plain(*tile_rows(x, w, rows), load, fs, ir, adc)
    return assert_adc_close(out, want, w, rows, adc)


def check_rows(dev, gen, b, r, c, rows, adc, n: int = 32) -> dict:
    """B4 on (b, r) operands from ``path_operands`` against plain, then on
    n-row slices of x (the first rows, and rows from the middle, whose start
    is not 16-byte aligned at an odd r) with the same col_load and fs: each
    slice's output must equal the full call's rows bit for bit."""
    x, w, load, fs = ops = path_operands(dev, gen, b, r, c, rows)
    ir = CIMConfig(array_rows=rows, ir_gamma=0.06).ir_scale()
    out = _launch(x, w, load, fs, rows, ir, adc)
    st = assert_adc_close(out, cim_mac_plain(*tile_rows(x, w, rows), load, fs,
                                             ir, adc), w, rows, adc)
    for start in (0, b // 2 + 1):
        part = _launch(x[start:start + n], w, load, fs, rows, ir, adc)
        if not torch.equal(part, out[start:start + n]):
            raise AssertionError(
                f"B4 rows {start}..{start + n} differ between B = {n} and "
                f"B = {b}")
    del ops
    return st
