"""Kernel B4 on the card: the ACIM simulator MAC over arrays of rows.

Replaces ``repro/kernels/cim_mac/kernel.py::_cim_mac_kernel`` (via
``cim_mac_pallas``) with ``csrc/cim_mac.cu`` (entry point ``cim_mac_fwd``):
one block per (row block, column tile) walks the arrays in order and
stages each array's IR-drop-attenuated weights in shared memory; ragged B,
C and the last array's rows are masked in the kernel, so nothing is padded.
It does 2*B*R_total*C f32 operations on one read of x; with C = 1 (the
paper's layer-1 MACs) the bytes of x bound it.  Its plain version is
:func:`.ref.cim_mac_plain` on the operands tiled by :func:`.ref.tile_rows`.
"""

from __future__ import annotations

import torch

from ...core.asp_quant import f32
from .. import cuda
from .ref import cim_mac_plain, comp_scale, tile_rows

__all__ = ["cim_mac_arrays"]


def _check(name, t, shape, dev):
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or t.device != dev):
        raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}, want {shape} float32 on {dev}")


def _cim_mac_cuda(x, w, col_load, fs, array_rows, ir_scale, adc_bits):
    bsz, r_total = x.shape
    cols = w.shape[-1]
    out = torch.empty((bsz, cols), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or r_total == 0:
        return out.zero_()
    status = cuda.library().cim_mac_fwd(
        cuda.ptr(x), cuda.ptr(w), cuda.ptr(col_load), cuda.ptr(fs),
        cuda.ptr(out), bsz, r_total, array_rows, cols, f32(ir_scale),
        comp_scale(ir_scale, array_rows), adc_bits,
        *cuda.stream_args(x.device),
    )
    cuda.check(status)
    cuda.LAUNCHES["cim_mac_fwd"] += 1
    return out


def cim_mac_arrays(x: torch.Tensor, w: torch.Tensor, col_load: torch.Tensor,
                   fs: torch.Tensor, *, array_rows: int, ir_scale: float,
                   adc_bits: int) -> torch.Tensor:
    """The ACIM MAC of x (B, R_total) and w (R_total, C) on A =
    ceil(R_total / array_rows) arrays, with col_load and fs (A, C), all f32
    on one device -> (B, C) f32: kernel B4 for CUDA tensors, the plain
    version for CPU tensors."""
    bsz, r_total = x.shape
    cols = w.shape[-1]
    n_arrays = -(-r_total // array_rows)
    dev = x.device
    _check("x", x, (bsz, r_total), dev)
    _check("w", w, (r_total, cols), dev)
    _check("col_load", col_load, (n_arrays, cols), dev)
    _check("fs", fs, (n_arrays, cols), dev)
    if x.is_cuda:
        return _cim_mac_cuda(x.contiguous(), w.contiguous(),
                             col_load.contiguous(), fs.contiguous(),
                             array_rows, ir_scale, adc_bits)
    return cim_mac_plain(*tile_rows(x, w, array_rows), col_load, fs,
                         ir_scale, adc_bits)
