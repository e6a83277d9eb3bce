"""Kernel B4 on the card: the ACIM simulator MAC over arrays of rows.

Replaces ``repro/kernels/cim_mac/kernel.py::_cim_mac_kernel`` (via
``cim_mac_pallas``) with ``csrc/cim_mac.cu`` (entry point ``cim_mac_fwd``).
It does 2*B*R_total*C f32 operations on one read of x; with C = 1 (the
paper's layer-1 MACs) the bytes of x bound it.  :func:`mac_plan` picks the
path from the shapes alone (never from B, so a row's bits do not depend
on the batch): at C = 1 the stream path, whose persistent blocks bring
tiles of ``tile_rows`` rows into a ring of shared-memory stages with TMA
bulk copies; otherwise the wide path, whose blocks sum 128-row chunks of
one array into an f32 workspace that a combine pass rounds and adds in
order (timed on the card only at the reference's 32-row case; its
workspace is A x chunks times the output).  Ragged B, C and the last array's rows are masked in the kernel,
so nothing is padded.  Its plain version is :func:`.ref.cim_mac_plain` on
the operands tiled by :func:`.ref.tile_rows`.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core.asp_quant import f32
from .. import cuda
from .ref import cim_mac_plain, comp_scale, tile_rows

__all__ = ["MacPlan", "cim_mac_arrays", "mac_plan", "stream_smem_bytes"]

# an H100 block's opt-in shared memory (227 KB), the budget of a stream
# plan's stages
SMEM_BYTES = 232448
# a stream stage's target size and the ring's depth (kStages in
# csrc/cim_mac.cu): 2 x 16 KB per block leaves room for 4 resident blocks
# on an SM, which streamed faster than 4 or 8 deeper stages on fewer blocks
# (PERF.md)
STAGE_BYTES = 16 * 1024
STAGES = 2
MAX_TILE_ROWS = 256
# the wide path's R-chunk (kChunk in csrc/cim_mac.cu)
CHUNK_ROWS = 128


@dataclasses.dataclass(frozen=True)
class MacPlan:
    """How B4 runs one shape: ``tile_rows`` > 0 is the stream path (rows
    per tile, a multiple of 4), 0 the wide path with ``chunks`` R-chunks
    per array."""

    tile_rows: int
    chunks: int


def stream_smem_bytes(r_total: int, n_arrays: int, tile_rows: int) -> int:
    """Shared-memory bytes of a stream block (``stream_smem_bytes`` in
    csrc/cim_mac.cu): 128 bytes of barriers, the STAGES stages, the
    attenuated weights, 3 constants per array and two buffers of pair
    sums."""
    def round4(n):
        return -(-n // 4) * 4

    return 128 + 4 * (STAGES * tile_rows * r_total + round4(r_total)
                      + round4(3 * n_arrays) + 2 * tile_rows * n_arrays)


def mac_plan(r_total: int, cols: int, array_rows: int) -> MacPlan:
    """B4's plan for x (B, r_total) and w (r_total, cols) on arrays of
    ``array_rows``: a function of these widths alone, never of B."""
    n_arrays = -(-r_total // array_rows)
    if cols == 1:
        tile = STAGE_BYTES // (4 * r_total) // 4 * 4
        tile = max(4, min(MAX_TILE_ROWS, tile))
        if stream_smem_bytes(r_total, n_arrays, tile) <= SMEM_BYTES:
            return MacPlan(tile, 0)
    return MacPlan(0, -(-array_rows // CHUNK_ROWS))


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
    plan = mac_plan(r_total, cols, array_rows)
    ws = None
    if plan.tile_rows == 0:
        ws = torch.empty((col_load.shape[0] * plan.chunks, bsz, cols),
                         dtype=torch.float32, device=x.device)
    elif x.data_ptr() % 16:
        x = x.clone()  # a bulk copy starts on a 16-byte boundary
    status = cuda.library().cim_mac_fwd(
        cuda.ptr(x), cuda.ptr(w), cuda.ptr(col_load), cuda.ptr(fs),
        cuda.ptr(out), cuda.ptr(ws), bsz, r_total, array_rows, cols,
        plan.tile_rows, plan.chunks, f32(ir_scale),
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
