"""The ACIM simulator MAC on flat operands: column load, ADC range.

Port of ``repro.kernels.cim_mac.ops.cim_mac``.  Computes each (array,
column)'s normalized load and ADC full scale on the real rows, columns
and batch, and hands x (B, R_total) and w (R_total, C) as they are to
kernel B4 (:mod:`.kernel`).  Unlike the reference it pads neither the
batch, the columns nor x's rows: the kernel masks its ragged edges and the
last array's missing rows, so no padded ``fs`` lanes exist.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.asp_quant import f32
from .kernel import cim_mac_arrays

__all__ = ["array_stats", "cim_mac"]


def array_stats(x: torch.Tensor, w: torch.Tensor, *, array_rows: int,
                x_max: float) -> tuple:
    """(col_load (A, C), fs (A, C)), f32, of x (B, R_total) drives and w
    (R_total, C) weights on A = ceil(R_total / array_rows) arrays."""
    bsz, r_total = x.shape
    if w.shape[0] != r_total:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form a (B, R) @ (R, C) product")
    cols = w.shape[-1]
    n_arrays = -(-r_total // array_rows)
    pad = n_arrays * array_rows - r_total
    w_t = F.pad(w.to(torch.float32).abs(), (0, 0, 0, pad)) \
        .reshape(n_arrays, array_rows, cols)
    # the reference's einsum "bar,arc->ac" over the padded drives, summed
    # over the batch first (padded rows are zero and add nothing), so x is
    # read once and not copied
    x_rows = F.pad(x.to(torch.float32).sum(dim=0) / f32(x_max), (0, pad)) \
        .reshape(n_arrays, array_rows)
    w_amax = torch.clamp_min(w_t.max(), 1e-9)
    col_load = torch.einsum("ar,arc->ac", x_rows, w_t / w_amax) \
        / (array_rows * bsz)
    col_load = col_load / torch.clamp_min(col_load.mean(), 1e-12)
    fs = torch.clamp_min(f32(x_max) * w_t.sum(dim=1), 1e-9)
    return col_load, fs


def cim_mac(x: torch.Tensor, w: torch.Tensor, *, array_rows: int,
            ir_scale: float, adc_bits: int, x_max: float) -> torch.Tensor:
    """ACIM MAC of x (B, R_total) WL drives and w (R_total, C) weights on
    arrays of ``array_rows``: (B, C) f32, equal to ``core.cim.cim_matmul``
    with ``deterministic=True`` up to one ADC LSB per array."""
    col_load, fs = array_stats(x, w, array_rows=array_rows, x_max=x_max)
    return cim_mac_arrays(x.to(torch.float32), w.to(torch.float32), col_load,
                          fs, array_rows=array_rows, ir_scale=ir_scale,
                          adc_bits=adc_bits)
