"""Plain PyTorch version of the single-layer ASP KAN-spline kernel (B3).

Port of ``repro.kernels.kan_spline.ref``.  For input codes (B, F):

    basis[b, f, i] = SH-LUT value of B_i at code[b, f]   (i in [0, G+K))
    y[b, o] = sum_{f,i} basis[b,f,i] * wc[f,i,o] + relu(deq(code[b,f])) * wb[f,o]

With ``feature_splits`` > 1 the features are cut as the CUDA kernel cuts
them (``pipeline.feature_split_bounds``), each slice is summed on its own
and the slices are added in order.  The CUDA kernel in :mod:`.kernel` is
held against this function.
"""

from __future__ import annotations

import torch

from ...core.asp_quant import ASPQuantSpec, dense_basis_from_codes, f32
from .pipeline import feature_split_bounds

__all__ = ["kan_spline_ref"]


def kan_spline_ref(
    codes: torch.Tensor,   # (B, F) int32 in [0, G*2**LD)
    lut: torch.Tensor,     # (2**LD, K+1) float
    wc: torch.Tensor,      # (F, G+K, O) spline coefficients (c')
    wb: torch.Tensor,      # (F, O) residual-branch weights
    spec: ASPQuantSpec,
    feature_splits: int = 1,
) -> torch.Tensor:
    basis = dense_basis_from_codes(codes, lut, spec).to(torch.float32)
    bsz, f, nb = basis.shape
    o = wc.shape[-1]
    wc = wc.to(torch.float32)
    xdeq = f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)
    relu = torch.relu(xdeq)
    wb = wb.to(torch.float32)
    y = None
    for lo, hi in feature_split_bounds(f, f, feature_splits):
        part = (basis[:, lo:hi].reshape(bsz, (hi - lo) * nb)
                @ wc[lo:hi].reshape((hi - lo) * nb, o)
                + relu[:, lo:hi] @ wb[lo:hi])
        y = part if y is None else y + part
    return y
