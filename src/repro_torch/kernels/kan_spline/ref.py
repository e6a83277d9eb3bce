"""Plain PyTorch version of the single-layer ASP KAN-spline kernel (B3).

Port of ``repro.kernels.kan_spline.ref``.  For input codes (B, F):

    basis[b, f, i] = SH-LUT value of B_i at code[b, f]   (i in [0, G+K))
    y[b, o] = sum_{f,i} basis[b,f,i] * wc[f,i,o] + relu(deq(code[b,f])) * wb[f,o]

The CUDA kernel in :mod:`.kernel` is held against this function.
"""

from __future__ import annotations

import torch

from ...core.asp_quant import ASPQuantSpec, dense_basis_from_codes, f32

__all__ = ["kan_spline_ref"]


def kan_spline_ref(
    codes: torch.Tensor,   # (B, F) int32 in [0, G*2**LD)
    lut: torch.Tensor,     # (2**LD, K+1) float
    wc: torch.Tensor,      # (F, G+K, O) spline coefficients (c')
    wb: torch.Tensor,      # (F, O) residual-branch weights
    spec: ASPQuantSpec,
) -> torch.Tensor:
    basis = dense_basis_from_codes(codes, lut, spec)
    bsz, f, nb = basis.shape
    o = wc.shape[-1]
    y = basis.reshape(bsz, f * nb).to(torch.float32) \
        @ wc.reshape(f * nb, o).to(torch.float32)
    xdeq = f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)
    return y + torch.relu(xdeq) @ wb.to(torch.float32)
