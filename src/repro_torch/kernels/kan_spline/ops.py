"""Public wrappers of the single-layer ASP KAN-spline kernel (B3).

Port of ``repro.kernels.kan_spline.ops``.  CUDA tensors launch the kernel
(which masks ragged B/F/O itself, so nothing is padded); CPU tensors take
the plain version ``ref.kan_spline_ref``.  There is no fallback between the
two.
"""

from __future__ import annotations

import torch

from ...core.asp_quant import ASPQuantSpec
from .kernel import kan_spline_cuda
from .pipeline import feature_split_plan
from .ref import kan_spline_ref

__all__ = ["kan_spline", "kan_spline_from_qparams"]


def kan_spline(
    codes: torch.Tensor,   # (B, F) int32
    lut: torch.Tensor,     # (2**LD, K+1)
    wc: torch.Tensor,      # (F, G+K, O)
    wb: torch.Tensor,      # (F, O)
    spec: ASPQuantSpec,
) -> torch.Tensor:
    f, nb, o = wc.shape
    if not codes.is_cuda:
        return kan_spline_ref(codes, lut, wc, wb, spec,
                              feature_splits=feature_split_plan(f, o)[0])
    return kan_spline_cuda(
        codes.to(torch.int32).contiguous(),
        lut.to(torch.float32).contiguous(),
        wc.to(torch.float32).reshape(f * nb, o).contiguous(),
        wb.to(torch.float32).contiguous(),
        spec,
    )


def kan_spline_from_qparams(codes: torch.Tensor, qparams: dict,
                            spec: ASPQuantSpec) -> torch.Tensor:
    """Run the kernel from ``quantize_kan_layer`` output (dequantized)."""
    wc = qparams["c_q"].to(torch.float32) * qparams["c_scale"]
    wb = qparams["w_b_q"].to(torch.float32) * qparams["w_b_scale"]
    return kan_spline(codes, qparams["lut"], wc, wb, spec)
