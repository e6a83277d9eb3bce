"""Kernel B3: the single-layer ASP KAN-spline kernel on the card.

Replaces ``repro/kernels/kan_spline/kernel.py::_kan_spline_kernel`` (via
``kan_spline_pallas``).  It is the single-layer instance of the fused layer
kernel in ``csrc/kan_spline.cu`` (entry point ``kan_spline_fwd``): no
packing, no noise, no requantizer, residual ``relu(deq(codes))``.  Its
operands are unpadded, so its bound is the larger of its bytes (codes in,
outputs out, weights once) at the card's memory rate and its K+2 band FMAs
per (b, f, o) at the f32 rate: at KAN1's widths, the bytes.  It splits the
feature axis as B1 does (``pipeline.feature_split_plan``; the wrapper
allocates the splits' workspace).  Its plain version is
``ref.kan_spline_ref``.
"""

from __future__ import annotations

import torch

from ...core.asp_quant import ASPQuantSpec, f32
from .. import cuda
from .pipeline import feature_split_plan

__all__ = ["kan_spline_cuda"]


def kan_spline_cuda(
    codes: torch.Tensor,   # (B, F) int32, on the card
    lut: torch.Tensor,     # (2**LD, K+1) f32
    wc: torch.Tensor,      # (F * NB, O) f32, flattened (f, i) rows
    wb: torch.Tensor,      # (F, O) f32
    spec: ASPQuantSpec,
) -> torch.Tensor:
    """Launch B3; any B, F, O (the kernel masks its ragged edges)."""
    bsz, f = codes.shape
    nb, kk = spec.num_basis, spec.order + 1
    o = wc.shape[-1]
    dev = codes.device
    for name, t, shape, dtype in (
        ("codes", codes, (bsz, f), torch.int32),
        ("lut", lut, (spec.codes_per_interval, kk), torch.float32),
        ("wc", wc, (f * nb, o), torch.float32),
        ("wb", wb, (f, o), torch.float32),
    ):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: got {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"want contiguous {shape} {dtype} on {dev}"
            )
    cuda.check_spec(spec)
    y = torch.empty((bsz, o), dtype=torch.float32, device=dev)
    splits, fps = feature_split_plan(f, o)
    ws = (torch.empty((splits, bsz, o), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    status = cuda.library().kan_spline_fwd(
        cuda.ptr(codes), cuda.ptr(lut), cuda.ptr(wc), cuda.ptr(wb),
        cuda.ptr(y), cuda.ptr(ws), bsz, f, o, nb, kk, spec.ld, splits, fps,
        f32(spec.lo), f32(spec.code_step), *cuda.stream_args(dev),
    )
    cuda.check(status)
    cuda.LAUNCHES["kan_spline"] += 1
    return y
