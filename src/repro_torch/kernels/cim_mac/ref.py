"""Plain PyTorch version of kernel B4 on the tiled 3-D operands.

Port of ``repro.kernels.cim_mac.ref.cim_mac_ref``, in its formula and op
order (``core.cim.cim_matmul`` with ``deterministic=True``; the stochastic
terms are elementwise on the per-array partials and stay outside)::

  per array a:  w_eff[r,c] = w[a,r,c] * clip(1 - ir_scale * dist[r] * load[a,c], 0, 1)
                partial[b,a,c] = sum_r x[b,a,r] * w_eff[r,c]
                partial /= max(1 - ir_scale * mean_dist * load[a,c], 1e-3)
                partial = round_half_even(clip(partial, +-fs) / lsb) * lsb
  out[b,c] = sum_a partial[b,a,c]

with dist[r] = (r+1)/R, mean_dist = (R+1)/(2R), lsb = 2 fs / 2**adc_bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.asp_quant import f32
from ...core.cim import row_distance

__all__ = ["cim_mac_plain", "comp_scale", "tile_rows"]


def tile_rows(x: torch.Tensor, w: torch.Tensor, array_rows: int) -> tuple:
    """x (B, R_total) and w (R_total, C) as f32 x (B, A, R) and w (A, R, C):
    R_total zero-padded to A whole arrays of ``array_rows``, as the
    reference tiles them."""
    bsz, r_total = x.shape
    n_arrays = -(-r_total // array_rows)
    pad = n_arrays * array_rows - r_total
    x_t = F.pad(x.to(torch.float32), (0, pad)) \
        .reshape(bsz, n_arrays, array_rows)
    w_t = F.pad(w.to(torch.float32), (0, 0, 0, pad)) \
        .reshape(n_arrays, array_rows, w.shape[-1])
    return x_t, w_t


def comp_scale(ir_scale: float, rows: int) -> float:
    """The f32 coefficient of the mean-attenuation compensation,
    ``ir_scale * (R+1)/(2R)`` rounded once (the reference multiplies the
    two Python doubles first)."""
    return f32(ir_scale * ((rows + 1.0) / (2.0 * rows)))


def cim_mac_plain(x: torch.Tensor, w: torch.Tensor, col_load: torch.Tensor,
                  fs: torch.Tensor, ir_scale: float,
                  adc_bits: int) -> torch.Tensor:
    """x (B, A, R), w (A, R, C), col_load and fs (A, C), all f32 -> (B, C)."""
    rows = x.shape[2]
    dist = row_distance(rows, x.device)
    factor = torch.clamp(
        1.0 - f32(ir_scale) * dist[None, :, None] * col_load[:, None, :],
        0.0, 1.0)
    partial = torch.einsum("bar,arc->bac", x.to(torch.float32),
                           w.to(torch.float32) * factor)
    comp = torch.clamp_min(1.0 - comp_scale(ir_scale, rows) * col_load,
                           f32(1e-3))
    partial = partial / comp[None]
    lsb = 2.0 * fs / (2**adc_bits)
    partial = torch.clamp(partial, -fs[None], fs[None])
    partial = torch.round(partial / lsb[None]) * lsb[None]
    return partial.sum(dim=1)
