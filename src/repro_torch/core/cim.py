"""RRAM-ACIM behavioral simulator (paper §2.2, §3.3, Fig. 12).

Port of ``repro.core.cim``.  Models the analog MAC ``y[c] = sum_r x[r] *
w[r, c]`` on word-line drives ``x`` (B(X) codes through the TM-DV input
generator) against int8 conductance weights ``w``, with the non-idealities
calibrated from the TSMC 22nm RRAM-ACIM prototype:

  * **IR-drop** on the bit line: a cell's contribution attenuates with its
    distance from the BL clamp and with the column's current; it grows
    with array size (Fig. 12 sweeps 128..1024 rows);
  * **input-generator noise** (TM-DV / pure voltage / pure PWM, tmdv.py);
  * **partial-sum error**: a per-array Gaussian on the analog sum (std
    growing with sqrt(rows)), then ADC quantization of each array's sum.

KAN-SAM enters as a physical row permutation (sam.py).

This module is the plain simulator, in the reference's op order; the tiled
hot loop is kernel B4 under ``kernels/cim_mac``.  The reference's PRNG key
becomes a ``torch.Generator`` (needed only when ``deterministic`` is off).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .asp_quant import f32
from .tmdv import TD_A, TMDVConfig, apply_input_noise

__all__ = ["CIMConfig", "cim_matmul", "ideal_matmul", "irdrop_factors",
           "row_distance"]


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """One RRAM-ACIM macro configuration."""

    array_rows: int = 128
    adc_bits: int = 8
    # IR-drop coefficient: fractional loss for the FARTHEST row of a
    # 128-row array at full column load (calibrated to Fig. 12's trend).
    ir_gamma: float = 0.04
    # Partial-sum noise std at 128 rows, in units of one LSB of input*weight.
    sigma_ps_ref: float = 1.0
    input_gen: TMDVConfig = dataclasses.field(default_factory=TD_A)
    deterministic: bool = False  # disable stochastic noise (IR-drop stays)

    def ir_scale(self) -> float:
        """IR-drop grows with BL length; sub-linear (sqrt) in rows because
        clamp circuits are upsized with array height."""
        return self.ir_gamma * float(np.sqrt(self.array_rows / 128.0))

    def sigma_ps(self) -> float:
        return self.sigma_ps_ref * float(np.sqrt(self.array_rows / 128.0))


def row_distance(rows: int, device=None) -> torch.Tensor:
    """(rows,) f32 distance of each physical row from the BL clamp,
    ``(p + 1) / rows``, each an IEEE f32 quotient (numpy rounds the
    division exactly; a CUDA tensor-by-scalar division would multiply by
    the reciprocal)."""
    dist = (np.arange(rows, dtype=np.float32) + np.float32(1.0)) \
        / np.float32(rows)
    return torch.from_numpy(dist).to(device)


def irdrop_factors(cfg: CIMConfig, col_load: torch.Tensor) -> torch.Tensor:
    """Effective-weight attenuation (rows, cols):
    ``1 - ir_scale * ((p+1)/rows) * col_load[c]``, physical row p = 0
    nearest the clamp, col_load the column's normalized current."""
    dist = row_distance(cfg.array_rows, col_load.device)
    return 1.0 - f32(cfg.ir_scale()) * dist[:, None] * col_load[None, :]


def ideal_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) @ w.to(torch.float32)


def cim_matmul(x: torch.Tensor, w: torch.Tensor, cfg: CIMConfig,
               generator: torch.Generator | None = None, row_perm=None,
               x_max: float | None = None,
               adc_calibrate: bool = False) -> torch.Tensor:
    """Simulated ACIM MAC: the ideal ``x @ w`` in code domain with the
    calibrated non-idealities.

    Args:
      x: (B, R) non-negative WL input codes, in [0, 2**total_bits - 1].
      w: (R, C) weights (int8-scale floats or ints).
      cfg: macro config.
      generator: draws the stochastic noise (input noise first, then the
        partial-sum noise); unused, and may be None, when
        ``cfg.deterministic``.
      row_perm: optional (R,) physical placement, perm[p] = logical row at
        physical position p (KAN-SAM).  None -> natural order.
      x_max: full-scale input code (ADC ranging); default from input_gen.
      adc_calibrate: range each ADC to 1.25x the observed ideal partials
        instead of the worst case ``x_max * sum|w|``.

    Returns (B, C) f32 in the scale of ``x @ w``.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         "not form a (B, R) @ (R, C) product")
    if not cfg.deterministic and generator is None:
        raise ValueError("a noisy CIMConfig needs a torch.Generator")
    bsz, r_total = x.shape
    cols = w.shape[1]
    rows = cfg.array_rows
    if x_max is None:
        x_max = float(2**cfg.input_gen.total_bits - 1)

    if row_perm is not None:
        perm = torch.as_tensor(np.asarray(row_perm), device=x.device)
        x = x.index_select(1, perm)
        w = w.index_select(0, perm)

    # pad logical rows up to a multiple of the array height
    n_arrays = -(-r_total // rows)
    pad = n_arrays * rows - r_total
    xt = F.pad(x.to(torch.float32), (0, pad)).reshape(bsz, n_arrays, rows)
    wt = F.pad(w.to(torch.float32), (0, 0, 0, pad)) \
        .reshape(n_arrays, rows, cols)

    if cfg.deterministic:
        x_eff = xt
    else:
        x_eff = apply_input_noise(xt, cfg.input_gen, generator)

    # column load: batch-mean fraction of full-scale current per column,
    # normalized to the mean column (ir_gamma is then the attenuation of
    # the farthest row of a typically loaded column)
    w_amax = torch.clamp_min(wt.abs().max(), 1e-9)
    col_load = torch.einsum("bar,arc->ac", xt / f32(x_max),
                            wt.abs() / w_amax) / (rows * bsz)
    col_load = col_load / torch.clamp_min(col_load.mean(), 1e-12)
    dist = row_distance(rows, x.device)
    factor = 1.0 - f32(cfg.ir_scale()) * dist[None, :, None] \
        * col_load[:, None, :]
    factor = torch.clamp(factor, 0.0, 1.0)  # attenuation is physical
    w_eff = wt * factor  # (arrays, rows, cols)

    partial = torch.einsum("bar,arc->bac", x_eff, w_eff)

    if not cfg.deterministic:
        partial = partial + f32(cfg.sigma_ps() * x_max) * torch.randn(
            partial.shape, generator=generator, device=partial.device)

    # digital calibration: the MEAN attenuation of a column is compensated
    # by a per-column scale; the row-placement residual is what remains
    # (and what KAN-SAM minimizes)
    mean_dist = float((rows + 1) / (2 * rows))
    comp = 1.0 - f32(cfg.ir_scale() * mean_dist) * col_load  # (arrays, cols)
    partial = partial / torch.clamp_min(comp, f32(1e-3))[None]

    # per-array ADC over the full-scale range
    if adc_calibrate:
        ideal_partial = torch.einsum("bar,arc->bac", xt, wt)
        fs = 1.25 * torch.clamp_min(ideal_partial.abs().amax(dim=0), 1e-9)
    else:
        fs = torch.clamp_min(f32(x_max) * wt.abs().sum(dim=1), 1e-9)
    lsb = 2.0 * fs / (2**cfg.adc_bits)
    partial = torch.clamp(partial, -fs[None], fs[None])
    partial = torch.round(partial / lsb[None]) * lsb[None]
    return partial.sum(dim=1)
