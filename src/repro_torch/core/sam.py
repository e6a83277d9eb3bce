"""KAN-SAM: sparsity-aware weight mapping (paper §3.3).

Port of ``repro.core.sam``.  Only K+1 of the G+K basis functions fire for
any input, so the word-line rows of the c' array have very unequal
activation probability.  IR-drop attenuation grows with a row's distance
from the BL clamp, and deployment (cim.py) compensates each column by the
MEAN attenuation over the array, so the placement-dependent residual is
smallest when the highest-drive rows sit at the slots whose distance is
closest to that compensated mean; rarely-firing rows take the extreme
near/far slots.  A pure permutation, no hardware or algorithm change.

Physical convention (as in cim.py): physical row 0 is closest to the BL
clamp; attenuation grows with the physical row index.
"""

from __future__ import annotations

import numpy as np
import torch

from .asp_quant import ASPQuantSpec, quantize_input
from .bspline import bspline_basis

__all__ = [
    "basis_activation_probability",
    "row_activation_weight",
    "sam_permutation",
    "identity_permutation",
    "apply_row_permutation",
]


def basis_activation_probability(x_samples: torch.Tensor,
                                 spec: ASPQuantSpec) -> torch.Tensor:
    """P_i = fraction of inputs for which B_i is active (g <= i <= g+K).

    x_samples: calibration inputs of ONE input feature (or pooled), any
    shape.  Returns (G+K,) f32 probabilities.
    """
    codes = quantize_input(x_samples.reshape(-1), spec)
    g = codes >> spec.ld  # active bands are g..g+K
    iota = torch.arange(spec.num_basis, device=codes.device)
    active = (iota[None, :] >= g[:, None]) \
        & (iota[None, :] <= g[:, None] + spec.order)
    return active.to(torch.float32).mean(dim=0)


def row_activation_weight(x_samples: torch.Tensor, spec: ASPQuantSpec,
                          in_dim: int) -> torch.Tensor:
    """Expected drive per word-line row of a KAN layer: E[B_i(x_f)] for the
    flattened rows ``f * (G+K) + i``.  x_samples: (S, in_dim)."""
    b = bspline_basis(x_samples, spec.lo, spec.hi, spec.grid_size, spec.order)
    return b.mean(dim=0).reshape(in_dim * spec.num_basis)


def sam_permutation(row_weight, array_rows: int | None = None) -> np.ndarray:
    """perm[p] = logical row placed at physical (flat) position p.

    Physical distance of flat position p is ((p % array_rows) + 1) /
    array_rows; the highest expected-drive rows go to the slots closest to
    the compensated mean distance (interleaved across array tiles).
    """
    if isinstance(row_weight, torch.Tensor):
        row_weight = row_weight.detach().cpu().numpy()
    w = np.asarray(row_weight)
    r = len(w)
    best_first = np.argsort(-w, kind="stable")
    rows = r if array_rows is None else array_rows
    dist = ((np.arange(r) % rows) + 1.0) / rows
    mean_d = (rows + 1.0) / (2.0 * rows)
    pos_by_match = np.argsort(np.abs(dist - mean_d), kind="stable")
    perm = np.empty(r, np.int64)
    perm[pos_by_match] = best_first
    return perm


def identity_permutation(n_rows: int) -> np.ndarray:
    return np.arange(n_rows)


def apply_row_permutation(w_rows: torch.Tensor, perm) -> torch.Tensor:
    """Place logical rows at their physical positions: out[p] = w[perm[p]]."""
    idx = torch.as_tensor(np.asarray(perm), device=w_rows.device)
    return w_rows.index_select(0, idx)
