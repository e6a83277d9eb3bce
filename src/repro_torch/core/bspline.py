"""Uniform B-spline basis: the float reference for KAN layers.

Port of ``repro.core.bspline``.  Each edge function is
``spline(x) = sum_i c_i B_i(x)`` over G+K order-K B-splines on a uniform
knot grid over ``[lo, hi]`` extended by K intervals on each side.  Because
the knots are uniform every ``B_i`` is a shifted copy of one cardinal bump
``b_K`` on ``[0, K+1]``: the property ASP quantization exploits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["extended_knots", "bspline_basis", "bspline_basis_fast",
           "cardinal_bump", "num_basis"]


def num_basis(grid_size: int, order: int) -> int:
    """Number of B-spline basis functions: G + K."""
    return grid_size + order


def extended_knots(lo: float, hi: float, grid_size: int, order: int) -> np.ndarray:
    """Uniform knot vector extended by ``order`` intervals on each side.

    Returns G + 2K + 1 knots: t_j = lo + (j - K) * h,  h = (hi-lo)/G.
    """
    h = (hi - lo) / grid_size
    j = np.arange(grid_size + 2 * order + 1, dtype=np.float64)
    return lo + (j - order) * h


def bspline_basis(x: torch.Tensor, lo: float, hi: float, grid_size: int,
                  order: int) -> torch.Tensor:
    """All G+K uniform B-spline bases at ``x`` (Cox-de Boor).

    ``x`` of any shape is clamped into ``[lo, hi)``; returns
    ``x.shape + (G+K,)`` in ``x.dtype``, rows summing to 1 on the domain.
    """
    t = torch.as_tensor(extended_knots(lo, hi, grid_size, order),
                        dtype=x.dtype, device=x.device)
    h = (hi - lo) / grid_size
    eps = torch.tensor(1e-6 * h, dtype=x.dtype, device=x.device)
    xc = torch.minimum(torch.clamp(x, min=lo), hi - eps)[..., None]

    # degree 0: indicator over each of the G+2K knot intervals
    b = ((xc >= t[:-1]) & (xc < t[1:])).to(x.dtype)
    for k in range(1, order + 1):
        t_i = t[: -(k + 1)]
        t_ik = t[k:-1]
        t_i1 = t[1:-k]
        t_ik1 = t[k + 1:]
        left = (xc - t_i) / (t_ik - t_i) * b[..., :-1]
        right = (t_ik1 - xc) / (t_ik1 - t_i1) * b[..., 1:]
        b = left + right
    return b


@functools.lru_cache(maxsize=64)
def _cardinal_bump_coeffs(order: int) -> np.ndarray:
    """Polynomial coefficients of b_K per segment: (K+1 segments, K+1 powers).

    Segment s covers t in [s, s+1) as a degree-K polynomial in u = t - s,
    built exactly by the Cox-de Boor recursion over coefficient arrays.
    """
    polys = [np.array([[1.0]])]
    for k in range(1, order + 1):
        prev = polys[k - 1]
        cur = np.zeros((k + 1, k + 1))
        # b_k(t) = t/k * b_{k-1}(t) + (k+1-t)/k * b_{k-1}(t-1)
        for s in range(k + 1):
            if s <= k - 1:
                p = prev[s]
                cur[s, :k] += (s / k) * p
                cur[s, 1:k + 1] += (1.0 / k) * p
            if 1 <= s <= k:
                p = prev[s - 1]
                cur[s, :k] += ((k + 1 - s) / k) * p
                cur[s, 1:k + 1] += (-1.0 / k) * p
        polys.append(cur)
    return polys[order]


def bspline_basis_fast(x: torch.Tensor, lo: float, hi: float, grid_size: int,
                       order: int) -> torch.Tensor:
    """Uniform-knot basis via the shared cardinal-bump polynomial.

    The K+1 active values of each input are degree-K polynomials in the
    intra-interval offset, placed at their band positions by an index
    compare; equal to :func:`bspline_basis` for uniform knots, without its
    K intermediate (x.shape, G+2K) tensors.  Returns ``x.shape + (G+K,)``
    in f32 (the LM float KAN-FFN path).
    """
    h = (hi - lo) / grid_size
    tau = torch.clamp((x.to(torch.float32) - lo) / h, 0.0,
                      grid_size * (1 - 1e-7))
    g = torch.floor(tau)
    u = tau - g
    g = g.to(torch.int32)

    coeffs = _cardinal_bump_coeffs(order)  # (K+1 segments, K+1 powers)
    nb = grid_size + order
    iota = torch.arange(nb, dtype=torch.int32, device=x.device)
    basis = torch.zeros(x.shape + (nb,), dtype=torch.float32, device=x.device)
    for d in range(order + 1):
        seg = order - d  # active slot d lives on bump segment K-d
        val = torch.zeros_like(u)
        for p in reversed(range(order + 1)):  # Horner
            val = val * u + float(coeffs[seg, p])
        basis = basis + torch.where(iota == (g + d)[..., None], val[..., None],
                                    0.0)
    return basis


def cardinal_bump(t: np.ndarray, order: int) -> np.ndarray:
    """Evaluate the canonical cardinal B-spline b_K on [0, K+1] (numpy f64)."""
    t = np.asarray(t, dtype=np.float64)
    coeffs = _cardinal_bump_coeffs(order)
    seg = np.clip(np.floor(t).astype(np.int64), 0, order)
    u = t - seg
    out = np.zeros_like(t)
    for p in range(order + 1):
        out += coeffs[seg, p] * u**p
    return np.where((t < 0) | (t > order + 1), 0.0, out)
