"""ASP-KAN-HAQ: Alignment-Symmetry and PowerGap KAN quantization (paper §3.1).

Port of ``repro.core.asp_quant``.  The quantization grid is an integer
multiple ``2**LD`` of the knot grid (``G * 2**LD <= 2**n``, eq. (6)), so a code
splits into bit fields::

    global = code >> LD              -> knot-interval index g
    local  = code & (2**LD - 1)      -> intra-interval offset

and ONE shared LUT of ``(2**LD, K+1)`` bump values serves every basis
function; its mirror symmetry halves storage (the SH-LUT).

Beside it, the conventional PACT baseline (misaligned grids, one table per
basis function: the paper's Fig. 2).

Host-side construction (``build_lut``, ``hemi_fold``, ``pact_basis_tables``)
runs in numpy float64 exactly as the reference does, so codes, scales and
tables are bit-identical to it.  Tensor functions take and return
``torch`` tensors on the caller's device; f32 constants are rounded from
the Python doubles exactly as JAX's weak typing rounds them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .bspline import cardinal_bump

__all__ = [
    "ASPQuantSpec",
    "max_ld",
    "resolve_layer_bits",
    "lut_scale",
    "f32",
    "quantize_input",
    "dequantize_input",
    "build_lut",
    "hemi_fold",
    "hemi_unfold",
    "lookup_active",
    "dense_basis_from_codes",
    "quantized_dense_basis",
    "pact_quantize",
    "pact_basis_tables",
    "pact_dense_basis",
]


def f32(v: float) -> float:
    """The f32 value JAX's weak typing gives a Python double, as a double.

    Every f32 product or sum of such operands is the same whether torch
    evaluates it in f32 or in f64 and rounds (double rounding is innocuous
    for + and * at 53 >= 2*24+2 bits), so the port's arithmetic lands on
    the reference's bits.
    """
    return float(np.float32(v))


def max_ld(grid_size: int, n_bits: int) -> int:
    """Largest LD with ``G * 2**LD <= 2**n`` (paper eq. (6)).  -1 if none."""
    ld = -1
    while grid_size * 2 ** (ld + 1) <= 2**n_bits:
        ld += 1
    return ld


def resolve_layer_bits(n_bits, n_layers: int, grid_size: int) -> tuple:
    """Normalize a scalar-or-sequence bit width into a per-layer tuple.

    Each layer's width must satisfy PowerGap (eq. (6)) on its own; an
    invalid allocation raises ``ValueError`` and is never clamped.
    """
    if isinstance(n_bits, (int, np.integer)):
        bits = (int(n_bits),) * n_layers
    else:
        bits = tuple(int(b) for b in n_bits)
        if len(bits) != n_layers:
            raise ValueError(
                f"{len(bits)} per-layer bit widths for {n_layers} layers"
            )
    for li, b in enumerate(bits):
        if not 2 <= b <= 16:
            raise ValueError(f"layer {li}: n_bits={b} outside [2, 16]")
        if max_ld(grid_size, b) < 0:
            raise ValueError(
                f"layer {li}: n_bits={b} is PowerGap-invalid for "
                f"G={grid_size} (G * 2**LD <= 2**n unsatisfiable, eq. (6))"
            )
    return bits


def lut_scale(spec: "ASPQuantSpec") -> float:
    """Dequantization scale of the SH-LUT codes: bump peak / code ceiling."""
    K = spec.order
    qmax = 2**spec.lut_bits - 1
    vmax = cardinal_bump(np.array([(K + 1) / 2.0]), K)[0]
    return float(vmax / qmax)


@dataclasses.dataclass(frozen=True)
class ASPQuantSpec:
    """Static description of one ASP-quantized KAN layer input.

    grid_size G, order K, input width n_bits, SH-LUT width lut_bits, the
    float domain [lo, hi] mapped onto the knot grid, and ``signed`` (an
    affine-map choice only; the bit split applies to the unsigned code).
    """

    grid_size: int
    order: int = 3
    n_bits: int = 8
    lut_bits: int = 8
    lo: float = -1.0
    hi: float = 1.0
    signed: bool = False

    def __post_init__(self):
        if self.grid_size < 1:
            raise ValueError("grid_size must be >= 1")
        if max_ld(self.grid_size, self.n_bits) < 0:
            raise ValueError(
                f"G={self.grid_size} does not fit in {self.n_bits} bits: "
                "G * 2**LD <= 2**n unsatisfiable (eq. (6))"
            )

    @property
    def ld(self) -> int:
        """LD: local bit width (log2 of codes per knot interval)."""
        return max_ld(self.grid_size, self.n_bits)

    @property
    def codes_per_interval(self) -> int:
        return 2**self.ld

    @property
    def num_codes(self) -> int:
        """Data range is [0, G * 2**LD - 1] (paper §3.1.B)."""
        return self.grid_size * self.codes_per_interval

    @property
    def num_basis(self) -> int:
        return self.grid_size + self.order

    @property
    def global_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.grid_size)))

    @property
    def knot_step(self) -> float:
        return (self.hi - self.lo) / self.grid_size

    @property
    def code_step(self) -> float:
        return self.knot_step / self.codes_per_interval


# ----------------------------------------------------------------------------
# Input quantization (the ASP affine map)
# ----------------------------------------------------------------------------


def quantize_input(x: torch.Tensor, spec: ASPQuantSpec) -> torch.Tensor:
    """Float x in [lo, hi] -> int32 code in [0, G*2**LD - 1], left-aligned
    on the knot grid (code q sits at x = lo + q * code_step)."""
    scale = f32(1.0 / spec.code_step)
    q = torch.floor((x - f32(spec.lo)) * scale + 0.5).to(torch.int32)
    return torch.clamp(q, 0, spec.num_codes - 1)


def dequantize_input(codes: torch.Tensor, spec: ASPQuantSpec) -> torch.Tensor:
    """Inverse affine map of :func:`quantize_input` (code grid -> f32)."""
    return f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)


# ----------------------------------------------------------------------------
# SH-LUT construction (host side, numpy float64)
# ----------------------------------------------------------------------------


def build_lut(spec: ASPQuantSpec) -> dict:
    """The shared LUT of active-basis values.

    Returns "lut" (2**LD, K+1) float64 with lut[u, d] = b_K(u/2**LD + K - d),
    "lut_q" its ``lut_bits`` unsigned codes, "scale", the physical "hemi"
    storage (half the flattened table + 1) and "flat_q" the table rebuilt
    from hemi.
    """
    K, U = spec.order, spec.codes_per_interval
    u = np.arange(U, dtype=np.float64) / U
    lut = np.stack([cardinal_bump(u + (K - d), K) for d in range(K + 1)], axis=1)
    scale = lut_scale(spec)
    lut_q = np.round(lut / scale).astype(np.int64)
    hemi = hemi_fold(lut_q, spec)
    flat_q = hemi_unfold(hemi, spec)
    return {"lut": lut, "lut_q": lut_q, "scale": scale, "hemi": hemi,
            "flat_q": flat_q}


def hemi_fold(lut_q: np.ndarray, spec: ASPQuantSpec) -> np.ndarray:
    """Fold the (2**LD, K+1) table into hemi storage by the bump's symmetry.

    Flat bump position f = s*2**LD + u with s = K - d; b(t) = b(K+1-t) means
    the value at f equals the value at total - f, so storage keeps
    f in [0, total//2].
    """
    K, U = spec.order, spec.codes_per_interval
    total = (K + 1) * U
    flat = np.zeros(total, dtype=lut_q.dtype)
    for d in range(K + 1):
        s = K - d
        flat[s * U:(s + 1) * U] = lut_q[:, d]
    return flat[: total // 2 + 1].copy()


def hemi_unfold(hemi: np.ndarray, spec: ASPQuantSpec) -> np.ndarray:
    """Reconstruct the full flat table from hemi storage (retrieval logic)."""
    total = (spec.order + 1) * spec.codes_per_interval
    f = np.arange(total)
    half = total // 2
    return hemi[np.where(f <= half, f, total - f)]


# ----------------------------------------------------------------------------
# Quantized basis evaluation (the reference retrieval path)
# ----------------------------------------------------------------------------


def lookup_active(codes: torch.Tensor, lut: torch.Tensor, spec: ASPQuantSpec):
    """code -> (interval g as int64, (..., K+1) active LUT values).

    ``g`` is a LOGICAL shift of the 32-bit code, as in the reference: a
    negative code maps past every band and contributes nothing.
    """
    g = (codes.to(torch.int64) & 0xFFFFFFFF) >> spec.ld
    local = (codes & (spec.codes_per_interval - 1)).to(torch.int64)
    return g, lut[local]


def dense_basis_from_codes(codes: torch.Tensor, lut: torch.Tensor,
                           spec: ASPQuantSpec) -> torch.Tensor:
    """Dense (..., G+K) basis: the K+1 active LUT values placed at g..g+K."""
    g, vals = lookup_active(codes, lut, spec)
    iota = torch.arange(spec.num_basis, device=codes.device)
    d = iota - g[..., None]
    active = (d >= 0) & (d <= spec.order)
    dd = torch.clamp(d, 0, spec.order) * active
    picked = torch.gather(vals, -1, dd)
    return torch.where(active, picked, torch.zeros((), dtype=lut.dtype,
                                                   device=lut.device))


def quantized_dense_basis(x: torch.Tensor, spec: ASPQuantSpec,
                          lut_entry: dict | None = None) -> torch.Tensor:
    """float x -> quantize -> dense dequantized basis (..., G+K) f32."""
    if lut_entry is None:
        lut_entry = build_lut(spec)
    lut = torch.from_numpy(np.asarray(lut_entry["lut_q"] * lut_entry["scale"],
                                      dtype=np.float32)).to(x.device)
    return dense_basis_from_codes(quantize_input(x, spec), lut, spec)


# ----------------------------------------------------------------------------
# Conventional (PACT-style) baseline: misaligned grids
# ----------------------------------------------------------------------------


def pact_quantize(x: torch.Tensor, alpha: float, n_bits: int) -> torch.Tensor:
    """PACT quantization (Choi et al. 2018): clip to [0, alpha], uniform
    n-bit, as int32.

    The quantization step alpha/(2**n - 1) is in general NOT an integer
    multiple of the knot step, so the two grids are misaligned and each
    B_i(x) needs its own code->value table.  The division is element by
    element against a full-shape divisor (CUDA multiplies by the reciprocal
    of a broadcast scalar), and ``torch.round`` rounds half to even as
    ``jnp.round`` does, so the card gives the reference's codes bit for bit.
    """
    a = f32(alpha)
    c = torch.clamp(x, 0.0, a)
    q = torch.round(torch.div(c, torch.full_like(c, a)) * (2**n_bits - 1))
    return q.to(torch.int32)


def pact_basis_tables(spec: ASPQuantSpec,
                      alpha: float | None = None) -> np.ndarray:
    """Per-basis LUTs of the conventional path: a (G+K, 2**n) float64 table.

    table[i, q] = B_i(x(q)) with x(q) = q * alpha / (2**n - 1) + lo, rounded
    to the ``lut_bits`` grid.  Distinct per i because of the grid
    misalignment (paper Fig. 2): G+K programmable LUTs on silicon.
    """
    if alpha is None:
        alpha = spec.hi - spec.lo
    n = spec.n_bits
    q = np.arange(2**n, dtype=np.float64)
    x = spec.lo + q * alpha / (2**n - 1)
    tau = (x - spec.lo) / spec.knot_step  # [0, G]
    tables = np.stack(
        [cardinal_bump(tau - i + spec.order, spec.order)
         for i in range(spec.num_basis)], axis=0)
    step = lut_scale(spec)
    return np.round(tables / step) * step


def pact_dense_basis(x: torch.Tensor, spec: ASPQuantSpec,
                     tables: np.ndarray) -> torch.Tensor:
    """Baseline dense basis (..., G+K) f32: one gather per basis function
    from its own table."""
    codes = pact_quantize(x - f32(spec.lo), spec.hi - spec.lo, spec.n_bits)
    t = torch.from_numpy(np.asarray(tables, dtype=np.float32)).to(x.device)
    return t.T[codes.to(torch.int64)]
