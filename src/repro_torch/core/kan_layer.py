"""KAN layers: the float reference path and the ASP-quantized LUT path.

Port of ``repro.core.kan_layer``.  A layer maps in_dim -> out_dim as

    y_o = sum_f [ w_b[f,o] * relu(x_f) + sum_i c'[f,i,o] * B_i(x_f) ]

with ReLU as the base function (paper eq. (1)-(3)) and the spline term as
one flattened banded matmul ``basis (B, F*(G+K)) @ c (F*(G+K), O)``.
Parameters are plain dicts of tensors; ``init_*`` draw from an explicit
``torch.Generator``.  Post-training quantization runs on the host in numpy
float64 exactly as the reference does, then moves the results to the
parameters' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .asp_quant import (
    ASPQuantSpec,
    build_lut,
    dense_basis_from_codes,
    f32,
    quantize_input,
    resolve_layer_bits,
)
from .bspline import bspline_basis

__all__ = [
    "KANSpec",
    "init_kan_layer",
    "kan_layer_apply",
    "quantize_kan_layer",
    "kan_layer_apply_quantized",
    "init_kan_network",
    "kan_network_apply",
    "param_count",
    "refit_layer_spec",
    "extend_layer_grid",
]


@dataclasses.dataclass(frozen=True)
class KANSpec:
    """Architecture of a KAN stack: dims + per-layer quantization specs.

    ``n_bits`` is one int (uniform) or a per-layer tuple (mixed precision),
    each PowerGap-validated at construction; a layer's ``lut_bits`` is
    clipped to its input width.
    """

    dims: tuple
    grid_size: int = 5
    order: int = 3
    n_bits: int | tuple = 8
    lut_bits: int = 8
    lo: float = -1.0
    hi: float = 1.0

    def __post_init__(self):
        if not isinstance(self.n_bits, int):
            object.__setattr__(
                self, "n_bits", tuple(int(b) for b in self.n_bits)
            )
        self.layer_bits  # validate eagerly

    @property
    def layer_bits(self) -> tuple:
        """Per-layer input bit widths, PowerGap-validated (never clamped)."""
        return resolve_layer_bits(self.n_bits, len(self.dims) - 1,
                                  self.grid_size)

    def layer_spec(self, li: int = 0) -> ASPQuantSpec:
        b = self.layer_bits[li]
        return ASPQuantSpec(
            grid_size=self.grid_size, order=self.order, n_bits=b,
            lut_bits=min(self.lut_bits, b), lo=self.lo, hi=self.hi,
        )

    def layer_specs(self) -> tuple:
        return tuple(self.layer_spec(li) for li in range(len(self.dims) - 1))

    @property
    def num_basis(self) -> int:
        return self.grid_size + self.order


def init_kan_layer(generator: torch.Generator, in_dim: int, out_dim: int,
                   spec: ASPQuantSpec, *, device=None,
                   dtype=torch.float32) -> dict:
    """c: (in, G+K, out) small-noise init (pykan-style); w_b: (in, out)."""
    dev = resolve_device(device)
    nb = spec.num_basis
    c = torch.randn((in_dim, nb, out_dim), generator=generator, device=dev,
                    dtype=dtype) * (0.1 / np.sqrt(in_dim))
    w_b = torch.randn((in_dim, out_dim), generator=generator, device=dev,
                      dtype=dtype) * (1.0 / np.sqrt(in_dim))
    return {"c": c, "w_b": w_b}


def _spline_matmul(basis: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, F, G+K) x (F, G+K, O) -> (B, O) as a single flattened matmul."""
    f, nb, o = c.shape
    return basis.reshape(basis.shape[:-2] + (f * nb,)) @ c.reshape(f * nb, o)


def kan_layer_apply(params: dict, x: torch.Tensor,
                    spec: ASPQuantSpec) -> torch.Tensor:
    """Float reference path: Cox-de Boor basis, exact."""
    basis = bspline_basis(x, spec.lo, spec.hi, spec.grid_size, spec.order)
    y = _spline_matmul(basis, params["c"])
    return y + torch.relu(x) @ params["w_b"]


# ----------------------------------------------------------------------------
# Quantized inference path (ASP-KAN-HAQ)
# ----------------------------------------------------------------------------


def quantize_kan_layer(params: dict, spec: ASPQuantSpec,
                       weight_bits: int | None = None) -> dict:
    """Post-training quantization of one layer (host side, numpy float64).

    Symmetric per-output-channel weight codes with
    ``qmax = 2**(bits-1) - 1``; ``weight_bits=None`` means
    ``min(8, spec.n_bits)``.  Returns tensors on the parameters' device:
    c_q int8 (in, G+K, out), c_scale f32 (out,), w_b_q / w_b_scale, lut f32
    (2**LD, K+1), lut_q int32, lut_scale (0-dim f32) and hemi int32.
    """
    dev = params["c"].device
    entry = build_lut(spec)
    if weight_bits is None:
        weight_bits = min(8, spec.n_bits)
    qmax = 2 ** (int(weight_bits) - 1) - 1
    # through f64 on the host, so bf16 weights (no numpy dtype) work too
    c = params["c"].detach().to("cpu", torch.float64).numpy()
    w_b = params["w_b"].detach().to("cpu", torch.float64).numpy()

    def chan_q(w, axis_out):
        red = tuple(i for i in range(w.ndim) if i != axis_out)
        s = np.maximum(np.abs(w).max(axis=red), 1e-12) / qmax
        q = np.clip(np.round(w / s), -qmax, qmax).astype(np.int8)
        return q, s.astype(np.float32)

    c_q, c_scale = chan_q(c, c.ndim - 1)
    w_b_q, w_b_scale = chan_q(w_b, w_b.ndim - 1)
    if spec.lut_bits <= 4:
        # int4-packable tables dequantize as f32(code) * f32(scale): the
        # exact product the kernel's in-lane nibble decode computes
        lut_f32 = np.float32(entry["lut_q"]) * np.float32(entry["scale"])
    else:
        lut_f32 = np.asarray(entry["lut_q"] * entry["scale"], np.float32)

    def t(a, dtype=None):
        # np.asarray keeps a 0-dim scale 0-dim (ascontiguousarray would
        # make it (1,)), as the reference's stacked trees expect
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return {
        "c_q": t(c_q),
        "c_scale": t(c_scale),
        "w_b_q": t(w_b_q),
        "w_b_scale": t(w_b_scale),
        "lut": t(lut_f32),
        "lut_q": t(entry["lut_q"], torch.int32),
        "lut_scale": t(np.float32(entry["scale"])),
        "hemi": t(entry["hemi"], torch.int32),
    }


def kan_layer_apply_quantized(qparams: dict, x: torch.Tensor,
                              spec: ASPQuantSpec) -> torch.Tensor:
    """ASP inference: quantize -> shared-LUT dense basis -> banded matmul."""
    codes = quantize_input(x, spec)
    basis = dense_basis_from_codes(codes, qparams["lut"], spec)
    c = qparams["c_q"].to(torch.float32) * qparams["c_scale"]
    y = _spline_matmul(basis, c)
    xq = torch.relu(f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step))
    wb = qparams["w_b_q"].to(torch.float32) * qparams["w_b_scale"]
    return y + xq @ wb


# ----------------------------------------------------------------------------
# Stacks
# ----------------------------------------------------------------------------


def init_kan_network(generator: torch.Generator, kspec: KANSpec, *,
                     device=None) -> list:
    """One ``init_kan_layer`` per layer, all drawn from ``generator``."""
    spec = kspec.layer_spec()
    return [
        init_kan_layer(generator, din, dout, spec, device=device)
        for din, dout in zip(kspec.dims[:-1], kspec.dims[1:])
    ]


def kan_network_apply(params_list, x: torch.Tensor, kspec: KANSpec,
                      quantized: bool = False, qparams_list=None,
                      backend: str | None = None, device=None):
    """Apply a KAN stack.

    The float path runs where ``x`` and the params are.  The quantized path
    deploys ``qparams_list`` on ``device`` (the card unless
    ``device="cpu"``) and resolves its backend through
    :mod:`repro_torch.runtime` (explicit arg > ``use_backend`` >
    ``REPRO_KAN_BACKEND`` > "ref"): "ref" is the layered composition,
    "fused" (alias "pallas") runs every layer in the CUDA kernel with the
    inter-layer requantization fused.
    """
    if quantized:
        from .. import runtime
        from .kan_network_deploy import (
            deploy_kan_network,
            kan_network_deploy_apply,
        )

        name = runtime.resolve_backend(backend, default="ref")
        dep = deploy_kan_network(qparams_list, kspec, batch=x.shape[0],
                                 device=device)
        return kan_network_deploy_apply(dep, x, backend=name)
    if backend not in (None, "ref"):
        raise ValueError(
            f"backend={backend!r} is a quantized executor; "
            "pass quantized=True with qparams_list"
        )
    spec = kspec.layer_spec()
    h = x
    n = len(params_list)
    for li in range(n):
        h = kan_layer_apply(params_list[li], h, spec)
        if li < n - 1:
            h = torch.tanh(h) * (0.5 * (spec.hi - spec.lo)) \
                + 0.5 * (spec.hi + spec.lo)
    return h


def param_count(kspec: KANSpec) -> int:
    """Edge count x (G + K + 1), the paper's #Param convention
    ((17,1,14): 279 at G=5 = KAN1, 2232 at G=68 = KAN2)."""
    edges = sum(a * b for a, b in zip(kspec.dims[:-1], kspec.dims[1:]))
    return edges * (kspec.grid_size + kspec.order + 1)


# ----------------------------------------------------------------------------
# Grid transfer (original-KAN §2.5; the speculative drafter's refit)
# ----------------------------------------------------------------------------


def refit_matrix(old_spec: ASPQuantSpec, new_spec: ASPQuantSpec) -> np.ndarray:
    """(G'+K', G+K) float64 map taking a spline's old coefficients to the
    least-squares coefficients of the new basis.

    The reference samples both bases at ``4(G'+K')+16`` points of the knot
    domain and solves ``new_b @ c_new = old_b @ c`` by ``lstsq``.  Both
    matrices are tiny, so the port forms them in float64 on the host and
    takes the pseudo-inverse once: ``c_new = pinv(new_b) @ old_b @ c`` is
    the same minimum-norm solution, and the result is the same on the CPU
    and on the card."""
    new_g, new_k = new_spec.grid_size, new_spec.order
    xs = torch.linspace(old_spec.lo, old_spec.hi, 4 * (new_g + new_k) + 16,
                        dtype=torch.float64)
    old_b = bspline_basis(xs, old_spec.lo, old_spec.hi, old_spec.grid_size,
                          old_spec.order).numpy()
    new_b = bspline_basis(xs, new_spec.lo, new_spec.hi, new_g,
                          new_k).numpy()
    return np.linalg.pinv(new_b) @ old_b


def refit_layer_spec(params: dict, old_spec: ASPQuantSpec,
                     new_spec: ASPQuantSpec) -> dict:
    """Refit layer coefficients onto a different (G, K) basis by least
    squares; ``w_b`` is unchanged.

    ``c`` (F, G+K, O) becomes f32 (F, G'+K', O): one matmul by
    :func:`refit_matrix` on the coefficients' device (the reference's
    result is f32 too).  To a finer grid the refit is near-lossless, to a
    coarser one it is the best L2 approximation of the same spline."""
    c = params["c"]
    m = torch.as_tensor(refit_matrix(old_spec, new_spec), dtype=torch.float32,
                        device=c.device)
    c_new = torch.einsum("jn,fno->fjo", m, c.to(torch.float32))
    return {"c": c_new, "w_b": params["w_b"]}


def extend_layer_grid(params: dict, old_spec: ASPQuantSpec, new_g: int) -> dict:
    """Refit layer coefficients on a finer grid by least squares (same K)."""
    return refit_layer_spec(
        params, old_spec, dataclasses.replace(old_spec, grid_size=new_g))
