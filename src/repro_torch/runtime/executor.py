"""Executor registry: the single dispatch point for quantized KAN inference.

Port of ``repro.runtime.executor``.  Every backend runs the same deployed
bundle (duck-typed: ``.dims``, ``.specs``, ``.layers``, ``.residual_raw``):

  * ``"ref"``:   the layered composition (per-layer SH-LUT dense basis,
                 banded matmul, tanh-rescale + re-quantize boundary), the
                 oracle for the fused backend;
  * ``"fused"``: kernel B1 for every layer, int32 codes across layer
                 boundaries.  ``"pallas"`` is an alias of it, so existing
                 environment and CLI strings still resolve.

Selection precedence: explicit argument > :func:`use_backend` scope >
``REPRO_KAN_BACKEND`` > the call site's default.  Both backends share the
:mod:`plancache` (pow2 batch bucketing + LRU of built entries).  The acim
backend and the mesh path wait for later slices.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.asp_quant import dense_basis_from_codes, f32, quantize_input
from ..kernels.kan_spline.pipeline import kan_pipeline_impl, unpacked_wc
from .plancache import PLAN_CACHE, PlanKey, bucket_batch

__all__ = [
    "ENV_BACKEND_VAR",
    "dispatch_counts",
    "reset_dispatch_counts",
    "register_executor",
    "available_backends",
    "resolve_backend",
    "get_executor",
    "use_backend",
    "ref_composition",
    "RefExecutor",
    "FusedExecutor",
]

ENV_BACKEND_VAR = "REPRO_KAN_BACKEND"

# Per-backend dispatch counts: one increment per KAN execution.
DISPATCH_COUNTS: collections.Counter = collections.Counter()


def dispatch_counts() -> dict:
    """Per-backend dispatch counts since start or the last reset."""
    return dict(DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


# ----------------------------------------------------------------------------
# Registry + resolution
# ----------------------------------------------------------------------------

_EXECUTORS: dict = {}
# names kept so existing env and CLI strings still resolve
_ALIASES = {"pallas": "fused"}
# innermost use_backend() override; a ContextVar so concurrent callers on
# different threads or tasks cannot clobber each other's scope
_SCOPE_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kan_backend_scope", default=None
)


def register_executor(name: str, executor) -> None:
    _EXECUTORS[name] = executor


def available_backends() -> tuple:
    """Registered backend names and their aliases."""
    return tuple(sorted(set(_EXECUTORS) | set(_ALIASES)))


def _canonical(backend: str) -> str:
    name = _ALIASES.get(backend, backend)
    if name not in _EXECUTORS:
        raise ValueError(
            f"unknown backend {backend!r}; registered: {available_backends()}"
        )
    return name


def resolve_backend(backend: str | None = None, *,
                    default: str = "fused") -> str:
    """Resolve to a registered backend name (aliases map to their target);
    raises ValueError for unknown names."""
    if backend is None or backend == "auto":
        backend = _SCOPE_BACKEND.get()
    if backend is None:
        backend = os.environ.get(ENV_BACKEND_VAR, "").strip() or None
    if backend is None:
        backend = default
    return _canonical(backend)


def get_executor(backend: str | None = None, *, default: str = "fused"):
    return _EXECUTORS[resolve_backend(backend, default=default)]


@contextlib.contextmanager
def use_backend(backend: str | None):
    """Scoped backend override (beats the env var, loses to explicit args).
    ``None`` is a passthrough so callers can plumb an optional choice."""
    if backend is not None:
        _canonical(backend)
    token = _SCOPE_BACKEND.set(
        backend if backend is not None else _SCOPE_BACKEND.get()
    )
    try:
        yield
    finally:
        _SCOPE_BACKEND.reset(token)


# ----------------------------------------------------------------------------
# Shared helpers
# ----------------------------------------------------------------------------


def _as_input(x, device: torch.device) -> torch.Tensor:
    """A request as f32 (the reference computes in f32 whatever it is
    given) on the bundle's device.  Host data (numpy, lists) is copied
    there; a tensor already on another device is refused."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"input on {x.device}, bundle on {device}")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _entry_codes(dep, x, xraw):
    """Entry coding, identical across backends: KAN stacks quantize x;
    FFN stacks (residual_raw) quantize tanh(x) and keep the raw f32 input
    for the ReLU branch."""
    spec0 = dep.specs[0]
    if dep.residual_raw:
        xraw = x.to(torch.float32) if xraw is None else xraw
        return quantize_input(torch.tanh(xraw), spec0), xraw
    return quantize_input(x, spec0), None


def _logical_layer(lw: dict, lp) -> tuple:
    """Slice one padded deployed layer back to its logical (lut, wc, wb);
    packed layers decode with the kernel's own nibble arithmetic."""
    nb = lp.spec.num_basis
    wc = unpacked_wc(lw, lp).reshape(lp.fp, nb, lp.op)[: lp.f, :, : lp.o]
    return lw["lut"], wc, lw["wb"][: lp.f, : lp.o]


def _pad_batch(a, bucket):
    if a is None:
        return None
    return F.pad(a, (0, 0, 0, bucket - a.shape[0]))


def _slice_result(out, b, return_intermediates):
    if return_intermediates:
        y, codes = out
        return y[:b], tuple(c[:b] for c in codes)
    return out[:b]


class _CachedExecutor:
    """Common plan-cache plumbing: bucket, pad, look up, run, slice.

    Subclasses supply ``_build(key) -> (plan, apply)`` with
    ``apply(codes, xraw, layers, return_intermediates)``.
    """

    name = "?"

    def __call__(self, dep, x, *, xraw=None, return_intermediates=False):
        device = dep.device
        x = _as_input(x, device)
        if xraw is not None:
            xraw = _as_input(xraw, device)
        codes, xraw = _entry_codes(dep, x, xraw)
        b = codes.shape[0]
        bucket = bucket_batch(b)
        key = PlanKey(
            dims=tuple(dep.dims),
            specs=tuple(dep.specs),
            bucket=bucket,
            residual_raw=dep.residual_raw,
            device=str(codes.device),
            backend=self.name,
        )
        _, apply = PLAN_CACHE.get(key, self._build)
        DISPATCH_COUNTS[self.name] += 1
        with torch.profiler.record_function(f"kan_spline.{self.name}"):
            out = apply(_pad_batch(codes, bucket), _pad_batch(xraw, bucket),
                        dep.layers, return_intermediates)
        return _slice_result(out, b, return_intermediates)

    def _build(self, key: PlanKey):
        raise NotImplementedError


# ----------------------------------------------------------------------------
# "ref": the layered composition
# ----------------------------------------------------------------------------


def ref_composition(logical_layers, specs, codes, xraw, *,
                    residual_raw: bool, return_intermediates: bool = False):
    """Layered quantized composition over logical (lut, wc, wb) triples,
    in the reference's op order and constants."""
    n = len(logical_layers)
    boundary = []
    y = None
    for li, (lut, wc, wb) in enumerate(logical_layers):
        spec = specs[li]
        basis = dense_basis_from_codes(codes, lut, spec)
        f, nb, o = wc.shape
        y = basis.reshape(codes.shape[0], f * nb) @ wc.reshape(f * nb, o)
        if residual_raw:
            resid = torch.relu(xraw)
        else:
            resid = torch.relu(
                f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)
            )
        y = y + resid @ wb
        if li < n - 1:
            nxt = specs[li + 1]
            if residual_raw:
                xraw = y
                codes = quantize_input(torch.tanh(y), nxt)
            else:
                h = torch.tanh(y) * f32(0.5 * (nxt.hi - nxt.lo)) \
                    + f32(0.5 * (nxt.hi + nxt.lo))
                codes = quantize_input(h, nxt)
            boundary.append(codes)
    if return_intermediates:
        return y, tuple(boundary)
    return y


class RefExecutor(_CachedExecutor):
    name = "ref"

    def _build(self, key: PlanKey):
        plan = PLAN_CACHE.plan(key.bucket, key.dims, key.specs,
                               residual_raw=key.residual_raw)

        def apply(codes, xraw, layers, return_intermediates):
            logical = [_logical_layer(lw, lp)
                       for lw, lp in zip(layers, plan.layers)]
            return ref_composition(
                logical, key.specs, codes, xraw,
                residual_raw=key.residual_raw,
                return_intermediates=return_intermediates,
            )

        return plan, apply


# ----------------------------------------------------------------------------
# "fused": kernel B1 per layer
# ----------------------------------------------------------------------------


class FusedExecutor(_CachedExecutor):
    name = "fused"

    def _build(self, key: PlanKey):
        plan = PLAN_CACHE.plan(key.bucket, key.dims, key.specs,
                               residual_raw=key.residual_raw)

        def apply(codes, xraw, layers, return_intermediates):
            return kan_pipeline_impl(
                codes, xraw, layers, plan,
                return_intermediates=return_intermediates,
            )

        return plan, apply


register_executor("ref", RefExecutor())
register_executor("fused", FusedExecutor())
