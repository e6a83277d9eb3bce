"""Executor registry: the single dispatch point for quantized KAN inference.

Port of ``repro.runtime.executor``.  Every backend runs the same deployed
bundle (duck-typed: ``.dims``, ``.specs``, ``.layers``, ``.residual_raw``):

  * ``"ref"``:   the layered composition (per-layer SH-LUT dense basis,
                 banded matmul, tanh-rescale + re-quantize boundary), the
                 oracle for the fused backend;
  * ``"fused"``: kernel B1 for every layer, int32 codes across layer
                 boundaries.  ``"pallas"`` is an alias of it, so existing
                 environment and CLI strings still resolve;
  * ``"acim"``:  the fused pipeline with the paper's RRAM-ACIM
                 non-idealities injected at the banded-MAC contraction:
                 TM-DV noise on the entry codes, IR-drop gains on the
                 conductance rows (optionally at KAN-SAM placements), and
                 a per-channel partial-sum sigma through B1's noise
                 operand, all drawn from one ``torch.Generator``.

Selection precedence: explicit argument > :func:`use_backend` scope >
``REPRO_KAN_BACKEND`` > the call site's default.  Every backend shares the
:mod:`plancache` (pow2 batch bucketing + LRU of built entries).  The mesh
path waits for a later slice.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.asp_quant import dense_basis_from_codes, f32, quantize_input
from ..core.cim import CIMConfig
from ..core.tmdv import TMDVConfig, apply_input_noise
from ..kernels.kan_spline.pipeline import (
    kan_pipeline_impl,
    unpacked_wc,
    weight_bits,
)
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
    "quiet_cim_config",
    "RefExecutor",
    "FusedExecutor",
    "ACIMExecutor",
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

    Subclasses supply ``_build(key) -> (plan, apply)``, and may override
    ``_flags(cim=, sam_perms=)`` (backend statics that belong in the cache
    key) and ``_run`` (how the apply is invoked; the default calls
    ``apply(codes, xraw, layers, return_intermediates)``).  ``generator``
    reaches ``_run``; only stochastic backends read it.
    """

    name = "?"

    def _flags(self, cim=None, sam_perms=None) -> tuple:
        return ()  # deterministic backends ignore the acim options

    def __call__(self, dep, x, *, xraw=None, generator=None,
                 return_intermediates=False, **opts):
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
            flags=self._flags(**opts),
        )
        _, apply = PLAN_CACHE.get(key, self._build)
        DISPATCH_COUNTS[self.name] += 1
        with torch.profiler.record_function(f"kan_spline.{self.name}"):
            out = self._run(key, apply, _pad_batch(codes, bucket),
                            _pad_batch(xraw, bucket), dep.layers, generator,
                            return_intermediates)
        return _slice_result(out, b, return_intermediates)

    def _run(self, key, apply, codes, xraw, layers, generator,
             return_intermediates):
        return apply(codes, xraw, layers, return_intermediates)

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


# ----------------------------------------------------------------------------
# "acim": the fused pipeline + RRAM-ACIM non-idealities
# ----------------------------------------------------------------------------


def quiet_cim_config() -> CIMConfig:
    """A CIMConfig with every non-ideality zeroed (bit-exact vs "fused")."""
    return CIMConfig(
        ir_gamma=0.0,
        sigma_ps_ref=0.0,
        input_gen=TMDVConfig(sigma_v_ref=0.0, sigma_t=0.0),
    )


def _irdrop_row_gain(lp, cfg: CIMConfig, perm=None) -> np.ndarray | None:
    """Static per-row conductance gain (Fp*NB, 1), or None when IR-drop is off.

    Mirrors ``core.cim.cim_matmul``'s systematic term at typical column load
    (col_load == 1): physical row p of each array attenuates by
    ``ir_scale * (p+1)/rows``; deployment calibration divides out the
    mean-distance attenuation, leaving the placement-dependent residual.
    By default logical rows map to physical positions in natural banded
    order (feature-major, as the weights are flattened); ``perm`` — a
    KAN-SAM placement with ``perm[p] = logical row at physical position p``
    (see ``core.sam.sam_permutation``) — relocates each logical row's
    IR-drop exposure to its SAM slot instead.  Zero-padded rows past the
    logical row count keep gain 1 (they hold no conductance).
    """
    ir = cfg.ir_scale()
    if ir == 0.0:
        return None
    rows = cfg.array_rows
    nb = lp.spec.num_basis
    n_logical = lp.f * nb
    r = np.arange(lp.fp * nb)
    if perm is None:
        pos = r
    else:
        perm = np.asarray(perm)
        if perm.shape != (n_logical,):
            raise ValueError(
                f"sam perm has {perm.shape} entries; layer has {n_logical} "
                "logical rows"
            )
        inv = np.empty(n_logical, np.int64)
        inv[perm] = np.arange(n_logical)
        pos = np.where(r < n_logical, inv[np.minimum(r, n_logical - 1)], r)
    dist = ((pos % rows) + 1.0) / rows
    factor = 1.0 - ir * dist
    comp = 1.0 - ir * (rows + 1.0) / (2.0 * rows)
    gain = np.where(r < n_logical, factor / comp, 1.0)
    return gain.astype(np.float32)[:, None]


def _n_arrays(lp, cfg: CIMConfig) -> int:
    """Physical macro count one output column's MAC spans."""
    return max(1, -(-(lp.f * lp.spec.num_basis) // cfg.array_rows))


@dataclasses.dataclass
class ACIMExecutor(_CachedExecutor):
    """Fused pipeline with measured non-idealities at the MAC contraction.

    The injection points (each gated, so a zeroed config runs exactly the
    "fused" launches):

      * entry codes -> :func:`apply_input_noise` (TM-DV voltage/time sigma),
        re-rounded to the nearest valid ASP code;
      * conductance rows -> systematic IR-drop gain (mean-compensated); an
        optional per-layer KAN-SAM placement (``sam_perms=``) relocates
        each row's exposure to its mapped physical slot.  A gained layer
        runs on its unpacked f32 weights times the gains, formed per call
        (a transient of the layer's f32 weight size);
      * each (batch, out) element -> additive Gaussian partial-sum error
        with per-channel std ``sigma_ps * sqrt(n_arrays) * x_max *
        lut_lsb * w_lsb[o]``, through B1's noise operand, so the boundary
        requantizer carries it into the next layer's codes.

    Every stochastic term is drawn from one ``torch.Generator`` on the
    bundle's device: the entry-code noise first, then one (Bp, Op) normal
    per layer.  The same generator state reproduces the run.  With no
    generator (the serving path), one is seeded from the entry codes' sum
    mod 2**32, so identical inputs reproduce and distinct ones decorrelate;
    reading that sum costs one host sync per call.
    """

    cim: CIMConfig = dataclasses.field(
        default_factory=lambda: CIMConfig(ir_gamma=0.06, sigma_ps_ref=0.05)
    )
    name: str = dataclasses.field(default="acim", init=False)

    def _flags(self, cim: CIMConfig | None = None, sam_perms=None) -> tuple:
        flags = ("cim", self.cim if cim is None else cim)
        if sam_perms is not None:
            # per-layer KAN-SAM placements (or None to keep natural order);
            # tuples so the cache key stays hashable
            flags += ("sam", tuple(
                None if p is None else tuple(int(i) for i in np.asarray(p))
                for p in sam_perms
            ))
        return flags

    @staticmethod
    def _statics(key: PlanKey) -> tuple:
        """(cfg, sam_perms, has_input_noise, has_psum) from the key."""
        cfg = key.flags[1]
        sam_perms = None
        if len(key.flags) >= 4 and key.flags[2] == "sam":
            sam_perms = key.flags[3]
        tm = cfg.input_gen
        has_input_noise = (not cfg.deterministic) and (
            tm.sigma_v > 0.0 or tm.sigma_t > 0.0
        )
        has_psum = (not cfg.deterministic) and cfg.sigma_ps_ref > 0.0
        return cfg, sam_perms, has_input_noise, has_psum

    def _run(self, key, apply, codes, xraw, layers, generator,
             return_intermediates):
        _, _, has_input_noise, has_psum = self._statics(key)
        if generator is None and (has_input_noise or has_psum):
            digest = int(codes.sum(dtype=torch.int64).item()) % 2**32
            generator = torch.Generator(device=codes.device)
            generator.manual_seed(digest)
        return apply(codes, xraw, layers, generator, return_intermediates)

    @staticmethod
    def _layer_psum_std(cfg, lp, lw) -> torch.Tensor:
        """Per-channel (Op,) partial-sum sigma of one layer, at ITS widths.

        ``x_max`` is the layer's LUT code ceiling (2**lut_bits - 1); the
        per-channel weight LSB divides by the signed weight-code ceiling
        (2**(w_bits-1) - 1).  Padded channels have zero weights and so
        zero sigma.
        """
        x_max = float(2 ** lp.spec.lut_bits - 1)
        w_qmax = float(2 ** (weight_bits(lp.spec) - 1) - 1)
        # max |w| per channel, without an |w| temporary of the weights' size
        w_lsb = torch.linalg.vector_norm(unpacked_wc(lw, lp), ord=float("inf"),
                                         dim=0) / f32(w_qmax)
        lut_lsb = lw["lut"].max() / f32(x_max)
        scale = cfg.sigma_ps() * float(np.sqrt(_n_arrays(lp, cfg))) * x_max
        return (f32(scale) * lut_lsb) * w_lsb

    def _row_gains(self, key: PlanKey, plan) -> tuple:
        """Per-layer (Fp*NB, 1) f32 gains on the key's device, or None."""
        cfg, sam_perms, *_ = self._statics(key)
        gains = []
        for li, lp in enumerate(plan.layers):
            g = _irdrop_row_gain(
                lp, cfg, perm=sam_perms[li] if sam_perms is not None else None)
            gains.append(None if g is None
                         else torch.from_numpy(g).to(key.device))
        return tuple(gains)

    def _build(self, key: PlanKey):
        cfg, _, has_input_noise, has_psum = self._statics(key)
        plan = PLAN_CACHE.plan(key.bucket, key.dims, key.specs,
                               residual_raw=key.residual_raw)
        spec0 = key.specs[0]
        tm = cfg.input_gen
        # built once per entry, on the device (the reference closes over
        # them as jit constants)
        row_gains = self._row_gains(key, plan)

        def apply(codes, xraw, layers, generator, return_intermediates):
            if has_input_noise:
                eff = apply_input_noise(codes, tm, generator)
                codes = torch.clamp(
                    torch.floor(eff + 0.5).to(torch.int32),
                    0, spec0.num_codes - 1,
                )
            noises = None
            if has_psum:
                noises = tuple(
                    self._layer_psum_std(cfg, lp, lw)[None, :] * torch.randn(
                        (plan.bp, lp.op), generator=generator,
                        device=codes.device)
                    for lp, lw in zip(plan.layers, layers))
            # the gained layers are formed one at a time inside the
            # pipeline; a quiet config has no gains and runs the same
            # (packed) launches as "fused"
            return kan_pipeline_impl(
                codes, xraw, layers, plan, psum_noises=noises,
                row_gains=row_gains,
                return_intermediates=return_intermediates,
            )

        return plan, apply


register_executor("ref", RefExecutor())
register_executor("fused", FusedExecutor())
register_executor("acim", ACIMExecutor())
