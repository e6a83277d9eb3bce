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
:mod:`plancache` (pow2 batch bucketing + LRU of built entries).  Each
dispatch is counted per backend (fed to the obs registry as
``runtime.backend_dispatch{backend=...}``), with its real and bucket-pad
rows (``runtime.rows{kind=real|pad}``) and the bytes of host data it
copied to the device (``runtime.h2d_bytes``).  Its host phases run under
``obs.profile_scope`` ranges: ``runtime.h2d`` (the copy of host rows),
``runtime.plan`` (bucket, key, plan-cache lookup or build),
``runtime.entry`` (entry coding) and ``kan_spline.<backend>`` (padding
to the bucket and the kernels).

Every backend also has a MESH dimension (:mod:`.meshexec`): when a mesh is
bound (explicit ``mesh=`` argument > :func:`use_mesh` scope > the bundle's
``DeployedKAN.placement``), the entry is built as a shard body: batch over
``"data"``, each layer's output columns over ``"model"`` per
``dist.sharding.deployed_kan_pspecs``, the boundary requantizer shard-local
and the int32 codes all-gathered between layers.  The plan-cache key
carries the mesh fingerprint, so sharded and unsharded entries never
collide.  A CUDA shard launches B1 (or raises), as an unsharded call does.
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
    _requant_consts,
    feature_split_plan,
    gained_layer,
    kan_pipeline_impl,
    run_pipeline_layer,
    shard_local_plan,
    unpacked_wc,
    weight_bits,
)
from ..obs import REGISTRY as _OBS_REGISTRY
from ..obs.trace import profile_scope
from .meshexec import (
    build_sharded_runner,
    mesh_axis_sizes,
    mesh_fingerprint,
    mesh_from_fingerprint,
    mesh_index,
    register_mesh,
    resolve_mesh,
    shard_generator,
    use_mesh,
)
from .plancache import PLAN_CACHE, PlanKey, bucket_batch

__all__ = [
    "ENV_BACKEND_VAR",
    "dispatch_counts",
    "reset_dispatch_counts",
    "io_counts",
    "reset_io_counts",
    "register_executor",
    "available_backends",
    "resolve_backend",
    "get_executor",
    "use_backend",
    "use_mesh",
    "resolve_mesh",
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


# What the dispatches moved: "rows_real" (the requests' rows), "rows_pad"
# (rows added to reach the bucket) and "h2d_bytes" (host data copied to
# the bundle's device).
IO_COUNTS: collections.Counter = collections.Counter()


def io_counts() -> dict:
    """Rows (real, pad) and host bytes copied since start or the last
    reset."""
    return {k: IO_COUNTS[k] for k in ("rows_real", "rows_pad", "h2d_bytes")}


def reset_io_counts() -> None:
    IO_COUNTS.clear()


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
    there, under the ``runtime.h2d`` range, and its f32 bytes counted; a
    tensor already on another device is refused."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"input on {x.device}, bundle on {device}")
        return x.to(torch.float32)
    with profile_scope("runtime.h2d"):
        a = np.asarray(x, np.float32)
        IO_COUNTS["h2d_bytes"] += a.nbytes
        return torch.as_tensor(a, device=device)


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


# Deriving a mesh fingerprint walks the mesh's ranks and the plan's layer
# geometry; on the serving path that would run per token per FFN block just
# to hit a cached entry, so it is memoized on (mesh, geometry, bucket).  The
# registration stays per call (dict writes), so reset_cache() and
# reset_shard_notes() are repopulated by the next execution.
_MESH_FP_MEMO: dict = {}


def _mesh_key_fingerprint(mesh, dsize, msize, dims, specs, bucket,
                          residual_raw) -> tuple:
    memo_key = (id(mesh), dims, specs, bucket, residual_raw)
    hit = _MESH_FP_MEMO.get(memo_key)
    if hit is None or hit[0] is not mesh:
        base = PLAN_CACHE.plan(bucket // dsize, dims, specs,
                               residual_raw=residual_raw)
        _, sharded, notes = shard_local_plan(base, msize)
        hit = (mesh, mesh_fingerprint(mesh, sharded), notes)
        if len(_MESH_FP_MEMO) > 256:
            _MESH_FP_MEMO.clear()
        _MESH_FP_MEMO[memo_key] = hit
    _, fp, notes = hit
    register_mesh(fp, mesh, notes)
    return fp


def _local_layers(layers, base_plan, local_plan, sharded, model_index):
    """This rank's slabs of a bundle's layers: a placed bundle's leaves are
    already its slabs (last dim = the local width); an unplaced bundle's
    sharded leaves (last dim = the global width) are sliced here."""
    out = []
    for lw, glp, llp, sh in zip(layers, base_plan.layers, local_plan.layers,
                                sharded):
        if not sh:
            out.append(lw)
            continue
        lo = model_index * llp.op
        local = {}
        for k, a in lw.items():
            if k.startswith("lut"):
                local[k] = a
            elif a.shape[-1] == llp.op:
                local[k] = a
            elif a.shape[-1] == glp.op:
                local[k] = a[..., lo:lo + llp.op].contiguous()
            else:
                raise ValueError(
                    f"layer leaf {k!r} has {a.shape[-1]} columns; the mesh "
                    f"wants {glp.op} (global) or {llp.op} (this shard's)")
        out.append(local)
    return tuple(out)


class _CachedExecutor:
    """Common plan-cache plumbing: bucket, pad, look up, run, slice.

    Subclasses supply ``_build_local(key) -> (plan, apply)``, and may
    override ``_flags(cim=, sam_perms=)`` (backend statics that belong in
    the cache key), ``_run`` (how the apply is invoked; the default calls
    ``apply(codes, xraw, layers, return_intermediates)``) and, for the mesh
    path, ``_mesh_layer_fn`` / ``_mesh_noise_fn`` (the per-shard layer step
    and the per-shard stochastic terms).  ``generator`` reaches ``_run``;
    only stochastic backends read it.
    """

    name = "?"
    range_name = "kan_spline.?"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # the kernels' profiler range, named once per backend
        cls.range_name = f"kan_spline.{cls.name}"

    def _flags(self, cim=None, sam_perms=None) -> tuple:
        return ()  # deterministic backends ignore the acim options

    def __call__(self, dep, x, *, xraw=None, generator=None, mesh=None,
                 return_intermediates=False, **opts):
        device = dep.device
        mesh = resolve_mesh(mesh, getattr(dep, "placement", None))
        x = _as_input(x, device)
        if xraw is not None:
            xraw = _as_input(xraw, device)
        b = x.shape[0]
        with profile_scope("runtime.plan"):
            if mesh is None:
                bucket = bucket_batch(b)
                mesh_fp = ()
            else:
                dsize, msize = mesh_axis_sizes(mesh)
                # every data shard's slab holds at least one 8-row tile,
                # and the bucket divides by any data size
                bucket = bucket_batch(b, lo=8 * dsize)
                mesh_fp = _mesh_key_fingerprint(
                    mesh, dsize, msize, tuple(dep.dims), tuple(dep.specs),
                    bucket, dep.residual_raw)
            key = PlanKey(
                dims=tuple(dep.dims),
                specs=tuple(dep.specs),
                bucket=bucket,
                residual_raw=dep.residual_raw,
                device=str(x.device),
                backend=self.name,
                flags=self._flags(**opts),
                mesh=mesh_fp,
            )
            _, apply = PLAN_CACHE.get(key, self._build)
        with profile_scope("runtime.entry"):
            codes, xraw = _entry_codes(dep, x, xraw)
        DISPATCH_COUNTS[self.name] += 1
        IO_COUNTS["rows_real"] += b
        IO_COUNTS["rows_pad"] += bucket - b
        with profile_scope(self.range_name):
            out = self._run(key, apply, _pad_batch(codes, bucket),
                            _pad_batch(xraw, bucket), dep.layers, generator,
                            return_intermediates)
        return _slice_result(out, b, return_intermediates)

    def _run(self, key, apply, codes, xraw, layers, generator,
             return_intermediates):
        return apply(codes, xraw, layers, return_intermediates)

    def _build(self, key: PlanKey):
        if key.mesh:
            return self._build_sharded(key)
        return self._build_local(key)

    def _build_local(self, key: PlanKey):
        raise NotImplementedError

    # -- the mesh path ---------------------------------------------------

    def _mesh_layer_fn(self, key: PlanKey, local_plan):
        """Per-shard layer step: kernel B1 on the local geometry at the
        global layer's feature split (shared by "fused" and "acim"; "ref"
        overrides it with the padded composition)."""
        def layer_fn(li, lp, lw, h_codes, h_raw, psum_noise, splits):
            return run_pipeline_layer(
                h_codes, h_raw if lp.residual_raw else None, lw, lp,
                local_plan.bp, psum_noise=psum_noise,
                row_tile=local_plan.row_tile, feature_splits=splits)
        return layer_fn

    def _mesh_noise_fn(self, key: PlanKey, local_plan):
        return None  # deterministic backends draw nothing per shard

    def _build_sharded(self, key: PlanKey):
        """One shard body per (geometry, bucket, mesh fingerprint).

        The per-shard plan is the plan of the local rows (``bucket /
        data``, tuned tiles included) with each sharded layer's padded
        output dim divided by the model size; each layer's feature split
        comes from the global widths."""
        mesh = mesh_from_fingerprint(key.mesh)
        dsize, msize = mesh_axis_sizes(mesh)
        base = PLAN_CACHE.plan(key.bucket // dsize, key.dims, key.specs,
                               residual_raw=key.residual_raw)
        local_plan, sharded, _ = shard_local_plan(base, msize)
        if sharded != key.mesh[4]:
            raise RuntimeError(f"shard flags {sharded} != key {key.mesh}")
        runner = build_sharded_runner(
            mesh, local_plan=local_plan, layer_sharded=sharded,
            feature_splits=tuple(feature_split_plan(lp.f, lp.o)[0]
                                 for lp in base.layers),
            residual_raw=key.residual_raw,
            layer_fn=self._mesh_layer_fn(key, local_plan),
            noise_fn=self._mesh_noise_fn(key, local_plan))
        lp0 = base.layers[0]
        logical_o = tuple(lp.o for lp in base.layers)
        model_index = mesh_index(mesh, "model")

        def apply(codes, xraw, layers, return_intermediates, noise_arg=None):
            codes = F.pad(codes, (0, lp0.fp - lp0.f))
            if key.residual_raw:
                xraw = F.pad(xraw.to(torch.float32), (0, lp0.fp - lp0.f))
            local = _local_layers(layers, base, local_plan, sharded,
                                  model_index)
            y, boundary = runner(codes, xraw, local, noise_arg,
                                 return_intermediates)
            y = y[:, : logical_o[-1]]
            if return_intermediates:
                return y, tuple(c[:, : logical_o[li]]
                                for li, c in enumerate(boundary))
            return y

        return base, apply


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


def _ref_padded_layer(lp, lw, codes, xraw, psum_noise=None):
    """One layer of the ref composition on PADDED per-shard geometry: the
    mesh path's plain analogue of B1, in the kernel's op order (dense
    SH-LUT basis -> banded MAC -> ReLU branch -> noise -> boundary re-code)
    on the padded weights a shard holds.  The re-code multiplies by the f32
    ``1 / code_step`` as every other path does; the reference's version
    divides by ``code_step``, which moves a code by one at near-ties."""
    spec = lp.spec
    b = codes.shape[0]
    basis = dense_basis_from_codes(codes, lw["lut"].to(torch.float32), spec)
    y = basis.reshape(b, lp.fp * spec.num_basis) @ unpacked_wc(lw, lp)
    if lp.residual_raw:
        resid = xraw.to(torch.float32)
    else:
        resid = f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)
    y = y + torch.clamp_min(resid, 0.0) @ lw["wb"].to(torch.float32)
    if psum_noise is not None:
        y = y + psum_noise
    if not lp.emit_codes:
        return y, None
    half_span, mid, lo, scale, num_codes = _requant_consts(lp)
    h = torch.tanh(y) * half_span + mid
    q = torch.floor((h - lo) * scale + 0.5).to(torch.int32)
    return y, torch.clamp(q, 0, num_codes - 1)


class RefExecutor(_CachedExecutor):
    name = "ref"

    def _mesh_layer_fn(self, key: PlanKey, local_plan):
        def layer_fn(li, lp, lw, h_codes, h_raw, psum_noise, splits):
            return _ref_padded_layer(
                lp, lw, h_codes, h_raw if lp.residual_raw else None,
                psum_noise=psum_noise)
        return layer_fn

    def _build_local(self, key: PlanKey):
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

    def _build_local(self, key: PlanKey):
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

    def _mesh_layer_fn(self, key: PlanKey, local_plan):
        """The fused step with the IR-drop row gains applied to the
        shard's column slab.  The gains are a full-length ROW vector (the
        contraction axis stays whole on every shard), so they broadcast
        unchanged against the slab."""
        base_fn = super()._mesh_layer_fn(key, local_plan)
        row_gains = self._row_gains(key, local_plan)

        def layer_fn(li, lp, lw, h_codes, h_raw, psum_noise, splits):
            return base_fn(li, lp, gained_layer(lw, lp, row_gains[li]),
                           h_codes, h_raw, psum_noise, splits)

        return layer_fn

    def _mesh_noise_fn(self, key: PlanKey, local_plan):
        """Per-shard stochastic terms, each from its own generator seeded
        by (the call's base seed, a tag, the shard's coordinates):

          * the entry-code noise folds in the data index only (codes are
            replicated across "model");
          * layer ``li``'s partial-sum draw folds in the model index only
            where that layer's columns are sharded, so a replicated layer
            draws identical noise on every model replica.

        A fixed seed on a fixed mesh reproduces; the draws are not the
        unsharded call's (nor the reference's: Philox is not threefry).
        Each shard owns whole columns, so its ``n_arrays`` and per-channel
        ``w_lsb`` equal the unsharded values of the same columns."""
        cfg, _, has_input_noise, has_psum = self._statics(key)
        if not (has_input_noise or has_psum):
            return None
        spec0 = key.specs[0]
        tm = cfg.input_gen

        def noise_fn(codes, layers, base_seed, ctx):
            dev = codes.device
            if has_input_noise:
                g = shard_generator(dev, base_seed, 0, ctx.data_index)
                eff = apply_input_noise(codes, tm, g)
                codes = torch.clamp(torch.floor(eff + 0.5).to(torch.int32),
                                    0, spec0.num_codes - 1)
            if not has_psum:
                return codes, None
            noises = []
            for li, (lp, lw) in enumerate(zip(local_plan.layers, layers)):
                mi = ctx.model_index if ctx.layer_sharded[li] else 0
                g = shard_generator(dev, base_seed, 1 + li, ctx.data_index,
                                    mi)
                noises.append(
                    self._layer_psum_std(cfg, lp, lw)[None, :] * torch.randn(
                        (local_plan.bp, lp.op), generator=g, device=dev))
            return codes, tuple(noises)

        return noise_fn

    def _build_sharded(self, key: PlanKey):
        """The shard body, fed a base seed drawn from the call's generator
        (one 62-bit draw, so a reused generator moves on)."""
        plan, apply = super()._build_sharded(key)

        def seeded(codes, xraw, layers, generator, return_intermediates):
            seed = 0
            if generator is not None:
                seed = int(torch.randint(2**62, (1,), generator=generator,
                                         device=generator.device).item())
            return apply(codes, xraw, layers, return_intermediates, seed)

        return plan, seeded

    def _build_local(self, key: PlanKey):
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


def _obs_collect() -> dict:
    """Per-backend dispatch counts under the reference's labeled series
    ``runtime.backend_dispatch{backend=...}``; the fused backend's label is
    ``fused`` (the reference's ``pallas``)."""
    return {
        ("runtime.backend_dispatch", (("backend", name),)): count
        for name, count in sorted(DISPATCH_COUNTS.items())
    }


_OBS_REGISTRY.register_collector(_obs_collect)


def _io_collect() -> dict:
    """The dispatches' rows and host bytes (the port's own series)."""
    return {
        ("runtime.rows", (("kind", "real"),)): IO_COUNTS["rows_real"],
        ("runtime.rows", (("kind", "pad"),)): IO_COUNTS["rows_pad"],
        "runtime.h2d_bytes": IO_COUNTS["h2d_bytes"],
    }


_OBS_REGISTRY.register_collector(_io_collect)
