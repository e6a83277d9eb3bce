"""Mesh-sharded execution of the KAN runtime (the distributed dimension).

Port of ``repro.runtime.meshexec`` onto a ``torch.distributed``
``DeviceMesh``.  The fused pipeline's **batch** shards over the mesh's
``"data"`` axis and each layer's **output channels** over ``"model"``
(the ``dist.sharding.deployed_kan_pspecs`` layout: every shard owns whole
MAC columns, so no layer reduces across shards).  The boundary requantizer
stays shard-local: each shard re-codes its own columns, then an all-gather
over ``"model"`` restores the full-width int32 code vector the next layer
contracts against.

Resolution: explicit ``mesh=`` argument > :func:`use_mesh` scope > the
bundle's ``DeployedKAN.placement`` > unsharded.  A layer whose padded
output dim the model axis cannot split keeps replicated columns, and the
reason is recorded in :func:`shard_notes` (the only fallback there is).

The reference wraps one ``shard_map`` around its body; the port is SPMD
(one process per device, every rank on the same global inputs), so
:func:`build_sharded_runner` writes the shard body out: each rank takes its
data slab of the bucket-padded rows, runs kernel B1 (or the backend's
layer step) on its column slab at the GLOBAL layer's feature split, so each
column sums as in the unsharded launch, gathers codes between layers, and
gathers ``y`` (and the boundaries, when asked) so every rank returns the
global arrays.  A 1x1 or a data-only mesh is therefore bit-identical to
the unsharded call for every deterministic program, as long as a row's
bits do not depend on how many rows share its launch (B1's do not; a CPU
GEMM's may).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..dist import comm

__all__ = [
    "ShardContext",
    "use_mesh",
    "resolve_mesh",
    "mesh_axis_sizes",
    "mesh_index",
    "mesh_fingerprint",
    "register_mesh",
    "mesh_from_fingerprint",
    "shard_notes",
    "reset_shard_notes",
    "shard_generator",
    "build_sharded_runner",
]

# innermost use_mesh() override; a ContextVar, as the backend scope
_SCOPE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kan_mesh_scope", default=None
)

# fingerprint core -> live mesh (PlanKey stays hashable: it carries the
# fingerprint, and the mesh object is parked here)
_MESHES: dict = {}
# fingerprint -> tuple of human-readable fallback reasons (replicated layers)
_NOTES: dict = {}


@contextlib.contextmanager
def use_mesh(mesh):
    """Scoped mesh override, mirroring ``use_backend``; ``None`` is a
    passthrough so callers can plumb an optional choice."""
    token = _SCOPE_MESH.set(mesh if mesh is not None else _SCOPE_MESH.get())
    try:
        yield
    finally:
        _SCOPE_MESH.reset(token)


def resolve_mesh(mesh=None, placement=None):
    """Explicit arg > ``use_mesh`` scope > bundle placement > None."""
    if mesh is not None:
        return mesh
    scoped = _SCOPE_MESH.get()
    if scoped is not None:
        return scoped
    return placement


def mesh_axis_sizes(mesh) -> tuple:
    """(data_size, model_size) of a mesh; absent axes count as 1."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return int(sizes.get("data", 1)), int(sizes.get("model", 1))


def mesh_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 when absent)."""
    if name not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(name))


def _group(mesh, name: str):
    return mesh.get_group(name) if name in mesh.mesh_dim_names else None


def mesh_fingerprint(mesh, layer_sharded) -> tuple:
    """Hashable identity of (mesh layout x per-layer sharded-or-not): axis
    names, sizes, the flat ranks, the device type and the per-layer flags
    (a geometry that fell back to replicated columns never collides with a
    fully sharded one)."""
    return (
        tuple(mesh.mesh_dim_names),
        tuple(int(s) for s in mesh.shape),
        tuple(int(r) for r in mesh.mesh.flatten().tolist()),
        str(mesh.device_type),
        tuple(bool(f) for f in layer_sharded),
    )


def register_mesh(fingerprint: tuple, mesh, notes=()) -> None:
    _MESHES[fingerprint[:4]] = mesh
    if notes:
        _NOTES[fingerprint] = tuple(notes)


def mesh_from_fingerprint(fingerprint: tuple):
    return _MESHES[fingerprint[:4]]


def shard_notes() -> dict:
    """Recorded sharding fallbacks: fingerprint -> reasons (for reporting)."""
    return dict(_NOTES)


def reset_shard_notes() -> None:
    _NOTES.clear()


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """Per-shard coordinates handed to backend hooks inside the shard body:
    this rank's ``data_index`` / ``model_index`` (0 where the mesh lacks
    the axis), and which layers' columns are split on "model"."""

    data_index: int
    model_index: int
    layer_sharded: tuple


def shard_generator(device, base_seed: int, *tags) -> torch.Generator:
    """A generator on ``device`` seeded from ``base_seed`` and integer
    ``tags`` (numpy's SeedSequence: the same tags give the same stream on
    every process, and different tags decorrelated ones)."""
    seed = np.random.SeedSequence([int(base_seed) % 2**63,
                                   *(int(t) for t in tags)])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed.generate_state(1, np.uint64)[0] % 2**63))
    return g


def build_sharded_runner(mesh, *, local_plan, layer_sharded, feature_splits,
                         residual_raw, layer_fn, noise_fn=None):
    """The shard body of one cached executor entry, as a function.

    Returns ``runner(codes, xraw, layers, noise_arg, return_intermediates)
    -> (y, boundaries)``:

      * ``codes``/``xraw`` are GLOBAL, padded to the global bucket and the
        entry feature pad ``fp0``; this rank takes its ``bucket / data``
        rows (padded further to the local plan's ``bp`` when a tuned ``bb``
        asks for it);
      * ``layers`` are this rank's slabs: sharded layers' weight columns
        for its model index, the SH-LUT whole;
      * ``noise_arg`` goes to ``noise_fn`` (the acim backend's base seed);
      * ``y`` comes back as the global (bucket, op_last) array, and the
        boundaries (with ``return_intermediates``) as the full-width int32
        codes each layer handed to the next, on every rank.

    ``layer_fn(li, lp, lw, codes, xraw, psum_noise, splits)`` runs ONE
    layer on the per-shard geometry, ``splits`` being the global layer's
    feature split count; ``noise_fn(codes, layers, noise_arg, ctx)``
    (optional) perturbs the entry codes and returns per-layer noise.
    """
    dsize, msize = mesh_axis_sizes(mesh)
    dgroup, mgroup = _group(mesh, "data"), _group(mesh, "model")
    ctx = ShardContext(data_index=mesh_index(mesh, "data"),
                       model_index=mesh_index(mesh, "model"),
                       layer_sharded=tuple(layer_sharded))

    def runner(codes, xraw, layers, noise_arg, return_intermediates):
        b_l = codes.shape[0] // dsize
        if dsize > 1:
            rows = slice(ctx.data_index * b_l, (ctx.data_index + 1) * b_l)
            codes = codes[rows]
            xraw = None if xraw is None else xraw[rows]
        if b_l != local_plan.bp:
            # a tuned bb may not divide the slab: pad rows up to the local
            # plan's bp (rows are independent), sliced back below
            pad = (0, 0, 0, local_plan.bp - b_l)
            codes = F.pad(codes, pad)
            xraw = None if xraw is None else F.pad(xraw, pad)
        noises = None
        if noise_fn is not None:
            codes, noises = noise_fn(codes, layers, noise_arg, ctx)
        h_codes, h_raw = codes, xraw
        y = None
        boundary = []
        for li, (lp, lw) in enumerate(zip(local_plan.layers, layers)):
            y, nxt = layer_fn(li, lp, lw, h_codes, h_raw,
                              None if noises is None else noises[li],
                              feature_splits[li])
            if nxt is None:
                continue  # last layer: f32 output only
            y_next = y if residual_raw else None
            if layer_sharded[li] and msize > 1:
                # the shard-local requantizer re-coded this shard's
                # columns; the next layer contracts the full feature axis
                nxt = comm.all_gather(nxt, mgroup, dim=1)
                if y_next is not None:
                    y_next = comm.all_gather(y_next, mgroup, dim=1)
            boundary.append(nxt)
            h_codes, h_raw = nxt, y_next
        if layer_sharded[-1] and msize > 1:
            y = comm.all_gather(y, mgroup, dim=1)
        y = comm.all_gather(y[:b_l], dgroup, dim=0)
        if not return_intermediates:
            return y, ()
        return y, tuple(comm.all_gather(c[:b_l], dgroup, dim=0)
                        for c in boundary)

    return runner
