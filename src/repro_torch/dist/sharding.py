"""Role-based sharding rules: param / optimizer / cache partition specs.

Port of ``repro.dist.sharding``.  The rules are NAME-based (the param tree
keys carry the role: wq/wk/wv have their heads axis at index ndim-2,
attention wo at ndim-3, ffn wi/wg shard the hidden dim, embed shards the
vocab) with a divisibility guard: a dim is only sharded when the mesh axis
divides it, otherwise the leaf stays replicated on that axis.  Scanned
stacks put a leading repeats dim on every decoder leaf, so every index
rule counts FROM THE END of the shape.

The port has no ``PartitionSpec``: :class:`PSpec` is its frozen stand-in,
one entry per tensor dim (an axis name, a tuple of names, or None), so a
spec compares entry for entry with the reference's.  The spec functions
read only the mesh's axis names and sizes (``mesh_dim_names`` and
``shape``), so they accept a ``DeviceMesh`` or any object with those two
attributes.  :func:`to_shardings` binds a spec tree to a mesh: each
spec becomes a :class:`MeshSharding`, the tuple of ``torch.distributed.
tensor`` placements (one ``Shard(dim)`` or ``Replicate()`` per mesh dim)
that also carries its mesh and spec, as a ``NamedSharding`` does.  The
port holds local tensors, not ``DTensor``s: :func:`shard_tensor` cuts a
whole tensor to this rank's slab of a sharding (:func:`shard_param` a
parameter by its path: the one place a parameter's tensor-parallel cut is
made) and :func:`gather_tensor` puts the slabs back together over the
mesh's groups.
"""

from __future__ import annotations

__all__ = [
    "PSpec",
    "axis_size",
    "leaf_pspec",
    "param_pspecs",
    "opt_state_pspecs",
    "batch_pspec",
    "cache_pspecs",
    "paged_cache_pspecs",
    "deployed_kan_pspecs",
    "to_shardings",
    "MeshSharding",
    "shard_tensor",
    "shard_param",
    "gather_tensor",
    "global_shape",
    "map_with_path",
]


class PSpec(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name, a
    tuple of axis names, or None (replicated along that dim).  A tuple of
    one name is stored as the name, as ``PartitionSpec`` stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"

    def on(self, dim: int, name: str) -> bool:
        """Whether tensor dim ``dim`` is cut on mesh axis ``name``."""
        e = self[dim] if -len(self) <= dim < len(self) else None
        return e == name or (isinstance(e, tuple) and name in e)

    def dim_on(self, name: str) -> int | None:
        """The tensor dim cut on mesh axis ``name`` (None: none is)."""
        return next((i for i in range(len(self)) if self.on(i, name)), None)


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name`` (1 when the mesh has no such axis)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(name, 1)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a param-like tree (dicts, lists, tuples; a
    :class:`PSpec` is a leaf); paths join dict keys and list indices with "/", as the reference's
    ``tree_flatten_with_path`` keys do."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PSpec):
        out = [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _leaves(tree) -> list:
    out = []
    map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, PSpec)


# (predicate on path, index-from-end of the dim to put on "model")
_MODEL_RULES = [
    (lambda p: p.endswith("wq") or p.endswith("wk") or p.endswith("wv"), 2),
    (lambda p: ("attn/wo" in p) or ("xattn/wo" in p), 3),          # (H, hd, D)
    (lambda p: p.endswith("bq") or p.endswith("bk") or p.endswith("bv"), 2),
    (lambda p: p.endswith("ffn/wi") or p.endswith("ffn/wg"), 1),   # (D, F)
    (lambda p: p.endswith("ffn/wo"), 2),                           # (F, D)
    (lambda p: p.endswith("moe/wi") or p.endswith("moe/wg"), 1),   # (E, D, F)
    (lambda p: p.endswith("moe/wo"), 2),                           # (E, F, D)
    (lambda p: p.endswith("ffn/c1"), 1),   # KAN (D, G+K, H): shard hidden
    (lambda p: p.endswith("ffn/wb1"), 1),
    (lambda p: p.endswith("ffn/c2"), 3),   # (H, G+K, D): shard hidden
    (lambda p: p.endswith("ffn/wb2"), 2),
]


def leaf_pspec(path: str, shape, mesh, fsdp: bool = False) -> PSpec:
    """The spec :func:`param_pspecs` gives the leaf at ``path`` (its tree
    keys joined with "/") of this ``shape``."""
    return _leaf_spec(path, tuple(shape), axis_size(mesh, "model"),
                      axis_size(mesh, "data"), fsdp)


def _leaf_spec(path: str, shape, msize: int, dsize: int, fsdp: bool) -> PSpec:
    nd = len(shape)
    parts = [None] * nd
    if nd == 0:
        return PSpec()
    if path.endswith("embed"):
        # (V, D): vocab on "model" (the lm_head transpose shards likewise)
        if msize > 1 and shape[0] % msize == 0:
            parts[0] = "model"
    elif path.endswith("lm_head") or path.endswith("patch_proj"):
        if msize > 1 and shape[-1] % msize == 0:
            parts[-1] = "model"
    else:
        for pred, from_end in _MODEL_RULES:
            if pred(path) and nd >= from_end:
                dim = nd - from_end
                if msize > 1 and shape[dim] % msize == 0:
                    parts[dim] = "model"
                break
    if fsdp and dsize > 1:
        # ZeRO-3-style: fully shard the largest still-replicated dim on
        # "data" when it divides evenly (skip tiny dims - norm scales etc.)
        cands = [
            i for i in range(nd)
            if parts[i] is None and shape[i] % dsize == 0
            and shape[i] >= 2 * dsize
        ]
        if cands:
            parts[max(cands, key=lambda i: shape[i])] = "data"
    return PSpec(*parts)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_pspecs(params, mesh, fsdp: bool = False):
    """PSpec tree for a ``models.model.init_params`` tree.  A leaf with no
    ``shape`` (a deployed KAN bundle) gets ``PSpec()``: the runtime's mesh
    runner places those itself."""
    msize, dsize = axis_size(mesh, "model"), axis_size(mesh, "data")
    return map_with_path(
        lambda path, leaf: _leaf_spec(path, _shape(leaf), msize, dsize, fsdp),
        params)


def opt_state_pspecs(opt_state, params, mesh, zero1: bool = True):
    """Optimizer-state specs: moment trees mirror the param layout.

    ``zero1`` keeps the moments on their param's (fsdp) spec; an entry that
    is not a moment tree (a step counter) replicates."""
    pspecs = param_pspecs(params, mesh, fsdp=zero1)
    n_params = len(_leaves(params))

    def one(entry):
        if isinstance(entry, dict) and entry:
            leaves = _leaves(entry)
            if leaves and len(leaves) == n_params:
                return pspecs
        return map_with_path(lambda _p, _l: PSpec(), entry)

    if isinstance(opt_state, dict):
        return {k: one(v) for k, v in opt_state.items()}
    return map_with_path(lambda _p, _l: PSpec(), opt_state)


def batch_pspec(mesh, global_batch: int) -> PSpec:
    """Batch-dim spec: shard over "data" when it divides; the tuple form is
    used when there is slack for further axes (super-batch > data size)."""
    dsize = axis_size(mesh, "data")
    if dsize <= 1 or global_batch % dsize != 0:
        return PSpec(None)
    if global_batch > dsize:
        return PSpec(("data",))
    return PSpec("data")


def _first_dim_on_data(leaf, size: int, dsize: int, start: int) -> PSpec:
    shape = _shape(leaf)
    parts = [None] * len(shape)
    if dsize > 1 and size % dsize == 0:
        for i, d in enumerate(shape):
            if i >= start and d == size:
                parts[i] = "data"
                break
    return PSpec(*parts)


def cache_pspecs(cache, mesh, batch: int):
    """KV / recurrent cache specs: shard the batch dim on "data" if it
    divides (the first dim whose size equals ``batch``)."""
    dsize = axis_size(mesh, "data")
    return map_with_path(
        lambda _, leaf: _first_dim_on_data(leaf, batch, dsize, 0), cache)


def paged_cache_pspecs(cache, mesh, num_blocks: int):
    """Paged KV pool specs: shard the pool (num_blocks) dim on "data" when
    it divides.  Leaves are (repeats, NB, block_size, H, D); the NB dim is
    matched by size from index 1, so a repeats count equal to NB cannot
    shadow it."""
    dsize = axis_size(mesh, "data")
    return map_with_path(
        lambda _, leaf: _first_dim_on_data(leaf, num_blocks, dsize, 1),
        cache)


def deployed_kan_pspecs(dep, mesh) -> tuple:
    """Per-layer PSpec dicts for a deployed KAN bundle.

    The padded banded weights shard their OUTPUT-channel (last) dim on
    "model" (each shard owns whole MAC columns), the shared SH-LUT ("lut",
    "lutp") replicates.  Shardability is the runtime's criterion
    (``kernels.kan_spline.pipeline.model_shardable``), read from the plan's
    GLOBAL padded width, so a placed bundle (whose leaves hold local slabs)
    gets the same specs as the bundle it was placed from.
    """
    from ..kernels.kan_spline.pipeline import model_shardable

    msize = axis_size(mesh, "model")

    def one_layer(lw, lp):
        sharded = model_shardable(int(lp.op), msize)

        def spec(k, a):
            nd = len(_shape(a))
            if k.startswith("lut") or not sharded:
                return PSpec(*([None] * nd))
            return PSpec(*([None] * (nd - 1) + ["model"]))

        return {k: spec(k, a) for k, a in lw.items()}

    return tuple(one_layer(lw, lp)
                 for lw, lp in zip(dep.layers, dep.plan.layers))


def _placements(spec: PSpec, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = spec.dim_on(name)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class MeshSharding(tuple):
    """A :class:`PSpec` bound to a mesh: the placements, one per mesh dim
    (it compares as that tuple), with ``mesh`` and ``spec`` attached."""

    def __new__(cls, spec: PSpec, mesh):
        obj = super().__new__(cls, _placements(spec, mesh))
        obj.mesh, obj.spec = mesh, spec
        return obj

    def __reduce__(self):
        return (tuple, (tuple(self),))

    def cuts(self):
        """(mesh dim name, tensor dim, mesh dim size) of each mesh dim that
        shards the tensor, in mesh order."""
        sizes = tuple(self.mesh.shape)
        return [(name, pl.dim, sizes[i])
                for i, (name, pl) in enumerate(zip(self.mesh.mesh_dim_names,
                                                   self))
                if hasattr(pl, "dim") and sizes[i] > 1]


def to_shardings(pspecs, mesh):
    """Bind a PSpec tree to a mesh: each spec becomes a
    :class:`MeshSharding`."""
    if _is_spec(pspecs):
        return MeshSharding(pspecs, mesh)
    if isinstance(pspecs, dict):
        return {k: to_shardings(v, mesh) for k, v in pspecs.items()}
    out = [to_shardings(v, mesh) for v in pspecs]
    return out if isinstance(pspecs, list) else tuple(out)


def global_shape(local_shape, sharding: MeshSharding) -> tuple:
    """The whole tensor's shape of a slab of ``local_shape``."""
    shape = list(local_shape)
    for _, dim, n in sharding.cuts():
        shape[dim] *= n
    return tuple(shape)


def shard_tensor(t, sharding: MeshSharding):
    """This rank's slab of the whole tensor ``t`` (``t`` itself where
    nothing is cut)."""
    from ..runtime.meshexec import mesh_index

    for name, dim, n in sharding.cuts():
        w = t.shape[dim] // n
        t = t.narrow(dim, mesh_index(sharding.mesh, name) * w, w)
    return t.contiguous()


def shard_param(path: str, leaf, mesh):
    """This rank's slab of the parameter ``leaf`` at ``path`` on ``mesh``:
    the cut :func:`param_pspecs` (no fsdp) gives it, on "model" only.  A
    leaf of a scanned stack may be cut before it is stacked: the rules
    count dims from the end."""
    return shard_tensor(leaf, MeshSharding(leaf_pspec(path, leaf.shape, mesh),
                                           mesh))


def gather_tensor(t, sharding: MeshSharding):
    """The whole tensor from every rank's slab ``t``: all-gathered over the
    group of each mesh dim that cuts it (``t`` itself where nothing is
    cut)."""
    from .comm import all_gather

    for name, dim, _ in reversed(sharding.cuts()):
        t = all_gather(t, sharding.mesh.get_group(name), dim)
    return t
