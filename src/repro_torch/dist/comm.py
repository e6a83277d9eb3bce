"""Collectives over mesh groups, their counters, and the model code's scopes.

Every collective the port issues on a serving, runtime or training path
goes through one of the helpers here, which count their calls in
:data:`COLLECTIVES` (``all_gather`` / ``all_reduce`` / ``broadcast``) and
their per-device payload, the bytes of the result, in
:data:`COLLECTIVE_BYTES` by the same kinds, so a caller can read what a
step paid.  A group of one rank is a no-op and counts nothing.

A :class:`DryGroup` stands in for a group of ``size`` ranks that does not
exist (the dry-run, ``launch.dryrun``): a collective over it sends nothing
and returns an uninitialized tensor of the result's shape (``new_empty``),
so it is meant for tensors on the meta device, and it counts as a real one
does.

The collectives carry gradients in Megatron's f / g form, so a meshed
forward trains: :func:`tp_copy` (f: identity forward, all-reduce of the
gradient backward) at the input of a region whose weights are cut on
their output dim; :func:`tp_reduce` (g: all-reduce forward, identity
backward) after a region whose weights are cut on their input dim;
:func:`tp_gather` (all-gather forward, this rank's chunk of the gradient
backward) for outputs cut on a dim, such as the logits of a vocabulary
slab.  Their backward collectives count as the forward ones do.  Without
autograd (serving under ``no_grad``) f is the identity and g / gather are
:func:`all_reduce_sum` / :func:`all_gather`, so a served step issues the
same collectives as before.

:func:`use_tp` binds a :class:`TPLayout` for the model code
(``models.layers`` / ``models.model``): the ``"model"`` group of a mesh and
the roles whose weights ``models.model.place_params`` cut to a local slab
(query and KV heads, dense FFN hidden columns, MoE expert hidden columns,
the patch projection's columns, the vocabulary).  A layer of a cut role
reduces or gathers its partial result over that group; a layer of a whole
role never pays a collective.

:func:`use_row_split` binds the ``"data"`` group when a step runs this
rank's rows of one batch split over that axis in rank order (the serving
engine's decode and verify, a meshed train step); a layer that couples the
rows of a batch (MoE capacity routing) then routes them as the whole
batch.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "COLLECTIVE_BYTES",
    "DryGroup",
    "reset_collectives",
    "group_size",
    "group_rank",
    "all_gather",
    "all_reduce_sum",
    "broadcast",
    "tp_copy",
    "tp_reduce",
    "tp_gather",
    "TPLayout",
    "use_tp",
    "tp_layout",
    "use_row_split",
    "row_split_group",
]

COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A group of ``size`` ranks, seen from its ``rank``-th, that has no
    process behind it (see the module note)."""

    size: int
    rank: int = 0


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()


def _count(kind: str, result: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += result.numel() * result.element_size()


def group_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, DryGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None:
        return 0
    if isinstance(group, DryGroup):
        return group.rank
    return dist.get_rank(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` (rank order of the
    group), through ``all_gather_into_tensor``."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.movedim(dim, 0)
    shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if isinstance(group, DryGroup):
        out = t.new_empty(shape)
    else:
        t = t.contiguous()
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    _count("all_gather", out)
    return out.movedim(0, dim)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor on every rank)."""
    if group_size(group) == 1:
        return t
    if isinstance(group, DryGroup):
        t = t.new_empty(t.shape)
    else:
        t = t.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", t)
    return t


def broadcast(t: torch.Tensor, src_index: int, group,
              one_rank: bool = False) -> torch.Tensor:
    """``t`` of the group's ``src_index``-th rank, on every rank (in
    place).  ``one_rank``: issue (and count) it on a group of one rank too,
    where a world-1 group still runs the collective."""
    if group is None or (group_size(group) == 1 and not one_rank):
        return t
    if not isinstance(group, DryGroup):
        dist.broadcast(t, src=dist.get_global_rank(group, src_index),
                       group=group)
    _count("broadcast", t)
    return t


# -- collectives that carry a gradient ----------------------------------------


def _tracks_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Copy(torch.autograd.Function):
    """f: identity forward, the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """g: the sum over ``group`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenation over ``group`` along ``dim`` forward; this rank's
    chunk of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        lo = group_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a region whose weights are cut over ``group`` on their
    output dim: the gradient that flows back is summed over the group."""
    if group_size(group) == 1 or not _tracks_grad(x):
        return x
    return _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of a region's partial outputs; the gradient
    passes through unchanged."""
    if group_size(group) == 1 or not _tracks_grad(x):
        return all_reduce_sum(x, group)
    return _Reduce.apply(x, group)


def tp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient that
    flows back is this rank's chunk."""
    if group_size(group) == 1 or not _tracks_grad(x):
        return all_gather(x, group, dim)
    return _Gather.apply(x, group, dim % x.ndim)


# -- scopes for the model code ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which roles of a param tree hold a tensor-parallel slab over
    ``group`` (a mesh's ``"model"`` group), as ``models.model.place_params``
    cut them: ``heads`` (wq / bq query heads and attention ``wo`` rows),
    ``kv`` (wk / wv / bk / bv heads, cut only with the query heads: where
    the group's size divides the query head count alone, the KV heads stay
    whole and each rank takes those its query heads read), ``ffn`` (the
    dense or float KAN-FFN hidden dim), ``moe`` (the experts' hidden dim),
    ``patch`` (the patch projection's output columns) and ``vocab``
    (``embed`` rows, ``lm_head`` columns).  ``size`` and ``rank`` are the
    mesh's "model" size and this rank's coordinate there, which chose the
    slabs.  The default cuts nothing."""

    group: Any = None
    heads: bool = False
    kv: bool = False
    ffn: bool = False
    moe: bool = False
    patch: bool = False
    vocab: bool = False
    size: int = 1
    rank: int = 0


_TP: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tp",
                                                     default=TPLayout())
_ROWS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_rows",
                                                       default=None)


@contextlib.contextmanager
def _bind(var, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def use_tp(layout: TPLayout | None):
    """Bind the tensor-parallel layout for the model code; ``None`` binds
    one that cuts nothing."""
    return _bind(_TP, TPLayout() if layout is None else layout)


def tp_layout() -> TPLayout:
    return _TP.get()


def use_row_split(group):
    """Bind the ``"data"`` group whose ranks hold, in rank order, equal
    slabs of the rows of the batch a step runs (``None``: the rows are the
    whole batch)."""
    return _bind(_ROWS, group)


def row_split_group():
    return _ROWS.get()
