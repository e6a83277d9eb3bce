"""Collectives over mesh groups, their counters, and the model code's scopes.

Every collective the port issues on a serving or runtime path goes through
one of the helpers here, which count their calls in :data:`COLLECTIVES`
(``all_gather`` / ``all_reduce`` / ``broadcast``) so a caller can read how
many a step paid.  A group of one rank is a no-op and counts nothing.

:func:`use_tp` binds a :class:`TPLayout` for the model code
(``models.layers`` / ``models.model``): the ``"model"`` group of a mesh and
the roles whose weights ``models.model.place_params`` cut to a local slab
(attention heads, dense FFN hidden columns, the vocabulary).  A layer of a
cut role reduces or gathers its partial result over that group; a layer of
a whole role never pays a collective.

:func:`use_row_split` binds the ``"data"`` group when a step runs this
rank's rows of one batch split over that axis in rank order (the serving
engine's decode and verify); a layer that couples the rows of a batch
(MoE capacity routing) then routes them as the whole batch.
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
    "reset_collectives",
    "group_size",
    "group_rank",
    "all_gather",
    "all_reduce_sum",
    "broadcast",
    "TPLayout",
    "use_tp",
    "tp_layout",
    "use_row_split",
    "row_split_group",
]

COLLECTIVES: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` (rank order of the
    group), through ``all_gather_into_tensor``."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    COLLECTIVES["all_gather"] += 1
    return out.movedim(0, dim)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor on every rank)."""
    if group_size(group) == 1:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def broadcast(t: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """``t`` of the group's ``src_index``-th rank, on every rank (in
    place)."""
    if group_size(group) == 1:
        return t
    dist.broadcast(t, src=dist.get_global_rank(group, src_index), group=group)
    COLLECTIVES["broadcast"] += 1
    return t


# -- scopes for the model code ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which roles of a param tree hold a tensor-parallel slab over
    ``group`` (a mesh's ``"model"`` group), as ``models.model.place_params``
    cut them: ``heads`` (wq / wk / wv / bq / bk / bv heads and attention
    ``wo`` rows), ``ffn`` (the dense or float KAN-FFN hidden dim) and
    ``vocab`` (``embed`` rows, ``lm_head`` columns).  The default cuts
    nothing."""

    group: Any = None
    heads: bool = False
    ffn: bool = False
    vocab: bool = False

    @property
    def size(self) -> int:
        return group_size(self.group)

    @property
    def rank(self) -> int:
        return group_rank(self.group)


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
