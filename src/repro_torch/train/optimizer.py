"""Optimizers as functions over parameter trees: AdamW, Adafactor, SGD-momentum.

Port of ``repro.train.optimizer``.  Each optimizer is (init, update) over a
tree of tensors: nested dicts, lists and tuples, such as a KAN's list of
``{"c", "w_b"}`` dicts or an LM's nested dict of stacked leaves:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``update`` updates nothing in place: it returns new state tensors and
``apply_updates`` new parameters, so the functions mirror the reference's
pure ones step for step.  ``update_`` is the same step, leaf by leaf, in
place: it writes the new state and parameters into the given tensors, so
no temporary outlives its leaf (the LM train step, whose functional step
would hold a second copy of every state and parameter tensor):

    opt.update_(grads, state, params, ok)   # == update + apply_updates

Every state and parameter leaf becomes ``where(ok, new, old)`` (``ok`` a
bool tensor on the device), so a rejected step leaves them bit for bit
as they were.  Both paths share each leaf's arithmetic, so they give
the same bits.  State tensors (and the int32 step counter) live on the
parameters' device.  Adafactor keeps factored second moments for
leaves of two or more dimensions: an (n, m) matrix holds an (n,) row factor
and an (m,) column factor.  Arithmetic is f32 throughout, in the
reference's order; Python-float hyperparameters round to f32 as the
reference's weak typing rounds them.

On a mesh (a sharded train step) ``update_`` takes a tree of
:class:`LeafShard`, one per parameter, and the gradients whole over
"data" (summed there) and cut over "model" as their parameters are.
AdamW and SGD-momentum run ZeRO-1 as ``dist.sharding.opt_state_pspecs
(zero1=True)`` lays the moments out: each rank holds its "data" slab of a
moment tree, updates it and its slab of the parameter, and all-gathers
the parameter over "data".  Adafactor keeps its statistics whole on every
rank, as the reference's specs replicate them: a mean over a dim cut on
"model" is summed over the model group, a statistic whose other dim is cut
is all-gathered, and the update's RMS sums over the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..dist import comm

__all__ = ["Optimizer", "LeafShard", "adamw", "adafactor", "sgdm",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "clip_by_global_norm_", "tree_map", "tree_leaves",
           "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)
    # (grads, state, params, ok, shards=None) -> None: update +
    # apply_updates in place
    update_: Callable[..., None]


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How one parameter and its optimizer state are cut on a mesh:
    ``model_dim``, the parameter's dim cut over ``model_group`` (None:
    whole); ``data_dim``, the dim its moment slabs are cut on over
    ``data_group`` (ZeRO-1; None: the moments are whole)."""

    model_dim: int | None = None
    model_group: Any = None
    data_dim: int | None = None
    data_group: Any = None


def _data_slab(t: torch.Tensor, sh: LeafShard) -> torch.Tensor:
    n = comm.group_size(sh.data_group)
    w = t.shape[sh.data_dim] // n
    return t.narrow(sh.data_dim, comm.group_rank(sh.data_group) * w, w)


def _step_param(ok, g, p: torch.Tensor, sh: LeafShard | None, step) -> None:
    """``p`` <- ``where(ok, step(g, p), p)``; under ZeRO-1 (``sh`` with a
    data dim) ``step`` runs on this rank's "data" slabs of ``g`` and ``p``
    and the new slabs are all-gathered into ``p``."""
    if sh is None or sh.data_dim is None:
        _commit(ok, p, step(g, p))
        return
    ps = _data_slab(p, sh)
    new = torch.where(ok, step(_data_slab(g, sh), ps), ps)
    p.copy_(comm.all_gather(new, sh.data_group, sh.data_dim))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors inside dicts, lists and
    tuples), with the matching sub-trees of ``rest`` as further arguments.
    ``tree`` alone decides the structure, so a leaf of ``tree`` may meet a
    whole sub-tree of another argument (Adafactor's per-leaf state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_map``'s order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _f32(v, device) -> torch.Tensor:
    # filled on the device: torch.tensor(v, device=) would copy from the
    # host and wait for the device on every call
    return torch.full((), v, dtype=torch.float32, device=device)


def _commit(ok, old: torch.Tensor, new: torch.Tensor) -> None:
    """``old`` <- ``where(ok, new, old)``."""
    old.copy_(torch.where(ok, new, old))


def _apply(p, u):
    return (p + u).to(p.dtype)


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return _f32(lr, step.device)


def apply_updates(params, updates):
    return tree_map(_apply, params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / norm), norm).  A bf16 leaf times the f32
    scale is f32, as in the reference (JAX promotes; PyTorch keeps the
    leaf's dtype against a 0-dim tensor, so the leaf is promoted first)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), norm


def clip_by_global_norm_(grads: list, max_norm: float, cut=None,
                         group=None) -> torch.Tensor:
    """:func:`clip_by_global_norm` over a list of gradient tensors, in
    place: an f32 entry is scaled where it is, any other is replaced by its
    f32 clipped copy (the same bits).  Returns the norm.

    ``cut`` (one bool per entry) marks the entries that are this rank's
    slab of a gradient cut over ``group``: their sums of squares are summed
    over the group, and the whole entries count once.  Where nothing is
    cut the norm is :func:`global_norm`'s, in its order."""
    if cut is None or not any(cut) or comm.group_size(group) == 1:
        norm = global_norm(grads)
    else:
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        idx = [i for i, c in enumerate(cut) if c]
        summed = comm.all_reduce_sum(torch.stack([sq[i] for i in idx]),
                                     group)
        for j, i in enumerate(idx):
            sq[i] = summed[j]
        norm = torch.sqrt(sum(sq))
    scale = _clip_scale(norm, max_norm)
    for i, g in enumerate(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            grads[i] = g.to(torch.float32) * scale
    return norm


def _clip_scale(norm, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, norm.device) / (norm + 1e-9), max=1.0)


@dataclasses.dataclass(frozen=True)
class _Pair:
    """One leaf's (update, new state): a leaf to ``tree_map``, so the
    mapped tree splits into the updates and the state by two more maps."""

    update: torch.Tensor
    state: Any


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    def coefs(step):
        t = step.to(torch.float32)
        dev = step.device
        return (1 - torch.pow(_f32(b1, dev), t),
                1 - torch.pow(_f32(b2, dev), t), _lr_at(lr, step))

    def leaf(g, m_, v_, p, bc1, bc2, lr_t):
        """One leaf's :class:`_Pair` of (update, (new m, new v))."""
        g = g.to(torch.float32)
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * g * g
        u = -(lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        if weight_decay:
            u = u - lr_t * weight_decay * p.to(torch.float32)
        return _Pair(u, (m, v))

    def update(grads, state, params):
        step = state["step"] + 1
        c = coefs(step)
        out = tree_map(lambda g, m_, v_, p: leaf(g, m_, v_, p, *c),
                       grads, state["m"], state["v"], params)
        return (tree_map(lambda pr: pr.update, out),
                {"step": step, "m": tree_map(lambda pr: pr.state[0], out),
                 "v": tree_map(lambda pr: pr.state[1], out)})

    def update_(grads, state, params, ok, shards=None):
        step = state["step"] + 1
        c = coefs(step)

        def one(g, m_, v_, p, sh=None):
            def step_(gs, ps):
                pr = leaf(gs, m_, v_, ps, *c)
                _commit(ok, m_, pr.state[0])
                _commit(ok, v_, pr.state[1])
                return _apply(ps, pr.update)

            _step_param(ok, g, p, sh, step_)

        tree_map(one, grads, state["m"], state["v"], params,
                 *(() if shards is None else (shards,)))
        _commit(ok, state["step"], step)

    return Optimizer(init, update, update_)


# ----------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ----------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    def init_leaf(p):
        if _factored(p.shape):
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                  device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                  dtype=torch.float32, device=p.device),
            }
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    def init(params):
        return {
            "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
            "v": tree_map(init_leaf, params),
        }

    def coefs(step):
        t = step.to(torch.float32)
        return (1.0 - torch.pow(t, _f32(-decay, t.device)), _lr_at(lr, step),
                _f32(eps, t.device))

    def leaf(g, s, beta, lr_t, eps32):
        """One leaf's :class:`_Pair` of (update, new state dict)."""
        g = g.to(torch.float32)
        g2 = g * g + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = vr.mean(dim=-1, keepdim=True)[..., None]
            prec = (vr[..., None] * vc[..., None, :]) \
                / torch.maximum(denom, eps32)
            u = g / torch.sqrt(torch.maximum(prec, eps32))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g / torch.sqrt(torch.maximum(v, eps32))
            new_s = {"v": v}
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return _Pair(-lr_t * u, new_s)

    def update(grads, state, params):
        step = state["step"] + 1
        c = coefs(step)
        pairs = tree_map(lambda g, s: leaf(g, s, *c), grads, state["v"])
        updates = tree_map(lambda pr: pr.update, pairs)
        new_v = tree_map(lambda pr: pr.state, pairs)
        return updates, {"step": step, "v": new_v}

    def leaf_cut(g, s, beta, lr_t, eps32, dim, group):
        """:func:`leaf` for ``g``, this rank's slab of a gradient cut on
        ``dim`` over ``group``, against the whole statistics ``s``."""
        n, nd = comm.group_size(group), g.ndim
        w, lo = g.shape[dim], comm.group_rank(group) * g.shape[dim]

        def mean_over(x, axis, out_dim):
            # the mean over ``axis`` of the whole gradient's g2: summed
            # over the group where ``axis`` is the cut dim, else this
            # slab's means gathered along ``out_dim``
            if axis == dim:
                return comm.all_reduce_sum(x.sum(dim=axis), group) \
                    / (x.shape[axis] * n)
            return comm.all_gather(x.mean(dim=axis), group, out_dim)

        g = g.to(torch.float32)
        g2 = g * g + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * mean_over(g2, nd - 1, dim)
            vc_dim = dim if dim < nd - 2 else nd - 2
            vc = beta * s["vc"] + (1 - beta) * mean_over(g2, nd - 2, vc_dim)
            denom = vr.mean(dim=-1, keepdim=True)[..., None]
            vr_l, vc_l = vr, vc
            if dim < nd - 1:
                vr_l = vr.narrow(dim, lo, w)
            if dim != nd - 2:
                vc_l = vc.narrow(vc_dim, lo, w)
            if dim < nd - 2:
                denom = denom.narrow(dim, lo, w)
            prec = (vr_l[..., None] * vc_l[..., None, :]) \
                / torch.maximum(denom, eps32)
            u = g / torch.sqrt(torch.maximum(prec, eps32))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * comm.all_gather(g2, group, dim)
            u = g / torch.sqrt(torch.maximum(v.narrow(dim, lo, w), eps32))
            new_s = {"v": v}
        sq = comm.all_reduce_sum(torch.sum(u * u), group)
        rms = torch.sqrt(sq / (u.numel() * n) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return _Pair(-lr_t * u, new_s)

    def update_(grads, state, params, ok, shards=None):
        step = state["step"] + 1
        c = coefs(step)

        def one(g, s, p, sh=None):
            if sh is not None and sh.model_dim is not None \
                    and comm.group_size(sh.model_group) > 1:
                pr = leaf_cut(g, s, *c, sh.model_dim, sh.model_group)
            else:
                pr = leaf(g, s, *c)
            for k, new in pr.state.items():
                _commit(ok, s[k], new)
            _commit(ok, p, _apply(p, pr.update))

        tree_map(one, grads, state["v"], params,
                 *(() if shards is None else (shards,)))
        _commit(ok, state["step"], step)

    return Optimizer(init, update, update_)


# ----------------------------------------------------------------------------
# SGD with momentum
# ----------------------------------------------------------------------------


def sgdm(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {
            "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
        }

    def leaf(g, m_):
        """One leaf's :class:`_Pair` of (update, new m)."""
        m = momentum * m_ + g.to(torch.float32)
        return _Pair(-lr * m, m)

    def update(grads, state, params):
        del params
        out = tree_map(leaf, grads, state["m"])
        return (tree_map(lambda pr: pr.update, out),
                {"step": state["step"] + 1,
                 "m": tree_map(lambda pr: pr.state, out)})

    def update_(grads, state, params, ok, shards=None):
        def one(g, m_, p, sh=None):
            def step_(gs, ps):
                pr = leaf(gs, m_)
                _commit(ok, m_, pr.state)
                return _apply(ps, pr.update)

            _step_param(ok, g, p, sh, step_)

        tree_map(one, grads, state["m"], params,
                 *(() if shards is None else (shards,)))
        _commit(ok, state["step"], state["step"] + 1)

    return Optimizer(init, update, update_)
