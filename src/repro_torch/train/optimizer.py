"""Optimizers as functions over parameter trees: AdamW, Adafactor, SGD-momentum.

Port of ``repro.train.optimizer``.  Each optimizer is (init, update) over a
tree of tensors: nested dicts, lists and tuples, such as a KAN's list of
``{"c", "w_b"}`` dicts or an LM's nested dict of stacked leaves:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Nothing is updated in place: ``update`` returns new state tensors and
``apply_updates`` new parameters, so the functions mirror the reference's
pure ones step for step.  State tensors (and the int32 step counter) live
on the parameters' device.  Adafactor keeps factored second moments for
leaves of two or more dimensions: an (n, m) matrix holds an (n,) row factor
and an (m,) column factor.  Arithmetic is f32 throughout, in the
reference's order; Python-float hyperparameters round to f32 as the
reference's weak typing rounds them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Optimizer", "adamw", "adafactor", "sgdm", "apply_updates",
           "global_norm", "clip_by_global_norm", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)


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


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return _f32(lr, step.device)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, norm.device) / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


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

    def update(grads, state, params):
        step = state["step"] + 1
        dev = step.device
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], gf)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], gf)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, dev), t)
        bc2 = 1 - torch.pow(_f32(b2, dev), t)
        lr_t = _lr_at(lr, step)

        def upd(m_, v_, p):
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        updates = tree_map(upd, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


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

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta = 1.0 - torch.pow(t, _f32(-decay, t.device))
        lr_t = _lr_at(lr, step)
        eps32 = _f32(eps, t.device)

        def upd(g, s):
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

        pairs = tree_map(upd, grads, state["v"])
        updates = tree_map(lambda pr: pr.update, pairs)
        new_v = tree_map(lambda pr: pr.state, pairs)
        return updates, {"step": step, "v": new_v}

    return Optimizer(init, update)


@dataclasses.dataclass(frozen=True)
class _Pair:
    """One leaf's (update, new state): a leaf to ``tree_map``, so the
    mapped tree splits into the updates and the state by two more maps."""

    update: torch.Tensor
    state: dict


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

    def update(grads, state, params):
        del params
        m = tree_map(lambda m_, g: momentum * m_ + g.to(torch.float32),
                     state["m"], grads)
        updates = tree_map(lambda m_: -lr * m_, m)
        return updates, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)
