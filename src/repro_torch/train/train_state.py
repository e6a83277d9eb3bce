"""Train state and the LM train step.

Port of ``repro.train.train_state``.  The state is a dict of tensors on
one device:

    {"params": ..., "opt": ..., "step", "good_steps", "skipped_steps"}

(the three counters int32 scalars).  ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``, which updates the
state's tensors IN PLACE and returns the same dict: the reference returns
a new state and donates the old one to ``jit``; eagerly, a second copy of
every parameter and optimizer tensor would not fit beside the first at
the published widths, so the optimizer runs leaf by leaf in place
(``Optimizer.update_``).  The metrics (``loss``, ``grad_norm``, ``ok``)
stay on the device; the step itself never waits for the device.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.model import init_params, loss_fn
from ..obs.trace import profile_scope
from ..runtime.attention import use_attn_backend
from .optimizer import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm_,
    sgdm,
    tree_leaves,
    tree_unflatten,
)

__all__ = ["make_optimizer", "init_state", "make_train_step"]


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg.learning_rate, weight_decay=0.1)
    if cfg.optimizer == "adafactor":
        return adafactor(cfg.learning_rate)
    if cfg.optimizer == "sgdm":
        return sgdm(cfg.learning_rate)
    raise ValueError(cfg.optimizer)


def init_state(gen: torch.Generator, cfg: ModelConfig, *,
               device=None) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``, the
    card unless ``device="cpu"``), the optimizer's zero state and the
    counters."""
    dev = resolve_device(device)
    params = init_params(gen, cfg, device=dev)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return {
        "params": params,
        "opt": make_optimizer(cfg).init(params),
        "step": zero(),
        "good_steps": zero(),   # NaN-guard accounting
        "skipped_steps": zero(),
    }


def make_train_step(cfg: ModelConfig, grad_clip: float = 1.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    * gradient accumulation over ``cfg.microbatch`` microbatches: each
      microbatch's gradients (``torch.autograd.grad``, in the parameters'
      dtype) add into an f32 accumulator, as the reference's f32 scan
      carry does; then loss sum / mb and grads / mb;
    * global-norm clipping;
    * NaN/Inf step rejection: ``ok = isfinite(loss) & isfinite(grad_norm)``
      stays on the device, every parameter and optimizer tensor becomes
      ``where(ok, new, old)`` (a rejected step leaves them bit for bit as
      they were) and ``good_steps`` / ``skipped_steps`` count on the device.

    Attention runs on the ``"ref"`` backend: kernel B2 has no backward
    (nor has the reference's Pallas kernel), so the step pins the one
    differentiable backend of both packages.  The forward, backward and
    optimizer parts run in ``train.forward`` / ``train.backward`` /
    ``train.optimizer`` profiler ranges while ``obs`` annotations are on.
    """
    opt = make_optimizer(cfg)

    def value_and_grad(params, leaves, batch):
        with profile_scope("train.forward"):
            loss = loss_fn(params, batch, cfg)
        with profile_scope("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        mb = max(1, cfg.microbatch)
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state["params"])]
        params = tree_unflatten(state["params"], leaves)
        with use_attn_backend("ref"):
            if mb > 1:
                split = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                         for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves]
                for i in range(mb):
                    mloss, mgrads = value_and_grad(
                        params, leaves, {k: v[i] for k, v in split.items()})
                    loss = loss + mloss
                    for acc, g in zip(grads, mgrads):
                        acc.add_(g)
                    del mgrads
                loss = loss / mb
                for g in grads:
                    g.div_(mb)
            else:
                loss, grads = value_and_grad(params, leaves, batch)

        with torch.no_grad(), profile_scope("train.optimizer"):
            gnorm = clip_by_global_norm_(grads, grad_clip)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            opt.update_(tree_unflatten(state["params"], grads), state["opt"],
                        state["params"], ok)
            state["step"] += 1
            state["good_steps"] += ok.to(torch.int32)
            state["skipped_steps"] += (~ok).to(torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "ok": ok}

    return train_step
