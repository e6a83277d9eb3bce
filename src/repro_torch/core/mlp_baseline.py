"""Traditional-MLP baseline (paper Fig. 13, ref. [22] Davies et al.).

Port of ``repro.core.mlp_baseline``.  17-420-420-14 ReLU MLP:
17*420+420 + 420*420+420 + 420*14+14 = 190,274 parameters (the paper
reports 190,214; the small delta is bias-counting).  Trained with the same
recipe as the KANs (AdamW, the same learning rate and weight decay) so the
accuracy comparison is fair.  ``init_mlp`` draws from an explicit
``torch.Generator``; ``train_mlp`` draws its epoch permutations from one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..train.optimizer import adamw, apply_updates

__all__ = ["init_mlp", "mlp_apply", "train_mlp", "mlp_param_count",
           "PAPER_MLP_DIMS"]

PAPER_MLP_DIMS = (17, 420, 420, 14)


def mlp_param_count(dims=PAPER_MLP_DIMS) -> int:
    return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))


def init_mlp(generator: torch.Generator, dims=PAPER_MLP_DIMS, *,
             device=None, dtype=torch.float32) -> list:
    """He-normal weights, zero biases, on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    params = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = torch.randn((i, o), generator=generator, device=dev,
                        dtype=dtype) * float(np.sqrt(2.0 / i))
        params.append({"w": w, "b": torch.zeros((o,), dtype=dtype,
                                                device=dev)})
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for li, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if li < len(params) - 1:
            h = torch.relu(h)
    return h


def train_mlp(params, x_train, y_train, x_val, y_val, epochs=200,
              batch_size=2048, lr=3e-3, seed=0, *,
              generator: torch.Generator | None = None):
    """Mini-batch AdamW on the params' device; returns (params, history)
    with the validation accuracy after each epoch.  ``generator`` draws the
    epoch permutations (None: one seeded from ``seed``)."""
    dev = params[0]["w"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    opt = adamw(lr, weight_decay=1e-4)
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    opt_state = opt.init(params)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev) \
        if not isinstance(a, torch.Tensor) else a.to(device=dev, dtype=dt)
    x_train, x_val = as_t(x_train, torch.float32), as_t(x_val, torch.float32)
    y_train, y_val = as_t(y_train, torch.int64), as_t(y_val, torch.int64)
    n = x_train.shape[0]
    steps = max(1, n // batch_size)

    def loss_fn(params, xb, yb):
        logp = torch.log_softmax(mlp_apply(params, xb), dim=-1)
        return -torch.gather(logp, 1, yb[:, None]).mean()

    history = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=dev)
        for s in range(steps):
            idx = perm[s * batch_size: (s + 1) * batch_size]
            leaves = [v.requires_grad_(True) for p in params
                      for v in p.values()]
            loss = loss_fn(params, x_train[idx], y_train[idx])
            it = iter(torch.autograd.grad(loss, leaves))
            grads = [{k: next(it) for k in p} for p in params]
            with torch.no_grad():
                params = [{k: v.detach() for k, v in p.items()}
                          for p in params]
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
        with torch.no_grad():
            logits = mlp_apply(params, x_val)
        history.append(float((torch.argmax(logits, -1) == y_val)
                             .to(torch.float32).mean()))
    return params, history
