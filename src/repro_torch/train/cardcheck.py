"""LM training held against its plain and CPU counterparts on the card.

The one definition of the training checks, shared by ``chip_smoke.py``
and ``tests/test_torch_gpu.py``.  Each raises ``AssertionError`` on
disagreement and returns what it measured:

  * :func:`check_spline_mm`: the float KAN-FFN's custom backward
    (``models.layers._SplineMM``) against autograd through the plain
    forward (``bspline_basis_fast``, an f32 matmul), at a KAN-FFN half's
    widths on f32 copies: dx and dc within
    ``SPLINE_TOL * max|plain| + 1e-6`` (f32 sums in another order; the
    Horner derivative against autograd's chain through the polynomial);
  * :func:`check_card_vs_cpu`: the train step on the card against the
    same steps on the CPU from the same weights (f32, TF32 off): losses
    and grad norms within ``CARD_CPU_TOL``, parameters within
    ``CARD_CPU_TOL`` except where the CPU's gradient fell below
    ``GRAD_FLOOR`` at some step (the sign of an Adam step there is
    rounding noise); those elements are counted and must stay under
    ``EXCUSED_SHARE`` of the parameters;
  * :func:`check_inplace_optimizer`: ``Optimizer.update_`` bit-equal to
    ``update`` + ``apply_updates`` for the three optimizers;
  * :func:`check_restart`: a loop restarted from its step-3 checkpoint
    gives the uninterrupted run's losses bit for bit.
"""

from __future__ import annotations

import tempfile

import torch

from ..configs.base import ModelConfig
from ..core.bspline import bspline_basis_fast
from ..data.lm_data import DataConfig, global_batch_at_step
from ..models.layers import _SplineMM
from ..models.model import loss_fn
from ..runtime.attention import use_attn_backend
from . import optimizer as O
from .checkpoint import flatten
from .loop import TrainLoop, batch_to_device
from .train_state import init_state, make_train_step

__all__ = ["SPLINE_TOL", "CARD_CPU_TOL", "GRAD_FLOOR", "EXCUSED_SHARE",
           "check_spline_mm", "check_card_vs_cpu", "check_inplace_optimizer",
           "check_restart"]

SPLINE_TOL = 1e-5
CARD_CPU_TOL = 1e-5
GRAD_FLOOR = 1e-7
EXCUSED_SHARE = 1e-3


def _tol_err(got, want, scale):
    tol = scale * want.abs().max().item() + 1e-6
    return (got - want).abs().max().item(), tol


def check_spline_mm(dev, f: int, o: int, tokens: int = 64, grid: int = 8,
                    order: int = 3, seed: int = 0) -> dict:
    """dx and dc of one (f -> o) half at ``tokens`` rows, custom backward
    against autograd of the plain forward; returns the errors and the
    tolerances."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = grid + order
    x = torch.randn((1, tokens, f), generator=gen, device=dev)
    c = torch.randn((f, nb, o), generator=gen, device=dev) * (0.1 / f ** 0.5)
    dy = torch.randn((1, tokens, o), generator=gen, device=dev)
    xs, cs = x.clone().requires_grad_(), c.clone().requires_grad_()
    got = torch.autograd.grad(_SplineMM.apply(xs, cs, -1.0, 1.0, grid, order),
                              (xs, cs), dy)
    xp, cp = x.clone().requires_grad_(), c.clone().requires_grad_()
    basis = bspline_basis_fast(torch.tanh(xp), -1.0, 1.0, grid, order)
    y = (basis.reshape(tokens, f * nb) @ cp.reshape(f * nb, o))[None]
    want = torch.autograd.grad(y, (xp, cp), dy)
    out = {"f": f, "o": o, "tokens": tokens, "tol_scale": SPLINE_TOL}
    for name, g, w in zip(("dx", "dc"), got, want):
        err, tol = _tol_err(g, w, SPLINE_TOL)
        if not err <= tol:
            raise AssertionError(f"_spline_mm {f}->{o} {name}: max err "
                                 f"{err:.3e} over {tol:.3e}")
        out[f"{name}_max_abs_err"], out[f"{name}_tol"] = err, tol
    return out


def check_card_vs_cpu(dev, cfg: ModelConfig, steps: int = 3,
                      seq_len: int = 16, global_batch: int = 4,
                      seed: int = 0) -> dict:
    """``steps`` train steps on the card and on the CPU from the same
    weights (drawn on the CPU) and the same batches."""
    gen = torch.Generator().manual_seed(seed)
    cpu = init_state(gen, cfg, device="cpu")
    card = O.tree_map(lambda t: t.to(dev, copy=True), cpu)
    step_fn = make_train_step(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    gmin = None
    out = {"losses": [], "grad_norms": []}
    for step in range(steps):
        batch = global_batch_at_step(dcfg, step)
        tb = batch_to_device(batch, torch.device("cpu"))
        leaves = [p.detach().requires_grad_()
                  for p in O.tree_leaves(cpu["params"])]
        with use_attn_backend("ref"):
            loss = loss_fn(O.tree_unflatten(cpu["params"], leaves), tb, cfg)
        ga = [g.abs() for g in torch.autograd.grad(loss, leaves)]
        gmin = ga if gmin is None else [torch.minimum(a, b)
                                        for a, b in zip(gmin, ga)]
        cpu, mc = step_fn(cpu, tb)
        card, md = step_fn(card, batch_to_device(batch, dev))
        for key, hist in (("loss", out["losses"]),
                          ("grad_norm", out["grad_norms"])):
            a, b = float(md[key]), float(mc[key])
            hist.append((a, b))
            if not abs(a - b) <= CARD_CPU_TOL:
                raise AssertionError(f"card vs CPU step {step} {key}: "
                                     f"{a!r} against {b!r}")
    worst = 0.0
    excused = total = 0
    by_order = O.tree_leaves(cpu["params"])
    for i, (a, b, gm) in enumerate(zip(O.tree_leaves(card["params"]),
                                       by_order, gmin)):
        diff = (a.cpu() - b).abs()
        noisy = gm < GRAD_FLOOR
        excused += int((noisy & (diff > CARD_CPU_TOL)).sum())
        total += diff.numel()
        w = diff[~noisy].max().item() if bool((~noisy).any()) else 0.0
        worst = max(worst, w)
        if not w <= CARD_CPU_TOL:
            raise AssertionError(f"card vs CPU param leaf {i}: {w:.3e}")
    if excused > EXCUSED_SHARE * total:
        raise AssertionError(f"card vs CPU: {excused} of {total} parameters "
                             f"differ where the gradient is below "
                             f"{GRAD_FLOOR}")
    out.update({"param_max_abs_err": worst, "excused": excused,
                "params": total, "tol": CARD_CPU_TOL})
    return out


def check_inplace_optimizer(dev, steps: int = 3, seed: int = 0) -> dict:
    """``update_`` against ``update`` + ``apply_updates`` on card tensors
    (f32 and bf16 parameters, f32 gradients); returns the leaves
    compared per optimizer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"embed": (64, 32), "blocks": {"w": (2, 32, 48), "b": (48,)},
              "scale": ()}
    out = {}
    for name, make in (("adamw", lambda: O.adamw(3e-4, weight_decay=0.1)),
                       ("adafactor", lambda: O.adafactor(3e-4)),
                       ("sgdm", lambda: O.sgdm(3e-4))):
        for pdtype in (torch.float32, torch.bfloat16):
            def draw(s):
                if isinstance(s, dict):
                    return {k: draw(v) for k, v in s.items()}
                return torch.randn(s, generator=gen, device=dev)

            params = O.tree_map(lambda t: t.to(pdtype), draw(shapes))
            opt = make()
            fp, fs = params, opt.init(params)
            ip = O.tree_map(torch.clone, params)
            is_ = opt.init(ip)
            ok = torch.ones((), dtype=torch.bool, device=dev)
            n = 0
            for _ in range(steps):
                g = draw(shapes)
                u, fs = opt.update(g, fs, fp)
                fp = O.apply_updates(fp, u)
                opt.update_(g, is_, ip, ok)
                for a, b in zip(O.tree_leaves((ip, is_)),
                                O.tree_leaves((fp, fs))):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(
                            f"{name} {pdtype}: in-place leaf differs")
                    n += 1
            out[f"{name}_{str(pdtype).split('.')[-1]}"] = n
    return out


def check_restart(dev, cfg: ModelConfig, seq_len: int = 16,
                  global_batch: int = 4) -> dict:
    """Five steps with a checkpoint at step 3, then a loop restarted from
    it for steps 3 and 4: losses bit-equal to the uninterrupted run's."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    quiet = lambda *_: None  # noqa: E731
    with tempfile.TemporaryDirectory() as d:
        first = TrainLoop(cfg, dcfg, d, ckpt_every=3, device=dev)
        h1 = first.run(5, log=quiet)
        del first
        second = TrainLoop(cfg, dcfg, d, ckpt_every=3, device=dev)
        if second.start_step != 3:
            raise AssertionError(f"restart at step {second.start_step}")
        dtypes = sorted({str(t.dtype) for t in flatten(second.state)})
        h2 = second.run(2, log=quiet)
    a = [m["loss"] for m in h1[3:]]
    b = [m["loss"] for m in h2]
    if a != b:
        raise AssertionError(f"restart losses {b} against {a}")
    return {"losses": [m["loss"] for m in h1], "restarted": b,
            "dtypes": dtypes}
