"""What a larger mesh runs, held on one card.

Shared by ``chip_smoke.py`` (phases 13 and 14) and
``tests/test_torch_gpu.py``.  ``dist.comm`` skips every collective over a
group of one rank, so a 1x1 mesh issues none on the serving path;
:func:`check_collectives` calls ``all_gather_into_tensor``, ``all_reduce``
and ``broadcast`` itself on each of the mesh's groups, with the int32
boundary codes and the f32 rows the runtime's shard body gathers.  Every
rank draws the same tensors (one seed), so the gather is ``n`` copies, the
sum ``n`` times the tensor.

A model shard's slab of a layer on the training path: :func:`check_moe_
slabs` computes each rank's expert hidden-column slab of a MoE layer in
turn and adds the partial expert outputs by hand (what the all-reduce over
"model" adds), :func:`check_kan_ffn_slabs` does so for the float KAN-FFN,
forward and backward, :func:`check_remat_under_layout` holds remat's
recompute to the forward's tensor-parallel layout, and
:func:`check_autograd_collectives` runs the gradient-carrying collectives
of ``dist.comm`` through autograd on a mesh's groups.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["check_collectives", "check_moe_slabs", "check_kan_ffn_slabs",
           "check_remat_under_layout", "check_autograd_collectives",
           "bf16_ulp"]


def bf16_ulp(x: float) -> float:
    """The bf16 grid step at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _slab(t: torch.Tensor, dim: int, r: int, m: int) -> torch.Tensor:
    w = t.shape[dim] // m
    return t.narrow(dim, r * w, w)


# the model axis the slab checks cut at, and the seed of their weights
MODEL = 2
SEED = 0


def check_moe_slabs(dev, cfg, tokens: int) -> dict:
    """One MoE layer of ``cfg`` (random, from ``SEED``) over ``tokens``
    tokens, whole and as ``MODEL`` ranks' slabs of the experts' hidden dim
    (wi / wg columns, wo rows) whose partial expert outputs are added in
    rank order, then gated and combined as ``models.layers.moe`` does
    after its all-reduce.  Returns the max difference and the limit, 4 bf16
    ulps of max|out| (phase 10's MoE unit); raises past it."""
    from ..models import layers as L

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_moe(gen, cfg, device=dev)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    x = x.to(L.torch_dtype(cfg))
    with torch.no_grad():
        whole = L.moe(p, x, cfg)
        xe, dest, gates = L.moe_dispatch(p, x, cfg)
        ye = None
        for r in range(MODEL):
            pr = {"wi": _slab(p["wi"], 2, r, MODEL),
                  "wg": _slab(p["wg"], 2, r, MODEL),
                  "wo": _slab(p["wo"], 1, r, MODEL)}
            part = L.moe_experts(pr, xe)
            ye = part if ye is None else ye + part
        out = L.moe_gather(ye, dest, gates, x.shape, x.dtype)
    ref = float(whole.float().abs().max())
    err = float((out.float() - whole.float()).abs().max())
    tol = 4 * bf16_ulp(ref)
    if not err <= tol:
        raise AssertionError(f"MoE slabs at model {MODEL}: max |diff| {err} "
                             f"> {tol} (4 bf16 ulps of {ref})")
    return {"tokens": tokens, "model": MODEL, "max_abs_err": err,
            "tol": tol, "max_abs_out": ref}


def check_kan_ffn_slabs(dev, d: int, h: int, tokens: int) -> dict:
    """One float KAN-FFN block of ``qwen2.5-14b``'s ``kan_variant()`` at
    ``d -> h -> d`` (f32, random from ``SEED``) forward and backward, whole
    and as ``MODEL`` ranks' slabs of its hidden dim: the summed outputs and
    input gradient against the whole block's, and each slab's ``c1`` /
    ``wb1`` / ``c2`` / ``wb2`` gradient against that slab of the whole
    block's, within 1e-5 x max|whole|."""
    from ..configs.registry import get_config
    from ..models import layers as L

    cfg = dataclasses.replace(get_config("qwen2.5-14b").kan_variant(),
                              d_model=d, kan_d_hidden=h, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_ffn(gen, cfg, device=dev)
    x = torch.randn((1, tokens, d), generator=gen, device=dev)
    dy = torch.randn((1, tokens, d), generator=gen, device=dev)
    cut = {"c1": 2, "wb1": 1, "c2": 0, "wb2": 0}

    def run(params):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        xin = x.detach().requires_grad_()
        y = L.ffn(leaves, xin, cfg)
        grads = torch.autograd.grad(y, [xin] + list(leaves.values()), dy)
        return y.detach(), grads[0], dict(zip(leaves, grads[1:]))

    y, dx, g = run(p)
    ys = dxs = None
    errs = {"y": 0.0, "dx": 0.0}
    for r in range(MODEL):
        yr, dxr, gr = run({k: _slab(v, cut[k], r, MODEL).contiguous()
                           for k, v in p.items()})
        ys = yr if ys is None else ys + yr
        dxs = dxr if dxs is None else dxs + dxr
        for k, gk in gr.items():
            want = _slab(g[k], cut[k], r, MODEL)
            e = float((gk - want).abs().max()) / max(
                float(g[k].abs().max()), 1e-30)
            errs[k] = max(errs.get(k, 0.0), e)
    errs["y"] = float((ys - y).abs().max()) / float(y.abs().max())
    errs["dx"] = float((dxs - dx).abs().max()) / float(dx.abs().max())
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    if bad:
        raise AssertionError(f"KAN-FFN slabs {d}->{h}->{d} at model "
                             f"{MODEL}: relative errors {bad} > 1e-5")
    return {"d": d, "h": h, "tokens": tokens, "model": MODEL,
            "rel_err": errs, "tol": 1e-5}


class _ModelRank:
    """A (1, ``size``) mesh seen from model rank ``rank``: as much of one
    as ``models.model.place_params`` reads, every group ``group``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, size: int, rank: int, group):
        self.shape = (1, size)
        self._rank, self._group = rank, group

    def get_local_rank(self, name):
        return self._rank if name == "model" else 0

    def get_group(self, name):
        return self._group

    def __getitem__(self, name):
        return self


def check_remat_under_layout(mesh, dev) -> dict:
    """Remat recomputes each block inside the backward pass, on the
    autograd engine's device thread for a CUDA tensor, where the caller's
    ``dist.comm.use_tp`` scope is not bound; ``models.transformer`` pins
    the layout read at the forward.  Held here: the smoke ``qwen2.5-14b``
    ``kan_variant()`` (f32, 4 query / 2 KV heads), its layers cut to each
    rank's slab (``place_params``) at model 2 (KV heads cut) and model 4
    (one query head a rank, the KV heads whole: each rank attends with the
    one its query head reads), the vocabulary whole; its layout bound over
    the mesh's "model" group for the forward only, the backward run outside
    that scope (as the device thread runs it): ``loss_fn``'s loss and
    gradients with remat on equal those with it off, bit for bit.  A
    recompute that lost the layout would attend with both KV heads at
    model 4.  Over a group of one rank the reductions are skipped, so each
    rank's slab computes its partial sums."""
    from ..configs import smoke_config
    from ..models.model import init_params, loss_fn, place_params
    from ..runtime.attention import use_attn_backend
    from ..train.optimizer import tree_leaves, tree_unflatten
    from . import comm

    cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    group = mesh.get_group("model")
    layouts = []
    for size in (2, 4):
        for r in range(size):
            placed, tp = place_params(params, cfg, _ModelRank(size, r, group))
            # the vocabulary stays whole: its logits' gather is skipped
            # over one rank, and the blocks are what remat recomputes
            placed = {**placed, "embed": params["embed"],
                      "lm_head": params["lm_head"]}
            tp = dataclasses.replace(tp, vocab=False)
            runs = []
            for remat in (False, True):
                leaves = [p.detach().requires_grad_()
                          for p in tree_leaves(placed)]
                with use_attn_backend("ref"), comm.use_tp(tp):
                    loss = loss_fn(tree_unflatten(placed, leaves), batch,
                                   dataclasses.replace(cfg, remat=remat))
                runs.append([loss.detach(),
                             *torch.autograd.grad(loss, leaves)])
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"model {size}, rank {r}: remat's "
                                     "gradients differ")
            layouts.append((size, r, tp.heads, tp.kv))
    return {"layouts": layouts}


def check_autograd_collectives(mesh, dev) -> dict:
    """``dist.comm``'s f / g / gather autograd functions (applied directly,
    so their autograd path runs even where a group of one rank skips the
    collective) on each of the mesh's groups: forward values and gradients
    exact for its size."""
    from . import comm

    out = {}
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        n, r = comm.group_size(group), comm.group_rank(group)
        x = torch.arange(12.0, device=dev).reshape(3, 4).requires_grad_()
        y = comm._Copy.apply(x, group)
        (gx,) = torch.autograd.grad((y * 2).sum(), x)
        z = comm._Reduce.apply(x, group)
        (gz,) = torch.autograd.grad((z * 3).sum(), x)
        w = comm._Gather.apply(x, group, 1)
        (gw,) = torch.autograd.grad((w * w).sum(), x)
        ok = (torch.equal(y, x) and torch.equal(gx, torch.full_like(x, 2 * n))
              and torch.equal(z, n * x) and torch.equal(gz, torch.full_like(
                  x, 3.0)) and torch.equal(w, x.repeat(1, n))
              and torch.equal(gw, 2 * x))
        if not ok:
            raise AssertionError(f"autograd collectives over {axis} "
                                 f"(size {n}, rank {r}): not exact")
        out[axis] = n
    return {"groups": out}


def check_collectives(mesh, dev, rows: int = 1024, cols: int = 640,
                      seed: int = 0) -> dict:
    """Each collective on each mesh group, int32 and f32; returns
    ``{"groups": {axis: size}, "calls"}``, raises on a wrong result."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes, calls = {}, 0
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        n = dist.get_world_size(group)
        sizes[axis] = n
        for dtype in (torch.int32, torch.float32):
            t = (torch.randint(0, 256, (rows, cols), generator=gen,
                               device=dev, dtype=dtype)
                 if dtype == torch.int32 else
                 torch.randn(rows, cols, generator=gen, device=dev))
            out = torch.empty((n * rows, cols), dtype=dtype, device=dev)
            dist.all_gather_into_tensor(out, t, group=group)
            red = t.clone()
            dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
            got = torch.empty_like(t) if dist.get_rank(group) else t.clone()
            dist.broadcast(got, src=dist.get_global_rank(group, 0),
                           group=group)
            calls += 3
            if not torch.equal(out, t.repeat(n, 1)):
                raise AssertionError(f"all_gather_into_tensor over {axis} "
                                     f"({dtype}): not {n} copies")
            if not torch.equal(red, t * n):
                raise AssertionError(f"all_reduce over {axis} ({dtype}): "
                                     f"not {n} x the tensor")
            if not torch.equal(got, t):
                raise AssertionError(f"broadcast over {axis} ({dtype}): "
                                     "not rank 0's tensor")
    return {"groups": sizes, "calls": calls}
