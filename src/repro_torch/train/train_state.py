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

On a mesh (``microbatch_spec`` bound to one by ``dist.sharding.
to_shardings``) the step is SPMD, one process per device: the state holds
this rank's slabs as :func:`state_pspecs` lays them out (parameters cut on
"model" as ``models.model.place_params`` cuts them, AdamW / SGD moments
also on "data": ZeRO-1), and the batch holds this rank's rows
(:func:`local_rows`).  It computes the reference's function within the
order of its sums; on a 1x1 mesh, bit for bit.
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..dist import comm
from ..dist.sharding import (
    PSpec,
    axis_size,
    batch_pspec,
    map_with_path,
    opt_state_pspecs,
    param_pspecs,
    shard_param,
    shard_tensor,
    to_shardings,
)
from ..models.model import init_params, loss_fn, param_layout
from ..obs.trace import profile_scope
from ..runtime.attention import use_attn_backend
from ..runtime.meshexec import mesh_index
from .optimizer import (
    LeafShard,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm_,
    sgdm,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["make_optimizer", "init_state", "meta_state", "state_pspecs",
           "microbatch_pspec", "local_rows", "make_train_step"]


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg.learning_rate, weight_decay=0.1)
    if cfg.optimizer == "adafactor":
        return adafactor(cfg.learning_rate)
    if cfg.optimizer == "sgdm":
        return sgdm(cfg.learning_rate)
    raise ValueError(cfg.optimizer)


def init_state(gen: torch.Generator, cfg: ModelConfig, *,
               device=None, mesh=None) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``, the
    card unless ``device="cpu"``), the optimizer's zero state and the
    counters.

    With ``mesh``, every leaf is this rank's slab as :func:`state_pspecs`
    lays it out, made at that size: each parameter is cut as soon as its
    layer is drawn (``init_params(place=)``, the same draws), and the
    optimizer's state, zeros in every optimizer, is made at its slab
    shapes.  The whole state is never on the device."""
    dev = resolve_device(device)
    if mesh is None:
        params = init_params(gen, cfg, device=dev)
        opt = make_optimizer(cfg).init(params)
    else:
        params = init_params(gen, cfg, device=dev,
                             place=lambda path, leaf: shard_param(path, leaf,
                                                                  mesh))
        meta = meta_state(cfg)
        opt_sh = to_shardings(state_pspecs(meta, mesh)["opt"], mesh)
        opt = tree_map(lambda t, sh: torch.zeros(
            shard_tensor(t, sh).shape, dtype=t.dtype, device=dev),
            meta["opt"], opt_sh)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return {
        "params": params,
        "opt": opt,
        "step": zero(),
        "good_steps": zero(),   # NaN-guard accounting
        "skipped_steps": zero(),
    }


def meta_state(cfg: ModelConfig) -> dict:
    """The whole state's shapes and dtypes, on the meta device (no
    memory)."""
    return init_state(None, cfg, device="meta")


def state_pspecs(state, mesh) -> dict:
    """The state's specs on ``mesh``, as ``repro.launch.dryrun`` builds them:
    ``param_pspecs`` without fsdp, ``opt_state_pspecs(zero1=True)`` and the
    three step counters replicated.  ``state`` holds the whole shapes (an
    unsharded state, or :func:`meta_state`)."""
    return {"params": param_pspecs(state["params"], mesh),
            "opt": opt_state_pspecs(state["opt"], state["params"], mesh,
                                    zero1=True),
            "step": PSpec(), "good_steps": PSpec(), "skipped_steps": PSpec()}


def microbatch_pspec(mesh, global_batch: int, microbatch: int) -> PSpec:
    """The (microbatch, rows, ...) layout of a batch on ``mesh``: each
    microbatch's rows on "data" by ``batch_pspec``, which replicates them
    where "data" does not divide them (``repro.launch.dryrun``'s)."""
    return PSpec(None, *batch_pspec(mesh, global_batch // max(1, microbatch)))


def _rows_on_data(spec) -> bool:
    return spec.spec.on(1, "data") and axis_size(spec.mesh, "data") > 1


def local_rows(batch: dict, microbatch: int, microbatch_spec) -> dict:
    """This rank's rows of a whole batch (arrays or tensors, rows first)
    under ``microbatch_spec``: each of the ``microbatch`` microbatches'
    slab of rows on "data", microbatch-major; the whole batch where the
    rows are not on "data"."""
    if microbatch_spec is None or not _rows_on_data(microbatch_spec):
        return batch
    mb = max(1, microbatch)
    d = axis_size(microbatch_spec.mesh, "data")
    r = mesh_index(microbatch_spec.mesh, "data")
    out = {}
    for k, v in batch.items():
        w = v.shape[0] // mb // d
        x = v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
        out[k] = x[:, r * w:(r + 1) * w].reshape((mb * w,)
                                                 + tuple(v.shape[1:]))
    return out


def _flat(tree) -> list:
    """(path, spec) of every leaf of a spec tree, in ``tree_leaves``
    order."""
    out = []
    map_with_path(lambda path, spec: out.append((path, spec)), tree)
    return out


def _leaf_shards(cfg: ModelConfig, mesh) -> list:
    """One :class:`LeafShard` per parameter (in ``tree_leaves`` order): the
    "model" dim of its spec, and the "data" dim of its moments' spec where
    the optimizer's moment trees mirror the parameters."""
    specs = state_pspecs(meta_state(cfg), mesh)
    params = _flat(specs["params"])
    paths = [path for path, _ in params]
    moments = next((_flat(e) for e in specs["opt"].values()
                    if [path for path, _ in _flat(e)] == paths),
                   [(path, PSpec()) for path in paths])
    mg = mesh.get_group("model") if "model" in mesh.mesh_dim_names else None
    dg = mesh.get_group("data") if "data" in mesh.mesh_dim_names else None
    return [LeafShard(p.dim_on("model"), mg, m.dim_on("data"), dg)
            for (_, p), (_, m) in zip(params, moments)]


def make_train_step(cfg: ModelConfig, grad_clip: float = 1.0,
                    microbatch_spec=None):
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

    ``microbatch_spec``: None, or the (microbatch, rows, ...) layout
    (:func:`microbatch_pspec`) bound to a mesh by ``dist.sharding.
    to_shardings``, which makes the step a sharded one (see the module
    note).  There each rank runs its rows of every microbatch (all of them
    where the rows are not on "data") under the parameters' tensor-parallel
    layout; its local loss is weighted by its share of the rows (with a
    ``loss_mask``, divided by the whole batch's mask count); loss and f32
    gradients are summed over "data" once per step, after accumulation
    (not where every rank ran every row); the clip sums the squares of cut
    gradients over "model"; ``ok`` is read off the summed loss and norm,
    so every rank takes or skips the same steps; the optimizer runs ZeRO-1
    (``Optimizer.update_`` with :class:`LeafShard`s).

    Attention runs on the ``"ref"`` backend: kernel B2 has no backward
    (nor has the reference's Pallas kernel), so the step pins the one
    differentiable backend of both packages.  The forward, backward and
    optimizer parts run in ``train.forward`` / ``train.backward`` /
    ``train.optimizer`` profiler ranges while ``obs`` annotations are on.
    """
    opt = make_optimizer(cfg)
    mesh = getattr(microbatch_spec, "mesh", None)
    if microbatch_spec is not None and mesh is None:
        raise TypeError("microbatch_spec must be bound to its mesh "
                        "(dist.sharding.to_shardings)")
    tp, shards, cut, split, dgroup = comm.TPLayout(), None, None, False, None
    if mesh is not None:
        tp = param_layout(cfg, mesh)
        shards = _leaf_shards(cfg, mesh)
        cut = [sh.model_dim is not None for sh in shards]
        split = _rows_on_data(microbatch_spec)
        dgroup = mesh.get_group("data") if split else None
    share = None if not split else 1.0 / axis_size(mesh, "data")

    def value_and_grad(params, leaves, batch):
        count = None
        if split and "loss_mask" in batch:
            count = comm.all_reduce_sum(batch["loss_mask"].sum(), dgroup)
        with profile_scope("train.forward"):
            loss = loss_fn(params, batch, cfg, mask_count=count)
            if share is not None and count is None:
                loss = loss * share
        with profile_scope("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        mb = max(1, cfg.microbatch)
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state["params"])]
        params = tree_unflatten(state["params"], leaves)
        with contextlib.ExitStack() as scope:
            scope.enter_context(use_attn_backend("ref"))
            if mesh is not None:
                scope.enter_context(comm.use_tp(tp))
                scope.enter_context(comm.use_row_split(dgroup))
            if mb > 1:
                split_b = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                           for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves]
                for i in range(mb):
                    mloss, mgrads = value_and_grad(
                        params, leaves, {k: v[i] for k, v in split_b.items()})
                    loss = loss + mloss
                    for acc, g in zip(grads, mgrads):
                        acc.add_(g)
                    del mgrads
                loss = loss / mb
                for g in grads:
                    g.div_(mb)
            else:
                loss, grads = value_and_grad(params, leaves, batch)
        del params, leaves

        with torch.no_grad(), profile_scope("train.optimizer"):
            if split:
                # the ranks' rows are parts of one batch: sum the weighted
                # losses and the f32 gradients over "data", once
                loss = comm.all_reduce_sum(loss, dgroup)
                for i, g in enumerate(grads):
                    grads[i] = comm.all_reduce_sum(g.to(torch.float32),
                                                   dgroup)
            gnorm = clip_by_global_norm_(grads, grad_clip, cut, tp.group)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            opt.update_(tree_unflatten(state["params"], grads), state["opt"],
                        state["params"], ok,
                        None if shards is None
                        else tree_unflatten(state["params"], shards))
            state["step"] += 1
            state["good_steps"] += ok.to(torch.int32)
            state["skipped_steps"] += (~ok).to(torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "ok": ok}

    return train_step
