"""Speculative decoding: a cheap refit KAN drafter + one-pass batched verify.

Port of ``repro.serve.spec``.  A **draft model** built from the target's
own float weights by ``core.kan_layer.refit_layer_spec`` (a coarser spline
grid and/or order, optionally fewer ASP bits or another KAN backend; no
retraining) proposes ``k`` greedy tokens per active slot, and the target
scores all ``k+1`` positions in ONE batched forward
(``models.model.verify_step``) over its paged KV cache.  The longest draft
prefix matching the target's own greedy argmax is accepted, so every
emitted token is an argmax of the target's verify rows; the drafter only
decides how MANY rows a round consumes.

Layering: :class:`DraftSpec` describes the drafter's deployment point;
:class:`DraftModel` owns the refit + quantized params, a contiguous
per-slot KV cache and the lockstep batched propose loop.  The engine
(``serve.engine``) owns the verify pass and the KV rollback
(``kvpool.truncate``); the scheduler owns the propose -> verify ->
accept/emit round and the accept-rate metrics.

KV bookkeeping invariant (the engine's): ``pos[slot]`` counts the drafter
KV positions known to hold the TRUE token stream; rows written with
rejected drafts lie behind ``pos`` only until :meth:`DraftModel.truncate`
rolls it back over them, and the next propose re-writes them before any
query attends them.

PyTorch runs eagerly, so the reference's jit trace counters have no
counterpart: :meth:`DraftModel.describe` reports under the same keys the
drafter's distinct prefill buckets (``prefill_traces``) and decode calls
(``decode_traces``), as the engine's ``compile_stats`` does, beside its
call counts and its plan-cache entries.

``DraftModel(mesh=)`` follows the engine's mesh (``engine.SlotShards``):
its params are placed as the target's, its cache holds this rank's slots,
a prefill runs on the owner's ranks, and each propose step decodes the
local slots and all-gathers their next tokens over "data".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import runtime
from ..configs.base import ModelConfig
from ..models import model as M
from ..obs.trace import profile_scope
from .engine import SlotShards, splice_slot, step_scope

__all__ = ["DraftSpec", "DraftModel", "refit_kan_ffn_params_tree"]


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """Deployment point of the drafter, relative to the target config.

    ``None`` fields derive from the target: ``grid`` halves the target's
    spline grid (floored at 2), ``order`` and ``n_bits`` inherit,
    ``backend`` inherits the engine's KAN backend.  :meth:`parse` reads
    the ``--draft-spec`` form ``"grid=4,order=2,bits=6,backend=ref"`` (any
    subset of keys).
    """

    grid: int | None = None
    order: int | None = None
    n_bits: int | None = None
    backend: str | None = None

    _KEYS = {"grid": "grid", "order": "order", "bits": "n_bits",
             "n_bits": "n_bits", "backend": "backend"}

    @classmethod
    def parse(cls, s: str | None) -> "DraftSpec":
        if not s:
            return cls()
        kw = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad --draft-spec entry {part!r} "
                                 f"(want key=value)")
            key, val = part.split("=", 1)
            field = cls._KEYS.get(key.strip())
            if field is None:
                raise ValueError(f"unknown --draft-spec key {key!r} "
                                 f"(known: grid, order, bits, backend)")
            kw[field] = val.strip() if field == "backend" else int(val)
        return cls(**kw)

    def resolve(self, cfg: ModelConfig) -> tuple:
        """(grid, order, n_bits) for the drafter given the target config."""
        grid = self.grid if self.grid is not None else max(2, cfg.kan_grid // 2)
        order = self.order if self.order is not None else cfg.kan_order
        n_bits = self.n_bits if self.n_bits is not None else cfg.kan_n_bits
        if grid < 1 or order < 1 or n_bits < 1:
            raise ValueError(f"draft spec fields must be >= 1, got "
                             f"grid={grid} order={order} bits={n_bits}")
        return grid, order, n_bits


def refit_kan_ffn_params_tree(params: dict, cfg: ModelConfig,
                              draft_cfg: ModelConfig) -> dict:
    """Refit every KAN-FFN block of a FLOAT param tree (decoder and encoder)
    onto the drafter's (G, K) basis (``refit_layer_spec``).  Edge counts and the hidden width
    are unchanged (``draft_cfg`` must pin ``kan_d_hidden``); only the
    per-edge basis shrinks from G+K to G'+K' columns (f32, as the
    reference's).  Every other leaf is the target's own tensor."""
    from ..core.kan_layer import refit_layer_spec
    from ..models.layers import kan_ffn_spec
    from ..models.transformer import stack_trees, tree_layer

    old_spec, new_spec = kan_ffn_spec(cfg), kan_ffn_spec(draft_cfg)

    def refit_ffn(ffn: dict) -> dict:
        l1 = refit_layer_spec({"c": ffn["c1"], "w_b": ffn["wb1"]},
                              old_spec, new_spec)
        l2 = refit_layer_spec({"c": ffn["c2"], "w_b": ffn["wb2"]},
                              old_spec, new_spec)
        return {"c1": l1["c"], "wb1": l1["w_b"],
                "c2": l2["c"], "wb2": l2["w_b"]}

    def refit_group(gp: dict) -> dict:
        out = dict(gp)
        for k, v in gp.items():
            if not k.endswith("_ffn"):
                continue
            if "c1" not in v:
                raise ValueError("the drafter refits from FLOAT KAN-FFN "
                                 "weights; this block is already quantized")
            out[k] = stack_trees([refit_ffn(tree_layer(v, r))
                                  for r in range(v["c1"].shape[0])])
        return out

    p = dict(params)
    for stack_key in ("decoder", "encoder"):
        if stack_key in p:
            p[stack_key] = [refit_group(g) for g in p[stack_key]]
    return p


class DraftModel:
    """The drafter: refit + quantized params and a small per-slot KV cache.

    Built from the target's FLOAT params (the engine keeps them before its
    own quantization): every KAN-FFN block is refit onto the reduced
    (G, K) basis, ASP-quantized at the drafter's bit width and deployed
    once; attention, norms and embeddings are the target's tensors.  Its
    reduced specs key plan-cache entries of their own, so drafter and
    target never rebuild each other's plans.

    The KV state is a plain contiguous ``(slots, max_len)`` cache;
    ``pos[slot]`` is the true-token watermark of the module docstring.
    """

    def __init__(self, float_params, cfg: ModelConfig, spec: DraftSpec,
                 slots: int, max_len: int, kan_backend: str | None = None,
                 attn_backend: str | None = None, mesh=None):
        from ..core.kan_ffn_deploy import quantize_kan_ffn_params_tree
        from ..models.layers import kan_ffn_hidden

        if cfg.ffn_kind != "kan":
            raise ValueError("DraftModel requires a KAN-FFN target config")
        grid, order, n_bits = spec.resolve(cfg)
        # kan_d_hidden is pinned: the default hidden-width rule divides by
        # G+K, which the drafter changes; only the per-edge basis shrinks
        self.cfg = dataclasses.replace(
            cfg, kan_grid=grid, kan_order=order, kan_n_bits=n_bits,
            kan_layer_bits=(),  # the drafter is uniform
            kan_d_hidden=kan_ffn_hidden(cfg),
        )
        self.spec = spec
        self.kan_backend = (spec.backend if spec.backend is not None
                            else kan_backend)
        runtime.resolve_backend(self.kan_backend)  # a typo fails at build
        self.attn_backend = runtime.resolve_attn_backend(attn_backend)
        self.slots = slots
        self.max_len = max_len
        self.mesh = mesh
        tp = None
        with torch.no_grad():
            params = refit_kan_ffn_params_tree(float_params, cfg, self.cfg)
            self.params = quantize_kan_ffn_params_tree(params, self.cfg)
            if mesh is not None:
                self.params, tp = M.place_params(self.params, self.cfg, mesh)
        del params
        self.shards = SlotShards(mesh, slots, tp)
        self.device = M.params_device(self.params)
        with self.shards.scope():
            self.cache = M.init_cache(self.params, self.cfg,
                                      self.shards.local, max_len)
        self.pos = np.zeros(slots, np.int32)
        self._prefill_buckets_seen: set = set()
        self.prefill_calls = 0
        self.decode_calls = 0

    def _scope(self, split_rows: bool = False):
        return step_scope(self.kan_backend, self.attn_backend, self.shards,
                          split_rows)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    # -- per-slot lifecycle ------------------------------------------------

    def prefill_slot(self, slot: int, req) -> None:
        """Prefill ``req``'s prompt into the drafter's cache row ``slot``
        (B=1, right-padded to its power-of-two bucket; KV past the prompt
        is zeroed in the splice)."""
        plen = len(req.prompt)
        prompt = list(req.prompt)
        lb = runtime.bucket_batch(plen)
        if plen < lb <= self.max_len - 1:
            prompt = prompt + [0] * (lb - plen)
        self._prefill_buckets_seen.add(len(prompt))
        self.prefill_calls += 1
        if self.shards.owns(slot):
            with self._scope(), profile_scope("serve.draft_prefill"):
                _, cache1 = M.prefill(
                    self.params, {"tokens": self._tensor([prompt])},
                    self.cfg, max_len=self.max_len, last_index=[plen - 1])
                splice_slot(self.cache, cache1, slot - self.shards.lo, plen,
                            zero_tail=True)
        self.pos[slot] = plen

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll the slot's true-token watermark back to ``new_len`` after a
        verify round rejected draft positions."""
        self.pos[slot] = min(int(self.pos[slot]), int(new_len))

    def release(self, slot: int) -> None:
        self.pos[slot] = 0

    # -- propose -----------------------------------------------------------

    def propose(self, pend: dict, k: int) -> dict:
        """Draft ``k`` greedy tokens for every slot in ``pend``.

        ``pend[slot]`` is that slot's catch-up list: the true tokens at
        drafter positions ``pos[slot] .. engine_pos`` inclusive (one at
        steady state, two after a fully accepted round).  All slots advance
        in LOCKSTEP through one batched single-token decode per step: slot
        ``i`` feeds ``pend[i]`` first, then chains its own argmax, for
        ``max(len(pend)) - 1 + k`` steps; slots not in ``pend`` ride along
        feeding token 0 (dead rows).

        Returns ``{slot: [k draft token ids]}``.  Afterwards ``pos[slot]``
        assumes every draft verifies (``engine_pos + k``); the caller
        follows up with :meth:`truncate` to the accepted length.
        """
        if k < 1:
            raise ValueError(f"propose needs k >= 1, got {k}")
        if not pend:
            return {}
        queues = {i: list(toks) for i, toks in pend.items()}
        for i, q in queues.items():
            if not q:
                raise ValueError(f"slot {i}: empty pend (drafter ahead of "
                                 f"engine?)")
        nsteps = max(len(q) for q in queues.values()) - 1 + k
        drafts = {i: [] for i in queues}
        chain = np.zeros(self.slots, np.int32)   # last argmax per slot
        pos = self.pos.copy()
        with self._scope(split_rows=True), profile_scope("serve.draft",
                                                         steps=nsteps):
            for step in range(nsteps):
                feed = np.zeros(self.slots, np.int32)
                for i, q in queues.items():
                    feed[i] = q[step] if step < len(q) else chain[i]
                self.decode_calls += 1
                rows = self.shards.rows
                logits, self.cache = M.decode_step(
                    self.params, self.cache, self._tensor(rows(feed)),
                    self._tensor(rows(pos)), self.cfg)
                # the next tokens, not the logits, cross "data"
                nxt = self.shards.gather(logits.argmax(dim=-1)).cpu().numpy()
                pos += 1
                for i, q in queues.items():
                    chain[i] = nxt[i]
                    if step >= len(q) - 1 and len(drafts[i]) < k:
                        drafts[i].append(int(nxt[i]))
        for i, q in queues.items():
            # rows written through engine_pos + k - 1; next valid write at:
            self.pos[i] = int(self.pos[i]) + len(q) - 1 + k
        return drafts

    # -- observability -----------------------------------------------------

    def plan_entries(self) -> int:
        """Plan-cache entries keyed by the drafter's own specs."""
        from ..models.layers import kan_ffn_specs

        specs = tuple(kan_ffn_specs(self.cfg))
        return sum(1 for key in list(runtime.PLAN_CACHE._entries)
                   if tuple(key.specs) == specs)

    def describe(self) -> dict:
        from ..core.kan_layer import KANSpec, param_count
        from ..models.layers import kan_ffn_hidden

        c = self.cfg
        dims = (c.d_model, kan_ffn_hidden(c), c.d_model)
        return {
            "kan_grid": c.kan_grid,
            "kan_order": c.kan_order,
            "kan_n_bits": c.kan_n_bits,
            "kan_backend": self.kan_backend,
            "attn_backend": self.attn_backend,
            "ffn_params_per_block": param_count(KANSpec(
                dims=dims, grid_size=c.kan_grid, order=c.kan_order)),
            "decode_traces": self.decode_calls,
            "prefill_traces": len(self._prefill_buckets_seen),
            "prefill_calls": self.prefill_calls,
            "plan_entries": self.plan_entries(),
        }
