"""Batched serving engine: slot-based continuous batching.

Port of ``repro.serve.engine``.  A fixed pool of B decode slots; each slot
holds one active request.  New requests are prefilled into a free slot,
decode advances ALL active slots with one step, and finished slots are
refilled from the queue.  The engine owns the state (params, slot pool, KV
cache); the loop lives in :mod:`.scheduler`, and ``run()`` runs it to
completion synchronously.

Prefill pads prompts to power-of-two length buckets (pure global-attention
decoders only): the padding sits at the END of the prompt, causal
attention keeps real positions from seeing it, it is zeroed out of the
cache at splice time, and the first-token logits are read at the true last
token.  PyTorch runs eagerly, so there are no traces:
``compile_stats()["prefill_traces"]`` counts the distinct prefill buckets,
``"verify_traces"`` the distinct verify widths and ``"decode_traces"`` the
decode calls, under the reference's keys.

``kan_deploy=True`` quantizes every KAN-FFN block once at engine build
(``core.kan_ffn_deploy.quantize_kan_ffn_params_tree``, deployed bundles
included) and runs it through the ``repro_torch.runtime`` executor
(``kan_backend`` > ``REPRO_KAN_BACKEND`` > "fused": kernel B1).  Attention
resolves the same way (``attn_backend`` > ``REPRO_ATTN_BACKEND`` >
"flash": kernel B2), once at build, and every step runs under that scope.

``kv_block_size=`` replaces the per-slot contiguous KV slab with a PAGED
pool (:mod:`.kvpool`): fixed-size blocks from a free-list allocator, a
block table per slot, and a hash-keyed prefix cache that splices cached
prompt blocks in copy-free.  ``prefill_chunk=`` stages long prompts one
chunk per scheduling round.  Greedy streams equal the contiguous path's.

``spec_decode=k`` (with ``kan_deploy`` and the paged cache) adds a drafter
(:class:`.spec.DraftModel`, refit from the FLOAT params the engine was
given, before its own quantization) and the batched verify pass
(:meth:`ServeEngine.verify_active`) the scheduler's speculative rounds
drive; ``draft_spec`` sets the drafter's deployment point.  Every prefill,
decode and verify call runs under ``obs.profile_scope`` (``serve.prefill``,
``serve.prefill_chunk``, ``serve.decode_step``, ``serve.verify``): a
``torch.profiler`` range while annotations are on, nothing otherwise.
Every prefill call counts its prompt's real tokens and the padding that
reaches its bucket (``PROMPT_TOKENS``, the series
``serve.prompt_tokens{kind=real|pad}``).

``mesh=`` (a ``DeviceMesh`` with axes ("data", "model"), e.g.
``launch.mesh.make_local_mesh``) serves SPMD, one process per device, each
running the same engine and scheduler on the same request stream
(:class:`SlotShards`):

  * params follow ``models.model.place_params``: query and KV heads,
    dense FFN and MoE expert hidden columns and the vocabulary on "model"
    (kernel B2 runs per rank on its ``Hkv / model`` heads, or, where the
    model size divides the query heads alone, on the KV heads its query
    heads read, and the caches hold those), and the deployed KAN-FFN
    bundles on the runtime's mesh runner with their columns on "model"
    (kernel B1 per shard);
  * slots split over "data" when ``data`` divides them: data rank d owns
    ``slots / data`` slots and the cache rows for them (contiguous), or its
    share of the paged pool (``ServeEngine.pools``, one ``KVBlockPool``
    per data rank; ``num_blocks`` is rounded up to a multiple of
    ``data``).  Otherwise every rank serves every slot;
  * decode (and verify) runs on the local slots, and the logits are
    all-gathered over "data", so every rank's scheduler sees every stream;
  * a B=1 prefill runs on the ranks of the slot's owner, and its
    first-token logits are broadcast over "data".

Host state (positions, block tables, pool bookkeeping, the scheduler)
stays identical on every rank, so every rank takes the same decisions; a
request ``deadline_s`` or future ``arrival_s`` is decided on rank 0's
clock, which the scheduler broadcasts (``scheduler.MeshClock``).  A 1x1
mesh serves the same tokens as no mesh.

An audio or vlm model is refused: its prefill needs stub embeddings beside
the tokens, which the engine does not carry (the reference's engine raises
``KeyError`` there).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import runtime
from ..configs.base import ModelConfig
from ..device import resolve_device
from ..dist import comm
from ..models import model as M
from ..obs import REGISTRY as _OBS_REGISTRY
from ..obs.trace import profile_scope
from ..runtime.meshexec import mesh_axis_sizes, mesh_index
from .kvpool import KVBlockPool, merged_stats

__all__ = ["Request", "ServeEngine", "SlotShards",
           "prefill_bucketing_supported", "paged_kv_supported"]


# Prompt tokens of every prefill call (whole or chunked): "real" (the
# prompt's) and "pad" (added to reach the power-of-two bucket), exported as
# ``serve.prompt_tokens{kind=...}``.
PROMPT_TOKENS: collections.Counter = collections.Counter()


def _prompt_collect() -> dict:
    return {("serve.prompt_tokens", (("kind", k),)): PROMPT_TOKENS[k]
            for k in ("real", "pad")}


_OBS_REGISTRY.register_collector(_prompt_collect)


def prefill_bucketing_supported(cfg: ModelConfig) -> bool:
    """Right-padded prefill is exact only when no layer state integrates the
    pad tokens: pure global-attention decoders."""
    return (
        cfg.encoder_layers == 0
        and cfg.family not in ("audio", "vlm")
        and all(k == "global" for k in cfg.layer_kinds)
    )


def paged_kv_supported(cfg: ModelConfig) -> bool:
    """Paged KV needs every layer's decode state to be a block-structured
    KV cache: the same pure global-attention predicate."""
    return prefill_bucketing_supported(cfg)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list                 # token ids
    max_new_tokens: int = 32
    eos_id: int = 2
    # scheduling inputs (consumed by the scheduler; the defaults arrive
    # immediately, never expire and decode greedily)
    arrival_s: float = 0.0       # offset from scheduler start; 0 = now
    deadline_s: float | None = None  # max queued seconds before expiry
    sampling: Any = None         # SamplingParams, or None for greedy
    # filled by the engine / scheduler
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "pending"      # pending -> queued -> running -> done|expired
    latency_s: float = 0.0       # admission -> last token
    ttft_s: float = 0.0          # arrival -> first token
    queue_s: float = 0.0         # arrival -> admission


class SlotShards:
    """How a mesh splits a pool of ``slots`` decode slots (``mesh=None``:
    one rank holds all of them).

    Data rank d owns slots ``[d * local, (d + 1) * local)`` when the data
    size divides ``slots`` (``sharded``); otherwise every rank holds every
    slot.  :meth:`scope` binds the runtime's mesh (the ``"model"`` axis:
    the KAN-FFN columns) and ``tp``, the tensor-parallel layout
    ``models.model.place_params`` returned, for one step."""

    def __init__(self, mesh, slots: int, tp: comm.TPLayout | None = None):
        self.mesh = mesh
        self.tp = tp
        self.ranks = 1 if mesh is None else int(mesh.mesh.numel())
        dsize, self.msize = (1, 1) if mesh is None else mesh_axis_sizes(mesh)
        self.dsize = dsize
        self.sharded = dsize > 1 and slots % dsize == 0
        self.rank = 0 if mesh is None else mesh_index(mesh, "data")
        self.local = slots // dsize if self.sharded else slots
        self.lo = self.rank * self.local if self.sharded else 0
        names = () if mesh is None else mesh.mesh_dim_names
        self.data_group = mesh.get_group("data") if "data" in names else None
        self.kan_mesh = mesh["model"] if "model" in names else None

    def owner(self, slot: int) -> int:
        return slot // self.local if self.sharded else self.rank

    def owns(self, slot: int) -> bool:
        return self.owner(slot) == self.rank

    def rows(self, a):
        """This rank's rows of a per-slot array."""
        return a[self.lo:self.lo + self.local] if self.sharded else a

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-slot result, in slot order."""
        return comm.all_gather(t, self.data_group, 0) if self.sharded else t

    def share_logits(self, slot: int, logits):
        """The owner's (V,) f32 first-token logits of ``slot`` on every
        rank (``logits`` is None on the others)."""
        if not self.sharded:
            return logits
        return comm.broadcast(logits, self.owner(slot), self.data_group)

    def scope(self, split_rows: bool = False):
        """The mesh scope of one step; ``split_rows``: the step runs the
        local slots on every data rank at once (decode, verify), so the
        rows are this rank's slab of one batch split over "data"."""
        stack = contextlib.ExitStack()
        stack.enter_context(runtime.use_mesh(self.kan_mesh))
        stack.enter_context(comm.use_tp(self.tp))
        stack.enter_context(comm.use_row_split(
            self.data_group if split_rows and self.sharded else None))
        return stack

    def layout(self) -> dict | None:
        if self.mesh is None:
            return None
        return {"axes": list(self.mesh.mesh_dim_names),
                "shape": [int(s) for s in self.mesh.shape],
                "devices": self.ranks,
                "slots_sharded": self.sharded}


def step_scope(kan_backend, attn_backend, shards=None,
               split_rows: bool = False):
    """The KAN and attention backends, the mesh scope of ``shards`` (see
    :meth:`SlotShards.scope`) and ``no_grad`` for one step."""
    stack = contextlib.ExitStack()
    stack.enter_context(runtime.use_backend(kan_backend))
    stack.enter_context(runtime.use_attn_backend(attn_backend))
    if shards is not None:
        stack.enter_context(shards.scope(split_rows))
    stack.enter_context(torch.no_grad())
    return stack


def splice_slot(pool, one, slot: int, plen: int, zero_tail: bool) -> None:
    """Copy a B=1 prefill cache ``one`` into row ``slot`` of a contiguous
    pool IN PLACE: every leaf of every layer (a KV cache's whole time axis,
    ``max_len`` or the rolling window of a "local" layer; a recurrent
    layer's conv and f32 states).  With ``zero_tail`` the KV past the
    prompt (bucket padding, pure global-attention stacks only) is zeroed
    so no stale state enters the pool."""
    for pool_g, one_g in zip(pool, one):
        for key, layer in pool_g.items():
            for name, leaf in layer.items():
                dst = leaf[:, slot]              # (repeats, ...)
                dst.copy_(one_g[key][name][:, 0])
                if zero_tail and key.endswith("_kv"):
                    dst[:, plen:] = 0


def _to_device(tree, dev: torch.device):
    """Tensors of a param tree on ``dev`` (a no-op where they are); deployed
    KAN bundles must already be there."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    for dep in tree:  # a tuple of per-layer DeployedKAN bundles
        if dep.device.type != dev.type:
            raise ValueError(f"deployed KAN bundle on {dep.device}, "
                             f"engine on {dev}")
    return tree


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 kan_deploy: bool = False, kan_backend: str | None = None,
                 attn_backend: str | None = None,
                 prefill_buckets: bool | None = None, mesh=None,
                 kv_block_size: int | None = None,
                 kv_blocks: int | None = None, prefix_cache: bool = True,
                 prefill_chunk: int | None = None,
                 spec_decode: int = 0, draft_spec=None, device=None):
        refusal = M.tokens_only_refusal(cfg, "the serving engine")
        if refusal:
            raise ValueError(refusal)
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        # the drafter refits from the FLOAT weights: keep them before the
        # kan_deploy quantization below swaps the tree for int8 + SH-LUT
        float_params = params
        if kan_deploy:
            # every KAN-FFN block on the quantized datapath (kernel B1),
            # quantized and deployed once here
            if cfg.ffn_kind != "kan":
                raise ValueError(
                    "kan_deploy requires a KAN-FFN config (cfg.kan_variant())")
            runtime.resolve_backend(kan_backend)  # a typo fails at build
            from ..core.kan_ffn_deploy import quantize_kan_ffn_params_tree

            params = quantize_kan_ffn_params_tree(params, cfg)
        tp = None
        if mesh is not None:
            params, tp = M.place_params(params, cfg, mesh)
        self.mesh = mesh
        self.shards = SlotShards(mesh, slots, tp)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.kan_backend = kan_backend if kan_deploy else None
        self.attn_backend = runtime.resolve_attn_backend(attn_backend)
        if prefill_buckets is None:
            prefill_buckets = prefill_bucketing_supported(cfg)
        self.prefill_buckets = prefill_buckets and prefill_bucketing_supported(cfg)

        # -- paged KV pool (kv_block_size set) vs contiguous per-slot slab --
        self.paged = kv_block_size is not None
        self.kv_block_size = kv_block_size
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and not self.paged:
            raise ValueError("prefill_chunk requires the paged KV cache "
                             "(set kv_block_size)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.pools: list[KVBlockPool] = []
        if self.paged:
            if not paged_kv_supported(cfg):
                raise ValueError(
                    "kv_block_size requires a pure global-attention decoder "
                    "(rolling-window / recurrent / encoder state has no pages)"
                )
            if kv_block_size < 1 or kv_block_size % 8:
                raise ValueError(f"kv_block_size must be a positive multiple "
                                 f"of 8, got {kv_block_size}")
            if max_len % kv_block_size:
                raise ValueError(f"max_len={max_len} not a multiple of "
                                 f"kv_block_size={kv_block_size}")
            nblk = max_len // kv_block_size
            num_blocks = (kv_blocks if kv_blocks is not None
                          else slots * nblk + 1)  # +1: the scratch block
            # a sharded pool: one share per data rank, each with its
            # scratch block
            shares = self.shards.dsize if self.shards.sharded else 1
            num_blocks += (-num_blocks) % shares
            self.pools = [KVBlockPool(num_blocks // shares, kv_block_size,
                                      prefix_cache=prefix_cache)
                          for _ in range(shares)]
            # table row entry 0 = the scratch block (unallocated / retired);
            # a row's ids index its owner's share
            self.block_tables = np.zeros((slots, nblk), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
            with self.shards.scope():
                self.cache = M.init_paged_cache(
                    params, cfg, num_blocks // shares, kv_block_size)
        else:
            with self.shards.scope():
                self.cache = M.init_cache(params, cfg, self.shards.local,
                                          max_len)
        self.pos = np.zeros(slots, np.int32)
        self.active: list[Request | None] = [None] * slots
        # sorted free-slot list; a slot mid-prefill is not free
        self._free_slots: list[int] = list(range(slots))
        self._prefilling: dict[int, dict] = {}  # slot -> chunked-prefill state
        self._prefill_buckets_seen: set = set()
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0
        self._verify_widths: set = set()

        # -- speculative decoding (spec_decode=k) ---------------------------
        self.spec_k = int(spec_decode or 0)
        self.draft = None
        if self.spec_k < 0:
            raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
        if self.spec_k:
            if not kan_deploy:
                raise ValueError(
                    "spec_decode requires kan_deploy=True: the drafter is "
                    "refit from the deployed target's KAN-FFN weights")
            if not self.paged:
                raise ValueError(
                    "spec_decode requires the paged KV cache (set "
                    "kv_block_size): draft rollback releases pool blocks")
            from .spec import DraftModel, DraftSpec

            dspec = (draft_spec if isinstance(draft_spec, DraftSpec)
                     else DraftSpec.parse(draft_spec))
            self.draft = DraftModel(float_params, cfg, dspec, slots, max_len,
                                    kan_backend=self.kan_backend,
                                    attn_backend=self.attn_backend,
                                    mesh=mesh)
        elif draft_spec is not None:
            raise ValueError("draft_spec without spec_decode=k has no effect")
        del float_params

    # -- backend scope ----------------------------------------------------

    def _scope(self, split_rows: bool = False):
        """The engine's KAN and attention backends and mesh, for one
        step."""
        return step_scope(self.kan_backend, self.attn_backend, self.shards,
                          split_rows)

    @property
    def pool(self) -> KVBlockPool | None:
        """The paged pool of an engine whose pool is not split over "data"
        (None otherwise, and on contiguous engines)."""
        return self.pools[0] if len(self.pools) == 1 else None

    def _pool_of(self, slot: int) -> KVBlockPool:
        """The pool share that holds ``slot``'s blocks."""
        return self.pools[self.shards.owner(slot) if self.shards.sharded
                          else 0]

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- slot management ------------------------------------------------

    def _free_slot(self):
        """Lowest free slot id, or None."""
        return self._free_slots[0] if self._free_slots else None

    def _take_slot(self, slot: int) -> None:
        i = bisect.bisect_left(self._free_slots, slot)
        if i == len(self._free_slots) or self._free_slots[i] != slot:
            raise RuntimeError(f"slot {slot} is not free "
                               f"(free list: {self._free_slots})")
        self._free_slots.pop(i)

    def release_slot(self, slot: int) -> None:
        """Retire a slot: deactivate it, return its KV blocks to the pool
        (paged) and put it back on the free list."""
        self.active[slot] = None
        self._prefilling.pop(slot, None)
        if self.draft is not None:
            self.draft.release(slot)
        if self.paged:
            for bid in self._slot_blocks[slot]:
                self._pool_of(slot).release(bid)
            self._slot_blocks[slot] = []
            # a retired slot still rides the pooled decode step: its writes
            # go to the scratch block
            self.block_tables[slot] = 0
        bisect.insort(self._free_slots, slot)

    def _padded_prompt(self, prompt: list) -> list:
        """Right-pad to the power-of-two length bucket (token 0 as filler)."""
        if not self.prefill_buckets:
            return list(prompt)
        lb = runtime.bucket_batch(len(prompt))
        if lb > self.max_len - 1:
            return list(prompt)
        return list(prompt) + [0] * (lb - len(prompt))

    def _admit(self, req: Request):
        """Prefill ``req`` into a free slot and greedily pick its first token
        (direct engine use; the scheduler selects tokens itself)."""
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError(
                f"ServeEngine._admit: no free slot for request {req.rid} "
                f"(all {self.slots} busy); check _free_slot() before admitting"
            )
        logits = self._prefill_slot(slot, req)
        req.output.append(int(np.argmax(logits)))

    def _prefill_slot(self, slot: int, req: Request) -> np.ndarray:
        """B=1 prefill of ``req`` into ``slot``, all chunks at once; returns
        the (V,) first-token logits."""
        self._begin_prefill(slot, req)
        logits = self._prefill_step(slot)
        while logits is None:
            logits = self._prefill_step(slot)
        return logits

    def _begin_prefill(self, slot: int, req: Request) -> None:
        """Claim ``slot`` for ``req`` and stage its prefill.  Paged engines
        splice the longest cached full-block prefix (capped at plen - 1
        tokens, so at least one real token is prefilled) copy-free."""
        self._take_slot(slot)
        state = {"req": req, "next": 0}
        if self.paged:
            reused = self._pool_of(slot).match_prefix(
                req.prompt, max_tokens=len(req.prompt) - 1)
            self._slot_blocks[slot] = list(reused)
            for j, bid in enumerate(reused):
                self.block_tables[slot, j] = bid
            state["next"] = len(reused) * self.kv_block_size
        self._prefilling[slot] = state

    def prefilling_slots(self) -> list:
        """Slots currently mid-prefill (claimed, not yet decoding)."""
        return sorted(self._prefilling)

    def _prefill_step(self, slot: int):
        """Advance ``slot``'s staged prefill by one chunk; returns the (V,)
        first-token logits when the prompt completes, else None."""
        st = self._prefilling[slot]
        req = st["req"]
        if not self.paged:
            logits = self._prefill_contiguous(slot, req)
        else:
            logits = self._prefill_paged_chunk(slot, st)
            if logits is None:
                return None
        self.pos[slot] = len(req.prompt)
        self.active[slot] = req
        del self._prefilling[slot]
        if self.draft is not None:
            # the drafter needs the prompt in its own cache before it can
            # propose for this slot: one B=1 drafter prefill
            self.draft.prefill_slot(slot, req)
        return logits

    def _first_logits(self, slot: int, logits) -> np.ndarray:
        """The (V,) first-token logits of ``slot`` on the host of every
        rank (the owner's, broadcast over "data" on a sharded pool)."""
        if logits is None:
            logits = torch.empty(self.cfg.vocab_size, dtype=torch.float32,
                                 device=self.device)
        else:
            logits = logits[0].to(torch.float32)
        return self.shards.share_logits(slot, logits).cpu().numpy()

    def _prefill_contiguous(self, slot: int, req: Request) -> np.ndarray:
        plen = len(req.prompt)
        padded = self._padded_prompt(req.prompt)
        self._prefill_buckets_seen.add(len(padded))
        self.prefill_calls += 1
        PROMPT_TOKENS["real"] += plen
        PROMPT_TOKENS["pad"] += len(padded) - plen
        logits = None
        with self._scope(), profile_scope("serve.prefill"):
            if self.shards.owns(slot):
                logits, cache1 = M.prefill(
                    self.params, {"tokens": self._tensor([padded])},
                    self.cfg, max_len=self.max_len, last_index=[plen - 1])
                splice_slot(self.cache, cache1, slot - self.shards.lo, plen,
                            self.prefill_buckets)
            return self._first_logits(slot, logits)

    def _prefill_paged_chunk(self, slot: int, st: dict):
        """One chunk of paged prefill; returns final logits or None."""
        req = st["req"]
        plen = len(req.prompt)
        start = st["next"]
        cap = self.prefill_chunk if self.prefill_chunk is not None else plen
        take = min(plen - start, cap)
        # pad the chunk to a power-of-two bucket unless that runs past
        # max_len
        c = take
        if self.prefill_buckets:
            lb = runtime.bucket_batch(take)
            if start + lb <= self.max_len:
                c = lb
        bs = self.kv_block_size
        blocks = self._slot_blocks[slot]
        pool = self._pool_of(slot)
        need = -(-(start + take) // bs)          # ceil: blocks covering chunk
        try:
            while len(blocks) < need:
                bid = pool.alloc()
                self.block_tables[slot, len(blocks)] = bid
                blocks.append(bid)
        except Exception:
            self.release_slot(slot)
            raise
        chunk = req.prompt[start:start + take] + [0] * (c - take)
        self._prefill_buckets_seen.add(c)
        self.prefill_calls += 1
        PROMPT_TOKENS["real"] += take
        PROMPT_TOKENS["pad"] += c - take
        logits = None
        with self._scope(), profile_scope("serve.prefill_chunk"):
            if self.shards.owns(slot):
                logits, self.cache = M.prefill_chunk(
                    self.params, self._tensor([chunk]), self.cache,
                    self._tensor(self.block_tables[slot]), start,
                    start + take, self.cfg, plen - 1,
                )
        st["next"] = start + take
        if st["next"] < plen:
            return None
        # publish the prompt's FULL blocks for future prefix hits; partial
        # tail blocks (decode keeps writing them) are never shared
        pool.publish_prefix(req.prompt, blocks[:plen // bs])
        with self._scope():
            return self._first_logits(slot, logits)

    def _ensure_decode_blocks(self, horizon: int = 1) -> None:
        """Allocate the pool blocks covering each active slot's next
        ``horizon`` writes (clamped at ``max_len``)."""
        bs = self.kv_block_size
        for i, r in enumerate(self.active):
            if r is None:
                continue
            blocks = self._slot_blocks[i]
            need = -(-min(int(self.pos[i]) + horizon, self.max_len) // bs)
            while len(blocks) < need:
                bid = self._pool_of(i).alloc()
                self.block_tables[i, len(blocks)] = bid
                blocks.append(bid)

    def _step_tables(self, horizon: int):
        """Block tables for one pooled step: mid-prefill slots ride along
        with a stale pos, so their rows point at the scratch block."""
        self._ensure_decode_blocks(horizon)
        tables = self.block_tables
        if self._prefilling:
            tables = tables.copy()
            for s in self._prefilling:
                tables[s] = 0
        return self._tensor(self.shards.rows(tables))

    def decode_active(self, tokens) -> torch.Tensor:
        """One pooled decode step over all slots (this rank's, on a sharded
        pool); returns device logits (slots, V), gathered over "data", and
        updates the cache in place.  ``pos`` bookkeeping is the caller's."""
        tables = self._step_tables(1) if self.paged else None
        rows = self.shards.rows
        self.decode_calls += 1
        with self._scope(split_rows=True), profile_scope("serve.decode_step"):
            logits, self.cache = M.decode_step(
                self.params, self.cache, self._tensor(rows(np.asarray(tokens))),
                self._tensor(rows(self.pos)), self.cfg, block_table=tables,
            )
            return self.shards.gather(logits)

    def verify_active(self, tokens) -> torch.Tensor:
        """One batched verify pass over all slots (paged engines): tokens
        (slots, S), row i at positions pos[i]..pos[i]+S-1.  Returns device
        logits (slots, S, V); KV for all S positions is written and rolled
        back by :meth:`truncate_slot`."""
        if not self.paged:
            raise ValueError("verify_active requires the paged KV cache")
        tokens = np.asarray(tokens)
        tables = self._step_tables(int(tokens.shape[1]))
        rows = self.shards.rows
        self.verify_calls += 1
        self._verify_widths.add(int(tokens.shape[1]))
        with self._scope(split_rows=True), profile_scope("serve.verify"):
            logits, self.cache = M.verify_step(
                self.params, self.cache, self._tensor(rows(tokens)),
                self._tensor(rows(self.pos)), self.cfg, tables,
            )
            return self.shards.gather(logits)

    def truncate_slot(self, slot: int, new_len: int) -> None:
        """Roll back a slot's KV to ``new_len`` positions: whole tail blocks
        return to the pool and their table rows point at the scratch block."""
        blocks = self._slot_blocks[slot]
        self._pool_of(slot).truncate(blocks, new_len)
        self.block_tables[slot, len(blocks):] = 0

    def kv_stats(self) -> dict | None:
        """Paged-pool counters (None on contiguous engines)."""
        if not self.paged:
            return None
        s = merged_stats(self.pools)
        s["prefill_chunk"] = self.prefill_chunk
        s["slot_blocks"] = [len(b) for b in self._slot_blocks]
        return s

    # -- main loop --------------------------------------------------------

    def run(self, requests: list, log: Callable | None = None):
        """Serve a batch synchronously; returns requests in completion order
        (a thin loop over :class:`.scheduler.Scheduler`)."""
        from .scheduler import Scheduler

        sched = Scheduler(self, log=log)
        for req in requests:
            sched.submit(req)
        return sched.run_until_idle()

    def kan_plan_source(self) -> str | None:
        """Where the KAN-FFN pipeline geometry comes from: "tuned" when a
        ``repro_torch.tune`` tile plan is registered for this engine's FFN
        geometry (e.g. from a ``--tuned-config`` artifact), "heuristic"
        for the built-in plan, None when no KAN-FFN is served."""
        if self.cfg.ffn_kind != "kan":
            return None
        from ..models.layers import kan_ffn_hidden, kan_ffn_specs

        d = self.cfg.d_model
        ov = runtime.PLAN_CACHE.get_tile_overrides(
            (d, kan_ffn_hidden(self.cfg), d), kan_ffn_specs(self.cfg), True)
        return "tuned" if ov is not None else "heuristic"

    def mesh_layout(self) -> dict | None:
        """The serving mesh layout (axes, sizes, ranks, and whether the slot
        pool split over "data"), or None without a mesh."""
        return self.shards.layout()

    def compile_stats(self) -> dict:
        """Engine counters under the reference's keys (``prefill_traces``:
        distinct prefill buckets, ``decode_traces``: decode calls,
        ``verify_traces``: distinct verify widths, what a jit would trace),
        plus the call counts and the runtime plan-cache counters."""
        return {
            "prefill_traces": len(self._prefill_buckets_seen),
            "decode_traces": self.decode_calls,
            "verify_traces": len(self._verify_widths),
            "verify_calls": self.verify_calls,
            "prefill_calls": self.prefill_calls,
            "plan_cache": runtime.cache_stats(),
            "mesh": self.mesh_layout(),
            "attn_backend": self.attn_backend,
            "kv": self.kv_stats(),
            "spec": (None if self.draft is None
                     else {"k": self.spec_k, "draft": self.draft.describe()}),
        }
