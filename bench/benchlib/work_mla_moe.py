"""The logical work of a decoder with latent attention (MLA) and routed
KAN experts (a ``lm_moe_serve`` configuration), counted as ``work.py``
counts the KAN-FFN decoder's: real rows (prompt tokens, active requests;
routed rows are tokens times the experts a token takes), real widths,
weights at the configuration's bits read once a call, activations in and
out once at the configuration's dtype, every B1 MAC float32 work.

A MoE layer's routed experts run as one grouped B1 call per half: its
rows are every routed row of the call, and each of the E experts' weights
is read once.  Prefill counts the expanded MLA (q . k over dn + dr dims,
v of dv, per head); decode the absorbed form over the latent cache (each
active request's cached latent rows, r + dr values a position, read once;
its query in the latent space in and its latent output out).
"""

from __future__ import annotations

import dataclasses

from .work import DTYPE_BYTES, Work, kan_layer, total


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d: int
    heads: int
    dn: int             # no-rope part of a query / key head
    dr: int             # rotary part (one shared key head)
    dv: int
    r: int              # latent rank
    vocab: int
    layers: int
    dense_layers: int
    experts: int
    topk: int
    shared: bool
    dense_hidden: int
    expert_hidden: int
    shared_hidden: int
    grid: int
    order: int
    n_bits: int
    act: int

    @classmethod
    def of(cls, cfg: dict) -> "MoEDims":
        k = cfg["kan_ffn"]
        return cls(d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
                   dn=cfg["qk_nope_head_dim"], dr=cfg["qk_rope_head_dim"],
                   dv=cfg["v_head_dim"], r=cfg["kv_lora_rank"],
                   vocab=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
                   dense_layers=cfg["first_k_dense_replace"],
                   experts=cfg["n_routed_experts"],
                   topk=cfg["num_experts_per_tok"],
                   shared=cfg["n_shared_experts"] > 0,
                   dense_hidden=k["d_hidden"],
                   expert_hidden=k["expert_hidden"],
                   shared_hidden=k["shared_hidden"], grid=k["grid"],
                   order=k["order"], n_bits=k["n_bits"],
                   act=DTYPE_BYTES[cfg["torch_dtype"]])

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers


def kan_halves(m: MoEDims, rows: int, hidden: int, copies: int = 1) -> list:
    """B1's two calls of a KAN-FFN d -> hidden -> d over ``rows`` rows,
    whose calls read ``copies`` networks' weights once each (a grouped
    call: every expert's)."""
    out = []
    for f, o in ((m.d, hidden), (hidden, m.d)):
        w = kan_layer(rows, f, o, m.grid, m.order, m.n_bits, m.n_bits,
                      m.n_bits, m.act, m.act)
        if copies > 1:
            weights = kan_layer(0, f, o, m.grid, m.order, m.n_bits, m.n_bits,
                                m.n_bits, m.act, m.act).nbytes
            w = Work(dict(w.flops), w.nbytes + (copies - 1) * weights)
        out.append(w)
    return out


def moe_grouped(m: MoEDims, tokens: int) -> list:
    """The grouped expert calls of one step of ``tokens`` tokens: both
    halves of every MoE layer over tokens x topk routed rows."""
    return [w for _ in range(m.moe_layers)
            for w in kan_halves(m, tokens * m.topk, m.expert_hidden,
                                m.experts)]


def ffn_ungrouped(m: MoEDims, tokens: int) -> list:
    """The B1 calls of one step of ``tokens`` tokens outside the grouped
    experts: both halves of every leading dense layer's KAN-FFN and of
    every MoE layer's shared experts."""
    out = []
    for _ in range(m.dense_layers):
        out += kan_halves(m, tokens, m.dense_hidden)
    for _ in range(m.moe_layers if m.shared else 0):
        out += kan_halves(m, tokens, m.shared_hidden)
    return out


def _linear(rows: int, k: int, n: int, act: int,
            cls: str = "bfloat16") -> Work:
    return Work({cls: 2.0 * rows * k * n},
                k * n * (4 if cls == "float32" else act)
                + rows * (k + n) * act)


def mla_projections(m: MoEDims, rows: int) -> Work:
    """q, kv_a, kv_b and o of one layer (kv_b's product is the same at
    decode, where it is absorbed into the query and the output)."""
    h = m.heads
    return total([_linear(rows, m.d, h * (m.dn + m.dr), m.act),
                  _linear(rows, m.d, m.r + m.dr, m.act),
                  _linear(rows, m.r, h * (m.dn + m.dv), m.act),
                  _linear(rows, h * m.dv, m.d, m.act)])


def mla_decode(m: MoEDims, keys) -> Work:
    """The absorbed attention of one decode step in one layer: each active
    request reads its ``keys`` cached latent rows once; scores over r + dr
    and the latent weighted sum over r, 2 FLOPs a MAC."""
    n = sum(keys)
    h = m.heads
    flops = 2.0 * n * h * (m.r + m.dr) + 2.0 * n * h * m.r
    cache = n * (m.r + m.dr) * m.act
    qo = len(keys) * h * ((m.r + m.dr) + m.r) * m.act
    return Work({"bfloat16": flops}, cache + qo)


def mla_prefill(m: MoEDims, s: int) -> Work:
    """The expanded causal attention of one prompt of ``s`` tokens."""
    h, pairs = m.heads, s * (s + 1) / 2
    flops = 2.0 * h * (m.dn + m.dr) * pairs + 2.0 * h * m.dv * pairs
    nbytes = s * h * (2 * (m.dn + m.dr) + 2 * m.dv) * m.act
    return Work({"bfloat16": flops}, nbytes)


def step_work(m: MoEDims, rows: int, attn: Work) -> list:
    """Every call of one step of ``rows`` tokens, ``attn`` its attention
    in one layer: projections, attention, the dense layer's and the shared
    experts' KAN-FFNs, the routers (float32) and grouped experts, and the
    LM head (one row a prefill)."""
    out = []
    for _ in range(m.layers):
        out += [mla_projections(m, rows), attn]
    for _ in range(m.moe_layers):
        out.append(_linear(rows, m.d, m.experts, 4, "float32"))
    return out + ffn_ungrouped(m, rows) + moe_grouped(m, rows)


def traced_calls(rec) -> tuple:
    """([prefill tokens], [decode keys per step]) of a traced slice."""
    pre = [p for st in rec.traced_steps for p in st["prefills"]]
    dec = [st["decode_keys"] for st in rec.traced_steps if st["decode_keys"]]
    return pre, dec


def model_works(rec) -> list:
    """Every call of the traced slice's prefills and decode steps."""
    m = MoEDims.of(rec.cfg)
    pre, dec = traced_calls(rec)
    out = []
    for s in pre:
        out += step_work(m, s, mla_prefill(m, s))
        out.append(_linear(1, m.d, m.vocab, m.act))
    for keys in dec:
        out += step_work(m, len(keys), mla_decode(m, keys))
        out.append(_linear(len(keys), m.d, m.vocab, m.act))
    return out
