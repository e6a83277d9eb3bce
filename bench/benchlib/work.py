"""The logical work of the benchmark's calls, and the H100's peaks.

Logical work is what the model needs from the inputs, counted the same
whatever implements it: real rows (prompt tokens, active requests,
request rows; never buckets or slots), real widths (40 query heads, not
the 48 the port stores), weights at the configuration's bits read once
per call, activations in and out once at the configuration's dtype.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit.
The KAN datapath runs float32 on the CUDA cores; the LM's matmuls and
attention run bfloat16 on the tensor cores.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass
class Work:
    """FLOPs by precision class and bytes moved."""

    flops: dict = dataclasses.field(default_factory=dict)
    nbytes: float = 0.0

    def add(self, other: "Work") -> "Work":
        for k, v in other.flops.items():
            self.flops[k] = self.flops.get(k, 0.0) + v
        self.nbytes += other.nbytes
        return self

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the FLOPs at
        each class's peak and the bytes at the memory's."""
        return max(sum(f / PEAK_FLOPS[c] for c, f in self.flops.items()),
                   self.nbytes / PEAK_BYTES)

    def peak_s(self) -> float:
        """The FLOPs' time at the peaks (an MFU's numerator)."""
        return sum(f / PEAK_FLOPS[c] for c, f in self.flops.items())


def total(works) -> Work:
    out = Work()
    for w in works:
        out.add(w)
    return out


def sum_bound_s(works) -> float:
    """Roofline bound of a sequence of calls: each call's bound, summed."""
    return sum(w.bound_s() for w in works)


# ----------------------------------------------------------------------------
# KAN layers (kernel B1: one call per layer)
# ----------------------------------------------------------------------------


def kan_ld(grid: int, n_bits: int) -> int:
    """Local bits of the PowerGap split: the largest LD, G * 2**LD <= 2**n."""
    ld = -1
    while grid * 2 ** (ld + 1) <= 2 ** n_bits:
        ld += 1
    return ld


def kan_layer(rows: int, f: int, o: int, grid: int, order: int,
              weight_bits: int, lut_bits: int, n_bits: int,
              act_in: int, act_out: int) -> Work:
    """One quantized KAN layer over ``rows`` rows, ``f`` -> ``o``.

    FLOPs: per (row, input, output) K+1 spline MACs and one ReLU-branch
    MAC, two FLOPs each, in float32.  Bytes: c' (f, G+K, o) and w_b (f, o)
    at ``weight_bits``, two per-column float32 scales, the shared LUT
    (2**LD, K+1) at ``lut_bits``, ``act_in`` bytes per input element and
    ``act_out`` per output element."""
    nb = grid + order
    weights = (f * nb * o + f * o) * weight_bits / 8 + 2 * o * 4
    lut = 2 ** kan_ld(grid, n_bits) * (order + 1) * lut_bits / 8
    nbytes = weights + lut + rows * (f * act_in + o * act_out)
    return Work({"float32": 2.0 * rows * f * o * (order + 2)}, nbytes)


def kan_network(rows: int, cfg: dict) -> list:
    """The calls of one request through a KAN network config
    (``dims``, ``grid_size``, ...): one per layer."""
    a = DTYPE_BYTES[cfg["activation_dtype"]]
    dims = cfg["dims"]
    return [kan_layer(rows, f, o, cfg["grid_size"], cfg["order"],
                      cfg["weight_bits"], cfg["lut_bits"], cfg["n_bits"],
                      a, a)
            for f, o in zip(dims[:-1], dims[1:])]


# ----------------------------------------------------------------------------
# The LM (a decoder with a KAN-FFN)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMDims:
    d: int
    heads: int          # logical query heads
    kv_heads: int
    head_dim: int
    vocab: int
    layers: int
    hidden: int         # KAN-FFN hidden width
    grid: int
    order: int
    n_bits: int
    act: int            # bytes of one activation element (the config dtype)

    @classmethod
    def of(cls, cfg: dict) -> "LMDims":
        k = cfg["kan_ffn"]
        return cls(d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
                   vocab=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
                   hidden=k["d_hidden"], grid=k["grid"], order=k["order"],
                   n_bits=k["n_bits"], act=DTYPE_BYTES[cfg["torch_dtype"]])


def lm_kan_halves(m: LMDims, rows: int) -> list:
    """B1's two calls of one KAN-FFN layer: d -> hidden -> d."""
    return [kan_layer(rows, m.d, m.hidden, m.grid, m.order, m.n_bits,
                      m.n_bits, m.n_bits, m.act, m.act),
            kan_layer(rows, m.hidden, m.d, m.grid, m.order, m.n_bits,
                      m.n_bits, m.n_bits, m.act, m.act)]


def _linear(rows: int, k: int, n: int, act: int) -> Work:
    """A bfloat16 matmul (rows, k) @ (k, n), weights read once."""
    return Work({"bfloat16": 2.0 * rows * k * n},
                k * n * act + rows * (k + n) * act)


def lm_projections(m: LMDims, rows: int) -> Work:
    """Q, K, V and output projections of one layer (logical heads)."""
    q = m.heads * m.head_dim
    kv = m.kv_heads * m.head_dim
    return total([_linear(rows, m.d, q + 2 * kv, m.act),
                  _linear(rows, q, m.d, m.act)])


def attn_decode(m: LMDims, keys) -> Work:
    """Kernel B2 at one decode step of one layer: each active request
    reads its ``keys`` cached K and V once; QK^T and PV, 2 FLOPs a MAC."""
    n = sum(keys)
    flops = 4.0 * n * m.heads * m.head_dim
    kv = 2.0 * n * m.kv_heads * m.head_dim * m.act
    qo = 2.0 * len(keys) * m.heads * m.head_dim * m.act
    return Work({"bfloat16": flops}, kv + qo)


def attn_prefill(m: LMDims, s: int) -> Work:
    """Kernel B2 over one causal prompt of ``s`` tokens in one layer."""
    flops = 4.0 * m.heads * m.head_dim * s * (s + 1) / 2
    nbytes = s * m.head_dim * (2 * m.heads + 2 * m.kv_heads) * m.act
    return Work({"bfloat16": flops}, nbytes)


def lm_head(m: LMDims, rows: int) -> Work:
    return _linear(rows, m.d, m.vocab, m.act)


def lm_prefill(m: LMDims, s: int) -> dict:
    """Logical work of one prefill of ``s`` real tokens, by part: the
    first-token logits are the only LM-head row."""
    return {"b1": [w for _ in range(m.layers) for w in lm_kan_halves(m, s)],
            "b2": [attn_prefill(m, s) for _ in range(m.layers)],
            "proj": [lm_projections(m, s) for _ in range(m.layers)],
            "head": [lm_head(m, 1)]}


def lm_decode(m: LMDims, keys) -> dict:
    """Logical work of one decode step whose active requests attend
    ``keys`` positions each (one row per active request)."""
    rows = len(keys)
    return {"b1": [w for _ in range(m.layers)
                   for w in lm_kan_halves(m, rows)],
            "b2": [attn_decode(m, keys) for _ in range(m.layers)],
            "proj": [lm_projections(m, rows) for _ in range(m.layers)],
            "head": [lm_head(m, rows)]}


def model_work(parts: dict) -> Work:
    return total(w for ws in parts.values() for w in ws)


def mfu_percent(works, seconds: float) -> float | None:
    """Share of the card's peak that the model FLOPs of ``works`` take
    over ``seconds``, in percent."""
    if seconds <= 0:
        return None
    return 100.0 * total(works).peak_s() / seconds


def roofline_percent(works, device_s: float) -> float | None:
    """Share of its roofline that a kernel reaches: the calls' summed
    bounds over the kernel's device time, in percent."""
    if device_s <= 0 or not works:
        return None
    return 100.0 * sum_bound_s(works) / device_s


def ceil_pow2(n: int, lo: int = 8) -> int:
    """The port's batch bucket: ``lo`` times a power of two (plancache)."""
    return lo * 2 ** max(0, math.ceil(math.log2(max(n, 1) / lo)))


def traced_lm_calls(rec) -> tuple:
    """The logical work of the calls in a traced LM slice: ([prefill parts
    per prefill], [decode parts per decode step]), each as
    :func:`lm_prefill` / :func:`lm_decode` give them."""
    m = LMDims.of(rec.cfg)
    pre = [lm_prefill(m, p) for st in rec.traced_steps for p in st["prefills"]]
    dec = [lm_decode(m, st["decode_keys"]) for st in rec.traced_steps
           if st["decode_keys"]]
    return pre, dec
