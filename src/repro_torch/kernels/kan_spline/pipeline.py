"""Fused multi-layer quantized KAN executor: plan, weight layout, kernel B1.

Port of ``repro.kernels.kan_spline.pipeline``.  Layers chain so that only
int32 activation codes (plus the raw f32 activation for ``residual_raw``
FFN stacks) cross layer boundaries: each layer's kernel also runs the
boundary requantizer (tanh domain rescale -> ASP re-coding) on its output.

The geometry half is ported verbatim, including the TPU tile heuristics of
:func:`make_pipeline_plan`: they mean nothing on Hopper, but layer 0's
``fp = _round_up(f, bf)`` depends on them, and the port must pad exactly as
the reference does so that converted bundles load without change.  The
CUDA kernel ignores ``bo``/``bf`` and picks its own column tile and feature
chunks; the one tile it reads is the plan's ``row_tile``, its batch rows
per block: 64 unless the plan was made with ``tile_overrides`` (a tuned
plan), where it follows the tuned ``bb`` (:func:`row_tile_for`).  The row
tile changes the schedule and no bit; the plain version ignores it.

Kernel B1 (``csrc/kan_spline.cu::kan_pipeline_layer``) replaces
``repro/kernels/kan_spline/pipeline.py::_pipeline_layer_kernel``.
:func:`run_pipeline_layer` launches it for CUDA tensors and takes the plain
PyTorch version :func:`run_pipeline_layer_plain` only for CPU tensors.  The
launch picks one of B1's two band loops by the call's shape
(:func:`b1_loop`); both give the same bits.
Both split the feature axis as :func:`feature_split_plan` says, a function
of the layer's widths alone: each split sums its features, and the splits
are added in order before the noise operand.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...core.asp_quant import (
    ASPQuantSpec,
    dense_basis_from_codes,
    f32,
    lut_scale,
)
from .. import cuda

__all__ = [
    "LayerPlan",
    "PipelinePlan",
    "make_pipeline_plan",
    "ROW_TILES",
    "row_tile_for",
    "normalize_tile_overrides",
    "validate_plan",
    "model_shardable",
    "shard_local_plan",
    "weight_bits",
    "packs_weights",
    "packs_lut",
    "layer_weight_keys",
    "pad_layer_weights",
    "pack_layer_weights",
    "pack_lut",
    "unpack_lut",
    "unpacked_wc",
    "gained_layer",
    "FEATURES_PER_SPLIT",
    "feature_split_plan",
    "feature_split_bounds",
    "B1_LOOPS",
    "REGS_ROW_TILE",
    "b1_loop",
    "run_pipeline_layer",
    "run_pipeline_layer_plain",
    "kan_pipeline_impl",
]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_at_least(x: int, lo: int = 8, hi: int = 128) -> int:
    p = lo
    while p < min(x, hi):
        p *= 2
    return p


# ----------------------------------------------------------------------------
# Static geometry plan (verbatim from the reference)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static per-layer geometry + boundary behavior (hashable)."""

    spec: ASPQuantSpec              # quantization grid of THIS layer's input
    next_spec: ASPQuantSpec | None  # None -> last layer (emit f32 only)
    f: int                          # logical input width
    o: int                          # logical output width
    fp: int                         # padded input width  (multiple of bf)
    op: int                         # padded output width (multiple of bo)
    bb: int
    bo: int
    bf: int
    residual_raw: bool              # ReLU branch source: raw f32 vs deq(codes)

    @property
    def emit_codes(self) -> bool:
        return self.next_spec is not None


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    b: int                          # logical batch
    bp: int                         # padded batch (multiple of layers[0].bb)
    layers: tuple                   # tuple[LayerPlan, ...]
    row_tile: int = 64              # kernel B1's batch rows per block


# kernel B1's row tiles (template instances of its kRowsB); the first is
# the smallest, the last the untuned default
ROW_TILES = (16, 32, 64)


def row_tile_for(bb: int) -> int:
    """B1's row tile for a tuned batch block ``bb``: the largest of
    :data:`ROW_TILES` not above ``max(16, bb)``, so ``min(64, max(16, bb))``
    for the power-of-two blocks the tile tuner proposes."""
    return max(t for t in ROW_TILES if t <= max(ROW_TILES[0], bb))


# The reference's VMEM ceiling for its (bB, bF, G+K) f32 basis tile; kept
# only because it decides bf, and bf decides layer 0's padded width fp.
_BASIS_TILE_BUDGET = 4 * 1024 * 1024


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def normalize_tile_overrides(tile_overrides, n_layers: int) -> tuple | None:
    """Canonicalize tile overrides to a per-layer ((bb, bo, bf), ...) tuple.

    Accepts one (bb, bo, bf) triple (broadcast) or a per-layer sequence;
    ``bb`` must agree across layers (the batch pad is shared).
    """
    if tile_overrides is None:
        return None
    ov = tuple(tile_overrides)
    if len(ov) == 3 and all(not hasattr(v, "__len__") for v in ov):
        ov = tuple((int(ov[0]), int(ov[1]), int(ov[2])) for _ in range(n_layers))
    else:
        ov = tuple((int(b), int(o), int(f)) for b, o, f in ov)
    if len(ov) != n_layers:
        raise ValueError(f"{len(ov)} tile overrides for {n_layers} layers")
    if len({b for b, _, _ in ov}) != 1:
        raise ValueError(f"per-layer bb must agree (shared batch pad): {ov}")
    return ov


def make_pipeline_plan(
    batch: int,
    dims: tuple,
    specs: tuple,
    *,
    residual_raw: bool = False,
    max_block_b: int = 128,
    max_block_f: int = 128,
    tile_overrides=None,
) -> PipelinePlan:
    """Choose block sizes + padded dims for a whole stack from shapes alone.

    dims: (F0, O0=F1, O1=F2, ...); specs: per-layer ASPQuantSpec.  Overrides
    change only the tiling, never the padded dims ``fp``/``op``; with them
    the plan's ``row_tile`` follows the tuned ``bb`` (:func:`row_tile_for`),
    without them it is 64.
    """
    n_layers = len(dims) - 1
    if len(specs) != n_layers:
        raise ValueError(f"{len(specs)} specs for {n_layers} layers")
    overrides = normalize_tile_overrides(tile_overrides, n_layers)

    bb = min(max_block_b, _round_up(batch, 8))
    if overrides is not None:
        bb = overrides[0][0]
        if bb < 8 or bb % 8:
            raise ValueError(f"bb override must be a multiple of 8 >= 8: {bb}")
        bb = min(bb, _round_up(batch, 8))
    bp = _round_up(batch, bb)

    layers = []
    for li in range(n_layers):
        f, o = dims[li], dims[li + 1]
        spec = specs[li]
        nb = spec.num_basis
        # bf must divide the boundary pad (128) when fed by a previous layer,
        # so it is a power of two <= 128; shrink until the basis tile fits.
        # The budget uses the WORST-CASE bb (max_block_b), so fp/op are
        # batch-independent.
        bf = _pow2_at_least(f) if li == 0 else 128
        while bf > 8 and max_block_b * bf * nb * 4 > _BASIS_TILE_BUDGET:
            bf //= 2
        bo = 128
        fp = _round_up(f, bf) if li == 0 else _round_up(f, 128)
        op = _round_up(o, bo)
        if overrides is not None:
            _, bo_c, bf_c = overrides[li]
            if not (_is_pow2(bo_c) and 8 <= bo_c <= 128 and op % bo_c == 0):
                raise ValueError(
                    f"layer {li}: bo override {bo_c} invalid for op={op}"
                )
            if not (_is_pow2(bf_c) and 8 <= bf_c <= 128 and fp % bf_c == 0):
                raise ValueError(
                    f"layer {li}: bf override {bf_c} invalid for fp={fp}"
                )
            if bb * bf_c * nb * 4 > _BASIS_TILE_BUDGET:
                raise ValueError(
                    f"layer {li}: basis tile {bb}x{bf_c}x{nb} exceeds the "
                    "VMEM budget"
                )
            bo, bf = bo_c, bf_c
        layers.append(
            LayerPlan(
                spec=spec,
                next_spec=specs[li + 1] if li + 1 < n_layers else None,
                f=f, o=o, fp=fp, op=op,
                bb=bb, bo=bo, bf=bf,
                residual_raw=residual_raw,
            )
        )
    return PipelinePlan(
        b=batch, bp=bp, layers=tuple(layers),
        row_tile=ROW_TILES[-1] if overrides is None else row_tile_for(bb))


def model_shardable(op: int, model_size: int) -> bool:
    """Can an output dim split over a model axis of this size?

    The axis must divide the padded dim AND each shard must keep a
    multiple-of-8 slab.  The one shardability criterion: ``shard_local_plan``
    (execution) and ``dist.sharding.deployed_kan_pspecs`` (weight placement)
    both use it, so a bundle is never placed sharded where the runtime would
    run it replicated (or the other way round)."""
    return (model_size > 1 and op % model_size == 0
            and (op // model_size) % 8 == 0)


def shard_local_plan(plan: PipelinePlan, model_size: int) -> tuple:
    """Per-shard geometry for output-channel ("model") sharding of a stack.

    Each model shard owns WHOLE output columns of every sharded layer (the
    contraction axis stays full), so the per-shard plan keeps ``f``/``fp``/
    ``bf`` and divides ``op`` by the model-axis size; a layer whose padded
    output dim :func:`model_shardable` refuses keeps replicated columns and
    the reason is recorded.  ``bo`` is halved until it divides the slab.

    Returns ``(local_plan, sharded_flags, notes)``.  The local plan breaks
    two :func:`validate_plan` invariants on purpose (the inter-layer
    boundary, restored by an all-gather over "model", and the 128-padded
    boundary, a global property), so it must not be re-validated.  Its
    sharded layers' ``o`` is the local slab, so B1's feature split must
    come from the GLOBAL plan (``run_pipeline_layer(feature_splits=)``).
    """
    n = len(plan.layers)
    if model_size <= 1:
        return plan, (False,) * n, ()
    layers, flags, notes = [], [], []
    for li, lp in enumerate(plan.layers):
        if not model_shardable(lp.op, model_size):
            notes.append(
                f"layer {li}: op={lp.op} not shardable over model={model_size}"
                " (needs a multiple-of-8 per-shard slab); columns replicated"
            )
            layers.append(lp)
            flags.append(False)
            continue
        op_l = lp.op // model_size
        bo_l = lp.bo
        while op_l % bo_l:
            bo_l //= 2
        layers.append(dataclasses.replace(lp, o=op_l, op=op_l, bo=bo_l))
        flags.append(True)
    return (
        dataclasses.replace(plan, layers=tuple(layers)),
        tuple(flags),
        tuple(notes),
    )


def validate_plan(plan: PipelinePlan) -> None:
    """Raise ``ValueError`` on the first broken geometric invariant."""
    if not plan.layers:
        raise ValueError("plan has no layers")
    if plan.bp < plan.b:
        raise ValueError(f"padded batch {plan.bp} < logical batch {plan.b}")
    if plan.row_tile not in ROW_TILES:
        raise ValueError(f"row tile {plan.row_tile} not in {ROW_TILES}")
    prev_op = None
    for li, lp in enumerate(plan.layers):
        nb = lp.spec.num_basis
        if plan.bp % lp.bb:
            raise ValueError(f"layer {li}: bp={plan.bp} not divisible by bb={lp.bb}")
        if lp.fp % lp.bf:
            raise ValueError(f"layer {li}: fp={lp.fp} not divisible by bf={lp.bf}")
        if lp.op % lp.bo:
            raise ValueError(f"layer {li}: op={lp.op} not divisible by bo={lp.bo}")
        if lp.fp < lp.f or lp.op < lp.o:
            raise ValueError(f"layer {li}: padded dims below logical dims")
        if prev_op is not None and lp.fp != prev_op:
            raise ValueError(
                f"layer {li}: boundary mismatch fp={lp.fp} != prev op={prev_op}"
            )
        if lp.emit_codes and lp.op % 128:
            raise ValueError(f"layer {li}: boundary op={lp.op} not 128-padded")
        if lp.bb * lp.bf * nb * 4 > _BASIS_TILE_BUDGET:
            raise ValueError(
                f"layer {li}: basis tile {lp.bb}x{lp.bf}x{nb} exceeds the "
                "VMEM budget"
            )
        prev_op = lp.op


# ----------------------------------------------------------------------------
# Deployed weight layout: padding and sub-8-bit packing
# ----------------------------------------------------------------------------
#
# A layer whose weight codes fit in 4 bits stores them PACKED: two signed
# int4 row codes per int8 lane along the contraction axis (row 2r in the low
# nibble, row 2r+1 in the high nibble) plus per-output-channel f32 scales.
# Decoding is int32 nibble extraction then f32 code x f32 scale, the exact
# product the unpacked deployment stores, so packed and unpacked runs are
# bit-identical.  A <=4-bit SH-LUT packs two unsigned nibbles per lane along
# its K+1 axis.


def weight_bits(spec: ASPQuantSpec) -> int:
    """Signed weight-code width a layer deploys at (input width, capped 8)."""
    return min(8, spec.n_bits)


def packs_weights(spec: ASPQuantSpec) -> bool:
    """True when the layer's weight codes int4-pack (two per int8 lane)."""
    return weight_bits(spec) <= 4


def packs_lut(spec: ASPQuantSpec) -> bool:
    """True when the layer's SH-LUT codes int4-pack."""
    return spec.lut_bits <= 4


def layer_weight_keys(lp: LayerPlan) -> tuple:
    """The deployed weight-dict keys this layer's plan implies."""
    keys = ["lut"]
    if packs_lut(lp.spec):
        keys.append("lutp")
    if packs_weights(lp.spec):
        keys += ["wcp", "wscale"]
    else:
        keys.append("wc")
    keys.append("wb")
    return tuple(keys)


def pad_layer_weights(wc: torch.Tensor, wb: torch.Tensor, lp: LayerPlan) -> dict:
    """Zero-pad dequantized weights: wc (F, G+K, O) -> (Fp*(G+K), Op),
    wb (F, O) -> (Fp, Op)."""
    nb = lp.spec.num_basis
    wc_p = F.pad(wc.to(torch.float32),
                 (0, lp.op - lp.o, 0, 0, 0, lp.fp - lp.f)).reshape(lp.fp * nb, lp.op)
    wb_p = F.pad(wb.to(torch.float32), (0, lp.op - lp.o, 0, lp.fp - lp.f))
    return {"wc": wc_p.contiguous(), "wb": wb_p.contiguous()}


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pair two int code arrays into one int8 lane (lo nibble, hi nibble)."""
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    return (((hi << 4) & 0xF0) | (lo & 0x0F)).to(torch.int8)


def _unpack_lo_nibble(p32: torch.Tensor) -> torch.Tensor:
    """Sign-extended low nibble of packed int8 lanes (as int32)."""
    return (p32 << 28) >> 28


def _unpack_hi_nibble(p32: torch.Tensor) -> torch.Tensor:
    """Sign-extended high nibble of packed int8 lanes (as int32)."""
    return (p32 << 24) >> 28


def pack_layer_weights(c_q: torch.Tensor, c_scale: torch.Tensor,
                       wb: torch.Tensor, lp: LayerPlan) -> dict:
    """int4-pack one layer's spline weight codes to the plan's geometry.

    c_q int8 (F, G+K, O) in [-7, 7] -> "wcp" (Fp*(G+K)//2, Op); c_scale
    (O,) -> "wscale" (1, Op) with padded channels at scale 0; wb stays f32,
    zero-padded as in :func:`pad_layer_weights`.
    """
    nb = lp.spec.num_basis
    q = F.pad(c_q.to(torch.int8),
              (0, lp.op - lp.o, 0, 0, 0, lp.fp - lp.f)).reshape(lp.fp * nb, lp.op)
    wcp = _pack_nibbles(q[0::2], q[1::2]).contiguous()
    wscale = F.pad(c_scale.to(torch.float32), (0, lp.op - lp.o))[None, :]
    wb_p = F.pad(wb.to(torch.float32), (0, lp.op - lp.o, 0, lp.fp - lp.f))
    return {"wcp": wcp, "wscale": wscale.contiguous(), "wb": wb_p.contiguous()}


def pack_lut(lut_q: torch.Tensor, spec: ASPQuantSpec) -> torch.Tensor:
    """Pack (2**LD, K+1) unsigned SH-LUT codes two per lane on K+1 (odd K+1
    pads one zero column first)."""
    q = lut_q.to(torch.int32)
    if (spec.order + 1) % 2:
        q = F.pad(q, (0, 1))
    return _pack_nibbles(q[:, 0::2], q[:, 1::2]).contiguous()


def unpack_lut(lutp: torch.Tensor, spec: ASPQuantSpec) -> torch.Tensor:
    """The f32 SH-LUT a packed table decodes to: unsigned nibble x f32
    ``lut_scale`` (equal to the deployed ``lut`` for lut_bits <= 4)."""
    p32 = lutp.to(torch.int32)
    nib = torch.stack([p32 & 0xF, (p32 >> 4) & 0xF], dim=-1)
    nib = nib.reshape(p32.shape[0], 2 * p32.shape[1])[:, : spec.order + 1]
    return nib.to(torch.float32) * f32(lut_scale(spec))


def unpacked_wc(lw: dict, lp: LayerPlan) -> torch.Tensor:
    """The padded f32 banded matrix of a deployed layer, packed or not,
    decoded with the kernel's own in-lane arithmetic."""
    if "wc" in lw:
        return lw["wc"].to(torch.float32)
    p32 = lw["wcp"].to(torch.int32)
    half, op = p32.shape
    q = torch.stack([_unpack_lo_nibble(p32), _unpack_hi_nibble(p32)],
                    dim=1).reshape(2 * half, op)
    return q.to(torch.float32) * lw["wscale"].to(torch.float32)


def gained_layer(lw: dict, lp: LayerPlan, gain) -> dict:
    """A deployed layer with its banded rows times ``gain`` ((Fp*NB, 1) f32,
    the acim backend's IR-drop row gains), or ``lw`` itself for None.  The
    gains break the uniform per-channel scale, so a packed layer comes back
    on its unpacked f32 weights: a new (Fp*NB, Op) f32 tensor."""
    if gain is None:
        return lw
    return {"lut": lw["lut"], "wc": unpacked_wc(lw, lp) * gain,
            "wb": lw["wb"]}


# ----------------------------------------------------------------------------
# Kernel B1: one fused layer + the boundary requantizer
# ----------------------------------------------------------------------------


# Feature splits of kernels B1 and B3: one per FEATURES_PER_SPLIT logical
# input features, and at most as many as fill the card
# (``cuda.FILL_BLOCKS``) at a single 64-row tile of 128-column blocks.
FEATURES_PER_SPLIT = 256
_BLOCK_COLS = 128


def feature_split_plan(f: int, o: int) -> tuple:
    """(splits, features per split) of a layer of logical widths f -> o.

    A function of the widths alone, never of the batch, so a row's output
    bits do not depend on how many rows share its call: 5120 -> 1280 gives
    (20, 256), 1280 -> 5120 (5, 256), every f <= 256 layer (1, f)."""
    col_tiles = -(-o // _BLOCK_COLS)
    splits = max(1, min(-(-f // FEATURES_PER_SPLIT),
                        -(-cuda.FILL_BLOCKS // col_tiles)))
    fps = -(-f // splits)
    return -(-f // fps), fps


def feature_split_bounds(f: int, fp: int, splits: int) -> list:
    """The [lo, hi) feature slices of ``splits`` splits of the logical
    features f (``ceil(f / splits)`` each, as the kernel cuts them); the
    last one runs on to the padded width fp (zero weights)."""
    fps = -(-f // max(int(splits), 1))
    bounds = [(lo, min(lo + fps, f)) for lo in range(0, f, fps)] or [(0, 0)]
    bounds[-1] = (bounds[-1][0], fp)
    return bounds


# Kernel B1's two band loops, the same bits either way (``csrc/
# kan_spline.cu``, "Design").  "gather": every (row, feature) reads its K+1
# band rows from shared memory.  "regs": a warp reads a feature's band rows
# into registers once and runs its rows against them, at a 64-row tile, for
# grids of REGS_GRID intervals only.  :func:`b1_loop` takes the register
# loop from REGS_MIN_ROWS rows over REGS_MIN_COLS live columns, the
# crossover of the card's times of both loops (``chip_smoke.py``'s B1 loop
# rows, H100: the gather is faster at 32 rows, the register loop at 64).
B1_LOOPS = ("gather", "regs")
REGS_ROW_TILE = 64
REGS_GRID = 8
REGS_MIN_ROWS = 64
REGS_MIN_COLS = 64


def b1_loop(rows: int, o: int, spec: ASPQuantSpec) -> tuple:
    """B1's band loop and row tile for a call of ``rows`` (padded) rows
    over ``o`` logical output columns of grid ``spec``: ``("regs",
    REGS_ROW_TILE)`` where the register loop is the faster, else
    ``("gather", None)`` (the plan's row tile).  A function of the call's
    shape alone; the live columns of a 128-column tile are ``min(o, 128)``."""
    if (spec.grid_size == REGS_GRID and rows >= REGS_MIN_ROWS
            and min(o, _BLOCK_COLS) >= REGS_MIN_COLS):
        return "regs", REGS_ROW_TILE
    return "gather", None


def _requant_consts(lp: LayerPlan) -> tuple:
    """(half_span, mid, lo, 1/code_step, num_codes) of the next layer's
    input grid, each rounded to f32 as the reference's weak typing does."""
    nxt = lp.next_spec
    return (f32(0.5 * (nxt.hi - nxt.lo)), f32(0.5 * (nxt.hi + nxt.lo)),
            f32(nxt.lo), f32(1.0 / nxt.code_step), nxt.num_codes)


def _check_layer_inputs(codes, xraw, lw, lp, bp, psum_noise) -> None:
    nb = lp.spec.num_basis
    dev = codes.device

    def want(name, t, shape, dtype):
        if t is None:
            raise ValueError(f"{name} is required for this layer")
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"{name}: got {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"want {shape} {dtype} on {dev}"
            )

    want("codes", codes, (bp, lp.fp), torch.int32)
    if lp.residual_raw:
        want("xraw", xraw, (bp, lp.fp), torch.float32)
    kk = lp.spec.order + 1
    if "lutp" in lw:
        want("lutp", lw["lutp"], (lp.spec.codes_per_interval, (kk + 1) // 2),
             torch.int8)
    else:
        want("lut", lw["lut"], (lp.spec.codes_per_interval, kk), torch.float32)
    if "wcp" in lw:
        want("wcp", lw["wcp"], (lp.fp * nb // 2, lp.op), torch.int8)
        want("wscale", lw["wscale"], (1, lp.op), torch.float32)
    else:
        want("wc", lw["wc"], (lp.fp * nb, lp.op), torch.float32)
    want("wb", lw["wb"], (lp.fp, lp.op), torch.float32)
    if psum_noise is not None:
        want("psum_noise", psum_noise, (bp, lp.op), torch.float32)


def run_pipeline_layer_plain(codes, xraw, lw: dict, lp: LayerPlan, bp: int,
                             *, psum_noise=None, feature_splits: int = 1):
    """Plain PyTorch version of kernel B1, in the reference kernel's op order.

    Dense SH-LUT basis -> banded matmul -> + relu(resid) @ wb, each of the
    ``feature_splits`` feature slices (:func:`feature_split_bounds`) on its
    own and the slices added in order -> + noise -> (not last layer) tanh
    rescale and ASP re-coding.  Returns (y, codes or None), both (bp, op).
    """
    spec = lp.spec
    nb = spec.num_basis
    lut = unpack_lut(lw["lutp"], spec) if "lutp" in lw else lw["lut"]
    basis = dense_basis_from_codes(codes, lut.to(torch.float32), spec)
    wc = unpacked_wc(lw, lp)
    if lp.residual_raw:
        resid = xraw.to(torch.float32)
    else:
        resid = f32(spec.lo) + codes.to(torch.float32) * f32(spec.code_step)
    relu = torch.clamp_min(resid, 0.0)
    wb = lw["wb"].to(torch.float32)
    acc = None
    for lo, hi in feature_split_bounds(lp.f, lp.fp, feature_splits):
        part = (basis[:, lo:hi].reshape(bp, (hi - lo) * nb) @ wc[lo * nb:hi * nb]
                + relu[:, lo:hi] @ wb[lo:hi])
        acc = part if acc is None else acc + part
    y = acc + psum_noise if psum_noise is not None else acc
    if not lp.emit_codes:
        return y, None
    half_span, mid, lo, scale, num_codes = _requant_consts(lp)
    h = torch.tanh(y) * half_span + mid
    q = torch.floor((h - lo) * scale + 0.5).to(torch.int32)
    return y, torch.clamp(q, 0, num_codes - 1)


def _run_pipeline_layer_cuda(codes, xraw, lw, lp, bp, psum_noise, row_tile,
                             splits, loop=None):
    spec = lp.spec
    cuda.check_spec(spec)
    if loop is None:
        loop, tile = b1_loop(bp, lp.o, spec)
        row_tile = tile or row_tile
    lib = cuda.library()
    dev = codes.device
    y = torch.empty((bp, lp.op), dtype=torch.float32, device=dev)
    codes_out = (torch.empty((bp, lp.op), dtype=torch.int32, device=dev)
                 if lp.emit_codes else None)
    nx = _requant_consts(lp) if lp.emit_codes else (0.0, 0.0, 0.0, 0.0, 0)
    packed_lut = "lutp" in lw
    packed_w = "wcp" in lw
    fps = -(-lp.f // splits)
    ws = (torch.empty((splits, bp, lp.op), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    status = lib.kan_pipeline_layer(
        cuda.ptr(codes), cuda.ptr(xraw if lp.residual_raw else None),
        cuda.ptr(None if packed_lut else lw["lut"]),
        cuda.ptr(lw["lutp"] if packed_lut else None),
        cuda.ptr(None if packed_w else lw["wc"]),
        cuda.ptr(lw["wcp"] if packed_w else None),
        cuda.ptr(lw["wscale"] if packed_w else None),
        cuda.ptr(lw["wb"]), cuda.ptr(psum_noise), cuda.ptr(y),
        cuda.ptr(codes_out), cuda.ptr(ws),
        bp, lp.fp, lp.op, lp.f, lp.o, spec.num_basis, spec.order + 1,
        spec.ld, splits, fps, row_tile, B1_LOOPS.index(loop), f32(spec.lo),
        f32(spec.code_step), f32(lut_scale(spec)), *nx,
        *cuda.stream_args(dev),
    )
    cuda.check(status)
    cuda.LAUNCHES["kan_pipeline_layer"] += 1
    if psum_noise is not None:
        cuda.LAUNCHES["kan_pipeline_layer.noise"] += 1
    if loop == "regs":
        cuda.LAUNCHES["kan_pipeline_layer.regs"] += 1
    return y, codes_out


def run_pipeline_layer(codes, xraw, lw: dict, lp: LayerPlan, bp: int, *,
                       psum_noise=None, row_tile: int = ROW_TILES[-1],
                       feature_splits: int | None = None):
    """One fused layer on padded geometry: kernel B1 for CUDA tensors, the
    plain version for CPU tensors.

    codes (bp, fp) int32; xraw (bp, fp) f32 when ``lp.residual_raw``; ``lw``
    the deployed layer dict (packing follows its keys); psum_noise (bp, op)
    f32 or None; ``row_tile`` B1's batch rows per block (one of
    :data:`ROW_TILES`; the plain version has no tiles); ``feature_splits``
    the contraction's split count, by default ``feature_split_plan(lp.f,
    lp.o)``'s.  A model shard passes the GLOBAL layer's count, so each of
    its columns sums in the unsharded order.  Returns (y (bp, op) f32, next
    codes (bp, op) int32 or None on the last layer).
    """
    return _run_layer(codes, xraw, lw, lp, bp, psum_noise, row_tile,
                      feature_splits, None)


def _run_layer(codes, xraw, lw, lp, bp, psum_noise, row_tile, feature_splits,
               loop):
    """:func:`run_pipeline_layer` with B1's band loop given (``loop`` one
    of :data:`B1_LOOPS` at ``row_tile``) or, for None, chosen by
    :func:`b1_loop`.  The card checks force each loop through here."""
    if feature_splits is None:
        feature_splits = feature_split_plan(lp.f, lp.o)[0]
    if loop == "regs":
        if row_tile != REGS_ROW_TILE or lp.spec.grid_size != REGS_GRID:
            raise ValueError(f"B1's register loop runs G={REGS_GRID} at row "
                             f"tile {REGS_ROW_TILE}, not G="
                             f"{lp.spec.grid_size} at {row_tile}")
    elif loop not in (None, "gather"):
        raise ValueError(f"B1 loop {loop!r} not in {B1_LOOPS}")
    elif row_tile not in ROW_TILES:
        raise ValueError(f"row tile {row_tile} not in {ROW_TILES}")
    tensors = [codes, xraw, psum_noise, *lw.values()]
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"layer operands span devices {sorted(map(str, devices))}")
    _check_layer_inputs(codes, xraw, lw, lp, bp, psum_noise)
    if codes.is_cuda:
        return _run_pipeline_layer_cuda(
            codes.contiguous(),
            xraw.contiguous() if lp.residual_raw else None,
            {k: v.contiguous() for k, v in lw.items()}, lp, bp,
            None if psum_noise is None else psum_noise.contiguous(),
            row_tile, feature_splits, loop,
        )
    return run_pipeline_layer_plain(
        codes, xraw, lw, lp, bp, psum_noise=psum_noise,
        feature_splits=feature_splits)


# ----------------------------------------------------------------------------
# The multi-layer executor
# ----------------------------------------------------------------------------


def kan_pipeline_impl(codes, xraw, layers: tuple, plan: PipelinePlan, *,
                      psum_noises: tuple | None = None,
                      row_gains: tuple | None = None,
                      return_intermediates: bool = False):
    """Run the whole stack: pad once, one fused layer each, slice back.

    codes (B, F0) int32 entry codes; xraw (B, F0) f32 (residual_raw only);
    psum_noises: per-layer (Bp, Op) f32 partial-sum noise or None (the
    acim backend's hook; added to each layer's MAC before its requantizer);
    row_gains: per-layer (Fp*NB, 1) f32 IR-drop row gains or None (the
    acim backend's other hook): each gained layer is formed just before
    its launch, so one gained copy of the weights is alive at a time.
    Returns y (B, O_last) and, with ``return_intermediates``, the int32
    boundary codes each layer handed to the next (logical shapes).
    """
    lp0 = plan.layers[0]
    b = codes.shape[0]
    if b != plan.b:
        raise ValueError(f"batch {b} != plan batch {plan.b}")
    h_codes = F.pad(codes, (0, lp0.fp - lp0.f, 0, plan.bp - b))
    h_raw = None
    if lp0.residual_raw:
        # padded raw lanes are zero: relu(0) @ zero-padded wb rows == 0
        h_raw = F.pad(xraw.to(torch.float32),
                      (0, lp0.fp - lp0.f, 0, plan.bp - b))
    y = None
    boundary = []
    for li, (lp, lw) in enumerate(zip(plan.layers, layers)):
        if row_gains is not None:
            lw = gained_layer(lw, lp, row_gains[li])
        y, nxt_codes = run_pipeline_layer(
            h_codes, h_raw if lp.residual_raw else None, lw, lp, plan.bp,
            psum_noise=None if psum_noises is None else psum_noises[li],
            row_tile=plan.row_tile)
        if nxt_codes is not None:
            boundary.append(nxt_codes[: plan.b, : lp.o])
        h_codes, h_raw = nxt_codes, y
    out = y[: plan.b, : plan.layers[-1].o]
    if return_intermediates:
        return out, tuple(boundary)
    return out
