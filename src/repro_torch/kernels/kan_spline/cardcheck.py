"""Kernels B1 and B3 held against their plain versions on the card.

The one definition of the card check, shared by ``chip_smoke.py`` (phase 3)
and ``tests/test_torch_gpu.py``.  Each check draws random operands from a
seeded ``torch.Generator`` on the card, runs the kernel and its plain
PyTorch version on the same tensors, and raises on disagreement:

  * outputs within ``ATOL + RTOL * |plain|`` (the same f32 terms summed in
    another order differ by a few ulps);
  * boundary codes equal up to the excused near-ties of
    :mod:`repro_torch.parity`;
  * packed and unpacked B1 weights / SH-LUT bit-identical;
  * each kernel call adds exactly one to its launch counter (also when the
    call splits the feature axis and runs the merge kernel too).

The plain version runs with the kernel's feature split count
(``pipeline.feature_split_plan``).  Three checks hold what the split design
promises: :func:`check_b1_rows_independent` (a row's y and codes are the
same bits at 8 rows as at 1024), ``B1_FFN_PACKED`` (packed == unpacked at a
full-width half with feature splits > 1) and
:func:`check_b1_padded_columns` (a noisy layer's padded columns are
y = noise exactly and the requantized code of it).  A fourth holds what the
row tile promises: :func:`check_b1_row_tiles` (the same bits at 16, 32 and
64 rows per block).  A fifth holds what a model shard promises:
:func:`check_b1_column_slabs` (each column slab of a layer, run at the
whole layer's feature split, gives those columns' bits).  A sixth holds
what B1's two band loops promise: :func:`check_b1_loops` (the register
loop gives the gather's bits, each forced through the launch code's
test-only entry ``pipeline._run_layer``).
"""

from __future__ import annotations

import itertools

import torch

from ... import parity
from ...core.asp_quant import ASPQuantSpec, build_lut
from .. import cuda
from . import pipeline as pl
from .ops import kan_spline
from .ref import kan_spline_ref

__all__ = ["ATOL", "RTOL", "ORDERS", "B1_GEOMETRIES", "B1_FLAGS",
           "B1_FFN_FULL", "B1_FFN_GEMMA2", "B1_FFN_RGEMMA", "B1_FFN_WHISPER",
           "B1_FFN_PIXTRAL", "B1_FFN_DRAFT",
           "B1_FFN_PACKED", "FFN_FULL_TIE_EPS", "B3_SHAPES",
           "B1_ROW_TILE_CASES", "ROW_TILE_ROWS", "B1_COLUMN_SLAB_CASES",
           "B1_LOOP_CASES", "b1_case", "check_b1", "check_b1_rows_independent",
           "check_b1_padded_columns", "check_b1_row_tiles",
           "check_b1_column_slabs", "check_b1_loops", "check_b3"]

ATOL = RTOL = 1e-5
# every spline order the kernel library has an instance for (K+1 = 2..6)
ORDERS = (1, 2, 3, 4, 5)
# (grid, f, o): both layers of KAN1 (G=5), KAN2 (G=68) and the FFN stack
B1_GEOMETRIES = ((5, 17, 1), (5, 1, 14), (68, 17, 1), (68, 1, 14),
                 (8, 64, 128), (8, 128, 64))
# residual_raw x packed_w x packed_lut x psum_noise x emit_codes
B1_FLAGS = tuple(itertools.product((False, True), repeat=5))
# the two halves of the full-width qwen2.5-14b KAN-FFN (d_model 5120,
# hidden 1280, G=8, 8 bit) with their serving flags (raw residual; the
# first half re-codes for the second), at the decode bucket (8 rows) and a
# full prefill bucket (1024 rows): (grid, f, o, flags, rows)
B1_FFN_FULL = tuple(
    (8, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((5120, 1280, True), (1280, 5120, False))
    for rows in (8, 1024))
# the two halves of the full-width gemma2-27b kan_variant() KAN-FFN
# (d_model 4608, hidden 36864 // 11 = 3351 rounded up to 3456, G=8) with
# the same serving flags, at the decode bucket and a prefill bucket:
# (grid, f, o, flags, rows)
B1_FFN_GEMMA2 = tuple(
    (8, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((4608, 3456, True), (3456, 4608, False))
    for rows in (8, 1024))
# the two halves of the full-width recurrentgemma-9b kan_variant() KAN-FFN
# (d_model 4096, hidden 12288 // 11 = 1117 rounded up to 1152, G=8), every
# layer's FFN (RG-LRU and local alike), at the decode bucket and the
# bucket of a 2300-token prompt: (grid, f, o, flags, rows)
B1_FFN_RGEMMA = tuple(
    (8, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((4096, 1152, True), (1152, 4096, False))
    for rows in (8, 4096))
# the two halves of the full-width whisper-base kan_variant() KAN-FFN
# (d_model 512, hidden 2048 // 11 = 186 rounded up to 256, G=8), in the
# encoder and the decoder, at the bucket of a 4-clip decode step (4 rows:
# 8) and of the encoder's 4 x 1500 frames (8192): (grid, f, o, flags, rows)
B1_FFN_WHISPER = tuple(
    (8, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((512, 256, True), (256, 512, False))
    for rows in (8, 8192))
# and of pixtral-12b's (d_model 5120, hidden 14336 // 11 = 1303 rounded up
# to 1408), at the decode bucket and that of a 1256-row prefill (256
# patches and a 1000-token prompt: 2048)
B1_FFN_PIXTRAL = tuple(
    (8, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((5120, 1408, True), (1408, 5120, False))
    for rows in (8, 2048))
# the same halves at the speculative drafter's default spec (G=4, K=3: 7
# basis functions instead of 11), at the executor's row buckets of a
# 4-slot decode (8) and of 20 rows (32: 4 slots x k+1 = 5 verify rows, and
# a drafter prefill bucket): (grid, f, o, flags, rows)
B1_FFN_DRAFT = tuple(
    (4, f, o, (True, False, False, False, emit), rows)
    for f, o, emit in ((5120, 1280, True), (1280, 5120, False))
    for rows in (8, 32))
# int4-packed weights (and a packed SH-LUT, with noise) at a full-width
# half, where the kernel splits the feature axis: (grid, f, o, flags, rows)
B1_FFN_PACKED = ((8, 5120, 1280, (True, True, True, True, True), 8),
                 (8, 1280, 5120, (True, True, False, False, False), 64))
# The excuse window of those halves' boundary codes.  Their outputs sum
# K+2 f32 terms over 5120 (or 1280) inputs, so the summation-order error of
# y is several times that of the f <= 128 layers above, and the
# requantizer's pre-round value moves by up to 1/code_step (128 at 8 bits,
# on tanh's [-1, 1]) per unit of y: a code may differ by one wherever the
# output tolerance ATOL can carry the pre-round value across an integer,
# 128 * 1e-5 = 1.28e-3 (the default window, 1e-4, stays for every other
# check).
FFN_FULL_TIE_EPS = ATOL / ASPQuantSpec(grid_size=8).code_step
# the row-tile check: both layers of KAN1 and KAN2 (codes out of the first),
# the mixed (8, 4) KAN1's int4-packed layer (packed weights and SH-LUT),
# and one full-width FFN half with its serving flags: (name, grid, f, o,
# flags), each at ROW_TILE_ROWS rows (a decode bucket, a ragged batch, the
# slice's largest request)
B1_ROW_TILE_CASES = (
    ("kan1.0", 5, 17, 1, (False, False, False, False, True)),
    ("kan1.1", 5, 1, 14, (False, False, False, False, False)),
    ("kan2.0", 68, 17, 1, (False, False, False, False, True)),
    ("kan2.1", 68, 1, 14, (False, False, False, False, False)),
    ("kan1_mixed.1", 5, 1, 14, (False, True, True, False, False)),
    ("ffn_5120x1280", 8, 5120, 1280, (True, False, False, False, True)),
)
ROW_TILE_ROWS = (8, 1000, 65536)
# a model shard's column slabs of gemma2-27b's full-width KAN-FFN halves,
# whose local width picks another feature split than the whole layer's
# (18 / 14 at model 2 against 10 / 8), at the decode bucket and a prefill
# bucket: (grid, f, o, flags, rows, model)
B1_COLUMN_SLAB_CASES = tuple(
    (8, f, o, (True, False, False, False, emit), rows, model)
    for f, o, emit in ((4608, 3456, True), (3456, 4608, False))
    for rows in (8, 1024) for model in (2, 4))
# B1's register loop against its gather (G = 8): (name, f, o, flags, rows,
# order).  Both full-width qwen2.5-14b halves with their serving flags at a
# reason decode bucket, a ragged last tile and rag's prefill buckets; every
# spline order of the kernel library (K+1 = 2..6) at a ragged 1000 rows;
# int4-packed weights and SH-LUT with noise and the requantizer, and the
# unpacked noisy half; one gemma2 half; both whisper halves, whose 256 ->
# 512 half runs one feature split (every other case splits)
B1_LOOP_CASES = (
    tuple((f"ffn_{f}x{o}", f, o, (True, False, False, False, emit), rows, 3)
          for f, o, emit in ((5120, 1280, True), (1280, 5120, False))
          for rows in (256, 1000, 1024, 2048, 4096))
    + tuple((f"order{k}", 5120, 1280, (True, False, False, False, True),
             1000, k) for k in ORDERS)
    + (("packed_noise", 5120, 1280, (True, True, True, True, True), 1000, 3),
       ("packed_w", 1280, 5120, (True, True, False, False, False), 512, 3),
       ("noise", 1280, 5120, (False, False, False, True, True), 333, 2),
       ("gemma2_4608x3456", 4608, 3456, (True, False, False, False, True),
        1024, 3),
       ("whisper_512x256", 512, 256, (True, False, False, False, True),
        8192, 3),
       ("whisper_256x512", 256, 512, (True, False, False, False, False),
        8192, 3)))
# (b, f, o, grid): ragged shapes, then KAN1's two layers at full batch
B3_SHAPES = ((33, 17, 14, 5), (1, 1, 1, 64), (130, 300, 200, 16),
             (7, 5, 3, 8), (65536, 17, 1, 5), (65536, 1, 14, 68))


def b1_case(dev, gen, grid, f, o, flags, bp, order=3):
    """Random operands of one B1 call at init-scale weights (|w| <=
    0.3/sqrt(f)), so outputs stay O(1) and the code gate's window holds.

    Returns ``(lp, lw, unpacked, codes, xraw, noise)``: ``lw`` is in the
    form ``flags`` ask for, ``unpacked`` the same weights as f32."""
    raw, pw, plut, noise, emit = flags
    spec = ASPQuantSpec(grid_size=grid, order=order, lut_bits=4 if plut else 8)
    dims = (f, o, 3) if emit else (f, o)
    lp = pl.make_pipeline_plan(bp, dims, (spec,) * (len(dims) - 1),
                               residual_raw=raw).layers[0]
    nb = spec.num_basis
    e = build_lut(spec)
    lut = (torch.tensor(e["lut_q"], dtype=torch.float32)
           * torch.tensor(e["scale"], dtype=torch.float32)).to(dev)
    c_q = torch.randint(-7, 8, (f, nb, o), generator=gen, device=dev).to(torch.int8)
    c_scale = (torch.rand(o, generator=gen, device=dev) + 0.5) * (0.3 / f**0.5 / 7)
    wb = torch.randn(f, o, generator=gen, device=dev) / f**0.5
    packed = pl.pack_layer_weights(c_q, c_scale, wb, lp)
    unpacked = {"lut": lut, "wc": pl.unpacked_wc(packed, lp).contiguous(),
                "wb": packed["wb"]}
    lw = {"lut": lut, **packed} if pw else dict(unpacked)
    if plut:
        lw["lutp"] = pl.pack_lut(torch.tensor(e["lut_q"], device=dev), spec)
    codes = torch.randint(0, spec.num_codes, (bp, lp.fp), generator=gen,
                          device=dev, dtype=torch.int32)
    xraw = torch.randn(bp, lp.fp, generator=gen, device=dev) if raw else None
    nz = torch.randn(bp, lp.op, generator=gen, device=dev) * 0.01 if noise else None
    return lp, lw, unpacked, codes, xraw, nz


def check_b1(dev, gen, grid, f, o, flags, bp, order=3,
             eps: float = 1e-4) -> dict:
    """One B1 case, kernel against plain; returns ``{"max_abs_err",
    "excused"}``.  ``eps``: the boundary codes' excuse window
    (:func:`repro_torch.parity.compare_runs`)."""
    lp, lw, unpacked, codes, xraw, nz = b1_case(dev, gen, grid, f, o, flags,
                                                bp, order)
    case = (grid, f, o, order, flags)
    before = cuda.launch_counts().get("kan_pipeline_layer", 0)
    y, c = pl.run_pipeline_layer(codes, xraw, lw, lp, bp, psum_noise=nz)
    if cuda.launch_counts()["kan_pipeline_layer"] != before + 1:
        raise AssertionError(f"B1 {case}: launch not counted once")
    py, pc = pl.run_pipeline_layer_plain(
        codes, xraw, lw, lp, bp, psum_noise=nz,
        feature_splits=pl.feature_split_plan(lp.f, lp.o)[0])
    torch.cuda.synchronize()
    if c is None:
        err = (y - py).abs()
        if not bool((err <= ATOL + RTOL * py.abs()).all()):
            raise AssertionError(f"B1 {case}: max err {err.max().item()}")
        st = {"max_abs_err": err.max().item(), "excused": 0}
    else:
        st = parity.compare_runs([c], [pc],
                                 [parity.requant_preround(py, lp.next_spec)],
                                 y, py, atol=ATOL, rtol=RTOL, eps=eps)
    if lw is not unpacked and ("wcp" in lw or "lutp" in lw):
        uy, uc = pl.run_pipeline_layer(codes, xraw, unpacked, lp, bp,
                                       psum_noise=nz)
        if not (torch.equal(uy, y) and (c is None or torch.equal(uc, c))):
            raise AssertionError(f"B1 {case}: packed != unpacked")
    return {"max_abs_err": st["max_abs_err"], "excused": st["excused"]}


def check_b1_rows_independent(dev, gen, grid: int = 8, f: int = 5120,
                              o: int = 1280, rows=(8, 1024)) -> dict:
    """The same rows at two batch sizes give the same bits: the first
    ``rows[0]`` rows of a ``rows[1]``-row call (raw residual, codes out)
    equal a call on those rows alone, y and codes.  Returns
    ``{"rows", "feature_splits", "equal"}``; raises if they differ."""
    small, big = rows
    lp, lw, _, codes, xraw, _ = b1_case(dev, gen, grid, f, o,
                                        (True, False, False, False, True), big)
    yb, cb = pl.run_pipeline_layer(codes, xraw, lw, lp, big)
    ys, cs = pl.run_pipeline_layer(codes[:small].contiguous(),
                                   xraw[:small].contiguous(), lw, lp, small)
    torch.cuda.synchronize()
    if not (torch.equal(yb[:small], ys) and torch.equal(cb[:small], cs)):
        diff = (yb[:small] - ys).abs().max().item()
        raise AssertionError(f"B1 {f}x{o}: rows differ between {small} and "
                             f"{big} rows (max |dy| {diff:.3e})")
    return {"rows": list(rows),
            "feature_splits": pl.feature_split_plan(lp.f, lp.o)[0],
            "equal": True}


def check_b1_padded_columns(dev, gen, grid: int = 5, bp: int = 512) -> dict:
    """A noisy 1 -> 14 layer with codes out: its padded columns 14..127
    are y = noise bit for bit, and their codes the requantizer's code of
    that y (exact except at an excused near-tie of the pre-round value).
    Returns ``{"columns", "excused"}``."""
    lp, lw, _, codes, xraw, nz = b1_case(dev, gen, grid, 1, 14,
                                         (False, False, False, True, True), bp)
    y, c = pl.run_pipeline_layer(codes, xraw, lw, lp, bp, psum_noise=nz)
    torch.cuda.synchronize()
    pad = slice(lp.o, lp.op)
    if not torch.equal(y[:, pad], nz[:, pad]):
        raise AssertionError("B1: padded columns are not y = noise")
    pre = torch.as_tensor(parity.requant_preround(nz[:, pad], lp.next_spec))
    want = torch.clamp(torch.floor(pre), 0, lp.next_spec.num_codes - 1)
    got = c[:, pad].cpu().to(torch.float64)
    off = got != want
    near = (pre - torch.round(pre)).abs() < 1e-4
    if bool((off & ~near).any()):
        raise AssertionError("B1: padded columns' codes are not the "
                             "requantized noise")
    return {"columns": lp.op - lp.o, "excused": int(off.sum())}


def check_b1_row_tiles(dev, gen, grid, f, o, flags, rows) -> dict:
    """B1 at row tiles 16 and 32 gives the bits of the default 64: y and
    codes, on one set of operands (``flags`` as in :func:`b1_case`), in the
    gather loop, whose knob the row tile is (forced, also where the launch
    code would take the register loop).  Returns ``{"rows", "tiles",
    "equal"}``; raises if any bit differs."""
    lp, lw, _, codes, xraw, nz = b1_case(dev, gen, grid, f, o, flags, rows)

    def gather(tile):
        return pl._run_layer(codes, xraw, lw, lp, rows, nz, tile, None,
                             "gather")

    want_y, want_c = gather(pl.ROW_TILES[-1])
    for tile in pl.ROW_TILES[:-1]:
        y, c = gather(tile)
        torch.cuda.synchronize()
        if not (torch.equal(y, want_y)
                and (c is None or torch.equal(c, want_c))):
            diff = (y - want_y).abs().max().item()
            raise AssertionError(f"B1 {grid, f, o, flags} at {rows} rows: "
                                 f"row tile {tile} differs from 64 (max "
                                 f"|dy| {diff:.3e})")
    return {"rows": rows, "tiles": list(pl.ROW_TILES), "equal": True}


def check_b1_column_slabs(dev, gen, grid, f, o, flags, rows,
                          model: int) -> dict:
    """A model shard's B1 launches: each of the ``model`` column slabs of
    one layer, on its local plan (``pipeline.shard_local_plan``) and at the
    WHOLE layer's feature split count, gives those columns of the whole
    layer's launch bit for bit, y and codes (``flags`` as in
    :func:`b1_case`, unpacked weights).  Returns ``{"model", "splits",
    "local_plan_splits", "equal"}``; raises if any bit differs."""
    raw, packed_w, _, _, emit = flags
    if packed_w:
        raise ValueError("column slabs of int4-packed weights: not a case")
    lp, lw, _, codes, xraw, nz = b1_case(dev, gen, grid, f, o, flags, rows)
    dims = (f, o, 3) if emit else (f, o)
    plan = pl.make_pipeline_plan(rows, dims, (lp.spec,) * (len(dims) - 1),
                                 residual_raw=raw)
    local = pl.shard_local_plan(plan, model)[0].layers[0]
    splits = pl.feature_split_plan(lp.f, lp.o)[0]
    y, c = pl.run_pipeline_layer(codes, xraw, lw, lp, rows, psum_noise=nz)
    for mi in range(model):
        cols = slice(mi * local.op, (mi + 1) * local.op)
        slab = {k: v[:, cols].contiguous() if k in ("wc", "wb") else v
                for k, v in lw.items()}
        ys, cs = pl.run_pipeline_layer(
            codes, xraw, slab, local, rows,
            psum_noise=None if nz is None else nz[:, cols].contiguous(),
            feature_splits=splits)
        torch.cuda.synchronize()
        if not (torch.equal(ys, y[:, cols])
                and (c is None or torch.equal(cs, c[:, cols]))):
            diff = (ys - y[:, cols]).abs().max().item()
            raise AssertionError(f"B1 {f}x{o} at {rows} rows: column slab "
                                 f"{mi} of {model} differs from the whole "
                                 f"layer's (max |dy| {diff:.3e})")
    return {"model": model, "splits": splits,
            "local_plan_splits": pl.feature_split_plan(local.f, local.o)[0],
            "equal": True}


def check_b1_loops(dev, gen, f, o, flags, rows, order=3) -> dict:
    """B1's register loop gives the bits of its gather loop at a G = 8
    layer: y and codes, on one set of operands (``flags`` as in
    :func:`b1_case`), each loop forced through the launch code's test-only
    entry, and each launch counted once (the register loop's also under
    ``kan_pipeline_layer.regs``).  Returns ``{"rows", "feature_splits",
    "rule", "equal"}``, ``rule`` the loop :func:`pipeline.b1_loop` takes at
    this shape; raises if any bit differs."""
    lp, lw, _, codes, xraw, nz = b1_case(dev, gen, pl.REGS_GRID, f, o, flags,
                                         rows, order)
    splits = pl.feature_split_plan(lp.f, lp.o)[0]
    case = (f, o, order, flags, rows)
    before = cuda.launch_counts()
    want_y, want_c = pl._run_layer(codes, xraw, lw, lp, rows, nz,
                                   pl.ROW_TILES[-1], splits, "gather")
    y, c = pl._run_layer(codes, xraw, lw, lp, rows, nz, pl.REGS_ROW_TILE,
                         splits, "regs")
    torch.cuda.synchronize()
    after = cuda.launch_counts()
    for key, n in (("kan_pipeline_layer", 2), ("kan_pipeline_layer.regs", 1)):
        if after.get(key, 0) != before.get(key, 0) + n:
            raise AssertionError(f"B1 loops {case}: {key} not counted {n}x")
    if not (torch.equal(y, want_y) and (c is None or torch.equal(c, want_c))):
        diff = (y - want_y).abs().max().item()
        raise AssertionError(f"B1 loops {case}: the register loop differs "
                             f"from the gather (max |dy| {diff:.3e})")
    return {"rows": rows, "feature_splits": splits,
            "rule": pl.b1_loop(rows, lp.o, lp.spec)[0], "equal": True}


# B1's grouped launch at a MoE layer's KAN experts (moonlight-16b-a3b's
# kan_variant(): 2048 -> 128 -> 2048 at G = 8): (name, f, o, emit, mean
# rows an expert): decode's ~24 rows (256 tokens x 6 / 64 experts) and a
# prefill's ~190 (2048 x 6 / 64)
B1_GROUPED_CASES = tuple(
    (f"{f}x{o}_{r}", f, o, emit, r)
    for f, o, emit in ((2048, 128, True), (128, 2048, False))
    for r in (24, 190))


def check_b1_grouped(dev, gen, f, o, emit, mean_rows, experts=64) -> dict:
    """B1's grouped launch over ``experts`` networks of one geometry gives
    the bits, y and codes, of one B1 launch per network on its own rows
    (whose loop follows its own row count), with empty segments (every
    fifth expert) and segment sizes drawn around ``mean_rows``; and each
    segment agrees with the plain version under :func:`check_b1`'s gate,
    whose excuse window for the codes is the y tolerance times the
    requantizer's steepest slope (at 2048 features a code 1e-4 from a tie
    moves with a few f32 ulps of y).
    Returns ``{"rows", "rule", "empty", "equal", "max_abs_err",
    "excused"}`` (the last two: against the plain version); raises where a
    bit differs or the gate fails."""
    spec = ASPQuantSpec(grid_size=8, order=3)
    dims = (f, o, 3) if emit else (f, o)
    lp = pl.make_pipeline_plan(8, dims, (spec,) * (len(dims) - 1),
                               residual_raw=True).layers[0]
    sizes = torch.randint(1, 2 * mean_rows, (experts,), generator=gen,
                          device=dev)
    sizes[::5] = 0
    seg = torch.zeros(experts + 1, dtype=torch.int32, device=dev)
    seg[1:] = torch.cumsum(sizes, 0)
    n = int(seg[-1])
    layers = []
    for _ in range(experts):
        _, lw, _, _, _, _ = b1_case(dev, gen, 8, f, o,
                                    (True, False, False, False, emit), 8)
        layers.append(lw)
    stacked = {k: torch.stack([lw[k] for lw in layers])
               for k in ("lut", "wc", "wb")}
    codes = torch.randint(0, spec.num_codes, (n, lp.fp), generator=gen,
                          device=dev, dtype=torch.int32)
    xraw = torch.randn(n, lp.fp, generator=gen, device=dev)
    before = cuda.launch_counts().get("kan_pipeline_layer.grouped", 0)
    y, c = pl.run_pipeline_layer_grouped(codes, xraw, stacked, lp, seg)
    if (dev.type == "cuda" and cuda.launch_counts()[
            "kan_pipeline_layer.grouped"] != before + 1):
        raise AssertionError("grouped B1: launch not counted once")
    bounds = seg.tolist()
    splits = pl.feature_split_plan(lp.f, lp.o)[0]
    err, excused = 0.0, 0
    for e in range(experts):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        ye, ce = pl.run_pipeline_layer(codes[lo:hi], xraw[lo:hi], layers[e],
                                       lp, hi - lo)
        if not (torch.equal(ye, y[lo:hi])
                and (ce is None or torch.equal(ce, c[lo:hi]))):
            diff = (ye - y[lo:hi]).abs().max().item()
            raise AssertionError(f"grouped B1 {f}x{o}: expert {e} differs "
                                 f"from its own launch (max |dy| {diff:.3e})")
        py, pc = pl.run_pipeline_layer_plain(codes[lo:hi], xraw[lo:hi],
                                             layers[e], lp, hi - lo,
                                             feature_splits=splits)
        if c is None:
            d = (y[lo:hi] - py).abs()
            if not bool((d <= ATOL + RTOL * py.abs()).all()):
                raise AssertionError(f"grouped B1 {f}x{o}: expert {e}: max "
                                     f"err {d.max().item()} against plain")
            err = max(err, d.max().item())
        else:
            # a code may round the other way wherever the y gate's own
            # slack, times the requantizer's steepest slope, reaches a tie
            nxt = lp.next_spec
            eps = (ATOL + RTOL * py.abs().max().item()) \
                * 0.5 * (nxt.hi - nxt.lo) / nxt.code_step
            st = parity.compare_runs(
                [c[lo:hi]], [pc], [parity.requant_preround(py, nxt)],
                y[lo:hi], py, atol=ATOL, rtol=RTOL, eps=max(eps, 1e-4))
            err = max(err, st["max_abs_err"])
            excused += st["excused"]
    return {"rows": n, "empty": int((sizes == 0).sum()),
            "rule": pl.grouped_b1_loop(n, experts, lp.o, spec)[0],
            "equal": True, "max_abs_err": err, "excused": excused}


def check_b3(dev, gen, b, f, o, grid, order=3) -> float:
    """One B3 case, kernel against plain; returns the max abs error."""
    spec = ASPQuantSpec(grid_size=grid, order=order)
    e = build_lut(spec)
    lut = torch.tensor(e["lut_q"] * e["scale"], dtype=torch.float32, device=dev)
    codes = torch.randint(0, spec.num_codes, (b, f), generator=gen,
                          device=dev, dtype=torch.int32)
    wc = torch.randn(f, spec.num_basis, o, generator=gen, device=dev) * (0.3 / f**0.5)
    wb = torch.randn(f, o, generator=gen, device=dev) / f**0.5
    before = cuda.launch_counts().get("kan_spline", 0)
    y = kan_spline(codes, lut, wc, wb, spec)
    if cuda.launch_counts()["kan_spline"] != before + 1:
        raise AssertionError(f"B3 {b, f, o, grid, order}: launch not counted once")
    py = kan_spline_ref(codes, lut, wc, wb, spec,
                        feature_splits=pl.feature_split_plan(f, o)[0])
    torch.cuda.synchronize()
    err = (y - py).abs()
    if not bool((err <= ATOL + RTOL * py.abs()).all()):
        raise AssertionError(f"B3 {b, f, o, grid, order}: max err {err.max().item()}")
    return err.max().item()
