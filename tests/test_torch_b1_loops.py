"""Kernel B1's band loops: the launch code's choice, on the CPU.

B1 has two band loops that give the same bits (``csrc/kan_spline.cu``,
"Design"): the gather and the register loop.  The launch code picks one by
the call's shape (``pipeline.b1_loop``).  Here, without a card:

  * the choice at the benchmark cells' shapes: rag's prefill buckets and
    reason's 256-row decode take the register loop at both full-width
    qwen2.5-14b KAN-FFN halves, 8-row decode and the knot table's G=5
    layers the gather;
  * the launch hands the chosen loop and its row tile to the library and
    counts it under ``kan_pipeline_layer.regs`` (a stand-in library records
    the call);
  * the test-only entry forces either loop and refuses what has no
    instance; on CPU tensors both run the plain version.

The loops' bits are held equal on the card (``test_torch_gpu.py``).
"""

import pytest
import torch

from repro_torch.core.asp_quant import ASPQuantSpec
from repro_torch.kernels import cuda
from repro_torch.kernels.kan_spline import cardcheck as cc
from repro_torch.kernels.kan_spline import pipeline as pl

torch.set_num_threads(1)

QWEN_HALVES = ((5120, 1280), (1280, 5120))
RAG_BUCKETS = (512, 1024, 2048, 4096)      # prompts of 512-4096 tokens
KNOT_BUCKETS = (16384, 32768, 65536, 131072, 262144)
G8, G5 = ASPQuantSpec(grid_size=8), ASPQuantSpec(grid_size=5)

# (name, rows, o, spec, loop): the three cells' B1 calls and the boundaries
RULE_CASES = (
    [(f"rag_{f}x{o}_{r}", r, o, G8, "regs")
     for f, o in QWEN_HALVES for r in RAG_BUCKETS]
    + [(f"reason_{f}x{o}_{r}", r, o, G8, loop)
       for f, o in QWEN_HALVES for r, loop in ((256, "regs"), (8, "gather"))]
    + [(f"knot_{o}_{r}", r, o, G5, "gather")
       for o in (1, 14) for r in KNOT_BUCKETS]
    + [("rows_below", pl.REGS_MIN_ROWS // 2, 1280, G8, "gather"),
       ("rows_at", pl.REGS_MIN_ROWS, 1280, G8, "regs"),
       ("cols_below", 4096, pl.REGS_MIN_COLS - 1, G8, "gather"),
       ("cols_at", 4096, pl.REGS_MIN_COLS, G8, "regs"),
       ("knot_g8_14", 65536, 14, G8, "gather"),
       ("drafter_g4", 4096, 1280, ASPQuantSpec(grid_size=4), "gather"),
       ("kan2_g68", 65536, 14, ASPQuantSpec(grid_size=68), "gather")])


@pytest.mark.parametrize("name,rows,o,spec,loop", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_b1_loop_follows_the_calls_shape(name, rows, o, spec, loop):
    got = pl.b1_loop(rows, o, spec)
    want_tile = pl.REGS_ROW_TILE if loop == "regs" else None
    assert got == (loop, want_tile)


class _Lib:
    """Stand-in kernel library: records kan_pipeline_layer's arguments."""

    def __init__(self):
        self.calls = []

    def kan_pipeline_layer(self, *args):
        self.calls.append(args)
        return 0


# the C signature's positions of row_tile and loop (cuda._SIGNATURES)
_ROW_TILE_AT, _LOOP_AT = 22, 23


@pytest.mark.parametrize("f,o,rows,loop", [
    (256, 512, 512, "regs"), (512, 256, 64, "regs"), (256, 512, 32, "gather"),
    (64, 14, 512, "gather")])
def test_launch_passes_the_loop_and_counts_the_register_loop(
        monkeypatch, f, o, rows, loop):
    lib = _Lib()
    monkeypatch.setattr(cuda, "library", lambda: lib)
    monkeypatch.setattr(cuda, "stream_args", lambda dev: (0, None))
    gen = torch.Generator().manual_seed(rows)
    lp, lw, _, codes, xraw, _ = cc.b1_case(
        "cpu", gen, 8, f, o, (True, False, False, False, True), rows)
    splits = pl.feature_split_plan(lp.f, lp.o)[0]
    before = cuda.launch_counts()
    pl._run_pipeline_layer_cuda(codes, xraw, lw, lp, rows, None,
                                pl.ROW_TILES[-1], splits)
    after = cuda.launch_counts()
    (args,) = lib.calls
    assert args[_LOOP_AT] == pl.B1_LOOPS.index(loop)
    assert args[_ROW_TILE_AT] == (pl.REGS_ROW_TILE if loop == "regs"
                                  else pl.ROW_TILES[-1])
    regs = "kan_pipeline_layer.regs"
    assert after["kan_pipeline_layer"] == before.get("kan_pipeline_layer", 0) + 1
    assert after.get(regs, 0) == before.get(regs, 0) + (loop == "regs")


def test_the_register_loop_key_is_documented():
    assert "kan_pipeline_layer.regs" in cuda.__doc__


def test_forced_loops_refuse_what_has_no_instance():
    gen = torch.Generator().manual_seed(0)
    lp, lw, _, codes, xraw, _ = cc.b1_case(
        "cpu", gen, 8, 64, 128, (True, False, False, False, True), 96)
    args = (codes, xraw, lw, lp, 96, None)
    with pytest.raises(ValueError, match="register loop"):
        pl._run_layer(*args, 32, None, "regs")
    with pytest.raises(ValueError, match="not in"):
        pl._run_layer(*args, 64, None, "rows")
    with pytest.raises(ValueError, match="row tile"):
        pl._run_layer(*args, 48, None, "gather")
    lp5, lw5, _, codes5, xraw5, _ = cc.b1_case(
        "cpu", gen, 5, 17, 1, (False, False, False, False, False), 96)
    with pytest.raises(ValueError, match="register loop"):
        pl._run_layer(codes5, None, lw5, lp5, 96, None, 64, None, "regs")


@pytest.mark.parametrize("loop,tile", [("gather", 16), ("regs", 64)])
def test_forced_loops_run_the_plain_version_on_cpu_tensors(loop, tile):
    gen = torch.Generator().manual_seed(1)
    lp, lw, _, codes, xraw, nz = cc.b1_case(
        "cpu", gen, 8, 64, 128, (True, False, False, True, True), 96)
    y, c = pl._run_layer(codes, xraw, lw, lp, 96, nz, tile, None, loop)
    wy, wc = pl.run_pipeline_layer_plain(
        codes, xraw, lw, lp, 96, psum_noise=nz,
        feature_splits=pl.feature_split_plan(lp.f, lp.o)[0])
    assert torch.equal(y, wy) and torch.equal(c, wc)
