#!/usr/bin/env python3
"""Build the PyTorch/CUDA port on one card and drive its main path.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card (sm_90a, the
H100) and ``nvcc``.  It imports nothing of JAX or of the reference package.

Phases (any failure exits non-zero):

  1. device report: name, count, ``nvidia-smi`` name and power limit; TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (seconds, ptxas)
     and, where the toolkit has ``cuobjdump``, count the tensor-core
     instructions (HMMA/HGMMA) of each kernel in the library's SASS (B2's
     bf16 instance must have some); ptxas must report no spill for B2's
     D = 256 tensor-core instance (``flash_kernel_mma<256>``) and for its
     latent decode instance (``flash_kernel_mla<576, 512>``);
  3. each kernel against its plain PyTorch version on the card
     (``repro_torch.kernels.kan_spline.cardcheck``): B1 in every flag
     combination at the KAN1 / KAN2 / FFN layer geometries (packed and
     unpacked B1 runs bit-identical), B3 on ragged shapes, both at every
     spline order 1..5 the kernel library is built for, and B1 at the
     full-width qwen2.5-14b KAN-FFN halves (G=8, and the speculative
     drafter's G=4), where the feature axis is
     split: packed == unpacked there, a row's bits equal at 8 and 1024
     rows, and a noisy layer's padded columns y = noise; B2 (flash
     attention, ``repro_torch.kernels.attention.cardcheck``) in f32 and bf16
     x kinds x GQA groups x head dims at odd lengths with fully masked rows,
     and its bf16 tensor-core instance with the KV axis split (decode,
     verify at S = 3 and 5, a masked split, rows masked in every split;
     recurrentgemma's D = 256 decode over 2048 and a ragged 2047 keys and
     a local window that masks most splits);
     B4 (the
     ACIM MAC, ``repro_torch.kernels.cim_mac.cardcheck``) on the reference's
     cases and ragged shapes under the reference's ADC contract, its
     zero-IR 24-bit case against the plain matmul, the wide path's
     R-chunks, ragged stream tiles, and 32-row slices whose bits equal
     the full call's;
  3b. the PACT baseline (``core.asp_quant``'s ``pact_quantize``,
     ``pact_dense_basis``) and ``quantized_dense_basis`` on the card
     against the CPU, bit for bit, at the CPU tests' twelve specs over
     inputs that hold every exact half step of the PACT grid and both
     clip edges, at the spec's clip and at 0.75 of it (plain PyTorch: the
     reference has no kernel there);
  4. the slice end to end: KAN1, KAN2, mixed (8, 4) KAN1 and the (64,128,64)
     G=8 FFN stack, initialized on the card, quantized and deployed, answer
     knot-surrogate requests of 1..65536 rows through ``runtime.execute``
     (default "fused" backend) and, for KAN1, the single-layer B3 path of the
     quickstart; every answer is held against the "ref" backend; the
     dispatch, launch and plan-cache counters are checked;
  5. CUDA-event times of B1 and B3 at the slice's 65536-row shapes,
     L2-cold (``cold_ms``) and warm, beside their bounds and plain
     versions, the 65536-row request time and the peak device memory of
     those requests;
  5b. the acim KAN slice: KAN1, KAN2 and mixed (8, 4) KAN1 at 1..65536 rows
     through ``runtime.execute(backend="acim")``: a quiet config is "fused"
     bit for bit; IR-drop only (natural and KAN-SAM placement) matches the
     same executor on CPU copies under the parity gate; the default noisy
     config reproduces under one generator seed; the psum sigma of a
     one-layer (17, 14) bundle is within 3% of the analytic one on every
     channel; and the simulator MAC ``cim_mac`` (kernel B4) runs the
     first-layer MAC of Fig. 13's KANs and Fig. 12's sweep against
     ``cim_matmul``, with B4's device time there from the profiler;
  6. the LM serving slice: ``qwen2.5-14b`` ``kan_variant()`` at full width
     (d_model 5120, 48 physical heads over 8 KV heads, vocab 152064,
     KAN-FFN hidden 1280), bf16, depth cut to 4 layers, random weights
     from a seed.  ``ServeEngine(kan_deploy=True)`` serves 8 requests
     (prompts of 5..1000 tokens, two sharing a 256-token prefix; greedy,
     16 new tokens) with 4 slots and max_len 1024, contiguous and then
     paged (16-token blocks, 256-token prefill chunks).  Checked: the
     launch and dispatch counts put B2 and B1 on every layer of every
     prefill and decode call, the paged run hits the prefix cache, and
     every emitted token passes the teacher-forced gate against the
     "ref" KAN and "ref" attention backends; timed: TTFT, prefill and
     decode ms, tokens/s, peak memory, and (a profiled run of each mode)
     the device time by kernel and the host idle share.
     With the obs registry on and the scheduler tracing, the contiguous
     run serves the same streams, leaves the documented series and one
     span tree per request.  The profiled contiguous run has the spans'
     ``torch.profiler`` ranges on: its host time split by span (count,
     host ms, device ms of the kernels inside), the wall outside them,
     launches per decode step and the device-to-host syncs.
     Then ``kan_backend="acim"``: the quiet config serves the fused
     streams token for token, the default config serves one stream in two
     runs (B1 with its noise operand on every layer of every call), timed
     beside the fused run.  Last, speculative decoding (paged, the default
     drafter refit to grid 4 from the float weights) at k = 2 and 4: the
     verify-vs-decode logit difference measured on the served model, the
     streams against the paged k = 0 streams (parting only at a k = 0
     top-2 margin within twice that difference, counted), every token
     under the teacher-forced gate, rounds, accept rate, tokens/s, draft
     and verify times, B1 / B2 launches per round, peak memory;
  7. CUDA-event times, L2-cold and warm, of B2 at the three shapes the
     serving path gives it, at decode over 4096 keys and at the k = 4
     verify pass (with its KV split count), of B1 at the full-width FFN
     halves of the target and of the drafter (with their feature split
     count), at each row tile (16, 32, 64; bits checked equal) on the
     target's halves at 8 and 1024 rows, and in both band loops (gather and
     register loop, bits checked equal, with the loop the launch code takes)
     at the G=8 halves of every decoder from 8 to 8192 rows, beside bounds,
     plain versions and
     ``scaled_dot_product_attention`` (warm) from the same run; and of B4
     at the simulator path's six shapes and the reference's largest case,
     L2-cold and warm (events, graph replay), beside its bound, its plain
     version and a cold read of x;
  8. the co-design flow of ``examples/tune_deploy.py`` at its full budgets
     (``repro_torch.tune``): the knot task's (17, 1, 14) G=8 base network
     trained on the card (8192 / 1024 rows, 120 epochs), its float, fused
     and acim validation accuracy beside the 17-420-420-14 MLP baseline's,
     the cost model's MLP / KAN1 area, energy and latency ratios inside the
     reference's bands, the Pareto search (budget 32, ``DesignSpace()``,
     0.02 mm2 / 300 pJ / 900 ns) with B1 and its noise operand on every
     acim accuracy run, run twice under one seed (equal fronts), the
     chosen point's B1 tile sweep in measured mode (every kept trial
     bit-exact), the artifact saved, the runtime reset, reloaded and
     redeployed (bit-identical outputs and codes), and ``launch.serve
     --tuned-config`` serving the full-width 4-layer LM at the chosen
     point;
  9. LM training: the float KAN-FFN's custom backward (``_SplineMM``) at
     the full-width halves against autograd of the plain forward; three
     train steps on the card against the CPU (smoke-size KAN-FFN config,
     f32, microbatch 2, remat); the in-place optimizer bit-equal to the
     functional one; a bf16 restart from a step-3 checkpoint bit-equal to
     the uninterrupted run; then the full-width ``qwen2.5-14b``
     ``kan_variant()`` (bf16, 4 layers, microbatch 8, remat, AdamW)
     trained 6 steps of 16 x 256 tokens through ``launch.train``: every
     step good, the step-0 loss in [ln V, ln V + 2], s/step, tokens/s,
     peak memory beside its reckoning, one step profiled (forward /
     backward / optimizer device ms, idle share, top ops, waits), one
     batch overfitted (the loss falls at every step), a second run from
     the seed with bit-equal losses; B1 / B2 never launched and "flash"
     never dispatched in the phase;
 10. the sliding-window and MoE decoders at their published widths, bf16,
     random weights from a seed: B1 at gemma2's kan_variant() FFN halves
     (4608 -> 3456 -> 4608, 8 and 1024 rows), B2 at gemma2's and mixtral's
     4200-token windowed prefill (softcap 50, 4096-key window; the pairs
     the window excludes counted), olmoe's causal prefill and decode over
     wrapped 4096-slot rings, each against its plain version and timed
     beside SDPA; one full-width MoE layer of mixtral and olmoe at 64 and
     1024 tokens, card against CPU (routing equal but at router near-ties,
     outputs within 4 bf16 ulps); then gemma2-27b kan_variant() (4
     layers) and mixtral-8x7b (4 layers) served contiguous (4 slots,
     max_len 4608, prompts of 5, 300, 1000 and 4200 tokens, 16 new each)
     and olmoe-1b-7b (16 layers) contiguous and paged on phase 6's
     prompts.  Gates: gemma2 every emitted token under LOGIT_TOL of the
     teacher-forced "ref" logits; MoE streams under LOGIT_TOL of a
     "ref"-attention replay of the same schedule and routing (the same
     batches, MoE capacities and expert choices; the tokens the replay's
     own router would have moved counted); launch counts, a profiled
     run's idle share and waits per decode step (no op waits that phase
     6's does not), MoE drops per step;
 11. the recurrent decoders at their published widths, bf16, random
     weights from a seed: B1 at recurrentgemma's kan_variant() FFN halves
     (4096 -> 1152 -> 4096, 8 and 4096 rows), B2 at its local layer (16
     query heads over one KV head, D = 256: the tensor-core instance, its
     KV axis split at decode) at a 2300-token prefill past the 2048-key
     window and at decode over wrapped 2048-slot rings, each against its
     plain version and timed beside SDPA, the instance and splits
     recorded; one full-width RG-LRU layer and one Mamba-2 block card
     against CPU (a 1000-token prefill, then 4 decode steps); then
     recurrentgemma-9b kan_variant() (8 layers: 2 x (rglru, rglru, local)
     + (rglru, rglru)) served contiguous (4 slots, max_len 2432, prompts
     of 5, 300, 1000 and 2300 tokens, 16 new each) and mamba2-370m (24
     of its 48 layers) on phase 6's prompts, each under phase 10's
     teacher-forced gate, with launch counts, a profiled run's idle share
     and waits per decode step;
 12. the encoder and patch prefixes at their published widths, bf16,
     random weights from a seed: B1 at whisper-base's and pixtral-12b's
     kan_variant() FFN halves (512 -> 256 -> 512 at 8 and 8192 rows,
     5120 -> 1408 -> 5120 at 8 and 2048 rows), B2 at whisper's encoder
     ("full" over 4 x 1500 frames), cross prefill (448 tokens) and cross
     decode (one query, the KV axis split) over 1500 encoder keys, at
     pixtral's 1256-row causal prefill (256 patches and a 1000-token
     prompt) and under "full" with more queries than keys, each against
     its plain version and timed beside SDPA; one full-width whisper
     encoder layer and cross-attention decoder layer card against CPU
     (the cross K/V left bit-equal by decode); then whisper-base
     kan_variant() whole (6 encoder + 6 decoder layers: 4 clips of 1500
     stub frames, a 4-token special-token prompt, 64 greedy new tokens in
     one batch) and pixtral-12b kan_variant() (4 of 40 layers: 256 stub
     patches and prompts of 5, 300 and 1000 tokens, 16 new tokens each,
     B = 1), driven through ``models.model``'s prefill and decode_step (no
     engine of either package serves these families): encode ms, TTFT,
     decode ms/step, peak memory beside its reckoning, launches per run
     and per decode step, a profiled run's idle share and waits per decode
     step, and phase 10's teacher-forced gate (also against the fused +
     flash forward, as prefill-then-decode against forward);
 13. mesh serving on a 1x1 ``DeviceMesh`` over a world-1 NCCL group
     (``launch.mesh.make_local_mesh``): phase 4's KAN slice at 1..65536
     rows through ``runtime.execute(mesh=)`` and through
     ``place_deployed_kan`` bundles, bit-identical (y and boundary codes)
     to the unsharded calls with the same B1 launches per call and the
     plan cache holding meshed and unmeshed entries apart; quiet acim ==
     fused under the mesh, noisy acim reproducible under one seed; phase
     6's full-width engine (contiguous and paged) with ``mesh=``: streams
     equal phase 6's token for token, B1 / B2 on every layer of every
     call, decode ms/step, tokens/s and collectives per decode step beside
     phase 6's and, contiguous, in turns with the unmeshed engine (mesh,
     plain, plain, mesh); the int8 codec (``dist.compress``) of the full-width
     KAN-FFN bundle against a numpy reckoning, ``_quantize`` on the card
     against numpy, the decompressed bundle on the mesh under the parity
     gate against its unplaced twin and within the codec's error of the
     original; what a larger mesh runs, on the one card: a model shard's
     B1 column slabs of gemma2's full-width halves at the whole layer's
     feature split bit-identical to the whole layer's columns, and NCCL's
     collectives called directly on the world-1 groups;
     ``launch.serve --mesh data=1,model=1`` in-process; then phase 6's
     contiguous requests once more, plus one with a 1 ms deadline behind
     the busy slots and one arriving at 0.05 s (phase 6's 5-token prompt),
     through a scheduler on ``MeshClock`` (its NCCL broadcast forced on
     the world-1 group): exactly one expiry, phase 6's streams token for
     token (the late request's too), the arrival admitted no earlier than
     its offset, broadcasts per decode step and the cost of one read;
 14. training on a 1x1 ``DeviceMesh`` over a world-1 NCCL group: phase
     9's cell (the full-width ``qwen2.5-14b`` ``kan_variant()``, 4 layers,
     microbatch 8, remat, 16 x 256 tokens, 6 steps) through
     ``TrainLoop(shardings=)``: losses, grad norms and the parameters'
     sha256 bit-equal to phase 9's unmeshed run, a checkpoint at step 3
     restored by a new loop whose steps 3-5 are bit-equal to the unbroken
     run, peak memory within 1 GiB of phase 9's and s/step beside it; what
     a model cut runs, one slab at a time: a full-width mixtral MoE layer
     at model 2 (partial expert outputs added by hand, within 4 bf16 ulps
     of the whole layer) and qwen's float KAN-FFN (5120 -> 1280 -> 5120,
     f32) at model 2 forward and backward (within 1e-5 x max); the
     gradient-carrying collectives of ``dist.comm`` on the world-1
     groups; no B1-B4 launch in the phase;
 15. the six examples (``repro_torch.examples``) in-process, the
     launch counts set to 0 before each and read after it: quickstart
     at its own size (KAN1, 8 rows; B3 and B1 exactly twice each, its
     kernel and fused paths against its quantized path under the parity
     gate, the SH-LUT's entry count), knot_e2e ``--fast`` (software and
     both ACIM accuracies; the cost dict equal to the host's reckoning;
     no launch), neurosim_search ``--fast`` (step 1's fronts equal a host
     run's; no launch), tune_deploy ``--smoke`` (exit status 0; B1 with
     its noise operand), lm_kan_train at its defaults (60 steps, a
     restart at step 60 for 10 more; every loss finite, the last below
     the first; no launch) and serve_demo at its own sizes (B2 on every
     layer of every engine call, B1 on both halves of every deployed
     call, streams equal to the final outputs, the float-vs-fused
     ``same`` count printed, not gated); seconds per example;
 16. the dry-run against the card: ``launch.op_analysis`` predicts phase
     9's train step (the full-width ``qwen2.5-14b`` ``kan_variant()``, 4
     layers, microbatch 8, remat, AdamW, 16 x 256 tokens, one rank) on the
     meta device; the card then builds that state after the earlier
     phases' memory is freed and steps it: the state's bytes (each tensor
     in 512 B blocks) equal the growth of ``memory_allocated`` less the
     tails the allocator left unsplit (at most 1 MiB), the requested bytes
     equal the tensors' own; the predicted high-water mark is within 5% of
     ``max_memory_allocated`` over one step; the roofline bound is at most
     the step's profiled device time; FlopCounterMode over the card's
     step equals the meta count.  Then ``python -m
     repro_torch.launch.dryrun --arch qwen2.5-14b --shape decode_32k`` and
     ``prefill_32k`` (the (16, 16) production mesh, ``--save-ops``) on the
     host with no card visible, beside the card's work, each exiting 0,
     and ``scripts.top_ops`` over the decode cell's ops; no B1-B4 launch
     in the phase;
 17. Moonlight-16B-A3B's ``kan_variant()`` at full width (latent attention,
     64 routed KAN experts top-6, 2 shared, one dense layer), 5 layers:
     B1's grouped launch over 64 experts at its 2048 x 128 / 128 x 2048
     halves (~24 and ~190 rows an expert, every fifth expert empty) bit
     for bit against one launch per expert and, per segment, against the
     plain version under phase 3's B1 gate; B2's latent decode instance
     (``flash_kernel_mla``) against the plain recurrence at 256 slots,
     a small batch, a verify step and a short cache, and timed (CUDA
     events, L2-cold) over 256 caches of 1024..5500 rows beside its byte
     bound and the "ref" backend's batched products over the whole
     cache; then ``ServeEngine(kan_deploy=True)`` + ``Scheduler`` serve 4
     requests (prompts of 5..2100 tokens, 16 new) with every launch count
     zeroed just before the run: B2 once a layer a prefill (the expanded
     MLA at D = 256), the latent instance once a layer a decode step, one
     grouped B1 launch per half per MoE layer per step, B1 twice per
     dense layer and shared experts per step; the served tokens
     teacher-forced under the "ref" attention backend, their widest gap
     within the benchmark check's 2.5;
 18. one JSON line of kernels, then ``{"ok": true, "device": ...}`` last.

A longer report goes to ``reports/chip_smoke_report.json`` (gitignored).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM, NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# atol for the slice's answers against the "ref" backend: f32 sums of the
# same O(1) terms in another order differ by a few ulps
ATOL = 1e-5
BATCHES = (1, 3, 5, 7, 8, 33, 130, 4096, 65536)
KERNEL_ROWS = 4096  # rows of each kernel-vs-plain check in phase 3
SOURCE = "src/repro_torch/csrc/kan_spline.cu"
B2_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
B4_SOURCE = "src/repro_torch/csrc/cim_mac.cu"

# the serving slice (phase 6)
SERVE_LAYERS = 4           # depth cut from 48; every layer has the same shapes
SERVE_SLOTS = 4
SERVE_MAX_LEN = 1024
SERVE_NEW = 16
SERVE_BLOCK = 16           # paged KV block (tokens)
SERVE_CHUNK = 256          # paged prefill chunk (tokens)
# prompt lengths in submission order: the first four fill the slots, so
# the 511-token prompt is prefilled (and its blocks published) before the
# 257-token prompt, which shares its first 256 tokens, is admitted
SERVE_LENS = (511, 5, 17, 64, 1000, 130, 257, 700)
SHARED = (511, 257)
# B2 timed beside the path shapes: decode over a 4096-key cache (a longer
# context than the cell's max_len; the split count stays 8)
DECODE_LONG = (("decode_t4096", 4, 1, 4096, "causal"),)
# and at the speculative verify pass of k = 4 (4 slots x 5 rows over the
# gathered paged view of a full 1024-token cache)
VERIFY_SHAPES = (("verify", 4, 5, 1024, "causal"),)
# Teacher-forced gate on the bf16 logits: each served token's logit under
# the "ref" KAN and "ref" attention backends must lie within LOGIT_TOL of
# the "ref" maximum.  A token picked as the argmax of logits that differ
# from the ref ones by e at the ref argmax and at the token itself has a
# ref logit within 2e of the ref maximum (``logit_err_stats``' max_top_err
# is that e).  The logits come out of a bf16 matmul, so they sit on the
# bf16 grid of their magnitude: 2^-5 = 0.03125 in [4, 8), where the
# maxima of qwen2.5-14b, gemma2, the MoE decoders and pixtral-12b lie
# (pixtral 7.72), 2^-6 in [2, 4) (whisper-base 2.08).  LOGIT_TOL = 0.125
# is 4 grid steps in [4, 8); the measured e stays within 0.0625 there
# (H100, 700 W: qwen 0.0625, gemma2 0.0677 anywhere in the vocabulary,
# whisper 0.0156 and pixtral 0.0312 at the gate's tokens), so the gate
# holds by the 2e argument.  recurrentgemma-9b's logits reach 52.5, where
# the grid is 0.25: its max |flash - ref| of 0.25 is one bf16 ulp at
# |logit| 44.75, and there LOGIT_TOL, half a grid step, admits only the
# ref argmax or an exact tie; its gate holds on the measured gaps (0.0),
# not on the 2e argument.
LOGIT_TOL = 0.125


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# the B1 launches that took the register loop, counted among
# ``kan_pipeline_layer``'s: the loop follows each call's shape
REGS_KEY = "kan_pipeline_layer.regs"


def by_kernel(counts: dict) -> dict:
    """Launch counts by kernel, without :data:`REGS_KEY`."""
    return {k: v for k, v in counts.items() if k != REGS_KEY}


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi failed: {proc.stderr.strip()}"


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in
    one CUDA graph and replayed: the launches back to back, where
    ``cuda_ms`` also counts the card's idle gaps when the host launches
    slower than the kernel runs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# device clock cycles (about 1 ms on an H100) that the card spins between
# cold_ms's flush and its timed launch
COLD_SPIN_CYCLES = 2_000_000


def cold_ms(fn, reps: int = 20, flush_bytes: int = 256 << 20) -> float:
    """Mean device milliseconds of ``fn`` with a cold L2: before each
    launch, outside its timed interval, a 256 MiB scratch buffer is written
    and then read, so the card's 50 MB L2 holds none of ``fn``'s operands
    and no dirty lines to write back while it runs.  Each launch is timed
    by its own pair of events, queued behind the flush and a ~1 ms spin of
    the card (``torch.cuda._sleep``): the host queues the start event and
    ``fn`` while the card spins, so the host's launch time stays out of the
    timed interval."""
    import torch

    scratch = torch.zeros(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        scratch.fill_(float(i))
        scratch.sum()
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del scratch
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound(nbytes: int, flops: int, flop_per_s: float = F32_FLOP_PER_S) -> tuple:
    """(bound ms, "bytes" | "operations") from the card's peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled: str) -> str:
    """A kernel's name (with template arguments) out of its mangled name."""
    m = re.search(r"\d+((?:flash|kan_layer|cim_mac)[a-z_]*)(?:I(.*?)EEv)?",
                  mangled)
    if m is None:
        return mangled
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel instance: its (mangled) name, then the
    registers / shared memory and spill lines ptxas printed for it."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split("Used", 1)[1].strip()
            out.append(f"{name[:56]}: {used}; {spill}")
            name, spill = None, ""
    return out


def require_no_spill(summary: list, name: str) -> str:
    """``name``'s line of :func:`ptxas_summary`; raises unless ptxas
    reported 0 bytes of spill stores and loads for it."""
    lines = [ln for ln in summary if ln.startswith(name + ":")]
    require(len(lines) == 1, f"ptxas: no single line for {name}: {lines}")
    require("0 bytes spill stores, 0 bytes spill loads" in lines[0],
            f"ptxas: {name} spills: {lines[0]}")
    return lines[0]


def sass_mma_counts(lib_path: str) -> dict | None:
    """Tensor-core instructions (HMMA, HGMMA) per kernel in the built
    library's SASS, from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        return None
    counts, fn = {}, None
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            fn = kernel_name(ln.split("Function :", 1)[1].strip())
        elif fn and re.search(r"\bH(G)?MMA\b|\bHMMA\.|\bHGMMA\.", ln):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


# ----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------------


def phase_kernels(dev, report) -> dict:
    import torch

    from repro_torch.kernels.kan_spline import cardcheck as cc

    gen = torch.Generator(device=dev).manual_seed(11)
    b1_err, excused, runs = 0.0, 0, 0
    for order in cc.ORDERS:
        for grid, f, o in cc.B1_GEOMETRIES:
            for flags in cc.B1_FLAGS:
                st = cc.check_b1(dev, gen, grid, f, o, flags, KERNEL_ROWS, order)
                b1_err = max(b1_err, st["max_abs_err"])
                excused += st["excused"]
                runs += 1
    print(f"B1 vs plain: {runs} runs ({len(cc.B1_FLAGS)} flag sets x "
          f"{len(cc.B1_GEOMETRIES)} layer geometries x orders {cc.ORDERS}, "
          f"{KERNEL_ROWS} rows), max |err| {b1_err:.3e} (atol {cc.ATOL}), "
          f"excused codes {excused}, packed == unpacked bit for bit")

    b3_err = max(cc.check_b3(dev, gen, *shape, order=order)
                 for order in cc.ORDERS for shape in cc.B3_SHAPES)
    print(f"B3 vs plain: {len(cc.B3_SHAPES)} shapes x orders {cc.ORDERS}, "
          f"max |err| {b3_err:.3e}")
    ffn_err, ffn_excused = 0.0, 0
    for grid, f, o, flags, rows in cc.B1_FFN_FULL:
        st = cc.check_b1(dev, gen, grid, f, o, flags, rows,
                         eps=cc.FFN_FULL_TIE_EPS)
        ffn_err = max(ffn_err, st["max_abs_err"])
        ffn_excused += st["excused"]
    print(f"B1 vs plain at the full-width KAN-FFN halves (5120 -> 1280 -> "
          f"5120, G=8, 8 and 1024 rows): max |err| {ffn_err:.3e}, excused "
          f"codes {ffn_excused} (tie window {cc.FFN_FULL_TIE_EPS:.2e})")
    draft_err, draft_excused = 0.0, 0
    for grid, f, o, flags, rows in cc.B1_FFN_DRAFT:
        st = cc.check_b1(dev, gen, grid, f, o, flags, rows,
                         eps=cc.FFN_FULL_TIE_EPS)
        draft_err = max(draft_err, st["max_abs_err"])
        draft_excused += st["excused"]
    ffn_err = max(ffn_err, draft_err)
    print(f"B1 vs plain at the speculative drafter's full-width halves (G=4, "
          f"K=3: 7 basis functions; 8 and 32 rows): max |err| "
          f"{draft_err:.3e}, excused codes {draft_excused}")
    from repro_torch.kernels.kan_spline.pipeline import feature_split_plan

    for grid, f, o, flags, rows in cc.B1_FFN_PACKED:
        require(feature_split_plan(f, o)[0] > 1, f"B1 {f}x{o}: no split")
        st = cc.check_b1(dev, gen, grid, f, o, flags, rows,
                         eps=cc.FFN_FULL_TIE_EPS)
        ffn_err = max(ffn_err, st["max_abs_err"])
    rows_eq = cc.check_b1_rows_independent(dev, gen)
    pad_cols = cc.check_b1_padded_columns(dev, gen)
    print(f"B1 with feature splits: packed == unpacked bit for bit at "
          f"{[c[1:3] for c in cc.B1_FFN_PACKED]} "
          f"({[feature_split_plan(c[1], c[2])[0] for c in cc.B1_FFN_PACKED]}"
          f" splits); 5120 -> 1280 rows bit-identical at 8 and 1024 rows "
          f"({rows_eq['feature_splits']} splits): {rows_eq['equal']}; a noisy "
          f"layer's {pad_cols['columns']} padded columns y = noise exactly, "
          f"codes requantized ({pad_cols['excused']} excused near-ties)")

    from repro_torch.kernels.attention import cardcheck as ac

    b2_err, b2_ratio = 0.0, 0.0
    cases = [dict(dtype=dt, kind=kind, hq=hq, hkv=hkv, d=d)
             for dt, kind, (hq, hkv), d in ac.B2_CASES] + list(ac.B2_EXTRA)
    for case in cases:
        st = ac.check_b2(dev, gen, **case)
        b2_err = max(b2_err, st["max_abs_err"])
        b2_ratio = max(b2_ratio, st["max_err_over_tol"])
    split_cases = []
    for case in ac.B2_SPLIT:
        st = ac.check_b2(dev, gen, **case)
        require(st["kv_splits"] > 1, f"B2 {case}: the KV axis was not split")
        b2_err = max(b2_err, st["max_abs_err"])
        b2_ratio = max(b2_ratio, st["max_err_over_tol"])
        split_cases.append({**{k: str(v) for k, v in case.items()}, **st})
    print(f"B2 vs plain: {len(cases)} cases (f32/bf16 x kinds {ac.KINDS} x "
          f"GQA {ac.GQA} x D {ac.HEAD_DIMS} at S=33, T=47, plus the serving "
          f"geometry, softcap and D=32) and {len(split_cases)} with the KV "
          f"axis split ({[c['kv_splits'] for c in split_cases]} splits: "
          f"decode T=1023/4096, verify S=3/5, a masked split, local, full "
          f"D=64; D=256 decode T=2048/2047, local), fully masked rows "
          f"exact 0; max |err| "
          f"{b2_err:.3e}, worst err / tol {b2_ratio:.3f} (f32 tol "
          f"{ac.F32_TOL} + rel, bf16 + one bf16 ulp)")

    from repro_torch.core.cim import CIMConfig
    from repro_torch.kernels.cim_mac import cardcheck as mc

    b4 = [mc.check_case(dev, gen, *case) for case in mc.CASES]
    b4 += [mc.check_case(dev, gen, b, r, c, rows, adc=adc, ir=0.03)
           for b, r, c, rows, adc in mc.PROPERTY_CASES]
    b4.append(mc.check_tiled(dev, gen))
    # the wide path's R-chunks, ragged stream tiles, a row's bits at 32 rows
    # and at the full batch
    b4 += [mc.check_case(dev, gen, b, r, c, rows, adc=adc)
           for b, r, c, rows, adc in mc.SPLIT_CASES]
    ir_of = {rows: CIMConfig(array_rows=rows, ir_gamma=0.06).ir_scale()
             for rows in (128, 256, 512, 1024)}
    for _, b, r, c, rows, adc in mc.RAGGED_CASES:
        b4.append(mc.check_path(dev, mc.path_operands(dev, gen, b, r, c, rows),
                                rows, ir_of[rows], adc))
        torch.cuda.empty_cache()
    for _, b, r, c, rows, adc in mc.ROW_CASES:
        b4.append(mc.check_rows(dev, gen, b, r, c, rows, adc))
        torch.cuda.empty_cache()
    b4_err = max(st["max_abs_err"] for st in b4)
    b4_over = max(st["max_err_over_allow"] for st in b4)
    b4_tight = min(st["tight"] for st in b4)
    zero_ir_err = mc.check_zero_ir(dev, gen)
    print(f"B4 vs plain: {len(b4)} cases (the reference's CASES, "
          f"{len(mc.PROPERTY_CASES)} ragged shapes at adc 6/8/12, the tiled "
          f"identity case, {len(mc.SPLIT_CASES)} wide R-split cases, "
          f"{len(mc.RAGGED_CASES)} ragged stream tiles, {len(mc.ROW_CASES)} "
          f"batches whose 32-row slices equal the full call bit for bit), "
          f"ADC contract: max |err| {b4_err:.4e} = "
          f"{b4_over:.3f} of one LSB per array, least tight share "
          f"{b4_tight:.4f} (>= 0.95); zero IR at 24 bits vs x @ w: max |err| "
          f"{zero_ir_err:.4e} (rtol 1e-3 + half an LSB per array)")
    report["kernel_checks"] = {"b1_runs": runs, "b1_max_abs_err": b1_err,
                               "b1_excused_codes": excused,
                               "b1_ffn_full_max_abs_err": ffn_err,
                               "b1_ffn_full_excused_codes": ffn_excused,
                               "b1_ffn_draft_max_abs_err": draft_err,
                               "b1_ffn_draft_excused_codes": draft_excused,
                               "b3_max_abs_err": b3_err,
                               "b1_packed_split_cases": len(cc.B1_FFN_PACKED),
                               "b1_rows_independent": rows_eq,
                               "b1_padded_columns": pad_cols,
                               "b2_cases": len(cases) + len(split_cases),
                               "b2_split_cases": split_cases,
                               "b2_max_abs_err": b2_err,
                               "b2_max_err_over_tol": b2_ratio,
                               "b4_cases": b4, "b4_zero_ir_max_abs_err":
                               zero_ir_err}
    return {"kan_pipeline_layer": max(b1_err, ffn_err), "kan_spline": b3_err,
            "flash_attention": b2_err, "cim_mac_fwd": b4_err}


# ----------------------------------------------------------------------------
# phase 3b: the PACT baseline and quantized_dense_basis, card against CPU
# ----------------------------------------------------------------------------

# (G, n_bits, lo, hi): tests/test_torch_asp_quant.py's PACT_SPECS
PACT_SPECS = [(g, n, lo, hi) for g in (5, 8, 68) for n in (8, 10)
              for lo, hi in ((0.0, 1.0), (-1.0, 1.0))]
PACT_DRAWS = 4096  # seeded uniform inputs per spec beside the half steps


def phase_pact(dev, report) -> None:
    """``pact_quantize``, ``pact_dense_basis`` and ``quantized_dense_basis``
    on the card equal the CPU's bit for bit (the CPU's equal the
    reference's: ``tests/test_torch_asp_quant.py``).  Also counted, not
    gated: the codes a division by the reciprocal (CUDA's way with a
    scalar divisor) would move."""
    import numpy as np
    import torch

    from repro_torch.core import asp_quant as aq

    t0 = time.perf_counter()
    halves = elems = 0
    moved = {True: 0, False: 0}
    for g, n, lo, hi in PACT_SPECS:
        spec = aq.ASPQuantSpec(grid_size=g, order=3, n_bits=n, lo=lo, hi=hi,
                               signed=lo < 0)
        rng = np.random.default_rng(g * 100 + n + int(lo < 0))
        draws = rng.uniform(lo - 0.2, hi + 0.2, PACT_DRAWS)
        label = f"PACT G={g} n={n} [{lo}, {hi}]"
        # the spec's clip, then one whose reciprocal is not exact
        for alpha in (hi - lo, 0.75 * (hi - lo)):
            half = lo + (np.arange(2**n - 1) + 0.5) * alpha / (2**n - 1)
            x = np.concatenate([half, [lo, lo + alpha, lo - 0.3,
                                       lo + alpha + 0.3], draws])
            xc = torch.from_numpy(x.astype(np.float32))
            xd = xc.to(dev)
            want = aq.pact_quantize(xc - aq.f32(lo), alpha, n)
            got = aq.pact_quantize(xd - aq.f32(lo), alpha, n)
            require(got.dtype == torch.int32
                    and torch.equal(got.cpu(), want),
                    f"{label} alpha={alpha}: card codes differ from the "
                    f"CPU's at {int((got.cpu() != want).sum())} inputs")
            a = aq.f32(alpha)
            recip = torch.round(torch.clamp(xd - aq.f32(lo), 0.0, a) / a
                                * (2**n - 1)).to(torch.int32)
            moved[alpha == hi - lo] += int((recip.cpu() != want).sum())
            halves += half.size
            elems += x.size
            if alpha == hi - lo:
                xs = (xc, xd)
        xc, xd = xs
        tables = aq.pact_basis_tables(spec)
        for name, fn in (
                ("pact_dense_basis",
                 lambda v: aq.pact_dense_basis(v, spec, tables)),
                ("quantized_dense_basis",
                 lambda v: aq.quantized_dense_basis(v, spec))):
            b_cpu, b_dev = fn(xc), fn(xd)
            require(b_dev.dtype == torch.float32
                    and b_dev.shape == (xc.numel(), spec.num_basis)
                    and torch.equal(b_dev.cpu(), b_cpu),
                    f"{label}: {name} on the card differs from the CPU's")
    wall = time.perf_counter() - t0
    print(f"PACT on the card: {len(PACT_SPECS)} specs x 2 clips, {elems} "
          f"inputs of which {halves} exact half steps and "
          f"{8 * len(PACT_SPECS)} at or past the clip edges: pact_quantize "
          "codes equal the CPU's bit for bit, and pact_dense_basis and "
          "quantized_dense_basis at the spec's clip; a reciprocal multiply "
          f"would have moved {moved[True]} codes at the spec's clip "
          f"(alpha 1 or 2) and {moved[False]} at 0.75 of it; {wall:.2f} s")
    report["pact"] = {"specs": len(PACT_SPECS), "inputs": elems,
                      "half_steps": halves,
                      "reciprocal_moved": {"spec_clip": moved[True],
                                           "clip_0.75": moved[False]},
                      "wall_s": wall}


# ----------------------------------------------------------------------------
# phase 4: the slice end to end
# ----------------------------------------------------------------------------


def build_models(dev) -> dict:
    import torch

    from repro_torch.core.kan_layer import KANSpec, init_kan_network
    from repro_torch.core.kan_network_deploy import (
        deploy_kan_ffn_stack,
        deploy_kan_network,
        quantize_kan_network,
    )

    models = {}
    for name, dims, grid, bits in [
        ("kan1", (17, 1, 14), 5, 8),
        ("kan2", (17, 1, 14), 68, 8),
        ("kan1_mixed_8_4", (17, 1, 14), 5, (8, 4)),
        ("ffn_64_128_64_g8", (64, 128, 64), 8, 8),
    ]:
        kspec = KANSpec(dims=dims, grid_size=grid, n_bits=bits)
        gen = torch.Generator(device=dev).manual_seed(0)
        qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev),
                                       kspec)
        if name.startswith("ffn"):
            dep = deploy_kan_ffn_stack(qparams, dims, kspec.layer_spec(),
                                       batch=8, device=dev)
        else:
            dep = deploy_kan_network(qparams, kspec, batch=8, device=dev)
        models[name] = (kspec, qparams, dep)
    return models


def requests(name: str, knot, b: int):
    """``b`` rows of knot-surrogate features (17 per row; the FFN takes 64,
    four rows' features laid end to end)."""
    if name.startswith("ffn"):
        return knot[: 4 * b].reshape(b, 68)[:, :64].copy()
    return knot[:b]


def phase_slice(dev, models, report) -> dict:
    import torch

    from repro_torch import parity, runtime
    from repro_torch.core.asp_quant import quantize_input
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kan_spline.ops import kan_spline_from_qparams
    from repro_torch.runtime.executor import _entry_codes

    knot, _, _, _ = make_knot_dataset(n_train=4 * max(BATCHES), n_test=1, seed=0)
    kspec1, qp1, _ = models["kan1"]
    spec1 = kspec1.layer_specs()

    runtime.reset_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_dispatch_counts()
    cuda.reset_launch_counts()
    answers, quick = {}, {}
    t0 = time.perf_counter()
    for name, (_, _, dep) in models.items():
        for b in BATCHES:
            answers[name, b] = runtime.execute(dep, requests(name, knot, b),
                                               return_intermediates=True)
    for b in BATCHES:
        # quickstart's path: kernel B3 layer by layer, tanh re-coding between
        x = torch.as_tensor(knot[:b], device=dev)
        c1 = quantize_input(torch.tanh(
            kan_spline_from_qparams(quantize_input(x, spec1[0]), qp1[0], spec1[0])),
            spec1[1])
        quick[b] = (c1, kan_spline_from_qparams(c1, qp1[1], spec1[1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dispatch = runtime.dispatch_counts()
    launches = cuda.launch_counts()
    stats = runtime.cache_stats()
    peak = torch.cuda.max_memory_allocated()

    n_req = len(models) * len(BATCHES)
    n_layers = sum(len(dep.plan.layers) for _, _, dep in models.values())
    buckets = len({runtime.bucket_batch(b) for b in BATCHES})
    print(f"main path: {n_req} requests in {wall:.3f} s; dispatch {dispatch}; "
          f"launches {launches}; plan cache {stats}; peak memory {peak} B")
    require(dispatch == {"fused": n_req}, f"dispatch counts {dispatch}")
    require(launches.get("kan_pipeline_layer") == len(BATCHES) * n_layers,
            f"B1 launches {launches} != requests x layers")
    require(launches.get("kan_spline") == 2 * len(BATCHES),
            f"B3 launches {launches} != quickstart requests x layers")
    require(stats["misses"] == len(models) * buckets,
            f"plan-cache misses {stats['misses']} != distinct buckets "
            f"{len(models) * buckets}")

    checked = {}
    for (name, b), (y, codes) in answers.items():
        dep = models[name][2]
        x = torch.as_tensor(requests(name, knot, b), device=dev)
        ry, rcodes = runtime.execute(dep, x, backend="ref",
                                     return_intermediates=True)
        entry, xraw = _entry_codes(dep, x, None)
        pre = parity.boundary_prerounds(dep, entry, xraw, rcodes)
        require(y.shape == (b, dep.dims[-1]) and bool(torch.isfinite(y).all()),
                f"{name} b={b}: bad output {tuple(y.shape)}")
        st = parity.compare_runs(codes, rcodes, pre, y, ry)
        if name == "kan1":
            c1, qy = quick[b]
            parity.compare_runs([c1], rcodes, pre, qy, ry)
        checked[f"{name}/{b}"] = st
    excused = sum(s["excused"] for s in checked.values())
    left = sum(s["rows_left_out"] for s in checked.values())
    err = max(s["max_abs_err"] for s in checked.values())
    print(f"fused vs ref on the card: {len(checked)} answers agree, max |err| "
          f"{err:.3e} (atol {ATOL}), excused codes {excused}, rows left out "
          f"{left}; quickstart B3 path agrees with ref")
    report["slice"] = {"requests": n_req, "wall_s": wall, "dispatch": dispatch,
                       "launches": launches, "plan_cache": stats,
                       "peak_bytes": peak, "vs_ref": checked}
    return launches


# ----------------------------------------------------------------------------
# phase 5: times
# ----------------------------------------------------------------------------


def b1_work(lp, lw, bp) -> tuple:
    """(bytes, flops) of one B1 call.  Bytes as the padded contract hands
    them: each stored weight operand read once, the (bp, fp) codes (and raw
    inputs) read once, the (bp, op) outputs written once.  Flops: the band
    work the layer needs, K+1 LUT MACs + 1 residual MAC per logical
    (b, f, o); padded features and columns carry zero weights."""
    nbytes = sum(t.numel() * t.element_size() for k, t in lw.items()
                 if not (k == "lut" and "lutp" in lw))
    nbytes += bp * lp.fp * 4 * (2 if lp.residual_raw else 1)
    nbytes += bp * lp.op * 4 * (2 if lp.emit_codes else 1)
    flops = 2 * bp * lp.f * lp.o * (lp.spec.order + 2)
    return nbytes, flops


def phase_times(dev, models, report) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch import runtime
    from repro_torch.core.asp_quant import quantize_input
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels.kan_spline import pipeline as pl
    from repro_torch.kernels.kan_spline.ops import kan_spline
    from repro_torch.kernels.kan_spline.ref import kan_spline_ref
    from repro_torch.runtime.executor import _entry_codes

    bp = max(BATCHES)
    knot, _, _, _ = make_knot_dataset(n_train=4 * bp, n_test=1, seed=0)
    rows, totals = [], {}
    # library_ms stays none: no single PyTorch call computes either kernel's
    # function (a gathered band MAC + requantizer), so none is timed
    print("B1 at 65536 rows: layer | kernel ms L2-cold | warm (graph) | "
          "back-to-back events | plain ms | bound ms (by) | library_ms: none")
    for name, (_, _, dep) in models.items():
        plan = runtime.PLAN_CACHE.plan(bp, dep.dims, dep.specs,
                                       residual_raw=dep.residual_raw)
        x = torch.as_tensor(requests(name, knot, bp), device=dev)
        codes, xraw = _entry_codes(dep, x, None)
        lp0 = plan.layers[0]
        codes = F.pad(codes, (0, lp0.fp - lp0.f))
        xraw = None if xraw is None else F.pad(xraw, (0, lp0.fp - lp0.f))
        for li, (lp, lw) in enumerate(zip(plan.layers, dep.layers)):
            args = (codes, xraw if lp.residual_raw else None, lw, lp, bp)
            ms = cuda_ms(lambda: pl.run_pipeline_layer(*args), reps=50)
            cold = cold_ms(lambda: pl.run_pipeline_layer(*args))
            warm = graph_ms(lambda: pl.run_pipeline_layer(*args), 20)
            plain = cuda_ms(lambda: pl.run_pipeline_layer_plain(*args), reps=5,
                            warmup=1)
            b_ms, by = bound(*b1_work(lp, lw, bp))
            rows.append({"kernel": "kan_pipeline_layer", "layer": f"{name}/{li}",
                         "f": lp.f, "o": lp.o, "fp": lp.fp, "op": lp.op,
                         "nb": lp.spec.num_basis,
                         "feature_splits": pl.feature_split_plan(lp.f, lp.o)[0],
                         "packed_w": "wcp" in lw, "packed_lut": "lutp" in lw,
                         "ms": cold, "cold_ms": cold, "warm_ms": warm,
                         "event_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": by})
            print(f"  {name}/{li} f={lp.f} o={lp.o} fp={lp.fp} op={lp.op} "
                  f"nb={lp.spec.num_basis} splits={rows[-1]['feature_splits']}"
                  f" | {cold:.4f} | {warm:.4f} | {ms:.4f} | {plain:.4f} | "
                  f"{b_ms:.4f} ({by})")
            y, nxt = pl.run_pipeline_layer(*args)
            codes, xraw = nxt, y

    kspec1, qp1, _ = models["kan1"]
    specs = kspec1.layer_specs()
    x = torch.as_tensor(knot[:bp], device=dev)
    c0 = quantize_input(x, specs[0])
    print("B3 at 65536 rows (quickstart's KAN1 layers): layer | kernel ms "
          "L2-cold | warm (graph) | back-to-back events | plain ms | bound ms "
          "(by) | library_ms: none")
    for li, (qp, spec) in enumerate(zip(qp1, specs)):
        wc = qp["c_q"].to(torch.float32) * qp["c_scale"]
        wb = qp["w_b_q"].to(torch.float32) * qp["w_b_scale"]
        args = (c0, qp["lut"], wc, wb, spec)
        ms = cuda_ms(lambda: kan_spline(*args), reps=50)
        cold = cold_ms(lambda: kan_spline(*args))
        warm = graph_ms(lambda: kan_spline(*args), 20)
        plain = cuda_ms(lambda: kan_spline_ref(*args), reps=5, warmup=1)
        f, nb, o = wc.shape
        nbytes = (c0.numel() * 4 + qp["lut"].numel() * 4 + wc.numel() * 4
                  + wb.numel() * 4 + bp * o * 4)
        b_ms, by = bound(nbytes, 2 * bp * f * o * (spec.order + 2))
        rows.append({"kernel": "kan_spline", "layer": f"kan1/{li}", "fp": f,
                     "op": o, "nb": nb, "ms": cold, "cold_ms": cold,
                     "warm_ms": warm, "event_ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by})
        print(f"  kan1/{li} F={f} O={o} | {cold:.4f} | {warm:.4f} | "
              f"{ms:.4f} | {plain:.4f} | {b_ms:.4f} ({by})")
        if li == 0:
            c0 = quantize_input(torch.tanh(kan_spline(*args)), specs[1])

    for kern in ("kan_pipeline_layer", "kan_spline"):
        sel = [r for r in rows if r["kernel"] == kern]
        by_time = {"bytes": 0.0, "operations": 0.0}
        for r in sel:
            by_time[r["bound_by"]] += r["bound_ms"]
        totals[kern] = {
            "ms": sum(r["cold_ms"] for r in sel),
            "warm_ms": sum(r["warm_ms"] for r in sel),
            "event_ms": sum(r["event_ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": max(by_time, key=by_time.get),
        }
        t = totals[kern]
        print(f"{kern} at 65536 rows, all layers: {t['ms']:.4f} ms L2-cold "
              f"({t['warm_ms']:.4f} warm, {t['event_ms']:.4f} back-to-back "
              f"events), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), bound / cold time "
              f"{100 * t['bound_ms'] / t['ms']:.2f}%")

    e2e = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, (_, _, dep) in models.items():
        x = requests(name, knot, bp)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runtime.execute(dep, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = sorted(times[1:])[len(times[1:]) // 2]
    peak = torch.cuda.max_memory_allocated()
    print("request time at 65536 rows (host clock, median of 5, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in e2e.items()))
    print(f"peak device memory over those requests: {peak} B")
    breakdown = profile_requests(models, knot, bp, e2e)
    report["times"] = {"rows": rows, "totals": totals, "request_ms_65536": e2e,
                       "device_breakdown_65536": breakdown,
                       "request_peak_bytes_65536": peak}
    return totals


def profile_requests(models, knot, bp, e2e) -> dict:
    """Device time by kernel of one 65536-row request per model (profiler),
    and its share of the unprofiled request time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import runtime

    out = {}
    print("device time of one 65536-row request (profiler, ms): total | "
          "share of request time | top kernels")
    for name, (_, _, dep) in models.items():
        x = requests(name, knot, bp)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runtime.execute(dep, x)
            torch.cuda.synchronize()
        kernels = []
        for ev in prof.key_averages():
            # the record_function range of the executor also shows on the
            # device timeline; it spans the kernels, so it is left out
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or ev.key.startswith("kan_spline.")
                    or getattr(ev, "is_user_annotation", False)):
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            key = ev.key.replace("void (anonymous namespace)::", "")
            kernels.append((us / 1e3, key.split("((")[0][:48]))
        kernels.sort(reverse=True)
        total = sum(ms for ms, _ in kernels)
        out[name] = {"device_ms": total, "busy_share": total / e2e[name],
                     "top": kernels[:4]}
        top = "; ".join(f"{k} {ms:.3f}" for ms, k in kernels[:3]) \
            or "profiler saw no device time"
        print(f"  {name}: {total:.3f} | {total / e2e[name]:.2f} | {top}")
    return out

# ----------------------------------------------------------------------------
# phase 5b: the acim KAN slice and the ACIM simulator MAC (kernel B4)
# ----------------------------------------------------------------------------

ACIM_MODELS = ("kan1", "kan2", "kan1_mixed_8_4")
NOISY_BATCHES = (130, 65536)
# the sigma gate: per-channel std of the injected psum noise within 3% of
# the analytic sigma (sampling error of a std over 65536 rows ~0.3%)
SIGMA_TOL = 0.03
# the simulator MAC of a KAN's first layer (17 features x G+3 bases -> 1),
# IR-drop only: (label, G, array rows, adc bits, ir_gamma).  Fig. 13's two
# accelerators (benchmarks/fig13_knot_e2e.py:90) and Fig. 12's array-size
# sweep (benchmarks/fig12_kan_sam.py:33, :53)
MAC_PATH = (("fig13/kan1", 5, 128, 8, 0.10), ("fig13/kan2", 68, 1024, 10, 0.10),
            ("fig12/g7", 7, 128, 10, 0.06), ("fig12/g15", 15, 256, 10, 0.06),
            ("fig12/g30", 30, 512, 10, 0.06), ("fig12/g60", 60, 1024, 10, 0.06))
ACIM_ROWS = 65536  # rows of the sigma gate and the simulator MAC path
CALIB_ROWS = 4096  # knot rows that calibrate the KAN-SAM placements


def cpu_bundle(dep):
    import dataclasses

    return dataclasses.replace(dep, layers=tuple(
        {k: v.cpu() for k, v in lw.items()} for lw in dep.layers))


def sam_perms_for(dep, x, array_rows: int) -> tuple:
    """Per-layer KAN-SAM placements from each layer's inputs: the request
    rows for layer 0, the fused run's dequantized boundary codes after."""
    from repro_torch import runtime
    from repro_torch.core.asp_quant import dequantize_input
    from repro_torch.core.sam import row_activation_weight, sam_permutation

    _, codes = runtime.execute(dep, x, backend="fused",
                               return_intermediates=True)
    inputs = [x] + [dequantize_input(c, lp.spec)
                    for lp, c in zip(dep.plan.layers[1:], codes)]
    return tuple(sam_permutation(row_activation_weight(h, lp.spec, lp.f),
                                 array_rows)
                 for lp, h in zip(dep.plan.layers, inputs))


def phase_acim(dev, models, report) -> dict:
    import torch

    from repro_torch import parity, runtime
    from repro_torch.core.cim import CIMConfig
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels import cuda
    from repro_torch.runtime.executor import _entry_codes

    t_phase = time.perf_counter()
    knot, _, _, _ = make_knot_dataset(n_train=max(BATCHES), n_test=1, seed=0)
    xs = {b: torch.as_tensor(knot[:b], device=dev) for b in BATCHES}
    quiet = runtime.quiet_cim_config()
    ir_only = CIMConfig(ir_gamma=0.06, deterministic=True)
    noisy = runtime.get_executor("acim").cim
    calib = torch.as_tensor(knot[:CALIB_ROWS], device=dev)
    perms = {name: sam_perms_for(models[name][2], calib, ir_only.array_rows)
             for name in ACIM_MODELS}

    # the acim path: every run through runtime.execute(backend="acim")
    runtime.reset_dispatch_counts()
    cuda.reset_launch_counts()
    runs = {}
    for name in ACIM_MODELS:
        dep = models[name][2]
        for b in BATCHES:
            runs["quiet", name, b] = runtime.execute(
                dep, xs[b], backend="acim", cim=quiet,
                return_intermediates=True)
            for tag, p in (("ir", None), ("ir_sam", perms[name])):
                runs[tag, name, b] = runtime.execute(
                    dep, xs[b], backend="acim", cim=ir_only, sam_perms=p,
                    return_intermediates=True)
        for b in NOISY_BATCHES:
            for tag, seed in (("noisy_a", 0), ("noisy_b", 0), ("noisy_c", 1)):
                gen = torch.Generator(device=dev).manual_seed(seed)
                runs[tag, name, b] = runtime.execute(
                    dep, xs[b], backend="acim", generator=gen,
                    return_intermediates=True)
    torch.cuda.synchronize()
    launches = cuda.launch_counts()
    dispatch = runtime.dispatch_counts()
    layers = {n: len(models[n][2].plan.layers) for n in ACIM_MODELS}
    n_noisy = 3 * len(NOISY_BATCHES) * sum(layers.values())
    n_b1 = 3 * len(BATCHES) * sum(layers.values()) + n_noisy
    print(f"acim path: {len(runs)} requests; dispatch {dispatch}; launches "
          f"{launches}")
    require(dispatch == {"acim": len(runs)}, f"acim dispatch {dispatch}")
    require(by_kernel(launches) == {"kan_pipeline_layer": n_b1,
                                    "kan_pipeline_layer.noise": n_noisy},
            f"acim launches {launches} != B1 {n_b1} (noise operand on "
            f"{n_noisy}: every layer of every noisy call)")

    # 1. quiet == fused, bit for bit
    for name in ACIM_MODELS:
        for b in BATCHES:
            y, codes = runs["quiet", name, b]
            fy, fcodes = runtime.execute(models[name][2], xs[b],
                                         backend="fused",
                                         return_intermediates=True)
            require(torch.equal(y, fy) and all(
                torch.equal(c, f) for c, f in zip(codes, fcodes)),
                f"quiet acim differs from fused: {name} b={b}")
    print(f"  quiet acim == fused bit for bit: {len(ACIM_MODELS)} models x "
          f"{len(BATCHES)} batches (y and boundary codes)")

    # 2. IR-drop only, natural and SAM placement: card vs the same executor
    #    on CPU copies (the plain versions), under the parity gate
    ir_stats = {}
    for name in ACIM_MODELS:
        dep = models[name][2]
        cdep = cpu_bundle(dep)
        for tag, p in (("ir", None), ("ir_sam", perms[name])):
            gained = parity.irdrop_bundle(cdep, ir_only, p)
            for b in BATCHES:
                y, codes = runs[tag, name, b]
                x = xs[b].cpu()
                want_y, want_codes = runtime.execute(
                    cdep, x, backend="acim", cim=ir_only, sam_perms=p,
                    return_intermediates=True)
                pre = parity.boundary_prerounds(
                    gained, _entry_codes(cdep, x, None)[0], None, want_codes)
                ir_stats[f"{tag}/{name}/{b}"] = parity.compare_runs(
                    codes, want_codes, pre, y, want_y)
    err = max(st["max_abs_err"] for st in ir_stats.values())
    excused = sum(st["excused"] for st in ir_stats.values())
    left = sum(st["rows_left_out"] for st in ir_stats.values())
    print(f"  IR-drop only (ir_gamma 0.06, natural and SAM placement) vs the "
          f"CPU run: {len(ir_stats)} answers agree, max |err| {err:.3e} "
          f"(atol {ATOL}), excused codes {excused}, rows left out {left}")

    # 3. the default noisy config: one seed twice is one answer, another
    #    seed another
    for name in ACIM_MODELS:
        for b in NOISY_BATCHES:
            (ya, ca), (yb, cb), (yc, _) = (runs[t, name, b] for t in
                                           ("noisy_a", "noisy_b", "noisy_c"))
            require(torch.equal(ya, yb) and all(
                torch.equal(u, v) for u, v in zip(ca, cb)),
                f"noisy acim not reproducible: {name} b={b}")
            require(not torch.equal(ya, yc),
                    f"noisy acim: two seeds gave one answer ({name} b={b})")
    print(f"  noisy acim ({noisy}): one generator seed reproduces, another "
          f"differs, at {NOISY_BATCHES} rows")

    sigma = sigma_gate(dev, knot)
    mac = phase_mac_path(dev, models, knot)
    report["acim"] = {"wall_s": time.perf_counter() - t_phase,
                      "dispatch": dispatch, "launches": launches,
                      "irdrop_vs_cpu": ir_stats, "sigma": sigma, "mac": mac}
    return {"acim_kan_slice": launches, "acim_mac": mac["launches"]}


def sigma_gate(dev, knot) -> dict:
    """One (17, 14) layer with only the partial-sum noise on: the
    per-channel std of y_acim - y_fused at 65536 rows against the analytic
    sigma of the executor (ROADMAP A8's sigma gate)."""
    import torch

    from repro_torch import runtime
    from repro_torch.core.cim import CIMConfig
    from repro_torch.core.kan_layer import KANSpec, init_kan_network
    from repro_torch.core.kan_network_deploy import (
        deploy_kan_network,
        quantize_kan_network,
    )
    from repro_torch.core.tmdv import TMDVConfig
    from repro_torch.runtime.executor import ACIMExecutor

    kspec = KANSpec(dims=(17, 14), grid_size=5)
    gen = torch.Generator(device=dev).manual_seed(0)
    qp = quantize_kan_network(init_kan_network(gen, kspec, device=dev), kspec)
    dep = deploy_kan_network(qp, kspec, device=dev)
    cfg = CIMConfig(ir_gamma=0.0, sigma_ps_ref=0.05,
                    input_gen=TMDVConfig(sigma_v_ref=0.0, sigma_t=0.0))
    x = torch.as_tensor(knot[:ACIM_ROWS], device=dev)
    noise = (runtime.execute(dep, x, backend="acim", cim=cfg,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
             - runtime.execute(dep, x, backend="fused")).double()
    lp = dep.plan.layers[0]
    want = ACIMExecutor._layer_psum_std(cfg, lp, dep.layers[0])[: lp.o]
    got = noise.std(dim=0)
    rel = ((got - want.double()) / want.double()).abs()
    require(bool((want > 0).all()), "psum sigma is zero on a live channel")
    print(f"  sigma gate (one 17 x 14 layer, psum noise only, {ACIM_ROWS} rows): "
          f"per-channel std / analytic sigma within {rel.max().item():.4f} "
          f"(tol {SIGMA_TOL}) on all {lp.o} channels")
    require(rel.max().item() <= SIGMA_TOL,
            f"psum sigma off by {rel.max().item():.4f}")
    return {"max_rel_err": rel.max().item(), "channels": lp.o,
            "sigma": want.tolist(), "measured": got.tolist()}


def mac_drives(qparams, x, spec):
    """Layer 0's simulator MAC operands: WL drives (the dense SH-LUT basis in
    LUT-code units) and the int8 weight codes as conductance rows."""
    import torch

    from repro_torch.core.asp_quant import dense_basis_from_codes, quantize_input

    qp = qparams[0]
    basis = dense_basis_from_codes(quantize_input(x, spec), qp["lut"], spec)
    drives = basis.reshape(x.shape[0], -1) / qp["lut_scale"]
    w_rows = qp["c_q"].to(torch.float32).reshape(drives.shape[1], -1)
    return drives, w_rows


def layer0_qparams(dev, models, grid: int):
    """(layer-0 spec, quantized layers) of a (17, 1, 14) KAN at ``grid``:
    the phase's KAN1 / KAN2 where they match, else one made from seed 0."""
    import torch

    from repro_torch.core.kan_layer import KANSpec, init_kan_network
    from repro_torch.core.kan_network_deploy import quantize_kan_network

    for name in ("kan1", "kan2"):
        kspec, qparams, _ = models[name]
        if kspec.grid_size == grid:
            return kspec.layer_specs()[0], qparams
    kspec = KANSpec(dims=(17, 1, 14), grid_size=grid)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_kan_network(gen, kspec, device=dev)
    return kspec.layer_specs()[0], quantize_kan_network(params, kspec)


def phase_mac_path(dev, models, knot) -> dict:
    """The ACIM simulator MAC (``cim_mac``, kernel B4) on the first-layer
    MAC of the Fig. 13 KANs and the Fig. 12 sweep, natural and KAN-SAM
    placement, 65536 knot rows: held to the plain simulator ``cim_matmul``
    on the card, and its error against the ideal MAC reported (the Fig. 12
    mechanism: SAM should lower it)."""
    import torch

    from repro_torch.core.cim import CIMConfig, cim_matmul, ideal_matmul
    from repro_torch.core.sam import row_activation_weight, sam_permutation
    from repro_torch.kernels import cuda
    from repro_torch.kernels.cim_mac import cim_mac
    from repro_torch.kernels.cim_mac.cardcheck import assert_adc_close

    x = torch.as_tensor(knot[:ACIM_ROWS], device=dev)
    cases = []
    for label, grid, rows, adc, gamma in MAC_PATH:
        spec, qparams = layer0_qparams(dev, models, grid)
        cfg = CIMConfig(array_rows=rows, adc_bits=adc, ir_gamma=gamma,
                        deterministic=True)
        drives, w_rows = mac_drives(qparams, x, spec)
        perm = sam_permutation(
            row_activation_weight(x[:CALIB_ROWS], spec, 17), rows)
        for tag, p in (("natural", None), ("sam", perm)):
            cases.append((f"{label}/{tag}", cfg, drives, w_rows, p))
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    by_shape, widths = {}, {}
    cuda.reset_launch_counts()
    outs = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for key, cfg, drives, w_rows, p in cases:
            xd, wd = drives, w_rows
            if p is not None:
                idx = torch.as_tensor(p, device=dev)
                xd, wd = drives.index_select(1, idx), \
                    w_rows.index_select(0, idx)
            before = cuda.LAUNCHES["cim_mac_fwd"]
            outs.append(cim_mac(xd, wd, array_rows=cfg.array_rows,
                                ir_scale=cfg.ir_scale(),
                                adc_bits=cfg.adc_bits, x_max=255.0))
            shape = f"{key.split('/')[1]}_l1_{ACIM_ROWS}"
            widths[shape] = (shape, *xd.shape, wd.shape[1], cfg.array_rows,
                             cfg.adc_bits)
            by_shape[shape] = by_shape.get(shape, 0) \
                + cuda.LAUNCHES["cim_mac_fwd"] - before
        torch.cuda.synchronize()
    launches = cuda.launch_counts()
    require(launches == {"cim_mac_fwd": len(cases)},
            f"simulator MAC launches {launches} != {len(cases)}")
    # B4's device time on this path: every kernel of cim_mac.cu
    b4_us = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and "cim_mac" in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            b4_us.append(ev.self_cuda_time_total if us is None else us)
    b4_ms = sum(b4_us) / 1e3
    require(b4_ms > 0, "the profiler saw no B4 device time on the MAC path")
    stats = {}
    for (key, cfg, drives, w_rows, p), out in zip(cases, outs):
        want = cim_matmul(drives, w_rows, cfg, row_perm=p, x_max=255.0)
        wp = w_rows if p is None else w_rows[torch.as_tensor(p, device=dev)]
        require(out.shape == want.shape and bool(torch.isfinite(out).all()),
                f"simulator MAC {key}: bad output {tuple(out.shape)}")
        st = assert_adc_close(out, want, wp, cfg.array_rows, cfg.adc_bits)
        ideal = ideal_matmul(drives, w_rows)
        st["rel_err_vs_ideal"] = float((out - ideal).abs().mean()
                                       / ideal.abs().mean())
        stats[key] = st
    print(f"  simulator MAC (cim_mac, B4) vs cim_matmul on the card, "
          f"{ACIM_ROWS} rows: case | max |err| / LSB | tight | mean |MAC - "
          "ideal| / mean |ideal|")
    for k, st in stats.items():
        print(f"    {k} | {st['max_err_over_allow']:.3f} | {st['tight']:.5f} "
              f"| {st['rel_err_vs_ideal']:.5f}")
    print(f"  B4 device time of the {len(cases)} launches (profiler): "
          f"{b4_ms:.4f} ms")
    return {"launches": launches, "launches_by_shape": by_shape,
            "shapes": widths, "b4_device_ms": b4_ms, "vs_cim_matmul": stats}


# ----------------------------------------------------------------------------
# phase 6: the LM serving slice at full width
# ----------------------------------------------------------------------------


def serve_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2.5-14b").kan_variant(),
                               num_layers=SERVE_LAYERS)


def serve_prompts(vocab: int) -> list:
    """Prompts of SERVE_LENS tokens from a numpy seed; the SHARED pair's
    first 256 tokens are equal."""
    import numpy as np

    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, vocab, n).tolist() for n in SERVE_LENS]
    a, b = (SERVE_LENS.index(n) for n in SHARED)
    prompts[b][:256] = prompts[a][:256]
    return prompts


def _timed(eng, name: str, sink: list) -> None:
    """Wrap ``eng.<name>`` so each call's host time, from a synchronized
    start to a synchronized end, is appended to ``sink`` (ms)."""
    import torch

    fn = getattr(eng, name)

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(eng, name, wrapper)


def serve_once(params, cfg, prompts, dev, mode: str, profile: bool = False,
               kan_backend: str | None = None, spec_decode: int = 0,
               sched_kw: dict | None = None, hook=None,
               engine_kw: dict | None = None, extra: list = ()):
    """One engine serves the requests through the scheduler; returns its
    streams, counters and times.  ``spec_decode``: k of a speculative
    engine (paged; ``params`` then the FLOAT tree the drafter refits);
    ``sched_kw``: Scheduler options (``trace``); ``hook(eng)`` runs after
    the warm-up (e.g. to wrap the engine's calls); ``engine_kw``:
    ServeEngine options over phase 6's (``max_len``, ``kan_deploy``,
    ``attn_backend``); ``extra``: requests submitted after the prompts'."""
    import gc

    import torch

    from repro_torch import runtime
    from repro_torch.kernels import cuda
    from repro_torch.serve import Request, Scheduler, ServeEngine

    gc.collect()        # engines of earlier runs (their timers form cycles)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    kw = ({} if mode == "contiguous" else
          {"kv_block_size": SERVE_BLOCK, "prefill_chunk": SERVE_CHUNK})
    kw = {"max_len": SERVE_MAX_LEN, "kan_deploy": True, **kw,
          **(engine_kw or {})}
    eng = ServeEngine(params, cfg, slots=SERVE_SLOTS, kan_backend=kan_backend,
                      device=dev, spec_decode=spec_decode, **kw)
    # warm-up (library load, plan builds) outside the measured run
    eng.run([Request(rid=-1, prompt=[5, 6, 7, 8, 9, 10, 11, 12],
                     max_new_tokens=2)])
    if hook is not None:
        hook(eng)
    engine_bytes = torch.cuda.memory_allocated() - before
    prefill_ms, decode_ms = [], []
    _timed(eng, "_prefill_step", prefill_ms)
    _timed(eng, "verify_active" if spec_decode else "decode_active",
           decode_ms)
    base = eng.compile_stats()
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)] + list(extra)
    sched = Scheduler(eng, **(sched_kw or {}))
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_dispatch_counts()
    runtime.reset_attn_dispatch_counts()
    cuda.reset_launch_counts()
    prof, prof_wall = None, None
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t_in = time.perf_counter()
            done = sched.run_until_idle()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_in
    else:
        done = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.compile_stats()
    calls = {"prefill_calls": st["prefill_calls"] - base["prefill_calls"],
             "decode_calls": st["decode_traces"] - base["decode_traces"],
             "verify_calls": st["verify_calls"] - base["verify_calls"]}
    if spec_decode:
        d, d0 = st["spec"]["draft"], base["spec"]["draft"]
        calls["draft_prefill_calls"] = d["prefill_calls"] - d0["prefill_calls"]
        calls["draft_decode_calls"] = d["decode_traces"] - d0["decode_traces"]
    return {
        "engine": eng, "streams": {r.rid: list(r.output) for r in done},
        "status": {r.rid: r.status for r in done},
        "launches": cuda.launch_counts(), "kan": runtime.dispatch_counts(),
        "attn": runtime.attn_dispatch_counts(), **calls,
        "kv": st["kv"], "sched": sched.stats(), "tracer": sched.tracer,
        "wall_s": wall, "prof_wall_s": prof_wall,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "engine_bytes": engine_bytes,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "ttft_s": {r.rid: r.ttft_s for r in done}, "prof": prof,
        "decode_steps": sched.decode_steps,
        "arrival_s": {r.rid: r.arrival_s for r in done},
    }


def check_counts(run: dict, mode: str, layers: int, backend: str = "fused",
                 noise: bool = False, kan: bool = True,
                 requests: int = len(SERVE_LENS), attn: str = "flash",
                 attn_layers: int | None = None,
                 ffn_layers: int | None = None) -> None:
    """B2 once per attention layer and B1 twice per KAN-FFN layer (both
    default to every layer) of every prefill / decode / verify call of
    the engine and of its drafter (with ``noise``: every B1 launch carried
    the psum-noise operand; without ``kan``: no B1; ``attn="ref"``: no B2
    either)."""
    calls = (run["prefill_calls"] + run["decode_calls"] + run["verify_calls"]
             + run.get("draft_prefill_calls", 0)
             + run.get("draft_decode_calls", 0))
    na = layers if attn_layers is None else attn_layers
    nf = layers if ffn_layers is None else ffn_layers
    want = ({"flash_attention": calls * na} if attn == "flash" and na
            else {})
    if kan:
        want["kan_pipeline_layer"] = 2 * calls * nf
    if noise:
        want["kan_pipeline_layer.noise"] = 2 * calls * nf
    require(by_kernel(run["launches"]) == want,
            f"{mode}: launches {run['launches']} != {want} ({calls} calls x "
            f"{na} attention / {nf} KAN-FFN layers; B1 twice per KAN-FFN)")
    require(run["attn"] == ({attn: calls * na} if na else {}),
            f"{mode}: attention dispatch {run['attn']}")
    require(run["kan"] == ({backend: calls * nf} if kan else {}),
            f"{mode}: KAN dispatch {run['kan']}")
    require(all(v == "done" for v in run["status"].values())
            and len(run["status"]) == requests,
            f"{mode}: requests not all served: {run['status']}")


def forward_rows(params, cfg, seq, start: int):
    """``models.model.forward``'s logits of rows ``start:`` only, (S -
    start, V): the LM head runs on those rows alone (gemma2's 256000-word
    head over a 4216-token sequence would be 4.3 GB of f32 logits)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.transformer import stack_forward

    s = seq.shape[1]
    h = M._embed_tokens(params, seq, cfg)
    h = stack_forward(params["decoder"], h, cfg,
                      positions=torch.arange(s, device=seq.device)[None])
    h = L.rmsnorm(params["final_norm"], h[:, start:], cfg.norm_eps)
    return M._lm_logits(params, h, cfg)[0]


def logit_err_stats(fl, ref, tok, into: dict | None = None) -> dict:
    """|fl - ref| logit errors of rows (..., V) whose emitted tokens are
    ``tok`` (...,): the largest over every logit, the |ref| logit there and
    that error in bf16 ulps of it (``max_logit_err``, ``_at``, ``_ulps``),
    and the largest at the two logits the gate weighs in each row, the ref
    argmax and the emitted token (``max_top_err``: the gate's worst ref gap
    is at most twice it); ``max_abs_logit``.  Merged into ``into`` (the
    larger of each, the site with the larger error)."""
    import torch

    diff = (fl - ref).abs()
    at = int(diff.argmax())
    err = diff.flatten()[at].item()
    where = ref.flatten()[at].abs().item()
    top = torch.maximum(diff.gather(-1, ref.argmax(dim=-1, keepdim=True)),
                        diff.gather(-1, tok[..., None])).max().item()
    st = {"max_logit_err": err, "max_logit_err_at": where,
          "max_logit_err_ulps": err / 2.0 ** (math.floor(math.log2(
              max(where, 2.0 ** -126))) - 7),
          "max_top_err": top, "max_abs_logit": ref.abs().max().item()}
    if into is None or not into:
        return st
    if err > into["max_logit_err"]:
        into.update({k: st[k] for k in ("max_logit_err", "max_logit_err_at",
                                         "max_logit_err_ulps")})
    into["max_top_err"] = max(into["max_top_err"], top)
    into["max_abs_logit"] = max(into["max_abs_logit"], st["max_abs_logit"])
    return into


def err_site(g: dict) -> str:
    """The logit-error fields of a gate's stats, for a printed line."""
    return (f"max |flash - ref| logit {g['max_logit_err']:.4f} at |logit| "
            f"{g['max_logit_err_at']:.3f} ({g['max_logit_err_ulps']:.1f} bf16 "
            f"ulps there), at the ref argmax and the emitted token "
            f"{g['max_top_err']:.4f}, max |logit| {g['max_abs_logit']:.3f}")


def teacher_forced(params, cfg, prompts, streams, dev,
                   served: dict | None = None) -> dict:
    """Score each served stream under the "ref" backends (KAN "ref",
    attention "ref") and, for the logit error, under "fused" + "flash",
    both as one forward over prompt + stream[:-1] with the LM head on the
    emitted rows; gate every emitted token on the ref logits.  With
    ``served`` ({(rid, index): logits row} of the served run, see
    :func:`replay_hook`) also the largest |served - ref| logit."""
    import torch

    from repro_torch import runtime

    steps, excused, worst_gap, served_err = 0, 0, 0.0, 0.0
    errs = {}
    for rid, out in streams.items():
        prompt = prompts[rid]
        seq = torch.tensor([prompt + out[:-1]], device=dev)
        rows = {}
        with torch.no_grad():
            for kan, attn in (("ref", "ref"), ("fused", "flash")):
                with runtime.use_backend(kan), runtime.use_attn_backend(attn):
                    rows[attn] = forward_rows(params, cfg, seq,
                                              len(prompt) - 1)
        ref, fl = rows["ref"], rows["flash"]
        require(ref.shape == (len(out), cfg.vocab_size)
                and bool(torch.isfinite(ref).all())
                and bool(torch.isfinite(fl).all()),
                f"request {rid}: bad logits {tuple(ref.shape)}")
        tok = torch.tensor(out, device=dev)
        gap = ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]
        steps += len(out)
        excused += int((ref.argmax(dim=-1) != tok).sum())
        worst_gap = max(worst_gap, gap.max().item())
        errs = logit_err_stats(fl, ref, tok, errs)
        if served is not None:
            # the first row comes from the prefill on the host
            rows = torch.stack([served[(rid, i)].float().to(ref.device)
                                for i in range(len(out))])
            served_err = max(served_err, (rows - ref).abs().max().item())
    return {"steps": steps, "excused": excused, "worst_gap": worst_gap,
            **errs, "max_served_err": None if served is None else served_err}


def device_breakdown(prof, wall_ms: float) -> dict:
    """Device time by kernel class from one profiled serving run."""
    import torch

    classes = {"B2 flash_attention": 0.0, "B1 kan_pipeline_layer": 0.0,
               "matmul (cuBLAS)": 0.0, "copies": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith(("kan_spline.", "serve."))
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        ms, key = us / 1e3, ev.key
        if "flash_kernel" in key:          # the split kernel and the merge
            cls = "B2 flash_attention"
        elif "kan_layer_" in key:          # the split kernel and the merge
            cls = "B1 kan_pipeline_layer"
        elif any(w in key.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "matmul (cuBLAS)"
        elif "Memcpy" in key or "Memset" in key:
            cls = "copies"
        else:
            cls = "other"
        classes[cls] += ms
        name = key.replace("void (anonymous namespace)::", "")
        kernels.append((ms, name.split("(")[0][:60]))
    kernels.sort(reverse=True)
    total = sum(classes.values())
    return {"device_ms": total, "wall_ms": wall_ms,
            "busy_share": total / wall_ms if wall_ms else None,
            "by_class_ms": classes, "top": kernels[:8]}


# runtime calls that launch a kernel, and the host's waits on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
SPAN_PREFIXES = ("serve.", "kan_spline.")
# a CUDA API call (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
# CUPTI's own overhead records (torch/profiler/_cupti_monitor.py): the
# profiler's activity-buffer flushes show up as ops that copy and wait
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request",
                     "Command Buffer Full")


def host_split(prof, wall_ms: float, decode_steps: int) -> dict:
    """The host time of one profiled serving run split by the reference's
    spans (``obs.profile_scope`` ranges, on while the run was profiled).

    Per span name: its count, host ms (the CPU extent of its ranges) and
    the device ms of the kernels launched inside them.  A kernel is owned
    by the range around the PyTorch op that launched it (the profiler's
    correlation); a kernel with no correlation was launched by the port's
    own kernel library (``ctypes``, its CUDA runtime linked statically, so
    the profiler records the kernel but not its launch call) and is owned
    by the range of the kernel before it on the stream, which runs the
    launches in their order.  For ``kan_spline.*`` those kernels (B1's)
    are counted by name: only the executor's range launches them.  Also:
    the wall outside every ``serve.*`` range (the scheduler and the Python
    between calls); kernels and launch calls per decode step; the host's
    waits on the device by the op that waited (a wait whose link to its
    op the profiler dropped is owned by the innermost op whose CPU extent
    holds it, and counted in ``waits_by_extent``; one that no op holds
    stays "-"); the top host ops by self CPU time.  Times in ms."""
    import bisect
    import collections

    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    ops = {e.correlation_id(): e for e in cpu
           if e.linked_correlation_id() == 0 and e.correlation_id()}

    def ranges(prefix):
        rs = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                    if e.name().startswith(prefix))
        return rs, [r[0] for r in rs]

    serve_r, serve_t0 = ranges("serve.")
    kan_r, kan_t0 = ranges("kan_spline.")
    held = sorted((e.start_ns(), e.end_ns(), e) for e in cpu
                  if not RUNTIME_CALL.match(e.name())
                  and not e.name().startswith(SPAN_PREFIXES))
    held_t0 = [h[0] for h in held]

    def holder(t):
        """The innermost op whose CPU extent holds time ``t``, or None."""
        i = bisect.bisect_right(held_t0, t)
        for a, b, e in reversed(held[max(0, i - 256):i]):
            if b >= t:
                return e
        return None

    def inside(rs, t0s, t):
        i = bisect.bisect_right(t0s, t) - 1
        return rs[i] if i >= 0 and rs[i][0] <= t <= rs[i][1] else None

    spans = {}
    for rs in (serve_r, kan_r):
        for a, b, name in rs:
            d = spans.setdefault(name, {"count": 0, "host_ms": 0.0,
                                        "device_ms": 0.0})
            d["count"] += 1
            d["host_ms"] += (b - a) / 1e6
    kan_names = sorted({r[2] for r in kan_r})
    dev = sorted((e for e in evs if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()
                  and not e.name().startswith(SPAN_PREFIXES)),
                 key=lambda e: e.start_ns())
    outside_dev_ms = lib_kernels = 0.0
    cur = None
    decode_kernels = decode_lib_kernels = 0
    for e in dev:
        ms = (e.end_ns() - e.start_ns()) / 1e6
        op = ops.get(e.linked_correlation_id())
        lib = op is None
        if not lib:
            cur = inside(serve_r, serve_t0, op.start_ns())
            k = inside(kan_r, kan_t0, op.start_ns())
            if k is not None:
                spans[k[2]]["device_ms"] += ms
        elif "kan_layer" in e.name() and len(kan_names) == 1:
            spans[kan_names[0]]["device_ms"] += ms
        lib_kernels += lib
        if cur is None:
            outside_dev_ms += ms
            continue
        spans[cur[2]]["device_ms"] += ms
        if cur[2] == "serve.decode_step" and "Memcpy" not in e.name() \
                and "Memset" not in e.name():
            decode_kernels += 1
            decode_lib_kernels += lib
    launch_calls = sum(1 for e in cpu if e.name() in LAUNCH_CALLS
                       and inside(serve_r, serve_t0, e.start_ns()) is not None
                       and inside(serve_r, serve_t0, e.start_ns())[2]
                       == "serve.decode_step")
    waits = collections.defaultdict(lambda: [0, 0.0])
    decode_waits = collections.Counter()
    by_extent = 0
    for e in cpu:
        if e.name() in SYNC_CALLS:
            op = ops.get(e.linked_correlation_id())
            if op is None:
                op = holder(e.start_ns())
                by_extent += op is not None
            key = f"{op.name() if op is not None else '-'} ({e.name()})"
            w = waits[key]
            w[0] += 1
            w[1] += (e.end_ns() - e.start_ns()) / 1e6
            r = inside(serve_r, serve_t0, e.start_ns())
            if (r is not None and r[2] == "serve.decode_step"
                    and (op is None or op.name() not in PROFILER_OVERHEAD)):
                decode_waits[key] += 1
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU
            and not ev.key.startswith(SPAN_PREFIXES)]
    host_ops = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key)
                       for ev in rows), reverse=True)[:12]
    # the wall by what the host did: self CPU of the runtime's launch
    # calls, of its syncs and copies, of every other op (PyTorch's
    # dispatch, allocation, host math); the rest is Python outside any op
    # (the spans' own self time) and the profiler's per-op cost
    by_kind = {"launch_calls": 0.0, "syncs_and_copies": 0.0, "ops": 0.0}
    for ev in rows:
        kind = ("launch_calls" if ev.key in LAUNCH_CALLS else
                "syncs_and_copies" if ev.key in SYNC_CALLS else "ops")
        by_kind[kind] += ev.self_cpu_time_total / 1e3
    by_kind["python_and_profiler"] = wall_ms - sum(by_kind.values())
    steps = max(decode_steps, 1)
    top_serve_ms = sum((b - a) / 1e6 for a, b, _ in serve_r)
    return {"spans": spans, "wall_ms": wall_ms,
            "outside_spans_ms": wall_ms - top_serve_ms,
            "outside_spans_device_ms": outside_dev_ms,
            "library_kernels": int(lib_kernels),
            "kernels_per_decode_step": decode_kernels / steps,
            "library_kernels_per_decode_step": decode_lib_kernels / steps,
            "launch_calls_per_decode_step": (launch_calls + decode_lib_kernels)
            / steps,
            "waits": {k: {"count": n, "cpu_ms": ms}
                      for k, (n, ms) in sorted(waits.items(),
                                               key=lambda kv: -kv[1][1])},
            "decode_waits_per_step": {k: n / steps
                                      for k, n in decode_waits.items()},
            "waits_by_extent": by_extent,
            "host_ms_by_kind": by_kind, "top_host_ops": host_ops}


def print_host_split(hs: dict, label: str) -> None:
    print(f"  host split of the {label} run (profiler ranges of the "
          f"reference's spans; wall {hs['wall_ms']:.2f} ms inside the "
          f"profiler): span | count | host ms | device ms of its kernels")
    for name, d in sorted(hs["spans"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        print(f"    {name} | {d['count']} | {d['host_ms']:.2f} | "
              f"{d['device_ms']:.2f}")
    print(f"    outside every serve.* span (scheduler, Python between calls):"
          f" {hs['outside_spans_ms']:.2f} ms host, "
          f"{hs['outside_spans_device_ms']:.2f} ms device; per decode step "
          f"{hs['kernels_per_decode_step']:.1f} kernels "
          f"({hs['library_kernels_per_decode_step']:.1f} of the kernel "
          f"library), {hs['launch_calls_per_decode_step']:.1f} launch calls")
    print("    inside each decode step, waits and copies per step: "
          + ("; ".join(f"{k} {v:.2f}" for k, v in
                       hs["decode_waits_per_step"].items()) or "none")
          + f" ({hs['waits_by_extent']} waits owned by the op around them)")
    print("    host waits on the device and copies (call by the op that "
          "made it): "
          + "; ".join(f"{k} x{v['count']} {v['cpu_ms']:.2f} ms"
                      for k, v in hs["waits"].items()))
    print("    the wall by what the host did (ms): " + "; ".join(
        f"{k} {v:.2f}" for k, v in hs["host_ms_by_kind"].items()))
    print("    top host ops by self CPU ms: " + "; ".join(
        f"{name} x{n} {ms:.2f}" for ms, n, name in hs["top_host_ops"]))


def phase_serve(dev, report) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.models.model import init_params

    cfg = serve_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    # quantized and deployed once; the plain engines take this tree, the
    # speculative ones the float tree (their drafter refits from it)
    qparams = quantize_kan_ffn_params_tree(params, cfg)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated()
    float_ffn = sum(t.numel() * t.element_size() for g in params["decoder"]
                    for k, blk in g.items() if k.endswith("_ffn")
                    for t in blk.values())
    print(f"serving slice: {cfg.name}, {cfg.num_layers} of 48 layers, "
          f"d_model {cfg.d_model}, heads {cfg.phys_heads}/{cfg.phys_kv_heads}"
          f" (physical q/kv), vocab {cfg.vocab_size}, bf16; init "
          f"{t_init:.2f} s, quantize + deploy {t_quant:.2f} s, weights on "
          f"the card {weights} B (of them {float_ffn} B the float KAN-FFN "
          f"blocks kept for the drafter)")
    prompts = serve_prompts(cfg.vocab_size)
    out = {"config": cfg.name, "layers": cfg.num_layers, "init_s": t_init,
           "quantize_deploy_s": t_quant, "weights_bytes": weights,
           "float_ffn_bytes": float_ffn,
           "prompt_lens": list(SERVE_LENS), "modes": {}}
    runs = {}
    for mode in ("contiguous", "paged"):
        run = serve_once(qparams, cfg, prompts, dev, mode)
        check_counts(run, mode, cfg.num_layers)
        # prefills of 64 rows and more (buckets or 256-token chunks) take
        # B1's register loop, the 4-row decode steps its gather
        regs = run["launches"].get(REGS_KEY, 0)
        require(0 < regs < run["launches"]["kan_pipeline_layer"],
                f"{mode}: B1 register-loop launches {regs} of "
                f"{run['launches']['kan_pipeline_layer']}")
        print(f"{mode}: B1 register loop on {regs} of "
              f"{run['launches']['kan_pipeline_layer']} B1 launches")
        if mode == "paged":
            require(run["kv"]["prefix_hits"] > 0,
                    f"paged: no prefix-cache hit {run['kv']}")
        gate = teacher_forced(qparams, cfg, prompts, run["streams"], dev)
        s = run["sched"]
        dec = sorted(run["decode_ms"])
        pre = run["prefill_ms"]
        info = {
            "prefill_calls": run["prefill_calls"],
            "decode_calls": run["decode_calls"], "launches": run["launches"],
            "wall_s": run["wall_s"], "tokens": s["tokens"],
            "tokens_per_s": s["tokens_per_s"],
            "ttft_s": s["ttft_s"], "ttft_by_len": {
                SERVE_LENS[rid]: t for rid, t in run["ttft_s"].items()},
            "prefill_ms": pre, "decode_ms_median": dec[len(dec) // 2],
            "decode_ms_mean": sum(dec) / len(dec),
            "peak_bytes": run["peak_bytes"], "kv": run["kv"], "gate": gate,
            "streams": run["streams"],
        }
        out["modes"][mode] = info
        runs[mode] = run
        kv = run["kv"] or {}
        print(f"  {mode}: {len(run['streams'])} requests, {s['tokens']} tokens"
              f" in {run['wall_s']:.3f} s ({s['tokens_per_s']:.1f} tokens/s);"
              f" {run['prefill_calls']} prefill + {run['decode_calls']} decode"
              f" calls; launches {run['launches']}; TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p95 "
              f"{s['ttft_s']['p95'] * 1e3:.1f} ms; decode "
              f"{info['decode_ms_median']:.2f} ms/step (median, 4 slots); "
              f"peak {run['peak_bytes']} B"
              + (f"; prefix hits {kv.get('prefix_hits')}" if kv else ""))
        print(f"    teacher-forced vs ref backends: {gate['steps']} steps, "
              f"{gate['excused']} excused (token not the ref argmax), worst "
              f"ref gap {gate['worst_gap']:.4f} (tol {LOGIT_TOL}), "
              + err_site(gate))
        require(gate["worst_gap"] <= LOGIT_TOL,
                f"{mode}: a served token's ref logit is {gate['worst_gap']:.4f}"
                f" below the ref maximum (tol {LOGIT_TOL})")
    same = runs["contiguous"]["streams"] == runs["paged"]["streams"]
    out["contiguous_equals_paged"] = same
    print(f"  contiguous and paged streams equal: {same}")

    launches = {f"lm_{mode}": r["launches"] for mode, r in runs.items()}
    out["obs"] = serve_obs(qparams, cfg, prompts, dev, runs["contiguous"],
                           launches)

    # where the time goes: each mode again, under the profiler; the
    # contiguous run with the spans' profiler ranges on (the host split)
    from repro_torch import obs

    for mode in ("paged", "contiguous"):
        if mode == "contiguous":
            obs.enable_profiler_annotations()
        try:
            run = serve_once(qparams, cfg, prompts, dev, mode, profile=True)
        finally:
            obs.disable_profiler_annotations()
        check_counts(run, f"{mode} (profiled)", cfg.num_layers)
        # the wall inside the profiler: its start and stop (which earlier
        # runs counted) are no serving time
        bd = device_breakdown(run["prof"], run["prof_wall_s"] * 1e3)
        bd["wall_ms_with_profiler_start_stop"] = run["wall_s"] * 1e3
        out[f"breakdown_{mode}"] = bd
        out["modes"][mode]["host_idle_share"] = 1.0 - bd["busy_share"]
        outer = bd["wall_ms_with_profiler_start_stop"]
        print(f"  profiled {mode} run: device {bd['device_ms']:.2f} ms of "
              f"{bd['wall_ms']:.2f} ms wall inside the profiler (busy "
              f"{bd['busy_share']:.3f}, host idle share "
              f"{1.0 - bd['busy_share']:.3f}; with the profiler's start and "
              f"stop {outer:.2f} ms, idle share "
              f"{1.0 - bd['device_ms'] / outer:.3f}); "
              + "; ".join(f"{k} {v:.2f}" for k, v in bd["by_class_ms"].items()))
        for ms, name in bd["top"][:6]:
            print(f"    {ms:9.3f} ms  {name}")
        if mode == "contiguous":
            hs = host_split(run["prof"], run["prof_wall_s"] * 1e3,
                            run["decode_calls"])
            hs["device_ms"] = bd["device_ms"]
            out["host_split_contiguous"] = hs
            print_host_split(hs, "profiled contiguous")
    out["acim"] = serve_acim(qparams, cfg, prompts, dev, runs["contiguous"],
                             bd, launches)
    out["spec"] = serve_spec(params, qparams, cfg, prompts, dev,
                             runs["paged"], launches)
    report["serve"] = out
    del runs, run, qparams, params
    torch.cuda.empty_cache()
    return launches


# the documented series (docs/observability.md) a contiguous fused run
# produces: no request expires or is rejected, no pool (kv.*), no drafter
OBS_SERIES = ("serve.submitted", "serve.completed", "serve.tokens",
              "serve.decode_steps", "serve.queue_depth", "serve.active_slots",
              "serve.prefilling_slots", "serve.ttft_s", "serve.itl_s",
              "plan_cache.hits", "plan_cache.misses", "plan_cache.traces",
              "plan_cache.entries", "runtime.backend_dispatch{backend=fused}")


OBS_TURNS = (False, True, True, False)


def serve_obs(qparams, cfg, prompts, dev, plain_run, launches) -> dict:
    """The contiguous run in turns with obs off and on (off, on, on, off:
    the registry recording and the scheduler tracing): every run serves
    the plain run's streams; with obs on the documented series are
    present, the Prometheus text parses, and the span tree has one closed
    ``request`` root per request."""
    from repro_torch import obs

    turns = []
    for on in OBS_TURNS:
        obs.REGISTRY.reset()
        if on:
            obs.enable()
        try:
            run = serve_once(qparams, cfg, prompts, dev, "contiguous",
                             sched_kw={"trace": on})
            snap = obs.REGISTRY.snapshot()["metrics"]
            parsed = obs.parse_prometheus_text(obs.prometheus_text())
        finally:
            obs.disable()
            obs.REGISTRY.reset()
        check_counts(run, f"obs {'on' if on else 'off'}", cfg.num_layers)
        require(run["streams"] == plain_run["streams"],
                f"obs {'on' if on else 'off'}: the streams differ from the "
                "plain run's")
        turns.append((on, run["sched"]["tokens_per_s"], run["wall_s"]))
        if not on:
            continue
        missing = [k for k in OBS_SERIES if k not in snap]
        require(not missing, f"obs on: documented series missing: {missing}")
        # the warm-up request of serve_once is served with obs on too
        require(snap["serve.completed"]["value"] == len(prompts) + 1,
                f"obs on: serve.completed {snap['serve.completed']}")
        recs = run["tracer"].records()
        roots = [r for r in recs if r["name"] == "request"]
        require(len(roots) == len(prompts)
                and all(r["parent"] is None and r["t1"] is not None
                        and r["attrs"]["status"] == "done" for r in roots)
                and sorted(r["rid"] for r in roots)
                == list(range(len(prompts))),
                f"obs on: request roots {roots}")
        launches["lm_obs"] = run["launches"]
        last = {"series": sorted(snap), "prometheus_samples": len(parsed),
                "span_records": len(recs),
                "span_names": sorted({r["name"] for r in recs})}
    on_tps = [t for on, t, _ in turns if on]
    off_tps = [t for on, t, _ in turns if not on]
    print(f"  obs off / on / on / off (registry + tracer): every run's "
          f"streams == the plain run's; {len(last['series'])} series "
          f"({len(OBS_SERIES)} documented ones checked), "
          f"{last['prometheus_samples']} Prometheus samples, "
          f"{last['span_records']} span records {last['span_names']}, one "
          f"closed request root per request; tokens/s "
          + " / ".join(f"{t:.1f}" for _, t, _ in turns))
    return {**last, "turns": [{"obs": on, "tokens_per_s": t, "wall_s": w}
                              for on, t, w in turns],
            "on_tokens_per_s_mean": sum(on_tps) / len(on_tps),
            "off_tokens_per_s_mean": sum(off_tps) / len(off_tps)}


SPEC_KS = (2, 4)


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of the distinct tensors in a param tree (dicts, lists, tuples,
    deployed bundles)."""
    import torch

    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in seen:
            return 0
        seen.add(obj.data_ptr())
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in obj)
    if hasattr(obj, "layers"):             # a DeployedKAN bundle
        return tensor_bytes(obj.layers, seen)
    return 0


def row_bits(dev, cfg) -> dict:
    """Which op of the served model keeps a row's bits when the rows
    around it change from a decode step's (4 slots) to a verify pass's
    (4 x 5): the largest |difference| of the same 4 rows computed among 4
    and among 20, for the bf16 matmuls of the LM head and the query
    projection, and for B2 (one query at a time against S = 5 at once over
    the same 1024 keys)."""
    import torch

    from repro_torch.kernels.attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(23)
    d = cfg.d_model
    x = (torch.randn(20, d, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    out = {}
    for name, cols in (("lm_head", cfg.vocab_size),
                       ("wq", cfg.phys_heads * cfg.head_dim)):
        w = (torch.randn(d, cols, generator=gen, device=dev)
             * d ** -0.5).to(torch.bfloat16)
        out[name] = float(((x[:4] @ w).float() - (x @ w)[:4].float())
                          .abs().max())
        del w
    q = torch.randn(4, 5, 48, 128, generator=gen, device=dev).to(torch.bfloat16)
    kv = [torch.randn(4, 1024, 8, 128, generator=gen, device=dev)
          .to(torch.bfloat16) for _ in range(2)]
    qpos = (1019 + torch.arange(5, device=dev, dtype=torch.int32)).expand(4, 5)
    kpos = torch.arange(1024, device=dev, dtype=torch.int32).expand(4, 1024)
    full = flash_attention(q, *kv, qpos=qpos.contiguous(),
                           kpos=kpos.contiguous())
    out["flash_attention"] = max(
        float((flash_attention(q[:, j:j + 1], *kv,
                               qpos=qpos[:, j:j + 1].contiguous(),
                               kpos=kpos.contiguous()).float()
               - full[:, j:j + 1].float()).abs().max())
        for j in range(5))
    torch.cuda.synchronize()
    return out


def serve_spec(params, qparams, cfg, prompts, dev, paged_run,
               launches) -> dict:
    """Speculative decoding at full width: paged engines with the default
    drafter (grid 4, refit from the float tree) at k = 2 and 4 on the same
    requests.  First the largest |logit| difference between a verify row
    and its sequential decode row (``serve.cardcheck``), measured on the
    served model at each k; then each k's streams held against the paged
    k = 0 streams (parting only at a k = 0 margin within twice that
    difference, counted) and every emitted token against the
    teacher-forced gate; launches checked per call as ``check_counts``
    does."""
    import torch

    from repro_torch.serve import ServeEngine
    from repro_torch.serve import cardcheck as sc

    layers = cfg.num_layers
    holder = {}

    def record(eng):
        holder["margins"] = sc.record_step_margins(eng)

    base = serve_once(qparams, cfg, prompts, dev, "paged", hook=record)
    require(base["streams"] == paged_run["streams"],
            "paged k = 0: two runs gave different streams")
    margins = holder["margins"]
    out = {"k0_tokens_per_s": paged_run["sched"]["tokens_per_s"],
           "k0_decode_ms_median": sorted(paged_run["decode_ms"])[
               len(paged_run["decode_ms"]) // 2],
           "k0_peak_bytes": paged_run["peak_bytes"],
           "k0_engine_bytes": paged_run["engine_bytes"], "runs": {}}
    del base
    bits = row_bits(dev, cfg)
    out["row_bits"] = bits
    print("  a row's logits among 4 rows vs among 20 (max |diff|; 0 = the "
          "same bits): " + "; ".join(f"{k} {v:.4g}" for k, v in bits.items()))
    for k in SPEC_KS:
        eng = ServeEngine(qparams, cfg, slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, kan_deploy=True,
                          kv_block_size=SERVE_BLOCK,
                          prefill_chunk=SERVE_CHUNK, device=dev)
        delta = sc.verify_decode_delta(eng, prompts[:SERVE_SLOTS], k)
        del eng
        run = serve_once(params, cfg, prompts, dev, "paged", spec_decode=k)
        check_counts(run, f"spec k={k}", layers)
        sp = run["sched"]["spec"]
        rounds = sp["rounds"]
        require(run["verify_calls"] == rounds
                and k * rounds <= run["draft_decode_calls"] <= (k + 1) * rounds,
                f"spec k={k}: {rounds} rounds, {run['verify_calls']} verify "
                f"and {run['draft_decode_calls']} drafter decode calls")
        parted = sc.spec_divergences(paged_run["streams"], run["streams"],
                                     margins, delta["max_abs_delta"])
        gate = teacher_forced(qparams, cfg, prompts, run["streams"], dev)
        require(gate["worst_gap"] <= LOGIT_TOL,
                f"spec k={k}: a served token's ref logit is "
                f"{gate['worst_gap']:.4f} below the ref maximum")
        round_calls = run["verify_calls"] + run["draft_decode_calls"]
        dec = sorted(run["decode_ms"])
        d = run["engine"].draft.describe()
        draft_bytes = tensor_bytes([
            blk for g in run["engine"].draft.params["decoder"]
            for key, blk in g.items() if key.endswith("_ffn")])
        info = {
            "k": k, "draft": d, "verify_vs_decode": delta,
            "parted": parted, "equal_to_k0": not parted and
            run["streams"] == paged_run["streams"], "gate": gate,
            "rounds": rounds, "drafted": sp["drafted"],
            "accepted": sp["accepted"], "accept_rate": sp["accept_rate"],
            "tokens_per_round": run["sched"]["tokens_per_round"],
            "tokens": run["sched"]["tokens"],
            "tokens_per_s": run["sched"]["tokens_per_s"],
            "wall_s": run["wall_s"], "draft_s": sp["draft_s"],
            "verify_s": sp["verify_s"], "verify_ms_median": dec[len(dec) // 2],
            "ttft_s": run["sched"]["ttft_s"],
            "calls": {c: run[c] for c in (
                "prefill_calls", "verify_calls", "draft_prefill_calls",
                "draft_decode_calls")},
            "b2_per_round": round_calls * layers / rounds,
            "b1_per_round": 2 * round_calls * layers / rounds,
            "launches": run["launches"], "peak_bytes": run["peak_bytes"],
            "engine_bytes": run["engine_bytes"],
            "draft_ffn_bytes": draft_bytes, "streams": run["streams"],
        }
        out["runs"][k] = info
        launches[f"lm_spec_k{k}"] = run["launches"]
        print(f"  spec k={k} (drafter G={d['kan_grid']} K={d['kan_order']}, "
              f"{d['kan_n_bits']} bit): verify vs sequential decode max "
              f"|dlogit| {delta['max_abs_delta']:.4f} ({delta['rows_bit_equal']}"
              f" of {delta['rows']} rows bit-equal); streams vs paged k=0: "
              f"{'equal' if info['equal_to_k0'] else f'parted at {parted}'};"
              f" teacher-forced worst ref gap {gate['worst_gap']:.4f}")
        print(f"    {rounds} rounds, accept rate {sp['accept_rate']:.3f} "
              f"({sp['accepted']}/{sp['drafted']}), "
              f"{info['tokens_per_round']:.2f} tokens per slot-round; "
              f"{info['tokens_per_s']:.1f} tokens/s (k=0 "
              f"{out['k0_tokens_per_s']:.1f}); draft_s p50 "
              f"{sp['draft_s']['p50'] * 1e3:.2f} ms, verify_s p50 "
              f"{sp['verify_s']['p50'] * 1e3:.2f} ms; per round "
              f"{info['b2_per_round']:.1f} B2 and {info['b1_per_round']:.1f} "
              f"B1 launches; launches {run['launches']}; peak "
              f"{run['peak_bytes']} B (k=0 {out['k0_peak_bytes']} B); the "
              f"engine (target + drafter) {run['engine_bytes']} B, of it "
              f"the drafter's KAN-FFN {draft_bytes} B; k=0 engine "
              f"{paged_run['engine_bytes']} B (the phase's tree)")
        del run
        torch.cuda.empty_cache()
    return out


def serve_acim(qparams, cfg, prompts, dev, fused_run, fused_bd,
               launches) -> dict:
    """The same model and requests through ``kan_backend="acim"``,
    contiguous: the quiet config (registered as "acim" for its run, then
    the default restored) serves the fused streams token for token; the
    default config, served twice (the second run profiled), gives one
    stream."""
    from repro_torch import runtime
    from repro_torch.runtime.executor import ACIMExecutor

    layers = cfg.num_layers
    fused = fused_run["streams"]
    default = runtime.get_executor("acim")
    runtime.register_executor("acim",
                              ACIMExecutor(cim=runtime.quiet_cim_config()))
    try:
        quiet = serve_once(qparams, cfg, prompts, dev, "contiguous",
                           kan_backend="acim")
    finally:
        runtime.register_executor("acim", default)
    check_counts(quiet, "acim quiet", layers, backend="acim")
    require(quiet["streams"] == fused,
            "acim quiet: the streams differ from the fused streams")
    runs = [serve_once(qparams, cfg, prompts, dev, "contiguous",
                       kan_backend="acim", profile=i == 1) for i in range(2)]
    for i, r in enumerate(runs):
        check_counts(r, f"acim run {i}", layers, backend="acim", noise=True)
    require(runs[0]["streams"] == runs[1]["streams"],
            "acim: two runs of the default config gave different streams")
    run = runs[0]
    differ = sum(a != f for rid, toks in fused.items()
                 for a, f in zip(run["streams"][rid], toks))
    first = {rid: next((i for i, (a, f) in enumerate(zip(run["streams"][rid],
                                                         toks)) if a != f),
                       None) for rid, toks in fused.items()}
    bd = device_breakdown(runs[1]["prof"], runs[1]["prof_wall_s"] * 1e3)
    s, fs = run["sched"], fused_run["sched"]
    dec = sorted(run["decode_ms"])
    fdec = sorted(fused_run["decode_ms"])
    info = {
        "config": str(default.cim), "quiet_equals_fused": True,
        "noisy_reproducible": True, "tokens": s["tokens"],
        "tokens_differing_from_fused": differ,
        "first_divergence_by_request": first,
        "tokens_per_s": s["tokens_per_s"], "wall_s": run["wall_s"],
        "decode_ms_median": dec[len(dec) // 2],
        "decode_ms_mean": sum(dec) / len(dec),
        "prefill_ms": run["prefill_ms"], "ttft_s": s["ttft_s"],
        "peak_bytes": run["peak_bytes"], "launches": run["launches"],
        "quiet_tokens_per_s": quiet["sched"]["tokens_per_s"],
        "breakdown": bd, "host_idle_share": 1.0 - bd["busy_share"],
        "fused_host_idle_share": 1.0 - fused_bd["busy_share"],
        "fused_tokens_per_s": fs["tokens_per_s"],
        "fused_decode_ms_median": fdec[len(fdec) // 2],
        "fused_peak_bytes": fused_run["peak_bytes"],
        "streams": run["streams"],
    }
    print(f"  acim quiet (registered as \"acim\"): streams == fused token for "
          f"token ({quiet['sched']['tokens_per_s']:.1f} tokens/s)")
    print(f"  acim {default.cim}: {s['tokens']} tokens in "
          f"{run['wall_s']:.3f} s ({s['tokens_per_s']:.1f} tokens/s, fused "
          f"{fs['tokens_per_s']:.1f}); decode {info['decode_ms_median']:.2f} "
          f"ms/step (fused {info['fused_decode_ms_median']:.2f}); peak "
          f"{run['peak_bytes']} B (fused {fused_run['peak_bytes']} B); "
          f"launches {run['launches']}")
    print(f"    two runs, one stream; {differ} of {s['tokens']} tokens differ "
          f"from the fused stream (first divergence by request {first}); "
          f"profiled: device {bd['device_ms']:.2f} ms of {bd['wall_ms']:.2f} "
          f"ms wall, host idle share {info['host_idle_share']:.3f} (fused "
          f"{info['fused_host_idle_share']:.3f}); "
          + "; ".join(f"{k} {v:.2f}" for k, v in bd["by_class_ms"].items()))
    launches["lm_acim"] = run["launches"]
    return info


# ----------------------------------------------------------------------------
# phase 7: B2 and the full-width B1 at the serving path's shapes
# ----------------------------------------------------------------------------


def b2_time_row(name: str, st: dict, q, k, v, qpos, kpos, kind: str,
                window: int = 0, softcap: float = 0.0) -> dict:
    """B2 timed on one set of operands (already held against plain,
    ``st``): L2-cold, warm (graph replay) and back-to-back, beside the
    plain version, ``scaled_dot_product_attention`` with the same boolean
    mask (none where there is a softcap: SDPA has none) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.attention.ref import flash_attention_plain

    b, s, hq, d = q.shape
    t = k.shape[1]
    args = dict(kind=kind, qpos=qpos, kpos=kpos, window=window,
                softcap=softcap)
    ms = cuda_ms(lambda: flash_attention(q, k, v, **args), reps=20)
    cold = cold_ms(lambda: flash_attention(q, k, v, **args))
    warm = graph_ms(lambda: flash_attention(q, k, v, **args), 20)
    plain = cuda_ms(lambda: flash_attention_plain(
        q, k, v, qpos, kpos, kind=kind, window=window, softcap=softcap,
        scale=d ** -0.5, kv_splits=st["kv_splits"]), reps=3, warmup=1)
    mask = (kpos[:, None, None, :] >= 0).expand(b, 1, s, t)  # (B, 1, S, T)
    if kind != "full":
        mask = mask & (kpos[:, None, None, :] <= qpos[:, None, :, None])
    if kind == "local":
        mask &= kpos[:, None, None, :] > qpos[:, None, :, None] - window
    lib = lib_warm = None
    if not softcap:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib, lib_warm = cold_ms(sdpa), graph_ms(sdpa, 20)
    pairs = int(mask.sum().item())          # admitted (q, k) per head
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, by = bound(nbytes, 4 * hq * d * pairs, BF16_FLOP_PER_S)
    row = {"kernel": "flash_attention", "shape": name, "B": b, "S": s,
           "T": t, "Hq": hq, "Hkv": k.shape[2], "window": window,
           "softcap": softcap, "admitted_pairs": pairs, "ms": cold,
           "cold_ms": cold, "warm_ms": warm, "event_ms": ms,
           "plain_ms": plain, "library_ms": lib, "library_warm_ms": lib_warm,
           "bound_ms": b_ms, "bound_by": by, **st}
    na = "n/a"
    print(f"  {name} B={b} S={s} T={t} Hq/Hkv={hq}/{k.shape[2]} D={d} | "
          f"{st['instance']} | {st['kv_splits']} | {cold:.4f} | {warm:.4f} "
          f"| {ms:.4f} | "
          f"{plain:.4f} | {na if lib is None else f'{lib:.4f}'} | "
          f"{na if lib_warm is None else f'{lib_warm:.4f}'} | {b_ms:.4f} "
          f"({by}) | {st['max_abs_err']:.3e} | {st['max_err_over_tol']:.3f}")
    return row


B2_TIME_HEADER = ("shape | instance | KV splits | kernel ms L2-cold | "
                  "warm (graph) | "
                  "back-to-back events | plain ms | sdpa ms L2-cold | warm "
                  "(graph) | bound ms (by) | max |err| | err / tol")
B1_TIME_HEADER = ("G half rows | feature splits | kernel ms L2-cold | warm "
                  "(graph) | plain ms | bound ms (by)")


def b1_time_row(dev, gen, grid: int, f: int, o: int, flags, nrows: int) -> dict:
    """B1 timed at one full-width FFN half: L2-cold and warm (graph
    replay), beside the plain version and the bound."""
    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.kernels.kan_spline import pipeline as pl

    lp, lw, _, codes, xraw, _ = cc.b1_case(dev, gen, grid, f, o, flags,
                                           nrows)
    a = (codes, xraw, lw, lp, nrows)
    splits = pl.feature_split_plan(lp.f, lp.o)[0]
    ms = graph_ms(lambda: pl.run_pipeline_layer(*a), 10)
    cold = cold_ms(lambda: pl.run_pipeline_layer(*a), reps=10)
    plain = cuda_ms(lambda: pl.run_pipeline_layer_plain(
        *a, feature_splits=splits), reps=2, warmup=1)
    b_ms, by = bound(*b1_work(lp, lw, nrows))
    print(f"  G={grid} {f}x{o} rows={nrows} | {splits} | {cold:.4f} | "
          f"{ms:.4f} | {plain:.4f} | {b_ms:.4f} ({by})")
    return {"kernel": "kan_pipeline_layer", "layer": f"ffn {f}x{o}",
            "grid": grid, "rows": nrows, "feature_splits": splits,
            "ms": cold, "cold_ms": cold, "warm_ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by}


def phase_times_lm(dev, report) -> tuple:
    """B2 at the three path shapes (returned summed, with the rows) and B1
    at the full-width FFN halves (returned as rows)."""
    import torch

    from repro_torch.kernels.attention import cardcheck as ac
    from repro_torch.kernels.kan_spline import cardcheck as cc

    rows = []
    print("B2 at the serving path's shapes, and decode over a 4096-key "
          "cache (bf16, 48 q heads / 8 kv heads, D=128), held against plain "
          f"(bf16 tol: one bf16 ulp + {ac.F32_TOL} + rel): "
          + B2_TIME_HEADER)
    for name, b, s, t, kind in ac.PATH_SHAPES + DECODE_LONG + VERIFY_SHAPES:
        # raises if the kernel disagrees with plain beyond the gate
        st, ops = ac.check_b2_path(dev, name, b, s, t, kind)
        row = b2_time_row(name, st, *ops, kind)
        row["on_path"] = (name, b, s, t, kind) in ac.PATH_SHAPES
        rows.append(row)

    print("B1 at the full-width KAN-FFN halves (raw residual; G=8 the "
          "target's, G=4 the drafter's): " + B1_TIME_HEADER)
    gen = torch.Generator(device=dev).manual_seed(13)
    for grid, f, o, flags, nrows in cc.B1_FFN_FULL + cc.B1_FFN_DRAFT:
        rows.append(b1_time_row(dev, gen, grid, f, o, flags, nrows))
    report["b1_row_tiles"] = b1_row_tile_times(dev)
    report["b1_loops"] = b1_loop_times(dev)
    report["times_lm"] = rows
    report["times_b4"] = phase_times_b4(dev)
    # the kernel line sums the three path shapes (as in earlier runs); the
    # 4096-key decode is reported beside them
    sel = [r for r in rows if r["kernel"] == "flash_attention" and r["on_path"]]
    by_time = {"bytes": 0.0, "operations": 0.0}
    for r in sel:
        by_time[r["bound_by"]] += r["bound_ms"]
    b2 = {"ms": sum(r["cold_ms"] for r in sel),
          "warm_ms": sum(r["warm_ms"] for r in sel),
          "event_ms": sum(r["event_ms"] for r in sel),
          "plain_ms": sum(r["plain_ms"] for r in sel),
          "library_ms": sum(r["library_ms"] for r in sel),
          "library_warm_ms": sum(r["library_warm_ms"] for r in sel),
          "bound_ms": sum(r["bound_ms"] for r in sel),
          "bound_by": max(by_time, key=by_time.get),
          "shapes": [r for r in rows if r["kernel"] == "flash_attention"]}
    return b2, [r for r in rows if r["kernel"] == "kan_pipeline_layer"]


# B1's two band loops timed at the full-width G=8 halves: qwen2.5-14b's at
# a decode bucket, reason's 256-row decode and rag's prefill buckets, the
# other decoders' at the rows PERF.md's B1 row lists, and the slice's G=8
# FFN stack at 65536 rows: (f, o, emit, rows)
B1_LOOP_SHAPES = (
    tuple((f, o, emit, rows)
          for f, o, emit in ((5120, 1280, True), (1280, 5120, False))
          for rows in (8, 256, 1024, 2048, 4096))
    + tuple((f, o, emit, rows)
            for (f, o, emit), rows_ in (
                ((4608, 3456, True), (8, 1024)), ((3456, 4608, False), (8, 1024)),
                ((4096, 1152, True), (8, 4096)), ((1152, 4096, False), (8, 4096)),
                ((512, 256, True), (8, 8192)), ((256, 512, False), (8, 8192)),
                ((5120, 1408, True), (8, 2048)), ((1408, 5120, False), (8, 2048)),
                ((64, 128, True), (65536,)), ((128, 64, False), (65536,)))
            for rows in rows_))


def b1_loop_times(dev) -> list:
    """B1's gather and register loops at :data:`B1_LOOP_SHAPES`, each
    forced through the launch code's test-only entry, L2-cold and warm,
    beside the bound and the loop the launch code takes there; raises if
    the two loops' y or codes differ in a bit."""
    import torch

    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.kernels.kan_spline import pipeline as pl

    gen = torch.Generator(device=dev).manual_seed(23)
    rows_out = []
    print("B1's loops at the G=8 halves (raw residual): half rows | rule | "
          "gather ms L2-cold / warm | register loop ms L2-cold / warm | "
          "bound ms (by) | cold speed-up")
    for f, o, emit, nrows in B1_LOOP_SHAPES:
        flags = (True, False, False, False, emit)
        lp, lw, _, codes, xraw, _ = cc.b1_case(dev, gen, pl.REGS_GRID, f, o,
                                               flags, nrows)
        splits = pl.feature_split_plan(lp.f, lp.o)[0]
        times, outs = {}, {}
        for loop, tile in (("gather", pl.ROW_TILES[-1]),
                           ("regs", pl.REGS_ROW_TILE)):
            def run(loop=loop, tile=tile):
                return pl._run_layer(codes, xraw, lw, lp, nrows, None, tile,
                                     splits, loop)

            outs[loop] = run()
            times[loop] = (cold_ms(run, reps=10), graph_ms(run, 10))
        torch.cuda.synchronize()
        (gy, gc), (ry, rc) = outs["gather"], outs["regs"]
        require(torch.equal(gy, ry) and (gc is None or torch.equal(gc, rc)),
                f"B1 {f}x{o} at {nrows} rows: the register loop differs "
                f"from the gather")
        b_ms, by = bound(*b1_work(lp, lw, nrows))
        rule = pl.b1_loop(nrows, lp.o, lp.spec)[0]
        gcold, gwarm = times["gather"]
        rcold, rwarm = times["regs"]
        print(f"  {f}x{o} rows={nrows} | {rule} | {gcold:.4f} / {gwarm:.4f} |"
              f" {rcold:.4f} / {rwarm:.4f} | {b_ms:.4f} ({by}) | "
              f"{gcold / rcold:.3f}")
        rows_out.append({"layer": f"ffn {f}x{o}", "rows": nrows,
                         "feature_splits": splits, "rule": rule,
                         "gather_cold_ms": gcold, "gather_warm_ms": gwarm,
                         "regs_cold_ms": rcold, "regs_warm_ms": rwarm,
                         "bound_ms": b_ms, "bound_by": by})
        del lw, codes, xraw, outs
        torch.cuda.empty_cache()
    return rows_out


def b1_row_tile_times(dev) -> list:
    """B1's gather loop at each row tile (``pipeline.ROW_TILES``) on the
    full-width G=8 FFN halves at 8 and 1024 rows, L2-cold and warm, after
    the card check of the tiles' bits (``cardcheck.check_b1_row_tiles``)."""
    import torch

    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.kernels.kan_spline import pipeline as pl

    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    print("B1's gather loop at each row tile, full-width G=8 halves: half "
          "rows | row tile |"
          " kernel ms L2-cold | warm (graph) (bits equal across tiles)")
    for grid, f, o, flags, nrows in cc.B1_FFN_FULL:
        cc.check_b1_row_tiles(dev, gen, grid, f, o, flags, nrows)
        lp, lw, _, codes, xraw, _ = cc.b1_case(dev, gen, grid, f, o, flags,
                                               nrows)
        for tile in pl.ROW_TILES:
            def run(tile=tile):
                return pl._run_layer(codes, xraw, lw, lp, nrows, None, tile,
                                     None, "gather")

            cold, ms = cold_ms(run, reps=10), graph_ms(run, 10)
            rows.append({"layer": f"ffn {f}x{o}", "rows": nrows,
                         "row_tile": tile, "cold_ms": cold, "warm_ms": ms})
            print(f"  {f}x{o} rows={nrows} | {tile} | {cold:.4f} | {ms:.4f}")
        del lw, codes, xraw
        torch.cuda.empty_cache()
    return rows


def phase_times_b4(dev, shapes=None) -> list:
    """B4 at ``shapes``, by default ``cardcheck.PATH_SHAPES`` (the simulator
    path's six first-layer MACs and the reference's largest case): each held
    against
    plain under the ADC contract, then timed L2-cold (``cold_ms``: the
    path's caller has just written a larger basis, so it finds x cold),
    warm from back-to-back events (``cuda_ms``) and warm from a CUDA-graph
    replay, beside its bound and plain version; one row per shape.  No
    library call computes the function (the ADC rounds each array's partial
    inside the contraction), so library_ms is None."""
    import torch

    from repro_torch.core.cim import CIMConfig
    from repro_torch.kernels.cim_mac import cardcheck as mc
    from repro_torch.kernels.cim_mac import cim_mac_arrays, cim_mac_plain
    from repro_torch.kernels.cim_mac.ref import tile_rows

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    print("B4 at the simulator path's shapes (held against plain, ADC "
          "contract): shape (B, R_total, A x R, C, adc) | cold ms | warm "
          "event ms | warm graph ms | cold x.sum() ms | plain ms | bound ms "
          "(by) | bound / cold | max |err| / LSB | library_ms: none")
    for name, b, r, c, arr, adc in shapes or mc.PATH_SHAPES:
        ops = mc.path_operands(dev, gen, b, r, c, arr)
        ir = CIMConfig(array_rows=arr, ir_gamma=0.06).ir_scale()
        st = mc.check_path(dev, ops, arr, ir, adc)
        x, w, load, fs = ops

        def run():
            return cim_mac_arrays(*ops, array_rows=arr, ir_scale=ir,
                                  adc_bits=adc)

        cold = cold_ms(run)
        # one cold read of x by a PyTorch reduction: the rate this card
        # reaches for these bytes (not the same function: no library_ms)
        read = cold_ms(x.sum)
        ms = cuda_ms(run, reps=20)
        g_ms = graph_ms(run, 20)
        # the plain version on the operands as the reference tiles them
        plain = cuda_ms(lambda: cim_mac_plain(*tile_rows(x, w, arr), load,
                                              fs, ir, adc), reps=3, warmup=1)
        n_arr = load.shape[0]
        # the function's own work: the R_total real rows, not the zero rows
        # that whole arrays would pad them with
        nbytes = 4 * (x.numel() + w.numel() + load.numel() + fs.numel()
                      + b * c)
        b_ms, by = bound(nbytes, 2 * b * r * c)
        rows.append({"kernel": "cim_mac_fwd", "shape": name, "B": b,
                     "R_total": r, "A": n_arr, "R": arr, "C": c,
                     "adc_bits": adc, "ms": cold, "cold_ms": cold,
                     "event_ms": ms, "graph_ms": g_ms, "read_ms": read,
                     "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     **st})
        print(f"  {name} ({b}, {r}, {n_arr} x {arr}, {c}, {adc}) | "
              f"{cold:.4f} | {ms:.4f} | {g_ms:.4f} | {read:.4f} | "
              f"{plain:.4f} | "
              f"{b_ms:.4f} ({by}) | {b_ms / cold:.3f} | "
              f"{st['max_err_over_allow']:.3f}")
        del ops, x, w, load, fs
        torch.cuda.empty_cache()
    return rows


def b4_totals(rows, mac) -> dict:
    """B4's kernel-line numbers: sums over the shapes that the MAC path
    (``mac``, phase 5b) launches, each of which must be a timed shape of
    ``rows``; the shapes it does not launch (the reference's C = 64 case)
    stand beside the sums, by name."""
    timed = {(r["shape"], r["B"], r["R_total"], r["C"], r["R"],
              r["adc_bits"]) for r in rows}
    for shape in mac["shapes"].values():
        require(shape in timed, f"B4: the MAC path's shape {shape} is not "
                "among the timed cardcheck.PATH_SHAPES")
    on = [r for r in rows if mac["launches_by_shape"].get(r["shape"], 0)]
    by_time = {"bytes": 0.0, "operations": 0.0}
    for r in on:
        by_time[r["bound_by"]] += r["bound_ms"]
    return {"ms": sum(r["cold_ms"] for r in on),
            "event_ms": sum(r["event_ms"] for r in on),
            "graph_ms": sum(r["graph_ms"] for r in on),
            "plain_ms": sum(r["plain_ms"] for r in on),
            "bound_ms": sum(r["bound_ms"] for r in on),
            "bound_by": max(by_time, key=by_time.get), "library_ms": None,
            "off_path_cold_ms": {r["shape"]: r["cold_ms"] for r in rows
                                 if r not in on},
            "shapes": rows}


# ----------------------------------------------------------------------------
# phase 8: the co-design flow at examples/tune_deploy.py's full budgets
# ----------------------------------------------------------------------------

# the knot task and search budgets of examples/tune_deploy.py:50-57 (its
# non-smoke settings) and the constraints of its HardwareConstraints
CODESIGN_TASK = dict(n_train=8192, n_val=1024, epochs=120, seed=0)
CODESIGN_SEARCH = dict(budget=32, n_init=8)
CODESIGN_HC = dict(max_area_mm2=0.02, max_energy_pj=300.0,
                   max_latency_ns=900.0)
CODESIGN_TILES = 16
# the paper's Fig. 13 headline ratios (MLP / KAN1) and the reference's bands
# for them (tests/test_costmodel_neurosim.py:43-53)
PAPER_RATIOS = {"area": (41.78, 30, 55), "energy": (77.97, 55, 105),
                "latency": (23.6, 20, 40)}


def phase_codesign(dev, report) -> dict:
    """Train the knot task's base network on the card, score it (float,
    fused, acim) beside the MLP baseline and the cost model's ratios,
    search the design space twice under one seed (the fronts must be
    equal), tune B1's tiles on the chosen point, save / reset / reload the
    artifact (the redeployed outputs must be bit-identical) and serve the
    full-width LM at the chosen point through ``launch.serve
    --tuned-config``.  Returns the phase's kernel launches."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch import runtime, tune
    from repro_torch.core.costmodel import accelerator_cost, mlp_accelerator
    from repro_torch.core.mlp_baseline import (
        PAPER_MLP_DIMS,
        init_mlp,
        mlp_param_count,
        train_mlp,
    )
    from repro_torch.core.neurosim import (
        HardwareConstraints,
        evaluate_accuracy,
        kan_cost,
    )
    from repro_torch.core.tmdv import PURE_PWM, TMDVConfig
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve as serve_cli

    steps = {}

    def step(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    def acc_of(logits, y):
        return float((logits.argmax(-1).cpu().numpy() == y).mean())

    runtime.reset_cache()
    cuda.reset_launch_counts()

    # the base network, trained on the card, and its accuracies
    task = step("train_kan", tune.make_knot_task, device=dev, **CODESIGN_TASK)
    base = tune.Candidate(grid_size=task.base_kspec.grid_size)
    _, _, base_dep = tune.deploy_candidate(task, base)
    acc = {"float": evaluate_accuracy(task.base_params, task.x_val,
                                      task.y_val, task.base_kspec),
           "fused": acc_of(runtime.execute(base_dep, task.x_val,
                                           backend="fused"), task.y_val),
           "acim": tune.evaluate_candidate(task, base)["accuracy"]}
    xt, yt, xv, yv = make_knot_dataset(
        CODESIGN_TASK["n_train"], CODESIGN_TASK["n_val"],
        seed=CODESIGN_TASK["seed"], label_noise=0.04)
    mlp = init_mlp(torch.Generator(device=dev).manual_seed(0), device=dev)
    _, mlp_hist = step("train_mlp", train_mlp, mlp, xt, yt, xv, yv)
    acc["mlp"] = mlp_hist[-1]
    print(f"knot task {CODESIGN_TASK}, base (17, 1, 14) G="
          f"{base.grid_size}: trained in {steps['train_kan']:.2f} s; "
          f"validation accuracy float {acc['float']:.4f}, fused "
          f"{acc['fused']:.4f}, acim {acc['acim']:.4f} (2 noise seeds); MLP "
          f"{PAPER_MLP_DIMS} ({mlp_param_count()} params, 200 epochs, "
          f"{steps['train_mlp']:.2f} s) {acc['mlp']:.4f}")

    # the cost model: KAN1 at the paper's point against the MLP accelerator
    kan1 = kan_cost((17, 1, 14), 5, 3, 8, TMDVConfig(8, 4), 128, 8)
    mlp_cost = accelerator_cost(mlp_accelerator(PAPER_MLP_DIMS, PURE_PWM(8)))
    ratios = {"area": mlp_cost["area_mm2"] / kan1["area_mm2"],
              "energy": mlp_cost["energy_pj"] / kan1["energy_pj"],
              "latency": mlp_cost["latency_ns"] / kan1["latency_ns"]}
    for k, (paper, lo, hi) in PAPER_RATIOS.items():
        require(lo < ratios[k] < hi, f"cost model: {k} ratio {ratios[k]:.2f} "
                f"outside the reference's band ({lo}, {hi})")
    print("cost model, MLP / KAN1 (G=5, 8 bit, TM-DV 4:4, 128 rows): "
          + ", ".join(f"{k} {ratios[k]:.2f}x (paper {PAPER_RATIOS[k][0]}x)"
                      for k in ratios)
          + f"; KAN1 {kan1}, MLP {mlp_cost}")

    # the search, twice under one seed
    hc = HardwareConstraints(**CODESIGN_HC)
    cfg = tune.SearchConfig(**CODESIGN_SEARCH)
    before = cuda.launch_counts()
    res = step("search", tune.pareto_search, task, tune.DesignSpace(),
               constraints=hc, config=cfg)
    after = cuda.launch_counts()
    search_b1 = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("kan_pipeline_layer", "kan_pipeline_layer.noise")}
    require(search_b1["kan_pipeline_layer.noise"] > 0,
            "search: no B1 launch with its noise operand")
    res2 = step("search_again", tune.pareto_search, task, tune.DesignSpace(),
                constraints=hc, config=cfg)
    require(res.to_dict() == res2.to_dict(),
            "search: two runs under one seed gave different fronts")
    per_eval = steps["search"] / res.n_evals
    print(f"search: {res.n_evals} candidates in {steps['search']:.2f} s "
          f"({per_eval * 1e3:.1f} ms per evaluation), B1 launches "
          f"{search_b1['kan_pipeline_layer']} ("
          f"{search_b1['kan_pipeline_layer.noise']} with noise); a second "
          f"run under seed {cfg.seed}: the same front "
          f"({steps['search_again']:.2f} s); front ({len(res.front)}):")
    for p in res.front:
        m = p.metrics
        print(f"  {p.candidate.to_dict()} | area {m['area_mm2']:.6f} mm2, "
              f"energy {m['energy_pj']:.3f} pJ, latency "
              f"{m['latency_ns']:.1f} ns, accuracy {m['accuracy']:.4f}")
    b = res.baseline
    print(f"  baseline {b.candidate.to_dict()}: energy "
          f"{b.metrics['energy_pj']:.3f} pJ, accuracy "
          f"{b.metrics['accuracy']:.4f}, feasible {b.feasible}; dominating "
          f"it on (energy, accuracy): {len(res.dominating_baseline())}")

    # the chosen point and B1's tiles
    chosen = tune.select_point(res.front)
    _, _, dep = tune.deploy_candidate(task, chosen.candidate)
    tile = step("tune_tiles", tune.tune_tiles, dep,
                max_candidates=CODESIGN_TILES)
    require(tile.mode == "measured", "tiles: not in measured mode")
    require(all(t.exact for t in tile.trials if t.valid),
            "tiles: a kept trial is not bit-exact")
    print(f"chosen {chosen.candidate.to_dict()}; B1 tile sweep at "
          f"{tile.bucket} rows ({tile.mode}): overrides | row tile | "
          "median ms | reason")
    for t in tile.trials:
        ms = t.score / 1e3 if np.isfinite(t.score) else float("inf")
        print(f"  {t.overrides} | {t.row_tile} | {ms:.4f} | "
              f"{t.reason or 'timed'}")
    print(f"  winner: {tile.chosen_overrides or 'the heuristic'} (row tile "
          f"{tile.chosen_plan.row_tile}), registered {tile.registered}")
    y1, c1 = runtime.execute(dep, task.x_val, backend="fused",
                             return_intermediates=True)

    # the artifact: save, reset, load, apply, redeploy
    out = ROOT / "reports"
    out.mkdir(exist_ok=True)
    path = out / "codesign_artifact.json"
    tune.save_tuning_artifact(str(path), tune.build_tuning_artifact(
        search=res, chosen=chosen, tile=tile, task=task.name))
    runtime.reset_cache()
    resolved = tune.apply_tuning_artifact(tune.load_tuning_artifact(str(path)))
    require(resolved["candidate"] == chosen.candidate,
            "artifact: another candidate came back")
    require(resolved["plan"] == tile.chosen_plan,
            "artifact: another tile plan came back")
    _, _, dep2 = tune.deploy_candidate(task, resolved["candidate"])
    y2, c2 = runtime.execute(dep2, task.x_val, backend="fused",
                             return_intermediates=True)
    require(torch.equal(y1, y2) and all(torch.equal(a, b)
                                        for a, b in zip(c1, c2)),
            "artifact: the reloaded deployment is not bit-identical")
    print(f"artifact {path.name}: reloaded and redeployed, outputs and "
          "boundary codes bit-identical")

    # the full-width LM served at the chosen point
    buf = io.StringIO()
    argv = ["--arch", "qwen2.5-14b", "--full-width-layers", str(SERVE_LAYERS),
            "--tuned-config", str(path), "--kan-ffn", "--requests", "2",
            "--max-new", "4"]
    with contextlib.redirect_stdout(buf):
        step("serve", serve_cli.main, argv)
    log = buf.getvalue()
    print("tuned serve: python -m repro_torch.launch.serve " + " ".join(argv))
    for ln in log.splitlines():
        if ln.startswith(("serve: kan-ffn", "serve: served", "serve: steps",
                          "serve: latency")):
            print(f"  {ln}")
    m = re.search(r"served requests=2 tokens=(\d+) tokens_per_s=([\d.]+)",
                  log)
    require(m is not None, f"tuned serve: no served line in {log[-2000:]}")
    launches = cuda.launch_counts()
    require(launches.get("flash_attention", 0) > 0
            and launches.get("kan_pipeline_layer", 0) > 0,
            "co-design path: B1 or B2 never launched")
    steps["total"] = sum(steps.values())
    print("phase 8 by step (s): " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in steps.items()))
    report["codesign"] = {
        "task": CODESIGN_TASK, "accuracy": acc, "cost_ratios": ratios,
        "kan1_cost": kan1, "mlp_cost": mlp_cost,
        "search": res.to_dict(), "search_b1": search_b1,
        "s_per_eval": per_eval, "chosen": chosen.to_dict(),
        "tiles": [{"overrides": t.overrides, "row_tile": t.row_tile,
                   "valid": t.valid, "exact": t.exact, "score_us": t.score,
                   "reason": t.reason} for t in tile.trials],
        "tile_winner": tile.chosen_overrides, "serve_tokens": int(m.group(1)),
        "serve_tokens_per_s": float(m.group(2)), "steps_s": steps,
        "launches": launches,
    }
    return {"codesign": launches}


# ----------------------------------------------------------------------------
# phase 9: LM training at full width
# ----------------------------------------------------------------------------

# the training cell: qwen2.5-14b kan_variant() at its published widths,
# depth cut to 4 layers (the model phase 6 serves), its own microbatch = 8
# and remat, AdamW at its learning rate; 16 x 256 tokens per step from
# lm_data (2 rows x 256 per microbatch)
TRAIN_LAYERS = 4
TRAIN_STEPS = 6
TRAIN_ARGV = ["--arch", "qwen2.5-14b", "--full-width-layers",
              str(TRAIN_LAYERS), "--kan-ffn", "--steps", str(TRAIN_STEPS),
              "--seq-len", "256", "--global-batch", "16",
              "--ckpt-every", "1000"]
OVERFIT_STEPS = 4
TRAIN_RANGES = ("train.forward", "train.backward", "train.optimizer")


def train_profile(prof, wall_ms: float) -> dict:
    """One profiled train step: device ms of the kernels launched inside
    each ``train.*`` range (a kernel belongs to the range whose host
    interval holds the op that launched it, on any thread: the backward's
    ops run on the autograd engine's thread while the caller waits inside
    ``train.backward``), the host ms of each range, the device busy and
    idle share of the wall inside the profiler, the top device ops, and
    the host's waits on the device and copies by runtime call."""
    import bisect
    import collections

    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    ops = {e.correlation_id(): e for e in cpu
           if e.linked_correlation_id() == 0 and e.correlation_id()}
    rs = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                if e.name() in TRAIN_RANGES)
    t0s = [r[0] for r in rs]
    parts = {n: {"count": 0, "host_ms": 0.0, "device_ms": 0.0}
             for n in TRAIN_RANGES + ("outside",)}
    for a, b, n in rs:
        parts[n]["count"] += 1
        parts[n]["host_ms"] += (b - a) / 1e6
    kernels = [e for e in evs if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not e.name().startswith("train.")]
    busy = 0.0
    for e in kernels:
        ms = (e.end_ns() - e.start_ns()) / 1e6
        busy += ms
        op = ops.get(e.linked_correlation_id())
        name = "outside"
        if op is not None:
            i = bisect.bisect_right(t0s, op.start_ns()) - 1
            if i >= 0 and rs[i][0] <= op.start_ns() <= rs[i][1]:
                name = rs[i][2]
        parts[name]["device_ms"] += ms
    # the host's waits (and copies) by runtime call and the op that made it
    waits = collections.Counter()
    for e in cpu:
        if e.name() in SYNC_CALLS:
            op = ops.get(e.linked_correlation_id())
            waits[f"{op.name() if op is not None else '-'} ({e.name()})"] += 1
    # the ops (on any thread) whose own kernels took the most device time
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU or ev.key.startswith("train."):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            top.append((us / 1e3, ev.count, ev.key))
    top = sorted(top, reverse=True)[:12]
    return {"parts": parts, "wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "kernels": len(kernels),
            "waits": dict(waits), "top": top}


def train_flops(cfg, tokens: int, seq: int) -> dict:
    """Matmul operations of one train step with remat: 2 per weight and
    token forward, 4 backward and 2 more for the blocks' recomputed
    forward; the "ref" attention's f32 QK^T and PV over full S x S logits
    (forward, recompute, backward x 2)."""
    d, hq, hd = cfg.d_model, cfg.phys_heads, cfg.head_dim
    hkv, h = cfg.phys_kv_heads, cfg.kan_d_hidden
    nb = cfg.kan_grid + cfg.kan_order
    block = d * hq * hd * 2 + d * hkv * hd * 2 + d * nb * h * 2 + d * h * 2
    head = d * cfg.vocab_size
    bf16 = tokens * (8 * block * cfg.num_layers + 6 * head)
    f32 = 4 * 4 * (tokens // seq) * seq * seq * hq * hd * cfg.num_layers
    return {"bf16": bf16, "f32": f32,
            "bound_ms": 1e3 * (bf16 / BF16_FLOP_PER_S + f32 / F32_FLOP_PER_S)}


def params_sha256(params) -> str:
    """sha256 of a parameter tree's bytes, leaf by leaf in the checkpoint's
    order, each copied to the host in turn."""
    import hashlib

    import torch

    from repro_torch.train.checkpoint import flatten

    h = hashlib.sha256()
    for t in flatten(params):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def phase_train(dev, report) -> None:
    """LM training: the float KAN-FFN's backward at the full-width halves,
    card against CPU and the in-place optimizer at small widths, a bf16
    restart, then the full-width 4-layer model trained through
    ``launch.train`` twice from one seed (equal losses), one step
    profiled, and one batch overfitted.  No phase launches B1 or B2 or
    dispatches "flash" attention here."""
    import contextlib
    import dataclasses
    import gc
    import io
    import math
    import statistics
    import tempfile

    import torch

    from repro_torch import obs, runtime
    from repro_torch.configs import smoke_config
    from repro_torch.data.lm_data import global_batch_at_step
    from repro_torch.kernels import cuda
    from repro_torch.launch import train as train_cli
    from repro_torch.train import cardcheck as tc
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    idle = (dict(cuda.launch_counts()),
            runtime.attn_dispatch_counts().get("flash", 0))
    out = {}

    # the float KAN-FFN's custom backward at the full-width halves
    out["spline_mm"] = [tc.check_spline_mm(dev, f, o, tokens=64)
                        for f, o in ((5120, 1280), (1280, 5120))]
    for r in out["spline_mm"]:
        print(f"_spline_mm {r['f']} -> {r['o']} at {r['tokens']} tokens, "
              f"custom backward vs autograd of the plain forward (f32): dx "
              f"{r['dx_max_abs_err']:.3e} (tol {r['dx_tol']:.3e}), dc "
              f"{r['dc_max_abs_err']:.3e} (tol {r['dc_tol']:.3e})")

    # card against CPU, the in-place optimizer, the bf16 restart
    narrow = smoke_config("qwen2.5-14b").kan_variant()
    cvc = tc.check_card_vs_cpu(dev, dataclasses.replace(
        narrow, microbatch=2, remat=True))
    print(f"card vs CPU, {cvc['params']} params f32, 3 steps (microbatch 2, "
          f"remat): losses {cvc['losses']}; grad norms {cvc['grad_norms']}; "
          f"params max |diff| {cvc['param_max_abs_err']:.3e} (tol "
          f"{cvc['tol']}), {cvc['excused']} elements excused (|g| < "
          f"{tc.GRAD_FLOOR})")
    inpl = tc.check_inplace_optimizer(dev)
    print(f"in-place optimizer == functional, bit for bit: {inpl}")
    rst = tc.check_restart(dev, dataclasses.replace(narrow, dtype="bfloat16"))
    print(f"bf16 restart at step 3: losses {rst['restarted']} == "
          f"uninterrupted {rst['losses'][3:]} ({rst['dtypes']})")
    out.update(card_vs_cpu=cvc, inplace=inpl, restart=rst)

    # the full-width model through the entry point, twice from one seed
    def train_run():
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(buf):
            gc.collect()   # earlier phases' garbage would hide some peak
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loop, hist = train_cli.main(TRAIN_ARGV + ["--ckpt-dir", d])
        for ln in buf.getvalue().splitlines():
            print(f"  {ln}")
        return loop, hist, base

    print("train: python -m repro_torch.launch.train " + " ".join(TRAIN_ARGV))
    t0 = time.perf_counter()
    loop, hist, base = train_run()
    run_s = time.perf_counter() - t0
    # the run's own peak: what earlier phases left allocated is not its
    peak = torch.cuda.max_memory_allocated() - base
    cfg, st = loop.cfg, loop.state
    losses = [m["loss"] for m in hist]
    lnv = math.log(cfg.vocab_size)
    require(int(st["good_steps"]) == TRAIN_STEPS
            and int(st["skipped_steps"]) == 0
            and all(math.isfinite(x) for x in losses),
            f"train: good {int(st['good_steps'])} skipped "
            f"{int(st['skipped_steps'])} losses {losses}")
    require(lnv <= losses[0] <= lnv + 2,
            f"train: step-0 loss {losses[0]} outside [ln V, ln V + 2] = "
            f"[{lnv:.4f}, {lnv + 2:.4f}]")
    n = sum(t.numel() for t in tree_leaves(st["params"]))
    reckon = {"params_bf16": 2 * n, "adamw_m_v_f32": 8 * n,
              "grad_accumulator_f32": 4 * n, "microbatch_grads_bf16": 2 * n}
    reckon["resident"] = sum(reckon.values())
    times = [m["time_s"] for m in hist]
    s_step = statistics.median(times[1:])
    tokens = 16 * 256
    fl = train_flops(cfg, tokens, 256)
    print(f"train: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} layers, "
          f"vocab {cfg.vocab_size}, KAN hidden {cfg.kan_d_hidden}, "
          f"{cfg.dtype}, microbatch {cfg.microbatch}, remat {cfg.remat}, "
          f"{cfg.optimizer} lr {cfg.learning_rate}; {n} parameters")
    print(f"train: losses {losses} (ln V = {lnv:.4f}); step s {times}; "
          f"median of steps 2-{TRAIN_STEPS} {s_step:.4f} s/step, "
          f"{tokens / s_step:.1f} tokens/s; run {run_s:.2f} s with init "
          f"({smi_line()})")
    print(f"train: peak device memory {peak} B (max_memory_allocated less "
          f"the {base} B allocated before the run) "
          f"against the reckoning " + ", ".join(
              f"{k} {v}" for k, v in reckon.items())
          + f"; card {torch.cuda.get_device_properties(dev).total_memory} B")
    print(f"train: matmul operations per step {fl['bf16']:.4e} bf16 + "
          f"{fl['f32']:.4e} f32 (attention); at peak {fl['bound_ms']:.2f} ms, "
          f"{fl['bound_ms'] / 1e3 / s_step:.3f} of the step")

    # one step profiled: the forward / backward / optimizer split
    batch = batch_to_device(global_batch_at_step(loop.data_cfg, TRAIN_STEPS),
                            dev)
    obs.enable_profiler_annotations()
    try:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            w0 = time.perf_counter()
            _, m = loop.step_fn(st, batch)
            float(m["loss"])
            wall_ms = (time.perf_counter() - w0) * 1e3
    finally:
        obs.disable_profiler_annotations()
    tp = train_profile(prof, wall_ms)
    print(f"train: profiled step {wall_ms:.2f} ms wall, device busy "
          f"{tp['device_ms']:.2f} ms, idle share {tp['idle_share']:.4f}, "
          f"{tp['kernels']} kernels; part | ranges | host ms | device ms: "
          + "; ".join(f"{k} | {v['count']} | {v['host_ms']:.2f} | "
                      f"{v['device_ms']:.2f}" for k, v in tp["parts"].items()))
    print("train: host waits and copies in the step, by the op that made "
          "them: " + "; ".join(f"{k} x{n}" for k, n in
                              sorted(tp["waits"].items(), key=lambda kv:
                                     -kv[1])))
    print("train: top ops by the device time of their kernels (ms, calls): "
          + "; ".join(f"{name} {ms:.2f} x{c}" for ms, c, name in tp["top"]))

    # overfitting: one batch, the loss falls at every step
    batch = batch_to_device(global_batch_at_step(loop.data_cfg,
                                                 TRAIN_STEPS + 1), dev)
    over = []
    for _ in range(OVERFIT_STEPS + 1):
        _, m = loop.step_fn(st, batch)
        over.append(float(m["loss"]))
    require(all(b < a for a, b in zip(over, over[1:])),
            f"train: one repeated batch, losses {over} do not fall at every "
            f"step")
    print(f"train: one batch repeated, losses {over}")
    del loop, st, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # determinism: a second run from the same seed; its untouched state's
    # parameter hash and its grad norms are what phase 14's meshed run
    # must equal
    loop, hist2, _ = train_run()
    losses2 = [m["loss"] for m in hist2]
    require(losses2 == losses,
            f"train: a second run from one seed gives losses {losses2} "
            f"against {losses}")
    params_hash = params_sha256(loop.state["params"])
    print(f"train: a second run from one seed: losses bit-equal {losses2}; "
          f"grad norms {[m['grad_norm'] for m in hist2]}; parameters "
          f"sha256 {params_hash}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()

    now = (dict(cuda.launch_counts()),
           runtime.attn_dispatch_counts().get("flash", 0))
    require(now == idle, f"train: B1/B2 launches or flash dispatches moved: "
            f"{idle} -> {now}")
    wall = time.perf_counter() - t_phase
    print(f"train: B1 / B2 launches and 'flash' dispatches unchanged over "
          f"the phase; phase wall {wall:.1f} s")
    report["train"] = {**out, "losses": losses, "losses_2": losses2,
                       "grad_norms_2": [m["grad_norm"] for m in hist2],
                       "params_sha256_2": params_hash,
                       "time_s": times, "s_per_step": s_step,
                       "tokens_per_s": tokens / s_step, "peak_bytes": peak,
                       "base_bytes": base, "reckoning_bytes": reckon,
                       "params": n, "flops": fl,
                       "profile": tp, "overfit": over, "wall_s": wall}


# ----------------------------------------------------------------------------
# phase 10: the sliding-window and MoE decoders at full width
# ----------------------------------------------------------------------------

# gemma2 / mixtral prompt lengths: the 4200-token prompt wraps the 4096-slot
# local rings in prefill (the window excludes keys there) and in decode
A7A_LENS = (5, 300, 1000, 4200)
# (arch, kan_variant, layers kept, modes, max_len, prompt lengths; None:
# phase 6's prompts): gemma2-27b's KAN variant (2 local / global pairs of
# its 46 layers), mixtral-8x7b (4 of 32 layers), olmoe-1b-7b whole (16
# layers), each at its published widths in bf16
A7A_MODELS = (("gemma2-27b", True, 4, ("contiguous",), 4608, A7A_LENS),
              ("mixtral-8x7b", False, 4, ("contiguous",), 4608, A7A_LENS),
              ("olmoe-1b-7b", False, 16, ("contiguous", "paged"),
               SERVE_MAX_LEN, None))
MOE_LAYER_TOKENS = (64, 1024)


def a7a_prompts(vocab: int, lens) -> list:
    """Prompts of ``lens`` tokens from numpy seed 7 (None: phase 6's)."""
    import numpy as np

    if lens is None:
        return serve_prompts(vocab)
    rng = np.random.default_rng(7)
    return [rng.integers(3, vocab, n).tolist() for n in lens]


def a7a_kernel_checks(dev, report) -> dict:
    """B1 at the gemma2 KAN-FFN halves, B2 at the windowed / MoE prefill
    geometry and over wrapped rings, and one full-width MoE layer of
    mixtral and olmoe, card against CPU; the kernels timed beside their
    plain versions, SDPA and bounds.  Returns the max abs errors."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import cardcheck as ac
    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.models.cardcheck import check_moe_layer

    gen = torch.Generator(device=dev).manual_seed(17)
    b1_err, b1_excused = 0.0, 0
    for grid, f, o, flags, rows in cc.B1_FFN_GEMMA2:
        st = cc.check_b1(dev, gen, grid, f, o, flags, rows,
                         eps=cc.FFN_FULL_TIE_EPS)
        b1_err = max(b1_err, st["max_abs_err"])
        b1_excused += st["excused"]
    rows_eq = cc.check_b1_rows_independent(dev, gen, f=4608, o=3456)
    print(f"B1 vs plain at the gemma2 kan_variant() halves (4608 -> 3456 -> "
          f"4608, G=8, 8 and 1024 rows): max |err| {b1_err:.3e}, excused "
          f"codes {b1_excused} (tie window {cc.FFN_FULL_TIE_EPS:.2e}); rows "
          f"bit-identical at 8 and 1024 rows: {rows_eq['equal']}")

    b2_rows, b2_err = [], 0.0
    print("B2 vs plain at the windowed / MoE decoders' shapes (bf16, D=128), "
          "then timed: " + B2_TIME_HEADER)
    for case in ac.B2_A7A:
        st, ops = ac.check_b2_case(dev, gen, **case)
        if case["kind"] == "local":
            require(st["window_excluded"] > 0,
                    f"B2 {case}: the window excludes no key")
        name = (f"prefill_{case['kind']}_g{case['hq'] // case['hkv']}"
                + (f"_cap{case['softcap']:g}" if case.get("softcap") else ""))
        row = b2_time_row(name, st, *ops, case["kind"],
                          case.get("window", 0) if case["kind"] == "local"
                          else 0, case.get("softcap", 0.0))
        row["window_excluded"] = st["window_excluded"]
        b2_rows.append(row)
        b2_err = max(b2_err, st["max_abs_err"])
        del ops
    for name, hq, hkv, cap in ac.B2_RING:
        st = ac.check_b2_ring(dev, name, hq, hkv, cap)
        row = b2_time_row(name, st, *ac.ring_inputs(dev, hq, hkv), "causal",
                          0, cap)
        row["non_monotone_slots"] = st["non_monotone_slots"]
        b2_rows.append(row)
        b2_err = max(b2_err, st["max_abs_err"])
    print("  pairs the window excludes per head (local cases): "
          + ", ".join(f"{r['shape']} {r['window_excluded']}" for r in b2_rows
                      if "window_excluded" in r)
          + "; ring slots below their predecessor: "
          + ", ".join(f"{r['shape']} {r['non_monotone_slots']}"
                      for r in b2_rows if "non_monotone_slots" in r))

    print("B1 at the gemma2 halves, timed: " + B1_TIME_HEADER)
    b1_rows = [b1_time_row(dev, gen, *case) for case in cc.B1_FFN_GEMMA2]

    moe_rows = []
    for arch in ("mixtral-8x7b", "olmoe-1b-7b"):
        cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
        for tokens in MOE_LAYER_TOKENS:
            t0 = time.perf_counter()
            st = {"arch": arch, **check_moe_layer(dev, cfg, tokens),
                  "s": time.perf_counter() - t0}
            moe_rows.append(st)
            print(f"MoE layer {arch} (E={cfg.num_experts}, top-"
                  f"{cfg.num_experts_per_tok}, {cfg.moe_dispatch}) at "
                  f"{tokens} tokens, card vs CPU: cap {st['cap']}, "
                  f"{st['dropped']} assignments dropped, {st['flipped']} "
                  f"tokens excused at a router near-tie, {st['displaced']} "
                  f"displaced behind them; max |err| {st['max_abs_err']:.4e}"
                  f" (tol {st['tol']:.4e}); {st['s']:.1f} s")
            torch.cuda.empty_cache()
    report["a7a_kernels"] = {"b1_max_abs_err": b1_err,
                             "b1_excused_codes": b1_excused,
                             "b1_rows_independent": rows_eq,
                             "b2": b2_rows, "b1": b1_rows, "moe": moe_rows}
    return {"kan_pipeline_layer": b1_err, "flash_attention": b2_err,
            "b2_rows": b2_rows, "b1_rows": b1_rows}


def replay_hook(rec: dict, force: dict | None = None):
    """``hook(eng)`` for :func:`serve_once`: every emitted step's logits
    row goes to ``rec["rows"]`` under (rid, token index), and
    ``rec["ctx"]`` names the requests of the call in flight (for
    :func:`logged_routes`).  With ``force`` ({rid: stream}) each step emits
    the stream's token instead of its own argmax, so a second engine run
    replays the first one's schedule: the same batches, chunks and idle
    slots, and so the same MoE capacities."""
    import numpy as np
    import torch

    def hook(eng):
        prefill, decode = eng._prefill_step, eng.decode_active

        def prefill_step(slot):
            rid = eng._prefilling[slot]["req"].rid
            rec["ctx"] = ("prefill", rid)
            logits = prefill(slot)
            rec["ctx"] = None
            if logits is None:
                return None
            rec["rows"][(rid, 0)] = torch.from_numpy(logits.copy())
            if force is not None:
                logits = logits.copy()
                logits[force[rid][0]] = np.inf
            return logits

        def decode_active(tokens):
            keys = [None if r is None else (r.rid, len(r.output))
                    for r in eng.active]
            rec["ctx"] = ("decode", keys)
            logits = decode(tokens)
            rec["ctx"] = None
            for i, key in enumerate(keys):
                if key is not None:
                    rec["rows"][key] = logits[i]
            if force is not None:
                live = [(i, force[key[0]][key[1]])
                        for i, key in enumerate(keys) if key is not None]
                idx = torch.tensor(live, device=logits.device)
                logits = logits.clone()
                logits[idx[:, 0], idx[:, 1]] = float("inf")
            return logits

        eng._prefill_step, eng.decode_active = prefill_step, decode_active

    return hook


class moe_routing:
    """While open, ``models.layers.moe_route`` is wrapped for the engine
    calls :func:`replay_hook` names (``rec["ctx"]``).  Recording (no
    ``replay``): each call's (context, experts, ranks, capacity) goes to
    ``rec["routes"]``.  Replaying (``replay``: a recording run's routes):
    each call routes as recorded, the recorded experts and ranks with
    gates from this run's own router logits at those experts, so the two
    runs differ only in what precedes the router; the tokens whose experts
    this run's own top-k would have moved are counted in ``rec["moved"]``,
    and the largest router gap (k-th minus (k+1)-th logit) among them in
    ``rec["moved_gap"]``.  Device tensors, read after the run."""

    def __init__(self, rec: dict, replay: list | None = None):
        self.rec, self.replay = rec, replay

    def __enter__(self):
        import torch

        from repro_torch.models import layers as L

        self.orig = orig = L.moe_route
        rec = self.rec
        rec.setdefault("routes", [])
        rec.setdefault("moved", [])
        rec.setdefault("moved_gap", [])
        todo = None if self.replay is None else iter(self.replay)

        def route(p, xt, cfg):
            out = orig(p, xt, cfg)
            ctx = rec["ctx"]
            if ctx is None:
                return out
            flat_e, _, pos, cap = out
            rec["routes"].append((ctx, flat_e, pos, cap))
            if todo is None:
                return out
            rctx, re, rpos, rcap = next(todo)
            require(rctx == ctx and rcap == cap,
                    f"replayed MoE call {ctx} (cap {cap}) is not the "
                    f"recorded {rctx} (cap {rcap})")
            k = cfg.num_experts_per_tok
            logits = xt.to(torch.float32) @ p["router"]
            gates = torch.softmax(logits.gather(1, re.view(-1, k)), dim=-1)
            # the same experts in another order route alike
            moved = (flat_e.view(-1, k).sort(dim=-1).values
                     != re.view(-1, k).sort(dim=-1).values).any(dim=-1)
            srt = torch.sort(logits, dim=-1, descending=True).values
            gap = srt[:, k - 1] - srt[:, k]
            rec["moved"].append(moved.sum())
            rec["moved_gap"].append(torch.where(moved, gap, 0.0).max())
            return re, gates.reshape(-1), rpos, cap

        L.moe_route = route
        return rec

    def __exit__(self, *exc):
        from repro_torch.models import layers as L

        L.moe_route = self.orig
        return False


def replay_gate(streams: dict, flash_rows: dict, ref_rows: dict) -> dict:
    """Each emitted token (flash run) scored on the "ref" replay's logits
    of the same step: its ref logit within LOGIT_TOL of the ref maximum."""
    import torch

    steps = argmax_diff = 0
    worst, errs = 0.0, {}
    for rid, out in streams.items():
        for idx, tok in enumerate(out):
            ref = ref_rows[(rid, idx)].float().cpu()
            fl = flash_rows[(rid, idx)].float().cpu()
            steps += 1
            worst = max(worst, float(ref.max() - ref[tok]))
            errs = logit_err_stats(fl, ref, torch.tensor(tok), errs)
            argmax_diff += int(int(ref.argmax()) != tok)
    return {"steps": steps, "argmax_diff": argmax_diff, "worst_gap": worst,
            **errs}


def f32_gate(params, cfg, prompts, dev, ekw: dict, label: str, layers: int,
             counts: dict, bf16_streams: dict) -> dict:
    """The teacher-forced gate on an f32 copy of a bf16 model (the same
    weights upcast, ``dtype="float32"``) served through the same engine:
    where a model's bf16 decode and whole-sequence forward part by more
    than ``LOGIT_TOL`` (two orders of one recurrence, rounded to bf16
    through many layers), the gate holds the f32 pair, which computes the
    same function.  Returns :func:`teacher_forced`'s stats with the f32
    run's largest |decode - forward| logit and how many of its streams
    equal the bf16 run's."""
    import dataclasses

    import torch

    from repro_torch.train.optimizer import tree_map

    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rec = {"rows": {}, "ctx": None}
    run = serve_once(p32, cfg32, prompts, dev, "contiguous", engine_kw=ekw,
                     hook=replay_hook(rec))
    check_counts(run, label, layers, kan=bool(ekw.get("kan_deploy")),
                 requests=len(prompts), **counts)
    streams = run["streams"]
    del run
    gate = teacher_forced(p32, cfg32, prompts, streams, dev,
                          served=rec["rows"])
    gate["streams_equal_bf16"] = sum(streams[r] == bf16_streams[r]
                                     for r in streams)
    del p32, rec
    torch.cuda.empty_cache()
    return gate


def a7a_config(arch: str, kan: bool, layers: int):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if kan:
        cfg = cfg.kan_variant()
    return dataclasses.replace(cfg, num_layers=layers)


def a7a_serve(dev, arch: str, kan: bool, layers: int, modes: tuple,
              max_len: int, lens, qwen_waits: set,
              path: str = "a7a", gate_f32: bool = False) -> tuple:
    """Serve one model: per mode a timed run (recording logits and
    routing for a MoE model), a profiled run (contiguous) and its gate
    (gemma2, the recurrent decoders: teacher-forced "ref" logits at the
    emitted rows; MoE: the flash run against a "ref"-attention replay of
    its schedule and routing).  With ``gate_f32`` the bf16 stream's
    teacher-forced gaps are recorded and the gate holds an f32 copy of the
    model served through the same engine (:func:`f32_gate`).  Returns
    (summary, launches by path, each path named ``{path}_{arch}_{mode}``)."""
    import gc

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    cfg = a7a_config(arch, kan, layers)
    moe = cfg.num_experts > 0
    kinds = cfg.layer_kinds
    counts = {"attn_layers": sum(k in ("global", "local") for k in kinds),
              "ffn_layers": sum(k != "ssm" for k in kinds)}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t_model = t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    if kan:
        params = quantize_kan_ffn_params_tree(params, cfg)
        gc.collect()            # the float KAN-FFN blocks
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    prompts = a7a_prompts(cfg.vocab_size, lens)
    ekw = {"max_len": max_len, "kan_deploy": kan}
    if moe:
        ffn = (f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} "
               f"({cfg.moe_dispatch}, capacity {cfg.moe_capacity_factor})")
    elif counts["ffn_layers"] == 0:
        ffn = (f"no FFN, SSD state {cfg.ssm_state} x head dim "
               f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    else:
        ffn = (f"KAN-FFN hidden {cfg.kan_d_hidden}" if kan else
               f"{cfg.ffn_kind} FFN {cfg.d_ff}")
    print(f"{arch}{' kan_variant()' if kan else ''}: {layers} of "
          f"{get_config(arch).num_layers} layers {list(kinds)}, d_model "
          f"{cfg.d_model}, heads {cfg.phys_heads}/{cfg.phys_kv_heads} (D "
          f"{cfg.head_dim}), {ffn}, "
          + f"window {cfg.window_size} on {sorted(set(cfg.layer_kinds))}, "
          f"vocab {cfg.vocab_size}, bf16: {n} parameters, init"
          f"{' + quantize + deploy' if kan else ''} {setup_s:.2f} s, "
          f"{weights} B on the card; prompts {[len(p) for p in prompts]}, "
          f"max_len {max_len}")
    out = {"arch": arch, "kan": kan, "layers": layers, "params": n,
           "weights_bytes": weights, "setup_s": setup_s,
           "prompt_lens": [len(p) for p in prompts], "modes": {}}
    launches = {}
    for mode in modes:
        label = f"{arch} {mode}"
        # the timed run; for a MoE model it also records each emitted
        # step's logits and every routing (device tensors, no wait)
        flash = {"rows": {}, "ctx": None}
        with moe_routing(flash):
            run = serve_once(params, cfg, prompts, dev, mode, engine_kw=ekw,
                             hook=(replay_hook(flash) if moe or gate_f32
                                   else None))
        check_counts(run, label, layers, kan=kan, requests=len(prompts),
                     **counts)
        launches[f"{path}_{arch}_{mode}"] = run["launches"]
        s = run["sched"]
        dec = sorted(run["decode_ms"])
        info = {"tokens": s["tokens"], "tokens_per_s": s["tokens_per_s"],
                "ttft_s": s["ttft_s"], "decode_ms_median": dec[len(dec) // 2],
                "prefill_ms": run["prefill_ms"],
                "peak_bytes": run["peak_bytes"] - base,
                "prefill_calls": run["prefill_calls"],
                "decode_calls": run["decode_calls"],
                "launches": run["launches"], "streams": run["streams"],
                "kv": run["kv"]}
        streams = run["streams"]
        del run
        if mode == "contiguous":
            obs.enable_profiler_annotations()
            try:
                prun = serve_once(params, cfg, prompts, dev, mode,
                                  profile=True, engine_kw=ekw)
            finally:
                obs.disable_profiler_annotations()
            check_counts(prun, f"{label} (profiled)", layers, kan=kan,
                         requests=len(prompts), **counts)
            require(prun["streams"] == streams,
                    f"{label}: the profiled run served other streams")
            bd = device_breakdown(prun["prof"], prun["prof_wall_s"] * 1e3)
            hs = host_split(prun["prof"], prun["prof_wall_s"] * 1e3,
                            prun["decode_calls"])
            del prun
            info.update(idle_share=1.0 - bd["busy_share"], breakdown=bd,
                        decode_waits_per_step=hs["decode_waits_per_step"],
                        waits_by_extent=hs["waits_by_extent"],
                        kernels_per_decode_step=hs["kernels_per_decode_step"])
            new = set(hs["decode_waits_per_step"]) - qwen_waits
            require(not new, f"{label}: decode steps wait on the device in "
                    f"ops phase 6's qwen2.5-14b run does not: {sorted(new)}")
        if moe:
            ref = {"rows": {}, "ctx": None}
            with moe_routing(ref, replay=flash["routes"]):
                rrun = serve_once(params, cfg, prompts, dev, mode,
                                  engine_kw={**ekw, "attn_backend": "ref"},
                                  hook=replay_hook(ref, force=streams))
            check_counts(rrun, f"{label} (ref replay)", layers, kan=kan,
                         requests=len(prompts), attn="ref", **counts)
            del rrun
            require(len(ref["routes"]) == len(flash["routes"]),
                    f"{label}: the replay made {len(ref['routes'])} MoE "
                    f"calls, the flash run {len(flash['routes'])}")
            gate = replay_gate(streams, flash["rows"], ref["rows"])
            gate["moved_tokens"] = int(sum(ref["moved"]).item())
            gate["moved_max_gap"] = float(max(ref["moved_gap"]).item())
            drops = {"decode": 0, "prefill": 0}
            for (kind, _), _, pos, cap in flash["routes"]:
                drops[kind] += int((pos >= cap).sum())
            info.update(gate=gate, drops_per_decode_step=drops["decode"]
                        / max(info["decode_calls"], 1),
                        prefill_drops=drops["prefill"],
                        assignments_per_decode_step=SERVE_SLOTS
                        * cfg.num_experts_per_tok * layers)
            del ref
        elif gate_f32:
            info["bf16_teacher_forced"] = bf = teacher_forced(
                params, cfg, prompts, streams, dev, served=flash["rows"])
            print(f"    bf16 stream, teacher-forced (not gated): worst ref gap "
                  f"{bf['worst_gap']:.4f}, {bf['excused']} of {bf['steps']} "
                  f"tokens not the forward's argmax, max |decode - forward| "
                  f"logit {bf['max_served_err']:.4f}")
            info["gate"] = f32_gate(params, cfg, prompts, dev, ekw,
                                    f"{label} (f32)", layers, counts, streams)
        else:
            info["gate"] = teacher_forced(params, cfg, prompts, streams, dev)
        del flash
        out["modes"][mode] = info
        g = info["gate"]
        ttft = info["ttft_s"]
        print(f"  {mode}: {len(streams)} requests, {info['tokens']} tokens "
              f"({info['tokens_per_s']:.1f} tokens/s); {info['prefill_calls']}"
              f" prefill + {info['decode_calls']} decode calls; decode "
              f"{info['decode_ms_median']:.2f} ms/step (median, "
              f"{SERVE_SLOTS} slots); TTFT p50 {ttft['p50'] * 1e3:.1f} ms "
              f"p95 {ttft['p95'] * 1e3:.1f} ms; peak {info['peak_bytes']} B "
              f"over the {base} B allocated before the model;"
              f" launches {info['launches']}"
              + (f"; idle share {info['idle_share']:.3f}, "
                 f"{info['kernels_per_decode_step']:.1f} kernels per decode "
                 "step, waits per decode step " + (", ".join(
                     f"{k} {v:.2f}" for k, v in
                     info["decode_waits_per_step"].items()) or "none")
                 + f" ({info['waits_by_extent']} owned by the op around "
                 "them)" if "idle_share" in info else "")
              + (f"; MoE assignments dropped {info['drops_per_decode_step']:.2f}"
                 f" per decode step (of {info['assignments_per_decode_step']}"
                 f"), {info['prefill_drops']} in prefill" if moe else ""))
        what = ('"ref"-attention replay of the schedule' if moe else
                'teacher-forced "ref" backends, f32 copy' if gate_f32 else
                'teacher-forced "ref" backends')
        print(f"    gate vs the {what}: {g['steps']} steps"
              + (f" (the replay routed as the flash run; its own top-k "
                 f"would have moved {g['moved_tokens']} tokens, at router "
                 f"gaps of at most {g['moved_max_gap']:.3e})"
                 if moe else "")
              + f"; worst ref gap {g['worst_gap']:.4f} (tol {LOGIT_TOL}), "
              + err_site(g)
              + (f", max |decode - forward| logit {g['max_served_err']:.3e},"
                 f" {g['streams_equal_bf16']} of {len(streams)} streams "
                 "equal to bf16's" if gate_f32 else ""))
        require(g["worst_gap"] <= LOGIT_TOL,
                f"{label}: a served token's ref logit is {g['worst_gap']:.4f}"
                f" below the ref maximum (tol {LOGIT_TOL})")
    out["wall_s"] = time.perf_counter() - t_model
    print(f"  {arch}: {out['wall_s']:.1f} s with its setup")
    if len(modes) > 1:
        same = (out["modes"]["contiguous"]["streams"]
                == out["modes"]["paged"]["streams"])
        out["contiguous_equals_paged"] = same
        print(f"  contiguous and paged streams equal: {same} (MoE "
              "capacities follow each mode's batches, so they may part)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def phase_a7a(dev, report) -> tuple:
    """Phase 10.  Returns (launches by path, kernel errors, timed rows)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10 starts with {torch.cuda.memory_allocated()} B allocated "
          "by earlier phases")
    t0 = time.perf_counter()
    checks = a7a_kernel_checks(dev, report)
    print(f"phase 10 kernel and MoE-layer checks: "
          f"{time.perf_counter() - t0:.1f} s")
    qwen_waits = set(report["serve"]["host_split_contiguous"][
        "decode_waits_per_step"])
    by_path, models = {}, []
    for model in A7A_MODELS:
        info, launches = a7a_serve(dev, *model, qwen_waits)
        models.append(info)
        by_path.update(launches)
    report["a7a"] = models
    return by_path, checks


# ----------------------------------------------------------------------------
# phase 11: the recurrent decoders at full width
# ----------------------------------------------------------------------------

# recurrentgemma prompt lengths: the 2300-token prompt runs past the
# 2048-key window of its local layers in prefill and wraps their rings
A7B_LENS = (5, 300, 1000, 2300)
# (arch, kan_variant, layers kept, modes, max_len, prompt lengths; None:
# phase 6's prompts): recurrentgemma-9b's KAN variant, 8 of its 38 layers
# (2 x (rglru, rglru, local) + (rglru, rglru), the shape of 12 x 3 + 2),
# and mamba2-370m, 24 of its 48 "ssm" layers (cut so that the whole script
# stays near half its time limit; every layer has the same shapes), at
# their published widths in bf16; both contiguous only (recurrent states
# have no pages)
A7B_MODELS = (("recurrentgemma-9b", True, 8, ("contiguous",), 2432, A7B_LENS),
              ("mamba2-370m", False, 24, ("contiguous",), SERVE_MAX_LEN,
               None))
# mamba2's bf16 decode (the one-step recurrence) and its teacher-forced
# forward (the chunked scan) round their activations differently through
# its residual layers (0.5293 apart at all 48, H100), so its gate holds an
# f32 copy served the same way (f32_gate); the bf16 run's gaps are
# recorded beside it
A7B_GATE_F32 = ("mamba2-370m",)
A7B_LAYER_TOKENS = 1000
A7B_LAYER_STEPS = 4


def a7b_kernel_checks(dev, report) -> dict:
    """B1 at the recurrentgemma KAN-FFN halves, B2 at its local layer's
    D = 256 prefill past the window and decode over wrapped rings, then
    one full-width RG-LRU layer and one Mamba-2 block card against CPU;
    the kernels timed beside their plain versions, SDPA and bounds.
    Returns the max abs errors and the timed rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import cardcheck as ac
    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.models.cardcheck import check_recurrent_layer

    gen = torch.Generator(device=dev).manual_seed(23)
    b1_err, b1_excused = 0.0, 0
    for grid, f, o, flags, rows in cc.B1_FFN_RGEMMA:
        st = cc.check_b1(dev, gen, grid, f, o, flags, rows,
                         eps=cc.FFN_FULL_TIE_EPS)
        b1_err = max(b1_err, st["max_abs_err"])
        b1_excused += st["excused"]
    rows_eq = cc.check_b1_rows_independent(dev, gen, f=4096, o=1152)
    print(f"B1 vs plain at the recurrentgemma kan_variant() halves (4096 -> "
          f"1152 -> 4096, G=8, 8 and 4096 rows): max |err| {b1_err:.3e}, "
          f"excused codes {b1_excused} (tie window "
          f"{cc.FFN_FULL_TIE_EPS:.2e}); rows bit-identical at 8 and 1024 "
          f"rows: {rows_eq['equal']}")

    b2_rows, b2_err = [], 0.0
    print("B2 vs plain at recurrentgemma's local layer (bf16, D=256, 16 / 1 "
          "heads: the tensor-core instance), then timed: " + B2_TIME_HEADER)
    for case in ac.B2_A7B:
        st, ops = ac.check_b2_case(dev, gen, **case)
        require(st["window_excluded"] > 0,
                f"B2 {case}: the window excludes no key")
        require(st["instance"] == "mma",
                f"B2 {case}: the {st['instance']} instance ran")
        row = b2_time_row(f"prefill_local_g{case['hq'] // case['hkv']}_d"
                          f"{case['d']}", st, *ops, "local", case["window"])
        row["window_excluded"] = st["window_excluded"]
        b2_rows.append(row)
        b2_err = max(b2_err, st["max_abs_err"])
        del ops
    for name, hq, hkv, cap, d, window in ac.B2_RING_A7B:
        st = ac.check_b2_ring(dev, name, hq, hkv, cap, d=d, window=window)
        require(st["instance"] == "mma" and st["kv_splits"] > 1,
                f"B2 {name}: {st['instance']} instance, "
                f"{st['kv_splits']} KV splits")
        row = b2_time_row(name, st, *ac.ring_inputs(dev, hq, hkv,
                                                    window=window, d=d),
                          "causal", 0, cap)
        row["non_monotone_slots"] = st["non_monotone_slots"]
        b2_rows.append(row)
        b2_err = max(b2_err, st["max_abs_err"])
    print(f"  pairs the window excludes per head: "
          f"{b2_rows[0]['window_excluded']}; ring slots below their "
          f"predecessor: {b2_rows[-1]['non_monotone_slots']}")

    print("B1 at the recurrentgemma halves, timed: " + B1_TIME_HEADER)
    b1_rows = [b1_time_row(dev, gen, *case) for case in cc.B1_FFN_RGEMMA]

    layer_rows = []
    for arch, kind in (("recurrentgemma-9b", "rglru"), ("mamba2-370m", "ssm")):
        t0 = time.perf_counter()
        st = {"arch": arch, "kind": kind,
              **check_recurrent_layer(dev, get_config(arch), kind,
                                      tokens=A7B_LAYER_TOKENS,
                                      steps=A7B_LAYER_STEPS),
              "s": time.perf_counter() - t0}
        layer_rows.append(st)
        print(f"{kind} layer of {arch} at full width, card vs CPU ("
              f"{st['tokens']}-token prefill, {st['steps']} decode steps): "
              f"outputs within {st['out_ulps']:.3f} bf16 ulps of max|out| "
              f"(tol 4), conv states within {st['conv_ulps']:.3f} ulps of "
              f"max|conv| (tol 1; {st['conv_diff']} elements differ), "
              f"f32 states within {st['state_ulps']:.3f} bf16 ulps of "
              f"max|state| (tol 2); {st['s']:.1f} s")
        torch.cuda.empty_cache()
    report["a7b_kernels"] = {"b1_max_abs_err": b1_err,
                             "b1_excused_codes": b1_excused,
                             "b1_rows_independent": rows_eq,
                             "b2": b2_rows, "b1": b1_rows,
                             "layers": layer_rows}
    return {"kan_pipeline_layer": b1_err, "flash_attention": b2_err,
            "b2_rows": b2_rows, "b1_rows": b1_rows}


def phase_a7b(dev, report) -> tuple:
    """Phase 11.  Returns (launches by path, kernel errors, timed rows)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 starts with {torch.cuda.memory_allocated()} B allocated "
          "by earlier phases")
    t0 = time.perf_counter()
    checks = a7b_kernel_checks(dev, report)
    print(f"phase 11 kernel and layer checks: "
          f"{time.perf_counter() - t0:.1f} s")
    qwen_waits = set(report["serve"]["host_split_contiguous"][
        "decode_waits_per_step"])
    by_path, models = {}, []
    for model in A7B_MODELS:
        info, launches = a7a_serve(dev, *model, qwen_waits, path="a7b",
                                   gate_f32=model[0] in A7B_GATE_F32)
        models.append(info)
        by_path.update(launches)
    report["a7b"] = models
    return by_path, checks


# ----------------------------------------------------------------------------
# phase 12: the encoder and patch prefixes at full width
# ----------------------------------------------------------------------------

# whisper-base kan_variant(), all 6 + 6 layers: 4 clips of one 30-s window
# (1500 stub frames each), the decoder prompted with the 4 special tokens
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|> of its
# 51865-word vocabulary, 64 greedy new tokens, one batch of 4; the decoder
# cache holds whisper's 448 text positions
A7C_WHISPER_CLIPS = 4
A7C_WHISPER_PROMPT = (50258, 50259, 50359, 50363)
A7C_WHISPER_NEW = 64
A7C_WHISPER_MAX_LEN = 448
# pixtral-12b kan_variant(), 4 of its 40 layers: one request at a time
# (B = 1), 256 stub patches each, prompts of 5, 300 and 1000 tokens
# (numpy seed 7), 16 greedy new tokens; a cache of 256 + 1000 + 16
# positions
A7C_PIXTRAL_LAYERS = 4
A7C_PIXTRAL_LENS = (5, 300, 1000)
A7C_PIXTRAL_NEW = 16
A7C_PIXTRAL_MAX_LEN = 256 + 1000 + 16
# new tokens per batch of the profiled run (its analysis takes seconds per
# thousand decode-step kernels)
A7C_PROFILE_NEW = 16


def a7c_kernel_checks(dev, report) -> dict:
    """B1 at whisper's and pixtral's kan_variant() FFN halves, B2 at the
    encoder / cross / patch-prefix geometry, and one full-width whisper
    encoder layer and cross-attention decoder layer card against CPU; the
    kernels timed beside their plain versions, SDPA and bounds.  Returns
    the max abs errors and the timed rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import cardcheck as ac
    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.models.cardcheck import check_encdec_layers

    gen = torch.Generator(device=dev).manual_seed(29)
    b1_err, b1_excused, rows_eq = 0.0, 0, {}
    for name, cases, (f, o) in (("whisper", cc.B1_FFN_WHISPER, (512, 256)),
                                ("pixtral", cc.B1_FFN_PIXTRAL, (5120, 1408))):
        err = excused = 0
        for grid, f_, o_, flags, rows in cases:
            st = cc.check_b1(dev, gen, grid, f_, o_, flags, rows,
                             eps=cc.FFN_FULL_TIE_EPS)
            err = max(err, st["max_abs_err"])
            excused += st["excused"]
        rows_eq[name] = cc.check_b1_rows_independent(dev, gen, f=f, o=o)
        b1_err, b1_excused = max(b1_err, err), b1_excused + excused
        print(f"B1 vs plain at the {name} kan_variant() halves ({f} -> {o} "
              f"-> {f}, G=8, rows {sorted({c[-1] for c in cases})}): max "
              f"|err| {err:.3e}, excused codes {excused} (tie window "
              f"{cc.FFN_FULL_TIE_EPS:.2e}); rows bit-identical at 8 and 1024 "
              f"rows: {rows_eq[name]['equal']}")

    b2_rows, b2_err = [], 0.0
    print("B2 vs plain at whisper's encoder / cross attention (8 / 8 heads, "
          "D=64) and pixtral's patch-prefix prefill (32 / 8, D=128), bf16, "
          "then timed: " + B2_TIME_HEADER)
    for name, case in ac.B2_A7C:
        st, ops = ac.check_b2_case(dev, gen, **case)
        b2_rows.append(b2_time_row(name, st, *ops, case["kind"]))
        b2_err = max(b2_err, st["max_abs_err"])
        del ops
    require(next(r for r in b2_rows if r["shape"] == "whisper_cross_decode")
            ["kv_splits"] > 1, "B2 whisper_cross_decode: the KV axis is not "
            "split")

    print("B1 at the whisper and pixtral halves, timed: " + B1_TIME_HEADER)
    b1_rows = [b1_time_row(dev, gen, *case)
               for case in cc.B1_FFN_WHISPER + cc.B1_FFN_PIXTRAL]

    t0 = time.perf_counter()
    layers = check_encdec_layers(dev, get_config("whisper-base"))
    layers["s"] = time.perf_counter() - t0
    print(f"whisper-base encoder layer (bidir, {layers['batch']} x "
          f"{layers['frames']} frames) and cross-attention decoder layer "
          f"({layers['prompt']}-token prefill, {layers['steps']} decode "
          f"steps) at full width, card vs CPU: encoder within "
          f"{layers['enc_ulps']:.3f} bf16 ulps of max|out|, decoder within "
          f"{layers['dec_ulps']:.3f} (tol {4}), cross K/V within "
          f"{layers['xkv_ulps']:.3f} ulps of max|kv| (tol 1), unchanged by "
          f"decode: {layers['xkv_unchanged']}; {layers['s']:.1f} s")
    torch.cuda.empty_cache()
    report["a7c_kernels"] = {"b1_max_abs_err": b1_err,
                             "b1_excused_codes": b1_excused,
                             "b1_rows_independent": rows_eq,
                             "b2": b2_rows, "b1": b1_rows, "layers": layers}
    return {"kan_pipeline_layer": b1_err, "flash_attention": b2_err,
            "b2_rows": b2_rows, "b1_rows": b1_rows}


def a7c_generate(params, cfg, batch: dict, new: int, max_len: int,
                 sink: dict | None = None) -> tuple:
    """Greedy generation through the model's own entry points (no engine
    serves these families): ``prefill``, then ``new - 1`` ``decode_step``
    calls, on the "fused" KAN and "flash" attention backends, each step's
    token read on the host as a server streams it.  The calls run under
    the engine's span names (``serve.prefill``, ``serve.decode_step``).
    Returns (tokens (B, new) on the host, each step's logits rows on the
    card); with ``sink``, the host times: ``ttft_ms`` (prefill and its
    token read), ``decode_ms`` per step."""
    import torch

    from repro_torch import runtime
    from repro_torch.models import model as M
    from repro_torch.obs.trace import profile_scope

    npfx = cfg.num_patches if cfg.family == "vlm" else 0
    b, s = batch["tokens"].shape
    rows, toks = [], []
    with (runtime.use_backend("fused"), runtime.use_attn_backend("flash"),
          torch.no_grad()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile_scope("serve.prefill"):
            logits, cache = M.prefill(params, batch, cfg, max_len)
            tok = logits.argmax(dim=-1)
            toks.append(tok.cpu())
        if sink is not None:
            sink["ttft_ms"] = (time.perf_counter() - t0) * 1e3
            sink["decode_ms"] = []
        rows.append(logits)
        pos = torch.full((b,), npfx + s, device=tok.device)
        for _ in range(new - 1):
            t0 = time.perf_counter()
            with profile_scope("serve.decode_step"):
                logits, cache = M.decode_step(params, cache, tok, pos, cfg)
                tok = logits.argmax(dim=-1)
                toks.append(tok.cpu())
            if sink is not None:
                sink["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            rows.append(logits)
            pos = pos + 1
    del cache
    return torch.stack(toks, dim=1), torch.stack(rows, dim=1)


def a7c_gate(params, cfg, batch: dict, tokens, served) -> dict:
    """The teacher-forced gate: one ``forward`` over the prompt and the
    emitted tokens (but the last), with the same stub embeddings, on the
    "ref" KAN and "ref" attention backends, and again on "fused" +
    "flash".  Each emitted token's ref logit within LOGIT_TOL of the ref
    maximum (the gate), and of the fused + flash forward's maximum
    (prefill and decode against the forward on the same backends, as the
    reference's ``test_prefill_then_decode_matches_forward``); recorded:
    the largest |flash - ref| and |served - forward| logits, the |logit|
    where the former lies and that difference in bf16 ulps there."""
    import torch

    from repro_torch import runtime
    from repro_torch.models import model as M

    s = batch["tokens"].shape[1]
    seq = torch.cat([batch["tokens"], tokens[:, :-1].to(
        batch["tokens"].device)], dim=1)
    rows = {}
    with torch.no_grad():
        for kan, attn in (("ref", "ref"), ("fused", "flash")):
            with runtime.use_backend(kan), runtime.use_attn_backend(attn):
                rows[attn] = M.forward(params, {**batch, "tokens": seq},
                                       cfg)[:, s - 1:]
    ref, fl = rows["ref"], rows["flash"]
    require(ref.shape == served.shape and bool(torch.isfinite(ref).all())
            and bool(torch.isfinite(fl).all())
            and bool(torch.isfinite(served).all()),
            f"{cfg.name}: bad logits {tuple(ref.shape)} vs served "
            f"{tuple(served.shape)}")
    tok = tokens.to(ref.device)[..., None]

    def gap(x):
        return (x.max(dim=-1).values - x.gather(-1, tok)[..., 0]).max().item()

    return {"steps": tokens.numel(), "worst_gap": gap(ref),
            "worst_gap_forward": gap(fl),
            "excused": int((ref.argmax(dim=-1) != tok[..., 0]).sum()),
            **logit_err_stats(fl, ref, tok[..., 0]),
            "max_served_err": (served - fl).abs().max().item()}


def a7c_model(dev, arch: str, layers: int) -> tuple:
    """``arch``'s kan_variant() at its published widths, ``layers`` deep,
    bf16, random weights from seed 0, its KAN-FFN blocks quantized and
    deployed (encoder and decoder).  Returns (params, cfg, stats)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(arch).kan_variant(),
                              num_layers=layers)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    params = quantize_kan_ffn_params_tree(params, cfg)
    gc.collect()            # the float KAN-FFN blocks
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return params, cfg, {"params": n, "base_bytes": base,
                         "weights_bytes": torch.cuda.memory_allocated() - base,
                         "setup_s": time.perf_counter() - t0}


def a7c_cache_bytes(cfg, b: int, max_len: int) -> int:
    """Bytes of the contiguous caches ``init_cache`` allocates: self K/V of
    ``max_len`` positions and, with an encoder, cross K/V of ``enc_seq``."""
    per_pos = 2 * cfg.phys_kv_heads * cfg.head_dim * 2          # K + V, bf16
    t = max_len + (cfg.enc_seq if cfg.encoder_layers else 0)
    return cfg.num_layers * b * t * per_pos


def a7c_run(dev, params, cfg, label: str, batches: list, new: int,
            max_len: int, stats: dict, qwen_waits: set) -> tuple:
    """Serve ``batches`` one after another through :func:`a7c_generate`:
    a warm-up, the timed run (launch counts: B2 on every attention and
    cross-attention layer, B1 twice per KAN-FFN layer of every call), a
    profiled run of the first A7C_PROFILE_NEW tokens of the same streams
    (idle share, kernels and waits per decode step), and each batch's gate.
    Returns (summary, launches)."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import cuda

    steps_s = {}
    t_step = time.perf_counter()
    enc = cfg.encoder_layers
    # per call: prefill runs the encoder too; decode the decoder alone
    calls = len(batches) * new
    want = {"flash_attention": len(batches) * (enc + cfg.num_layers * (
        2 if enc else 1)) + len(batches) * (new - 1) * cfg.num_layers * (
        2 if enc else 1),
        "kan_pipeline_layer": 2 * (len(batches) * (enc + cfg.num_layers)
                                   + len(batches) * (new - 1)
                                   * cfg.num_layers)}
    for bt in batches:          # warm-up: library, plans, allocator
        a7c_generate(params, cfg, bt, 2, max_len)
    enc_ms = None
    if enc:
        from repro_torch import runtime
        from repro_torch.models import model as M

        with (runtime.use_backend("fused"), runtime.use_attn_backend("flash"),
              torch.no_grad()):
            enc_ms = cuda_ms(lambda: M._encode(params, batches[0], cfg), 3, 1)
    torch.cuda.synchronize()
    steps_s["warm_up"] = time.perf_counter() - t_step
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t_run = time.perf_counter()
    outs, times = [], []
    for bt in batches:
        sink = {}
        outs.append(a7c_generate(params, cfg, bt, new, max_len, sink))
        times.append(sink)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() - stats["base_bytes"]
    require(by_kernel(launches) == want, f"{label}: launches {launches} != {want} "
            f"({calls} calls; B2 on every self- and cross-attention layer, "
            "B1 twice per KAN-FFN layer, encoder at prefill)")
    kept = sum(r.numel() * r.element_size() for _, r in outs)
    # one batch's caches are alive at a time
    cache = a7c_cache_bytes(cfg, batches[0]["tokens"].shape[0], max_len)
    steps_s["timed"] = time.perf_counter() - t_step - steps_s["warm_up"]
    # the profiled run: the same streams, the spans' profiler ranges on
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    pnew = min(new, A7C_PROFILE_NEW)
    t0 = time.perf_counter()
    obs.enable_profiler_annotations()
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t_in = time.perf_counter()
            pouts = [a7c_generate(params, cfg, bt, pnew, max_len)
                     for bt in batches]
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t_in) * 1e3
    finally:
        obs.disable_profiler_annotations()
    require(all(torch.equal(a[0][:, :pnew], b[0]) for a, b in zip(outs,
                                                                  pouts)),
            f"{label}: the profiled run served other tokens")
    del pouts
    steps_s["profiled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bd = device_breakdown(prof, prof_wall)
    hs = host_split(prof, prof_wall, len(batches) * (pnew - 1))
    del prof
    steps_s["profile_analysis"] = time.perf_counter() - t0
    new_waits = set(hs["decode_waits_per_step"]) - qwen_waits
    require(not new_waits, f"{label}: decode steps wait on the device in ops "
            f"phase 6's qwen2.5-14b run does not: {sorted(new_waits)}")
    t0 = time.perf_counter()
    gates = [a7c_gate(params, cfg, bt, tok, rows)
             for bt, (tok, rows) in zip(batches, outs)]
    steps_s["gate"] = time.perf_counter() - t0
    dec = sorted(t for s in times for t in s["decode_ms"])
    g = {k: max(x[k] for x in gates) for k in (
        "worst_gap", "worst_gap_forward", "max_logit_err", "max_served_err",
        "max_top_err", "max_abs_logit")}
    worst = max(gates, key=lambda x: x["max_logit_err"])
    g.update(steps=sum(x["steps"] for x in gates),
             excused=sum(x["excused"] for x in gates),
             max_logit_err_at=worst["max_logit_err_at"],
             max_logit_err_ulps=worst["max_logit_err_ulps"])
    info = {**stats, "arch": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": enc, "batches": [tuple(bt["tokens"].shape)
                                               for bt in batches],
            "new_tokens": new, "max_len": max_len, "encode_ms": enc_ms,
            "ttft_ms": [t["ttft_ms"] for t in times],
            "decode_ms_median": dec[len(dec) // 2], "wall_s": wall,
            "tokens_per_s": sum(o[0].numel() for o in outs) / wall,
            "peak_bytes": peak, "cache_bytes": cache, "kept_logits": kept,
            "launches": launches,
            # the run's counts equal the reckoning above, so per step:
            "launches_per_decode_step": {
                "flash_attention": cfg.num_layers * (2 if enc else 1),
                "kan_pipeline_layer": 2 * cfg.num_layers},
            "idle_share": 1.0 - bd["busy_share"], "breakdown": bd,
            "kernels_per_decode_step": hs["kernels_per_decode_step"],
            "decode_waits_per_step": hs["decode_waits_per_step"],
            "waits_by_extent": hs["waits_by_extent"],
            "gate": g, "gates": gates, "steps_s": steps_s,
            "profiled_new_tokens": pnew,
            "streams": [o[0].tolist() for o in outs]}
    print(f"  {label}: {len(batches)} batch(es) {info['batches']}, {new} new "
          f"tokens each ({info['tokens_per_s']:.1f} tokens/s); "
          + (f"encode {enc_ms:.2f} ms ({batches[0]['tokens'].shape[0]} x "
             f"{cfg.enc_seq} frames); " if enc else "")
          + f"TTFT {', '.join(f'{t:.1f}' for t in info['ttft_ms'])} ms; "
          f"decode {info['decode_ms_median']:.2f} ms/step (median); peak "
          f"{peak} B = weights {stats['weights_bytes']} + caches {cache} + "
          f"kept logits {kept} + {peak - stats['weights_bytes'] - cache - kept}"
          f" transient; launches {launches}, per decode step "
          f"{cfg.num_layers * (2 if enc else 1)} B2 and "
          f"{2 * cfg.num_layers} B1; profiled ({pnew} new tokens): idle share "
          f"{info['idle_share']:.3f}, {info['kernels_per_decode_step']:.1f} "
          "kernels per decode step, waits per decode step " + (", ".join(
              f"{k} {v:.2f}" for k, v in info["decode_waits_per_step"].items())
              or "none") + f" ({info['waits_by_extent']} owned by the op "
          "around them); s by step: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in steps_s.items()))
    print(f"    gate vs the teacher-forced \"ref\" backends: {g['steps']} "
          f"steps, {g['excused']} not the ref argmax; worst ref gap "
          f"{g['worst_gap']:.4f} (tol {LOGIT_TOL}); worst gap vs the fused "
          f"+ flash forward {g['worst_gap_forward']:.4f} (tol {LOGIT_TOL});"
          f" {err_site(g)}; max |served - forward| "
          f"{g['max_served_err']:.4f}")
    require(g["worst_gap"] <= LOGIT_TOL,
            f"{label}: a served token's ref logit is {g['worst_gap']:.4f} "
            f"below the ref maximum (tol {LOGIT_TOL})")
    require(g["worst_gap_forward"] <= LOGIT_TOL,
            f"{label}: a served token's forward logit is "
            f"{g['worst_gap_forward']:.4f} below the forward's maximum (tol "
            f"{LOGIT_TOL})")
    return info, launches


def a7c_whisper(dev, qwen_waits: set) -> tuple:
    import numpy as np
    import torch

    params, cfg, st = a7c_model(dev, "whisper-base", 6)
    rng = np.random.default_rng(7)
    b = A7C_WHISPER_CLIPS
    frames = torch.from_numpy(rng.standard_normal(
        (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(dev)
    tokens = torch.tensor([A7C_WHISPER_PROMPT] * b, device=dev)
    batch = {"tokens": tokens, "enc_embeds": frames.to(torch.bfloat16)}
    print(f"whisper-base kan_variant(): {cfg.encoder_layers} encoder + "
          f"{cfg.num_layers} decoder layers (all), d_model {cfg.d_model}, "
          f"heads {cfg.phys_heads}/{cfg.phys_kv_heads} (D {cfg.head_dim}), "
          f"KAN-FFN hidden {cfg.kan_d_hidden}, vocab {cfg.vocab_size}, bf16: "
          f"{st['params']} parameters, init + quantize + deploy "
          f"{st['setup_s']:.2f} s, {st['weights_bytes']} B on the card; "
          f"{b} clips of {cfg.enc_seq} frames, prompt {list(A7C_WHISPER_PROMPT)}"
          f", max_len {A7C_WHISPER_MAX_LEN}")
    out = a7c_run(dev, params, cfg, "whisper-base", [batch], A7C_WHISPER_NEW,
                  A7C_WHISPER_MAX_LEN, st, qwen_waits)
    del params, batch
    return out


def a7c_pixtral(dev, qwen_waits: set) -> tuple:
    import numpy as np
    import torch

    params, cfg, st = a7c_model(dev, "pixtral-12b", A7C_PIXTRAL_LAYERS)
    rng = np.random.default_rng(7)
    batches = []
    for n in A7C_PIXTRAL_LENS:
        tokens = torch.tensor([rng.integers(3, cfg.vocab_size, n).tolist()],
                              device=dev)
        patches = torch.from_numpy(rng.standard_normal(
            (1, cfg.num_patches, cfg.patch_embed_dim), dtype=np.float32))
        batches.append({"tokens": tokens,
                        "patch_embeds": patches.to(dev, torch.bfloat16)})
    print(f"pixtral-12b kan_variant(): {cfg.num_layers} of 40 layers, "
          f"d_model {cfg.d_model}, heads {cfg.phys_heads}/{cfg.phys_kv_heads}"
          f" (D {cfg.head_dim}), KAN-FFN hidden {cfg.kan_d_hidden}, vocab "
          f"{cfg.vocab_size}, patches {cfg.num_patches} x "
          f"{cfg.patch_embed_dim}, bf16: {st['params']} parameters, init + "
          f"quantize + deploy {st['setup_s']:.2f} s, {st['weights_bytes']} B "
          f"on the card; prompts {list(A7C_PIXTRAL_LENS)} (B = 1 each), "
          f"max_len {A7C_PIXTRAL_MAX_LEN}")
    out = a7c_run(dev, params, cfg, "pixtral-12b", batches, A7C_PIXTRAL_NEW,
                  A7C_PIXTRAL_MAX_LEN, st, qwen_waits)
    del params, batches
    return out


def phase_a7c(dev, report) -> tuple:
    """Phase 12.  Returns (launches by path, kernel errors, timed rows)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 starts with {torch.cuda.memory_allocated()} B allocated "
          "by earlier phases")
    t0 = time.perf_counter()
    checks = a7c_kernel_checks(dev, report)
    print(f"phase 12 kernel and layer checks: "
          f"{time.perf_counter() - t0:.1f} s")
    qwen_waits = set(report["serve"]["host_split_contiguous"][
        "decode_waits_per_step"])
    by_path, models = {}, []
    for fn in (a7c_whisper, a7c_pixtral):
        t0 = time.perf_counter()
        info, launches = fn(dev, qwen_waits)
        info["model_s"] = time.perf_counter() - t0
        print(f"  {info['arch']}: {info['model_s']:.1f} s with its setup")
        models.append(info)
        by_path[f"a7c_{info['arch']}"] = launches
        gc.collect()
        torch.cuda.empty_cache()
    report["a7c"] = models
    return by_path, checks


# ----------------------------------------------------------------------------
# phase 13: mesh serving on a 1x1 DeviceMesh over a world-1 NCCL group
# ----------------------------------------------------------------------------

# the rows of phase 4's requests the meshed slice repeats
MESH_BATCHES = BATCHES


def _codec_reckoning(a):
    """numpy reckoning of one leaf's int8 codes and scale, apart from
    ``dist.compress``: the scale in f64 from max |a|, the quotient in f32."""
    import numpy as np

    s = max(float(np.abs(a).max()), 1e-30) / 127.0
    q = np.clip(np.rint(a / np.float32(s)), -127, 127).astype(np.int8)
    return q, s


def mesh_slice(dev, mesh, report) -> dict:
    """Phase 4's KAN slice through ``runtime.execute(mesh=)`` and through a
    ``place_deployed_kan`` bundle, against the unsharded calls."""
    import torch

    from repro_torch import runtime
    from repro_torch.core.kan_network_deploy import place_deployed_kan
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels import cuda

    models = build_models(dev)
    knot, _, _, _ = make_knot_dataset(n_train=4 * max(MESH_BATCHES),
                                      n_test=1, seed=0)
    runtime.reset_cache()
    want, per_call = {}, {}
    for name, (_, _, dep) in models.items():
        for b in MESH_BATCHES:
            x = torch.as_tensor(requests(name, knot, b), device=dev)
            n0 = cuda.launch_counts().get("kan_pipeline_layer", 0)
            want[name, b] = runtime.execute(dep, x, return_intermediates=True)
            per_call[name, b] = (cuda.launch_counts()["kan_pipeline_layer"]
                                 - n0)
    placed = {name: place_deployed_kan(dep, mesh)
              for name, (_, _, dep) in models.items()}
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    got, mesh_calls = {}, {}
    for name, (_, _, dep) in models.items():
        for b in MESH_BATCHES:
            x = torch.as_tensor(requests(name, knot, b), device=dev)
            for how, kw in (("mesh", {"mesh": mesh}), ("placed", {})):
                bundle = dep if how == "mesh" else placed[name]
                n0 = cuda.launch_counts().get("kan_pipeline_layer", 0)
                got[name, b, how] = runtime.execute(
                    bundle, x, return_intermediates=True, **kw)
                mesh_calls[name, b, how] = (
                    cuda.launch_counts()["kan_pipeline_layer"] - n0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda.launch_counts()
    stats = runtime.cache_stats()
    for (name, b, how), (y, codes) in got.items():
        wy, wcodes = want[name, b]
        require(torch.equal(y, wy) and len(codes) == len(wcodes)
                and all(torch.equal(c, w) for c, w in zip(codes, wcodes)),
                f"mesh {name} b={b} ({how}): not bit-identical to unsharded")
        require(mesh_calls[name, b, how] == per_call[name, b],
                f"mesh {name} b={b} ({how}): {mesh_calls[name, b, how]} B1 "
                f"launches, unsharded {per_call[name, b]}")
    buckets = len({runtime.bucket_batch(b) for b in MESH_BATCHES})
    require(stats["entries"] == 2 * len(models) * buckets
            and stats["misses"] == 2 * len(models) * buckets,
            f"plan cache {stats}: meshed and unmeshed entries not apart "
            f"({2 * len(models) * buckets} expected)")
    notes = runtime.shard_notes()
    require(not notes, f"1x1 mesh recorded fallbacks {notes}")

    # acim under the mesh: quiet == fused bit for bit, noise reproducible
    _, _, dep = models["kan1"]
    x = torch.as_tensor(requests("kan1", knot, 4096), device=dev)
    yf, cf = got["kan1", 4096, "mesh"]
    yq, cq = runtime.execute(dep, x, backend="acim", mesh=mesh,
                             cim=runtime.quiet_cim_config(),
                             return_intermediates=True)
    require(torch.equal(yq, yf) and all(torch.equal(a, b)
                                        for a, b in zip(cq, cf)),
            "mesh acim: quiet config not bit-identical to fused")

    def noisy(seed):
        return runtime.execute(
            dep, x, backend="acim", mesh=mesh,
            generator=torch.Generator(device=dev).manual_seed(seed))

    n0 = cuda.launch_counts().get("kan_pipeline_layer.noise", 0)
    a, b2, c = noisy(11), noisy(11), noisy(12)
    noise_launches = cuda.launch_counts()["kan_pipeline_layer.noise"] - n0
    require(torch.equal(a, b2) and not torch.equal(a, c),
            "mesh acim: noise not reproducible under one seed")
    require(noise_launches == 6, f"mesh acim: {noise_launches} noisy B1 "
            "launches (want 2 layers x 3 calls)")
    n_req = len(got)
    print(f"  KAN slice on the mesh: {n_req} requests (mesh= and placed) in "
          f"{wall:.3f} s, bit-identical to unsharded (y and boundary codes), "
          f"B1 launches per call equal ({launches.get('kan_pipeline_layer')} "
          f"in all); plan cache {stats} (meshed and unmeshed apart); quiet "
          f"acim == fused, noisy acim reproducible ({noise_launches} noisy "
          "B1 launches)")
    report["mesh"]["slice"] = {"requests": n_req, "wall_s": wall,
                               "launches": launches, "plan_cache": stats}
    del models, placed, got, want
    torch.cuda.empty_cache()
    return launches


def mesh_serve(dev, mesh, report) -> dict:
    """Phase 6's full-width engine on the mesh, contiguous and paged, and
    the compress round trip of its first KAN-FFN bundle."""
    import numpy as np
    import torch

    from repro_torch import parity, runtime
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.dist import comm
    from repro_torch.dist.compress import (
        _quantize,
        compress_deployed_kan,
        decompress_deployed_kan,
    )
    from repro_torch.models.model import init_params
    from repro_torch.runtime.executor import _entry_codes

    cfg = serve_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = quantize_kan_ffn_params_tree(init_params(gen, cfg, device=dev),
                                           cfg)
    prompts = serve_prompts(cfg.vocab_size)
    base = report["serve"]["modes"]
    launches, out = {}, {}
    # contiguous in turns with the unmeshed engine (mesh, plain, plain,
    # mesh), so the host's drift between phase 6 and here stays out of the
    # comparison; paged once
    for mode, turns in (("contiguous", (True, False, False, True)),
                        ("paged", (True,))):
        times = {True: [], False: []}
        for meshed in turns:
            comm.reset_collectives()
            run = serve_once(qparams, cfg, prompts, dev, mode,
                             engine_kw={"mesh": mesh} if meshed else None)
            label = f"{'mesh' if meshed else 'plain'} {mode}"
            check_counts(run, label, cfg.num_layers)
            require(run["streams"] == base[mode]["streams"],
                    f"{label}: streams differ from phase 6's")
            dec = sorted(run["decode_ms"])
            times[meshed].append((dec[len(dec) // 2],
                                  run["sched"]["tokens_per_s"]))
            if meshed and len(times[True]) == 1:
                require(run["engine"].mesh_layout()["shape"] == [1, 1],
                        f"{label}: layout {run['engine'].mesh_layout()}")
                coll = dict(comm.COLLECTIVES)
                steps = max(run["decode_calls"], 1)
                launches[f"mesh_lm_{mode}"] = run["launches"]
                info = {"decode_calls": run["decode_calls"],
                        "prefill_calls": run["prefill_calls"],
                        "collectives": coll,
                        "collectives_per_decode_step": {
                            k: v / steps for k, v in coll.items()},
                        "launches": run["launches"],
                        "peak_bytes": run["peak_bytes"]}
            del run
        info.update(
            meshed_decode_ms=[t[0] for t in times[True]],
            meshed_tokens_per_s=[t[1] for t in times[True]],
            plain_decode_ms=[t[0] for t in times[False]],
            plain_tokens_per_s=[t[1] for t in times[False]],
            phase6_decode_ms=base[mode]["decode_ms_median"],
            phase6_tokens_per_s=base[mode]["tokens_per_s"])
        out[mode] = info

        def fmt(xs):
            return " / ".join(f"{x:.2f}" for x in xs)

        print(f"  mesh {mode}: streams equal phase 6's in every turn; decode "
              f"ms/step (median) meshed {fmt(info['meshed_decode_ms'])}, "
              f"plain {fmt(info['plain_decode_ms']) or 'not run'} (phase 6 "
              f"{info['phase6_decode_ms']:.2f}); tokens/s meshed "
              f"{fmt(info['meshed_tokens_per_s'])}, plain "
              f"{fmt(info['plain_tokens_per_s']) or 'not run'} (phase 6 "
              f"{info['phase6_tokens_per_s']:.1f}); collectives "
              f"{info['collectives'] or 'none'} in "
              f"{info['decode_calls']} decode steps (a group of one rank "
              "skips its collective)")
    report["mesh"]["serve"] = out
    launches["mesh_lm_clock"] = mesh_clock_serve(qparams, cfg, prompts, dev,
                                                 mesh, base, report)

    # compress -> decompress of the full-width KAN-FFN bundle onto the mesh
    dep = qparams["decoder"][0]["l0_ffn"]["deployed"][0]
    t0 = time.perf_counter()
    payload = compress_deployed_kan(dep)
    t_comp = time.perf_counter() - t0
    f32_bytes = sum(t.numel() * t.element_size()
                    for lw in dep.layers for t in lw.values())
    pay_bytes = 0
    for entry, lw in zip(payload["layers"], dep.layers):
        for k, v in entry.items():
            a = lw[k].cpu().numpy()
            if isinstance(v, tuple):
                q, sc = _codec_reckoning(a)
                require(np.array_equal(v[0], q) and v[1] == sc,
                        f"codec: leaf {k} differs from the numpy reckoning")
                pay_bytes += v[0].nbytes + 4
            else:
                require(np.array_equal(v, a), f"codec: raw leaf {k} moved")
                pay_bytes += v.nbytes
    # the gradient codec on the card against numpy, on the largest leaf
    big = dep.layers[0]["wc"]
    gq, gs = _quantize(big)
    a = big.cpu().numpy()
    s_np = np.float32(np.abs(a).max()) / np.float32(127)
    require(np.float32(gs.item()) == s_np and np.array_equal(
        gq.cpu().numpy(), np.clip(np.round(a / s_np), -127, 127)
        .astype(np.int8)), "_quantize on the card differs from numpy")
    del gq, a
    dep_mesh = decompress_deployed_kan(payload, dep, mesh=mesh)
    dep_host = decompress_deployed_kan(payload, dep)
    require(dep_mesh.placement is mesh, "decompress: placement not recorded")
    x = torch.randn(64, cfg.d_model, generator=gen, device=dev)
    y0 = runtime.execute(dep, x)
    ym, cm = runtime.execute(dep_mesh, x, return_intermediates=True)
    yh, ch = runtime.execute(dep_host, x, return_intermediates=True)
    entry, xraw = _entry_codes(dep_host, x, None)
    gate = parity.compare_runs(
        cm, ch, parity.boundary_prerounds(dep_host, entry, xraw, ch), ym, yh)
    rel = float((ym - y0).abs().max() / (y0.abs().max() + 1e-6))
    require(rel < 5e-2, f"decompressed bundle {rel:.3e} of scale from the "
            "original (codec envelope 5e-2)")
    print(f"  compress: full-width KAN-FFN bundle {f32_bytes} B -> payload "
          f"{pay_bytes} B ({pay_bytes / f32_bytes:.4f}) in {t_comp:.2f} s; "
          "every int8 code and scale equal to the numpy reckoning, "
          "_quantize on the card equal to numpy; decompressed onto the mesh "
          f"== decompressed unplaced under the parity gate ({gate}); "
          f"against the original bundle {rel:.3e} of max|y| (the int8 "
          "codec's error)")
    report["mesh"]["compress"] = {
        "f32_bytes": f32_bytes, "payload_bytes": pay_bytes,
        "ratio": pay_bytes / f32_bytes, "seconds": t_comp, "gate": gate,
        "rel_err_vs_original": rel}
    del qparams, dep, dep_mesh, dep_host
    torch.cuda.empty_cache()
    return launches


# the scheduler's shared clock (phase 13): a request behind the busy slots
# with a 1 ms deadline, and one with phase 6's 5-token prompt arriving later
CLOCK_EXPIRE_RID, CLOCK_LATE_RID = 100, 101
CLOCK_ARRIVAL_S = 0.05
CLOCK_READS = 200  # reads timed for the cost of one


def mesh_clock_serve(qparams, cfg, prompts, dev, mesh, base, report) -> dict:
    """Phase 6's contiguous requests plus a deadline and a future arrival
    through a scheduler on ``MeshClock(mesh)``, whose NCCL broadcast runs
    on the 1x1 mesh's world-1 group: exactly one expiry, phase 6's
    streams, the arrival admitted no earlier than its offset.  Returns
    the run's launches."""
    import torch

    from repro_torch.dist import comm
    from repro_torch.serve import Request
    from repro_torch.serve.scheduler import MeshClock

    late_src = SERVE_LENS.index(min(SERVE_LENS))
    extra = [Request(rid=CLOCK_EXPIRE_RID, prompt=list(prompts[0][:8]),
                     max_new_tokens=SERVE_NEW, deadline_s=1e-3),
             Request(rid=CLOCK_LATE_RID, prompt=list(prompts[late_src]),
                     max_new_tokens=SERVE_NEW, arrival_s=CLOCK_ARRIVAL_S)]
    clock = MeshClock(mesh)
    comm.reset_collectives()
    run = serve_once(qparams, cfg, prompts, dev, "contiguous",
                     sched_kw={"clock": clock, "trace": True},
                     engine_kw={"mesh": mesh}, extra=extra)
    coll = dict(comm.COLLECTIVES)
    label = "mesh clock"
    status = dict(run["status"])
    require(status.pop(CLOCK_EXPIRE_RID, None) == "expired"
            and run["sched"]["expired"] == 1,
            f"{label}: expiries {run['sched']['expired']}, statuses "
            f"{run['status']}")
    check_counts({**run, "status": status}, label, cfg.num_layers,
                 requests=len(SERVE_LENS) + 1)
    want = dict(base["contiguous"]["streams"])
    want[CLOCK_LATE_RID] = want[late_src]
    streams = {k: v for k, v in run["streams"].items()
               if k != CLOCK_EXPIRE_RID}
    require(streams == want, f"{label}: streams differ from phase 6's")
    admitted = {r["rid"]: r["t1"] for r in run["tracer"].records()
                if r["name"] == "queued"}
    late_admit = admitted[CLOCK_LATE_RID]
    require(run["arrival_s"][CLOCK_LATE_RID] == CLOCK_ARRIVAL_S
            and late_admit >= CLOCK_ARRIVAL_S,
            f"{label}: arrival {run['arrival_s'][CLOCK_LATE_RID]} admitted "
            f"at {late_admit}")
    require(clock.reads > 0 and coll.get("broadcast", 0) == clock.reads,
            f"{label}: {clock.reads} clock reads, collectives {coll}")
    steps = max(run["decode_steps"], 1)
    reads = clock.reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CLOCK_READS):
        clock.share(0.0)
    read_us = (time.perf_counter() - t0) / CLOCK_READS * 1e6
    dec = sorted(run["decode_ms"])
    info = {"reads": reads, "broadcasts": coll.get("broadcast", 0),
            "decode_steps": run["decode_steps"],
            "broadcasts_per_decode_step": coll.get("broadcast", 0) / steps,
            "read_us": read_us, "late_admitted_s": late_admit,
            "late_ttft_s": run["ttft_s"][CLOCK_LATE_RID],
            "decode_ms_median": dec[len(dec) // 2],
            "tokens_per_s": run["sched"]["tokens_per_s"],
            "wall_s": run["wall_s"]}
    print(f"  mesh clock (MeshClock, NCCL broadcast on the world-1 group): "
          f"1 of {len(SERVE_LENS) + 2} requests expired (1 ms deadline "
          f"behind busy slots), the others' streams equal phase 6's token "
          f"for token (the late request's its prompt's); arrival "
          f"{CLOCK_ARRIVAL_S} s admitted at {late_admit:.4f} s; "
          f"{info['broadcasts']} broadcasts over {run['decode_steps']} "
          f"decode steps ({info['broadcasts_per_decode_step']:.3f} per "
          f"step); one read {read_us:.1f} us; decode ms/step (median) "
          f"{info['decode_ms_median']:.2f}, tokens/s "
          f"{info['tokens_per_s']:.1f}")
    report["mesh"]["clock"] = info
    launches = run["launches"]
    del run
    return launches


def mesh_shard_checks(dev, mesh, report) -> None:
    """What a larger mesh runs, held on one card: a model shard's B1
    column slabs at the whole layer's feature split equal the whole
    layer's columns bit for bit (gemma2's full-width halves, whose slabs
    would split otherwise), and NCCL's collectives called directly on the
    mesh's world-1 groups, int32 and f32 (``dist.comm`` skips them there).
    Comparison launches: no path's count."""
    import torch

    from repro_torch.dist.cardcheck import check_collectives
    from repro_torch.kernels.kan_spline import cardcheck as cc

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    slabs = []
    for grid, f, o, flags, rows, model in cc.B1_COLUMN_SLAB_CASES:
        r = cc.check_b1_column_slabs(dev, gen, grid, f, o, flags, rows, model)
        require(r["local_plan_splits"] != r["splits"],
                f"B1 slab {f}x{o}/{model}: the slab's own split equals the "
                "layer's, the case checks nothing")
        slabs.append(f"{f}x{o}@{rows}/{model}: {r['splits']} splits (slab's "
                     f"own {r['local_plan_splits']})")
    coll = check_collectives(mesh, dev)
    wall = time.perf_counter() - t0
    print(f"  B1 column slabs bit-identical to the whole layer's columns at "
          f"its feature split: {'; '.join(slabs)}; NCCL collectives called "
          f"directly on groups {coll['groups']}: {coll['calls']} calls "
          f"(all-gather / all-reduce / broadcast, int32 and f32) exact; "
          f"{wall:.2f} s")
    report["mesh"]["shard_checks"] = {"slabs": slabs, "collectives": coll,
                                      "wall_s": wall}
    torch.cuda.empty_cache()


def phase_mesh(dev, report) -> dict:
    """A 1x1 DeviceMesh over a world-1 NCCL group: the KAN slice, the
    full-width engine, the compress round trip and ``launch.serve --mesh``
    (see the module docstring, phase 13)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve as cli
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1)
    t_mesh = time.perf_counter() - t0
    ones = torch.ones(8, device=dev)
    dist.all_reduce(ones)  # the NCCL group answers a collective
    require(dist.get_backend() == "nccl" and bool((ones == 1).all()),
            f"process group {dist.get_backend()}: all-reduce gave {ones}")
    print(f"mesh: {mesh} (backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}), built in {t_mesh:.2f} s")
    report["mesh"] = {"build_s": t_mesh}
    launches = {"mesh_kan_slice": mesh_slice(dev, mesh, report)}
    launches.update(mesh_serve(dev, mesh, report))
    mesh_shard_checks(dev, mesh, report)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--arch", "qwen2.5-14b", "--kan-ffn", "--mesh",
                  "data=1,model=1", "--requests", "2", "--max-new", "4"])
    lines = [ln for ln in buf.getvalue().splitlines() if "mesh" in ln]
    require(any("mesh shape=" in ln and "data=1 x model=1" in ln
                for ln in lines),
            f"launch.serve --mesh printed no mesh line: {buf.getvalue()}")
    print("  launch.serve --mesh data=1,model=1: " + lines[0].strip())
    dist.destroy_process_group()
    return launches


# ----------------------------------------------------------------------------
# phase 14: training on a 1x1 DeviceMesh over a world-1 NCCL group
# ----------------------------------------------------------------------------

# phase 9's cell through TrainLoop(shardings=); the checkpoint after step 3
# (AdamW state and bf16 parameters of the 4-layer model, ~25 GB) is written
# to the temporary directory and read back by a new loop
MESH_CKPT_STEP = 3
# one full-width MoE layer of mixtral-8x7b at 256 tokens, and the float
# KAN-FFN of qwen2.5-14b (5120 -> 1280 -> 5120) at 64 tokens, at model 2
MOE_SLAB_TOKENS = 256
KAN_SLAB = (5120, 1280, 64)


def phase_meshtrain(dev, report) -> dict:
    """Phase 9's training cell on a 1x1 mesh through ``TrainLoop(
    shardings=)``: bit-equal to phase 9's unmeshed run (losses, grad norms,
    parameter hash), a restart from the step-3 checkpoint bit-equal to
    the unbroken run, peak memory and s/step beside phase 9's; then what
    one card can hold of a model cut (a MoE layer's and a KAN-FFN's slabs
    at model 2, remat's recompute under a cut layout) and the autograd
    collectives on the world-1 groups.
    Returns the B1-B4 launches of the phase (none: training attends on
    "ref" and runs the float KAN-FFN)."""
    import dataclasses
    import gc
    import shutil
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import runtime
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import DataConfig
    from repro_torch.dist import cardcheck as dc
    from repro_torch.dist.sharding import PSpec, to_shardings
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.train_state import meta_state, state_pspecs

    t_phase = time.perf_counter()
    idle = (dict(cuda.launch_counts()),
            runtime.attn_dispatch_counts().get("flash", 0))
    mesh = make_local_mesh(1, 1)
    require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    want = report["train"]
    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              num_layers=TRAIN_LAYERS).kan_variant()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                      global_batch=16)
    rows = PSpec("data", None)
    sh = {"state": to_shardings(state_pspecs(meta_state(cfg), mesh), mesh),
          "batch": to_shardings({"tokens": rows, "targets": rows}, mesh)}
    quiet = lambda *_: None  # noqa: E731
    ckdir = tempfile.mkdtemp(prefix="repro_torch_meshtrain_")
    free = shutil.disk_usage(ckdir).free
    print(f"meshtrain: {cfg.name} {cfg.num_layers} layers on {mesh}; "
          f"checkpoints in {ckdir} ({free} B free)")
    try:
        # what earlier phases left for the collector would be freed during
        # the run and hide that much of its peak: collect it first
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, dcfg, ckdir, ckpt_every=MESH_CKPT_STEP,
                         shardings=sh)
        hist = loop.run(MESH_CKPT_STEP, log=quiet)   # saves step_3
        t_save = time.perf_counter()
        loop.ckpt_every = 10 ** 9
        loop.start_step = MESH_CKPT_STEP
        hist += loop.run(TRAIN_STEPS - MESH_CKPT_STEP, log=quiet)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        got_hash = params_sha256(loop.state["params"])
        losses = [m["loss"] for m in hist]
        norms = [m["grad_norm"] for m in hist]
        times = [m["time_s"] for m in hist]
        require(losses == want["losses"] and norms == want["grad_norms_2"]
                and got_hash == want["params_sha256_2"],
                f"meshtrain: 1x1 losses {losses} / grad norms {norms} / hash "
                f"{got_hash} against phase 9's {want['losses']} / "
                f"{want['grad_norms_2']} / {want['params_sha256_2']}")
        s_step = statistics.median(times[1:])
        require(abs(peak - want["peak_bytes"]) <= 1 << 30,
                f"meshtrain: peak {peak} B against phase 9's "
                f"{want['peak_bytes']} B (more than 1 GiB apart)")
        print(f"meshtrain: TrainLoop(shardings=) 1x1, {TRAIN_STEPS} steps: "
              f"losses, grad norms and parameter sha256 bit-equal to phase "
              f"9's ({got_hash[:16]}...); median s/step {s_step:.4f} "
              f"(phase 9: {want['s_per_step']:.4f}); steps {times}; peak "
              f"{peak} B over the {base} B allocated before (phase 9: "
              f"{want['peak_bytes']} B); run {run_s:.2f} "
              f"s with init and the step-{MESH_CKPT_STEP} save "
              f"({t_save - t0:.2f} s to it) ({smi_line()})")
        del loop
        gc.collect()
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        loop = TrainLoop(cfg, dcfg, ckdir, ckpt_every=10 ** 9, shardings=sh)
        t_restore = time.perf_counter() - t1
        require(loop.start_step == MESH_CKPT_STEP,
                f"meshtrain: restored at {loop.start_step}")
        again = loop.run(TRAIN_STEPS - MESH_CKPT_STEP, log=quiet)
        again_hash = params_sha256(loop.state["params"])
        require([m["loss"] for m in again] == losses[MESH_CKPT_STEP:]
                and [m["grad_norm"] for m in again] == norms[MESH_CKPT_STEP:]
                and again_hash == got_hash,
                f"meshtrain: the restart's losses {[m['loss'] for m in again]}"
                f" against {losses[MESH_CKPT_STEP:]}")
        print(f"meshtrain: restart from step {MESH_CKPT_STEP} (restore "
              f"{t_restore:.2f} s): steps {MESH_CKPT_STEP}-"
              f"{TRAIN_STEPS - 1} losses, grad norms and parameter sha256 "
              f"bit-equal to the unbroken run")
        del loop
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # what a model cut runs, one slab at a time on the card
    t2 = time.perf_counter()
    moe = dc.check_moe_slabs(dev, get_config("mixtral-8x7b"),
                             MOE_SLAB_TOKENS)
    kan = dc.check_kan_ffn_slabs(dev, *KAN_SLAB)
    coll = dc.check_autograd_collectives(mesh, dev)
    remat = dc.check_remat_under_layout(mesh, dev)
    torch.cuda.empty_cache()
    print(f"meshtrain: mixtral MoE layer (4096, 8 experts, d_ff 14336, bf16, "
          f"{moe['tokens']} tokens) at model {moe['model']}: slabs' partial "
          f"sums vs the whole layer {moe['max_abs_err']:.3e} (tol "
          f"{moe['tol']:.3e}, 4 bf16 ulps of {moe['max_abs_out']:.3f}); "
          f"qwen KAN-FFN {kan['d']} -> {kan['h']} -> {kan['d']} f32 at "
          f"model {kan['model']}, forward and backward, relative errors "
          f"{kan['rel_err']} (tol {kan['tol']}); autograd collectives exact "
          f"on groups {coll['groups']}; remat's recompute on the device "
          f"thread bit-equal to no remat under {len(remat['layouts'])} "
          f"cut layouts (smoke qwen at model 2 and 4, the backward outside "
          f"the layout's scope); {time.perf_counter() - t2:.2f} s")
    now = (dict(cuda.launch_counts()),
           runtime.attn_dispatch_counts().get("flash", 0))
    require(now == idle, f"meshtrain: B1/B2 launches or flash dispatches "
            f"moved: {idle} -> {now}")
    dist.destroy_process_group()
    wall = time.perf_counter() - t_phase
    print(f"meshtrain: no B1-B4 launch and no 'flash' dispatch in the phase; "
          f"phase wall {wall:.1f} s")
    report["meshtrain"] = {
        "losses": losses, "grad_norms": norms, "params_sha256": got_hash,
        "time_s": times, "s_per_step": s_step, "peak_bytes": peak,
        "run_s": run_s, "restore_s": t_restore, "moe_slabs": moe,
        "kan_ffn_slabs": kan, "autograd_collectives": coll,
        "remat_layouts": remat["layouts"], "wall_s": wall}
    return {k: now[0].get(k, 0) - idle[0].get(k, 0) for k in now[0]}


# ----------------------------------------------------------------------------
# phase 15: the examples (repro_torch.examples)
# ----------------------------------------------------------------------------


def phase_examples(dev, report) -> dict:
    """The six example twins in-process on the card, each at the size
    phase 15 of the module docstring names.  Counts are set to 0 just
    before each example and read just after it (the checks that follow,
    e.g. the quickstart's parity gate, launch B1 again outside that
    window); returns the examples' launches summed."""
    import os
    import signal
    import tempfile

    import torch

    from repro_torch.core.asp_quant import ASPQuantSpec
    from repro_torch.core.costmodel import accelerator_cost, kan_accelerator
    from repro_torch.core.tmdv import TMDVConfig
    from repro_torch.examples import (
        knot_e2e,
        lm_kan_train,
        neurosim_search,
        quickstart,
        serve_demo,
        tune_deploy,
    )
    from repro_torch.kernels import cuda
    from repro_torch.tune import SearchConfig, pareto_search

    lines: list = []

    def log(*a):
        lines.append(" ".join(str(v) for v in a))

    total: dict = {}
    secs: dict = {}
    rep: dict = {}

    def drive(name, fn, **kw):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(**kw)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches = cuda.launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"  {name}: {secs[name]:.2f} s, launches {launches}")
        return out, launches

    # quickstart at its own size (KAN1, 8 rows): B3 and B1 once per layer
    q, launches = drive("quickstart", quickstart.run, device=dev, log=log)
    n_layers = len(q["kspec"].dims) - 1
    require(launches == {"kan_spline": n_layers,
                         "kan_pipeline_layer": n_layers},
            f"quickstart: launches {launches}, want B3 and B1 x {n_layers}")
    gate = quickstart.parity_gate(q)
    spec = q["spec"]
    want_lut = (spec.order + 1) * 2**spec.ld // 2 + 1
    require(q["sh_lut"]["stored"] == want_lut,
            f"quickstart: SH-LUT {q['sh_lut']} != {want_lut} entries")
    print(f"    quantized vs kernel {gate['kernel']}, vs fused {gate['fused']};"
          f" max |float - quantized| {q['max_abs']['float_quant']:.3e}; "
          f"SH-LUT {q['sh_lut']['stored']} entries")
    rep["quickstart"] = {"gate": gate, "max_abs": q["max_abs"],
                         "sh_lut": q["sh_lut"]}

    # knot_e2e --fast: training and the simulator's plain MAC, no kernel
    k, launches = drive("knot_e2e", knot_e2e.run, fast=True, device=dev,
                        log=log)
    require(launches == {}, f"knot_e2e: launches {launches}")
    accs = [k["sw_acc"], *k["acim_acc"].values()]
    require(all(0.0 <= a <= 1.0 for a in accs) and len(accs) == 3,
            f"knot_e2e: accuracies {accs}")
    cpu_cost = accelerator_cost(kan_accelerator(
        (17, 1, 14), ASPQuantSpec(grid_size=5, order=3, n_bits=8, lut_bits=8,
                                  lo=-1.0, hi=1.0),
        TMDVConfig(8, 4), 128, adc_bits=8))
    require(k["cost"] == cpu_cost, f"knot_e2e: cost {k['cost']} != "
            f"{cpu_cost}")
    print(f"    software accuracy {k['sw_acc']:.4f}, ACIM baseline map "
          f"{k['acim_acc']['baseline']:.4f}, KAN-SAM "
          f"{k['acim_acc']['kan_sam']:.4f}; stage seconds {k['seconds']}")
    rep["knot_e2e"] = {"sw_acc": k["sw_acc"], "acim_acc": k["acim_acc"],
                       "cost": k["cost"], "seconds": k["seconds"]}

    # neurosim_search --fast: step 1's fronts equal a host run's
    ns, launches = drive("neurosim_search", neurosim_search.run, fast=True,
                         device=dev, log=log)
    require(launches == {}, f"neurosim_search: launches {launches}")
    for name, hc in neurosim_search.BUDGETS.items():
        host = pareto_search(None, neurosim_search.SPACE, constraints=hc,
                             dims=(17, 1, 14),
                             config=SearchConfig(budget=40, n_init=16, seed=0))
        require(ns["searches"][name].to_dict() == host.to_dict(),
                f"neurosim_search: {name}'s front differs from a host run's")
    ext = ns["extension"]
    print(f"    max feasible G {ns['gmax']}; step 2 G={ext['G']} "
          f"(log {[r['G'] for r in ext['log']]}) accuracy "
          f"{ns['accuracy']:.4f}")
    rep["neurosim_search"] = {"gmax": ns["gmax"], "G": ext["G"],
                              "log": ext["log"], "accuracy": ns["accuracy"],
                              "seconds": ns["seconds"]}

    # tune_deploy --smoke: exit status 0 (phase 8 runs the full budgets)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "TUNE_artifact.json")
        status, launches = drive("tune_deploy", tune_deploy.main,
                                 argv=["--smoke", "--out", art])
    require(status == 0, f"tune_deploy --smoke exited {status}")
    require(launches.get("kan_pipeline_layer", 0) > 0
            and launches.get("kan_pipeline_layer.noise", 0) > 0
            and set(launches) <= {"kan_pipeline_layer",
                                  "kan_pipeline_layer.noise", REGS_KEY},
            f"tune_deploy: launches {launches}")

    # lm_kan_train at its defaults: 60 steps, a restart for 10
    sigterm = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as tmp:
        lm, launches = drive("lm_kan_train", lm_kan_train.run, device=dev,
                             ckpt_dir=os.path.join(tmp, "ckpt"), log=log)
    signal.signal(signal.SIGTERM, sigterm)
    require(launches == {}, f"lm_kan_train: launches {launches}")
    losses = [m["loss"] for m in lm["hist"] + lm["hist2"]]
    require(lm["start_step"] == len(lm["hist"]) == 60
            and [m["step"] for m in lm["hist2"]] == list(range(60, 70)),
            f"lm_kan_train: restart at {lm['start_step']}, steps "
            f"{[m['step'] for m in lm['hist2']]}")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"lm_kan_train: losses {losses[0]} -> {losses[-1]}")
    print(f"    loss {losses[0]:.4f} -> {losses[59]:.4f} (60 steps), "
          f"{losses[-1]:.4f} after the restart at step {lm['start_step']}")
    rep["lm_kan_train"] = {"first": losses[0], "at_60": losses[59],
                           "last": losses[-1], "seconds": lm["seconds"]}
    del lm

    # serve_demo at its own sizes: B2 on every layer of every engine call,
    # B1 on both halves of every deployed call
    sd, launches = drive("serve_demo", serve_demo.run, device=dev, log=log)
    want = serve_demo.expected_launches(sd)
    require(by_kernel(launches) == want,
            f"serve_demo: launches {launches} != {want}")
    require(sd["stream_outputs"] == sd["streams"],
            "serve_demo: a stream differs from its final output")
    tps = {k: sd["tokens"][k] / sd["seconds"][k] for k in ("float", "fused")}
    print(f"    float-vs-fused same {sd['same']}/{len(sd['fused'])} (not "
          f"gated); tok/s float {tps['float']:.1f}, fused {tps['fused']:.1f};"
          f" streamed {sd['stats']['tokens']} tokens at "
          f"{sd['stats']['tokens_per_s']:.1f} tok/s")
    rep["serve_demo"] = {"same": sd["same"], "tokens": sd["tokens"],
                         "seconds": sd["seconds"], "tokens_per_s": tps,
                         "stream_stats": {k: sd["stats"][k] for k in (
                             "tokens", "completed", "tokens_per_s")},
                         "engines": {k: {c: v[c] for c in (
                             "prefill_calls", "decode_traces")}
                             for k, v in sd["engines"].items()}}
    report["examples"] = {"seconds": secs, "launches": total, **rep,
                          "printed": lines}
    print(f"  examples seconds: {secs}")
    return total


# ----------------------------------------------------------------------------
# phase 16: the dry-run's prediction against the card
# ----------------------------------------------------------------------------

# the production cells the dry-run entry point runs on the host (train_4k
# takes ~90 s of host time and is left out)
DRY_CELLS = ("decode_32k", "prefill_32k")
DRY_STATE_TOL = 1 << 20      # allocator bytes the state may differ by
DRY_PEAK_TOL = 0.05          # predicted high-water mark against the card's


def allocator_tails(tensors) -> tuple:
    """(blocks, bytes): the blocks the caching allocator handed to
    ``tensors`` whole, each larger than its request rounded up to 512 B (a
    large block's tail of up to 1 MiB is not split off), and those
    tails' sum, from ``torch.cuda.memory_snapshot()``."""
    import torch

    ptrs = {t.data_ptr() for t in tensors}
    n = total = 0
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            addr = blk.get("address", addr)
            if addr in ptrs and blk["state"] == "active_allocated":
                req = blk.get("requested_size", blk["size"])
                tail = blk["size"] - -(-req // 512) * 512
                if tail:
                    n, total = n + 1, total + tail
            addr += blk["size"]
    return n, total


def phase_dryrun(dev, report) -> None:
    """(a) ``launch.op_analysis`` predicts phase 9's train step on the meta
    device; the card then builds that state and takes that step: the state's
    bytes, the step's memory high-water mark, its profiled device time
    against the roofline bound, and FlopCounterMode's count over it against
    the meta count.  (b) ``launch.dryrun`` on production cells, as a user
    runs it: one subprocess per cell on the host, started first so they
    run beside (a), and ``scripts.top_ops`` over the decode cell's ops.
    No B1-B4 launch in the phase."""
    from repro_torch.kernels import cuda
    from repro_torch.scripts import top_ops

    t_phase = time.perf_counter()
    idle = dict(cuda.launch_counts())
    out_dir = ROOT / "reports" / "dryrun_torch"
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-14b", "--shape", shape, "--mesh", "single", "--save-ops",
         "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})   # the dry-run needs no card
        for shape in DRY_CELLS}
    try:
        dryrun_card_check(dev, report)
        cells = dryrun_cells(procs, out_dir)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ops = f"{out_dir / 'qwen2.5-14b__decode_32k__single'}.ops.jsonl"
    print(f"python -m repro_torch.scripts.top_ops {Path(ops).name} flops 5:")
    top_ops.main(ops, "flops", 5)

    now = dict(cuda.launch_counts())
    require(now == idle, f"dry-run: B1-B4 launches moved: {idle} -> {now}")
    wall = time.perf_counter() - t_phase
    print(f"dry-run phase: no B1-B4 launch; {wall:.1f} s")
    report["dryrun"].update(cells=cells, wall_s=wall)


def dryrun_card_check(dev, report) -> None:
    """Phase 16 (a): the prediction on meta, then the card (see
    :func:`phase_dryrun`); the readings go to ``report["dryrun"]``."""
    import dataclasses
    import gc

    import torch
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import DataConfig, global_batch_at_step
    from repro_torch.launch import op_analysis
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.train_state import (
        init_state,
        make_train_step,
        meta_state,
    )

    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              num_layers=TRAIN_LAYERS).kan_variant()
    b, s = 16, 256

    # (a) the prediction, on the meta device
    meta = meta_state(cfg)
    mbatch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
              for k in ("tokens", "targets")}
    pred = op_analysis.analyze_step(make_train_step(cfg), meta, mbatch)
    sizes = [t.numel() * t.element_size() for t in tree_leaves(meta)]
    raw, rounded = sum(sizes), sum(-(-n // 512) * 512 for n in sizes)
    pmem, prl = pred["memory"], pred["roofline"]
    print(f"dry-run of phase 9's cell on meta ({pred['run_s']:.1f} s, "
          f"{pred['op_count']} ops): FLOPs {pred['flops_per_dev']:.6e}, "
          f"bytes {pred['bytes_per_dev']:.6e}, state {raw} B ({rounded} B "
          f"in 512 B blocks, {len(sizes)} tensors), arguments "
          f"{pmem['argument_bytes']} B, peak {pmem['peak_bytes']} B, "
          f"roofline terms (c/m/n) {prl['compute_s']:.4f} / "
          f"{prl['memory_s']:.4f} / {prl['collective_s']:.4f} s, bound "
          f"{prl['step_time_lb_s']:.4f} s ({prl['dominant']})")

    # the state on the card, after the earlier phases' memory is freed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats
    a0 = torch.cuda.memory_allocated()
    r0 = stats().get("requested_bytes.all.current")
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - a0
    req = stats().get("requested_bytes.all.current")
    req = None if r0 is None or req is None else req - r0
    tails, tail_b = allocator_tails(tree_leaves(state))
    diff = grown - rounded
    print(f"state on the card: memory_allocated grew {grown} B against the "
          f"predicted {rounded} B in 512 B blocks (difference {diff} B: "
          f"{tails} blocks the allocator handed out whole, their unsplit "
          f"tails {tail_b} B); requested bytes grew {req} B against the "
          f"predicted {raw} B")
    require(diff == tail_b and abs(diff) <= DRY_STATE_TOL,
            f"dry-run: state {grown} B on the card against {rounded} B "
            f"predicted; {diff} B differ, {tail_b} B of it block tails")
    require(req is None or req == raw,
            f"dry-run: requested state bytes {req} against {raw} predicted")

    batch = batch_to_device(global_batch_at_step(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), 0), dev)
    step = make_train_step(cfg)

    # FLOPs: FlopCounterMode over the card's step against the meta count
    with FlopCounterMode(display=False) as fcm:
        _, m = step(state, batch)
    float(m["loss"])
    card_flops = fcm.get_total_flops()
    print(f"FLOPs of the card's step (FlopCounterMode): {card_flops:.6e}, "
          f"meta {pred['flops_per_dev']:.6e}")
    require(card_flops == pred["flops_per_dev"],
            f"dry-run: FLOPs {card_flops} on the card, "
            f"{pred['flops_per_dev']} on meta")

    # the step's high-water mark, over what the state was built on
    del m
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - a0
    rel = peak / pmem["peak_bytes"] - 1.0
    print(f"peak of one step: {peak} B above the {a0} B allocated before "
          f"the state, predicted {pmem['peak_bytes']} B ({rel:+.4%}; "
          f"tolerance {DRY_PEAK_TOL:.0%})")
    require(abs(rel) <= DRY_PEAK_TOL,
            f"dry-run: peak {peak} B against {pmem['peak_bytes']} B predicted")

    # the roofline bound against the step's profiled device time
    del m
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        _, m = step(state, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - w0) * 1e3
    tp = train_profile(prof, wall_ms)
    print(f"profiled step: device {tp['device_ms']:.2f} ms of {wall_ms:.2f} "
          f"ms wall, {tp['kernels']} kernels; roofline bound "
          f"{prl['step_time_lb_s'] * 1e3:.2f} ms = "
          f"{prl['step_time_lb_s'] * 1e3 / tp['device_ms']:.4f} of the "
          f"device time ({smi_line()})")
    require(prl["step_time_lb_s"] * 1e3 <= tp["device_ms"],
            f"dry-run: bound {prl['step_time_lb_s']} s above the step's "
            f"device time {tp['device_ms']} ms")
    del state, batch, m, prof
    gc.collect()
    torch.cuda.empty_cache()
    report["dryrun"] = {
        "predicted": {k: pred[k] for k in ("flops_per_dev", "bytes_per_dev",
                                           "memory", "roofline", "op_count",
                                           "run_s")},
        "state": {"raw": raw, "rounded": rounded, "grown": grown,
                  "requested": req, "tails": tails, "tail_bytes": tail_b},
        "card_flops": card_flops, "peak_bytes": peak, "peak_rel": rel,
        "profile": tp}


def dryrun_cells(procs: dict, out_dir: Path) -> dict:
    """Phase 16 (b): each production cell's subprocess exits 0; its
    ``_fmt`` line is printed and its report read."""
    cells = {}
    for shape, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        print(f"python -m repro_torch.launch.dryrun --arch qwen2.5-14b "
              f"--shape {shape} --mesh single --save-ops: exit "
              f"{proc.returncode}")
        for ln in out.splitlines():
            print(f"  {ln}")
        require(proc.returncode == 0, f"dry-run {shape}: exit "
                f"{proc.returncode}: {err[-2000:]}")
        tag = out_dir / f"qwen2.5-14b__{shape}__single"
        cells[shape] = json.loads(Path(f"{tag}.json").read_text())
    return cells


MOON_LAYERS = 5            # the dense layer and 4 MoE layers
MOON_LENS = (5, 300, 1000, 2100)
MOON_MAX_LEN = 4096
MOON_GAP = 2.5             # bench/checks/moonlight-kanmoe-reason.json


def mla_time_row(dev, gen) -> dict:
    """B2's latent instance at the Moonlight cell's decode geometry: 256
    slots of a 8192-row cache, lengths uniform in 1024..5500, L2-cold,
    beside its byte bound (each admitted row once, q in, out f32) and the
    "ref" backend's batched products (every cache row)."""
    import torch

    from repro_torch.kernels.attention import MLA_DIMS, mla_attention
    from repro_torch.models import layers as L

    b, t, h = 256, 8192, 16
    dqk, dv = MLA_DIMS
    q = torch.randn(b, 1, h, dqk, generator=gen, device=dev) \
        .to(torch.bfloat16)
    ckv = torch.randn(b, t, dqk, generator=gen, device=dev) \
        .to(torch.bfloat16)
    pos = torch.randint(1023, 5500, (b, 1), generator=gen, device=dev)
    scale = (dqk - 64) ** -0.5

    def ref():
        sc = L._bmm_f32(q.reshape(b, h, dqk), ckv.transpose(1, 2)) * scale
        mask = (torch.arange(t, device=dev)[None, None] <= pos[:, :, None])
        pr = L._masked_softmax(sc, mask)
        return L._bmm_f32(pr.to(ckv.dtype), ckv[..., :dv])

    keys = int((pos + 1).sum())
    nbytes = keys * dqk * 2 + b * h * (dqk * 2 + dv * 4)
    ms = cold_ms(lambda: mla_attention(q, ckv, pos, dv=dv, scale=scale))
    row = {"shape": "mla_decode_256", "B": b, "T": t, "keys": keys,
           "cold_ms": ms, "ref_cold_ms": cold_ms(ref),
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
    row["roofline_pct"] = 100.0 * row["bound_ms"] / ms
    return row


def phase_moonlight(dev, report) -> dict:
    """Phase 17 (see the module docstring).  Returns the serving run's
    launch counts by path."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch import runtime
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import cardcheck as ac
    from repro_torch.kernels.kan_spline import cardcheck as cc
    from repro_torch.models.model import init_params

    gen = torch.Generator(device=dev).manual_seed(17)
    grouped = []
    for name, f, o, emit, rows in cc.B1_GROUPED_CASES:
        st = cc.check_b1_grouped(dev, gen, f, o, emit, rows)
        require(st["equal"] and st["empty"] >= 12, f"grouped B1 {name}: {st}")
        grouped.append({"case": name, **st})
        print(f"  grouped B1 {name}: {st['rows']} rows, {st['empty']} empty "
              f"experts, loop {st['rule']}; bits = a launch per expert; "
              f"plain per segment max |dy| {st['max_abs_err']:.3e}, "
              f"{st['excused']} excused codes")
    mla = []
    for case in ac.B2_MLA:
        st = ac.check_mla(dev, gen, *case)
        mla.append({"case": case[0], **st})
        print(f"  B2 latent {case[0]}: max err {st['max_abs_err']:.3e} "
              f"({st['max_err_over_tol']:.3f} of tol), {st['kv_splits']} "
              f"KV splits")
    timing = mla_time_row(dev, gen)
    print(f"  B2 latent at 256 slots ({timing['keys']} cache rows): "
          f"{timing['cold_ms']:.4f} ms cold, bound {timing['bound_ms']:.4f} "
          f"ms ({timing['roofline_pct']:.1f}%), \"ref\" products over every "
          f"row {timing['ref_cold_ms']:.4f} ms")
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("moonlight-16b-a3b").kan_variant(),
                              num_layers=MOON_LAYERS)
    n_moe = MOON_LAYERS - cfg.first_dense_layers
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in MOON_LENS]
    run = serve_once(params, cfg, prompts, dev, "contiguous",
                     engine_kw={"max_len": MOON_MAX_LEN})
    del params
    pre, dec = run["prefill_calls"], run["decode_calls"]
    calls = pre + dec
    want = {"flash_attention": pre * MOON_LAYERS,
            "flash_attention.mla": dec * MOON_LAYERS,
            "kan_pipeline_layer": 2 * calls * MOON_LAYERS,
            "kan_pipeline_layer.grouped": 2 * calls * n_moe}
    require(by_kernel(run["launches"]) == want,
            f"moonlight: launches {run['launches']} != {want} ({pre} prefill "
            f"+ {dec} decode calls)")
    require(all(v == "done" for v in run["status"].values())
            and len(run["status"]) == len(MOON_LENS),
            f"moonlight: requests not all served: {run['status']}")
    eng = run.pop("engine")
    gaps = []
    with torch.no_grad(), runtime.use_attn_backend("ref"):
        for rid, out in run["streams"].items():
            seq = torch.tensor([prompts[rid] + out[:-1]], device=dev)
            ref = forward_rows(eng.params, cfg, seq, len(prompts[rid]) - 1)
            tok = torch.tensor(out, device=dev)
            gaps.append(ref.max(dim=-1).values
                        - ref.gather(1, tok[:, None])[:, 0])
    gap = torch.cat(gaps)
    st = {"prefill_calls": pre, "decode_calls": dec,
          "launches": run["launches"], "steps": int(gap.numel()),
          "worst_gap": gap.max().item(), "mean_gap": gap.mean().item(),
          "ref_argmax_share": float((gap == 0).float().mean()),
          "wall_s": run["wall_s"], "decode_ms": run["decode_ms"],
          "peak_gib": run["peak_bytes"] / 2 ** 30}
    require(bool(torch.isfinite(gap).all()) and st["worst_gap"] <= MOON_GAP,
            f"moonlight: teacher-forced gaps {st}")
    print(f"  moonlight {MOON_LAYERS} layers: {pre} prefill + {dec} decode "
          f"calls, launches {by_kernel(run['launches'])}; {st['steps']} "
          f"tokens, widest gap under \"ref\" attention {st['worst_gap']:.4f}, "
          f"mean {st['mean_gap']:.3e}, {100 * st['ref_argmax_share']:.1f}% "
          f"its argmax; decode ms median "
          f"{float(np.median(run['decode_ms'])):.2f}, peak "
          f"{st['peak_gib']:.2f} GiB")
    report["moonlight"] = {"grouped": grouped, "mla": mla, "mla_time": timing,
                           "serve": st}
    del eng, run
    gc.collect()
    torch.cuda.empty_cache()
    return {"moonlight_contiguous": st["launches"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name} x {torch.cuda.device_count()}; {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = cuda.build()
    summary = ptxas_summary(info["ptxas"])
    print(f"build: {info['seconds']:.2f} s ({'cached' if info['cached'] else 'nvcc'}),"
          f" {len(summary)} kernel instances from {info['sources']}")
    for ln in summary:
        print(f"  ptxas: {ln}")
    # B2's D = 256 tensor-core instance: 128 f32 output registers a thread
    print("B2 flash_kernel_mma<256> (ptxas): "
          + require_no_spill(summary, "flash_kernel_mma<Li256E>"))
    # the latent instance: 64 f32 output registers a thread and the score
    # and probability fragments
    print("B2 flash_kernel_mla<576, 512> (ptxas): "
          + require_no_spill(summary, "flash_kernel_mla<Li576ELi512E>"))
    mma = sass_mma_counts(info["path"])
    if mma is None:
        print("SASS: no cuobjdump in this toolkit; tensor-core count not read")
    else:
        print(f"SASS tensor-core instructions (HMMA/HGMMA) by kernel: {mma}")
        require(any(k.startswith("flash_kernel_mma") and n > 0
                    for k, n in mma.items()),
                "B2: no HMMA/HGMMA in the tensor-core instance's SASS")

    report = {"device": name, "smi": smi, "build_s": info["seconds"],
              "ptxas": summary, "sass_mma": mma, "phase_s": {}}
    t_all = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        report["phase_s"][phase] = time.perf_counter() - t0
        print(f"[phase {phase}: {report['phase_s'][phase]:.1f} s]")
        return out

    errs = timed("3", phase_kernels, dev, report)
    timed("3b", phase_pact, dev, report)
    models = build_models(dev)
    by_path = {"kan_slice": timed("4", phase_slice, dev, models, report)}
    totals = timed("5", phase_times, dev, models, report)
    by_path.update(timed("5b", phase_acim, dev, models, report))
    del models
    torch.cuda.empty_cache()
    by_path.update(timed("6", phase_serve, dev, report))
    totals["flash_attention"], ffn_full = timed("7", phase_times_lm, dev,
                                                report)
    torch.cuda.empty_cache()
    by_path.update(timed("8", phase_codesign, dev, report))
    torch.cuda.empty_cache()
    timed("9", phase_train, dev, report)
    a7a_paths, a7a = timed("10", phase_a7a, dev, report)
    by_path.update(a7a_paths)
    a7b_paths, a7b = timed("11", phase_a7b, dev, report)
    by_path.update(a7b_paths)
    a7c_paths, a7c = timed("12", phase_a7c, dev, report)
    by_path.update(a7c_paths)
    by_path.update(timed("13", phase_mesh, dev, report))
    mesh_train = timed("14", phase_meshtrain, dev, report)
    by_path["examples"] = timed("15", phase_examples, dev, report)
    timed("16", phase_dryrun, dev, report)
    by_path.update(timed("17", phase_moonlight, dev, report))
    print(f"[phases 3-17: {time.perf_counter() - t_all:.1f} s]")
    # phase 10's, 11's and 12's B2 and B1 shapes join the kernel line's rows
    # (its B2 ms stays the sum over phase 7's three path shapes)
    for extra in (a7a, a7b, a7c):
        totals["flash_attention"]["shapes"] += extra["b2_rows"]
        ffn_full += extra["b1_rows"]
        errs["kan_pipeline_layer"] = max(errs["kan_pipeline_layer"],
                                         extra["kan_pipeline_layer"])
    totals["cim_mac_fwd"] = b4_totals(report["times_b4"],
                                      report["acim"]["mac"])
    errs["flash_attention"] = max(
        [errs["flash_attention"]]
        + [r["max_abs_err"] for r in totals["flash_attention"]["shapes"]])
    errs["cim_mac_fwd"] = max(
        [errs["cim_mac_fwd"]]
        + [r["max_abs_err"] for r in totals["cim_mac_fwd"]["shapes"]])

    out = ROOT / "reports"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1, default=str))

    replaces = {
        "kan_pipeline_layer": "src/repro/kernels/kan_spline/pipeline.py:471",
        "kan_spline": "src/repro/kernels/kan_spline/kernel.py:33",
        "flash_attention": "src/repro/kernels/attention/kernel.py:50",
        "cim_mac_fwd": "src/repro/kernels/cim_mac/kernel.py:24",
    }
    sources = {"flash_attention": B2_SOURCE, "cim_mac_fwd": B4_SOURCE}
    kernels = []
    for k in ("kan_pipeline_layer", "kan_spline", "flash_attention",
              "cim_mac_fwd"):
        t = totals[k]
        paths = {p: c.get(k, 0) for p, c in by_path.items() if c.get(k, 0)}
        row = {"name": k, "route": "cuda", "source": sources.get(k, SOURCE),
               "replaces": replaces[k], "launches": sum(paths.values()),
               "max_abs_err": errs[k], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
               "launches_by_path": paths,
               # phase 14's meshed training runs none of B1-B4
               "mesh_train_launches": mesh_train.get(k, 0)}
        if k != "cim_mac_fwd":
            # ms is L2-cold (cold_ms); warm_ms replays a CUDA graph of
            # launches on warm operands; event_ms times launches back to
            # back, where the host's launch pace can exceed a short kernel
            row["warm_ms"] = t["warm_ms"]
            row["event_ms"] = t.get("event_ms")
        if k == "flash_attention":
            row["shapes"] = [{key: r[key] for key in (
                "shape", "B", "S", "T", "instance", "kv_splits", "ms",
                "cold_ms",
                "warm_ms", "event_ms", "plain_ms", "library_ms",
                "library_warm_ms", "bound_ms", "bound_by", "max_abs_err")}
                for r in t["shapes"]]
        if k == "cim_mac_fwd":
            # ms: L2-cold, summed over the six shapes of the MAC path (the
            # reference's C = 64 case, never launched there, stands in
            # off_path_cold_ms); event and graph times are warm (operands
            # left in L2 by the previous launch)
            mac = report["acim"]["mac"]
            row["shapes"] = [{**{key: r[key] for key in (
                "shape", "B", "R_total", "A", "R", "C", "adc_bits",
                "cold_ms", "event_ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err", "max_err_over_allow", "tight")},
                "launches": mac["launches_by_shape"].get(r["shape"], 0)}
                for r in t["shapes"]]
            row["warm_event_ms"] = t["event_ms"]
            row["warm_graph_ms"] = t["graph_ms"]
            row["off_path_cold_ms"] = t["off_path_cold_ms"]
            row["mac_path_device_ms"] = mac["b4_device_ms"]
        if k == "kan_pipeline_layer":
            row["ffn_full_width"] = [{key: r[key] for key in (
                "layer", "grid", "rows", "feature_splits", "ms", "cold_ms",
                "warm_ms", "plain_ms", "bound_ms", "bound_by")}
                for r in ffn_full]
            row["row_tiles"] = report["b1_row_tiles"]
            row["loops"] = report["b1_loops"]
        require(row["launches"] > 0, f"{k}: no launch on any main path")
        kernels.append(row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
