"""Empirical tile autotuner for the fused KAN pipeline (kernel B1).

Port of ``repro.tune.tiles``.  ``make_pipeline_plan`` picks ``(bb, bo, bf)``
by a fixed heuristic; this module sweeps valid tile overrides for a
deployed network's geometry, checks each candidate plan against the
heuristic plan for bit-exactness (outputs AND boundary codes: tiling must
change the schedule, never the numbers), scores the survivors, and
registers the winner with the runtime plan cache so every consumer
(``DeployedKAN.replan``, the executors, the serving path) runs on it.

On the card the overrides reach kernel B1 through one knob: the plan's
``row_tile`` (16, 32 or 64 batch rows per block, from the tuned ``bb``);
``bo`` and ``bf`` decide padding and plan validity only.  Candidates with
the same ``row_tile`` are therefore the same launch: in measured mode each
launch is timed once, and a candidate whose launch was already timed is
recorded with that time and ``reason="same launch as <overrides>"``.

Two scoring modes, chosen by the bundle's device:

  * **measured** (on the card): the median of ``repeats`` CUDA-event
    timings of the whole pipeline (``kan_pipeline_impl``), in microseconds.
    Each timed call is queued behind a ~1 ms spin of the card, so the host
    has enqueued the pipeline's launches before the start event fires and
    the events read device time, not the host's launch pace (which, for a
    small network, is longer than its kernels);
  * **proxy** (on the CPU): the reference's deterministic cost proxy
    (:func:`plan_cost_proxy`), with every candidate still executed once
    for the bit-exactness gate, so a CPU run validates the mechanism and
    gives the reference's trials and verdicts.

Candidates never change the padded dims ``fp``/``op`` (enforced by
``make_pipeline_plan``'s override validation), so weight bundles padded
under the heuristic plan stay valid verbatim: registering a tuned plan is
a schedule swap, not a redeploy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.kan_spline.pipeline import (
    PipelinePlan,
    kan_pipeline_impl,
    make_pipeline_plan,
    normalize_tile_overrides,
    validate_plan,
)
from ..runtime.plancache import PLAN_CACHE, bucket_batch

__all__ = [
    "TileTrial",
    "TileTuneResult",
    "enumerate_tile_candidates",
    "plan_cost_proxy",
    "tune_tiles",
]


@dataclasses.dataclass(frozen=True)
class TileTrial:
    """One swept tile candidate and what happened to it."""

    overrides: tuple          # per-layer ((bb, bo, bf), ...)
    valid: bool
    exact: bool
    score: float              # us (measured) or proxy units; inf if rejected
    reason: str = ""          # why it was rejected or not timed, if so
    row_tile: int = 0         # kernel B1's rows per block; 0 if invalid


@dataclasses.dataclass
class TileTuneResult:
    dims: tuple
    specs: tuple
    residual_raw: bool
    bucket: int
    mode: str                 # "measured" | "proxy"
    heuristic_plan: PipelinePlan
    heuristic_score: float
    chosen_overrides: tuple | None   # None -> heuristic won
    chosen_plan: PipelinePlan
    trials: tuple             # tuple[TileTrial]
    registered: bool

    @property
    def tuned(self) -> bool:
        return self.chosen_overrides is not None

    def to_dict(self) -> dict:
        return {
            "dims": list(self.dims),
            "residual_raw": bool(self.residual_raw),
            "bucket": int(self.bucket),
            "mode": self.mode,
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "overrides": None if self.chosen_overrides is None
            else [list(t) for t in self.chosen_overrides],
            "heuristic_score": float(self.heuristic_score),
            "n_trials": len(self.trials),
        }


def _heuristic_overrides(plan: PipelinePlan) -> tuple:
    return tuple((lp.bb, lp.bo, lp.bf) for lp in plan.layers)


def enumerate_tile_candidates(
    plan: PipelinePlan,
    *,
    max_candidates: int = 16,
    seed: int = 0,
) -> list:
    """Valid (by construction) tile-override candidates for a plan's shape.

    Sweeps the batch block, the output block and a per-layer shrink of the
    contraction block, constrained to power-of-two divisors of the plan's
    padded dims.  The heuristic's own blocks are always candidate 0 so the
    tuner can conclude "heuristic wins".  Deterministically subsampled to
    ``max_candidates`` under ``seed``.
    """
    heur = _heuristic_overrides(plan)
    bb_h = plan.layers[0].bb
    bb_opts = sorted({bb for bb in (8, 16, 32, 64, 128, 256)
                      if bb <= max(plan.bp, bb_h)} | {bb_h})
    bo_opts = (128, 64, 32)
    bf_shifts = (0, 1, 2)

    cands = [heur]
    for bb in bb_opts:
        for bo in bo_opts:
            for shift in bf_shifts:
                ov = []
                ok = True
                for lp in plan.layers:
                    bo_c = min(bo, lp.op)
                    while lp.op % bo_c:
                        bo_c //= 2
                    bf_c = max(8, lp.bf >> shift)
                    if lp.fp % bf_c or bo_c < 8:
                        ok = False
                        break
                    ov.append((bb, bo_c, bf_c))
                if ok:
                    ov = tuple(ov)
                    if ov not in cands:
                        cands.append(ov)
    extra = cands[1:]
    if len(extra) > max_candidates - 1:
        rng = np.random.default_rng(seed)
        keep = sorted(rng.choice(len(extra), size=max_candidates - 1,
                                 replace=False).tolist())
        extra = [extra[i] for i in keep]
    return [heur] + extra


def plan_cost_proxy(plan: PipelinePlan) -> float:
    """Deterministic stand-in for wall-clock where timing is meaningless.

    Models the two things tiling changes at fixed padded dims in the
    reference's TPU schedule: per-tile dispatch overhead (finer grids pay
    more fixed cost) and padded-batch waste (``bp`` grows with ``bb``).
    Compute volume itself is tile-invariant, so it enters only through
    ``bp``.
    """
    C0 = 4096.0  # fixed per-tile dispatch/prologue cost, flop-equivalents
    total = 0.0
    for lp in plan.layers:
        nb = lp.spec.num_basis
        cells = (plan.bp // lp.bb) * (lp.op // lp.bo) * (lp.fp // lp.bf)
        tile_work = lp.bb * lp.bf * nb * (1.0 + lp.bo)  # basis build + MAC
        total += cells * (C0 + tile_work)
    return total


def _sample_inputs(plan: PipelinePlan, seed: int, device):
    """Deterministic entry codes (+ raw activations) at the plan's bucket."""
    rng = np.random.default_rng(seed)
    spec0 = plan.layers[0].spec
    codes = torch.as_tensor(
        rng.integers(0, spec0.num_codes, size=(plan.b, plan.layers[0].f)),
        dtype=torch.int32, device=device,
    )
    xraw = None
    if plan.layers[0].residual_raw:
        xraw = torch.as_tensor(
            rng.standard_normal((plan.b, plan.layers[0].f)),
            dtype=torch.float32, device=device,
        )
    return codes, xraw


def _run_plan(codes, xraw, layers, plan):
    y, bcodes = kan_pipeline_impl(codes, xraw, layers, plan,
                                  return_intermediates=True)
    return y.cpu().numpy(), tuple(c.cpu().numpy() for c in bcodes)


# device clock cycles (about 1 ms on an H100) the card spins before each
# timed call, while the host enqueues it
_SPIN_CYCLES = 2_000_000


def _time_plan(codes, xraw, layers, plan, repeats) -> float:
    """Median over ``repeats`` CUDA-event timings (us) of the pipeline,
    each behind a spin of the card that keeps the host's enqueue out of
    the timed interval."""
    fn = lambda: kan_pipeline_impl(codes, xraw, layers, plan)
    fn()  # warm: the library is built and every instance loaded
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def tune_tiles(
    dep,
    *,
    batch: int | None = None,
    candidates=None,
    max_candidates: int = 16,
    repeats: int = 5,
    seed: int = 0,
    register: bool = True,
    warm: bool = True,
    score_fn=None,
) -> TileTuneResult:
    """Sweep tile geometries for a deployed KAN; register the winner.

    ``dep`` is a :class:`~repro_torch.core.kan_network_deploy.DeployedKAN`;
    the sweep runs at the batch bucket of ``batch`` (default: the bundle's
    bound batch), in measured mode on the card and proxy mode on the CPU.
    Every candidate is validated (:func:`validate_plan`) and gated on
    bit-exact outputs + boundary codes vs the heuristic plan before it may
    win.  With ``register=True`` the winning overrides are installed in the
    runtime plan cache (a no-op when the heuristic wins) and, with
    ``warm=True``, the fused executor's entry is built once here
    (``runtime.execute(dep, x, backend="fused")``), so consumers hit the
    cache.

    ``score_fn(plan) -> float`` replaces the scoring entirely when given
    (candidates are still validated and exactness-gated).  The proxy is
    minimized by the heuristic's maximal blocks by construction, so on the
    CPU the tuner reports "heuristic wins".
    """
    device = dep.device
    mode = "measured" if device.type == "cuda" else "proxy"
    dims, specs, residual_raw = tuple(dep.dims), tuple(dep.specs), \
        dep.residual_raw
    bucket = bucket_batch(batch if batch is not None else dep.plan.b)

    # the pure heuristic baseline, independent of any registered overrides
    heur_plan = make_pipeline_plan(bucket, dims, specs,
                                   residual_raw=residual_raw)
    codes, xraw = _sample_inputs(heur_plan, seed, device)
    y_ref, codes_ref = _run_plan(codes, xraw, dep.layers, heur_plan)

    if candidates is None:
        candidates = enumerate_tile_candidates(
            heur_plan, max_candidates=max_candidates, seed=seed)
    heur_ov = _heuristic_overrides(heur_plan)
    n_layers = len(dims) - 1
    normed = []
    for c in candidates:
        try:
            nc = normalize_tile_overrides(c, n_layers)
        except ValueError:
            nc = tuple(tuple(t) for t in c)  # keep malformed; trial rejects
        if nc not in normed:
            normed.append(nc)
    if heur_ov not in normed:
        normed.insert(0, heur_ov)  # the baseline must always compete
    candidates = normed

    trials = []
    scored = []  # (score, order_index, overrides, plan)
    timed: dict = {}  # measured mode: row_tile -> (score, overrides)
    for idx, ov in enumerate(candidates):
        try:
            plan_c = make_pipeline_plan(bucket, dims, specs,
                                        residual_raw=residual_raw,
                                        tile_overrides=ov)
            validate_plan(plan_c)
        except ValueError as e:
            trials.append(TileTrial(overrides=tuple(ov), valid=False,
                                    exact=False, score=float("inf"),
                                    reason=str(e)))
            continue
        y_c, codes_c = _run_plan(codes, xraw, dep.layers, plan_c)
        exact = np.array_equal(y_c, y_ref) and all(
            np.array_equal(a, b) for a, b in zip(codes_c, codes_ref)
        )
        if not exact:
            trials.append(TileTrial(overrides=tuple(ov), valid=True,
                                    exact=False, score=float("inf"),
                                    reason="not bit-exact vs heuristic",
                                    row_tile=plan_c.row_tile))
            continue
        reason = ""
        if score_fn is not None:
            score = float(score_fn(plan_c))
        elif mode == "measured":
            if plan_c.row_tile in timed:
                score, first = timed[plan_c.row_tile]
                reason = f"same launch as {first}"
            else:
                score = _time_plan(codes, xraw, dep.layers, plan_c, repeats)
                timed[plan_c.row_tile] = (score, tuple(ov))
        else:
            score = plan_cost_proxy(plan_c)
        trials.append(TileTrial(overrides=tuple(ov), valid=True, exact=True,
                                score=score, reason=reason,
                                row_tile=plan_c.row_tile))
        scored.append((score, idx, tuple(ov), plan_c))

    heur_score = next(t.score for t in trials
                      if t.overrides == heur_ov and t.exact)
    best_score, _, best_ov, best_plan = min(scored, key=lambda s: (s[0], s[1]))
    tuned = best_ov != heur_ov and best_score < heur_score

    registered = False
    if register:
        PLAN_CACHE.set_tile_overrides(
            dims, specs, residual_raw, best_ov if tuned else None
        )
        registered = tuned
        if tuned and warm:
            # build the consumer-visible executor entry HERE so callers of
            # the serving/deploy surfaces get pure cache hits afterwards
            from .. import runtime

            rng = np.random.default_rng(seed)
            spec0 = specs[0]
            x = torch.as_tensor(
                rng.uniform(spec0.lo, spec0.hi, size=(bucket, dims[0])),
                dtype=torch.float32, device=device,
            )
            runtime.execute(dep, x, backend="fused")

    return TileTuneResult(
        dims=dims, specs=specs, residual_raw=residual_raw, bucket=bucket,
        mode=mode,
        heuristic_plan=heur_plan, heuristic_score=heur_score,
        chosen_overrides=best_ov if tuned else None,
        chosen_plan=best_plan if tuned else heur_plan,
        trials=tuple(trials),
        registered=registered,
    )
