"""Deterministic multi-objective co-design search (Pareto, not argmax).

Port of ``repro.tune.search``.  The paper's headline numbers come from
*searching* the KAN/quantization/mapping space under hardware constraints
(§3.4, Fig. 9).  This module runs that search as a seedable NSGA-II-lite
loop:

  * **proposals**: random samples and one-axis neighborhood mutations of
    the current front (:class:`~repro_torch.tune.space.DesignSpace`,
    ``numpy.random.default_rng``: the reference's proposals, in order),
    deduplicated;
  * **cost**: :func:`repro_torch.core.neurosim.kan_cost` (the
    22nm-calibrated accelerator model) gives area/energy/latency;
    candidates violating the
    :class:`~repro_torch.core.neurosim.HardwareConstraints` are recorded
    but never enter the front;
  * **quality**: task accuracy measured on the ``acim`` runtime backend
    (on the card: kernel B1 with its partial-sum noise operand, at the
    candidate's TM-DV split, array geometry and SAM placement), averaged
    over a fixed set of seeds so the whole search is reproducible;
  * **result**: a Pareto FRONT over (area, energy, latency, accuracy);
    callers pick an operating point per deployment budget
    (:func:`select_point`) and freeze it into a tuning artifact.

Per-candidate accuracy does NOT retrain: one float base network is trained
once per task, and each candidate's (G, K) basis is least-squares-refit
from it (:func:`repro_torch.core.kan_layer.refit_layer_spec`) before ASP
quantization.  The port's refit forms a float64 pseudo-inverse on the host
where the reference solves by SVD least squares; the two agree within
about 3e-6, which can move an ASP weight code that sits at a rounding tie.

Noise seeds.  The reference folds ``crc32(repr(candidate))`` into
``PRNGKey(eval_seed)`` and then each seed index ``s``.  Threefry has no
PyTorch counterpart, so the port seeds one ``torch.Generator`` on the
task's device per ``(eval_seed, digest, s)`` (:func:`candidate_generator`):
the same candidate and seeds give the same noise run to run, and the two
packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib

import numpy as np
import torch

from ..core.asp_quant import dequantize_input
from ..core.kan_layer import KANSpec, refit_layer_spec
from ..core.kan_network_deploy import (
    deploy_kan_network,
    kan_network_deploy_apply,
    quantize_kan_network,
)
from ..core.neurosim import (
    HardwareConstraints,
    check_constraints,
    kan_cost,
    train_kan,
)
from ..core.sam import row_activation_weight, sam_permutation
from ..device import resolve_device
from .space import Candidate, DesignSpace, default_candidate, space_hash

__all__ = [
    "OBJECTIVE_DIRECTIONS",
    "EvaluatedPoint",
    "SearchConfig",
    "SearchResult",
    "KnotTask",
    "make_knot_task",
    "deploy_candidate",
    "candidate_generator",
    "evaluate_candidate",
    "dominates",
    "pareto_front",
    "pareto_search",
    "select_point",
]

# +1.0 -> minimize, -1.0 -> maximize
OBJECTIVE_DIRECTIONS = {
    "area_mm2": 1.0,
    "energy_pj": 1.0,
    "latency_ns": 1.0,
    "phases": 1.0,
    "accuracy": -1.0,
}


@dataclasses.dataclass(frozen=True)
class EvaluatedPoint:
    """One scored candidate: the search's phenotype."""

    candidate: Candidate
    metrics: dict
    feasible: bool = True

    def to_dict(self) -> dict:
        return {
            "config": self.candidate.to_dict(),
            "metrics": {k: float(v) for k, v in self.metrics.items()},
            "feasible": bool(self.feasible),
        }


def dominates(a: dict, b: dict, objectives: tuple) -> bool:
    """True iff metrics ``a`` Pareto-dominates ``b`` on ``objectives``
    (every objective at least as good, at least one strictly better)."""
    better = False
    for name in objectives:
        sign = OBJECTIVE_DIRECTIONS[name]
        va, vb = sign * a[name], sign * b[name]
        if va > vb:
            return False
        if va < vb:
            better = True
    return better


def pareto_front(points, objectives: tuple) -> tuple:
    """Non-dominated subset of ``points`` (order-preserving)."""
    return tuple(
        p for p in points
        if not any(dominates(q.metrics, p.metrics, objectives)
                   for q in points if q is not p)
    )


# ----------------------------------------------------------------------------
# Task: what "accuracy" means for a candidate
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class KnotTask:
    """A trained base network + eval data: the quality oracle of the search.

    ``base_params`` is the float network trained ONCE at ``base_kspec``;
    candidates are refit from it.  ``calib_x`` feeds KAN-SAM placement and
    per-layer activation statistics.  ``ir_gamma``/``sigma_ps_ref`` are the
    measured 22nm non-ideality calibration every candidate is scored under.
    Tensors live on one device, where every candidate deploys and runs.
    """

    dims: tuple
    base_kspec: KANSpec
    base_params: list
    x_val: torch.Tensor
    y_val: np.ndarray
    calib_x: torch.Tensor
    ir_gamma: float = 0.06
    sigma_ps_ref: float = 0.05
    name: str = "knot"

    @property
    def device(self) -> torch.device:
        return self.x_val.device


def make_knot_task(
    n_train: int = 4096,
    n_val: int = 512,
    epochs: int = 40,
    seed: int = 0,
    dims: tuple = (17, 1, 14),
    base_grid: int = 8,
    base_order: int = 3,
    lr: float = 1.5e-2,
    label_noise: float = 0.04,
    calib_n: int = 256,
    ir_gamma: float = 0.06,
    sigma_ps_ref: float = 0.05,
    verbose: bool = False,
    *,
    device=None,
) -> KnotTask:
    """Train the shared float base network on the knot surrogate (once),
    on ``device`` (the card unless ``device="cpu"``).  The data is the
    reference's for the same seed; the trained network is not (see
    ``neurosim.train_kan``)."""
    from ..data.knot import make_knot_dataset

    dev = resolve_device(device)
    xt, yt, xv, yv = make_knot_dataset(n_train, n_val, seed=seed,
                                       label_noise=label_noise)
    kspec = KANSpec(dims=tuple(dims), grid_size=base_grid, order=base_order)
    params, _ = train_kan(kspec, xt, yt, xv, yv, epochs=epochs,
                          batch_size=1024, lr=lr, seed=seed, verbose=verbose,
                          device=dev)
    return KnotTask(
        dims=tuple(dims), base_kspec=kspec, base_params=params,
        x_val=torch.as_tensor(np.array(xv, np.float32), device=dev),
        y_val=np.asarray(yv),
        calib_x=torch.as_tensor(np.array(xt[:calib_n], np.float32),
                                device=dev),
        ir_gamma=ir_gamma, sigma_ps_ref=sigma_ps_ref,
    )


def deploy_candidate(task: KnotTask, cand: Candidate):
    """Refit the base network to the candidate's basis, quantize, deploy.

    Returns (kspec, qparams, dep); ``dep`` is bound to the task's
    validation batch on the task's device and runs on any backend.
    """
    kspec_c = KANSpec(
        dims=task.dims, grid_size=cand.grid_size, order=cand.order,
        n_bits=cand.layer_bits if cand.layer_bits else cand.n_bits,
        lut_bits=cand.n_bits,
    )
    base_spec = task.base_kspec.layer_spec()
    spec_c = kspec_c.layer_spec()
    if (spec_c.grid_size, spec_c.order) == (base_spec.grid_size,
                                            base_spec.order):
        params = task.base_params
    else:
        params = [refit_layer_spec(p, base_spec, spec_c)
                  for p in task.base_params]
    qparams = quantize_kan_network(params, kspec_c)
    dep = deploy_kan_network(qparams, kspec_c,
                             batch=int(task.x_val.shape[0]),
                             device=task.device)
    return kspec_c, qparams, dep


def _sam_perms(task: KnotTask, cand: Candidate, dep, kspec: KANSpec) -> tuple:
    """Per-layer KAN-SAM placements from calibration activations.

    Layer 0 calibrates on the task's calibration inputs; deeper layers on
    the dequantized boundary codes an ideal (quantized, noise-free) pass
    emits: the same activation statistics the deployed chip would profile.
    """
    specs = kspec.layer_specs()
    _, codes = kan_network_deploy_apply(dep, task.calib_x, backend="ref",
                                        return_intermediates=True)
    layer_inputs = [task.calib_x]
    for li, c in enumerate(codes):
        # boundary codes are emitted at the NEXT layer's input width
        layer_inputs.append(dequantize_input(c, specs[li + 1]))
    perms = []
    for li, f in enumerate(task.dims[:-1]):
        rw = row_activation_weight(layer_inputs[li], specs[li], f)
        perms.append(tuple(int(i) for i in
                           sam_permutation(rw, cand.array_rows)))
    return tuple(perms)


def candidate_generator(cand: Candidate, eval_seed: int, s: int,
                        device) -> torch.Generator:
    """The noise generator of seed index ``s`` of one candidate.

    Seeded with the first 8 bytes (little-endian) of
    ``sha256(f"{eval_seed}:{digest}:{s}")``, where ``digest`` is the
    reference's ``crc32(repr(cand)) & 0x7FFFFFFF``: stable across runs and
    platforms (no Python ``hash``), distinct for every candidate and seed.
    """
    digest = zlib.crc32(repr(cand).encode()) & 0x7FFFFFFF
    mix = hashlib.sha256(f"{eval_seed}:{digest}:{s}".encode()).digest()
    seed = int.from_bytes(mix[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF
    return torch.Generator(device=device).manual_seed(seed)


def evaluate_candidate(
    task: KnotTask | None,
    cand: Candidate,
    *,
    acim_seeds: int = 2,
    eval_seed: int = 0,
    dims: tuple = (17, 1, 14),
) -> dict:
    """Score one candidate: accelerator cost (+ acim accuracy with a task).

    With ``task=None`` this is a pure hardware design-space evaluation
    (area/energy/latency/phases only, on ``dims``).  With a task, accuracy
    is the mean over ``acim_seeds`` seeded runs of the ``acim`` backend at
    the candidate's TM-DV split, array geometry and (optionally) SAM
    placement.
    """
    metrics = dict(kan_cost(
        task.dims if task is not None else tuple(dims),
        cand.grid_size, cand.order, cand.n_bits,
        cand.input_gen(), cand.array_rows, cand.adc_bits,
        layer_bits=cand.layer_bits,
    ))
    if task is None:
        return metrics
    kspec_c, _, dep = deploy_candidate(task, cand)
    sam_perms = (_sam_perms(task, cand, dep, kspec_c)
                 if cand.use_sam else None)
    cim = cand.cim_config(task.ir_gamma, task.sigma_ps_ref)
    accs = []
    for s in range(acim_seeds):
        logits = kan_network_deploy_apply(
            dep, task.x_val, backend="acim", cim=cim, sam_perms=sam_perms,
            generator=candidate_generator(cand, eval_seed, s, task.device),
        )
        accs.append(float(
            (np.argmax(logits.cpu().numpy(), -1) == task.y_val).mean()))
    metrics["accuracy"] = float(np.mean(accs))
    return metrics


# ----------------------------------------------------------------------------
# The search loop
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """The reference's search knobs (its ``interpret`` switch has no
    counterpart: the port runs where the task's tensors are)."""

    budget: int = 24          # total candidate evaluations (incl. baseline)
    n_init: int = 6           # random seeding of the first round
    n_neighbors: int = 2      # mutations proposed per front member per round
    seed: int = 0             # proposal RNG seed
    eval_seed: int = 0        # accuracy-noise seed family
    acim_seeds: int = 2       # noise seeds averaged per accuracy estimate
    objectives: tuple | None = None  # None -> cost axes (+accuracy w/ task)


@dataclasses.dataclass
class SearchResult:
    front: tuple              # tuple[EvaluatedPoint]: feasible, non-dominated
    evaluated: tuple          # every scored point, evaluation order
    baseline: EvaluatedPoint | None
    objectives: tuple
    seed: int
    space_hash: str
    n_evals: int
    calibration: dict | None = None  # non-ideality point accuracy was scored at

    def dominating_baseline(self, on: tuple = ("energy_pj", "accuracy")):
        """Front points that Pareto-dominate the baseline on ``on``."""
        if self.baseline is None:
            return ()
        return tuple(p for p in self.front
                     if dominates(p.metrics, self.baseline.metrics, on))

    def to_dict(self) -> dict:
        return {
            "objectives": list(self.objectives),
            "seed": self.seed,
            "space_hash": self.space_hash,
            "n_evals": self.n_evals,
            "calibration": self.calibration,
            "front": [p.to_dict() for p in self.front],
            "baseline": None if self.baseline is None
            else self.baseline.to_dict(),
        }


def pareto_search(
    task: KnotTask | None,
    space: DesignSpace,
    *,
    constraints: HardwareConstraints | None = None,
    config: SearchConfig | None = None,
    baseline: Candidate | None = None,
    dims: tuple = (17, 1, 14),
) -> SearchResult:
    """Run the co-design search; fully deterministic under a fixed config.

    ``baseline`` (default: the repo's un-searched deployment defaults) is
    always evaluated first so the front can be compared against it; pass a
    candidate of your own to rebase the comparison.  ``dims`` only matters
    for the task-free (cost-only) mode; with a task the task's dims rule.
    """
    cfg = config or SearchConfig()
    if cfg.objectives is not None:
        objectives = tuple(cfg.objectives)
    else:
        objectives = ("area_mm2", "energy_pj", "latency_ns")
        if task is not None:
            objectives += ("accuracy",)
    rng = np.random.default_rng(cfg.seed)
    if baseline is None:
        baseline = default_candidate()

    seen: dict = {}
    evaluated: list = []

    def eval_one(cand: Candidate):
        if cand in seen or not space.is_valid(cand):
            return None
        metrics = evaluate_candidate(
            task, cand, acim_seeds=cfg.acim_seeds,
            eval_seed=cfg.eval_seed, dims=dims,
        )
        feasible = constraints is None or check_constraints(metrics,
                                                            constraints)
        pt = EvaluatedPoint(candidate=cand, metrics=metrics,
                            feasible=feasible)
        seen[cand] = pt
        evaluated.append(pt)
        return pt

    base_pt = eval_one(baseline)
    for cand in space.sample(rng, cfg.n_init):
        if len(evaluated) >= cfg.budget:
            break
        eval_one(cand)

    while len(evaluated) < cfg.budget:
        front = pareto_front([p for p in evaluated if p.feasible],
                             objectives)
        proposals: list = []
        for p in front:
            proposals += space.neighbors(p.candidate, rng, cfg.n_neighbors)
        proposals += space.sample(rng, 2)
        fresh = [c for c in proposals if c not in seen]
        if not fresh:
            break
        for cand in fresh[: cfg.budget - len(evaluated)]:
            eval_one(cand)

    front = pareto_front([p for p in evaluated if p.feasible], objectives)
    front = tuple(sorted(front, key=lambda p: (p.metrics["energy_pj"],
                                               p.metrics["area_mm2"],
                                               repr(p.candidate))))
    calibration = None
    if task is not None:
        # the exact non-ideality point every accuracy above was scored at
        # (TMDV sigma refs come from Candidate.input_gen's defaults)
        from ..core.tmdv import TMDVConfig

        tm = TMDVConfig()
        calibration = {
            "ir_gamma": float(task.ir_gamma),
            "sigma_ps_ref": float(task.sigma_ps_ref),
            "sigma_v_ref": float(tm.sigma_v_ref),
            "sigma_t": float(tm.sigma_t),
        }
    return SearchResult(
        front=front,
        evaluated=tuple(evaluated),
        baseline=base_pt,
        objectives=objectives,
        seed=cfg.seed,
        space_hash=space_hash(space),
        n_evals=len(evaluated),
        calibration=calibration,
    )


def select_point(front, prefer: str = "accuracy") -> EvaluatedPoint:
    """Pick one operating point off a front.

    ``prefer="accuracy"``: highest accuracy, ties broken by lowest energy,
    the paper's "accuracy boost under the budget" reading.  Any other name
    minimizes that metric, ties broken by highest accuracy.
    """
    if not front:
        raise ValueError("empty Pareto front")
    if prefer == "accuracy":
        return max(front, key=lambda p: (p.metrics.get("accuracy", 0.0),
                                         -p.metrics["energy_pj"]))
    return min(front, key=lambda p: (p.metrics[prefer],
                                     -p.metrics.get("accuracy", 0.0)))
