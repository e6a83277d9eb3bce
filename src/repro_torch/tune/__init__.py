"""repro_torch.tune: hardware-aware co-design autotuner (paper §3.4, scaled up).

Port of ``repro.tune``, with its export list.  Three cooperating pieces:

  * :mod:`~repro_torch.tune.space` + :mod:`~repro_torch.tune.search`: a
    declarative design space over the paper's knobs (ASP bit width,
    B-spline G/K, TM-DV voltage/time split, KAN-SAM on/off, ACIM array
    geometry) and a deterministic seedable multi-objective search returning
    a Pareto front over (area, energy, latency, accuracy), scored by the
    calibrated cost model and the ``acim`` runtime backend (on the card:
    kernel B1 with its noise operand).
  * :mod:`~repro_torch.tune.tiles`: an empirical tile autotuner that sweeps
    ``(bb, bo, bf)`` for a deployed network, gates candidates on
    bit-exactness, times kernel B1's distinct launches (its row tile) on
    the card, and registers the winner with the runtime plan cache so every
    consumer picks it up.
  * :mod:`~repro_torch.tune.artifact`: versioned JSON tuning artifacts
    (space hash, seed, front, chosen point, tile plan), byte-compatible
    with the reference's, that ``launch.serve --tuned-config`` loads, so a
    tuned deployment reproduces from a file instead of a re-search.

    from repro_torch import tune
    task = tune.make_knot_task()                 # on the card
    result = tune.pareto_search(task, tune.DesignSpace(), constraints=hc)
    chosen = tune.select_point(result.front)
    _, _, dep = tune.deploy_candidate(task, chosen.candidate)
    tile = tune.tune_tiles(dep)
    art = tune.build_tuning_artifact(search=result, chosen=chosen, tile=tile)
    tune.save_tuning_artifact("TUNE_artifact.json", art)
"""

from .artifact import (
    ARTIFACT_KIND,
    ARTIFACT_VERSION,
    apply_tuning_artifact,
    build_tuning_artifact,
    load_tuning_artifact,
    save_tuning_artifact,
)
from .search import (
    OBJECTIVE_DIRECTIONS,
    EvaluatedPoint,
    KnotTask,
    SearchConfig,
    SearchResult,
    deploy_candidate,
    dominates,
    evaluate_candidate,
    make_knot_task,
    pareto_front,
    pareto_search,
    select_point,
)
from .space import (
    Candidate,
    DesignSpace,
    candidate_from_dict,
    default_candidate,
    space_hash,
)
from .tiles import (
    TileTrial,
    TileTuneResult,
    enumerate_tile_candidates,
    plan_cost_proxy,
    tune_tiles,
)

__all__ = [
    "ARTIFACT_KIND",
    "ARTIFACT_VERSION",
    "Candidate",
    "DesignSpace",
    "EvaluatedPoint",
    "KnotTask",
    "OBJECTIVE_DIRECTIONS",
    "SearchConfig",
    "SearchResult",
    "TileTrial",
    "TileTuneResult",
    "apply_tuning_artifact",
    "build_tuning_artifact",
    "candidate_from_dict",
    "default_candidate",
    "deploy_candidate",
    "dominates",
    "enumerate_tile_candidates",
    "evaluate_candidate",
    "load_tuning_artifact",
    "make_knot_task",
    "pareto_front",
    "pareto_search",
    "plan_cost_proxy",
    "save_tuning_artifact",
    "select_point",
    "space_hash",
    "tune_tiles",
]
