"""Versioned, deployable tuning artifacts (search + tile plan as a file).

Port of ``repro.tune.artifact``: the same schema and the same bytes on
disk (``json.dump(..., indent=2, sort_keys=True)`` plus a newline), so an
artifact written by either package loads in the other and resolves to the
same candidate, specs, configs and tile geometry.  On the card a
registered tile plan sets kernel B1's row tile (``PipelinePlan.row_tile``).

A tuned deployment must be reproducible WITHOUT re-running the search: the
artifact freezes everything the runtime needs — the space fingerprint and
seed (provenance), the Pareto front and the chosen operating point
(quantization/mapping), and the tuned tile plan (schedule) — into one JSON
file that ``launch.serve --tuned-config``, ``ServeEngine`` setups and the
examples load at deploy time.

Schema (version 1)::

    {
      "kind": "repro.tune.artifact", "version": 1,
      "task": "knot", "seed": 0, "space_hash": "...",
      "calibration": {"ir_gamma": ..., "sigma_ps_ref": ...,
                      "sigma_v_ref": ..., "sigma_t": ...} | null,
      "objectives": [...],
      "front":    [{"config": {...}, "metrics": {...}, "feasible": true}],
      "baseline": {...} | null,
      "chosen":   {"config": {...}, "metrics": {...}} | null,
      "tile_plan": {
        "dims": [...], "residual_raw": false, "bucket": 32,
        "mode": "measured" | "proxy",
        "specs": [{"grid_size": ..., "order": ..., ...}],
        "overrides": [[bb, bo, bf], ...] | null
      } | null
    }

``apply_tuning_artifact`` re-installs the tile plan in the runtime plan
cache and resolves the chosen point back into live config objects
(:class:`~repro_torch.core.asp_quant.ASPQuantSpec`,
:class:`~repro_torch.core.tmdv.TMDVConfig`, :class:`~repro_torch.core.cim.CIMConfig`),
so loading an artifact under the same seed reproduces the identical
deployment the tuner built.
"""

from __future__ import annotations

import dataclasses
import json

from ..core.asp_quant import ASPQuantSpec
from ..runtime.plancache import PLAN_CACHE
from .space import candidate_from_dict

__all__ = [
    "ARTIFACT_KIND",
    "ARTIFACT_VERSION",
    "build_tuning_artifact",
    "save_tuning_artifact",
    "load_tuning_artifact",
    "apply_tuning_artifact",
]

ARTIFACT_KIND = "repro.tune.artifact"
ARTIFACT_VERSION = 1


def _spec_from_dict(d: dict) -> ASPQuantSpec:
    fields = {f.name for f in dataclasses.fields(ASPQuantSpec)}
    return ASPQuantSpec(**{k: v for k, v in d.items() if k in fields})


def build_tuning_artifact(
    *,
    search=None,          # SearchResult | None
    chosen=None,          # EvaluatedPoint | None
    tile=None,            # TileTuneResult | None
    task: str = "knot",
    extra: dict | None = None,
) -> dict:
    """Assemble the artifact dict from tuner outputs (all optional)."""
    art = {
        "kind": ARTIFACT_KIND,
        "version": ARTIFACT_VERSION,
        "task": task,
        "seed": None if search is None else int(search.seed),
        "space_hash": None if search is None else search.space_hash,
        "calibration": None if search is None else search.calibration,
        "objectives": [] if search is None else list(search.objectives),
        "front": [] if search is None else [p.to_dict() for p in search.front],
        "baseline": None if search is None or search.baseline is None
        else search.baseline.to_dict(),
        "chosen": None if chosen is None else {
            "config": chosen.candidate.to_dict(),
            "metrics": {k: float(v) for k, v in chosen.metrics.items()},
        },
        "tile_plan": None if tile is None else tile.to_dict(),
    }
    if extra:
        art.update(extra)
    return art


def save_tuning_artifact(path: str, artifact: dict) -> None:
    if artifact.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"not a tuning artifact: kind={artifact.get('kind')!r}")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")


def load_tuning_artifact(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"{path}: not a tuning artifact "
                         f"(kind={art.get('kind')!r})")
    if int(art.get("version", -1)) > ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact version {art['version']} is newer than this "
            f"runtime understands ({ARTIFACT_VERSION})"
        )
    return art


def apply_tuning_artifact(artifact: dict, *,
                          register_tiles: bool = True) -> dict:
    """Install the artifact and resolve it into live objects.

    Returns::

        {
          "candidate": Candidate | None,      # the chosen operating point
          "spec": ASPQuantSpec | None,        # its quantization grid
          "input_gen": TMDVConfig | None,     # its TM-DV split
          "cim": CIMConfig | None,            # its ACIM macro config
          "tile_overrides": tuple | None,     # what was registered
          "tile_geometry": (dims, specs, residual_raw) | None,
          "plan": PipelinePlan | None,        # resolved at the artifact's
        }                                     #  bucket, post-registration

    With ``register_tiles`` the tile plan is registered in the runtime plan
    cache (geometry-keyed), so any consumer deploying the matching network
    picks it up transparently; ``plan`` is the cache's resolved plan for
    the artifact's own bucket — under the same seed it is identical to the
    plan the tuner chose (the round-trip the tests assert).
    """
    resolved: dict = {
        "candidate": None, "spec": None, "input_gen": None, "cim": None,
        "tile_overrides": None, "tile_geometry": None, "plan": None,
    }
    chosen = artifact.get("chosen")
    if chosen and chosen.get("config"):
        cand = candidate_from_dict(chosen["config"])
        resolved["candidate"] = cand
        resolved["spec"] = cand.spec()
        # resolve at the calibration the artifact's accuracies were scored
        # under (falling back to the shipped 22nm defaults for artifacts
        # that predate the field)
        cal = artifact.get("calibration") or {}
        ig = cand.input_gen(
            sigma_v_ref=float(cal.get("sigma_v_ref", 0.015)),
            sigma_t=float(cal.get("sigma_t", 0.08)),
        )
        resolved["input_gen"] = ig
        resolved["cim"] = dataclasses.replace(
            cand.cim_config(
                ir_gamma=float(cal.get("ir_gamma", 0.06)),
                sigma_ps_ref=float(cal.get("sigma_ps_ref", 0.05)),
            ),
            input_gen=ig,
        )

    tp = artifact.get("tile_plan")
    if tp:
        dims = tuple(tp["dims"])
        specs = tuple(_spec_from_dict(d) for d in tp["specs"])
        residual_raw = bool(tp["residual_raw"])
        overrides = tp.get("overrides")
        overrides = None if overrides is None else tuple(
            tuple(int(v) for v in t) for t in overrides
        )
        resolved["tile_geometry"] = (dims, specs, residual_raw)
        resolved["tile_overrides"] = overrides
        if register_tiles:
            PLAN_CACHE.set_tile_overrides(dims, specs, residual_raw,
                                          overrides)
            resolved["plan"] = PLAN_CACHE.plan(
                int(tp.get("bucket", 8)), dims, specs,
                residual_raw=residual_raw,
            )
    return resolved
