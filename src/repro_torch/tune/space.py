"""Declarative co-design search space (the knobs of the paper's techniques).

Port of ``repro.tune.space``, line for line: the same axes, validity rule,
``numpy.random.default_rng`` proposals (so one seed proposes the same
candidates in the same order in both packages) and the same
:func:`space_hash`, the tuning artifact's provenance key.

One :class:`Candidate` is a complete hardware/algorithm operating point:

  * ``grid_size`` / ``order``  — the B-spline basis (G, K); more grid means
    more accuracy AND more RRAM rows/LUT demux throws (paper Fig. 9/13).
  * ``n_bits``                 — ASP system bit width; PowerGap (eq. (6))
    requires ``G * 2**LD <= 2**n`` with LD >= 0, checked by validity.
  * ``voltage_bits``           — the TM-DV N:1 split of the WL input
    generator (paper §3.2): more voltage bits -> fewer time slots (faster,
    less WL drive energy) but tighter DAC noise margins (sigma_v grows).
  * ``array_rows`` / ``adc_bits`` — ACIM macro geometry (cost model +
    partial-sum/IR-drop statistics both scale with rows).
  * ``use_sam``                — KAN-SAM sparsity-aware row placement on/off
    (paper §3.3): a free permutation that trades nothing in cost for a
    smaller IR-drop residual.

:class:`DesignSpace` is a plain axes->choices table with deterministic,
seedable sampling and one-axis neighborhood mutation — the proposal
machinery :func:`repro_torch.tune.search.pareto_search` iterates on.  The space
hash fingerprints the axes so a tuning artifact records exactly which space
produced it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ..core.asp_quant import ASPQuantSpec, max_ld
from ..core.cim import CIMConfig
from ..core.tmdv import TMDVConfig

__all__ = [
    "Candidate",
    "DesignSpace",
    "default_candidate",
    "candidate_from_dict",
    "space_hash",
]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One co-design operating point (hashable; the search's genotype).

    ``layer_bits`` is the mixed-precision axis (KANtize-style): one ASP bit
    width per layer, each independently PowerGap-checked against
    ``grid_size``; ``()`` means uniform ``n_bits``.  Layers at <= 4 bits
    deploy int4-packed (two weight codes per int8 lane) and are costed at
    the narrower cell footprint.
    """

    grid_size: int = 5
    order: int = 3
    n_bits: int = 8
    layer_bits: tuple = ()
    voltage_bits: int = 4
    array_rows: int = 128
    adc_bits: int = 8
    use_sam: bool = False

    def __post_init__(self):
        # JSON round trips (artifacts) hand lists back; keep it hashable
        if not isinstance(self.layer_bits, tuple):
            object.__setattr__(self, "layer_bits",
                               tuple(int(b) for b in self.layer_bits))

    def bits_for(self, n_layers: int) -> tuple:
        """Resolved per-layer widths (uniform ``n_bits`` when unset)."""
        if self.layer_bits:
            return self.layer_bits
        return (self.n_bits,) * n_layers

    def spec(self, lo: float = -1.0, hi: float = 1.0) -> ASPQuantSpec:
        """The ASP quantization grid this point deploys with."""
        return ASPQuantSpec(
            grid_size=self.grid_size, order=self.order, n_bits=self.n_bits,
            lut_bits=self.n_bits, lo=lo, hi=hi,
        )

    def input_gen(self, sigma_v_ref: float = 0.015,
                  sigma_t: float = 0.08) -> TMDVConfig:
        """The WL input-generator config (TM-DV split of ``n_bits``)."""
        return TMDVConfig(
            total_bits=self.n_bits, voltage_bits=self.voltage_bits,
            sigma_v_ref=sigma_v_ref, sigma_t=sigma_t,
        )

    def cim_config(self, ir_gamma: float = 0.06,
                   sigma_ps_ref: float = 0.05) -> CIMConfig:
        """The ACIM macro config at the given measured calibration."""
        return CIMConfig(
            array_rows=self.array_rows, adc_bits=self.adc_bits,
            ir_gamma=ir_gamma, sigma_ps_ref=sigma_ps_ref,
            input_gen=self.input_gen(),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def candidate_from_dict(d: dict) -> Candidate:
    fields = {f.name for f in dataclasses.fields(Candidate)}
    return Candidate(**{k: v for k, v in d.items() if k in fields})


def default_candidate() -> Candidate:
    """The repo's un-searched deployment defaults (KAN1 as shipped):
    G=5, K=3, 8-bit ASP, 4:4 TM-DV split, 128-row arrays, 8-bit ADC,
    no SAM.  The baseline the Pareto front is measured against."""
    return Candidate()


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Axes -> choices.  Every axis mirrors a :class:`Candidate` field."""

    grid_size: tuple = (3, 5, 8, 12)
    order: tuple = (3,)
    n_bits: tuple = (8,)
    # per-layer bit allocations (whole tuples are the choices); () = uniform.
    # NOTE: mixed allocations must be PowerGap-valid against the sampled
    # grid_size — ``sample``/``neighbors`` REJECT invalid combinations
    # (never clamp), so e.g. (4, 8) with grid_size 32 simply never appears.
    layer_bits: tuple = ((),)
    voltage_bits: tuple = (2, 3, 4, 5, 6)
    array_rows: tuple = (128, 256)
    adc_bits: tuple = (8,)
    use_sam: tuple = (False, True)

    def axes(self) -> dict:
        return {f.name: tuple(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def size(self) -> int:
        n = 1
        for choices in self.axes().values():
            n *= len(choices)
        return n

    # -- validity --------------------------------------------------------

    def is_valid(self, cand: Candidate) -> bool:
        """Structural validity (independent of space membership)."""
        if cand.order < 1 or cand.grid_size < 1:
            return False
        # every deployed width — mixed per-layer or the uniform n_bits —
        # must satisfy PowerGap: G * 2**LD <= 2**n with LD >= 0 (eq. (6)),
        # and the TM-DV split cannot exceed the narrowest layer's width
        widths = (cand.n_bits,) + tuple(cand.layer_bits)
        for b in widths:
            if b < 2 or b > 16 or max_ld(cand.grid_size, b) < 0:
                return False
        if cand.voltage_bits < 0 or cand.voltage_bits > min(widths):
            return False
        return True

    def contains(self, cand: Candidate) -> bool:
        return all(getattr(cand, name) in choices
                   for name, choices in self.axes().items())

    # -- deterministic proposals ----------------------------------------

    def sample(self, rng, n: int) -> list:
        """n valid random candidates (rejection sampling, seeded rng)."""
        out = []
        axes = self.axes()
        tries = 0
        while len(out) < n and tries < 64 * max(n, 1):
            tries += 1
            cand = Candidate(**{
                name: choices[int(rng.integers(len(choices)))]
                for name, choices in axes.items()
            })
            if self.is_valid(cand):
                out.append(cand)
        return out

    def neighbors(self, cand: Candidate, rng, n: int = 2) -> list:
        """Mutate ONE axis to an adjacent choice, n times (seeded rng)."""
        axes = [(name, choices) for name, choices in self.axes().items()
                if len(choices) > 1]
        out = []
        tries = 0
        while len(out) < n and axes and tries < 32 * max(n, 1):
            tries += 1
            name, choices = axes[int(rng.integers(len(axes)))]
            cur = getattr(cand, name)
            idx = choices.index(cur) if cur in choices \
                else int(rng.integers(len(choices)))
            step = 1 if rng.integers(2) else -1
            nxt = choices[max(0, min(len(choices) - 1, idx + step))]
            if nxt == cur:
                continue
            prop = dataclasses.replace(cand, **{name: nxt})
            if self.is_valid(prop):
                out.append(prop)
        return out


def space_hash(space: DesignSpace) -> str:
    """Stable fingerprint of the axes (recorded in tuning artifacts)."""
    blob = json.dumps(space.axes(), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
