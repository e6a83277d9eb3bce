"""Request sizes of a mix: one fixed sequence per mix.

A mix draws ``sequence`` sizes from its distribution with its own
``sizes_seed``, and every run serves them in that order, cycling; the
run's ``--seed`` draws only contents and weights.  So every seed does the
same work.  (With the order permuted by the run's seed, the rag cell's
TTFT p95 on an H100 split into two modes, 214 and 255 ms, by which long prompts
queued behind each other, while one seed repeated within 2%.)
"""

from __future__ import annotations

import numpy as np

SEED_MOD = 1 << 64


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator for a run seed of any size (negative too)."""
    return np.random.default_rng([seed % SEED_MOD, *salt])


def draw(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` whole sizes from ``{"dist": "lognormal", "median", "sigma",
    "min", "max"}`` or ``{"dist": "uniform", "min", "max"}`` (inclusive),
    clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * gen.standard_normal(n))
        x = np.rint(x)
    elif spec["dist"] == "uniform":
        x = gen.integers(lo, hi + 1, n)
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def fixed_sizes(spec: dict, mix: dict, salt: int) -> np.ndarray:
    """The mix's sequence of sizes for one size ``spec`` (``salt`` keeps
    two specs of one mix apart)."""
    return draw(spec, int(mix["sequence"]), rng(int(mix["sizes_seed"]), salt))


def fixed_shares(mix: dict, n: int) -> np.ndarray:
    """``n`` fixed uniform shares in (0, 1] of the mix (the first
    requests' part of their length under a ``"residual"`` stagger)."""
    return 1.0 - rng(int(mix["sizes_seed"]), 9).uniform(0.0, 1.0, n)


def prompt_tokens(seed: int, q: int, n: int, vocab: int,
                  salt: int = 3) -> list:
    """Request ``q``'s ``n`` prompt tokens, uniform over ``[3, vocab)``
    (above the special ids), from the run's seed."""
    return rng(seed, salt, q).integers(3, vocab, n).tolist()
