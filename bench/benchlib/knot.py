"""Knot-invariant feature rows: 17 per row in [-1, 1].

A copy of the feature half of ``repro_torch/data/knot.py::
make_knot_dataset`` (the labels are not needed to score rows): the same
seed gives the same rows as its ``x``.  The benchmark keeps its own copy
so that the program cannot change the traffic it is measured on.
"""

from __future__ import annotations

import numpy as np

NUM_FEATURES = 17


def knot_features(n: int, seed: int) -> np.ndarray:
    """(n, 17) float32 rows: bell-shaped invariants truncated to the KAN
    domain, as ``make_knot_dataset(n_train=n, n_test=0, seed)[0]``."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0.0, 0.45, size=(n, NUM_FEATURES)), -1.0, 1.0)
    return x.astype(np.float32)
