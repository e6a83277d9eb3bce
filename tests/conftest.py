"""Shared test config: hypothesis fallback + the golden-parity harness.

Two roles:

  * makes ``hypothesis`` optional.  With ``hypothesis`` installed (see
    requirements-dev.txt) the property-based tests run as written; on a
    bare interpreter a small deterministic shim is registered under the
    ``hypothesis`` / ``hypothesis.strategies`` module names BEFORE the test
    modules import them — each ``@given`` test then runs a fixed number of
    cases from a per-test seeded RNG.  The shim implements only what this
    suite uses (``given``, ``settings``, ``strategies.integers``,
    ``strategies.sampled_from`` plus a few cheap extras).  Set
    ``HYPOTHESIS_SHIM_MAX_EXAMPLES`` to change the per-test case budget.

  * the shared **golden-parity harness**: one deployed KAN1 bundle per bit
    allocation with its expected output + boundary codes captured ONCE on
    the unsharded fused pipeline (``golden_parity`` fixture), plus the
    ``run_pair`` / ``assert_bit_exact`` helpers and the idempotent
    ``acim-quiet`` backend registration that test_runtime / test_kvpool /
    test_spec_decode / test_mixed_precision all share (import them with
    ``from conftest import ...``).  The serving suites also share one
    session-scoped qwen2.5-14b KAN-FFN param tree (``kan_setup``).
"""

from __future__ import annotations

import functools
import inspect
import os
import random
import sys
import types
import zlib

try:  # pragma: no cover - exercised in the hypothesis-installed CI leg
    import hypothesis  # noqa: F401

    HYPOTHESIS_IS_SHIM = False
except ImportError:
    HYPOTHESIS_IS_SHIM = True

    _DEFAULT_EXAMPLES = int(os.environ.get("HYPOTHESIS_SHIM_MAX_EXAMPLES", "6"))

    class _Strategy:
        """A deterministic sampler standing in for a hypothesis strategy."""

        def __init__(self, sample):
            self.sample = sample

        def map(self, f):
            return _Strategy(lambda rng: f(self.sample(rng)))

        def filter(self, pred, _tries: int = 100):
            def sample(rng):
                for _ in range(_tries):
                    v = self.sample(rng)
                    if pred(v):
                        return v
                raise ValueError("shim filter found no satisfying value")

            return _Strategy(sample)

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: elements[rng.randrange(len(elements))])

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rng: bool(rng.getrandbits(1)))

    def _lists(elem, min_size=0, max_size=8, **_kw):
        return _Strategy(
            lambda rng: [
                elem.sample(rng) for _ in range(rng.randint(min_size, max_size))
            ]
        )

    def _settings(max_examples=None, deadline=None, **_kw):
        def deco(fn):
            if max_examples is not None:
                fn._shim_max_examples = max_examples
            return fn

        return deco

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                declared = getattr(wrapper, "_shim_max_examples", None)
                n = _DEFAULT_EXAMPLES if declared is None \
                    else min(declared, _DEFAULT_EXAMPLES)
                # per-test deterministic seed: same name -> same cases
                rng = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for _ in range(max(n, 1)):
                    drawn = {k: s.sample(rng) for k, s in strategies.items()}
                    fn(*args, **drawn, **kwargs)

            # hide the drawn parameters from pytest's fixture resolution
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(
                parameters=[
                    p for name, p in sig.parameters.items()
                    if name not in strategies
                ]
            )
            return wrapper

        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.__doc__ = "Deterministic fallback shim (see tests/conftest.py)."
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.floats = _floats
    _st.booleans = _booleans
    _st.lists = _lists
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(
        too_slow=None, data_too_large=None, filter_too_much=None
    )
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# ----------------------------------------------------------------------------
# pytest config
# ----------------------------------------------------------------------------


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running suite (kept in CI; deselect locally with "
        '-m "not slow")',
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (PyTorch port kernels); skips without one",
    )


# ----------------------------------------------------------------------------
# golden-parity harness (shared by the runtime/serving/mixed-precision suites)
# ----------------------------------------------------------------------------

# the (backend, bits) grid the parity tests sweep; mesh cells are built per
# test from the host's device count.  8 = the uniform legacy deployment,
# (8, 4)/(4, 4) = mixed / fully sub-8-bit int4-packed allocations.
GOLDEN_BITS = (8, (8, 4), (4, 4))
GOLDEN_BACKENDS = ("ref", "pallas", "acim-quiet")


def ensure_quiet_acim_backend() -> str:
    """Idempotently register the zero-noise acim executor as "acim-quiet".

    Quiet acim traces the same program as "pallas" (every non-ideality
    zeroed and compiled out), so its streams take part in every
    bit-identity acceptance.  Returns the backend name.
    """
    from repro import runtime
    from repro.runtime.executor import ACIMExecutor

    if "acim-quiet" not in runtime.available_backends():
        runtime.register_executor(
            "acim-quiet", ACIMExecutor(cim=runtime.quiet_cim_config())
        )
    return "acim-quiet"


def kan1_bundle(n_bits=8, batch=8, seed=0, grid=5):
    """Deploy the paper's KAN1 geometry at a (possibly mixed) bit allocation.

    Returns (kspec, qparams, dep).  ``n_bits`` may be an int or a per-layer
    tuple; layers at <= 4 bits deploy int4-packed.
    """
    import jax as _jax

    from repro.core.kan_layer import KANSpec, init_kan_network
    from repro.core.kan_network_deploy import (
        deploy_kan_network,
        quantize_kan_network,
    )

    kspec = KANSpec(dims=(17, 1, 14), grid_size=grid, n_bits=n_bits)
    key = _jax.random.PRNGKey(seed)
    qparams = quantize_kan_network(init_kan_network(key, kspec), kspec)
    dep = deploy_kan_network(qparams, kspec, batch=batch)
    return kspec, qparams, dep


def run_pair(dep, x, mesh, backend="pallas", **kw):
    """(unsharded pallas, sharded ``backend``) outputs + boundary codes."""
    from repro.core.kan_network_deploy import kan_network_deploy_apply

    y0, c0 = kan_network_deploy_apply(
        dep, x, interpret=True, backend="pallas", return_intermediates=True
    )
    y1, c1 = kan_network_deploy_apply(
        dep, x, interpret=True, backend=backend, mesh=mesh,
        return_intermediates=True, **kw
    )
    return (y0, c0), (y1, c1)


def assert_bit_exact(a, b):
    """Both (y, codes) pairs agree bitwise — outputs AND boundary codes."""
    import numpy as np

    (y0, c0), (y1, c1) = a, b
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y0))
    assert len(c0) == len(c1)
    for x0, x1 in zip(c0, c1):
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x0))


import pytest  # noqa: E402  (after the shim install, by design)


@pytest.fixture(scope="session")
def kan_setup():
    """One qwen2.5-14b KAN-FFN smoke config + param tree for the serving
    suites (params are immutable jax arrays — safe to share)."""
    import jax as _jax

    from repro.configs.registry import smoke_config
    from repro.models.model import init_params

    cfg = smoke_config("qwen2.5-14b").kan_variant()
    return cfg, init_params(_jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="session")
def golden_parity():
    """The golden-parity table: bits -> one deployed bundle + its expected
    output and boundary codes, captured once on the unsharded fused
    pipeline.  Every (backend, mesh, bits) parity cell replays against
    THESE arrays, so any backend- or mesh-dependent divergence shows up as
    a bitwise diff against a single source of truth.
    """
    import jax as _jax
    import numpy as np

    from repro.core.kan_network_deploy import kan_network_deploy_apply

    table = {}
    for bits in GOLDEN_BITS:
        kspec, qparams, dep = kan1_bundle(n_bits=bits, batch=16)
        x = _jax.random.uniform(_jax.random.PRNGKey(3), (13, 17),
                                minval=-1.0, maxval=1.0)
        y, codes = kan_network_deploy_apply(
            dep, x, interpret=True, backend="pallas",
            return_intermediates=True,
        )
        table[bits] = {
            "kspec": kspec,
            "qparams": qparams,
            "dep": dep,
            "x": x,
            "y": np.asarray(y),
            "codes": tuple(np.asarray(c) for c in codes),
        }
    return table
