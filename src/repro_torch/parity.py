"""The parity gate between two runs of one deployed bundle on one input.

Two runs (the port against the JAX reference, or the fused kernel against
the ``ref`` backend on the card) sum in different orders and use different
``tanh`` implementations, so their f32 outputs differ by a few ulps.  A
boundary code then moves by one wherever the requantizer's pre-round value
``(h - lo) * scale + 0.5`` lies at an integer.  The gate:

  * boundary codes are equal except at positions whose REFERENCE pre-round
    value lies within ``eps`` of an integer, and there they differ by one;
    such positions are counted as excused;
  * a row with an excused flip feeds different codes to every later layer,
    so its later codes and its output are left out of the comparison (and
    counted);
  * every other output agrees within ``atol + rtol * |want|``.

The reference's pre-round values are recomputed from the reference's own
boundary codes with one layer of :func:`runtime.ref_composition` at a time,
in float64 from there on; that is within ~1e-5 of the reference's own value,
well inside ``eps``.  A deterministic acim run (IR-drop gains, no noise)
takes its pre-round values from :func:`irdrop_bundle`, the bundle with the
gained weights that run uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.kan_spline.pipeline import gained_layer
from .runtime.executor import _irdrop_row_gain, _logical_layer, ref_composition

__all__ = ["entry_preround", "requant_preround", "boundary_prerounds",
           "irdrop_bundle", "compare_runs"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _preround(h: np.ndarray, spec) -> np.ndarray:
    return (h - spec.lo) * (1.0 / spec.code_step) + 0.5


def requant_preround(y, nxt) -> np.ndarray:
    """Pre-round values of the boundary requantizer that codes layer output
    ``y`` onto the next layer's grid ``nxt``, in float64."""
    h = np.tanh(_np(y).astype(np.float64)) * (0.5 * (nxt.hi - nxt.lo)) \
        + 0.5 * (nxt.hi + nxt.lo)
    return _preround(h, nxt)


def entry_preround(dep, x) -> np.ndarray:
    """Pre-round values of the entry quantizer (tanh first for FFN stacks)."""
    v = _np(x).astype(np.float64)
    return _preround(np.tanh(v) if dep.residual_raw else v, dep.specs[0])


def boundary_prerounds(dep, entry_codes, xraw, boundary_codes) -> list:
    """Pre-round values of each boundary requantizer, layer by layer from
    the given (reference) codes; logical shapes, float64."""
    codes = entry_codes
    out = []
    for li, (lp, lw) in enumerate(zip(dep.plan.layers, dep.layers)):
        if not lp.emit_codes:
            break
        y = ref_composition([_logical_layer(lw, lp)], (lp.spec,), codes, xraw,
                            residual_raw=lp.residual_raw)
        out.append(requant_preround(y, lp.next_spec))
        codes, xraw = boundary_codes[li], y
    return out


def irdrop_bundle(dep, cfg, sam_perms=None):
    """``dep`` with each layer's weights times its IR-drop row gains under
    ``cfg`` (and the per-layer KAN-SAM placements ``sam_perms``), as the
    acim executor forms them: the bundle whose fused run is that
    executor's deterministic run, and whose pre-round values gate it."""
    layers = []
    for li, (lp, lw) in enumerate(zip(dep.plan.layers, dep.layers)):
        gain = _irdrop_row_gain(
            lp, cfg, None if sam_perms is None else sam_perms[li])
        layers.append(gained_layer(
            lw, lp, None if gain is None else torch.from_numpy(gain)
            .to(dep.device)))
    return dataclasses.replace(dep, layers=tuple(layers))


def compare_runs(got_codes, want_codes, prerounds, got_y, want_y, *,
                 atol: float = 1e-5, rtol: float = 1e-5,
                 eps: float = 1e-4) -> dict:
    """Hold one run against a reference run (see the module docstring).

    ``*_codes``: per boundary, in order (entry codes first when the two
    runs quantized the input independently); ``prerounds``: the reference's
    pre-round values for the same boundaries.  Raises AssertionError on a
    mismatch the gate does not excuse; returns
    ``{"excused", "rows_left_out", "rows", "max_abs_err"}``.
    """
    want_y = _np(want_y).astype(np.float64)
    got_y = _np(got_y).astype(np.float64)
    rows = want_y.shape[0]
    tainted = np.zeros(rows, bool)
    excused = 0
    for li, (g, w, pre) in enumerate(zip(got_codes, want_codes, prerounds)):
        g, w = _np(g).astype(np.int64), _np(w).astype(np.int64)
        diff = (g != w) & ~tainted[:, None]
        near = np.abs(pre - np.round(pre)) < eps
        ok = near & (np.abs(g - w) == 1)
        bad = diff & ~ok
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise AssertionError(
                f"boundary {li}: {int(bad.sum())} code mismatches outside "
                f"the excused ties, first at ({r}, {c}): got {g[r, c]} want "
                f"{w[r, c]} pre-round {pre[r, c]:.6f}"
            )
        excused += int(diff.sum())
        tainted |= diff.any(axis=1)
    keep = ~tainted
    err = np.abs(got_y[keep] - want_y[keep])
    lim = atol + rtol * np.abs(want_y[keep])
    if (err > lim).any():
        i = np.unravel_index(np.argmax(err - lim), err.shape)
        raise AssertionError(
            f"output mismatch beyond atol={atol} rtol={rtol}: max err "
            f"{err.max():.3e} at kept row/col {i}"
        )
    return {
        "excused": excused,
        "rows_left_out": int(tainted.sum()),
        "rows": rows,
        "max_abs_err": float(err.max()) if err.size else 0.0,
    }
