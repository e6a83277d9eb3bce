"""KAN-NeuroSim: hyperparameter optimization framework (paper §3.4, Fig. 9).

Port of ``repro.core.neurosim``.  Two steps:

  * **Step 1**: constraint loop.  Given hardware constraints (area, energy,
    latency) and KAN hyperparameters (dims, K, G, input method), evaluate
    the accelerator cost model (``costmodel.py``) and keep the largest G
    whose accelerator satisfies them.
  * **Step 2**: grid extension training.  Train for N epochs; while the
    validation loss keeps falling and the extended grid (G + E) still
    satisfies the constraints, extend the grid
    (``kan_layer.extend_layer_grid``) and continue; otherwise revert to the
    previous G and stop.

RRAM non-idealities (partial-sum error, IR-drop; ``cim.py``) are applied in
the evaluation path :func:`evaluate_accuracy_cim`, which runs on the plain
simulator ``cim_matmul`` as the reference's does.

Training runs ``torch.autograd`` through the float path
(``kan_layer.kan_network_apply``: Cox-de Boor basis, matmuls, tanh) with
the port's AdamW.  The epoch permutations come from an explicit
``torch.Generator``: Threefry and Philox draw different orders, so the two
packages never share a trained network through a seed, only through numpy
(``repro_torch.convert.params_from_numpy``).  A training step is
deterministic on the card as on the CPU: its ops are elementwise maps,
cuBLAS matmuls at fixed shapes on one stream, PyTorch's reductions (which
use no atomics), ``log_softmax``, and a gather of one label per row whose
backward scatters to distinct positions, so no sum depends on the order in
which atomics land.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..train.optimizer import adamw, apply_updates
from .asp_quant import (
    ASPQuantSpec,
    dense_basis_from_codes,
    f32,
    quantize_input,
    resolve_layer_bits,
)
from .cim import CIMConfig, cim_matmul
from .costmodel import accelerator_cost, kan_accelerator
from .kan_layer import (
    KANSpec,
    extend_layer_grid,
    init_kan_network,
    kan_network_apply,
    quantize_kan_layer,
)
from .sam import row_activation_weight, sam_permutation
from .tmdv import TMDVConfig

__all__ = [
    "HardwareConstraints",
    "check_constraints",
    "kan_cost",
    "search_max_grid",
    "train_kan",
    "evaluate_accuracy",
    "cim_network_apply",
    "evaluate_accuracy_cim",
    "grid_extension_train",
]


@dataclasses.dataclass(frozen=True)
class HardwareConstraints:
    max_area_mm2: float = float("inf")
    max_energy_pj: float = float("inf")
    max_latency_ns: float = float("inf")


def kan_cost(dims, grid_size, order, n_bits, input_gen, array_rows=128,
             adc_bits=8, layer_bits=()) -> dict:
    """Accelerator cost of one KAN hyperparameter point (area/energy/latency).

    The single cost hook shared by the step-1 constraint loop here and the
    Pareto search in ``repro_torch.tune.search``.  Raises ``ValueError``
    when G does not fit the bit budget (eq. (6)), for the uniform
    ``n_bits`` and for every width in a mixed-precision ``layer_bits``
    allocation alike.  ``layer_bits`` scales each layer's cell area/energy
    by its weight width (int4-packed layers cost half the 8-bit cell
    footprint).
    """
    spec = ASPQuantSpec(grid_size=grid_size, order=order, n_bits=n_bits,
                        lut_bits=n_bits, lo=-1.0, hi=1.0)
    if layer_bits:
        # per-layer PowerGap validation (raises ValueError, never clamps)
        resolve_layer_bits(layer_bits, len(dims) - 1, grid_size)
    acc = kan_accelerator(dims, spec, input_gen, array_rows, adc_bits,
                          layer_bits=tuple(layer_bits))
    return accelerator_cost(acc)


_cost_for = kan_cost  # internal alias kept for the step-2 loop below


def check_constraints(cost: dict, hc: HardwareConstraints) -> bool:
    return (
        cost["area_mm2"] <= hc.max_area_mm2
        and cost["energy_pj"] <= hc.max_energy_pj
        and cost["latency_ns"] <= hc.max_latency_ns
    )


def search_max_grid(
    dims,
    hc: HardwareConstraints,
    order: int = 3,
    n_bits: int = 8,
    input_gen: TMDVConfig | None = None,
    array_rows: int = 128,
    adc_bits: int = 8,
    g_candidates=None,
) -> tuple:
    """Step 1: largest G whose accelerator satisfies the constraints.

    Returns (best_G, cost dict) or (None, None) if even the smallest fails.
    """
    if input_gen is None:
        input_gen = TMDVConfig(total_bits=n_bits, voltage_bits=n_bits // 2)
    if g_candidates is None:
        g_candidates = [g for g in range(1, 2**n_bits)
                        if ASPQuantSpec(g, order, n_bits).ld >= 0]
    best = (None, None)
    for g in sorted(g_candidates):
        try:
            cost = _cost_for(dims, g, order, n_bits, input_gen, array_rows,
                             adc_bits)
        except ValueError:
            continue
        if check_constraints(cost, hc):
            best = (g, cost)
    return best


# ----------------------------------------------------------------------------
# Training / evaluation on a classification task (knot theory)
# ----------------------------------------------------------------------------


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)


def _loss_fn(params, x, y, kspec):
    """Mean negative log-likelihood of labels ``y`` under the float KAN."""
    logits = kan_network_apply(params, x, kspec)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y[:, None].to(torch.int64)).mean()


def train_kan(
    kspec: KANSpec,
    x_train,
    y_train,
    x_val,
    y_val,
    epochs: int = 200,
    batch_size: int = 1024,
    lr: float = 3e-3,
    seed: int = 0,
    params=None,
    verbose: bool = False,
    *,
    generator: torch.Generator | None = None,
    permutations=None,
    device=None,
):
    """Mini-batch AdamW training of a KAN stack; returns (params, history).

    Runs on ``device`` (the card unless ``device="cpu"``; with ``params``
    given, on their device).  ``generator`` draws the initial parameters
    (when ``params`` is None) and then one permutation per epoch; None
    seeds one from ``seed`` on the device.  ``permutations``, one index
    order per epoch, replaces the drawn ones (the tests feed the
    reference's).  ``history`` holds the validation loss after each epoch.
    """
    if params is not None:
        dev = params[0]["c"].device
    else:
        dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_kan_network(generator, kspec, device=dev)
    params = [{k: v.detach().to(torch.float32) for k, v in p.items()}
              for p in params]
    opt = adamw(lr, weight_decay=1e-4)
    opt_state = opt.init(params)

    x_train = _as_tensor(x_train, dev, torch.float32)
    y_train = _as_tensor(y_train, dev, torch.int64)
    x_val = _as_tensor(x_val, dev, torch.float32)
    y_val = _as_tensor(y_val, dev, torch.int64)
    n = x_train.shape[0]
    steps = max(1, n // batch_size)

    def step(params, opt_state, xb, yb):
        leaves = [p.requires_grad_(True) for lp in params for p in lp.values()]
        loss = _loss_fn(params, xb, yb, kspec)
        grads_flat = torch.autograd.grad(loss, leaves)
        it = iter(grads_flat)
        grads = [{k: next(it) for k in lp} for lp in params]
        with torch.no_grad():
            params = [{k: v.detach() for k, v in lp.items()} for lp in params]
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state

    history = []
    for ep in range(epochs):
        if permutations is not None:
            perm = _as_tensor(permutations[ep], dev, torch.int64)
        else:
            perm = torch.randperm(n, generator=generator, device=dev)
        for s in range(steps):
            idx = perm[s * batch_size: (s + 1) * batch_size]
            params, opt_state = step(params, opt_state, x_train[idx],
                                     y_train[idx])
        with torch.no_grad():
            history.append(float(_loss_fn(params, x_val, y_val, kspec)))
        if verbose and (ep % 25 == 0 or ep == epochs - 1):
            print(f"  epoch {ep}: val_loss {history[-1]:.4f}")
    return params, history


def _accuracy(logits: torch.Tensor, y, device) -> float:
    y = _as_tensor(y, device, torch.int64)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())


def evaluate_accuracy(params, x, y, kspec: KANSpec) -> float:
    dev = params[0]["c"].device
    with torch.no_grad():
        logits = kan_network_apply(params, _as_tensor(x, dev, torch.float32),
                                   kspec)
    return _accuracy(logits, y, dev)


def cim_network_apply(
    params,
    x,
    kspec: KANSpec,
    cim_cfg: CIMConfig,
    generator: torch.Generator | None = None,
    use_sam: bool = False,
    calib_x=None,
) -> torch.Tensor:
    """Logits of the quantized network with every spline matmul executed
    on the ACIM simulator (:func:`evaluate_accuracy_cim`'s forward pass).

    The spline matmul of every layer runs through ``cim_matmul`` with the
    layer's c' int8 rows as conductances and the dense basis as WL drives;
    KAN-SAM optionally permutes the physical rows by activation
    probability.  ``generator`` draws each layer's noise in turn (the
    reference splits its key once per layer); it may be None for a
    deterministic ``cim_cfg``.
    """
    dev = params[0]["c"].device
    spec = kspec.layer_spec()
    h = _as_tensor(x, dev, torch.float32)
    n_layers = len(params)
    with torch.no_grad():
        for li, p in enumerate(params):
            qp = quantize_kan_layer(p, spec)
            codes = quantize_input(h, spec)
            basis = dense_basis_from_codes(codes, qp["lut"], spec)  # (B, F, nb)
            bsz, f, nb = basis.shape
            # WL drives in code units (lut_bits full-scale); the divisor is
            # a device tensor, so CUDA divides (a Python scalar would be
            # applied as a reciprocal multiply)
            drives = basis.reshape(bsz, f * nb) / qp["lut_scale"]
            w_rows = qp["c_q"].to(torch.float32).reshape(f * nb, -1)
            perm = None
            if use_sam:
                cx = h if calib_x is None or li > 0 \
                    else _as_tensor(calib_x, dev, torch.float32)
                rw = row_activation_weight(cx if li == 0 else h, spec, f)
                perm = sam_permutation(rw, cim_cfg.array_rows)
            acc = cim_matmul(drives, w_rows, cim_cfg, generator, row_perm=perm,
                             x_max=float(2**spec.lut_bits - 1),
                             adc_calibrate=True)
            y_spline = acc * qp["lut_scale"] * qp["c_scale"][None, :]
            xq = torch.relu(f32(spec.lo)
                            + codes.to(torch.float32) * f32(spec.code_step))
            wb = qp["w_b_q"].to(torch.float32) * qp["w_b_scale"]
            h = y_spline + xq @ wb
            if li < n_layers - 1:
                h = torch.tanh(h) * (0.5 * (spec.hi - spec.lo)) \
                    + 0.5 * (spec.hi + spec.lo)
    return h


def evaluate_accuracy_cim(
    params,
    x,
    y,
    kspec: KANSpec,
    cim_cfg: CIMConfig,
    generator: torch.Generator | None = None,
    use_sam: bool = False,
    calib_x=None,
) -> float:
    """Accuracy with the quantized spline path executed on the ACIM
    simulator (:func:`cim_network_apply`)."""
    h = cim_network_apply(params, x, kspec, cim_cfg, generator,
                          use_sam=use_sam, calib_x=calib_x)
    return _accuracy(h, y, h.device)


# ----------------------------------------------------------------------------
# Step 2: grid-extension training under constraints
# ----------------------------------------------------------------------------


def grid_extension_train(
    dims,
    hc: HardwareConstraints,
    x_train,
    y_train,
    x_val,
    y_val,
    g_init: int = 3,
    extend_by: int = 2,
    epochs_per_round: int = 60,
    max_rounds: int = 8,
    order: int = 3,
    n_bits: int = 8,
    input_gen: TMDVConfig | None = None,
    array_rows: int = 128,
    adc_bits: int = 8,
    seed: int = 0,
    verbose: bool = False,
    *,
    device=None,
):
    """Paper Fig. 9 step 2.  Returns dict with final params/G/cost/history."""
    if input_gen is None:
        input_gen = TMDVConfig(total_bits=n_bits, voltage_bits=n_bits // 2)

    g = g_init
    kspec = KANSpec(dims=tuple(dims), grid_size=g, order=order, n_bits=n_bits,
                    lut_bits=n_bits)
    params, hist = train_kan(kspec, x_train, y_train, x_val, y_val,
                             epochs=epochs_per_round, seed=seed,
                             verbose=verbose, device=device)
    best_val = hist[-1]
    log = [{"G": g, "val_loss": best_val}]

    for _ in range(max_rounds):
        g_next = g + extend_by
        try:
            cost_next = _cost_for(dims, g_next, order, n_bits, input_gen,
                                  array_rows, adc_bits)
        except ValueError:
            break  # G*2^LD no longer fits in n bits
        if not check_constraints(cost_next, hc):
            break  # hardware budget exceeded -> keep G_pre
        params_pre, kspec_pre = params, kspec  # "1. G_pre = G"
        spec = kspec.layer_spec()
        params = [extend_layer_grid(p, spec, g_next) for p in params]
        kspec = dataclasses.replace(kspec, grid_size=g_next)
        params, hist = train_kan(kspec, x_train, y_train, x_val, y_val,
                                 epochs=epochs_per_round, seed=seed,
                                 params=params, verbose=verbose)
        log.append({"G": g_next, "val_loss": hist[-1]})
        if hist[-1] >= best_val:  # val loss stopped decreasing: "2. G = G_pre"
            params, kspec = params_pre, kspec_pre
            break
        best_val = hist[-1]
        g = g_next

    cost = _cost_for(dims, g, order, n_bits, input_gen, array_rows, adc_bits)
    return {
        "params": params,
        "kspec": kspec,
        "G": g,
        "cost": cost,
        "log": log,
    }
