"""Deployment of whole quantized KAN networks: quantize + bind for the runtime.

Port of ``repro.core.kan_network_deploy``: post-training-quantize a stack,
dequantize and zero-pad (or int4-pack) the weights to the batch-independent
pipeline geometry on a device, and hand the resulting :class:`DeployedKAN`
to :mod:`repro_torch.runtime`, which owns backend selection and bucketing.

    qparams_list = quantize_kan_network(params_list, kspec)
    dep = deploy_kan_network(qparams_list, kspec, batch=B)   # on the card
    y = kan_network_deploy_apply(dep, x)                     # "fused"

Mesh placement waits for the mesh slice.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import runtime
from ..device import resolve_device
from ..kernels.kan_spline.pipeline import (
    PipelinePlan,
    pack_layer_weights,
    pack_lut,
    packs_lut,
    packs_weights,
    pad_layer_weights,
)
from .asp_quant import ASPQuantSpec, quantize_input
from .kan_layer import KANSpec, quantize_kan_layer

__all__ = [
    "DeployedKAN",
    "quantize_kan_network",
    "deploy_kan_network",
    "deploy_kan_ffn_stack",
    "kan_network_deploy_apply",
    "kan_network_apply_ref",
]


@dataclasses.dataclass
class DeployedKAN:
    """A quantized KAN stack bound to a pipeline geometry plan.

    layers: per-layer weight dicts padded to the plan, on one device:
    {"lut", "wc", "wb"} f32 for 8-bit layers, or the int4-packed
    {"lut"[, "lutp"], "wcp", "wscale", "wb"} form for <=4-bit layers.
    specs/dims describe the logical network.
    """

    plan: PipelinePlan
    layers: tuple
    specs: tuple
    dims: tuple
    residual_raw: bool = False

    @property
    def device(self) -> torch.device:
        return self.layers[0]["wb"].device

    def replan(self, batch: int) -> "DeployedKAN":
        """Rebind to a new batch size: a plan-cache lookup, not a rebuild
        (weights and padding are batch-agnostic)."""
        if batch == self.plan.b:
            return self
        plan = runtime.PLAN_CACHE.plan(
            batch, self.dims, self.specs, residual_raw=self.residual_raw
        )
        return dataclasses.replace(self, plan=plan)


def quantize_kan_network(params_list, kspec: KANSpec) -> list:
    """Post-training-quantize every layer of a stack at its own spec."""
    return [quantize_kan_layer(p, spec)
            for p, spec in zip(params_list, kspec.layer_specs())]


def _dequant_layer(qp: dict) -> tuple:
    wc = qp["c_q"].to(torch.float32) * qp["c_scale"]
    wb = qp["w_b_q"].to(torch.float32) * qp["w_b_scale"]
    return wc, wb


def deploy_kan_network(qparams_list, kspec: KANSpec, *, batch: int = 8,
                       device=None) -> DeployedKAN:
    """Bind a quantized KAN stack to a pipeline plan on ``device`` (the
    card unless ``device="cpu"``)."""
    return _deploy(qparams_list, tuple(kspec.dims), kspec.layer_specs(),
                   batch, residual_raw=False, device=device)


def deploy_kan_ffn_stack(qparams_list, dims: tuple, spec, *, batch: int = 8,
                         device=None) -> DeployedKAN:
    """Bind a KANLinear chain with the raw-input ReLU branch (FFN contract).

    ``spec``: one ASPQuantSpec for every layer, or a per-layer sequence.
    """
    if isinstance(spec, ASPQuantSpec):
        specs = tuple(spec for _ in qparams_list)
    else:
        specs = tuple(spec)
    return _deploy(qparams_list, tuple(dims), specs, batch,
                   residual_raw=True, device=device)


def _deploy(qparams_list, dims, specs, batch, *, residual_raw,
            device) -> DeployedKAN:
    if len(dims) != len(qparams_list) + 1:
        raise ValueError(f"dims {dims} vs {len(qparams_list)} layers")
    dev = resolve_device(device)
    plan = runtime.PLAN_CACHE.plan(batch, dims, specs,
                                   residual_raw=residual_raw)
    layers = []
    for qp, lp in zip(qparams_list, plan.layers):
        if tuple(qp["c_q"].shape) != (lp.f, lp.spec.num_basis, lp.o):
            raise ValueError(
                f"layer weights {tuple(qp['c_q'].shape)} != plan {lp}")
        qp = {k: v.to(dev) for k, v in qp.items()}
        wb = qp["w_b_q"].to(torch.float32) * qp["w_b_scale"]
        if packs_weights(lp.spec):
            # <=4-bit layer: keep the weight CODES, two per int8 lane
            layer = {
                "lut": qp["lut"],
                **pack_layer_weights(qp["c_q"], qp["c_scale"], wb, lp),
            }
            if packs_lut(lp.spec):
                layer["lutp"] = pack_lut(qp["lut_q"], lp.spec)
        else:
            wc, _ = _dequant_layer(qp)
            layer = {"lut": qp["lut"], **pad_layer_weights(wc, wb, lp)}
        layers.append(layer)
    return DeployedKAN(plan=plan, layers=tuple(layers), specs=specs,
                       dims=dims, residual_raw=residual_raw)


def kan_network_deploy_apply(dep: DeployedKAN, x, *, xraw=None,
                             backend: str | None = None, generator=None,
                             cim=None, sam_perms=None,
                             return_intermediates: bool = False):
    """Run float input x (B, F0) through the runtime-resolved backend
    (explicit > scope > ``REPRO_KAN_BACKEND`` > "fused").

    ``generator`` / ``cim`` / ``sam_perms`` only matter for the acim
    backend (``sam_perms``: per-layer KAN-SAM row placements)."""
    return runtime.execute(
        dep, x, backend=backend, default="fused", xraw=xraw,
        generator=generator, cim=cim, sam_perms=sam_perms,
        return_intermediates=return_intermediates,
    )


def kan_network_apply_ref(qparams_list, x: torch.Tensor, kspec: KANSpec):
    """The layered reference over the un-padded quantized weights, on the
    device of ``x`` and the qparams."""
    specs = kspec.layer_specs()
    logical = []
    for qp in qparams_list:
        wc, wb = _dequant_layer(qp)
        logical.append((qp["lut"], wc, wb))
    codes = quantize_input(x, specs[0])
    return runtime.ref_composition(logical, specs, codes, None,
                                   residual_raw=False)
