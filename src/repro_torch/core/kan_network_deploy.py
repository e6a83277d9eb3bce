"""Deployment of whole quantized KAN networks: quantize + bind for the runtime.

Port of ``repro.core.kan_network_deploy``: post-training-quantize a stack,
dequantize and zero-pad (or int4-pack) the weights to the batch-independent
pipeline geometry on a device, and hand the resulting :class:`DeployedKAN`
to :mod:`repro_torch.runtime`, which owns backend selection and bucketing.

    qparams_list = quantize_kan_network(params_list, kspec)
    dep = deploy_kan_network(qparams_list, kspec, batch=B)   # on the card
    y = kan_network_deploy_apply(dep, x)                     # "fused"
    placed = place_deployed_kan(dep, mesh)                   # a DeviceMesh
    y = kan_network_deploy_apply(placed, x)                  # sharded

Placement keeps each rank's column slab as a plain local tensor, with the
per-leaf specs recorded in ``DeployedKAN.shard_specs``, and not as a
``DTensor``: kernel B1 takes raw device pointers of contiguous tensors, so
a ``DTensor`` would be unwrapped (``to_local()``) on every call, and the
runtime's shard body already knows each rank's coordinates.  The global
bundle comes back with ``dist.compress`` (an all-gather over ``"model"``).
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
    "place_deployed_kan",
    "kan_network_deploy_apply",
    "kan_network_apply_ref",
]


@dataclasses.dataclass
class DeployedKAN:
    """A quantized KAN stack bound to a pipeline geometry plan.

    layers: per-layer weight dicts padded to the plan, on one device:
    {"lut", "wc", "wb"} f32 for 8-bit layers, or the int4-packed
    {"lut"[, "lutp"], "wcp", "wscale", "wb"} form for <=4-bit layers.
    specs/dims describe the logical network.  ``placement``: the mesh the
    weights were placed on with :func:`place_deployed_kan` (or None); each
    sharded leaf then holds this rank's column slab, and ``shard_specs``
    the per-layer ``dist.sharding.PSpec`` dicts it was placed by.  The
    runtime resolves the placement as its lowest-precedence mesh, and
    ``replan`` keeps it.
    """

    plan: PipelinePlan
    layers: tuple
    specs: tuple
    dims: tuple
    residual_raw: bool = False
    placement: object = None
    shard_specs: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.layers[0]["wb"].device

    def replan(self, batch: int) -> "DeployedKAN":
        """Rebind to a new batch size: a plan-cache lookup, not a rebuild
        (weights and padding are batch-agnostic); the placement stays."""
        if batch == self.plan.b:
            return self
        plan = runtime.PLAN_CACHE.plan(
            batch, self.dims, self.specs, residual_raw=self.residual_raw
        )
        return dataclasses.replace(self, plan=plan)


def place_deployed_kan(dep: DeployedKAN, mesh) -> DeployedKAN:
    """Keep this rank's slabs of a bundle's weights and record the mesh.

    Each leaf follows ``dist.sharding.deployed_kan_pspecs`` (output columns
    on "model" where the layer shards, the SH-LUT whole): a sharded leaf
    becomes its contiguous column slab for this rank's model index.  The
    result carries ``placement=mesh``, which the runtime picks up as its
    default mesh.  ``dep`` must be unplaced (global weights)."""
    from ..dist.sharding import deployed_kan_pspecs
    from ..runtime.meshexec import mesh_axis_sizes, mesh_index

    if dep.placement is not None:
        raise ValueError("bundle is already placed; gather it first "
                         "(dist.compress) to place it on another mesh")
    specs = deployed_kan_pspecs(dep, mesh)
    _, msize = mesh_axis_sizes(mesh)
    mi = mesh_index(mesh, "model")
    layers = []
    for lw, lspec in zip(dep.layers, specs):
        out = {}
        for k, a in lw.items():
            if "model" in lspec[k]:
                w = a.shape[-1] // msize
                a = a[..., mi * w:(mi + 1) * w].contiguous()
            out[k] = a
        layers.append(out)
    return dataclasses.replace(dep, layers=tuple(layers), placement=mesh,
                               shard_specs=specs)


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
                             cim=None, sam_perms=None, mesh=None,
                             return_intermediates: bool = False):
    """Run float input x (B, F0) through the runtime-resolved backend
    (explicit > scope > ``REPRO_KAN_BACKEND`` > "fused"), on ``mesh``
    (explicit > ``runtime.use_mesh`` scope > ``dep.placement`` > none).

    ``generator`` / ``cim`` / ``sam_perms`` only matter for the acim
    backend (``sam_perms``: per-layer KAN-SAM row placements)."""
    return runtime.execute(
        dep, x, backend=backend, default="fused", xraw=xraw,
        generator=generator, cim=cim, sam_perms=sam_perms, mesh=mesh,
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
