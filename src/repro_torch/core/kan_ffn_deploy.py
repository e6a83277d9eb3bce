"""Deployment of the LM's KAN-FFN blocks: ASP-quantize + the fused executor.

Port of ``repro.core.kan_ffn_deploy``.  A KAN-FFN block
(``models.layers.init_ffn`` with ``ffn_kind="kan"``) is post-training-
quantized with ASP-KAN-HAQ (int8 c', shared SH-LUT) and executed through
the runtime's fused backend: kernel B1 once per KANLinear half, with the
inter-half boundary (tanh -> ASP re-coding) fused into the first half's
kernel, so the hidden activation crosses as int32 codes (plus the raw f32
copy the second half's ReLU branch contracts against).

    qffn = quantize_kan_ffn(ffn_params, cfg)
    y = kan_ffn_apply_quantized(qffn, x, cfg)

Deploy once, not per call.  The reference's ``kan_ffn_apply_quantized``
deploys the stack (dequantize + pad the weights) on every call; under
``jit`` that is folded or fused, but run eagerly at full width it would
re-dequantize and re-pad about 0.63 GB per layer per decode step.  So
:func:`quantize_kan_ffn_params_tree` also builds each layer's
:class:`~repro_torch.core.kan_network_deploy.DeployedKAN` once (key
``"deployed"`` of the block), and :func:`kan_ffn_apply_quantized` only
rebinds it to the call's batch with ``replan`` (a plan-cache lookup).  A
block without ``"deployed"`` (e.g. a converted reference tree) is refused:
give it its bundles with :func:`deploy_kan_ffn_params_tree` first.

A routed MoE layer with KAN experts (``models.layers.routed_moe`` of a
``routed_moe`` config's ``kan_variant()``) is quantized and deployed here
too: each routed expert as its own KAN-FFN (its own weight scales and
SH-LUT), their deployed layers stacked on a leading expert axis (:class:`GroupedKAN`),
and the shared experts as one KAN-FFN bundle (:class:`DeployedKANMoE`).
:func:`kan_moe_apply_quantized` routes a step's tokens, codes each token
once, gathers the codes into expert order and runs every routed expert
with one grouped B1 launch per half (``pipeline.
run_pipeline_layer_grouped``), under the ranges ``model.moe.route``,
``model.moe.experts`` and ``model.moe.shared``.  Its counters, exported as
``moe.rows{kind=routed|shared}``, ``moe.busiest_rows`` and
``moe.grouped_launches``: the rows it routed (tokens times k) and ran
through the shared experts, the rows of each call's busiest expert
summed (accumulated on the device, read when the registry is), and the
grouped launches.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from .. import runtime
from ..configs.base import ModelConfig
from ..kernels.kan_spline.pipeline import (
    PipelinePlan,
    kan_pipeline_impl,
    run_pipeline_layer_grouped,
)
from ..obs import REGISTRY as _OBS_REGISTRY
from ..obs.metrics import setup_phase
from ..obs.trace import profile_scope
from .asp_quant import quantize_input
from .kan_layer import quantize_kan_layer
from .kan_network_deploy import (
    DeployedKAN,
    deploy_kan_ffn_stack,
    kan_network_deploy_apply,
)

__all__ = [
    "quantize_kan_ffn",
    "deploy_kan_ffn",
    "kan_ffn_apply_quantized",
    "quantize_kan_ffn_params_tree",
    "deploy_kan_ffn_params_tree",
    "GroupedKAN",
    "DeployedKANMoE",
    "deploy_kan_moe",
    "kan_moe_apply_quantized",
    "MOE_COUNTS",
]

# host counters of the routed KAN layers (see the module note)
MOE_COUNTS: collections.Counter = collections.Counter()
# the busiest expert's rows of every routed call, summed on each device
_BUSIEST: dict = {}


def _moe_collect() -> dict:
    busiest = sum(int(t.item()) for t in _BUSIEST.values())
    return {("moe.rows", (("kind", "routed"),)): MOE_COUNTS["routed"],
            ("moe.rows", (("kind", "shared"),)): MOE_COUNTS["shared"],
            "moe.busiest_rows": busiest,
            "moe.grouped_launches": MOE_COUNTS["grouped_launches"]}


_OBS_REGISTRY.register_collector(_moe_collect)


def quantize_kan_ffn(ffn_params: dict, cfg: ModelConfig) -> dict:
    """Quantize both KANLinear halves of a KAN-FFN block.

    ffn_params: {"c1","wb1","c2","wb2"}.  Returns {"l1": qparams, "l2":
    qparams} (see ``kan_layer.quantize_kan_layer``), on the params' device.
    Host seconds count as ``setup.seconds{phase=quantize}``.
    """
    from ..models.layers import kan_ffn_specs

    s1, s2 = kan_ffn_specs(cfg)
    with setup_phase("quantize"):
        l1 = quantize_kan_layer({"c": ffn_params["c1"],
                                 "w_b": ffn_params["wb1"]}, s1)
        l2 = quantize_kan_layer({"c": ffn_params["c2"],
                                 "w_b": ffn_params["wb2"]}, s2)
    return {"l1": l1, "l2": l2}


def deploy_kan_ffn(qffn: dict, cfg: ModelConfig, *, batch: int = 8):
    """Bind one quantized block (unstacked ``{"l1","l2"}``) to the fused
    executor's padded geometry on the weights' device."""
    from ..models.layers import kan_ffn_specs

    d, hidden = qffn["l1"]["c_q"].shape[0], qffn["l1"]["c_q"].shape[-1]
    return deploy_kan_ffn_stack([qffn["l1"], qffn["l2"]], (d, hidden, d),
                                kan_ffn_specs(cfg), batch=batch,
                                device=qffn["l1"]["c_q"].device)


def kan_ffn_apply_quantized(qffn: dict, x: torch.Tensor, cfg: ModelConfig,
                            backend: str | None = None) -> torch.Tensor:
    """Quantized KAN-FFN forward through the runtime-resolved executor.

    x: (B, S, D).  Each half squashes by tanh, ASP-quantizes and runs the
    SH-LUT band, with the ReLU branch on the RAW pre-squash input (as the
    float ``models.layers._kan_linear``).  ``backend=None`` resolves
    through ``repro_torch.runtime`` (scope > ``REPRO_KAN_BACKEND`` >
    "fused").  ``qffn`` is one layer's block with its ``"deployed"``
    bundle (see the module docstring); one without it raises."""
    b, s, d = x.shape
    if "deployed" not in qffn:
        raise ValueError(
            "quantized KAN-FFN block has no 'deployed' bundle; build it once "
            "with deploy_kan_ffn_params_tree (or quantize_kan_ffn_params_tree)")
    dep = qffn["deployed"].replan(b * s)
    x2 = x.reshape(b * s, d).to(torch.float32)
    y = kan_network_deploy_apply(dep, x2, backend=backend)
    return y.reshape(b, s, d).to(x.dtype)


@dataclasses.dataclass
class GroupedKAN:
    """E KAN-FFN stacks of one geometry, each quantized on its own, with
    their deployed layers stacked on a leading expert axis: per layer
    {"lut" (E, 2**LD, K+1), "wc" (E, Fp*NB, Op), "wb" (E, Fp, Op)}.
    ``plan`` gives the layers' padded geometry (its batch is unused: a
    grouped launch takes its rows from the segments)."""

    plan: PipelinePlan
    layers: tuple
    specs: tuple
    dims: tuple
    experts: int

    @property
    def device(self) -> torch.device:
        return self.layers[0]["wb"].device


@dataclasses.dataclass
class DeployedKANMoE:
    """One routed MoE layer's deployed KAN experts and shared experts."""

    experts: GroupedKAN
    shared: DeployedKAN | None

    @property
    def device(self) -> torch.device:
        return self.experts.device


def _stack_experts(deps: list) -> GroupedKAN:
    d0 = deps[0]
    layers = tuple(
        {k: torch.stack([dep.layers[li][k] for dep in deps])
         for k in ("lut", "wc", "wb")}
        for li in range(len(d0.layers)))
    return GroupedKAN(plan=d0.plan, layers=layers, specs=d0.specs,
                      dims=d0.dims, experts=len(deps))


def deploy_kan_moe(blk: dict, cfg: ModelConfig) -> DeployedKANMoE:
    """Quantize and deploy one layer's float KAN experts (``blk``: the
    unstacked ``routed_moe`` params, experts on a leading axis): each
    expert on its own (``quantize_kan_ffn`` / ``deploy_kan_ffn``), then
    stacked for the grouped launch; the shared experts as one bundle."""
    names = ("c1", "wb1", "c2", "wb2")
    deps = []
    for e in range(blk["c1"].shape[0]):
        q = quantize_kan_ffn({k: blk[k][e] for k in names}, cfg)
        deps.append(deploy_kan_ffn(q, cfg))
    with setup_phase("deploy"):
        experts = _stack_experts(deps)
    del deps
    shared = None
    if "shared" in blk:
        shared = deploy_kan_ffn(quantize_kan_ffn(blk["shared"], cfg), cfg)
    return DeployedKANMoE(experts=experts, shared=shared)


def _count_busiest(seg: torch.Tensor) -> None:
    n = seg[1:] - seg[:-1]
    acc = _BUSIEST.get(seg.device)
    if acc is None:
        acc = _BUSIEST[seg.device] = torch.zeros((), dtype=torch.int64,
                                                 device=seg.device)
    acc.add_(n.max())


def kan_moe_apply_quantized(p: dict, x: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    """A deployed routed KAN MoE layer over x (B, S, D): route
    (``models.layers.route_sigmoid``, nothing dropped), code every token
    once (tanh, the first half's grid), gather codes and raw inputs into
    expert order, one grouped B1 launch per half over all experts, gates
    times outputs summed per token in f32, plus the shared experts'
    KAN-FFN (ungated) on the same codes.  ``p``: {"router", "bias",
    "deployed": DeployedKANMoE}; the fused backend only."""
    from ..models.layers import route_sigmoid, routed_combine

    backend = runtime.resolve_backend()
    if backend != "fused":
        raise ValueError(f"the routed KAN experts run on the fused backend, "
                         f"not {backend!r}")
    b, s, d = x.shape
    t, k = b * s, cfg.num_experts_per_tok
    dep = p["deployed"]
    xt = x.reshape(t, d).to(torch.float32)
    with profile_scope("model.moe.route"):
        gates, _, order, seg = route_sigmoid(p, xt, cfg)
        _count_busiest(seg)
    MOE_COUNTS["routed"] += t * k
    g = dep.experts
    with profile_scope("model.moe.experts"):
        codes = quantize_input(torch.tanh(xt), g.specs[0])
        tok = order // k
        h_codes, h_raw = codes[tok], xt[tok]
        lp0 = g.plan.layers[0]
        if lp0.fp != lp0.f:
            h_codes = torch.nn.functional.pad(h_codes, (0, lp0.fp - lp0.f))
            h_raw = torch.nn.functional.pad(h_raw, (0, lp0.fp - lp0.f))
        for lp, lw in zip(g.plan.layers, g.layers):
            y, nxt = run_pipeline_layer_grouped(h_codes, h_raw, lw, lp, seg)
            h_codes, h_raw = nxt, y
            MOE_COUNTS["grouped_launches"] += 1
        y = y[:, :g.plan.layers[-1].o]
    out = routed_combine(y, order, gates)
    if dep.shared is not None:
        MOE_COUNTS["shared"] += t
        with profile_scope("model.moe.shared"):
            sh = dep.shared.replan(t)
            out = out + kan_pipeline_impl(codes, xt, sh.layers, sh.plan)
    return out.to(x.dtype).reshape(b, s, d)


def _map_ffn_blocks(params: dict, fn) -> dict:
    """Apply ``fn`` to every stacked ``l{i}_ffn`` block of the decoder and,
    where the tree has one, of the encoder, and to every routed MoE block
    with KAN experts (``l{i}_moe`` with ``"c1"`` or ``"deployed"``)."""
    def kan_block(k: str, v) -> bool:
        return k.endswith("_ffn") or (k.endswith("_moe") and (
            "c1" in v or "deployed" in v))

    def group(gp: dict) -> dict:
        return {k: fn(v) if kan_block(k, v) else v for k, v in gp.items()}

    p = dict(params)
    for stack_key in ("decoder", "encoder"):
        if stack_key in p:
            p[stack_key] = [group(g) for g in p[stack_key]]
    return p


def deploy_kan_ffn_params_tree(params: dict, cfg: ModelConfig) -> dict:
    """Add each layer's deployed bundle to every quantized block of a tree
    (key ``"deployed"``: one DeployedKAN per stacked repeat)."""
    from ..models.transformer import tree_layer

    def deploy(blk: dict) -> dict:
        if "deployed" in blk:
            return blk
        if "c1" in blk:  # a routed MoE block: quantized and deployed at once
            return _deploy_moe_block(blk, cfg)
        repeats = blk["l1"]["c_q"].shape[0]
        deployed = tuple(
            deploy_kan_ffn(tree_layer({"l1": blk["l1"], "l2": blk["l2"]}, r),
                           cfg)
            for r in range(repeats))
        return {**blk, "deployed": deployed}

    return _map_ffn_blocks(params, deploy)


def quantize_kan_ffn_params_tree(params: dict, cfg: ModelConfig) -> dict:
    """Swap every KAN-FFN block of a model param tree (decoder and encoder)
    for its quantized form.

    Each stacked ``l{i}_ffn`` float dict (leading dim = repeats) becomes
    the stacked ``{"l1","l2"}`` qparams dict (equal to the reference's
    byte for byte) plus ``"deployed"``, the per-layer bundles built once
    here (see the module docstring).  Run once at deploy time; a block that
    is already quantized is kept (and deployed if it is not yet)."""
    from ..models.transformer import stack_trees, tree_layer

    def quantize(blk: dict) -> dict:
        if "l1" in blk or "router" in blk:  # quantized, or a MoE block
            return blk
        repeats = blk["c1"].shape[0]
        return stack_trees([quantize_kan_ffn(tree_layer(blk, r), cfg)
                            for r in range(repeats)])

    return deploy_kan_ffn_params_tree(_map_ffn_blocks(params, quantize), cfg)


def _deploy_moe_block(blk: dict, cfg: ModelConfig) -> dict:
    """A stacked routed MoE block with float KAN experts -> its router,
    selection bias and one :class:`DeployedKANMoE` per repeat
    (``"deployed"``); the float experts are not kept."""
    from ..models.transformer import tree_layer

    repeats = blk["router"].shape[0]
    deployed = tuple(deploy_kan_moe(tree_layer(blk, r), cfg)
                     for r in range(repeats))
    out = {"router": blk["router"], "deployed": deployed}
    if "bias" in blk:
        out["bias"] = blk["bias"]
    return out
