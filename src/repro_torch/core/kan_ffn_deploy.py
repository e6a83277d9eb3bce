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
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..obs.metrics import setup_phase
from .kan_layer import quantize_kan_layer
from .kan_network_deploy import deploy_kan_ffn_stack, kan_network_deploy_apply

__all__ = [
    "quantize_kan_ffn",
    "deploy_kan_ffn",
    "kan_ffn_apply_quantized",
    "quantize_kan_ffn_params_tree",
    "deploy_kan_ffn_params_tree",
]


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


def _map_ffn_blocks(params: dict, fn) -> dict:
    """Apply ``fn`` to every stacked ``l{i}_ffn`` block of the decoder and,
    where the tree has one, of the encoder."""
    def group(gp: dict) -> dict:
        return {k: fn(v) if k.endswith("_ffn") else v for k, v in gp.items()}

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
        if "l1" in blk:  # already quantized: kept as it is
            return blk
        repeats = blk["c1"].shape[0]
        return stack_trees([quantize_kan_ffn(tree_layer(blk, r), cfg)
                            for r in range(repeats)])

    return deploy_kan_ffn_params_tree(_map_ffn_blocks(params, quantize), cfg)
