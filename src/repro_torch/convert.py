"""Bridge from the JAX reference's parameters and bundles to the port's.

Threefry and Philox draw different numbers from the same seed, so the two
packages are never compared on same-seed initializations: weights move
through numpy instead.  Every function here takes host arrays (numpy, or
anything ``np.asarray`` accepts) and duck-typed reference objects, and
imports nothing of the reference package.

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dep = deployed_from_reference(jdep, device="cpu")
    lm = lm_params_from_numpy(jax.tree.map(np.asarray, jlm), device="cpu")
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.asp_quant import ASPQuantSpec
from .core.cim import CIMConfig
from .core.kan_network_deploy import DeployedKAN
from .core.tmdv import TMDVConfig
from .device import resolve_device
from .runtime import PLAN_CACHE

__all__ = [
    "spec_from_reference",
    "tmdv_config_from_reference",
    "cim_config_from_reference",
    "params_from_numpy",
    "qparams_from_numpy",
    "deployed_from_reference",
    "lm_params_from_numpy",
]


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def spec_from_reference(spec) -> ASPQuantSpec:
    """The port's frozen ASPQuantSpec, mapped field by field."""
    return ASPQuantSpec(**{
        f.name: getattr(spec, f.name) for f in dataclasses.fields(ASPQuantSpec)
    })


def tmdv_config_from_reference(cfg) -> TMDVConfig:
    """The port's frozen TMDVConfig, mapped field by field."""
    return TMDVConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(TMDVConfig)
    })


def cim_config_from_reference(cfg) -> CIMConfig:
    """The port's frozen CIMConfig, mapped field by field (its input
    generator too)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(CIMConfig)}
    fields["input_gen"] = tmdv_config_from_reference(cfg.input_gen)
    return CIMConfig(**fields)


def params_from_numpy(params_list, *, device=None) -> list:
    """Float layer params ``[{"c", "w_b"}, ...]`` as tensors on ``device``."""
    dev = resolve_device(device)
    return [{k: _tensor(p[k], dev) for k in ("c", "w_b")} for p in params_list]


def qparams_from_numpy(qparams: dict, *, device=None) -> dict:
    """One ``quantize_kan_layer`` dict, every entry a tensor of the same
    dtype on ``device`` (``lut_scale`` becomes a 0-dim f32 tensor)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in qparams.items()}


def deployed_from_reference(dep, *, device=None) -> DeployedKAN:
    """A reference ``DeployedKAN`` as the port's, weights copied verbatim.

    The port's plan for the same batch, dims and specs must pad exactly as
    the reference's did; a mismatch raises instead of loading weights into
    the wrong geometry.
    """
    dev = resolve_device(device)
    specs = tuple(spec_from_reference(s) for s in dep.specs)
    dims = tuple(int(d) for d in dep.dims)
    plan = PLAN_CACHE.plan(int(dep.plan.b), dims, specs,
                           residual_raw=bool(dep.residual_raw))
    for lp, ref_lp in zip(plan.layers, dep.plan.layers):
        if (lp.fp, lp.op) != (ref_lp.fp, ref_lp.op):
            raise ValueError(
                f"padded geometry differs: port {(lp.fp, lp.op)} vs "
                f"reference {(ref_lp.fp, ref_lp.op)}"
            )
    layers = tuple({k: _tensor(v, dev) for k, v in lw.items()}
                   for lw in dep.layers)
    return DeployedKAN(plan=plan, layers=layers, specs=specs, dims=dims,
                       residual_raw=bool(dep.residual_raw))


def lm_params_from_numpy(tree, *, device=None):
    """An LM param tree (``models.model.init_params``, or that tree after
    ``quantize_kan_ffn_params_tree``) as the port's, leaf for leaf.

    ``tree``: nested dicts and lists of host arrays, with each decoder
    group's leaves stacked over its repeats (leading dim), as the reference
    keeps them.  bf16 leaves (``ml_dtypes.bfloat16`` in numpy) are carried
    as their bit patterns, so the values are exact.  A quantized tree comes
    back without the port's per-layer ``"deployed"`` bundles; add them with
    ``core.kan_ffn_deploy.deploy_kan_ffn_params_tree`` before serving it
    (``kan_ffn_apply_quantized`` refuses a block without them)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
            return bits.view(torch.bfloat16).to(dev)
        return _tensor(a, dev)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    return walk(tree)
