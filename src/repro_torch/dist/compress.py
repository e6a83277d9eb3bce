"""int8 compression for cross-replica sync and sharded-bundle shipping.

Port of ``repro.dist.compress``.  Two consumers of one symmetric
per-tensor int8 scheme:

  * **gradients**: EF-SGD.  Quantize (grad + carried error) to int8,
    all-reduce the dequantized payload as a mean over the ``"data"`` group
    (:func:`compressed_grad_sync`), and carry the quantization residual
    into the next step.
  * **deployed KAN bundles**: :func:`compress_deployed_kan` gathers a
    (possibly model-sharded) bundle's padded weights to the host and
    int8-compresses each leaf; :func:`decompress_deployed_kan` decodes the
    payload and places it on a target mesh (or none), so a bundle placed on
    one mesh can ship as a ~4x smaller payload and land on another.

The bundle codec runs in numpy, as the reference's does.  The gradient
codec runs on the tensors' device.  On CUDA a division by a host scalar
(or a 0-d tensor broadcast in the same way) multiplies by the reciprocal,
so :func:`_quantize` divides by a tensor of the full shape and is IEEE
there too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import comm

__all__ = [
    "init_error_feedback",
    "compressed_grad_sync",
    "compress_deployed_kan",
    "decompress_deployed_kan",
    "_quantize",
]


def _ieee_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` divided element by element against a full-shape divisor
    (never the reciprocal multiply CUDA takes for a broadcast scalar)."""
    return torch.div(a, b.expand(a.shape).contiguous())


def _quantize(g: torch.Tensor):
    """Symmetric per-tensor int8: returns (q int8, scale f32 0-d)."""
    g = g.to(torch.float32)
    amax = torch.clamp_min(g.abs().max(), 1e-30)
    scale = _ieee_div(amax, torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(_ieee_div(g, scale)), -127, 127)
    return q.to(torch.int8), scale


def init_error_feedback(params):
    """Zero residual tree, shaped like the gradients (f32)."""
    from ..train.optimizer import tree_map

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_grad_sync(grads, error_feedback, mesh, axis_name: str = "data"):
    """Quantize gradients + error to int8 and average the dequantized
    payload over the mesh's ``axis_name`` group (an all-reduce of the sum,
    then a division by the group size).

    Every rank passes its own gradients; returns (synced_grads,
    new_error_feedback), the same synced tree on every rank of the group.
    """
    from ..train.optimizer import tree_map

    group = mesh.get_group(axis_name)
    n = comm.group_size(group)

    def one(g, e):
        ge = g.to(torch.float32) + e
        q, s = _quantize(ge)
        deq = q.to(torch.float32) * s
        total = comm.all_reduce_sum(deq, group)
        synced = _ieee_div(total, torch.full((), float(n),
                                             device=total.device))
        return synced, ge - deq

    pairs = tree_map(one, grads, error_feedback)
    synced = tree_map(lambda g, p: p[0], grads, pairs)
    new_ef = tree_map(lambda g, p: p[1], grads, pairs)
    return synced, new_ef


# ----------------------------------------------------------------------------
# deployed-KAN bundle shipping (gather -> compress -> place)
# ----------------------------------------------------------------------------


def _gathered_layers(dep) -> list:
    """The bundle's layers as global host arrays: a placed bundle's column
    slabs are all-gathered over the placement's ``"model"`` group."""
    if dep.placement is None:
        return [{k: v.detach().cpu().numpy() for k, v in lw.items()}
                for lw in dep.layers]
    mesh = dep.placement
    group = (mesh.get_group("model") if "model" in mesh.mesh_dim_names
             else None)
    out = []
    for lw, specs in zip(dep.layers, dep.shard_specs):
        out.append({
            k: (comm.all_gather(v, group, dim=v.ndim - 1)
                if "model" in specs[k] else v).detach().cpu().numpy()
            for k, v in lw.items()})
    return out


def compress_deployed_kan(dep) -> dict:
    """Gather a deployed-KAN bundle to host and int8-compress its weights.

    Works on placed (model-sharded) and unplaced bundles alike.  The shared
    SH-LUT ships in raw f32 (tiny, and the datapath's precision anchor);
    int4-packed leaves ship verbatim; the padded ``wc``/``wb`` matrices
    ship as (int8 codes, f32 scale).  Returns a host payload for
    :func:`decompress_deployed_kan`.
    """
    layers = []
    for lw in _gathered_layers(dep):
        entry = {}
        for k, a in lw.items():
            if a.dtype == np.int8:
                entry[k] = a
            elif k.startswith("lut") or k == "wscale":
                entry[k] = np.asarray(a, np.float32)
            else:
                a = np.asarray(a, np.float32)
                s = max(float(np.abs(a).max()), 1e-30) / 127.0
                q = np.clip(np.round(a / s), -127, 127).astype(np.int8)
                entry[k] = (q, float(s))
        layers.append(entry)
    return {
        "layers": layers,
        "dims": tuple(int(d) for d in dep.dims),
        "specs": tuple(dataclasses.astuple(s) for s in dep.specs),
        "residual_raw": bool(dep.residual_raw),
    }


def decompress_deployed_kan(payload: dict, dep, mesh=None):
    """Decode a compressed bundle and place it on ``mesh``.

    ``dep`` supplies the geometry and specs (the receiving end's bundle,
    e.g. freshly deployed from the same quantized params, on the device the
    result should live on); its weights are replaced by the decoded
    payload.  With ``mesh`` the result is placed (``place_deployed_kan``)
    and records the placement; ``mesh=None`` returns an unplaced bundle.
    """
    from ..core.kan_network_deploy import place_deployed_kan

    specs = tuple(dataclasses.astuple(s) for s in dep.specs)
    if (tuple(payload["dims"]) != tuple(dep.dims)
            or bool(payload["residual_raw"]) != bool(dep.residual_raw)
            or tuple(payload["specs"]) != specs):
        raise ValueError(
            f"payload geometry {payload['dims']} (residual_raw="
            f"{payload['residual_raw']}) does not match bundle {dep.dims} "
            f"(residual_raw={dep.residual_raw}) / its quantization specs"
        )
    device = dep.device
    layers = []
    for entry in payload["layers"]:
        lw = {}
        for k, v in entry.items():
            if isinstance(v, tuple):
                q, s = v
                v = q.astype(np.float32) * np.float32(s)
            lw[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        layers.append(lw)
    out = dataclasses.replace(dep, layers=tuple(layers), placement=None,
                              shard_specs=None)
    if mesh is not None:
        out = place_deployed_kan(out, mesh)
    return out
