"""Quickstart: build a KAN, quantize it with ASP-KAN-HAQ, run all four
execution paths (float / quantized-LUT / kernel B3 / fused pipeline B1)
and compare.

Port of ``examples/quickstart.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On a CPU tensor each kernel's wrapper takes its plain version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import parity, runtime
from ..core.asp_quant import quantize_input
from ..core.kan_layer import (
    KANSpec,
    init_kan_network,
    kan_network_apply,
    quantize_kan_layer,
)
from ..core.kan_network_deploy import deploy_kan_network
from ..device import resolve_device
from ..kernels.kan_spline.ops import kan_spline_from_qparams
from ..runtime.executor import _entry_codes
from . import device_label

__all__ = ["run", "parity_gate", "main"]


def run(*, params=None, x=None, device=None, log=print) -> dict:
    """The four paths on one network and one batch.

    ``params`` (a float KAN1 stack) and ``x`` (``(B, 17)`` in [-1, 1])
    replace the ones drawn from seed 0 (8 rows).  Returns the spec, the
    weights, the input, each path's output (``y_float``, ``y_quant``,
    ``y_kernel``, ``y_fused``), the kernel path's input codes per layer
    (``kernel_codes``), the max differences the example prints, and the
    SH-LUT's entry counts.
    """
    dev = resolve_device(device)
    # the paper's edge KAN: 17 -> 1 -> 14, G=5 (KAN1 design point)
    kspec = KANSpec(dims=(17, 1, 14), grid_size=5, n_bits=8)
    spec = kspec.layer_spec()
    log(f"KAN {kspec.dims}, G={kspec.grid_size}, K={kspec.order} on "
        f"{device_label(dev)}")
    log(f"ASP bit split: LD={spec.ld} -> global={spec.global_bits} bits "
        f"(knot interval), local={spec.ld} bits (intra-interval)")
    log(f"code range [0, {spec.num_codes - 1}] (eq. (6): G*2^LD <= 2^n)")

    gen = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = init_kan_network(gen, kspec, device=dev)
    params = [{k: v.to(dev) for k, v in p.items()} for p in params]
    if x is None:
        x = torch.rand((8, kspec.dims[0]), generator=gen, device=dev) \
            * 2.0 - 1.0
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    x = x.to(device=dev, dtype=torch.float32)

    with torch.no_grad():
        # 1) float path (training path)
        y_float = kan_network_apply(params, x, kspec)

        # 2) ASP-quantized path (shared SH-LUT + banded matmul)
        qparams = [quantize_kan_layer(p, spec) for p in params]
        y_quant = kan_network_apply(None, x, kspec, quantized=True,
                                    qparams_list=qparams, device=dev)

        # 3) kernel B3, layer by layer
        h, kernel_codes = x, []
        for li, qp in enumerate(qparams):
            codes = quantize_input(h, spec)
            kernel_codes.append(codes)
            h = kan_spline_from_qparams(codes, qp, spec)
            if li < len(qparams) - 1:
                h = torch.tanh(h)
        y_kernel = h

        # 4) the fused multi-layer pipeline: every layer in kernel B1,
        #    inter-layer requantization fused, activations stay int codes
        y_fused = kan_network_apply(None, x, kspec, quantized=True,
                                    qparams_list=qparams, backend="pallas",
                                    device=dev)

    log("\nfloat    ", y_float[0, :5].tolist())
    log("quantized", y_quant[0, :5].tolist())
    log("kernel   ", y_kernel[0, :5].tolist())
    log("fused    ", y_fused[0, :5].tolist())
    err = {
        "float_quant": float((y_float - y_quant).abs().max()),
        "quant_kernel": float((y_quant - y_kernel).abs().max()),
        "quant_fused": float((y_quant - y_fused).abs().max()),
    }
    log("\nmax |float - quantized| =", err["float_quant"])
    log("max |quantized - kernel| =", err["quant_kernel"])
    log("max |quantized - fused|  =", err["quant_fused"])
    e = quantize_kan_layer(params[0], spec)
    lut = {"stored": int(e["hemi"].numel()),
           "unfolded": (spec.order + 1) * spec.codes_per_interval,
           "per_basis": spec.num_basis * 2**spec.n_bits}
    log(f"\nSH-LUT: {lut['stored']} stored entries "
        f"(vs {lut['unfolded']} unfolded, "
        f"vs {lut['per_basis']} for per-B_i tables)")
    return {"kspec": kspec, "spec": spec, "device": dev, "params": params,
            "qparams": qparams, "x": x, "y_float": y_float,
            "y_quant": y_quant, "y_kernel": y_kernel, "y_fused": y_fused,
            "kernel_codes": kernel_codes, "max_abs": err, "sh_lut": lut}


def parity_gate(out: dict) -> dict:
    """Hold the kernel and the fused paths of a :func:`run` to its quantized
    path under :mod:`repro_torch.parity`'s gate.

    The quantized path is the "ref" backend of the bundle the example
    deploys; its boundary codes and pre-round values come from one more
    "ref" run, the fused path's codes from one more fused run (kernel B1
    again on a CUDA input).  Raises AssertionError where the gate fails;
    returns ``{"kernel", "fused"}``, each ``compare_runs``' summary."""
    kspec, x = out["kspec"], out["x"]
    dep = deploy_kan_network(out["qparams"], kspec, batch=x.shape[0],
                             device=out["device"])
    with torch.no_grad():
        want_y, want_codes = runtime.execute(dep, x, backend="ref",
                                             return_intermediates=True)
        _, fused_codes = runtime.execute(dep, x, backend="fused",
                                         return_intermediates=True)
        entry, xraw = _entry_codes(dep, x, None)
    if not torch.equal(out["y_quant"], want_y):
        raise AssertionError("the quantized path is not the 'ref' backend's "
                             "run of the deployed bundle")
    pre = parity.boundary_prerounds(dep, entry, xraw, want_codes)
    return {
        "kernel": parity.compare_runs(out["kernel_codes"][1:], want_codes, pre,
                                      out["y_kernel"], want_y),
        "fused": parity.compare_runs(fused_codes, want_codes, pre,
                                     out["y_fused"], want_y),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
