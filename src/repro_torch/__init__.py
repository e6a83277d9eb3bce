"""PyTorch + CUDA port of the quantized KAN datapath for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core/``, ``kernels/kan_spline/``, ``runtime/``, ``data/``) so each
module's counterpart can be found, and imports nothing of it.  The paper's
datapath runs end to end here:

    ASP-quantize (core.asp_quant, core.kan_layer)
      -> deploy padded int8 / int4-packed bundles (core.kan_network_deploy)
      -> runtime.execute on the "fused" backend, one hand-written CUDA
         kernel launch per layer (kernels.kan_spline.pipeline, csrc/)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no ``device="cpu"`` they raise.  On CPU tensors every kernel
wrapper takes its plain PyTorch version; on CUDA tensors it launches the
kernel or raises.

    from repro_torch import runtime
    y = runtime.execute(dep, x)                # "fused" unless overridden
"""
