"""Op-stream analysis of one step: FLOPs, memory traffic, collectives, memory.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
parses the compiled per-device HLO module and expands its ``while`` loops
by their trip counts; the port has no HLO.  What it has is the stream of
aten ops a step dispatches, which :class:`OpRecorder` (a
``TorchDispatchMode``) sees one by one.  Eager execution has no loops to
expand: every op instance, of every microbatch, layer and recomputed
block, is dispatched and recorded, so the stream is already trip-counted.

Per op it records the name, the output shapes and dtypes and:

  * FLOPs, from ``torch.utils.flop_counter``'s registered formulas (mm,
    bmm, addmm, baddbmm, convolution and SDPA, with their backwards).  An
    op without a formula is decomposed where it has a decomposition and
    its parts are recorded instead, as ``FlopCounterMode`` does, so the
    total equals ``FlopCounterMode``'s over the same run.  The reference
    counts ``dot``s only, 2 * prod(result) * prod(contracting dims);
  * bytes: 2 x the bytes of the outputs that are new storages (each is
    written once and read about once downstream), the reference's proxy.
    An in-place op writes into an existing storage and a view makes none,
    so neither counts; the ops of :data:`_NO_TRAFFIC_OPS` (views, metadata
    and allocations that write nothing) are written out below, as the
    reference's are;
  * the storage high-water mark: each new storage's bytes are added when
    it appears and taken off when it is freed (a ``weakref.finalize`` on
    the storage), the stand-in for ``compiled.memory_analysis()``.

Collective bytes come from ``dist.comm.COLLECTIVE_BYTES``: the payload of
every collective, real or over a ``dist.comm.DryGroup``, by kind.

The reference's ``xla_flat_*`` (XLA's own loop-blind cost analysis) and
``unknown_trip_loops`` have no counterpart and are not reported.

On the meta device the kernel wrappers (B1-B4) take their plain versions
(``kernels/attention/ops.py``: only a CUDA tensor launches), so what is
counted is their plain arithmetic: a kernel's FLOPs are its matmuls, and
its bytes are eager's, not the fused kernel's.  ``launch.dryrun`` attends
on the "ref" backend, as the reference's dry-run does on its host devices.

The roofline terms use one H100 SXM's published peaks (NVIDIA data sheet,
dense, at the full 700 W power limit):

    compute    = flops_per_device / 989e12     (bf16 on the tensor cores)
    memory     = bytes_per_device / 3.35e12    (HBM3)
    collective = collective_bytes_per_device / 450e9   (NVLink 4)
"""

from __future__ import annotations

import functools
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..dist import comm

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "OpRecorder", "roofline",
           "tensor_bytes", "analyze_step"]

# bf16 dense on the tensor cores, H100 SXM (NVIDIA H100 data sheet)
PEAK_FLOPS = 989e12
# HBM3 bandwidth, H100 SXM (NVIDIA H100 data sheet)
HBM_BW = 3.35e12
# bytes/s per direction per GPU: 18 NVLink 4 links x 25 GB/s (NVIDIA H100
# data sheet: 900 GB/s bidirectional); in place of the reference's ICI_BW
NVLINK_BW = 450e9

_aten = torch.ops.aten

# ops that move no bytes of their own: views and metadata (no new storage)
# and allocations that write nothing (their storage still counts toward
# the high-water mark)
_NO_TRAFFIC_OPS = frozenset({
    # views
    _aten.view, _aten._unsafe_view, _aten.reshape, _aten._reshape_alias,
    _aten.expand, _aten.permute, _aten.transpose, _aten.t, _aten.slice,
    _aten.select, _aten.squeeze, _aten.unsqueeze, _aten.as_strided,
    _aten.alias, _aten.detach, _aten.split, _aten.split_with_sizes,
    _aten.unbind, _aten.chunk, _aten.narrow, _aten.diagonal, _aten.unfold,
    _aten.movedim, _aten.view_as_real, _aten.view_as_complex,
    _aten.lift_fresh,
    # metadata
    _aten.size, _aten.sym_size, _aten.stride, _aten.sym_stride,
    _aten.numel, _aten.sym_numel, _aten.dim, _aten.is_contiguous,
    _aten.storage_offset, _aten.sym_storage_offset,
    # allocations without a write
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided,
})

# the ops FlopCounterMode passes through uncounted and undecomposed
_META_OPS = frozenset({
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default,
})


@functools.cache
def _decomposes(func) -> bool:
    """Whether ``FlopCounterMode`` would record ``func``'s parts in its
    place: it offers every op outside its registry to ``decompose``, which
    runs a CompositeImplicitAutograd kernel where there is one."""
    if func in flop_registry or func is torch.ops.prim.device.default:
        return False
    key = torch._C.DispatchKey.CompositeImplicitAutograd
    return (key in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                              key))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpRecorder(TorchDispatchMode):
    """Records the aten ops dispatched inside it (see the module note).

    ``flops`` and ``bytes`` are the totals; ``peak_bytes`` the high-water
    mark of the storages made inside it (those alive on entry, the step's
    arguments, are not counted); ``ops`` one record per op when
    ``keep_ops``: ``{"op", "shapes", "dtypes", "flops", "bytes"}``."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.keep_ops = keep_ops
        self.ops: list = []
        self.flops = 0
        self.bytes = 0
        self.count = 0
        self.live = 0
        self.peak_bytes = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        # FlopCounterMode's test: the registry's keys are packets, so every
        # overload that has a decomposition is decomposed
        if _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        held = {_storage_key(t) for t in _tensors((args, kwargs))}
        out = func(*args, **kwargs)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        outs = _tensors(out)
        for t in outs:
            key = _storage_key(t)
            if key in held:
                continue
            held.add(key)
            st = t.untyped_storage()
            size = st.nbytes()
            self.live += size
            weakref.finalize(st, self._free, size)
            if packet not in _NO_TRAFFIC_OPS:
                nbytes += 2 * size
        self.peak_bytes = max(self.peak_bytes, self.live)
        self.flops += flops
        self.bytes += nbytes
        self.count += 1
        if self.keep_ops:
            self.ops.append({
                "op": str(func),
                "shapes": [list(t.shape) for t in outs],
                "dtypes": [str(t.dtype).replace("torch.", "") for t in outs],
                "flops": flops, "bytes": nbytes})
        return out


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float) -> dict:
    """The reference's roofline terms at the H100's peaks."""
    compute_s = flops_per_dev / PEAK_FLOPS
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_time_lb_s"] = bound
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages' views in a tree of tensors (each
    tensor's own elements; a storage shared by two leaves counts once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = (_storage_key(t), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def analyze_step(fn, *args, devices: int = 1, keep_ops: bool = False) -> dict:
    """Run ``fn(*args)`` once under an :class:`OpRecorder` and report, per
    device, the keys of the reference's ``analyze_compiled`` whose meaning
    carries over: ``devices``, ``flops_per_dev``, ``bytes_per_dev``,
    ``collectives`` (bytes by kind, and ``total``), ``memory``
    (``argument_bytes``: the arguments' bytes; ``peak_bytes``: those
    plus the high-water mark of the storages the run made;
    ``temp_bytes``: the difference) and ``roofline``; plus
    ``ops`` (the per-op records, with ``keep_ops``), ``op_count`` and
    ``run_s``.  ``fn``'s collectives are counted from zero: the
    module-level counters of ``dist.comm`` are reset first."""
    comm.reset_collectives()
    rec = OpRecorder(keep_ops=keep_ops)
    t0 = time.perf_counter()
    with rec:
        out = fn(*args)
    run_s = time.perf_counter() - t0
    del out
    arg = tensor_bytes(args)
    coll = dict(comm.COLLECTIVE_BYTES)
    coll["total"] = sum(comm.COLLECTIVE_BYTES.values())
    report = {
        "devices": devices,
        "flops_per_dev": float(rec.flops),
        "bytes_per_dev": float(rec.bytes),
        "collectives": coll,
        "collective_counts": dict(comm.COLLECTIVES),
        "memory": {"argument_bytes": int(arg),
                   "peak_bytes": int(arg + rec.peak_bytes),
                   "temp_bytes": int(rec.peak_bytes)},
        "roofline": roofline(rec.flops, rec.bytes, coll["total"]),
        "op_count": rec.count,
        "run_s": run_s,
    }
    if keep_ops:
        report["ops"] = rec.ops
    return report

