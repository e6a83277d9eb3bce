"""The traced run: ``torch.profiler`` over a slice of the window, reduced
to device intervals and the program's ranges.

Device operations (kernels, copies, memsets) are kept as (start, end,
name, kind) in seconds from the traced window's start.  The program's
``obs.profile_scope`` ranges (``serve.prefill``, ``serve.decode_step``,
``kan_spline.<backend>``) are kept twice: as host ranges (when the host
was inside them) and as their device-side spans (the interval the
kernels they launched ran in).  Kernel B1 and B2 are found by their
symbols: ``kan_layer_kernel`` / ``kan_layer_combine`` and
``flash_kernel*``.
"""

from __future__ import annotations

import bisect
import collections

from .stats import merged, union_length

WINDOW_RANGE = "bench.window"
B1_SYMBOLS = ("kan_layer_kernel", "kan_layer_combine")
B2_SYMBOLS = ("flash_kernel",)


def is_b1(name: str) -> bool:
    return any(s in name for s in B1_SYMBOLS)


def is_b2(name: str) -> bool:
    return any(s in name for s in B2_SYMBOLS)


class Trace:
    """What one traced window left: device ops, host and device ranges,
    and the window's length."""

    def __init__(self, ops, host_ranges, device_ranges, window_s: float):
        self.ops = sorted(ops)
        self.host_ranges = host_ranges
        self.device_ranges = device_ranges
        self.window_s = window_s

    # -- device time -------------------------------------------------------

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_length((s, e) for s, e, _, _ in self.ops)

    def idle_percent(self) -> float | None:
        """Share of the window in which nothing ran on the device."""
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def op_s(self, pred) -> float:
        """Summed device time of the ops whose name satisfies ``pred``."""
        return sum(e - s for s, e, n, _ in self.ops if pred(n))

    def kind_s(self, kind: str, pred=lambda n: True) -> float:
        return sum(e - s for s, e, n, k in self.ops if k == kind and pred(n))

    def inside(self, range_name: str):
        """The ops that started inside a device span of ``range_name`` (its
        host spans where the profile gave it none on the device)."""
        spans = merged(self.device_ranges.get(range_name)
                       or self.host_ranges.get(range_name, ()))
        starts = [s for s, _ in spans]
        for op in self.ops:
            i = bisect.bisect_right(starts, op[0]) - 1
            if i >= 0 and op[0] < spans[i][1]:
                yield op

    def host_s(self, range_name: str) -> float:
        return union_length(self.host_ranges.get(range_name, ()))

    # -- the breakdown the result line carries --------------------------------

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.Counter()
        for s, e, n, _ in self.ops:
            by_name[short_name(n)] += e - s
        busy = merged((s, e) for s, e, _, _ in self.ops)
        edges = [0.0] + [x for se in busy for x in se] + [self.window_s]
        gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                       if b > a), reverse=True)[:top]
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[self.host_at(a + g / 2), g] for g, a in gaps]}

    def host_at(self, t: float) -> str:
        """The innermost program range the host was in at ``t``."""
        best = None
        for name, spans in self.host_ranges.items():
            for s, e in spans:
                if s <= t < e and (best is None or e - s < best[0]):
                    best = (e - s, name)
        return best[1] if best else "host outside the program's ranges"


def short_name(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


class Tracer:
    """Profile from :meth:`start` to :meth:`stop`; both are called between
    the traffic generator's calls, so every call is traced whole or not at
    all."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch import obs

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        obs.enable_profiler_annotations()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()

    def stop(self) -> Trace:
        import torch

        from repro_torch import obs

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        obs.disable_profiler_annotations()
        return reduce(self.prof)


def reduce(prof) -> Trace:
    """Device ops and ranges of a finished profile, in seconds from the
    start of its ``bench.window`` range, clipped to that range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw_ops, host, dev = [], collections.defaultdict(list), \
        collections.defaultdict(list)
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        kind = str(getattr(e, "activity_type", lambda: "")()).lower()
        annotation = e.is_user_annotation() or "user_annotation" in kind
        if e.device_type() == cuda:
            if annotation:
                dev[name].append((s, t))
            elif "memcpy" in kind or name.startswith("Memcpy"):
                raw_ops.append((s, t, name, "memcpy"))
            elif "memset" in kind or name.startswith("Memset"):
                raw_ops.append((s, t, name, "memset"))
            else:
                raw_ops.append((s, t, name, "kernel"))
        elif annotation:
            if name == WINDOW_RANGE:
                w0, w1 = s, t
            else:
                host[name].append((s, t))
    if w0 is None:
        raise RuntimeError("the profile holds no bench.window range")

    def clip(s, t):
        s, t = max(s, w0), min(t, w1)
        return ((s - w0) / 1e9, (t - w0) / 1e9) if t > s else None

    ops = []
    for s, t, name, kind in raw_ops:
        c = clip(s, t)
        if c:
            ops.append((c[0], c[1], name, kind))

    def clipped(d):
        out = {}
        for name, spans in d.items():
            kept = [c for c in (clip(s, t) for s, t in spans) if c]
            if kept:
                out[name] = kept
        return out

    return Trace(ops, clipped(host), clipped(dev), (w1 - w0) / 1e9)
