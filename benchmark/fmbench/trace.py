"""Reading a ``torch.profiler`` trace of a slice of the measured window.

The harness opens the profiler after a synchronize, wraps the slice in a
``bench.slice`` range, the sweeps in ``bench.sweep`` and the callback in
``bench.callback``, counts kernel 1's calls, then synchronizes and closes
it; the program's spans (``myfm.*``, recorded in traced runs) are ranges
of the trace too.  This module turns the events into the device's busy
time, its idle gaps by what the host was doing, the device time of
every operation by name, the operations that took most time, and kernel
1's device time.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

SLICE = "bench.slice"
HOST_SPANS = ("bench.sweep", "bench.callback")
# the program's spans (myfm_tpu_torch/tracing.py)
PROGRAM = "myfm."
# kernel 1's kernels (csrc/gram_tile.cuh): its Gram pass, one a call, in
# one of two forms, and the carry walk
KERNEL1_PASS = re.compile(r"\b(gram_tile_kernel|gram_wgmma_tile_kernel)<")
KERNEL1_CARRY = re.compile(r"\bcarry_walk_kernel<")


class Nest:
    """The innermost of a set of nested host intervals holding a point."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (start, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, x, default):
        i = bisect.bisect_right(self.starts, x) - 1
        while i is not None and i >= 0:
            if x < self.spans[i][1]:
                return self.spans[i][2]
            i = self.parent[i]
        return default


def _union(intervals):
    """Merged [start, end] intervals of ``intervals``, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, top: int = 10) -> dict:
    """Busy and window seconds, the ``breakdown`` lists, the device ms of
    every operation by name (``kernel_ms``) and kernel 1's device time
    from the profiler's ``events()`` (FunctionEvent objects: ``name``,
    ``device_type``, ``time_range`` in µs).  The profiler puts each
    ``bench.*`` and ``myfm.*`` range on the device's timeline too,
    spanning the work launched inside it: those annotations are not
    operations.  An idle gap is named by the innermost ``bench.*`` or
    ``myfm.*`` host range holding its start, else ``loop``.
    Kernel 1's device time and its Gram passes are counted by the
    kernels' names over the whole trace, which holds kernel 1's calls of
    the slice and no others; its edges on the device's clock do not
    matter there.  Raises ValueError for a trace without its
    ``bench.slice`` range or without device operations."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name == SLICE
              and e.device_type != DeviceType.CUDA]
    if not window:
        raise ValueError("the trace holds no bench.slice range")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    device, spans = [], []
    kernel1_us, passes, carries = 0.0, 0, 0
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(("bench.", PROGRAM)):
                continue
            is_pass = bool(KERNEL1_PASS.search(e.name))
            is_carry = bool(KERNEL1_CARRY.search(e.name))
            if is_pass or is_carry:
                kernel1_us += end - start
                passes += is_pass
                carries += is_carry
            if end > lo and start < hi:
                device.append((max(start, lo), min(end, hi), e.name))
        elif e.name in HOST_SPANS or e.name.startswith(PROGRAM):
            spans.append((start, end, e.name))
    if not device:
        on_card = [e.time_range for e in events
                   if e.device_type == DeviceType.CUDA]
        raise ValueError(
            f"the trace holds no device operation in its slice "
            f"[{lo}, {hi}] us: {len(on_card)} device events in all")
    busy = _union([(s, t) for s, t, _ in device])
    by_name = defaultdict(float)
    for s, t, name in device:
        by_name[name] += t - s

    gaps = []
    edge = lo
    for s, t in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((s - edge, edge))
        edge = max(edge, t)
    gaps.sort(reverse=True)

    doing = Nest(spans)
    return dict(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(t - s for s, t in busy) / 1e6,
        device_s=sum(by_name.values()) / 1e6,
        kernel_ms={n: us / 1e3 for n, us in by_name.items()},
        device_ops=[[n, us / 1e6] for n, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[doing.at(at, "loop"), us / 1e6] for us, at in gaps[:top]],
        kernel1_device_ms=kernel1_us / 1e3,
        kernel1_passes=passes,
        kernel1_carries=carries,
    )

