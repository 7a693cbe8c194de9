"""Reading the port's spans (``myfm_tpu_torch/tracing.py``) in a traced run.

A traced run recorded under ``tracing.recording()`` has two views of
the spans:

* the recording: each span's host interval, its fit and its sweep.  The
  host-time readings take the measured fit's sweeps in the window
  outside the traced slice, where the profiler slows the host;
* the profiler's events of the traced slice, where each span is also a
  ``record_function`` range on the host's timeline.  Each device
  operation is linked to the runtime call that launched it (a kernel
  and its launch share the profiler's correlation id) and put under the
  innermost ``myfm.*`` span holding that call, or ``unattributed``; the
  card's idle gaps are named by the innermost program or ``bench.*``
  span holding their start, else ``loop``.

A traced run of ``cell.run_cell`` keeps the host readings by span
(``host_ms_by_name``) and the device ms by span (``device_split``) in
what its per-layer readers read; ``report`` gathers every reading and
its cross-checks, and ``python3 benchmark/spans.py`` prints it.
"""

from __future__ import annotations

import re
from collections import defaultdict

from . import trace

PROGRAM = trace.PROGRAM
UNATTRIBUTED = "unattributed"
# the CUDA runtime and driver calls that enqueue device work
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def device_split(events, top: int = 10) -> dict:
    """Over the device operations of the traced slice (those
    ``trace.summarize`` counts, with the ``myfm.*`` annotations also
    left out): ``device_s``, ``span_device_ms`` (ms of the operations
    launched inside each program span, ``unattributed`` for the rest),
    ``idle_gaps`` (the ``top`` longest, [name, s]; the gap that opens
    the slice is the harness's profiler start, ``bench.slice``: the
    spans open then began before the profiler did) with their starts
    (``idle_gap_at_ms``, from the slice's) and the span holding each
    gap's middle (``idle_gap_mid``), kernel 1's device ms by its
    kernels' names inside the slice, and the device ms the trace holds
    before and after the slice (``outside_ms``)."""
    window = [e for e in events if e.name == trace.SLICE
              and not _is_device(e)]
    if not window:
        raise ValueError("the trace holds no bench.slice range")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    hosts = [(e.time_range.start, e.time_range.end, e.name)
             for e in events if not _is_device(e)
             and (e.name.startswith(PROGRAM) or e.name in trace.HOST_SPANS)]
    program = trace.Nest([h for h in hosts if h[2].startswith(PROGRAM)])
    doing = trace.Nest(hosts)
    launched = {e.id: e.time_range.start for e in events
                if not _is_device(e) and RUNTIME.match(e.name)}
    by_span = defaultdict(float)
    busy, kernel1_us = [], 0.0
    outside = dict(before=0.0, after=0.0)
    for e in events:
        if not _is_device(e) or e.name.startswith(("bench.", PROGRAM)):
            continue
        start, end = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if e.time_range.start < lo:
            outside["before"] += (min(e.time_range.end, lo)
                                  - e.time_range.start) / 1e3
        if e.time_range.end > hi:
            outside["after"] += (e.time_range.end
                                 - max(e.time_range.start, hi)) / 1e3
        if end <= start:
            continue
        at = launched.get(e.id)
        by_span[UNATTRIBUTED if at is None
                else program.at(at, UNATTRIBUTED)] += end - start
        busy.append((start, end))
        if trace.KERNEL1_PASS.search(e.name) or trace.KERNEL1_CARRY.search(
                e.name):
            kernel1_us += end - start
    gaps, edge = [], lo
    for s, t in trace._union(busy) + [[hi, hi]]:
        if s > edge:
            gaps.append((s - edge, edge))
        edge = max(edge, t)
    gaps.sort(reverse=True)
    return dict(
        device_s=sum(by_span.values()) / 1e6,
        span_device_ms={k: us / 1e3 for k, us in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        idle_gaps=[[trace.SLICE if at == lo else doing.at(at, "loop"),
                    us / 1e6] for us, at in gaps[:top]],
        idle_gap_at_ms=[(at - lo) / 1e3 for _, at in gaps[:top]],
        idle_gap_mid=[doing.at(at + us / 2, "loop") for us, at in gaps[:top]],
        kernel1_slice_ms=kernel1_us / 1e3,
        outside_ms=outside,
    )


def measured_sweeps(spans, window_sweeps: int, slice_after: int,
                    slice_sweeps: int):
    """(the measured fit's number, its window sweeps outside the traced
    slice): sweeps 1..``window_sweeps`` less those whose iteration the
    profiler touched (its start in sweep ``slice_after``'s callback to
    its stop in sweep ``slice_after + slice_sweeps``'s)."""
    fits = [s.fit for s in spans if s.fit is not None]
    if not fits:
        return None, []
    touched = range(slice_after, slice_after + slice_sweeps + 1)
    return max(fits), [i for i in range(1, window_sweeps + 1)
                       if i not in touched]


def host_ms(spans, fit, sweeps, names, own: bool = False):
    """Mean host ms per sweep of ``sweeps`` under the spans named in
    ``names`` (each counted once: a span inside another of ``names``
    is left out), or their own time with ``own`` (less the spans
    directly inside them); None where the fit's sweeps hold none."""
    want = set(sweeps)
    inner = defaultdict(int)
    for s in spans:
        if s.parent is not None and s.t1_ns is not None:
            inner[s.parent] += s.t1_ns - s.t0_ns
    total, found = 0, False
    for i, s in enumerate(spans):
        if (s.name not in names or s.fit != fit or s.sweep not in want
                or s.t1_ns is None):
            continue
        p = s.parent
        while p is not None and spans[p].name not in names:
            p = spans[p].parent
        if p is not None:
            continue
        found = True
        total += s.t1_ns - s.t0_ns - (inner[i] if own else 0)
    return total / 1e6 / len(want) if found else None


def host_ms_by_name(spans, fit, sweeps) -> dict:
    """{name: [total, own]} host ms per sweep of ``sweeps`` for every span
    name the fit's sweeps hold: ``host_ms(spans, fit, sweeps, (name,))``
    and the same with ``own``, in one pass."""
    want = set(sweeps)
    inner = defaultdict(int)
    for s in spans:
        if s.parent is not None and s.t1_ns is not None:
            inner[s.parent] += s.t1_ns - s.t0_ns
    out = {}
    for i, s in enumerate(spans):
        if s.fit != fit or s.sweep not in want or s.t1_ns is None:
            continue
        p = s.parent
        while p is not None and spans[p].name != s.name:
            p = spans[p].parent
        if p is not None:
            continue
        row = out.setdefault(s.name, [0, 0])
        row[0] += s.t1_ns - s.t0_ns
        row[1] += s.t1_ns - s.t0_ns - inner[i]
    return {name: [total / 1e6 / len(want), own / 1e6 / len(want)]
            for name, (total, own) in sorted(out.items())}


def spans_per_sweep(spans, fit, sweeps) -> float:
    want = set(sweeps)
    return sum(1 for s in spans if s.fit == fit
               and s.sweep in want) / max(len(want), 1)


# device readings: (names whose device ms are summed) per slice sweep
DEVICE_METRICS = {
    "sweep.gather_device_ms": ("myfm.sweep.gather",),
    "sweep.finalize_device_ms": ("myfm.sweep.finalize",),
    "sweep.draws_device_ms": ("myfm.sweep.draws",),
    "sweep.hypers_device_ms": ("myfm.sweep.variates", "myfm.sweep.hypers"),
    "eval.score_device_ms": ("myfm.eval.score",),
}
# host readings: (names, own time) per sweep outside the slice
HOST_METRICS = {
    "loop.harvest_ms": (("myfm.loop.harvest", "myfm.loop.drain"), False),
    "loop.self_ms": (("myfm.loop.iter",), True),
    "sweep.enqueue_ms": (("myfm.sweep",), False),
    "eval.metrics_ms": (("myfm.eval.metrics",), True),
}


def metrics(spans, split, window_sweeps, slice_after, slice_sweeps) -> dict:
    """The span metrics of a traced run, each None where its spans are
    absent: ``spans`` the recording's, ``split`` ``device_split``'s
    result (or None)."""
    fit, sweeps = measured_sweeps(spans, window_sweeps, slice_after,
                                  slice_sweeps)
    out = {}
    fingerprint = [s for s in spans if s.name == "myfm.plan.fingerprint"
                   and s.fit == fit and s.t1_ns is not None]
    out["plan.fingerprint_s"] = (
        sum(s.t1_ns - s.t0_ns for s in fingerprint) / 1e9 if fingerprint
        else None)
    for name, (names, own) in HOST_METRICS.items():
        out[name] = (None if fit is None or not sweeps
                     else host_ms(spans, fit, sweeps, names, own))
    for name, names in DEVICE_METRICS.items():
        ms = None if split is None else [split["span_device_ms"][n]
                                         for n in names
                                         if n in split["span_device_ms"]]
        out[name] = sum(ms) / slice_sweeps if ms and slice_sweeps else None
    return out


def report(spans, events, observed, slice_after: int) -> dict:
    """Every reading of a traced run recorded under ``recording()``:
    the span metrics, host ms per sweep by span name, the device ms per
    slice sweep by span, the idle gaps by name and the cross-checks
    (the attributed device time against ``device_s``, kernel 1's span
    against its kernels by name, the unattributed share)."""
    t = observed["trace"]
    n = t["sweeps"]
    split = device_split(events)
    fit, sweeps = measured_sweeps(spans, observed["window_sweeps"],
                                  slice_after, n)
    host = host_ms_by_name(spans, fit, sweeps)
    device_ms = split["span_device_ms"]
    k1_span = device_ms.get("myfm.sweep.kernel1", 0.0)
    return dict(
        metrics=metrics(spans, split, observed["window_sweeps"],
                        slice_after, n),
        spans_per_sweep=spans_per_sweep(spans, fit, sweeps),
        sweeps_outside_slice=len(sweeps),
        host_ms_per_sweep=host,
        device_ms_per_sweep={k: v / n for k, v in device_ms.items()},
        device_ms_sweep=1e3 * split["device_s"] / n,
        idle_gaps=split["idle_gaps"],
        idle_gap_at_ms=split["idle_gap_at_ms"],
        idle_gap_mid=split["idle_gap_mid"],
        outside_slice_ms=split["outside_ms"],
        checks=dict(
            attributed_over_device_s=sum(device_ms.values())
            / (1e3 * split["device_s"]),
            kernel1_span_over_names=(k1_span / t["kernel1_device_ms"]
                                     if t["kernel1_device_ms"] else None),
            kernel1_span_over_names_in_slice=(
                k1_span / split["kernel1_slice_ms"]
                if split["kernel1_slice_ms"] else None),
            unattributed_share=device_ms.get(UNATTRIBUTED, 0.0)
            / (1e3 * split["device_s"]),
            loop_gaps=sum(1 for g in split["idle_gaps"] if g[0] == "loop"),
        ),
    )
