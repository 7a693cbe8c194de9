"""Spans: named blocks of host work at the port's layer boundaries.

``span(name)`` marks a block of the program.  Tracing is off by default,
and then a span is one shared no-op context, returned after a single
check of a module flag: it allocates and records nothing.  Inside
``recording()`` every span records its name, the index of the span that
encloses it, the fit and the sweep it belongs to (``fit`` numbers the
``myfm.fit`` spans of the recording, ``sweep`` is the index the
enclosing ``myfm.loop.iter`` sets) and its host interval in
``time.perf_counter_ns()``.  While a ``torch.profiler`` records, a span
also enters ``torch.profiler.record_function(name)``: it then appears
among the profiler's events, on the timeline of the device trace, which
is how an operator sees the spans beside the kernels they launched.

No span synchronizes the device except those opened with ``sync`` (the
plan build's windows, once per design and off the sweep path), which
synchronize at their end while recording so that the device work of a
window lands in it.  Spans are opened from one thread.  Every name
starts with ``myfm.``.

    with tracing.recording() as rec:
        fm.fit(X, y)
    rec.summary()["myfm.sweep"]  # {"calls": ..., "total_ms": ..., ...}
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

# the span that numbers the fits of a recording
FIT = "myfm.fit"

# the open Recording, or None: tracing off
_recording = None


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span; ``t1_ns`` is None while it is open."""

    name: str
    parent: Optional[int]
    fit: Optional[int]
    sweep: Optional[int]
    t0_ns: int
    t1_ns: Optional[int] = None

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class Recording:
    """The spans recorded inside one ``recording()``, in the order they
    were opened (``parent`` indexes this list)."""

    def __init__(self):
        self.spans = []
        self._open = []
        self._fits = 0

    def summary(self) -> dict:
        """Per name: ``calls``, ``total_ms`` and ``self_ms`` (each span's
        time less the time of the spans directly inside it) of the
        closed spans."""
        inner = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None and s.t1_ns is not None:
                inner[s.parent] += s.t1_ns - s.t0_ns
        out = {}
        for s, children in zip(self.spans, inner):
            if s.t1_ns is None:
                continue
            row = out.setdefault(
                s.name, dict(calls=0, total_ms=0.0, self_ms=0.0))
            row["calls"] += 1
            row["total_ms"] += s.ms
            row["self_ms"] += (s.t1_ns - s.t0_ns - children) / 1e6
        return out


# the span of tracing off: one shared context that does nothing
_NOOP = contextlib.nullcontext()


class _Open:
    __slots__ = ("rec", "name", "sweep", "sync", "index", "annotation")

    def __init__(self, rec, name, sweep, sync):
        self.rec, self.name, self.sweep, self.sync = rec, name, sweep, sync

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        up = rec.spans[parent] if parent is not None else None
        fit = None if up is None else up.fit
        if self.name == FIT:
            fit = rec._fits
            rec._fits += 1
        sweep = self.sweep
        if sweep is None and up is not None:
            sweep = up.sweep
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(rec.spans)
        rec._open.append(self.index)
        rec.spans.append(Span(self.name, parent, fit, sweep,
                              time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        self.rec.spans[self.index].t1_ns = time.perf_counter_ns()
        self.rec._open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        return False


def span(name: str, sweep: Optional[int] = None, sync=None):
    """A context that records the block as span ``name`` while
    recording (``sweep`` sets the sweep index of it and the spans inside
    it; ``sync``, a device, synchronizes a CUDA device at its end), and
    does nothing otherwise."""
    if _recording is None:
        return _NOOP
    if sync is not None and torch.device(sync).type != "cuda":
        sync = None
    return _Open(_recording, name, sweep, sync)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block; yields the
    ``Recording``."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
