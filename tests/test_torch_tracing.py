"""The port's spans (myfm_tpu_torch/tracing.py).

* Hand-timed spans nest as opened: each records its parent, the fit and
  sweep it belongs to, and ``summary()`` gives calls, total and self ms.
* With tracing off nothing is recorded and ``record_function`` is never
  entered, a CPU profiler running or not.
* Under a CPU ``torch.profiler`` the recorded spans are profiler events
  under their names, nested as they were opened.
* A same-seed fit on a small one-hot design keeps bit-identical samples
  and hyperparameter trace with recording on and off, and records per
  sweep one gather, one kernel-1 span and one finalize per kernel-1 call
  (on the CPU kernel 1 runs its plain version, which its launch counters
  leave out: the calls are counted by a wrapper and against the plan's
  chunks) and one ``myfm.sweep.draws`` per table.
* The libFM callback records its device score, its wait and its host
  metrics once a sweep.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from myfm_tpu_torch import (
    MyFMGibbsRegressor,
    RelationBlock,
    clear_plan_cache,
    tracing,
)
from myfm_tpu_torch.design_cache import _CACHE
from myfm_tpu_torch.ops import categorical
from myfm_tpu_torch.utils.callbacks import RegressionCallback

N_ITER = 5


class _Clock:
    """A perf_counter_ns the test moves by hand."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns


def test_spans_nest_and_sum(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing.time, "perf_counter_ns", clock)
    ms = 1_000_000
    with tracing.recording() as rec:
        with tracing.span("myfm.outer"):
            clock.ns += 1 * ms
            with tracing.span(tracing.FIT):
                with tracing.span("myfm.loop.iter", sweep=3):
                    clock.ns += 2 * ms
                    with tracing.span("myfm.leaf"):
                        clock.ns += 4 * ms
                    with tracing.span("myfm.leaf"):
                        clock.ns += 8 * ms
                clock.ns += 16 * ms
            with tracing.span(tracing.FIT):
                with tracing.span("myfm.leaf"):
                    clock.ns += 32 * ms
    names = [s.name for s in rec.spans]
    assert names == ["myfm.outer", "myfm.fit", "myfm.loop.iter",
                     "myfm.leaf", "myfm.leaf", "myfm.fit", "myfm.leaf"]
    assert [s.parent for s in rec.spans] == [None, 0, 1, 2, 2, 0, 5]
    assert [s.fit for s in rec.spans] == [None, 0, 0, 0, 0, 1, 1]
    assert [s.sweep for s in rec.spans] == [None, None, 3, 3, 3, None,
                                            None]
    assert [s.ms for s in rec.spans] == [63, 30, 14, 4, 8, 32, 32]
    summary = rec.summary()
    assert summary["myfm.outer"] == dict(calls=1, total_ms=63.0,
                                         self_ms=1.0)
    assert summary["myfm.fit"] == dict(calls=2, total_ms=62.0,
                                       self_ms=16.0)
    assert summary["myfm.loop.iter"] == dict(calls=1, total_ms=14.0,
                                             self_ms=2.0)
    assert summary["myfm.leaf"] == dict(calls=3, total_ms=44.0,
                                        self_ms=44.0)


def test_open_spans_are_left_out_and_recordings_do_not_nest():
    with tracing.recording() as rec:
        with tracing.span("myfm.closed"):
            pass
        open_span = tracing.span("myfm.open")
        open_span.__enter__()
        assert set(rec.summary()) == {"myfm.closed"}
        open_span.__exit__(None, None, None)
        with pytest.raises(RuntimeError, match="already"):
            with tracing.recording():
                pass
    assert set(rec.summary()) == {"myfm.closed", "myfm.open"}
    assert tracing._recording is None


@pytest.mark.parametrize("profiling", [False, True])
def test_off_records_nothing_and_never_annotates(monkeypatch, profiling):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    # a recording made and closed before: nothing reaches it afterwards
    with tracing.recording() as before:
        pass
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    if profiling:
        prof.__enter__()
    try:
        contexts = {id(tracing.span(f"myfm.s{i}", sweep=i, sync="cpu"))
                    for i in range(3)}
        with tracing.span("myfm.a"):
            with tracing.span("myfm.b"):
                pass
    finally:
        if profiling:
            prof.__exit__(None, None, None)
    assert contexts == {id(tracing._NOOP)}
    assert before.spans == [] and before.summary() == {}


def test_spans_are_profiler_events_nested_as_opened():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with tracing.recording() as rec:
        with torch.profiler.profile(activities=acts) as prof:
            with tracing.span("myfm.outer"):
                with tracing.span("myfm.middle"):
                    torch.ones(8).add_(1)
                    with tracing.span("myfm.inner"):
                        torch.ones(8).mul_(2)
                with tracing.span("myfm.second"):
                    pass
    assert [s.name for s in rec.spans] == ["myfm.outer", "myfm.middle",
                                           "myfm.inner", "myfm.second"]
    events = {e.name: e for e in prof.events() if e.name.startswith("myfm.")}
    assert set(events) == {"myfm.outer", "myfm.middle", "myfm.inner",
                           "myfm.second"}
    for child, parent in (("myfm.middle", "myfm.outer"),
                          ("myfm.inner", "myfm.middle"),
                          ("myfm.second", "myfm.outer")):
        c, p = events[child], events[parent]
        assert c.cpu_parent is not None and c.cpu_parent.name == parent
        assert p.time_range.start <= c.time_range.start
        assert c.time_range.end <= p.time_range.end
    assert (events["myfm.middle"].time_range.end
            <= events["myfm.second"].time_range.start)


def _design(n=400, n_days=7, n_users=23, n_items=17, seed=0):
    """A date one-hot X plus user and item RelationBlocks."""
    rng = np.random.RandomState(seed)
    d = rng.randint(0, n_days, n)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    X = sps.csr_matrix((np.ones(n), (np.arange(n), d)), shape=(n, n_days))
    blocks = [RelationBlock(u, sps.identity(n_users, format="csr")),
              RelationBlock(i, sps.identity(n_items, format="csr"))]
    y = (3 + rng.normal(size=n_users)[u] + rng.normal(size=n_items)[i]
         + 0.3 * rng.normal(size=n))
    grouping = [0] * n_days + [1] * n_users + [2] * n_items
    return X, blocks, y, grouping


class _Kernel1Calls:
    """Counts the sweep's kernel-1 calls."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def _fit(monkeypatch, callback=None, record=False):
    X, blocks, y, grouping = _design()
    counter = _Kernel1Calls(categorical.fused_tile_gram_cross)
    monkeypatch.setattr(categorical, "fused_tile_gram_cross", counter)
    clear_plan_cache()
    fm = MyFMGibbsRegressor(rank=3, random_seed=11, device="cpu")
    rec = None
    if record:
        with tracing.recording() as rec:
            fm.fit(X, y, X_rel=blocks, n_iter=N_ITER, grouping=grouping,
                   callback=callback)
    else:
        fm.fit(X, y, X_rel=blocks, n_iter=N_ITER, grouping=grouping,
               callback=callback)
    assert fm.history_.engine == "fastpath"
    cat_plan = next(p for (kind, _, _), p in _CACHE.items()
                    if kind == "cat_gibbs")
    return fm, rec, counter.calls, cat_plan


def _per_sweep(rec, name):
    counts = [0] * N_ITER
    for s in rec.spans:
        if s.name == name:
            counts[s.sweep] += 1
    return counts


def test_recording_leaves_the_chain_bit_identical(monkeypatch):
    off, _, _, _ = _fit(monkeypatch)
    on, rec, _, _ = _fit(monkeypatch, record=True)
    assert len(rec.spans) > 0
    assert len(off.predictor_.samples) == len(on.predictor_.samples) == N_ITER
    for a, b in zip(off.predictor_.samples, on.predictor_.samples):
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.V, b.V)
    for a, b in zip(off.history_.hypers, on.history_.hypers):
        assert a.alpha == b.alpha
        for k in ("mu_w", "lambda_w", "mu_V", "lambda_V"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_fit_records_its_spans_per_sweep(monkeypatch):
    fm, rec, kernel1_calls, cat_plan = _fit(monkeypatch, record=True)
    chunks = sum(-(-t.n_tiles // t.chunk_tiles) for t in cat_plan.tables)
    n_tables = len(cat_plan.tables)
    assert kernel1_calls == N_ITER * chunks
    for name in ("myfm.sweep.gather", "myfm.sweep.kernel1",
                 "myfm.sweep.finalize"):
        assert _per_sweep(rec, name) == [chunks] * N_ITER, name
    for name, each in (("myfm.sweep.draws", n_tables),
                       ("myfm.sweep.table", n_tables),
                       ("myfm.loop.iter", 1), ("myfm.sweep", 1),
                       ("myfm.sweep.variates", 1), ("myfm.sweep.hypers", 1),
                       ("myfm.sweep.eff", 1), ("myfm.loop.callback", 1)):
        assert _per_sweep(rec, name) == [each] * N_ITER, name
    summary = rec.summary()
    for name in ("myfm.fit", "myfm.plan.fingerprint", "myfm.plan.build",
                 "myfm.loop.init", "myfm.plan.counts", "myfm.plan.finalize"):
        assert summary[name]["calls"] == (
            n_tables if name.startswith("myfm.plan.") and name not in (
                "myfm.plan.fingerprint", "myfm.plan.build") else 1), name
    by_index = rec.spans
    for s in by_index:
        assert s.name.startswith("myfm.") and s.t1_ns >= s.t0_ns
        assert s.fit == 0
        if s.name == "myfm.sweep.kernel1":
            chain = []
            p = s.parent
            while p is not None:
                chain.append(by_index[p].name)
                p = by_index[p].parent
            assert chain == ["myfm.sweep.table", "myfm.sweep",
                             "myfm.loop.iter", "myfm.fit"]
    # the spans a sweep opens: 7 of the loop and the sweep, 2 a table, 3
    # a kernel-1 call (on the card 2 more: the harvest's two drains)
    per_sweep = sum(1 for s in rec.spans if s.sweep is not None) / N_ITER
    assert per_sweep == 7 + 3 * chunks + 2 * n_tables


def test_libfm_callback_records_score_wait_and_metrics(monkeypatch):
    X, blocks, y, _ = _design(seed=1)
    cb = RegressionCallback(N_ITER, X, y, X_rel_test=blocks, clip_min=1.0,
                            clip_max=5.0)
    fm, rec, _, _ = _fit(monkeypatch, callback=cb, record=True)
    assert len(cb.result_trace) == N_ITER
    for name in ("myfm.eval.score", "myfm.eval.wait", "myfm.eval.metrics"):
        assert _per_sweep(rec, name) == [1] * N_ITER, name
    for s in rec.spans:
        if s.name in ("myfm.eval.score", "myfm.eval.wait"):
            assert rec.spans[s.parent].name == "myfm.eval.metrics"
        if s.name == "myfm.eval.metrics":
            assert rec.spans[s.parent].name == "myfm.loop.callback"
    summary = rec.summary()["myfm.eval.metrics"]
    assert 0 <= summary["self_ms"] <= summary["total_ms"]
