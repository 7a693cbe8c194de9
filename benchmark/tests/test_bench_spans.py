"""The span reader (fmbench/spans.py) on hand-made timelines and
recordings, and on a recording of a CPU run of a cell."""

import time
from types import SimpleNamespace

import pytest
from conftest import TINY
from fmbench import cell, spans, trace
from torch.autograd import DeviceType


def ev(name, start, end, device=False, id=0):
    return SimpleNamespace(
        name=name, id=id, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def timeline():
    """A slice of 100 µs: a bench.sweep range holding the program's sweep
    spans, a callback; kernels with their launches."""
    return [
        ev(trace.SLICE, 0, 100),
        ev("bench.sweep", 0, 50),
        ev("myfm.sweep", 1, 49),
        ev("myfm.sweep.gather", 2, 10),
        ev("myfm.sweep.kernel1", 10, 20),
        ev("myfm.loop.harvest", 50, 60),
        ev("myfm.loop.drain", 52, 58),
        ev("bench.callback", 60, 95),
        ev("myfm.eval.metrics", 61, 94),
        ev("myfm.eval.score", 62, 64),
        # the annotations' device-side ranges are not operations
        ev("myfm.sweep.gather", 12, 40, device=True),
        ev("bench.sweep", 12, 48, device=True),
        # launches (runtime calls, one correlation id each) and kernels
        ev("cudaLaunchKernel", 3, 4, id=7),
        ev("void index_elementwise_kernel<128, 4>", 12, 30, device=True,
           id=7),
        ev("cudaLaunchKernel", 11, 12, id=8),
        ev("void gram_wgmma_tile_kernel<float, 2>(float)", 30, 40,
           device=True, id=8),
        ev("cudaMemcpyAsync", 53, 54, id=9),
        ev("Memcpy DtoH (Device -> Pinned)", 54, 56, device=True, id=9),
        ev("cudaLaunchKernel", 63, 63.5, id=10),
        ev("void gemv2N_kernel", 65, 70, device=True, id=10),
        # a kernel no launch of the trace holds
        ev("void elementwise_kernel", 96, 98, device=True, id=11),
        # kernels the trace holds outside the slice
        ev("void carry_walk_kernel<float>(float*)", -5, -3, device=True),
        ev("void elementwise_kernel", 101, 104, device=True),
        # an aten op sharing a kernel's correlation number is no launch
        ev("aten::index", 20, 21, id=11),
    ]


def test_device_split_attributes_kernels_to_their_launching_span():
    s = spans.device_split(timeline())
    assert s["span_device_ms"] == {
        "myfm.sweep.gather": 0.018, "myfm.sweep.kernel1": 0.010,
        "myfm.eval.score": 0.005, "myfm.loop.drain": 0.002,
        spans.UNATTRIBUTED: 0.002}
    # the same operations as device_s, which leaves the annotations out
    assert abs(s["device_s"] - 37e-6) < 1e-15
    assert abs(s["kernel1_slice_ms"] - 0.010) < 1e-12
    assert s["outside_ms"] == dict(before=0.002, after=0.003)


def test_idle_gaps_take_the_innermost_span():
    s = spans.device_split(timeline())
    # gaps: 70-96 (inside the callback's metrics span), 40-54 (the
    # sweep), 0-12 (the slice's start: the profiler's), 56-65 (it starts
    # inside the drain), 98-100 (no span: the loop)
    assert s["idle_gaps"] == [
        ["myfm.eval.metrics", 26e-6], ["myfm.sweep", 14e-6],
        [trace.SLICE, 12e-6], ["myfm.loop.drain", 9e-6],
        ["loop", 2e-6]]
    assert s["idle_gap_at_ms"] == [0.07, 0.04, 0.0, 0.056, 0.098]
    # their middles: 83 (the metrics), 47 (the sweep), 6 (the gather),
    # 60.5 (the callback) and 99 (the loop)
    assert s["idle_gap_mid"] == ["myfm.eval.metrics", "myfm.sweep",
                                 "myfm.sweep.gather", "bench.callback",
                                 "loop"]
    # a gap from 0.5 to 12 starts inside the bench.sweep range alone
    events = timeline()
    events.insert(1, ev("void k", 0, 0.5, device=True))
    assert spans.device_split(events)["idle_gaps"][2] == ["bench.sweep",
                                                          11.5e-6]


def test_nest_walks_up_to_the_span_holding_the_point():
    nest = trace.Nest([(0, 100, "a"), (10, 20, "b"), (12, 14, "c"),
                       (30, 90, "d")])
    assert nest.at(13, "-") == "c"
    assert nest.at(16, "-") == "b"
    assert nest.at(25, "-") == "a"
    assert nest.at(95, "-") == "a"
    assert nest.at(100, "-") == "-" and nest.at(-1, "-") == "-"


def span(name, parent, fit, sweep, t0_ms, t1_ms):
    return SimpleNamespace(name=name, parent=parent, fit=fit, sweep=sweep,
                           t0_ns=int(t0_ms * 1e6), t1_ns=int(t1_ms * 1e6))


def recording(n_sweeps=6, eval_spans=True):
    """Two fits; the second (the measured one) runs ``n_sweeps`` sweeps
    of 10 ms: 3 ms of it in myfm.sweep, a harvest of 2 ms holding a
    drain of 1, a callback of 4 holding the metrics (3, of it 1 the
    score)."""
    out = [span("myfm.fit", None, 0, None, 0, 5),
           span("myfm.plan.fingerprint", 0, 0, None, 0, 1),
           span("myfm.fit", None, 1, None, 10, 200)]
    out.append(span("myfm.plan.fingerprint", 2, 1, None, 10, 10.5))
    for i in range(n_sweeps):
        t = 20 + 10 * i
        it = len(out)
        out.append(span("myfm.loop.iter", 2, 1, i, t, t + 10))
        out.append(span("myfm.sweep", it, 1, i, t, t + 3))
        h = len(out)
        out.append(span("myfm.loop.harvest", it, 1, i, t + 3, t + 5))
        out.append(span("myfm.loop.drain", h, 1, i, t + 3.5, t + 4.5))
        if eval_spans:
            c = len(out)
            out.append(span("myfm.loop.callback", it, 1, i, t + 5, t + 9))
            m = len(out)
            out.append(span("myfm.eval.metrics", c, 1, i, t + 5, t + 8))
            out.append(span("myfm.eval.score", m, 1, i, t + 5, t + 6))
    return out


def test_host_metrics_take_the_measured_fit_outside_the_slice():
    rec = recording()
    split = dict(span_device_ms={"myfm.sweep.gather": 12.0,
                                 "myfm.sweep.variates": 1.0,
                                 "myfm.sweep.hypers": 2.0,
                                 "myfm.eval.score": 4.0})
    m = spans.metrics(rec, split, window_sweeps=5, slice_after=2,
                      slice_sweeps=2)
    assert spans.measured_sweeps(rec, 5, 2, 2) == (1, [1, 5])
    assert m["plan.fingerprint_s"] == pytest.approx(0.0005)
    assert m["loop.harvest_ms"] == pytest.approx(2.0)
    assert m["sweep.enqueue_ms"] == pytest.approx(3.0)
    # the iteration's own time: 10 less sweep, harvest and callback
    assert m["loop.self_ms"] == pytest.approx(1.0)
    # the metrics' own time: 3 less the score's 1
    assert m["eval.metrics_ms"] == pytest.approx(2.0)
    assert m["sweep.gather_device_ms"] == pytest.approx(6.0)
    assert m["sweep.hypers_device_ms"] == pytest.approx(1.5)
    assert m["eval.score_device_ms"] == pytest.approx(2.0)
    assert m["sweep.finalize_device_ms"] is None
    assert m["sweep.draws_device_ms"] is None
    assert spans.spans_per_sweep(rec, 1, [1, 5]) == 7


def test_metrics_are_none_where_their_spans_are_absent():
    m = spans.metrics(recording(eval_spans=False), None, 5, 2, 2)
    assert m["eval.metrics_ms"] is None
    assert all(m[k] is None for k in spans.DEVICE_METRICS)
    assert m["loop.harvest_ms"] == pytest.approx(2.0)
    empty = spans.metrics([], None, 5, 2, 2)
    assert set(empty) == {"plan.fingerprint_s", *spans.HOST_METRICS,
                          *spans.DEVICE_METRICS}
    assert all(v is None for v in empty.values())


@pytest.mark.parametrize("workload", ["ml10m_r32.chain",
                                      "ml10m_r128.libfm"])
def test_a_recorded_cpu_run_gives_the_host_metrics(workload):
    from myfm_tpu_torch import tracing

    with tracing.recording() as rec:
        result, observed = cell.run_cell(
            workload, 2 ** 31 + 11, 1.0, False, time.perf_counter(),
            device="cpu", overrides=TINY)
    assert result["correct"]
    n = observed["window_sweeps"]
    fit, sweeps = spans.measured_sweeps(rec.spans, n, cell.SLICE_AFTER, 2)
    assert fit == 1 and sweeps and max(sweeps) == n
    m = spans.metrics(rec.spans, None, n, cell.SLICE_AFTER, 2)
    for name in ("plan.fingerprint_s", "loop.harvest_ms", "loop.self_ms",
                 "sweep.enqueue_ms"):
        assert m[name] is not None and m[name] > 0, name
    assert (m["eval.metrics_ms"] is not None) == workload.endswith("libfm")
    # the cold fit built the plan, the measured fit found it
    builds = [s.fit for s in rec.spans if s.name == "myfm.plan.build"]
    assert builds == [0]


def reader(name):
    import importlib.util

    from fmbench import registry

    path = registry.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_span_metrics_give_none_when_nothing_was_recorded():
    harvest = reader("loop.harvest_ms")
    gather = reader("sweep.gather_device_ms")
    # an untraced run's readings: no recording, no trace
    assert harvest.read(dict(window_sweeps=5)) is None
    assert gather.read(dict(window_sweeps=5)) is None
    # a recording without the measured fit's sweeps, a slice without
    # the span
    assert harvest.read(dict(spans=dict(records=[], fit=None,
                                        sweeps=[]))) is None
    assert gather.read(dict(trace=dict(span_device_ms={}, sweeps=2))) is None


def test_span_metrics_read_what_the_span_tool_reads():
    rec = recording()
    fit, sweeps = spans.measured_sweeps(rec, 5, 2, 2)
    split = dict(span_device_ms={"myfm.sweep.gather": 12.0})
    want = spans.metrics(rec, split, 5, 2, 2)
    observed = dict(spans=dict(records=rec, fit=fit, sweeps=sweeps),
                    trace=dict(span_device_ms=split["span_device_ms"],
                               sweeps=2))
    assert reader("loop.harvest_ms").read(observed) == want["loop.harvest_ms"]
    assert reader("sweep.gather_device_ms").read(observed) == \
        want["sweep.gather_device_ms"]


def test_host_ms_by_name_is_host_ms_of_each_name():
    rec = recording()
    fit, sweeps = spans.measured_sweeps(rec, 5, 2, 2)
    by_name = spans.host_ms_by_name(rec, fit, sweeps)
    assert set(by_name) == {s.name for s in rec if s.fit == fit
                            and s.sweep in sweeps}
    for name, (total, own) in by_name.items():
        assert total == spans.host_ms(rec, fit, sweeps, (name,))
        assert own == spans.host_ms(rec, fit, sweeps, (name,), own=True)


def test_a_traced_cpu_run_records_spans_for_the_readers(monkeypatch):
    """A traced run (its device readings stubbed: the CPU's trace holds no
    device operation) records the spans from before the cold fit, keeps
    the measured fit's host ms by span, reads the declared counters and
    gives the span and counter metrics; an untraced run records none."""
    from myfm_tpu_torch import tracing

    monkeypatch.setattr(trace, "summarize", lambda events, top=10: dict(
        window_s=1.0, busy_s=0.5, device_s=0.5, kernel_ms={}, device_ops=[],
        idle_gaps=[], kernel1_device_ms=0.0, kernel1_passes=0,
        kernel1_carries=0))
    monkeypatch.setattr(spans, "device_split", lambda events: dict(
        span_device_ms={"myfm.sweep.gather": 3.0}))
    result, observed = cell.run_cell(
        "ml10m_r128.libfm", 2 ** 31 + 5, 4.0, True, time.perf_counter(),
        device="cpu", overrides=TINY)
    assert result["correct"]
    recorded = observed["spans"]
    assert recorded["fit"] == 1 and recorded["sweeps"]
    assert min(s.fit for s in recorded["records"] if s.fit is not None) == 0
    for name in ("myfm.sweep", "myfm.loop.harvest", "myfm.eval.metrics"):
        total, own = recorded["host_ms"][name]
        assert total >= own > 0, name
    assert observed["counters"] == {"entity_draws.launches": (0, 0)}
    metrics = result["metrics"]
    assert metrics["draws.launches_per_sweep"]["value"] == 0.0
    assert metrics["sweep.gather_device_ms"]["value"] == \
        3.0 / observed["trace"]["sweeps"]
    assert metrics["loop.harvest_ms"]["value"] > 0
    assert tracing._recording is None
    _, untraced = cell.run_cell(
        "ml10m_r128.libfm", 2 ** 31 + 5, 0.5, False, time.perf_counter(),
        device="cpu", overrides=TINY)
    assert "spans" not in untraced and "trace" not in untraced
