"""The trace reader on a hand-made timeline."""

from types import SimpleNamespace

from fmbench import trace
from torch.autograd import DeviceType


def ev(name, start, end, device=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_busy_idle_and_kernel1():
    events = [
        ev(trace.SLICE, 0, 100), ev(trace.SLICE, 10, 80, device=True),
        ev("bench.sweep", 0, 40), ev("bench.callback", 60, 90),
        ev("void gram_wgmma_tile_kernel<float, 2>(float)", 10, 30,
           device=True),
        ev("gather", 20, 50, device=True),
        ev("copy", 70, 80, device=True),
        # kernel 1's carry walk, past the slice's edge on the device's
        # clock: kernel 1 counts it, the busy time does not
        ev("void carry_walk_kernel<float>(float*)", 98, 104, device=True),
        ev("void gram_meta_tile_kernel<float>(float)", 1, 2, device=True),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == 100e-6 and s["busy_s"] == 53e-6
    assert abs(s["device_s"] - 63e-6) < 1e-15
    assert s["device_ops"][0] == ["gather", 30e-6]
    # gaps: 50-70 (the loop), 80-98 (in the callback), 2-10 and 0-1 (the
    # sweep)
    assert s["idle_gaps"] == [["loop", 20e-6], ["bench.callback", 18e-6],
                              ["bench.sweep", 8e-6], ["bench.sweep", 1e-6]]
    assert s["kernel1_passes"] == 1 and s["kernel1_carries"] == 1
    assert abs(s["kernel1_device_ms"] - 0.026) < 1e-12


def test_kernel1_roofline_takes_the_bounds_of_the_passes_held():
    import importlib.util

    from fmbench import registry

    path = registry.BENCH_DIR / "metrics" / "kernel1_roofline.py"
    spec = importlib.util.spec_from_file_location("k1_roofline", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    t = dict(kernel1_bound_ms=[0.01, 0.01, 0.01, 0.01],
             kernel1_device_ms=0.1, kernel1_passes=4)
    assert abs(reader.read(dict(trace=t)) - 40.0) < 1e-9
    # one call's kernels lost: three calls' bounds over their time
    t.update(kernel1_passes=3, kernel1_device_ms=0.075)
    assert abs(reader.read(dict(trace=t)) - 40.0) < 1e-9
    t.update(kernel1_passes=0)
    assert reader.read(dict(trace=t)) is None


def test_program_spans_are_no_operations_and_name_the_gaps():
    events = [
        ev(trace.SLICE, 0, 100),
        ev("bench.sweep", 0, 40), ev("myfm.sweep", 1, 39),
        ev("myfm.sweep.gather", 2, 12),
        # the spans' device-side annotations are not operations
        ev("myfm.sweep.gather", 5, 30, device=True),
        ev("myfm.sweep", 5, 60, device=True),
        ev("gather", 5, 20, device=True),
        ev("copy", 30, 60, device=True),
        ev("gather", 70, 72, device=True),
        ev("myfm.loop.harvest", 65, 80),
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == 47e-6 and abs(s["device_s"] - 47e-6) < 1e-15
    # every operation by name, not only the top ones
    assert s["kernel_ms"] == {"gather": 0.017, "copy": 0.030}
    assert trace.summarize(events, top=1)["kernel_ms"] == s["kernel_ms"]
    # gaps: 72-100 (it opens in the harvest), 60-70 (no span holds 60:
    # the loop), 20-30 (inside myfm.sweep, past its gather), 0-5 (in
    # bench.sweep alone)
    assert s["idle_gaps"] == [["myfm.loop.harvest", 28e-6], ["loop", 10e-6],
                              ["myfm.sweep", 10e-6], ["bench.sweep", 5e-6]]
