"""A whole run of a cell on the CPU at a small size (the harness's look
for a card skipped): the window stops the chain through its callback
with the pipelined harvest kept, and the comparison with the plain
reference passes."""

import time

import pytest
from conftest import TINY
from fmbench import cell, registry


def run(workload, **kw):
    return cell.run_cell(workload, 2 ** 31 + 7, 1.0, False,
                         time.perf_counter(), device="cpu",
                         overrides=TINY, **kw)


def test_chain_window_stops_the_fit_and_passes():
    result, observed = run("ml10m_r128.chain")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == observed["window_sweeps"] > 2
    assert observed["window_s"] >= 1.0
    assert len(observed["sweep_ms"]) == observed["window_sweeps"]
    assert set(result["metrics"]) == {"sweeps_per_s", "peak_device_gib",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["checks"]["carry_diff"]["value"] == 0.0


def test_libfm_window_keeps_the_async_harvest_and_passes():
    from myfm_tpu_torch import trainer

    drains = []

    class Spy(trainer._AsyncDrain):
        def __init__(self):
            drains.append(self)
            super().__init__()

    old, trainer._AsyncDrain = trainer._AsyncDrain, Spy
    try:
        result, observed = run("ml10m_r128.libfm")
    finally:
        trainer._AsyncDrain = old
    # the cold fit and the measured fit both harvest asynchronously
    assert len(drains) == 2
    assert result["correct"], result["checks"]
    assert {"score_gap", "rmse_gap"} <= set(result["checks"])
    assert len(observed["callback_s"]) == observed["window_sweeps"]


def test_window_takes_the_inner_callbacks_tag():
    class Tagged:
        allow_async_trace = True

    dev = cell.Device("cpu")
    assert cell.Window(dev, 1.0, None, dict).allow_async_trace
    assert cell.Window(dev, 1.0, Tagged(), dict).allow_async_trace
    assert not cell.Window(dev, 1.0, object(), dict).allow_async_trace


def test_seeds_take_large_numbers_and_repeat():
    big = 2 ** 31 + 12345
    assert cell.seeds(big, 16) == cell.seeds(big, 16)
    assert cell.seeds(big, 16) != cell.seeds(big + 1, 16)
    assert {cell.seeds(s, 16)[2] for s in range(200)} == set(range(2, 17))


def test_same_seed_same_ratings_and_same_degrees():
    import numpy as np
    from fmbench import data

    shape = dict(rows=5000, users=50, items=30, days=7, test_share=0.1)

    def ratings(seed):
        train, test = data.make_ratings(shape, seed, "cpu")
        assert len(train) == 4500 and len(test) == 500
        return [np.concatenate([getattr(train, k), getattr(test, k)])
                for k in ("user", "item", "y")]

    a, b, c = ratings(99), ratings(99), ratings(100)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert set(a[2]) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    # every seed gives the users and the items the same degrees, by
    # other ids
    for k, n in ((0, 50), (1, 30)):
        assert sorted(np.bincount(a[k], minlength=n)) == sorted(
            np.bincount(c[k], minlength=n))


@pytest.mark.cuda
def test_cell_on_the_card(card, tmp_path):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(cell.registry.BENCH_DIR / "run.py"),
         "--workload", "ml10m_r32.chain", "--seed", "3", "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=cell.registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_traced_slice_is_left_out_of_the_sweep_gaps():
    dev = cell.Device("cpu")
    window = cell.Window(dev, 3600.0, None, dict, slice_at=(2, 3),
                         kernel1=cell.Kernel1Bounds(None))
    for i in range(8):
        assert window(i, None, None, None) == (False, None)
    # the profiler starts after sweep 2's mark and stops after sweep 5's:
    # the gaps from mark 2 to mark 6 hold it
    assert window.slice_sweeps == 3 and window.profiled() == {2, 3, 4, 5}
    assert 0.0 < window.slice_s() < time.perf_counter() - window.t_open
    assert not window.kernel1.active


def test_declared_counter_is_read_at_the_windows_open_and_close(tmp_path):
    """A metric reader's COUNTERS: the window reads each at its open
    (after sweep 0) and its close (after sweep n); the probe counts the
    sweeps the harness's capture saw."""
    bench = registry.BENCH_DIR
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).symlink_to(bench / sub)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "probe.sweeps.py").write_text(
        'COUNTERS = {"sweeps": '
        '"myfm_tpu_torch.trainer:categorical_sweep.calls"}\n\n\n'
        "def read(observed):\n    return None\n")
    spec = dict(registry.load_spec(), per_layer=[dict(
        name="probe.sweeps", unit="sweeps", better="lower",
        source="program_counter", layer="loop", moves="sweeps_per_s")])
    assert registry.cell("ml10m_r32.chain", spec, tmp_path)["counters"] == {
        "sweeps": "myfm_tpu_torch.trainer:categorical_sweep.calls"}
    result, observed = cell.run_cell(
        "ml10m_r32.chain", 2 ** 31 + 7, 0.5, False, time.perf_counter(),
        device="cpu", spec=spec, bench_dir=tmp_path, overrides=TINY)
    n = observed["window_sweeps"]
    assert observed["counters"] == {"sweeps": (1, n + 1)}
    assert result["correct"]


def test_read_counter_copies_the_value():
    from myfm_tpu_torch.ops import gram

    path = "myfm_tpu_torch.ops.gram:fused_tile_gram_cross.mode_launches"
    value = cell.read_counter(path)
    assert value == gram.fused_tile_gram_cross.mode_launches
    assert value is not gram.fused_tile_gram_cross.mode_launches
