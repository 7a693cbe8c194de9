"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A workload names a configuration and a traffic mix; each lives in a file
of its own (``configs/<name>.json``, ``traffic/<name>.json``), each
per-layer metric has a reader ``metrics/<name>.py`` with a function
``read(observed)`` (and, where it reads program counters, a
module-level ``COUNTERS``), each cell's comparison limits sit in
``limits/<workload>.json``, and a configuration names its plain
reference, a module ``configs/<reference>.py`` that also builds the
configuration's design (``design``, ``sweep``, ``forward``,
``sweep_flops``).  Adding a cell, a mix, a metric or a configuration
adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(workload: str, spec: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything a run of ``workload`` reads: its BENCHMARK.json entry,
    configuration, traffic mix, limits, the end-to-end metrics it
    reports, the per-layer readers that list it (or list no cell) and
    the program counters those readers declare (a reader's module-level
    ``COUNTERS``, {key: "<module>:<attribute path>"})."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = _json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in spec["end_to_end"] if reports(m)]
    readers = {
        m["name"]: _module(bench_dir / "metrics" / f"{m['name']}.py",
                           f"fmbench_metric_{i}")
        for i, m in enumerate(spec["per_layer"]) if reports(m)
    }
    counters = {}
    for reader in readers.values():
        counters.update(getattr(reader, "COUNTERS", {}))
    return dict(
        entry=entry, config=config, traffic=traffic,
        limits=_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=end_to_end,
        per_layer=[m for m in spec["per_layer"] if reports(m)],
        readers=readers, counters=counters,
    )


def reference(config: dict, bench_dir: Path = BENCH_DIR):
    """The configuration's plain reference module."""
    return _module(bench_dir / "configs" / f"{config['reference']}.py",
                   f"fmbench_reference_{config['reference']}")
