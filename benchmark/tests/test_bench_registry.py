"""The harness finds every piece of a cell by the names BENCHMARK.json
gives, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest
from fmbench import registry

SPEC = registry.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_pieces_found_by_name(workload):
    cell = registry.cell(workload, SPEC)
    entry = cell["entry"]
    assert cell["config"]["name"] == entry["config"]
    assert cell["traffic"]["name"] == entry["traffic"]
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s",
                                                        "sweeps_per_s"}
    assert cell["per_layer"] and set(cell["readers"]) == {
        m["name"] for m in cell["per_layer"]}
    for reader in cell["readers"].values():
        assert callable(reader.read)
    assert {"weight_gap_sd", "hyper_gap_sd"} <= set(cell["limits"])
    reference = registry.reference(cell["config"])
    for name in ("design", "sweep", "forward", "sweep_flops", "WEIGHTS",
                 "HYPERS", "widest_gap_sd", "rmse"):
        assert hasattr(reference, name), name
    for key, path in cell["counters"].items():
        assert NAME.match(key) and ":" in path


def test_a_metric_listing_cells_is_read_only_there():
    libfm = registry.cell("ml10m_r128.libfm", SPEC)
    chain = registry.cell("ml10m_r128.chain", SPEC)
    assert "eval.callback_ms" in libfm["readers"]
    assert "eval.callback_ms" not in chain["readers"]


def test_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(registry.ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves
    assert len(json.dumps(SPEC)) < 64 * 1024
