"""A whole run on the CPU with the timed path broken underneath: each
fault the cells can have must turn ``correct`` false.  (The exchange
between chips has no fault here: every cell runs on one card.)"""

import time

import pytest
import torch
from conftest import TINY
from fmbench import cell


def run(workload):
    result, _ = cell.run_cell(workload, 2 ** 31 + 99, 0.5, False,
                              time.perf_counter(), device="cpu",
                              overrides=TINY)
    return result


@pytest.mark.parametrize("workload", ["ml10m_r128.chain", "ml10m_r32.libfm"])
def test_a_sweep_that_returns_its_state_unchanged(monkeypatch, workload):
    from myfm_tpu_torch import trainer

    monkeypatch.setattr(trainer, "categorical_sweep",
                        lambda plan, state, *a, **k: state)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["weight_gap_sd"]["value"] > 1


@pytest.mark.parametrize("workload", ["ml10m_r128.chain", "ml10m_r32.libfm"])
def test_half_the_rows_left_out_and_the_rest_doubled(monkeypatch, workload):
    from myfm_tpu_torch.ops import categorical

    inner = categorical.fused_tile_gram_cross

    def half(aux2, gths, wvsl, ci, co, ls, S, carry=None, **kw):
        aux2 = aux2.clone()
        aux2[:, 0, 1::2] = S  # every other row of a tile reads as padding
        flat, carry_out = inner(aux2, gths, wvsl, ci, co, ls, S,
                                None if carry is None else carry / 2, **kw)
        return 2 * flat, 2 * carry_out

    monkeypatch.setattr(categorical, "fused_tile_gram_cross", half)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["weight_gap_sd"]["value"] > 1


@pytest.mark.parametrize("workload", ["ml10m_r128.chain",
                                      "ml10m_r128.libfm", "ml10m_r32.libfm"])
def test_one_drawn_factor_altered_where_it_is_drawn(monkeypatch, workload):
    from myfm_tpu_torch.ops import categorical

    inner = categorical._entity_draws

    def altered(*a, **k):
        w, V, parts = inner(*a, **k)
        V = V.clone()
        V[-1, -1] += 1.0
        return w, V, parts

    monkeypatch.setattr(categorical, "_entity_draws", altered)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["weight_gap_sd"]["at"].startswith("V")


@pytest.mark.parametrize("workload", ["ml10m_r128.libfm", "ml10m_r32.libfm"])
def test_one_held_out_score_altered_where_it_is_scored(monkeypatch,
                                                       workload):
    from myfm_tpu_torch.utils.callbacks import libfm

    inner = libfm.predict_score

    def altered(*a, **k):
        score = inner(*a, **k).clone()
        score[0] += 1e-2
        return score

    monkeypatch.setattr(libfm, "predict_score", altered)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] >= 1e-2 * 0.99
    assert torch.isfinite(torch.tensor(result["checks"]["rmse_gap"]["value"]))
