"""The port's libFM evaluation callbacks against the JAX package's.

Three checks:

* the same sequence of ``FM`` samples and hyperparameters through the
  JAX and the port callbacks of each kind gives the same
  ``result_trace`` (rtol 1e-12, fp64), the same descriptions and the
  same CSV text, the NaN fields of the first sweeps included;
* a CPU fit of 6 sweeps through each port callback scores the test set
  on the chain's device (``_device_plan`` built there), equal to the
  numpy forward ``fm.predict_score`` within 1e-10 in fp64;
* a pickle round trip drops the device plan and goes on scoring.
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import myfm_tpu.containers as jcont
import myfm_tpu.utils.callbacks as jcb
import myfm_tpu_torch.containers as tcont
import myfm_tpu_torch.utils.callbacks as tcb
from myfm_tpu import RelationBlock as JBlock
from myfm_tpu_torch import (
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
    RelationBlock,
)

N_CLASS = 4


def _design(n, n_days=6, n_users=9, n_items=7, seed=0, block=RelationBlock):
    """A date one-hot main table plus user and item RelationBlocks (the
    ML-10M protocol's shape at toy size) and a rating-like target."""
    rng = np.random.RandomState(seed)
    d = rng.randint(0, n_days, n)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    X = sps.csr_matrix((np.ones(n), (np.arange(n), d)), shape=(n, n_days))
    blocks = [block(u, sps.identity(n_users, format="csr")),
              block(i, sps.identity(n_items, format="csr"))]
    y = (3 + rng.normal(size=n_users)[u] + rng.normal(size=n_items)[i]
         + 0.3 * rng.normal(size=n))
    return X, blocks, y


def _target(task, y):
    if task == "regression":
        return y
    if task == "classification":
        return (y >= np.median(y)).astype(np.int64)
    return np.digitize(y, np.quantile(y, [0.25, 0.5, 0.75])).astype(np.int64)


def _callbacks(mod, task, X, blocks, y, trace_path=None):
    if task == "regression":
        return mod.RegressionCallback(7, X, y, X_rel_test=blocks,
                                      clip_min=1.5, clip_max=4.5,
                                      trace_path=trace_path)
    if task == "classification":
        return mod.ClassificationCallback(7, X, y, X_rel_test=blocks,
                                          trace_path=trace_path)
    return mod.OrderedProbitCallback(7, X, y, N_CLASS, X_rel_test=blocks,
                                     trace_path=trace_path)


@pytest.mark.parametrize("task", ["regression", "classification",
                                  "ordered"])
def test_trace_descriptions_and_csv_match_jax(task, tmp_path):
    X, blocks, y = _design(50, seed=1)
    _, jblocks, _ = _design(50, seed=1, block=JBlock)
    y = _target(task, y)
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)
    paths = [tmp_path / "jax.csv", tmp_path / "port.csv"]
    jc = _callbacks(jcb, task, X, jblocks, y, paths[0])
    tc = _callbacks(tcb, task, X, blocks, y, paths[1])
    rng = np.random.RandomState(2)
    for it in range(7):  # sweeps 0..4 leave *_all_but_5 NaN
        w0 = 3 + 0.2 * rng.normal()
        w = 0.5 * rng.normal(size=n_features)
        V = 0.3 * rng.normal(size=(n_features, 3))
        cuts = [np.sort(rng.normal(size=N_CLASS - 1))] if task == \
            "ordered" else None
        hyper = dict(alpha=float(rng.gamma(2.0)), mu_w=np.zeros(3),
                     lambda_w=np.ones(3), mu_V=np.zeros((3, 3)),
                     lambda_V=np.ones((3, 3)))
        jstop, jdesc = jc(it, jcont.FM(w0, w, V, cuts),
                          jcont.FMHyperParameters(**hyper), None)
        tstop, tdesc = tc(it, tcont.FM(w0, w, V, cuts),
                          tcont.FMHyperParameters(**hyper), None)
        assert (tstop, tdesc) == (jstop, jdesc)
    assert tc._device_plan is None  # plain FMs take the numpy forward
    assert len(tc.result_trace) == len(jc.result_trace) == 7
    for t_row, j_row in zip(tc.result_trace, jc.result_trace):
        assert list(t_row) == list(j_row)
        np.testing.assert_allclose(list(t_row.values()),
                                   list(j_row.values()), rtol=1e-12)
    text = paths[1].read_text()
    assert text == paths[0].read_text()
    assert text.splitlines()[1].endswith(",")  # NaN: an empty field
    np.testing.assert_allclose(tc.predictions, jc.predictions, rtol=1e-12)


_ESTIMATORS = {
    "regression": MyFMGibbsRegressor,
    "classification": MyFMGibbsClassifier,
    "ordered": MyFMOrderedProbit,
}


def _spy_views(cb):
    """Record every view the fit hands the callback and the device score
    the callback took of it."""
    seen = []
    orig = cb._score_on_device

    def spy(fm):
        score = orig(fm)
        seen.append((fm.materialize(), score))
        return score

    cb._score_on_device = spy
    return seen


def _fit_with_callback(task, sweep_strategy):
    X, blocks, y = _design(240, seed=3)
    Xt, bt, yt = _design(60, seed=4)
    y, yt = _target(task, y), _target(task, yt)
    cb = _callbacks(tcb, task, Xt, bt, yt)
    seen = _spy_views(cb)
    fm = _ESTIMATORS[task](
        rank=3, random_seed=5, dtype=np.float64, device="cpu",
        sweep_strategy=sweep_strategy,
    ).fit(X, y, X_rel=blocks, n_iter=6, n_kept_samples=1, callback=cb)
    return fm, cb, seen, (Xt, bt, yt)


@pytest.mark.parametrize("sweep_strategy", ["auto", "colored"])
@pytest.mark.parametrize("task", ["regression", "classification",
                                  "ordered"])
def test_fit_scores_test_set_on_device(task, sweep_strategy):
    fm, cb, seen, (Xt, bt, yt) = _fit_with_callback(task, sweep_strategy)
    want_engine = "fastpath" if sweep_strategy == "auto" else "colored"
    assert fm.history_.engine == want_engine
    assert cb._device_plan is not None
    assert cb._device_plan.group_index.device.type == "cpu"
    assert len(seen) == len(cb.result_trace) == 6
    for view, score in seen:
        np.testing.assert_allclose(score, view.predict_score(Xt, bt),
                                   rtol=0, atol=1e-10)
    last = cb.result_trace[-1]
    assert all(np.isfinite(v) for v in last.values())
    assert all(np.isnan(row[k]) for row in cb.result_trace[:5]
               for k in row if k.endswith("all_but_5"))
    if task == "regression":
        # the one kept sample is the last sweep's
        pred = fm.predict(Xt, bt)
        assert abs(last["rmse_this"]
                   - np.sqrt(np.mean((pred - yt) ** 2))) < 1e-10
    elif task == "ordered":
        mean = cb.predictions / cb.n_samples
        np.testing.assert_allclose(mean.sum(axis=1), 1.0, atol=1e-12)
        np.testing.assert_allclose(
            fm.predict_proba(Xt, bt), seen[-1][0].oprobit_predict_proba(
                Xt, bt, 0), atol=1e-10)
    else:
        assert 0 <= last["accuracy"] <= 1


def test_pickle_drops_plan_and_keeps_scoring():
    fm, cb, seen, (Xt, bt, yt) = _fit_with_callback("regression", "auto")
    del cb._score_on_device  # the test's spy does not pickle
    state = fm.predictor_.samples[-1]
    cb2 = pickle.loads(pickle.dumps(cb))
    assert cb2._device_plan is None and cb._device_plan is not None
    np.testing.assert_array_equal(cb2.predictions, cb.predictions)
    np.testing.assert_equal(cb2.result_trace, cb.result_trace)

    class View(tcont.FM):
        """A view over the device state, as the trainer hands one."""

    view = View(state.w0, state.w, state.V)
    view._state = type("S", (), dict(
        w0=torch.tensor(state.w0, dtype=torch.float64),
        w=torch.from_numpy(state.w), V=torch.from_numpy(state.V)))
    score = cb2._score_on_device(view)
    assert cb2._device_plan is not None
    np.testing.assert_allclose(score, seen[-1][1], rtol=0, atol=1e-12)
    cb2(6, view, fm.history_.hypers[-1], fm.history_)
    assert cb2.n_samples == 7 and np.isfinite(cb2.result_trace[-1]["rmse"])


def test_device_failure_raises():
    X, blocks, y = _design(30, seed=6)
    cb = tcb.RegressionCallback(2, X, y, X_rel_test=blocks)
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)
    view = tcont.FM(0.0, np.zeros(n_features), np.zeros((n_features, 2)))
    # factors of the wrong shape: the device forward fails, and so does
    # the callback (no fallback to the host forward)
    view._state = type("S", (), dict(
        w0=torch.tensor(0.0, dtype=torch.float64),
        w=torch.zeros(n_features, dtype=torch.float64),
        V=torch.zeros(2 * n_features, dtype=torch.float64)))
    with pytest.raises(IndexError):
        cb(0, view, tcont.FMHyperParameters(1.0, *[np.zeros(1)] * 4), None)
