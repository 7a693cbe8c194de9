"""``VariationalFMRegressor`` of the port against the TPU package's: the
"auto" engine resolution, serving, the callback surface, and what
raises (tests/test_torch_vi_accuracy.py has the fitted accuracy;
test_torch_vi_classifier.py the classifier).
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import myfm_tpu
from myfm_tpu.containers import VariationalFM as JaxVFM
from myfm_tpu.predictor import VariationalPredictor as JaxVPredictor
from myfm_tpu_torch import (
    MyFMGibbsRegressor,
    VariationalFMClassifier,
    VariationalFMRegressor,
    VariationalPredictor,
)
from myfm_tpu_torch.containers import VariationalFM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


@pytest.fixture(scope="module")
def tiny():
    from ml_features import build_feature_blocks, load_movielens

    tr, te = load_movielens("tiny", 0, synthetic=True)
    Xtr, Xte, btr, bte, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    return (Xtr, btr, tr.rating.values, Xte, bte, te.rating.values,
            grouping)


def _onehot(n=300, n_u=30, n_i=20, seed=0):
    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    rows = np.arange(n)
    X = sps.hstack([sps.csr_matrix((np.ones(n), (rows, u)), (n, n_u)),
                    sps.csr_matrix((np.ones(n), (rows, i)), (n, n_i))],
                   format="csr")
    y = 3 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    return X, y + 0.3 * rng.normal(size=n), [n_u, n_i]


@pytest.mark.parametrize("design", ["onehot", "ea"])
def test_auto_resolves_fastpath_like_jax(tiny, design):
    if design == "onehot":
        X, y, shapes = _onehot()
        kw = dict(X=X, y=y, n_iter=2, group_shapes=shapes)
    else:
        X, blocks, y, _, _, _, grouping = tiny
        kw = dict(X=X, y=y, X_rel=blocks, n_iter=2, grouping=grouping)
    ours = VariationalFMRegressor(rank=2, device="cpu").fit(**kw)
    ref = myfm_tpu.VariationalFMRegressor(rank=2).fit(**kw)
    assert ours.history_.engine == ref.history_.engine == "fastpath"


def test_user_callback_sees_host_values_and_stops_early():
    X, y, shapes = _onehot(n=200)
    seen = []

    def callback(i, fm, hyper, history):
        seen.append((i, float(fm.w0), hyper.alpha, len(history.elbos)))
        assert isinstance(fm.V_var, np.ndarray)
        return i == 3, None

    fm = VariationalFMRegressor(rank=2, device="cpu").fit(
        X, y, n_iter=10, group_shapes=shapes, callback=callback)
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert [s[3] for s in seen] == [1, 2, 3, 4]
    assert isinstance(seen[0][2], float)
    assert len(fm.history_.elbos) == 4
    assert all(isinstance(e, float) for e in fm.history_.elbos)
    assert fm.w_mean.shape == (50,) and fm.V_var.shape == (50, 2)
    assert fm.history_.hypers.mu_V.shape == (2, 2)
    assert VariationalFMRegressor(rank=2, device="cpu").w0_mean is None


def test_variational_predictor_matches_jax(tiny):
    """The converged weights scored on the device through the row-space
    forward equal the TPU package's numpy forward (f64, 1e-10)."""
    _, _, _, Xte, bte, _, grouping = tiny
    F, R = len(grouping), 3
    rng = np.random.RandomState(0)
    w0, w, V = rng.normal(), rng.normal(size=F), 0.3 * rng.normal(size=(F, R))
    var = (1.0, np.ones(F), np.ones((F, R)))
    ref = JaxVPredictor(R, F, "regression", np.float64)
    ref.samples.append(JaxVFM(w0, w, V, *var))
    ours = VariationalPredictor(R, F, "regression", np.float64, "cpu")
    ours.samples.append(VariationalFM(w0, w, V, *var))
    np.testing.assert_allclose(ours.predict(Xte, bte), ref.predict(Xte, bte),
                               rtol=1e-10, atol=1e-10)


def test_default_device_is_cuda():
    assert VariationalFMRegressor(rank=2).device == torch.device("cuda")


@pytest.mark.parametrize("make", [
    # the classifier itself fits now (test_torch_vi_classifier.py); like
    # the regressor it still raises for multiple devices
    lambda: VariationalFMClassifier(rank=2, n_devices=2, device="cpu"),
    lambda: VariationalFMRegressor(rank=2, n_devices=2, device="cpu"),
    lambda: VariationalFMRegressor(rank=2, mesh=object(), device="cpu"),
])
def test_classifier_and_multi_device_raise(make):
    with pytest.raises(NotImplementedError, match="later slice"):
        make()


@pytest.mark.parametrize("strategy,error", [
    ("auto", None), ("categorical", ValueError),
])
def test_non_categorical_design_raises(strategy, error):
    """A multi-hot main table compiles to no fast-path plan.  Under
    "auto" both packages run the row-space colored VI there (the port
    raised before it was ported; the name is kept): both histories say
    "colored", and from the same deterministic start (init_stdev = 0)
    the two fits agree within 1e-10 — weights, their variances and the
    ELBO trace.  "categorical" still refuses the design."""
    rng = np.random.RandomState(0)
    X = sps.random(200, 12, density=0.4, random_state=rng, format="csr")
    y = rng.normal(size=200)
    if error is not None:
        with pytest.raises(error):
            VariationalFMRegressor(rank=2, sweep_strategy=strategy,
                                   device="cpu").fit(X, y, n_iter=2)
        return
    kw = dict(rank=2, init_stdev=0.0, dtype=np.float64)
    ref = myfm_tpu.VariationalFMRegressor(**kw).fit(X, y, n_iter=3)
    fm = VariationalFMRegressor(sweep_strategy=strategy, device="cpu",
                                **kw).fit(X, y, n_iter=3)
    assert ref.history_.engine == fm.history_.engine == "colored"
    for f in ("w0_mean", "w0_var", "w_mean", "w_var", "V_mean", "V_var"):
        np.testing.assert_allclose(getattr(fm, f), getattr(ref, f),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(fm.history_.elbos, ref.history_.elbos,
                               rtol=1e-10)
    np.testing.assert_allclose(fm.predict(X), ref.predict(X), rtol=1e-10,
                               atol=1e-12)


def test_gibbs_auto_on_ea_design_raises_before_any_sweep(tiny):
    """Below 200 sweeps JAX's Gibbs "auto" takes the fast path with the
    entity+attribute tables (its _ea_table_pass), and the port runs the
    same pass now (it raised before that pass was ported; the name is
    kept): the fit resolves to "fastpath" and its first sweep runs."""
    X, blocks, y, _, _, _, grouping = tiny
    seen = []
    fm = MyFMGibbsRegressor(rank=4, random_seed=3, device="cpu")
    fm.fit(X, y, X_rel=blocks, n_iter=199, grouping=grouping,
           callback=lambda *a: seen.append(a[0]) or (True, None))
    assert seen == [0]
    assert fm.history_.engine == "fastpath"
