"""The port's estimator surface (myfm_tpu_torch.MyFMGibbsRegressor) and
what it shares with the TPU package: the import boundary, the engine
resolution, the synthetic data generator, and the fitted accuracy.

JAX's threefry and torch's Philox generators differ, so the two chains
cannot agree sample for sample; the accuracy check is distributional:
the port's held-out RMSE, averaged over two seeds, lies within 0.03 of
the TPU package's (about twice the seed-to-seed range of either
package on this design, measured at 0.013).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sps

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.design import joint_auto_candidate as jax_candidate
from myfm_tpu.utils.benchmark_data import (
    SyntheticMovieLensManager as JaxSynthetic,
)
from myfm_tpu_torch import MyFMGibbsRegressor
from myfm_tpu_torch.design import joint_auto_candidate
from myfm_tpu_torch.utils.benchmark_data import SyntheticMovieLensManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def test_import_leaves_jax_and_pandas_out():
    code = (
        "import sys, myfm_tpu_torch, myfm_tpu_torch.convert, "
        "myfm_tpu_torch.trainer, myfm_tpu_torch.vi_trainer, "
        "myfm_tpu_torch.ops.gram, myfm_tpu_torch.ops.categorical_vi, "
        "myfm_tpu_torch.ops.joint_tail, myfm_tpu_torch.utils.ml_features, "
        "myfm_tpu_torch.utils.benchmark_data\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'myfm_tpu.', 'pandas')) or m == 'myfm_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def _onehot_problem(n_rows=600, n_u=40, n_i=25, seed=0):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_u, n_rows)
    i = rng.randint(0, n_i, n_rows)
    rows = np.arange(n_rows)
    X = sps.hstack(
        [
            sps.csr_matrix((np.ones(n_rows), (rows, u)),
                           shape=(n_rows, n_u)),
            sps.csr_matrix((np.ones(n_rows), (rows, i)),
                           shape=(n_rows, n_i)),
        ],
        format="csr",
    )
    y = (
        3.0
        + rng.normal(size=n_u)[u]
        + rng.normal(size=n_i)[i]
        + 0.3 * rng.normal(size=n_rows)
    )
    return X, y, [n_u, n_i]


def test_plain_onehot_resolves_fastpath_like_jax():
    X, y, shapes = _onehot_problem()
    kw = dict(n_iter=3, n_kept_samples=2, group_shapes=shapes)
    fm = MyFMGibbsRegressor(rank=2, random_seed=3, device="cpu").fit(
        X, y, **kw
    )
    ref = myfm_tpu.MyFMGibbsRegressor(rank=2, random_seed=3).fit(X, y, **kw)
    assert fm.history_.engine == ref.history_.engine == "fastpath"


@pytest.fixture(scope="module")
def tiny_timesvdpp():
    from ml_features import build_feature_blocks, load_movielens

    df_tr, df_te = load_movielens("tiny", 0, synthetic=True)
    X, _, blocks, _, grouping = build_feature_blocks(
        df_tr, df_te, "timesvdpp_flipped"
    )
    return X, blocks, grouping, df_tr.rating.values.astype(np.float64)


def test_long_chain_small_design_raises_where_jax_picks_joint(
    tiny_timesvdpp,
):
    """JAX resolves this design at n_iter=200 to the joint engine
    (tests/test_engine_resolution.py); the port shares the gate and,
    since it has the joint engine now, resolves alike (the fit stops
    after its first sweep)."""
    X, blocks, grouping, y = tiny_timesvdpp
    assert joint_auto_candidate(4, True, np.float64, grouping)
    assert jax_candidate(4, True, np.float64, grouping)
    fm = MyFMGibbsRegressor(rank=4, random_seed=3, dtype=np.float64,
                            device="cpu")
    fm.fit(X, y, X_rel=blocks, n_iter=200, n_kept_samples=1,
           grouping=grouping, callback=lambda *a: (True, None))
    assert fm.history_.engine == "joint"


def test_short_chain_side_features_raise(tiny_timesvdpp):
    """At n_iter=3 JAX takes the fast path with entity+attribute
    tables, and so does the port now (it raised before that pass was
    ported; the name is kept): the fit resolves to "fastpath" and
    predicts finite values."""
    X, blocks, grouping, y = tiny_timesvdpp
    fm = MyFMGibbsRegressor(rank=4, random_seed=3, dtype=np.float64,
                            device="cpu")
    fm.fit(X, y, X_rel=blocks, n_iter=3, n_kept_samples=1,
           grouping=grouping)
    assert fm.history_.engine == "fastpath"
    assert np.isfinite(fm.predict(X, blocks)).all()


@pytest.mark.parametrize("strategy", ["colored", "serial"])
def test_unported_engines_raise(strategy):
    """The colored engine is ported now (it raised before; the name is
    kept): both strategies fit on it and predict finite values."""
    X, y, shapes = _onehot_problem(n_rows=100)
    fm = MyFMGibbsRegressor(rank=2, sweep_strategy=strategy, device="cpu")
    fm.fit(X, y, n_iter=2, group_shapes=shapes)
    assert fm.history_.engine == "colored"
    pred = fm.predict(X)
    assert pred.shape == y.shape and np.isfinite(pred).all()


def test_categorical_strategy_on_non_onehot_design_raises():
    X, y, shapes = _onehot_problem(n_rows=100)
    X = X.tolil()
    X[0, 0] = 2.0
    fm = MyFMGibbsRegressor(rank=2, sweep_strategy="categorical",
                            device="cpu")
    with pytest.raises(ValueError, match="one-hot"):
        fm.fit(X.tocsr(), y, n_iter=2, group_shapes=shapes)


@pytest.mark.parametrize("kw", [dict(n_devices=2), dict(mesh=object())])
def test_multi_device_raises(kw):
    with pytest.raises(NotImplementedError, match="multi-device"):
        MyFMGibbsRegressor(rank=2, device="cpu", **kw)


@pytest.mark.parametrize("preset,kw", [
    ("tiny", {}),
    ("100k", dict(n_rows=5000, n_users=120, n_items=70)),
])
def test_synthetic_generator_equals_jax(preset, kw):
    ours = SyntheticMovieLensManager(preset, random_seed=7,
                                     **kw).load_rating_all()
    df = JaxSynthetic(preset, random_seed=7, **kw).load_rating_all()
    np.testing.assert_array_equal(ours["user_id"], df.user_id.values)
    np.testing.assert_array_equal(ours["movie_id"], df.movie_id.values)
    np.testing.assert_array_equal(ours["rating"], df.rating.values)
    days = (df.timestamp - pd.Timestamp("2005-01-01")).dt.days.values
    np.testing.assert_array_equal(ours["day"], days)


def test_fit_predict_rmse_near_jax():
    data = SyntheticMovieLensManager(
        "tiny", n_rows=6000, n_users=150, n_items=80, random_seed=3
    ).load_rating_all()
    u, i, y = data["user_id"] - 1, data["movie_id"] - 1, data["rating"]
    cut = int(0.9 * len(y))

    def blocks(mod, rows):
        return [
            mod.RelationBlock(u[rows], sps.identity(150, format="csr")),
            mod.RelationBlock(i[rows], sps.identity(80, format="csr")),
        ]

    def rmse(mod, seed, **kw):
        fm = mod.MyFMGibbsRegressor(rank=4, random_seed=seed, **kw).fit(
            None, y[:cut], X_rel=blocks(mod, slice(None, cut)),
            n_iter=40, n_kept_samples=30, group_shapes=[150, 80],
        )
        pred = fm.predict(None, blocks(mod, slice(cut, None)))
        return float(np.sqrt(np.mean((pred - y[cut:]) ** 2)))

    ours = np.mean([rmse(myfm_tpu_torch, s, device="cpu") for s in (1, 2)])
    ref = np.mean([rmse(myfm_tpu, s) for s in (1, 2)])
    assert ours < y[cut:].std()
    assert abs(ours - ref) <= 0.03, (ours, ref)


def test_hyper_trace_and_callback():
    X, y, shapes = _onehot_problem(n_rows=200)
    seen = []

    def callback(i, fm, hyper, history):
        seen.append((i, float(fm.w0), float(hyper.alpha)))
        return i == 4, None

    fm = MyFMGibbsRegressor(rank=2, device="cpu").fit(
        X, y, n_iter=10, n_kept_samples=10, group_shapes=shapes,
        callback=callback,
    )
    assert [s[0] for s in seen] == [0, 1, 2, 3, 4]
    trace = fm.get_hyper_trace()
    assert trace.shape == (5, 1 + 2 * 2 + 2 * 2 * 2)
    assert np.isfinite(trace.values).all()
    assert len(fm.w_samples) == 5
