"""The probit estimators of the port (MyFMGibbsClassifier,
MyFMOrderedProbit) against the TPU package's: the "auto" engine
resolution on a one-hot design (fast path) and on the synthetic "tiny"
timeSVD++ design (joint engine), the probability outputs, serving of
kept samples with cutpoints on both scorers, and the fitted log-loss.

JAX's threefry and torch's Philox generators differ, so the two chains
cannot agree sample for sample; the accuracy check is distributional:
the port's held-out log-loss, averaged over two seeds, must lie inside
the TPU package's seed-to-seed range over three seeds, widened by that
range on each side.  Serving the same samples agrees to 1e-10.

Also here: the entry points that take a device default to the card.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.containers import FM as JaxFM
from myfm_tpu.predictor import Predictor as JaxPredictor
from myfm_tpu_torch import (
    MyFMGibbsClassifier,
    MyFMOrderedProbit,
    Predictor,
    VariationalPredictor,
)
from myfm_tpu_torch.convert import predictor_from_numpy
from myfm_tpu_torch.design import compile_design

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def test_entry_points_default_to_the_card():
    for fn in (Predictor.__init__, VariationalPredictor.__init__,
               compile_design):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    X = sps.identity(4, format="csr")
    assert Predictor(2, 4, "ordered", np.float64, "cpu").device.type == "cpu"
    assert VariationalPredictor(2, 4, "regression", np.float64,
                                "cpu").device.type == "cpu"
    assert compile_design(X, device="cpu").main.coo_row.device.type == "cpu"


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
    z = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    z = z + 0.5 * rng.normal(size=n)
    return X, z, [n_u, n_i]


def _labels(kind, z):
    if kind == "classifier":
        return (z > 0.2).astype(np.int64)
    return np.searchsorted([-1.0, 0.0, 1.0], z).astype(np.int64)


ESTIMATORS = {
    "classifier": (MyFMGibbsClassifier, myfm_tpu.MyFMGibbsClassifier),
    "ordered": (MyFMOrderedProbit, myfm_tpu.MyFMOrderedProbit),
}


def _stop_at_once(i, fm, hyper, history):
    return True, None


@pytest.fixture
def jax_engine_only(monkeypatch):
    """The TPU package's trainers report their resolved engine without
    running a sweep (its compile would dominate these tests)."""
    from myfm_tpu import trainer as jtrainer
    from myfm_tpu.containers import LearningHistory as JaxHistory

    def run(self, n_iter, n_kept_samples, callback=None, *a, **k):
        return None, JaxHistory(engine=self.engine_name)

    for cls in (jtrainer.GibbsTrainer, jtrainer.CategoricalGibbsTrainer):
        monkeypatch.setattr(cls, "run", run)


@pytest.mark.parametrize("kind", ["classifier", "ordered"])
@pytest.mark.parametrize("design", ["onehot", "tiny"])
def test_auto_resolution_matches_jax(kind, design, tiny, jax_engine_only):
    if design == "onehot":
        X, z, shapes = _onehot()
        kw = dict(X=X, n_iter=5, group_shapes=shapes)
        want = "fastpath"
    else:
        X, blocks, rating, _, _, _, grouping = tiny
        z = rating - 3.5
        kw = dict(X=X, X_rel=blocks, n_iter=200, grouping=grouping)
        want = "joint"
    y = _labels(kind, z)
    ours, ref = ESTIMATORS[kind]
    a = ours(rank=3, random_seed=1, device="cpu").fit(
        y=y, n_kept_samples=1, callback=_stop_at_once, **kw)
    b = ref(rank=3, random_seed=1).fit(
        y=y, n_kept_samples=1, callback=_stop_at_once, **kw)
    assert a.history_.engine == b.history_.engine == want


def test_outputs_on_the_fast_path():
    X, z, shapes = _onehot(seed=1)
    yc, yo = _labels("classifier", z), _labels("ordered", z)
    clf = MyFMGibbsClassifier(rank=3, random_seed=0, device="cpu").fit(
        X, yc, n_iter=8, n_kept_samples=4, group_shapes=shapes)
    p = clf.predict_proba(X)
    assert p.shape == (X.shape[0],) and np.all((p > 0) & (p < 1))
    np.testing.assert_array_equal(clf.predict(X), p > 0.5)
    assert clf.history_.engine == "fastpath"
    assert all(float(h.alpha) == 1.0 for h in clf.history_.hypers)

    op = MyFMOrderedProbit(rank=3, random_seed=0, device="cpu").fit(
        X, yo, n_iter=8, n_kept_samples=4, group_shapes=shapes)
    P = op.predict_proba(X)
    assert P.shape == (X.shape[0], 4)
    np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(op.predict(X), P.argmax(axis=1))
    cuts = op.cutpoint_samples
    assert cuts.shape == (4, 3) and np.all(np.diff(cuts, axis=1) > 0)
    np.testing.assert_array_equal(op.get_cutpoint_samples(0), cuts)
    h = op.history_
    assert len(h.n_mh_accept) == 1 and len(h.n_mh_accept_trace) == 8
    assert h.n_mh_accept == h.n_mh_accept_trace[-1]


def _samples(rng, n, F, R, groups=(4,)):
    out = []
    for _ in range(n):
        cuts = [np.sort(rng.normal(size=K - 1)) for K in groups]
        out.append((rng.normal(), rng.normal(size=F),
                    0.3 * rng.normal(size=(F, R)), cuts))
    return out


@pytest.mark.parametrize("design", ["onehot", "tiny"])
def test_serving_matches_jax(design, tiny):
    """Kept samples with cutpoints, served by the entity-space scorer
    (modes probit_sum / oprobit_sum) on the one-hot design and by the
    row-space scorer on the tiny timeSVD++ design, as JAX's Predictor
    serves them."""
    if design == "onehot":
        X, _, shapes = _onehot(seed=2)
        blocks, F = [], sum(shapes)
    else:
        _, _, _, X, blocks, _, grouping = tiny
        F = len(grouping)
    R = 3
    rng = np.random.RandomState(0)
    samples = _samples(rng, 5, F, R, groups=(4, 3))
    for task in ("classification", "ordered"):
        jpred = JaxPredictor(R, F, task, np.float64)
        jpred.samples = [JaxFM(*s) for s in samples]
        tpred = predictor_from_numpy(jpred, "cpu")
        if task == "classification":
            np.testing.assert_allclose(tpred.predict(X, blocks),
                                       jpred.predict(X, blocks),
                                       rtol=1e-10, atol=1e-12)
            continue
        for idx in (0, 1):
            got = tpred.predict_parallel_oprobit(X, blocks,
                                                 cutpoint_index=idx)
            want = jpred.predict_parallel_oprobit(X, blocks,
                                                  cutpoint_index=idx)
            assert got.shape == want.shape == (X.shape[0], 4 - idx)
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _log_loss(P, y):
    if P.ndim == 1:
        P = np.stack([1 - P, P], axis=1)
    return float(-np.mean(np.log(P[np.arange(y.size), y] + 1e-15)))


@pytest.mark.parametrize("kind", ["classifier", "ordered"])
def test_tiny_log_loss_within_jax_seed_spread(kind, tiny):
    """The joint engine on the tiny timeSVD++ design, 12 sweeps: held-out
    log-loss of the posterior-mean probabilities."""
    Xtr, btr, r_tr, Xte, bte, r_te, grouping = tiny
    lab = ((lambda r: (r >= 4).astype(np.int64)) if kind == "classifier"
           else (lambda r: (r - 1).astype(np.int64)))
    ytr, yte = lab(r_tr), lab(r_te)

    def loss(mod, seed, **kw):
        est = {"classifier": mod.MyFMGibbsClassifier,
               "ordered": mod.MyFMOrderedProbit}[kind]
        fm = est(rank=4, random_seed=seed, sweep_strategy="joint",
                 **kw).fit(Xtr, ytr, X_rel=btr, n_iter=12,
                           n_kept_samples=8, grouping=grouping)
        assert fm.history_.engine == "joint"
        return _log_loss(fm.predict_proba(Xte, bte), yte)

    ref = [loss(myfm_tpu, s) for s in (1, 2, 3)]
    ours = np.mean([loss(myfm_tpu_torch, s, device="cpu") for s in (1, 2)])
    base = np.bincount(ytr, minlength=yte.max() + 1) / ytr.size
    assert ours < _log_loss(np.tile(base, (yte.size, 1)), yte)
    spread = max(ref) - min(ref)
    assert min(ref) - spread <= ours <= max(ref) + spread, (ours, ref)
