"""The pipelined harvest of the port's Gibbs loop (trainer.py ``_HostCopy``,
``_AsyncDrain``, ``LazyHyper``, ``_LazyAccept``, ``LazyPackedFM``) and
the predictor's caches (predictor.py ``_LiveKey``): the default harvest
and an eager user callback give identical samples, hyper trace and MH
accept trace; what a fit leaves behind pickles; a repeat ``predict``
reuses the plans and the stacked samples, and a changed ``samples`` list
or another design rebuilds them."""

import pickle

import numpy as np
import pytest
import scipy.sparse as sps

from myfm_tpu_torch import (
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
    RelationBlock,
)
from myfm_tpu_torch import predictor as tpred
from myfm_tpu_torch import trainer as ttrainer


def _problem(seed=0, n=240, nu=13, ni=9):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    blocks = [RelationBlock(u, sps.identity(nu, format="csr")),
              RelationBlock(i, sps.identity(ni, format="csr"))]
    y = rng.normal(size=nu)[u] + rng.normal(size=ni)[i] + 0.3 * rng.normal(
        size=n)
    return blocks, y


ESTIMATORS = {
    "regression": (MyFMGibbsRegressor, lambda y: y),
    "classification": (MyFMGibbsClassifier, lambda y: (y > 0).astype(int)),
    "ordered": (MyFMOrderedProbit,
                lambda y: np.digitize(y, [-1.0, 0.0, 1.0])),
}


@pytest.mark.parametrize("strategy", ["auto", "colored"])
@pytest.mark.parametrize("task", list(ESTIMATORS))
def test_async_and_eager_harvests_are_identical(task, strategy):
    blocks, y = _problem()
    cls, target = ESTIMATORS[task]
    seen = []

    def eager(i, fm, hyper, history):
        seen.append(float(hyper.alpha))
        return False, None

    fits = []
    for callback in (None, eager):
        fm = cls(rank=3, random_seed=4, device="cpu", dtype=np.float64,
                 sweep_strategy=strategy)
        fm.fit(None, target(y), X_rel=blocks, n_iter=7, n_kept_samples=4,
               callback=callback)
        fits.append(fm)
    lazy, eager_fm = fits
    assert lazy.history_.engine == eager_fm.history_.engine
    assert len(seen) == 7
    for a, b in zip(lazy.predictor_.samples, eager_fm.predictor_.samples):
        assert type(a) is type(b)
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.V, b.V)
        assert len(a.cutpoints) == len(b.cutpoints)
        for ca, cb in zip(a.cutpoints, b.cutpoints):
            np.testing.assert_array_equal(ca, cb)
    for a, b in zip(lazy.history_.hypers, eager_fm.history_.hypers):
        assert type(a) is type(b)
        assert a.alpha == b.alpha
        for f in ("mu_w", "lambda_w", "mu_V", "lambda_V"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert seen == [h.alpha for h in lazy.history_.hypers]
    assert (lazy.history_.n_mh_accept_trace
            == eager_fm.history_.n_mh_accept_trace)
    if task == "ordered":
        assert len(lazy.history_.n_mh_accept_trace) == 7
        assert all(isinstance(t, list)
                   for t in lazy.history_.n_mh_accept_trace)


def test_history_and_predictor_pickle():
    blocks, y = _problem(seed=1)
    fm = MyFMOrderedProbit(rank=2, device="cpu")
    fm.fit(None, np.digitize(y, [-1.0, 0.0, 1.0]), X_rel=blocks, n_iter=5)
    first = fm.predict_proba(None, blocks)  # fills the predictor caches
    assert fm.predictor_._plan_cache is not None
    history = pickle.loads(pickle.dumps(fm.history_))
    predictor = pickle.loads(pickle.dumps(fm.predictor_))
    assert predictor._plan_cache is None
    assert history.n_mh_accept_trace == fm.history_.n_mh_accept_trace
    np.testing.assert_array_equal(history.hypers[-1].lambda_V,
                                  fm.history_.hypers[-1].lambda_V)
    again = pickle.loads(pickle.dumps(fm))
    np.testing.assert_array_equal(again.predict_proba(None, blocks), first)


def test_drain_forces_entries_older_than_the_lag():
    forced = []

    class Entry:
        def __init__(self, k):
            self.k = k

        def force(self):
            forced.append(self.k)

    drain = ttrainer._AsyncDrain(lag=3)
    for sweep in range(6):
        drain.push(Entry(sweep), sweep)
        assert forced == list(range(max(0, sweep - 2)))
    drain.drain()
    assert forced == list(range(6))


def test_cpu_harvest_copies_at_once():
    import torch

    t = torch.arange(4.0)
    copy = ttrainer._HostCopy([t, t.sum()])
    t += 1  # a later in-place write does not reach the harvest
    w, s = copy.wait()
    np.testing.assert_array_equal(w, [0.0, 1.0, 2.0, 3.0])
    assert s == 6.0


def test_predictor_caches_reuse_and_rebuild(monkeypatch):
    blocks, y = _problem(seed=2)
    fm = MyFMGibbsRegressor(rank=3, random_seed=0, device="cpu")
    fm.fit(None, y, X_rel=blocks, n_iter=6, n_kept_samples=4)
    compiles = []
    real = tpred.compile_categorical_inference

    def counting(*a, **k):
        compiles.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tpred, "compile_categorical_inference", counting)
    p = fm.predictor_
    first = fm.predict(None, blocks)
    stack = p._sample_stack_cache
    second = fm.predict(None, blocks)
    assert len(compiles) == 1  # the plan is reused
    assert p._sample_stack_cache is stack  # and the stacked samples
    np.testing.assert_array_equal(first, second)

    # a changed sample list rebuilds the stack (never a stale one)
    p.samples = p.samples[:2]
    fewer = fm.predict(None, blocks)
    assert p._sample_stack_cache is not stack
    fresh = tpred.Predictor(p.rank, p.n_features, p.task, p.dtype, "cpu")
    fresh.samples = list(p.samples)
    np.testing.assert_allclose(fewer, fresh.predict(None, blocks),
                               rtol=1e-6)
    assert not np.allclose(fewer, first)

    # another design (new block objects, same shapes) compiles anew
    blocks2, _ = _problem(seed=3)
    other = fm.predict(None, blocks2)
    assert len(compiles) == 3  # the fresh predictor's + this one
    assert not np.allclose(other, fewer)


def test_live_key_does_not_alias_a_recycled_id():
    class Obj:
        shape = (3, 2)
        nnz = 4

    a = Obj()
    key = tpred._LiveKey((a,))
    assert key.matches((a,))
    del a
    b = Obj()  # may well take the freed address
    assert not key.matches((b,))
