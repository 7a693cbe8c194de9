"""The colored Gibbs engine and the joint-row factor sweep through the
port's three Gibbs estimators: engine resolution against the TPU
package's, fit → predict for every task and strategy that lands there,
and the RelationBlock contract (blocked ≡ flattened, the logic of
tests/test_block.py) for the port's colored engine.

Blocked ≡ flattened: with ``sweep_strategy="serial"`` both plans visit
the features in the same order, one per color, and draw the same
variates from one seed (the shapes of every variate are the design's F,
G and N, not its layout), so the kept samples agree to rounding: the
blocked fit reads its conditionals from the block-row aggregates, the
flattened one from the expanded rows.
"""

import numpy as np
import pytest

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu_torch import (
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
    RelationBlock,
)

from .oracle import expand_blocks
from .test_block import _make_relational_problem
from .vi_cases import load_tiny

# strategy name -> estimator keywords; "auto" and "joint" without the
# linear terms ("auto" then finds neither the fast path, whose side
# features need w, nor the joint gate)
STRATEGIES = {
    "colored": dict(sweep_strategy="colored"),
    "serial": dict(sweep_strategy="serial"),
    "auto": dict(sweep_strategy="auto", fit_linear=False),
    "joint": dict(sweep_strategy="joint", fit_linear=False),
}
ENGINE = {"colored": "colored", "serial": "colored", "auto": "colored",
          "joint": "joint"}


def _stop_at_once(i, fm, hyper, history):
    return True, None


def _problem(mod, seed=0):
    """test_block's relational problem (one-hot users / items with side
    features, a small main table) with ``mod``'s RelationBlocks."""
    X, blocks, y = _make_relational_problem(seed=seed)
    return X, [mod.RelationBlock(b.original_to_block, b.data)
               for b in blocks], y


def test_auto_without_linear_terms_resolves_colored_like_jax():
    """On the tiny timeSVD++ design, ``fit_linear=False`` takes the
    colored engine in both packages: the side features of the fast path
    and the joint candidate both need the linear terms."""
    X, blocks, grouping, y = load_tiny()
    kw = dict(rank=4, fit_linear=False, max_unrolled_colors=2)
    ours = MyFMGibbsRegressor(device="cpu", **kw).fit(
        X, y, X_rel=blocks, n_iter=3, grouping=grouping,
        callback=_stop_at_once)
    ref = myfm_tpu.MyFMGibbsRegressor(**kw).fit(
        X, y, X_rel=[myfm_tpu.RelationBlock(b.original_to_block, b.data)
                     for b in blocks],
        n_iter=3, grouping=grouping, callback=_stop_at_once)
    assert ours.history_.engine == ref.history_.engine == "colored"
    assert float(np.abs(ours.w_samples).max()) == 0.0


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_engine_matches_jax(strategy):
    X, blocks, y = _problem(myfm_tpu_torch)
    Xj, bj, _ = _problem(myfm_tpu)
    kw = dict(rank=2, max_unrolled_colors=4, **STRATEGIES[strategy])
    ours = MyFMGibbsRegressor(device="cpu", **kw).fit(
        X, y, X_rel=blocks, n_iter=2, callback=_stop_at_once)
    ref = myfm_tpu.MyFMGibbsRegressor(**kw).fit(
        Xj, y, X_rel=bj, n_iter=2, callback=_stop_at_once)
    assert ours.history_.engine == ref.history_.engine == ENGINE[strategy]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("task", ["regression", "classification",
                                  "ordered"])
def test_every_task_fits_and_predicts(task, strategy):
    X, blocks, y = _problem(myfm_tpu_torch, seed=2)
    kw = dict(rank=2, random_seed=1, device="cpu", **STRATEGIES[strategy])
    fit = dict(X_rel=blocks, n_iter=4, n_kept_samples=2)
    if task == "regression":
        fm = MyFMGibbsRegressor(**kw).fit(X, y, **fit)
        pred = fm.predict(X, blocks)
        assert pred.shape == y.shape and np.isfinite(pred).all()
    elif task == "classification":
        fm = MyFMGibbsClassifier(**kw).fit(
            X, (y > np.median(y)).astype(int), **fit)
        p = fm.predict_proba(X, blocks)
        assert ((p >= 0) & (p <= 1)).all()
    else:
        classes = np.searchsorted(np.quantile(y, [0.3, 0.7]), y)
        fm = MyFMOrderedProbit(**kw).fit(X, classes, **fit)
        P = fm.predict_proba(X, blocks)
        assert P.shape == (y.shape[0], 3)
        np.testing.assert_allclose(P.sum(axis=1), 1.0, rtol=1e-5)
        cuts = fm.cutpoint_samples
        assert np.isfinite(cuts).all() and (np.diff(cuts, axis=1) > 0).all()
    assert fm.history_.engine == ENGINE[strategy]
    if not kw.get("fit_linear", True):
        assert float(np.abs(fm.w_samples).max()) == 0.0


@pytest.mark.parametrize("task,max_unrolled", [
    ("regression", 16), ("regression", 0), ("classification", 0),
])
def test_blocked_equals_flattened_colored(task, max_unrolled):
    """``max_unrolled_colors=0`` sends every block color through the
    stack folds (``_w_block_stack`` / ``_V_block_stack``) and every
    flattened color through the main-table stack."""
    X, blocks, y = _problem(myfm_tpu_torch, seed=4)
    X_flat = expand_blocks(X, blocks)
    est = MyFMGibbsRegressor
    if task == "classification":
        est, y = MyFMGibbsClassifier, (y > np.median(y)).astype(int)
    kw = dict(rank=2, random_seed=3, dtype=np.float64, device="cpu",
              sweep_strategy="serial", max_unrolled_colors=max_unrolled)
    blocked = est(**kw).fit(X, y, X_rel=blocks, n_iter=8, n_kept_samples=8)
    flat = est(**kw).fit(X_flat, y, n_iter=8, n_kept_samples=8)
    assert blocked.history_.engine == flat.history_.engine == "colored"
    for what in ("w0_samples", "w_samples", "V_samples"):
        np.testing.assert_allclose(getattr(blocked, what),
                                   getattr(flat, what), rtol=1e-6,
                                   atol=1e-8, err_msg=what)
    pb = (blocked.predict_proba(X, blocks) if task == "classification"
          else blocked.predict(X, blocks))
    pf = (flat.predict_proba(X_flat) if task == "classification"
          else flat.predict(X_flat))
    np.testing.assert_allclose(pb, pf, rtol=1e-6, atol=1e-8)
