"""The joint engine through the port's estimator: the "auto" engine
resolution against the TPU package's, the tail-kernel gate, row-space
serving, and the fitted accuracy on the synthetic "tiny" timeSVD++
design.

JAX's threefry and torch's Philox generators differ, so the two chains
cannot agree sample for sample; the accuracy check is distributional.
The port's held-out RMSE, averaged over two seeds, must lie inside the
TPU package's seed-to-seed range over three seeds, widened by that
range on each side (measured on the CPU: TPU package 0.9796-0.9879,
port 0.9778-0.9886 over seeds 1-4).
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.predictor import Predictor as JaxPredictor
from myfm_tpu.containers import FM as JaxFM
from myfm_tpu_torch import MyFMGibbsRegressor, RelationBlock
from myfm_tpu_torch.convert import predictor_from_numpy
from myfm_tpu_torch.design import compile_design
from myfm_tpu_torch.ops.gibbs import GibbsConfig
from myfm_tpu_torch.trainer import GibbsTrainer, _resolve_joint_tail

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


def _stop_at_once(i, fm, hyper, history):
    return True, None


def _onehot(n=300, n_u=30, n_i=20, seed=0):
    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    rows = np.arange(n)
    X = sps.hstack([sps.csr_matrix((np.ones(n), (rows, u)), (n, n_u)),
                    sps.csr_matrix((np.ones(n), (rows, i)), (n, n_i))],
                   format="csr")
    y = 3 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    return X, y + 0.3 * rng.normal(size=n), [n_u, n_i]


def _engines(fit_kw, **est_kw):
    """(port engine, TPU-package engine) of one fit, stopped after the
    first sweep."""
    ours = MyFMGibbsRegressor(device="cpu", **est_kw).fit(
        callback=_stop_at_once, **fit_kw)
    ref = myfm_tpu.MyFMGibbsRegressor(**est_kw).fit(
        callback=_stop_at_once, **fit_kw)
    return ours.history_.engine, ref.history_.engine


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_auto_long_chain_resolves_joint_like_jax(tiny, dtype):
    X, blocks, y, _, _, _, grouping = tiny
    got = _engines(dict(X=X, y=y, X_rel=blocks, n_iter=200,
                        n_kept_samples=1, grouping=grouping),
                   rank=4, random_seed=1, dtype=dtype)
    assert got == ("joint", "joint")


@pytest.mark.parametrize("strategy", ["auto", "joint"])
def test_onehot_design_resolves_like_jax(strategy):
    X, y, shapes = _onehot()
    got = _engines(dict(X=X, y=y, n_iter=5, n_kept_samples=1,
                        group_shapes=shapes),
                   rank=2, random_seed=1, sweep_strategy=strategy)
    assert got == {"auto": ("fastpath", "fastpath"),
                   "joint": ("joint", "joint")}[strategy]


def _colored_design(n=200, seed=0):
    """Multi-hot float32 rows whose groups are too small for the joint
    gate: the TPU package resolves "auto" to the colored engine."""
    rng = np.random.RandomState(seed)
    X = sps.random(n, 12, density=0.4, random_state=rng, format="csr")
    y = X @ rng.normal(size=12) + 0.3 * rng.normal(size=n)
    return X, y, [6, 6]


@pytest.mark.parametrize("strategy", ["auto", "colored"])
def test_colored_resolution_raises_where_jax_picks_colored(strategy):
    """Where the TPU package picks the colored engine the port picks it
    too (it raised before that engine was ported; the name is kept), and
    the port's held-out RMSE over two seeds lies inside JAX's range over
    three seeds, widened by that range on each side."""
    X, y, shapes = _colored_design()
    tr, te = np.arange(160), np.arange(160, 200)

    def rmse(mod, seed, **kw):
        fm = mod.MyFMGibbsRegressor(
            rank=2, sweep_strategy=strategy, random_seed=seed, **kw
        ).fit(X[tr], y[tr], n_iter=40, n_kept_samples=30,
              group_shapes=shapes)
        assert fm.history_.engine == "colored"
        return float(np.sqrt(np.mean((fm.predict(X[te]) - y[te]) ** 2)))

    ref = [rmse(myfm_tpu, s) for s in (1, 2, 3)]
    ours = [rmse(myfm_tpu_torch, s, device="cpu") for s in (1, 2)]
    spread = max(ref) - min(ref)
    assert np.mean(ours) < y[te].std()
    for r in ours:
        assert min(ref) - spread <= r <= max(ref) + spread, (ours, ref)


def test_tiny_timesvdpp_rmse_within_jax_seed_spread(tiny):
    Xtr, btr, y, Xte, bte, yte, grouping = tiny

    def rmse(mod, seed, **kw):
        fm = mod.MyFMGibbsRegressor(rank=4, random_seed=seed, **kw).fit(
            Xtr, y, X_rel=btr, n_iter=200, n_kept_samples=150,
            grouping=grouping)
        assert fm.history_.engine == "joint"
        pred = fm.predict(Xte, bte)
        return float(np.sqrt(np.mean((pred - yte) ** 2)))

    ref = [rmse(myfm_tpu, s) for s in (1, 2, 3)]
    ours = np.mean([rmse(myfm_tpu_torch, s, device="cpu") for s in (1, 2)])
    spread = max(ref) - min(ref)
    assert ours < yte.std()
    assert min(ref) - spread <= ours <= max(ref) + spread, (ours, ref)


def _plan(tiny, dtype=np.float32):
    X, blocks, y, _, _, _, grouping = tiny
    plan = compile_design(X, blocks, grouping=np.asarray(grouping, np.int32),
                          dtype=dtype, joint_dense=True, joint_rank=4,
                          device="cpu")
    return plan, y


def test_tail_kernel_gate_on_cpu(tiny):
    plan, y = _plan(tiny)
    cfg = GibbsConfig(task="regression", joint_rows=True)
    assert _resolve_joint_tail(cfg, plan, 4).joint_tail_kernel is False
    off = GibbsConfig(task="regression", joint_rows=True,
                      joint_tail_kernel=False)
    assert _resolve_joint_tail(off, plan, 4).joint_tail_kernel is False
    on = GibbsConfig(task="regression", joint_rows=True,
                     joint_tail_kernel=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        GibbsTrainer(plan, y, on, 4, 0.1, 0)


def test_trainer_chain_is_seeded(tiny):
    plan, y = _plan(tiny, np.float64)
    cfg = GibbsConfig(task="regression", joint_rows=True)

    def chain(seed):
        tr = GibbsTrainer(plan, y, cfg, 4, 0.1, seed, np.float64)
        assert tr.engine_name == "joint"
        st = tr._initialize()
        for _ in range(3):
            st = tr._sweep_call(st)
        return st.V

    a, b, c = chain(5), chain(5), chain(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_row_space_serving_matches_jax(tiny):
    """A design that is not all one-hot is served by the row-space
    scorer: posterior mean over the kept samples, as the TPU package's
    Predictor computes it."""
    _, _, _, Xte, bte, _, grouping = tiny
    F, R = len(grouping), 3
    rng = np.random.RandomState(0)
    jpred = JaxPredictor(R, F, "regression", np.float64)
    for _ in range(4):
        jpred.samples.append(JaxFM(rng.normal(), rng.normal(size=F),
                                   0.3 * rng.normal(size=(F, R))))
    ours = predictor_from_numpy(jpred, "cpu").predict(Xte, bte)
    np.testing.assert_allclose(ours, jpred.predict(Xte, bte), rtol=1e-10,
                               atol=1e-10)
