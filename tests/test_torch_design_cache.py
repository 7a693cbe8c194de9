"""The port's content-addressed plan cache (myfm_tpu_torch/design_cache.py)
against the TPU package's: the same fingerprint digest for the same
design, the same cache behaviour on the port's estimators, and a refit
on a cached plan bit-equal to a fit on a freshly compiled one (nothing
writes into a plan or keeps per-fit state on it)."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from myfm_tpu import design_cache as jcache
from myfm_tpu.relational import RelationBlock as JaxBlock
from myfm_tpu_torch import MyFMGibbsRegressor, MyFMOrderedProbit
from myfm_tpu_torch import RelationBlock, clear_plan_cache
from myfm_tpu_torch import design_cache as tcache
from myfm_tpu_torch.design import compile_design
from myfm_tpu_torch.design_categorical import try_compile_categorical
from myfm_tpu_torch.ops.gibbs import GibbsConfig
from myfm_tpu_torch.trainer import CategoricalGibbsTrainer, GibbsTrainer


def _problem(seed=0, n=150, nu=9, ni=6):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    y = rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
    return blocks, y


@pytest.mark.parametrize("with_blocks", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_fingerprint_equals_jax(with_blocks, grouped):
    rng = np.random.RandomState(3)
    X = sps.random(60, 7, density=0.3, format="csr", random_state=3)
    blocks, jblocks = [], []
    if with_blocks:
        for B, F in ((9, 4), (5, 3)):
            m = rng.randint(0, B, 60)
            tab = sps.random(B, F, density=0.5, format="csr",
                             random_state=B)
            blocks.append(RelationBlock(m, tab))
            jblocks.append(JaxBlock(m, tab))
    n_feat = 7 + sum(b.feature_size for b in blocks)
    grouping = ([int(g) for g in rng.randint(0, 3, n_feat)] if grouped
                else None)
    ours = tcache.design_fingerprint(X, blocks, grouping)
    assert ours == jcache.design_fingerprint(X, jblocks, grouping)
    # a blocks-only design (X None) too
    if with_blocks:
        assert (tcache.design_fingerprint(None, blocks, grouping)
                == jcache.design_fingerprint(None, jblocks, grouping))


def test_repeat_fit_reuses_plan():
    clear_plan_cache()
    blocks, y = _problem()
    fm1 = MyFMGibbsRegressor(rank=2, random_seed=0, device="cpu")
    fm1.fit(None, y, X_rel=blocks, n_iter=4)
    n_after_first = len(tcache._CACHE)
    assert n_after_first >= 1
    plans = list(tcache._CACHE.values())
    hits = tcache.get_or_build.hits
    fm2 = MyFMGibbsRegressor(rank=2, random_seed=0, device="cpu")
    fm2.fit(None, y, X_rel=blocks, n_iter=4)
    assert len(tcache._CACHE) == n_after_first  # pure hits
    assert tcache.get_or_build.hits == hits + 1
    assert all(p is q for p, q in zip(plans, tcache._CACHE.values()))
    np.testing.assert_array_equal(fm1.w_samples, fm2.w_samples)
    # every key carries the device the plan lives on
    assert all(key[2][-1] == "cpu" for key in tcache._CACHE)


def test_content_fingerprint_detects_inplace_mutation():
    X = sps.random(40, 8, density=0.4, format="csr", random_state=1)
    fp1 = tcache.design_fingerprint(X, [], None)
    assert tcache.design_fingerprint(X, [], None) == fp1
    X.data[0] += 1.0  # same object, same sparsity, new content
    assert tcache.design_fingerprint(X, [], None) != fp1


def test_fingerprint_covers_blocks_and_grouping():
    blocks, _ = _problem(seed=2)
    blocks2, _ = _problem(seed=3)
    fp = tcache.design_fingerprint(None, blocks, [0, 1])
    assert tcache.design_fingerprint(None, blocks2, [0, 1]) != fp
    assert tcache.design_fingerprint(None, blocks, [0, 0]) != fp


def test_none_builds_are_not_cached():
    clear_plan_cache()
    calls = []

    def declined():
        calls.append(1)
        return None

    assert tcache.get_or_build("k", "fp", (), declined) is None
    assert tcache.get_or_build("k", "fp", (), declined) is None
    assert len(calls) == 2 and len(tcache._CACHE) == 0


def test_lru_eviction():
    clear_plan_cache()
    for i in range(7):
        tcache.get_or_build("k", f"fp{i}", (), lambda i=i: f"plan{i}")
    assert len(tcache._CACHE) == 4
    assert tcache.get_or_build("k", "fp6", (), lambda: "rebuilt") == "plan6"
    assert tcache.get_or_build("k", "fp0", (), lambda: "rebuilt") == "rebuilt"
    clear_plan_cache()
    assert tcache.plan_cache_bytes("cpu") == 0


def _design(seed=0, n=300, nu=17, ni=11):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    X = sps.hstack([
        sps.csr_matrix((np.ones(n), (np.arange(n), u)), shape=(n, nu)),
        sps.csr_matrix((np.ones(n), (np.arange(n), i)), shape=(n, ni)),
    ]).tocsr()
    y = (rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
         + 0.3 * rng.normal(size=n))
    grouping = np.asarray([0] * nu + [1] * ni, np.int32)
    return X, y, grouping, rng.randint(0, 4, n)


def _plan_bits(plan):
    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o.clone())
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (tuple, list)):
            for x in o:
                walk(x)

    walk(plan)
    return out


@pytest.mark.parametrize("engine", ["fastpath", "colored"])
@pytest.mark.parametrize("task", ["regression", "ordered"])
def test_refit_on_cached_plan_is_bit_equal(engine, task):
    """Two fits of one seed: the second on the plan the first used (as
    a cache hit hands it over), against a fit on a fresh plan; and the
    plan's tensors are unchanged by the fits."""
    X, y, grouping, y_ord = _design()
    cfg = GibbsConfig(task=task, n_class=4 if task == "ordered" else 0)
    target = y_ord if task == "ordered" else y

    def plan():
        if engine == "fastpath":
            return try_compile_categorical(X, [], grouping, None, np.float64,
                                           "cpu", rank=2)
        return compile_design(X, [], grouping=grouping, dtype=np.float64,
                              device="cpu")

    def fit(p):
        cls = (CategoricalGibbsTrainer if engine == "fastpath"
               else GibbsTrainer)
        pred, hist = cls(p, target, cfg, 2, 0.1, 5, np.float64).run(5, 5)
        return pred, hist

    shared = plan()
    before = _plan_bits(shared)
    fit(shared)
    again, h_again = fit(shared)
    fresh, h_fresh = fit(plan())
    assert h_again.engine == engine
    for a, b in zip(again.samples, fresh.samples):
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.V, b.V)
        assert a.w0 == b.w0
        for ca, cb in zip(a.cutpoints, b.cutpoints):
            np.testing.assert_array_equal(ca, cb)
    for a, b in zip(h_again.hypers, h_fresh.hypers):
        assert a.alpha == b.alpha
        np.testing.assert_array_equal(a.lambda_V, b.lambda_V)
    after = _plan_bits(shared)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_ordered_refit_through_the_estimator_hits_the_cache():
    clear_plan_cache()
    blocks, y = _problem(seed=4)
    yo = (np.digitize(y, [-1.0, 0.0, 1.0])).astype(np.int64)
    runs = []
    for _ in range(2):
        hits = tcache.get_or_build.hits
        fm = MyFMOrderedProbit(rank=2, random_seed=1, device="cpu",
                               dtype=np.float64)
        fm.fit(None, yo, X_rel=blocks, n_iter=4)
        runs.append((tcache.get_or_build.hits - hits, fm.V_samples,
                     fm.cutpoint_samples))
    assert [r[0] for r in runs] == [0, 1]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


def test_exports_cover_the_jax_package():
    import myfm_tpu
    import myfm_tpu_torch

    assert set(myfm_tpu.__all__) <= set(myfm_tpu_torch.__all__)
    for name in myfm_tpu_torch.__all__:
        assert hasattr(myfm_tpu_torch, name), name
    assert myfm_tpu_torch.clear_plan_cache is clear_plan_cache


@pytest.mark.parametrize("strategy", ["auto", "colored"])
def test_vi_refit_on_cached_plan_is_bit_equal(strategy):
    """The VI estimators' plans (keys "cat_vi" and "row_vi") are shared
    the same way: a refit hitting the cache equals a fit on a fresh
    compile."""
    from myfm_tpu_torch import VariationalFMRegressor

    blocks, y = _problem(seed=5)

    def fit():
        fm = VariationalFMRegressor(rank=2, random_seed=3, device="cpu",
                                    dtype=np.float64,
                                    sweep_strategy=strategy)
        return fm.fit(None, y, X_rel=blocks, n_iter=4)

    clear_plan_cache()
    first = fit()
    hits = tcache.get_or_build.hits
    again = fit()
    assert tcache.get_or_build.hits == hits + 1
    clear_plan_cache()
    fresh = fit()
    assert again.history_.engine == fresh.history_.engine
    for name in ("w_mean", "V_mean", "V_var"):
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(fresh, name))
        np.testing.assert_array_equal(getattr(first, name),
                                      getattr(fresh, name))
