"""The port's row-space CAVI (myfm_tpu_torch/ops/variational.py) against
the TPU package's, float64, for the regression and the probit
classification task, on three designs:

* ``multihot``: the 200 x 12 multi-hot main table (no fast-path plan);
* ``relational``: a multi-hot main table plus two multi-hot
  RelationBlocks, compiled with two unrolled colors per table so that
  every table also has a stacked color tail (``ColorStack``; the block
  stacks run ``_vi_w_block_stack`` / ``_vi_V_block_stack``);
* ``serial``: the relational design with every feature its own color.

From one initial state (JAX's, carried across with ``convert``) and one
plan (JAX's, carried across), ``vi_sweep_w``, ``vi_sweep_V``,
``vi_update_e_and_var`` and three chained ``vi_sweep``s agree within
1e-10 of their scale; CAVI is deterministic, so the two differ only in
summation order.  Then the ELBO over 20 sweeps never falls, and the
estimators resolve to "colored" as JAX's do and land inside JAX's seed
spread.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.design import compile_design as jax_compile_design
from myfm_tpu.ops import variational as jv
from myfm_tpu_torch import (
    RelationBlock,
    VariationalFMClassifier,
    VariationalFMRegressor,
)
from myfm_tpu_torch.convert import design_plan_from_numpy, vi_state_from_numpy
from myfm_tpu_torch.design import compile_design
from myfm_tpu_torch.ops import variational as tv

from .vi_cases import as_np, close

R = 3
TASKS = ("regression", "classification")
DESIGNS = ("multihot", "relational", "serial")
_STATE_FIELDS = ("w0", "w0_var", "w", "w_var", "V", "V_var", "e",
                 "e_var_sum", "alpha", "alpha_rate", "mu_w", "mu_w_var",
                 "lambda_w", "lambda_w_rate", "mu_V", "mu_V_var",
                 "lambda_V", "lambda_V_rate", "elbo")


def _multihot(seed=0, n=200):
    rng = np.random.RandomState(seed)
    X = sps.random(n, 12, density=0.4, random_state=rng, format="csr")
    w = rng.normal(size=12)
    y = X @ w + 0.3 * rng.normal(size=n)
    return X, [], None, y


def _relational(seed=0, n=240, n_users=30, n_items=20):
    """Multi-hot main table and two multi-hot blocks (x in (0, 1])."""
    rng = np.random.RandomState(seed)
    X = sps.random(n, 5, density=0.5, random_state=rng, format="csr")
    tabs = []
    for size, width in ((n_users, 9), (n_items, 7)):
        d = sps.random(size, width, density=0.45, random_state=rng,
                       format="csr")
        d = d + sps.csr_matrix(
            (np.ones(size), (np.arange(size), np.arange(size) % width)),
            shape=(size, width))
        tabs.append((rng.randint(0, size, n), sps.csr_matrix(d)))
    y = (X @ rng.normal(size=5) + sum(
        (d @ rng.normal(size=d.shape[1]))[m] for m, d in tabs)
        + 0.3 * rng.normal(size=n))
    grouping = np.repeat(np.arange(3), [5, 9, 7]).astype(np.int32)
    return X, tabs, grouping, y


def _blocks(tabs, cls):
    return [cls(m, d) for m, d in tabs]


def _case(design, task):
    """(jax plan, port plan, y) for one design and task."""
    if design == "multihot":
        X, tabs, grouping, y = _multihot()
        kw = {}
    else:
        X, tabs, grouping, y = _relational()
        kw = dict(max_unrolled_colors=2,
                  strategy="serial" if design == "serial" else "auto")
    if task == "classification":
        y = np.where(y > np.median(y), 1.0, -1.0)
    jp = jax_compile_design(X, _blocks(tabs, myfm_tpu.RelationBlock),
                            grouping=grouping, dtype=np.float64, **kw)
    return jp, design_plan_from_numpy(jp, "cpu"), y


@pytest.fixture(scope="module")
def cases():
    return {(d, t): _case(d, t) for d in DESIGNS for t in TASKS}


def _init(jp, y, task):
    """JAX's initial state (its initialize_e) and the port's copy."""
    cfg = jv.VariationalConfig(task=task)
    st = jv.vi_init_state(jp, R, 0.1, jax.random.PRNGKey(0), cfg,
                          np.float64)
    e, ev = jv.vi_update_e_and_var(jp, st.w0, st.w0_var, st.w, st.w_var,
                                   st.V, st.V_var)
    yj = jnp.asarray(y)
    js = jv.VIState(**{**st.__dict__, "e": e - yj, "e_var_sum": ev})
    return cfg, js, vi_state_from_numpy(js, "cpu"), yj, torch.as_tensor(y)


def test_plans_carry_colour_stacks(cases):
    """The relational designs exercise the stacked color tails, and the
    port compiles the same plan as the one carried across."""
    jp, pp, _ = cases[("relational", "regression")]
    assert pp.main.color_stack is not None
    assert all(b.color_stack is not None for b in pp.blocks)
    X, tabs, grouping, _ = _relational()
    mine = compile_design(X, _blocks(tabs, RelationBlock), grouping=grouping,
                          dtype=np.float64, max_unrolled_colors=2,
                          device="cpu")
    for a, b in zip(mine.blocks, pp.blocks):
        np.testing.assert_array_equal(as_np(a.color_stack.rows),
                                      as_np(b.color_stack.rows))
        np.testing.assert_array_equal(as_np(a.color_stack.vals),
                                      as_np(b.color_stack.vals))


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("design", DESIGNS)
def test_sweep_w_matches_jax(cases, design, task):
    jp, pp, y = cases[(design, task)]
    cfg, js, ps, _, _ = _init(jp, y, task)
    want = jax.jit(jv.vi_sweep_w)(jp, js.e, js.w, js.w_var, js.alpha,
                                  js.lambda_w + 0.5, js.mu_w + 0.1)
    got = tv.vi_sweep_w(pp, ps.e, ps.w, ps.w_var, ps.alpha,
                        ps.lambda_w + 0.5, ps.mu_w + 0.1)
    for g, w, what in zip(got, want, ("e", "w", "w_var")):
        close(g, w, what=what)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("design", DESIGNS)
def test_sweep_V_matches_jax(cases, design, task):
    jp, pp, y = cases[(design, task)]
    cfg, js, ps, _, _ = _init(jp, y, task)
    want = jax.jit(jv.vi_sweep_V)(jp, js.e, js.V, js.V_var, js.alpha,
                                  js.lambda_V + 0.5, js.mu_V + 0.1)
    got = tv.vi_sweep_V(pp, ps.e, ps.V, ps.V_var, ps.alpha,
                        ps.lambda_V + 0.5, ps.mu_V + 0.1)
    for g, w, what in zip(got, want, ("e", "V", "V_var")):
        close(g, w, what=what)


@pytest.mark.parametrize("design", DESIGNS)
def test_update_e_and_var_matches_jax(cases, design):
    jp, pp, y = cases[(design, "regression")]
    rng = np.random.RandomState(4)
    F = pp.n_features
    m = [rng.normal(size=F), rng.random(F) * 0.3 + 0.05,
         rng.normal(size=(F, R)), rng.random((F, R)) * 0.3 + 0.05]
    want = jax.jit(jv.vi_update_e_and_var)(
        jp, 0.3, 0.01, *[jnp.asarray(a) for a in m])
    got = tv.vi_update_e_and_var(pp, torch.tensor(0.3, dtype=torch.float64),
                                 torch.tensor(0.01, dtype=torch.float64),
                                 *[torch.as_tensor(a) for a in m])
    close(got[0], want[0], what="score")
    close(got[1], want[1], what="Σ Var(score)")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("design", DESIGNS)
def test_three_sweeps_match_jax(cases, design, task):
    """Three chained vi_sweeps from JAX's initial state: every state
    field, the ELBO included, within 1e-10 of its scale."""
    jp, pp, y = cases[(design, task)]
    jcfg, js, ps, yj, yp = _init(jp, y, task)
    pcfg = tv.VariationalConfig(task=task)
    sweep = jax.jit(jv.vi_sweep, static_argnums=(3,))
    for it in range(3):
        js = sweep(jp, js, yj, jcfg)
        ps = tv.vi_sweep(pp, ps, yp, pcfg)
        for f in _STATE_FIELDS:
            close(getattr(ps, f), getattr(js, f), what=f"sweep {it} {f}")
    assert float(ps.elbo) != 0.0


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("design", DESIGNS)
def test_elbo_never_falls(cases, design, task):
    """Every CAVI step is an exact coordinate maximiser: over 20 f64
    sweeps the ELBO does not fall (beyond rounding)."""
    _, pp, y = cases[(design, task)]
    cfg = tv.VariationalConfig(task=task)
    state = tv.vi_init_state(pp, R, 0.1, torch.Generator().manual_seed(0),
                             cfg, torch.float64, "cpu")
    score, ev = tv.vi_update_e_and_var(pp, state.w0, state.w0_var, state.w,
                                       state.w_var, state.V, state.V_var)
    yp = torch.as_tensor(y)
    state = tv.VIState(**{**state.__dict__, "e": score - yp,
                          "e_var_sum": ev})
    elbos = []
    for _ in range(20):
        state = tv.vi_sweep(pp, state, yp, cfg)
        elbos.append(float(state.elbo))
    elbos = np.array(elbos)
    assert np.isfinite(elbos).all()
    assert (np.diff(elbos) >= -1e-9 * np.abs(elbos[1:])).all(), elbos


def _split(n, seed=7):
    idx = np.random.RandomState(seed).permutation(n)
    return idx[: int(0.8 * n)], idx[int(0.8 * n):]


def _fit_rowspace(mod, task, seed, strategy):
    """(engine, held-out RMSE or log-loss) of one fit of ``mod``'s
    estimator on the relational design."""
    X, tabs, grouping, y = _relational(n=400)
    tr, te = _split(X.shape[0])
    if task == "classification":
        y = (y > np.median(y)).astype(np.float64)
    est = (mod.VariationalFMClassifier if task == "classification"
           else mod.VariationalFMRegressor)
    kw = dict(rank=R, random_seed=seed, sweep_strategy=strategy,
              dtype=np.float64)
    if mod is not myfm_tpu:
        kw["device"] = "cpu"

    def blocks(rows):
        return [mod.RelationBlock(m[rows], d) for m, d in tabs]

    fm = est(**kw).fit(X[tr], y[tr], X_rel=blocks(tr), n_iter=30,
                       grouping=grouping)
    if task == "classification":
        p = np.clip(fm.predict_proba(X[te], blocks(te)), 1e-12, 1 - 1e-12)
        gt = y[te] > 0
        score = -np.mean(np.log(np.where(gt, p, 1 - p)))
    else:
        score = np.sqrt(np.mean((fm.predict(X[te], blocks(te)) - y[te]) ** 2))
    return fm.history_.engine, score


@pytest.mark.parametrize("strategy", ["auto", "serial"])
@pytest.mark.parametrize("task", TASKS)
def test_estimator_within_jax_seed_spread(task, strategy):
    """Both estimators resolve to "colored" as JAX's do, and their
    held-out RMSE / log-loss lies inside JAX's 3-seed spread, widened by
    half its width plus 2%."""
    jax_scores, port_scores = [], []
    for seed in (1, 2, 3):
        eng_j, sj = _fit_rowspace(myfm_tpu, task, seed, strategy)
        eng_p, sp = _fit_rowspace(myfm_tpu_torch, task, seed,
                                  strategy)
        assert eng_j == eng_p == "colored"
        jax_scores.append(sj)
        port_scores.append(sp)
    lo, hi = min(jax_scores), max(jax_scores)
    slack = 0.5 * (hi - lo) + 0.02 * hi
    for s in port_scores:
        assert lo - slack <= s <= hi + slack, (port_scores, jax_scores)


def test_colored_strategy_on_onehot_design():
    """sweep_strategy="colored" sends even an all-one-hot design to the
    row-space sweep, in both packages."""
    rng = np.random.RandomState(2)
    u, i = rng.randint(0, 15, 150), rng.randint(0, 10, 150)
    y = rng.normal(size=15)[u] + rng.normal(size=10)[i]

    def blocks(mod):
        return [mod.RelationBlock(u, sps.identity(15, format="csr")),
                mod.RelationBlock(i, sps.identity(10, format="csr"))]

    ref = myfm_tpu.VariationalFMRegressor(
        rank=2, sweep_strategy="colored").fit(None, y, X_rel=blocks(myfm_tpu),
                                              n_iter=3)
    fm = VariationalFMRegressor(rank=2, sweep_strategy="colored",
                                device="cpu").fit(
        None, y, X_rel=blocks(myfm_tpu_torch), n_iter=3)
    assert ref.history_.engine == fm.history_.engine == "colored"
    assert np.isfinite(fm.predict(None, blocks(myfm_tpu_torch))
                       ).all()
    assert VariationalFMClassifier(rank=2, device="cpu").fit(
        None, (y > 0).astype(float),
        X_rel=blocks(myfm_tpu_torch), n_iter=2,
    ).history_.engine == "fastpath"
