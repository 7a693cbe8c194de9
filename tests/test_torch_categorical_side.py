"""The port's entity+attribute (EA) tables on the Gibbs fast path
(myfm_tpu_torch/ops/categorical.py ``eff_tables``, ``_ea_table_pass``,
``categorical_sweep``; ops/forward_categorical.py) against the TPU
package's, float64 on the CPU, the JAX Pallas kernel in interpret mode.

Tolerances:

* effective rows, scores, one EA pass and three chained sweeps with the
  same weights and standard variates in both packages: 1e-10 of each
  field's scale (max |JAX|, at least 1).  Both evaluate the same
  formulas and differ only in summation order (~1e-15 per op, a few
  hundred colors deep);
* one EA pass against an independent per-row numpy oracle of the
  per-color (R+1)-joint draws: 1e-9 relative (the oracle sums over rows,
  the pass over Gram entries);
* the residual invariant of the port's own chain: 1e-8 relative, as in
  the JAX package's test;
* serving: 1e-12 of scale between the entity-space scorer, the
  row-space scorer and JAX's;
* the fitted estimator is distributional (JAX's threefry and torch's
  Philox draw different chains): the port's held-out RMSE, averaged over
  two seeds, inside the TPU package's three-seed range widened by that
  range on each side.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.design_categorical import try_compile_categorical as jcompile
from myfm_tpu.ops import categorical as jcat
from myfm_tpu.ops import forward_categorical as jfc
from myfm_tpu.ops import gibbs as jgibbs
from myfm_tpu_torch.convert import categorical_state_from_numpy
from myfm_tpu_torch.design import compile_design
from myfm_tpu_torch.design_categorical import try_compile_categorical
from myfm_tpu_torch.ops import categorical as tcat
from myfm_tpu_torch.ops import forward_categorical as tfc
from myfm_tpu_torch.ops import gibbs as tgibbs
from myfm_tpu_torch.predictor import _rows_reduce

from .test_categorical_side import _ea_problem
from .test_torch_categorical import _jax_sweep_variates
from .test_torch_probit_sweep import jax_latent_variates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

R = 3
HYPERS = ("lambda_w", "mu_w", "lambda_V", "mu_V")
FIELDS = ("w0", "w", "V", "e", "alpha", "mu_w", "lambda_w", "mu_V",
          "lambda_V", "cutpoints", "oprobit_alpha", "n_mh_accept")
JAX_CAT_SWEEP = jax.jit(jcat.categorical_sweep, static_argnums=(5, 6))
JAX_CAT_INIT = jax.jit(jcat.init_categorical_state, static_argnums=(4,))


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, what, tol=1e-10):
    if want is None:
        assert got is None, what
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def tiny():
    """The synthetic "tiny" MovieLens fold with the timeSVD++-flipped
    features: its user and item blocks are [one-hot | implicit 1/√n]
    (side values outside {0, 1})."""
    from ml_features import build_feature_blocks, load_movielens

    tr, te = load_movielens("tiny", 0, synthetic=True)
    Xtr, Xte, btr, bte, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    return (Xtr, btr, tr.rating.values.astype(np.float64), Xte, bte,
            te.rating.values.astype(np.float64),
            np.asarray(grouping, np.int32))


def _ungrouped():
    """test_categorical_side.py:292: one ungrouped non-one-hot block,
    compiled as a single EA table over the whole block."""
    rng = np.random.RandomState(5)
    N, B = 300, 11
    m = rng.randint(0, B, N)
    tbl = rng.random((B, 6)) * (rng.random((B, 6)) < 0.5)
    return None, [myfm_tpu_torch.RelationBlock(m, sps.csr_matrix(tbl))], None


def _case(name, tiny=None):
    """(X, blocks, grouping) of a named EA design."""
    if name == "ea_problem":
        _, blocks, grouping, _ = _ea_problem(seed=1)
        return None, blocks, grouping
    if name == "ungrouped":
        return _ungrouped()
    X, blocks, _, _, _, _, grouping = tiny
    return X, blocks, grouping


def _plans(X, blocks, grouping, ts=(32, 4), rank=R):
    kw = dict(rank=rank, allow_side=True, fixed_ts=ts)
    jp = jcompile(X, blocks, grouping, None, np.float64, **kw)
    pp = try_compile_categorical(X, blocks, grouping, None, np.float64,
                                 "cpu", **kw)
    assert jp is not None and pp is not None and pp.has_side
    assert [s is None for s in pp.side] == [s is None for s in jp.side]
    return jp, pp


def _weights(plan, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    F, G = plan.n_features, plan.n_groups
    return rng, dict(
        w=scale * rng.normal(size=F),
        V=scale * rng.normal(size=(F, R)),
        lambda_w=rng.random(G) + 0.5,
        mu_w=rng.normal(size=G) * 0.1,
        lambda_V=rng.random((G, R)) + 0.5,
        mu_V=rng.normal(size=(G, R)) * 0.1,
        noise_w=rng.normal(size=F),
        noise_V=rng.normal(size=(F, R)),
    )


# ---------------------------------------------------------------------------
# (a) effective rows and scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ea_problem", "tiny"])
def test_eff_rows_and_scores_match_jax(case, tiny):
    jp, pp = _plans(*_case(case, tiny))
    _, h = _weights(pp, 0)
    w0 = 0.7
    jw, jV = jnp.asarray(h["w"]), jnp.asarray(h["V"])
    pw, pV = T(h["w"]), T(h["V"])
    jeff = jcat.eff_tables(jp, jw, jV)
    peff = tcat.eff_tables(pp, pw, pV)
    for ti, (a, b) in enumerate(zip(peff, jeff)):
        assert (a is None) == (b is None), ti
        if a is None:
            continue
        close(a, b, f"eff[{ti}]")
        idx = pp.tables[ti].ent_main
        close(tcat._eff_rows(pw, pV, pp.tables[ti], a, idx),
              jcat._eff_rows(jw, jV, jp.tables[ti], b,
                             jnp.asarray(idx.numpy())), f"rows[{ti}]")
    close(tcat.score_rows(pp, w0, pw, pV, row_chunk=128),
          jcat.score_rows(jp, w0, jw, jV), "score_rows")
    s, q = tcat.score_and_q(pp, w0, pw, pV)
    js, jq = jcat.score_and_q(jp, w0, jw, jV)
    close(s, js, "score_and_q score")
    close(q, jq, "score_and_q Q")


def test_eff_rows_are_full_float32_under_tf32_settings(tiny):
    """float32 effective rows are products at full precision whatever
    the process's matmul settings (the float64 result rounded once)."""
    X, blocks, _, _, _, _, grouping = tiny
    pp = try_compile_categorical(X, blocks, grouping, None, np.float32,
                                 "cpu", rank=R, allow_side=True)
    _, h = _weights(pp, 2)
    pw, pV = T(h["w"]).float(), T(h["V"]).float()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = tcat.eff_tables(pp, pw, pV)
    finally:
        torch.set_float32_matmul_precision(before)
    for si, g in zip(pp.side, got):
        if si is None:
            continue
        fc = si.feat_cols.long()
        w_s, V_s = pw[fc], pV[fc]

        def dot(a, b):
            return (a.double() @ b.double()).float()

        want = torch.cat([dot(si.xs, w_s[:, None]), dot(si.xs, V_s),
                          dot(si.xs * si.xs, V_s * V_s).sum(1, keepdim=True)],
                         1)
        assert g.dtype == torch.float32
        assert torch.equal(g, want.float())


# ---------------------------------------------------------------------------
# (b) one EA table pass
# ---------------------------------------------------------------------------


def _ea_pass_both(jp, pp, ti, h, tau, w0=0.4, alpha=1.7, want=True):
    jt = jcat.make_y_tiles(jp, jnp.asarray(tau))
    pt = tcat.make_y_tiles(pp, T(tau))
    jfn = jax.jit(lambda plan, *a: jcat._ea_table_pass(
        plan, ti, *a, jgibbs.GibbsConfig(task="regression"), True,
        want_moments=want))
    jw, jV, jm = jfn(jp, jnp.asarray(h["w"]), jnp.asarray(h["V"]), w0, alpha,
                     *[jnp.asarray(h[k]) for k in HYPERS], jp.group_index,
                     jnp.asarray(h["noise_w"]), jnp.asarray(h["noise_V"]),
                     jt[ti])
    pw, pV, pm = tcat._ea_table_pass(
        pp, ti, T(h["w"]), T(h["V"]), w0, alpha,
        *[T(h[k]) for k in HYPERS], pp.group_index, T(h["noise_w"]),
        T(h["noise_V"]), pt[ti], tgibbs.GibbsConfig(), want_moments=want)
    return (jw, jV, jm), (pw, pV, pm)


@pytest.mark.parametrize("case", ["ea_problem", "ungrouped", "tiny"])
def test_ea_table_pass_matches_jax(case, tiny):
    """Every EA table of the design, f64, the same weights, priors and
    noise: w, V and the moments (Σe, Σe²) of the scanned Gram."""
    jp, pp = _plans(*_case(case, tiny))
    rng, h = _weights(pp, 1)
    tau = rng.normal(size=pp.n_rows) + 3.0
    for ti, si in enumerate(pp.side):
        if si is None:
            continue
        (jw, jV, jm), (pw, pV, pm) = _ea_pass_both(jp, pp, ti, h, tau)
        close(pw, jw, f"{case} table {ti} w")
        close(pV, jV, f"{case} table {ti} V")
        for k in range(2):
            close(pm[k], jm[k], f"{case} table {ti} moment {k}")
        # the side features moved; no other feature did
        side = np.zeros(pp.n_features, bool)
        side[si.feat_cols.numpy()] = True
        assert not np.allclose(pw.numpy()[side], h["w"][side])
        np.testing.assert_array_equal(pw.numpy()[~side], h["w"][~side])


def test_ea_pass_matches_numpy_oracle():
    """_ea_table_pass == an independent numpy walk of the colors in
    row space (test_categorical_side.py:76): each side feature's
    [w_j | V_j] from its exact (R+1)-dim Gaussian conditional with the
    same noise, e and Q kept per row."""
    (m1, side, m2), blocks, grouping, rng = _ea_problem(seed=1)
    N = m1.shape[0]
    B1, Fs = side.shape
    pp = try_compile_categorical(None, blocks, grouping, None, np.float64,
                                 "cpu", rank=R, allow_side=True,
                                 fixed_ts=(32, 4))
    assert pp.side[2] is not None
    F = pp.n_features
    _, h = _weights(pp, 4, scale=1.0)
    w0, alpha = 0.4, 1.7
    tau = rng.normal(size=N)
    pt = tcat.make_y_tiles(pp, T(tau))
    w2, V2, moments = tcat._ea_table_pass(
        pp, 2, T(h["w"]), T(h["V"]), w0, alpha,
        *[T(h[k]) for k in HYPERS], pp.group_index, T(h["noise_w"]),
        T(h["noise_V"]), pt[2], tgibbs.GibbsConfig(), want_moments=True)

    w_o, V_o = h["w"].copy(), h["V"].copy()
    gi = pp.group_index.numpy()
    x_of = side[m1]
    o2 = B1 + Fs + m2
    lin = w_o[m1] + w_o[o2] + x_of @ w_o[B1 : B1 + Fs]
    Q = V_o[m1] + V_o[o2] + x_of @ V_o[B1 : B1 + Fs]
    QS = V_o[m1] ** 2 + V_o[o2] ** 2 + (x_of**2) @ V_o[B1 : B1 + Fs] ** 2
    e = w0 + lin + 0.5 * (Q**2 - QS).sum(axis=1) - tau
    for color in pp.side[2].stack_feat.numpy():
        for f in color:
            if f >= F:
                continue
            x = x_of[:, f - B1]
            psi = x[:, None] * np.concatenate(
                [np.ones((N, 1)), Q - x[:, None] * V_o[f]], axis=1)
            S = psi.T @ psi
            lam = np.concatenate([[h["lambda_w"][gi[f]]],
                                  h["lambda_V"][gi[f]]])
            mu = np.concatenate([[h["mu_w"][gi[f]]], h["mu_V"][gi[f]]])
            u_old = np.concatenate([[w_o[f]], V_o[f]])
            A = alpha * S + np.diag(lam)
            rhs = alpha * (S @ u_old - psi.T @ e) + lam * mu
            xi = np.concatenate([[h["noise_w"][f]], h["noise_V"][f]])
            u_new = np.linalg.solve(A, rhs) + np.linalg.solve(
                np.linalg.cholesky(A).T, xi)
            delta = u_new - u_old
            e = e + psi @ delta
            Q = Q + x[:, None] * delta[1:]
            w_o[f], V_o[f] = u_new[0], u_new[1:]
    np.testing.assert_allclose(w2.numpy(), w_o, rtol=1e-9)
    np.testing.assert_allclose(V2.numpy(), V_o, rtol=1e-9)
    np.testing.assert_allclose(float(moments[0]), e.sum(), rtol=1e-9)
    np.testing.assert_allclose(float(moments[1]), (e**2).sum(), rtol=1e-9)


def test_scan_is_the_color_step_without_carry(tiny):
    """``ea_color_scan`` (the joint tail's plain version with a zero
    Atot/Ct carry, dropped) gives the bits of the TPU package's scan
    body, ``_dense_color_step`` then ``_update_gram_lanes`` per color:
    the Gram's evolution does not read the carry."""
    from myfm_tpu_torch.ops.joint import (
        _dense_color_step,
        _update_gram_lanes,
    )
    from myfm_tpu_torch.tools.joint_tail import ea_stacks
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    X, blocks, y, _, _, _, grouping = tiny
    pp = try_compile_categorical(X, blocks, grouping, None, np.float64,
                                 "cpu", rank=R, allow_side=True)
    tr = CategoricalGibbsTrainer(pp, y, tgibbs.GibbsConfig(), R, 0.1, 0,
                                 np.float64)
    D = R + 2
    for st in ea_stacks(pp, tr, tr._initialize(), R):
        Gf, _, _, xw, segb, u0, lam, mu, xi = st["ops"]
        alpha = st["alpha"]
        G, u = tcat.ea_color_scan(Gf, xw, segb, u0, lam, mu, xi, alpha, D)
        us = []
        for c in range(xw.shape[0]):
            u_new, a0, A_B = _dense_color_step(
                Gf, xw[c], segb[c], u0[c], lam[c], mu[c], xi[c], alpha, D)
            Gf = _update_gram_lanes(Gf, a0, A_B, D)
            us.append(u_new)
        assert torch.equal(G, Gf)
        assert torch.equal(u, torch.stack(us))


# ---------------------------------------------------------------------------
# (c) three chained sweeps per task, (d) the residual invariant
# ---------------------------------------------------------------------------


def _targets(task, n, rng):
    z = rng.normal(size=n)
    if task == "regression":
        return 3.0 + z
    if task == "classification":
        return np.where(z > 0.3, 1.0, -1.0)
    return np.searchsorted([-0.8, 0.2, 1.1], z).astype(np.float64)


@pytest.mark.parametrize("task", ["regression", "classification", "ordered"])
def test_three_ea_sweeps_match_jax(task):
    """categorical_sweep three times on an EA plan, f64, the port fed
    JAX's own variates (its key splits recreated), from JAX's initial
    state carried across."""
    _, blocks, grouping, rng = _ea_problem(seed=2)
    jp, pp = _plans(None, blocks, grouping, ts=(128, 8))
    y = _targets(task, pp.n_rows, rng)
    extra = dict(n_class=4, n_classes=(4,)) if task == "ordered" else {}
    jcfg = jgibbs.GibbsConfig(task=task, **extra)
    tcfg = tgibbs.GibbsConfig(task=task, **extra)
    key = jax.random.PRNGKey(5)
    k_init, k_e = jax.random.split(key)
    core = jgibbs.init_state(jp, R, 0.1, k_init, jcfg, np.float64)
    y_arg = jnp.asarray(y.astype(np.int32) if task == "ordered" else y)
    js = JAX_CAT_INIT(jp, core, y_arg, k_e, jcfg)
    ps = categorical_state_from_numpy(js, "cpu")
    jt = jcat.make_y_tiles(jp, jnp.asarray(y))
    pt = tcat.make_y_tiles(pp, T(y))
    yp = T(y).long() if task == "ordered" else T(y)
    for it in range(3):
        k = jax.random.fold_in(key, it)
        js = JAX_CAT_SWEEP(jp, js, y_arg, jt, k, jcfg, True)
        v = _jax_sweep_variates(k, jp, R, jcfg)
        u = mh = None
        if task != "regression":
            v["gamma_alpha"] = None
            u, mh = jax_latent_variates(jax.random.split(k, 9)[8], task,
                                        pp.n_rows)
        ps = tcat.categorical_sweep(
            pp, ps, yp, pt,
            tcat.SweepVariates(**{n: None if a is None else T(a)
                                  for n, a in v.items()},
                               u_latent=u, oprobit=mh),
            tcfg)
        for f in FIELDS:
            close(getattr(ps.core, f), getattr(js.core, f), f"{it}:{f}")
        for f in ("tau", "sum_e", "sum_e2"):
            close(getattr(ps, f), getattr(js, f), f"{it}:{f}")


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_ea_sweep_residual_invariant(task):
    """The carried (Σe, Σe²) after the port's own EA sweeps equal the
    moments of the recomputed residual score − target."""
    (m1, _, _), blocks, grouping, rng = _ea_problem(seed=3)
    pp = try_compile_categorical(None, blocks, grouping, None, np.float64,
                                 "cpu", rank=2, allow_side=True,
                                 fixed_ts=(64, 4))
    y = _targets(task, m1.shape[0], rng)
    cfg = tgibbs.GibbsConfig(task=task)
    gen = torch.Generator().manual_seed(0)
    core = tgibbs.init_state(pp, 2, 0.1, gen, cfg, torch.float64, "cpu")
    yp = T(y)
    state = tcat.init_categorical_state(pp, core, yp, cfg)
    y_tiles = tcat.make_y_tiles(pp, yp)
    for _ in range(3):
        v = tcat.draw_sweep_variates(pp, cfg, 2, gen, torch.float64, "cpu")
        state = tcat.categorical_sweep(pp, state, yp, y_tiles, v, cfg)
    score = tcat.score_rows(pp, state.core.w0, state.core.w, state.core.V)
    target = y if task == "regression" else state.tau.numpy()
    e_true = score.numpy() - target
    np.testing.assert_allclose(float(state.sum_e), e_true.sum(), rtol=1e-8)
    np.testing.assert_allclose(float(state.sum_e2), (e_true**2).sum(),
                               rtol=1e-8)


# ---------------------------------------------------------------------------
# (e) serving, (f) the estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ea_problem", "ungrouped", "tiny"])
def test_ea_serving_matches_rows_and_jax(case, tiny):
    """compile_categorical_inference peels the blocks as JAX does, and
    its scores of three samples equal the row-space scorer's and JAX's
    (sum, probit and ordered modes)."""
    X, blocks, _ = _case(case, tiny)
    jplan = jfc.compile_categorical_inference(X, blocks, np.float64)
    tplan = tfc.compile_categorical_inference(X, blocks, np.float64, "cpu")
    assert tplan is not None and any(t.xs is not None for t in tplan.tables)
    assert [(t.col_offset, t.n_cols, t.xs is None) for t in tplan.tables] == [
        (t.col_offset, t.n_cols, t.xs is None) for t in jplan.tables]
    rng = np.random.RandomState(0)
    S, F = 3, tplan.n_features
    w0s, ws = rng.normal(size=S), rng.normal(size=(S, F))
    Vs = 0.3 * rng.normal(size=(S, F, R))
    cps = np.sort(rng.normal(size=(S, 3)), axis=1)
    rows = compile_design(X, blocks, dtype=np.float64, for_training=False,
                          device="cpu")
    for mode, cp in (("sum", None), ("probit_sum", None),
                     ("oprobit_sum", cps)):
        got = tfc.scores_samples_reduce(
            tplan, T(w0s), T(ws), T(Vs), mode=mode,
            cutpoints=None if cp is None else T(cp), row_chunk=256)
        want = jfc.scores_samples_reduce(
            jplan, jnp.asarray(w0s), jnp.asarray(ws), jnp.asarray(Vs),
            mode=mode, cutpoints=None if cp is None else jnp.asarray(cp),
            row_chunk=256)
        close(got, want, f"{case} {mode} vs JAX", tol=1e-12)
        close(got, _rows_reduce(rows, T(w0s), T(ws), T(Vs), mode,
                                None if cp is None else T(cp)),
              f"{case} {mode} vs rows", tol=1e-12)


@pytest.fixture
def jax_engine_only(monkeypatch):
    """The TPU package's trainers report their resolved engine without
    running a sweep."""
    from myfm_tpu import trainer as jtrainer
    from myfm_tpu.containers import LearningHistory as JaxHistory

    def run(self, n_iter, n_kept_samples, callback=None, *a, **k):
        return None, JaxHistory(engine=self.engine_name)

    for cls in (jtrainer.GibbsTrainer, jtrainer.CategoricalGibbsTrainer):
        monkeypatch.setattr(cls, "run", run)


@pytest.mark.parametrize("est", ["MyFMGibbsRegressor", "MyFMGibbsClassifier",
                                 "MyFMOrderedProbit"])
@pytest.mark.parametrize("n_iter,strategy,want", [
    (199, "auto", "fastpath"), (200, "auto", "joint"),
    (200, "categorical", "fastpath")])
def test_engine_resolution_matches_jax(est, n_iter, strategy, want, tiny,
                                       jax_engine_only):
    """The three Gibbs estimators resolve the tiny timeSVD++ design as
    JAX does: the EA fast path below 200 sweeps (or when asked for), the
    joint engine at 200; the port's fit stops after its first sweep."""
    Xtr, btr, r, _, _, _, grouping = tiny
    y = {"MyFMGibbsRegressor": r, "MyFMGibbsClassifier": (r >= 4) * 1,
         "MyFMOrderedProbit": (r - 1).astype(np.int64)}[est]
    kw = dict(X_rel=btr, n_iter=n_iter, n_kept_samples=1, grouping=grouping)
    ref = getattr(myfm_tpu, est)(rank=3, sweep_strategy=strategy).fit(
        Xtr, y, **kw)
    seen = []
    ours = getattr(myfm_tpu_torch, est)(
        rank=3, sweep_strategy=strategy, device="cpu").fit(
        Xtr, y, callback=lambda i, *a: seen.append(i) or (True, None), **kw)
    assert ref.history_.engine == ours.history_.engine == want
    assert seen == [0]


def test_trainer_resolves_the_scan_route(tiny):
    """On an EA plan the trainer resolves ``joint_tail_kernel`` as the
    joint engine does: off on the CPU, and asking for the kernel there
    raises; a one-hot plan leaves it unresolved."""
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    X, blocks, y, _, _, _, grouping = tiny
    pp = try_compile_categorical(X, blocks, grouping, None, np.float64,
                                 "cpu", rank=R, allow_side=True)
    tr = CategoricalGibbsTrainer(pp, y, tgibbs.GibbsConfig(), R, 0.1, 0,
                                 np.float64)
    assert tr.cfg.joint_tail_kernel is False
    with pytest.raises(ValueError, match="plain"):
        CategoricalGibbsTrainer(
            pp, y, tgibbs.GibbsConfig(joint_tail_kernel=True), R, 0.1, 0)
    rng = np.random.RandomState(0)
    onehot = [myfm_tpu_torch.RelationBlock(
        rng.randint(0, 7, 50), sps.identity(7, format="csr"))]
    p1 = try_compile_categorical(None, onehot, None, None, np.float64, "cpu",
                                 rank=R, fixed_ts=(16, 2))
    tr1 = CategoricalGibbsTrainer(p1, rng.normal(size=50),
                                  tgibbs.GibbsConfig(), R, 0.1, 0)
    assert tr1.cfg.joint_tail_kernel is None


def test_tiny_rmse_within_jax_seed_spread(tiny):
    """MyFMGibbsRegressor "auto" at 12 sweeps on the tiny timeSVD++
    design, both packages on their EA fast path."""
    Xtr, btr, ytr, Xte, bte, yte, grouping = tiny

    def rmse(mod, seed, **kw):
        fm = mod.MyFMGibbsRegressor(rank=4, random_seed=seed, **kw).fit(
            Xtr, ytr, X_rel=btr, n_iter=12, n_kept_samples=6,
            grouping=grouping)
        assert fm.history_.engine == "fastpath"
        return float(np.sqrt(np.mean((fm.predict(Xte, bte) - yte) ** 2)))

    ref = [rmse(myfm_tpu, s) for s in (1, 2, 3)]
    ours = np.mean([rmse(myfm_tpu_torch, s, device="cpu") for s in (1, 2)])
    assert ours < yte.std()
    spread = max(ref) - min(ref)
    assert min(ref) - spread <= ours <= max(ref) + spread, (ours, ref)
