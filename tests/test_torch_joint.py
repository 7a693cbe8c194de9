"""The port's joint engine (myfm_tpu_torch/ops/joint.py and the merged
branch of ops/gibbs.gibbs_sweep) against the TPU package's, step by step
and sweep by sweep, on the same plans, states and standard variates.

Tolerance: float64, 1e-10 relative to each output's scale.  The two
packages evaluate the same formulas in another summation order (~1e-15
per op); the whole sweeps chain a few hundred colors, whose rounding
grows by well under two orders of magnitude.  The JAX sweep's variates
are recreated from the same 9 key splits its ``gibbs_sweep`` makes and
injected into the port.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from myfm_tpu import design as jdesign
from myfm_tpu.ops import gibbs as jgibbs
from myfm_tpu.ops import joint as jjoint
from myfm_tpu.ops.forward import factor_q as jax_factor_q
from myfm_tpu.ops.forward import predict_score as jax_score
from myfm_tpu.relational import RelationBlock as JaxBlock
from myfm_tpu_torch.convert import design_plan_from_numpy, state_from_numpy
from myfm_tpu_torch.ops import gibbs as tgibbs
from myfm_tpu_torch.ops import joint as tjoint

TOL = 1e-10


def close(got, want, tol=TOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (name, err, scale)


def T(a):
    return torch.as_tensor(np.array(a))


def relational_plan(seed=8, joint_dense=True, max_unrolled_colors=2,
                    n=400, nu=40, ni=18, with_main=True):
    """Both packages' plans of one design: a date main table, a user
    block [one-hot id | N-hot implicit items] and a one-hot item block
    (the timeSVD++ shape at a small size)."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    imp = sps.csr_matrix((rng.random((nu, ni)) > 0.7).astype(np.float64)
                         * (0.5 + rng.random((nu, ni))))
    blocks = [JaxBlock(u, sps.hstack([sps.identity(nu, format="csr"), imp],
                                     format="csr")),
              JaxBlock(i, sps.identity(ni, format="csr"))]
    X = (sps.csr_matrix((np.ones(n), (np.arange(n), rng.randint(0, 7, n))),
                        shape=(n, 7)) if with_main else None)
    jp = jdesign.compile_design(
        X, blocks, grouping=None, dtype=np.float64, for_training=True,
        joint_dense=joint_dense, max_unrolled_colors=max_unrolled_colors,
    )
    return jp, design_plan_from_numpy(jp, "cpu"), rng


def random_joint_inputs(plan, R, rng):
    F, N = plan.n_features, plan.n_rows
    return dict(
        e=rng.normal(size=N), w=0.3 * rng.normal(size=F),
        V=0.3 * rng.normal(size=(F, R)), alpha=1.7,
        lambda_w=np.abs(rng.normal(size=plan.n_groups)) + 0.5,
        mu_w=0.1 * rng.normal(size=plan.n_groups),
        lambda_V=np.abs(rng.normal(size=(plan.n_groups, R))) + 0.5,
        mu_V=0.1 * rng.normal(size=(plan.n_groups, R)),
    )


# ---------------------------------------------------------------------------
# The batched sampler
# ---------------------------------------------------------------------------


def spd_problem(Bn, D, seed):
    rng = np.random.RandomState(seed)
    M = rng.normal(size=(Bn, D, D))
    S = M @ M.transpose(0, 2, 1) / D
    lam = np.abs(rng.normal(size=(Bn, D))) + 0.1
    A = 1.3 * S + lam[:, :, None] * np.eye(D)
    return A, rng.normal(size=(Bn, D)), rng.normal(size=(Bn, D)), lam


@pytest.mark.parametrize("D", [1, 2, 5, 11, 33])
def test_chol_solve_sample_matches_jax(D):
    A, rhs, xi, lam = spd_problem(9, D, seed=D)
    close(tjoint.chol_solve_sample(T(A), T(rhs), T(xi), T(lam)),
          jjoint.chol_solve_sample(jnp.asarray(A), jnp.asarray(rhs),
                                   jnp.asarray(xi), jnp.asarray(lam)))
    close(tjoint.chol_solve_sample(T(A), T(rhs), T(xi)),
          jjoint.chol_solve_sample(jnp.asarray(A), jnp.asarray(rhs),
                                   jnp.asarray(xi)))


def test_pivot_floor_on_an_indefinite_matrix_matches_jax():
    """A computed pivot below λ (here exactly negative) is lifted to λ in
    both packages: the floor is what keeps a rank-deficient S drawable."""
    A = np.array([[[1.0, 1.0, 0.2], [1.0, 1.0 - 1e-3, 0.1],
                   [0.2, 0.1, 2.0]]])
    lam = np.array([[0.5, 0.5, 0.5]])
    rhs, xi = np.array([[0.3, -0.2, 1.0]]), np.array([[0.1, 0.4, -0.7]])
    got = tjoint.chol_solve_sample(T(A), T(rhs), T(xi), T(lam))
    want = jjoint.chol_solve_sample(jnp.asarray(A), jnp.asarray(rhs),
                                    jnp.asarray(xi), jnp.asarray(lam))
    close(got, want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("D", [4, 32, 33, 40])
def test_solve_spd_sample_both_branches_match_jax(D):
    A, rhs, xi, lam = spd_problem(6, D, seed=100 + D)
    close(tjoint.solve_spd_sample(T(A), T(rhs), T(xi), T(lam)),
          jjoint.solve_spd_sample(jnp.asarray(A), jnp.asarray(rhs),
                                  jnp.asarray(xi), jnp.asarray(lam)))


# ---------------------------------------------------------------------------
# Steps of the sweep
# ---------------------------------------------------------------------------


def _gathered(plan, inp):
    w, V = inp["w"], inp["V"]
    U = np.concatenate([w[:, None], V], axis=1)
    lam = np.concatenate([inp["lambda_w"][:, None], inp["lambda_V"]], 1)
    mu = np.concatenate([inp["mu_w"][:, None], inp["mu_V"]], 1)
    return U, lam, mu


def test_joint_u_color_main_matches_jax():
    jp, tp, rng = relational_plan()
    R = 3
    inp = random_joint_inputs(tp, R, rng)
    U, lam, mu = _gathered(tp, inp)
    noise = rng.normal(size=(tp.n_features, R + 1))
    q = rng.normal(size=(tp.n_rows, R))
    for jc, tc in zip(jp.main.colors, tp.main.colors):
        want = jjoint._joint_u_color_main(
            jc, jnp.asarray(inp["e"]), jnp.asarray(q), jnp.asarray(U),
            inp["alpha"], jnp.asarray(lam), jnp.asarray(mu),
            jnp.asarray(noise), jp.group_index)
        got = tjoint._joint_u_color_main(
            tc, T(inp["e"]), T(q), T(U), inp["alpha"], T(lam), T(mu),
            T(noise), tp.group_index)
        for name, g, w in zip(("e", "q", "U"), got, want):
            close(g, w, name=name)


@pytest.mark.parametrize("flat", [False, True])
def test_build_block_gram_matches_jax(flat):
    jp, tp, rng = relational_plan()
    e, q = rng.normal(size=tp.n_rows), rng.normal(size=(tp.n_rows, 3))
    for jb, tb in zip(jp.blocks, tp.blocks):
        got = tjoint.build_block_gram(tb, T(e), T(q), row_chunk=150,
                                      flat=flat)
        want = jjoint.build_block_gram(jb, jnp.asarray(e), jnp.asarray(q),
                                       row_chunk=150, flat=flat)
        close(got, want)


def _lanes_gram(tb, rng, R):
    e = rng.normal(size=tb.mapper.shape[0])
    q = rng.normal(size=(tb.mapper.shape[0], R))
    G = tjoint.build_block_gram(tb, T(e), T(q), flat=True).T.contiguous()
    return G.numpy()


def test_dense_color_step_and_gram_update_match_jax():
    jp, tp, rng = relational_plan()
    R, D = 3, 5
    inp = random_joint_inputs(tp, R, rng)
    U, lam, mu = _gathered(tp, inp)
    noise = rng.normal(size=(tp.n_features, R + 1))
    b = tp.blocks[0]
    G = _lanes_gram(b, rng, R)
    gi = tp.group_index.numpy()
    for dc in b.dense_colors:
        f = np.minimum(dc.feat.numpy(), tp.n_features - 1)
        args = (dc.xw.numpy(), dc.segb.numpy(), U[f], lam[gi[f]],
                mu[gi[f]], noise[f])
        got = tjoint._dense_color_step(T(G), *map(T, args), inp["alpha"], D)
        want = jjoint._dense_color_step(jnp.asarray(G),
                                        *map(jnp.asarray, args),
                                        inp["alpha"], D)
        for name, g, w in zip(("u_new", "a0", "A_B"), got, want):
            close(g, w, name=name)
        a0, A_B = want[1], want[2]
        close(tjoint._update_gram_lanes(T(G), T(a0), T(A_B), D),
              jjoint._update_gram_lanes(jnp.asarray(G), a0, A_B, D))


def test_identity_color_apply_matches_jax():
    jp, tp, rng = relational_plan()
    R, D = 3, 5
    inp = random_joint_inputs(tp, R, rng)
    U, lam, mu = _gathered(tp, inp)
    noise = rng.normal(size=(tp.n_features, R + 1))
    b, jb = tp.blocks[0], jp.blocks[0]
    assert b.dense_colors[0].id_feat is not None
    G = _lanes_gram(b, rng, R)
    B = b.block_size
    Atot, Ct = 0.05 * rng.normal(size=(R, B)), 0.05 * rng.normal(size=B)
    got = tjoint._identity_color_apply(
        b.dense_colors[0], T(G), T(Atot), T(Ct), T(U), inp["alpha"], T(lam),
        T(mu), T(noise), tp.group_index, D)
    want = jjoint._identity_color_apply(
        jb.dense_colors[0], jnp.asarray(G), jnp.asarray(Atot),
        jnp.asarray(Ct), jnp.asarray(U), inp["alpha"], jnp.asarray(lam),
        jnp.asarray(mu), jnp.asarray(noise), jp.group_index, D)
    for name, g, w in zip(("G", "Atot", "Ct", "U"), got, want):
        close(g, w, name=name)


@pytest.mark.parametrize("joint_dense", [True, False])
def test_sweep_joint_u_matches_jax(joint_dense):
    """The dense pass (head colors, identity step, stacked tail) and the
    ragged pass (the fallback when a block's dense operands exceed the
    budget) against the TPU package's sweep_joint_u."""
    jp, tp, rng = relational_plan(joint_dense=joint_dense)
    R = 3
    inp = random_joint_inputs(tp, R, rng)
    key = jax.random.PRNGKey(4)
    noise = jax.random.normal(key, (tp.n_features, R + 1),
                              dtype=jnp.float64)
    want = jjoint.sweep_joint_u(
        jp, jnp.asarray(inp["e"]), jnp.asarray(inp["w"]),
        jnp.asarray(inp["V"]), inp["alpha"], jnp.asarray(inp["lambda_w"]),
        jnp.asarray(inp["mu_w"]), jnp.asarray(inp["lambda_V"]),
        jnp.asarray(inp["mu_V"]), key)
    got = tjoint.sweep_joint_u(
        tp, T(inp["e"]), T(inp["w"]), T(inp["V"]), inp["alpha"],
        T(inp["lambda_w"]), T(inp["mu_w"]), T(inp["lambda_V"]),
        T(inp["mu_V"]), T(noise))
    for name, g, w in zip(("w", "V", "e", "q"), got, want):
        close(g, w, name=name)
    # e and q are maintained exactly by the pass: the forward agrees
    close(got[3], jax_factor_q(jp, want[1]), tol=1e-9, name="q vs X·V")


# ---------------------------------------------------------------------------
# Whole sweeps
# ---------------------------------------------------------------------------


def jax_sweep_variates(key, plan, rank, cfg, dtype=jnp.float64):
    """The standard variates JAX's gibbs_sweep draws from ``key``: the
    same 9 splits and the same calls (ops/gibbs.py:926-928, draw_alpha,
    draw_w0, draw_lambda, draw_mu, and sweep_joint_u's ξ)."""
    (k_alpha, k_w0, k_lw, k_mw, _, k_lv, k_mv, k_v, _) = (
        jax.random.split(key, 9))
    counts = plan.group_counts
    G, F = plan.n_groups, plan.n_features
    return tgibbs.GibbsVariates(
        gamma_alpha=T(jax.random.gamma(
            k_alpha, jnp.asarray((cfg.alpha_0 + plan.n_rows) / 2.0, dtype),
            dtype=dtype)),
        normal_w0=T(jax.random.normal(k_w0, (), dtype=dtype)),
        gamma_lambda_w=T(jax.random.gamma(
            k_lw, ((cfg.alpha_0 + counts) / 2.0).astype(dtype),
            dtype=dtype)),
        normal_mu_w=T(jax.random.normal(k_mw, (G,), dtype=dtype)),
        gamma_lambda_V=T(jax.random.gamma(
            k_lv, ((cfg.alpha_0 + counts[:, None]) / 2.0).astype(dtype),
            dtype=dtype)),
        normal_mu_V=T(jax.random.normal(k_mv, (G, rank), dtype=dtype)),
        noise=T(jax.random.normal(k_v, (F, rank + 1), dtype=dtype)),
    )


@pytest.mark.parametrize("with_main,joint_dense", [
    (True, True), (False, True), (True, False),
])
def test_three_gibbs_sweeps_match_jax(with_main, joint_dense):
    jp, tp, rng = relational_plan(seed=3, with_main=with_main,
                                  joint_dense=joint_dense)
    R = 3
    y = rng.normal(size=tp.n_rows)
    jcfg = jgibbs.GibbsConfig(task="regression", joint_rows=True)
    tcfg = tgibbs.GibbsConfig(task="regression", joint_rows=True)
    key = jax.random.PRNGKey(0)
    st = jgibbs.init_state(jp, R, 0.1, key, jcfg, np.float64)
    st = dataclasses.replace(
        st, e=jax_score(jp, st.w0, st.w, st.V) - jnp.asarray(y))
    ts = state_from_numpy(st, "cpu")
    for it in range(3):
        k = jax.random.fold_in(key, it)
        st = jgibbs.gibbs_sweep(jp, st, jnp.asarray(y), k, jcfg)
        ts = tgibbs.gibbs_sweep(tp, ts, T(y),
                                jax_sweep_variates(k, jp, R, jcfg), tcfg)
        for f in ("w0", "w", "V", "e", "alpha", "lambda_w", "mu_w",
                  "lambda_V", "mu_V"):
            close(getattr(ts, f), getattr(st, f), name=f"{it}:{f}")


def test_non_joint_sweeps_raise():
    _, tp, rng = relational_plan()
    st = tgibbs.GibbsState(*[None] * 9)
    for cfg in (tgibbs.GibbsConfig(joint_rows=False),
                tgibbs.GibbsConfig(joint_rows=True, fit_linear=False)):
        with pytest.raises(NotImplementedError, match="colored engine"):
            tgibbs.gibbs_sweep(tp, st, None, None, cfg)
    with pytest.raises(NotImplementedError, match="probit"):
        tgibbs.gibbs_sweep(tp, st, None, None, tgibbs.GibbsConfig(
            task="classification", joint_rows=True))
