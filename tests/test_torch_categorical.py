"""The port's categorical fast path (myfm_tpu_torch/design_categorical.py,
myfm_tpu_torch/ops/categorical.py) against the TPU package's.

* Layout: every array of the tile packing is bit-equal to JAX's at the
  same pinned (T, S).
* Table pass and whole sweep, float64, the same inputs and the same
  standard variates in both packages (the JAX sweep's variates are
  recreated from its own key splits and injected into the port):
  1e-10 relative — the two evaluate the same formulas, differing only
  in summation order (~1e-15 per op, a few hundred ops deep).
* The residual-moment invariant of the port's own chain: 1e-8 relative,
  as in the JAX package's test.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.design_categorical import (
    compile_categorical_table as jax_compile_table,
    try_compile_categorical as jax_try_compile,
)
from myfm_tpu.ops import categorical as jcat
from myfm_tpu.ops.gibbs import GibbsConfig as JaxConfig
from myfm_tpu.ops.gibbs import init_state as jax_init_state
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch.convert import (
    categorical_state_from_numpy,
    plan_from_numpy,
)
from myfm_tpu_torch.design_categorical import (
    choose_tiling,
    compile_categorical_table,
    try_compile_categorical,
)
from myfm_tpu_torch.ops import categorical as tcat
from myfm_tpu_torch.ops.gibbs import GibbsConfig

LAYOUT_FIELDS = (
    "src", "slot", "slot_f", "ent_of_tile_row", "cont_in", "cont_out",
    "last_slot", "ent_slots", "final_part", "fin_win", "fin_idx",
    "fin_mask", "cardinality", "ent_main", "noise_feat",
)
STATIC_FIELDS = ("col_offset", "n_cols", "n_tiles", "tile_rows",
                 "tile_entities", "chunk_tiles", "max_fin")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (256, 4)])
@pytest.mark.parametrize("seed", [0, 5])
def test_table_layout_bit_equal(T, S, seed):
    rng = np.random.RandomState(seed)
    N, B = 650, 23
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6  # entity with zero rows
    ent[:200] = 9  # one entity spanning several tiles
    jt = jax_compile_table(ent, B, 4, N, np.float32, fixed_ts=(T, S),
                           derive_src_on_device=False)
    pt = compile_categorical_table(ent, B, 4, N, np.float32, "cpu",
                                   fixed_ts=(T, S))
    for field in LAYOUT_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(pt, field)), _np(getattr(jt, field)),
            err_msg=field,
        )
    for field in STATIC_FIELDS:
        assert getattr(pt, field) == getattr(jt, field), field


def _two_table_design(seed=1, N=300, B1=11, B2=7):
    rng = np.random.RandomState(seed)
    ent1 = rng.randint(0, B1, N)
    ent2 = rng.randint(0, B2, N)
    X1 = sps.csr_matrix((np.ones(N), (np.arange(N), ent1)), shape=(N, B1))
    X2 = sps.csr_matrix((np.ones(N), (np.arange(N), ent2)), shape=(N, B2))
    return rng, sps.hstack([X1, X2]).tocsr(), (ent1, ent2), (B1, B2)


def test_plan_bit_equal_including_cross_maps():
    rng, X, _, (B1, B2) = _two_table_design()
    blocks = [RelationBlock(rng.randint(0, 5, X.shape[0]),
                            sps.identity(5, format="csr"))]
    grouping = np.asarray([0] * B1 + [1] * B2 + [2] * 5, np.int32)
    jp = jax_try_compile(X, blocks, grouping, None, np.float64, rank=3,
                         fixed_ts=(32, 4))
    pp = try_compile_categorical(X, blocks, grouping, None, np.float64,
                                 "cpu", rank=3, fixed_ts=(32, 4))
    assert len(pp.tables) == len(jp.tables) == 2 + 1
    for pt, jt in zip(pp.tables, jp.tables):
        for field in LAYOUT_FIELDS:
            np.testing.assert_array_equal(
                _np(getattr(pt, field)), _np(getattr(jt, field)),
                err_msg=field,
            )
    for prow, jrow in zip(pp.cross_ent, jp.cross_ent):
        for pm, jm in zip(prow, jrow):
            np.testing.assert_array_equal(_np(pm), _np(jm))
    np.testing.assert_array_equal(_np(pp.group_index), _np(jp.group_index))
    np.testing.assert_array_equal(_np(pp.group_counts),
                                  _np(jp.group_counts))
    assert (pp.n_rows, pp.n_features, pp.n_groups) == (
        jp.n_rows, jp.n_features, jp.n_groups
    )


def test_choose_tiling_rule():
    """T from the shared-memory stage; S by modeled bytes — long
    entities pick few slots, short ones many."""
    long_ents = np.full(50, 4000)
    short_ents = np.full(5000, 3)
    T, S, infl = choose_tiling(long_ents, 32, 4)
    assert T == 256 and S == 1 and infl < 1.1
    T, S, infl = choose_tiling(short_ents, 32, 4)
    assert T == 256 and S >= 32 and infl < 1.5
    # float64 halves the rows a 48 KiB stage holds
    assert choose_tiling(long_ents, 32, 8)[0] == 128


def test_side_feature_table_raises():
    """A multi-hot block compiles to an entity+attribute table with
    ``allow_side``, and the Gibbs fast path runs it (it raised before the
    entity+attribute pass was ported; the name is kept): the trainer is
    built, its effective rows exist, and its chain takes a sweep.
    Without ``allow_side`` the block still compiles to no plan."""
    rng = np.random.RandomState(0)
    N = 50
    Xs = sps.csr_matrix(rng.random((6, 3)))  # a multi-hot block
    blocks = [RelationBlock(rng.randint(0, 6, N), Xs)]
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=2, allow_side=True,
                                   fixed_ts=(16, 2))
    assert plan.has_side and plan.side[0].n_cols == 3
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    tr = CategoricalGibbsTrainer(plan, rng.normal(size=N),
                                 GibbsConfig(task="regression"), 2, 0.1, 0,
                                 np.float64)
    assert tr.engine_name == "fastpath"
    assert tr.cfg.joint_tail_kernel is False  # the plain scan on the CPU
    w = torch.zeros(plan.n_features, dtype=torch.float64)
    (eff,) = tcat.eff_tables(plan, w, torch.ones(plan.n_features, 2,
                                                 dtype=torch.float64))
    assert eff.shape == (6, 4)
    pred, hist = tr.run(1, 1)
    assert hist.engine == "fastpath" and len(hist.hypers) == 1
    assert np.isfinite(pred.samples[0].w).all()
    assert try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=2) is None


def _hyper_inputs(rng, F, R, G_n):
    return dict(
        lambda_w=rng.random(G_n) + 0.5,
        mu_w=rng.normal(size=G_n) * 0.1,
        lambda_V=rng.random((G_n, R)) + 0.5,
        mu_V=rng.normal(size=(G_n, R)) * 0.1,
        noise_w=rng.normal(size=F),
        noise_V=rng.normal(size=(F, R)),
    )


@pytest.mark.parametrize("fit_linear", [True, False])
def test_table_pass_matches_jax(fit_linear):
    """Both table passes of a two-table design, chained, f64: the
    port's _table_pass equals JAX's _table_pass (interpret-mode Pallas
    kernel) given the same weights, hyperparameters and noise."""
    rng, X, _, (B1, B2) = _two_table_design()
    N, R, G_n = X.shape[0], 3, 2
    grouping = np.asarray([0] * B1 + [1] * B2, np.int32)
    jp = jax_try_compile(X, [], grouping, None, np.float64, rank=R,
                         fixed_ts=(32, 4))
    pp = try_compile_categorical(X, [], grouping, None, np.float64, "cpu",
                                 rank=R, fixed_ts=(32, 4))
    F = B1 + B2
    w = rng.normal(size=F)
    V = rng.normal(size=(F, R))
    tau = rng.normal(size=N)
    h = _hyper_inputs(rng, F, R, G_n)
    w0, alpha = 0.4, 1.7
    jcfg = JaxConfig(task="regression", fit_linear=fit_linear)
    pcfg = GibbsConfig(task="regression", fit_linear=fit_linear)
    jt = jcat.make_y_tiles(jp, jnp.asarray(tau))
    pt = tcat.make_y_tiles(pp, torch.as_tensor(tau))
    wj, Vj = jnp.asarray(w), jnp.asarray(V)
    wp, Vp = torch.as_tensor(w), torch.as_tensor(V)
    for ti in range(2):
        last = ti == 1
        wj, Vj, mj = jcat._table_pass(
            jp, ti, wj, Vj, w0, alpha,
            *[jnp.asarray(h[k]) for k in ("lambda_w", "mu_w",
                                          "lambda_V", "mu_V")],
            jp.group_index, jnp.asarray(h["noise_w"]),
            jnp.asarray(h["noise_V"]), jt[ti], jcfg, True,
            want_moments=last,
        )
        wp, Vp, mp = tcat._table_pass(
            pp, ti, wp, Vp, w0, alpha,
            *[torch.as_tensor(h[k]) for k in ("lambda_w", "mu_w",
                                              "lambda_V", "mu_V")],
            pp.group_index, torch.as_tensor(h["noise_w"]),
            torch.as_tensor(h["noise_V"]), pt[ti], pcfg,
            want_moments=last,
        )
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-10)
    np.testing.assert_allclose(Vp.numpy(), np.asarray(Vj), rtol=1e-10)
    for a, b in zip(mp, mj):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-10)
    if not fit_linear:
        np.testing.assert_array_equal(wp.numpy(), w)


def _jax_sweep_variates(key, plan, rank, cfg, dtype=jnp.float64):
    """The standard variates JAX's categorical_sweep draws from ``key``
    (the same splits and calls as ops/categorical.py:771-816 and
    ops/gibbs.draw_lambda / draw_mu)."""
    (k_alpha, k_w0, k_lw, k_mw, k_w, k_lv, k_mv, k_v, _) = (
        jax.random.split(key, 9)
    )
    counts = plan.group_counts
    G, F = plan.n_groups, plan.n_features
    return dict(
        gamma_alpha=jax.random.gamma(
            k_alpha, jnp.asarray((cfg.alpha_0 + plan.n_real) / 2.0, dtype),
            dtype=dtype,
        ),
        normal_w0=jax.random.normal(k_w0, (), dtype=dtype),
        gamma_lambda_w=jax.random.gamma(
            k_lw, ((cfg.alpha_0 + counts) / 2.0).astype(dtype), dtype=dtype
        ),
        normal_mu_w=jax.random.normal(k_mw, (G,), dtype=dtype),
        gamma_lambda_V=jax.random.gamma(
            k_lv, ((cfg.alpha_0 + counts[:, None]) / 2.0).astype(dtype),
            dtype=dtype,
        ),
        normal_mu_V=jax.random.normal(k_mv, (G, rank), dtype=dtype),
        noise_w=jax.random.normal(k_w, (F,), dtype=dtype),
        noise_V=jax.random.normal(k_v, (F, rank), dtype=dtype),
    )


def _cf_blocks(seed=0, n=600, n_users=31, n_items=19):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    y = (
        1.5
        + rng.normal(size=n_users)[u]
        + rng.normal(size=n_items)[i]
        + 0.3 * rng.normal(size=n)
    )
    blocks = [
        RelationBlock(u, sps.identity(n_users, format="csr")),
        RelationBlock(i, sps.identity(n_items, format="csr")),
    ]
    return blocks, y, [0] * n_users + [1] * n_items


@pytest.mark.parametrize("fit_w0", [True, False])
@pytest.mark.parametrize("plan_from", ["compiled", "converted"])
def test_sweep_matches_jax_with_injected_variates(fit_w0, plan_from):
    """Three chained sweeps of the whole fast path, f64: JAX's
    categorical_sweep vs the port's, the port fed JAX's own variates,
    on its own plan or on JAX's plan carried across."""
    blocks, y, grouping = _cf_blocks()
    R = 3
    g = np.asarray(grouping, np.int32)
    jp = jax_try_compile(None, blocks, g, None, np.float64, rank=R,
                         fixed_ts=(64, 4))
    if plan_from == "compiled":
        pp = try_compile_categorical(None, blocks, g, None, np.float64,
                                     "cpu", rank=R, fixed_ts=(64, 4))
    else:
        pp = plan_from_numpy(jp, "cpu")
    jcfg = JaxConfig(task="regression", fit_w0=fit_w0)
    pcfg = GibbsConfig(task="regression", fit_w0=fit_w0)
    key = jax.random.PRNGKey(0)
    yj = jnp.asarray(y)
    core = jax_init_state(jp, R, 0.1, key, jcfg, np.float64)
    js = jcat.init_categorical_state(jp, core, yj, key, jcfg)
    ps = categorical_state_from_numpy(js, "cpu")
    yp = torch.as_tensor(y)
    jt = jcat.make_y_tiles(jp, yj)
    pt = tcat.make_y_tiles(pp, yp)
    for it in range(3):
        k = jax.random.fold_in(key, it)
        js = jcat.categorical_sweep(jp, js, yj, jt, k, jcfg, interpret=True)
        v = tcat.SweepVariates(**{
            name: torch.as_tensor(np.array(a))
            for name, a in _jax_sweep_variates(k, jp, R, jcfg).items()
        })
        ps = tcat.categorical_sweep(pp, ps, yp, pt, v, pcfg)
        for f in ("w0", "w", "V", "alpha", "mu_w", "lambda_w", "mu_V",
                  "lambda_V"):
            np.testing.assert_allclose(
                _np(getattr(ps.core, f)), np.asarray(getattr(js.core, f)),
                rtol=1e-10, atol=1e-12, err_msg=f"sweep {it} {f}",
            )
        np.testing.assert_allclose(float(ps.sum_e), float(js.sum_e),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(ps.sum_e2), float(js.sum_e2),
                                   rtol=1e-10)


def test_sweep_residual_invariant():
    """The carried (Σe, Σe²) after the port's own sweeps equal the
    moments of the recomputed residual score − y."""
    blocks, y, grouping = _cf_blocks(seed=3)
    R = 3
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=R)
    cfg = GibbsConfig(task="regression")
    gen = torch.Generator().manual_seed(0)
    from myfm_tpu_torch.ops.gibbs import init_state

    core = init_state(plan, R, 0.1, gen, cfg, torch.float64, "cpu")
    yp = torch.as_tensor(y)
    state = tcat.init_categorical_state(plan, core, yp, cfg)
    y_tiles = tcat.make_y_tiles(plan, yp)
    for _ in range(3):
        v = tcat.draw_sweep_variates(plan, cfg, R, gen, torch.float64,
                                     "cpu")
        state = tcat.categorical_sweep(plan, state, yp, y_tiles, v, cfg)
    score, _ = tcat.score_and_q(plan, state.core.w0, state.core.w,
                                state.core.V)
    e_true = (score - yp).numpy()
    np.testing.assert_allclose(float(state.sum_e), e_true.sum(), rtol=1e-8)
    np.testing.assert_allclose(float(state.sum_e2), (e_true**2).sum(),
                               rtol=1e-8)
    # the chained score_rows agrees with the unchunked score
    np.testing.assert_allclose(
        tcat.score_rows(plan, state.core.w0, state.core.w, state.core.V,
                        row_chunk=128).numpy(),
        score.numpy(), rtol=1e-12,
    )


def test_plain_flag_runs_the_same_sweep():
    """plain=True (the comparison path on the card) gives the same
    sweep on CPU tensors."""
    blocks, y, grouping = _cf_blocks(seed=4, n=300)
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=2)
    cfg = GibbsConfig(task="regression")
    gen = torch.Generator().manual_seed(1)
    from myfm_tpu_torch.ops.gibbs import init_state

    core = init_state(plan, 2, 0.1, gen, cfg, torch.float64, "cpu")
    yp = torch.as_tensor(y)
    state = tcat.init_categorical_state(plan, core, yp, cfg)
    y_tiles = tcat.make_y_tiles(plan, yp)
    v = tcat.draw_sweep_variates(plan, cfg, 2, gen, torch.float64, "cpu")
    a = tcat.categorical_sweep(plan, state, yp, y_tiles, v, cfg)
    b = tcat.categorical_sweep(plan, state, yp, y_tiles, v, cfg, plain=True)
    for f in (f.name for f in dataclasses.fields(a.core)):
        x, z = getattr(a.core, f), getattr(b.core, f)
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), z.numpy())


def test_probit_tasks_raise():
    """The probit tasks run on the fast path now (test_torch_probit_sweep);
    what still raises is a task the sweep does not know, and an ordered
    task without cutpoint groups."""
    blocks, y, grouping = _cf_blocks(n=300)
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=2)
    gen = torch.Generator()
    v = tcat.draw_sweep_variates(plan, GibbsConfig(task="classification"),
                                 2, gen, torch.float64, "cpu")
    assert v.gamma_alpha is None and v.u_latent.shape == (plan.n_rows,)
    assert float(v.u_latent.min()) > 0.0
    for cfg, match in ((GibbsConfig(task="poisson"), "unknown task"),
                       (GibbsConfig(task="ordered"), "cutpoint")):
        with pytest.raises(ValueError, match=match):
            tcat.draw_sweep_variates(plan, cfg, 2, gen, torch.float64, "cpu")
