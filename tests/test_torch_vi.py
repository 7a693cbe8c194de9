"""The port's VI fast path (myfm_tpu_torch/ops/categorical_vi.py and the
entity+attribute plan of design_categorical.py) against the TPU
package's, pass by pass (tests/test_torch_vi_sweep.py has the whole
sweeps).

* Layout: ``compile_side_info`` and the entity+attribute plan of the tiny
  timeSVD++ design are bit-equal to JAX's at a pinned (T, S), in every
  array and dtype (the draw ids ``noise_feat`` are int64 in the port).
* ``_vi_table_pass`` (kernel 1's VI layout), ``_vi_ea_table_pass``
  (kernel 2 and the color scan), ``_vi_dense_color_step`` and
  ``_update_gram_lanes_u``, float64, from the same moments, JAX's Pallas
  kernels in interpret mode: 1e-10 of each output's scale (the same
  formulas, summed in another order).  The entity+attribute comparisons
  with JAX use side values x ∈ {0, 1} (the binarized tiny design), where
  the TPU package's color step is exact; for other x the port departs
  from it (its covariance term is a power of x short) and
  ``_vi_ea_table_pass`` is held to an independent per-coordinate numpy
  CAVI instead, at 1e-9 of scale.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from myfm_tpu.design_categorical import (
    compile_side_info as jax_side_info,
    try_compile_categorical as jax_compile,
)
from myfm_tpu.ops import categorical_vi as jvi
from myfm_tpu.ops.categorical import make_y_tiles as jax_y_tiles
from myfm_tpu.ops.variational import VariationalConfig as JaxConfig
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch.convert import plan_from_numpy
from myfm_tpu_torch.design_categorical import (
    SIDE_DENSE_ELEMS,
    SIDE_MAX_COLORS,
    compile_side_info,
    try_compile_categorical,
)
from myfm_tpu_torch.ops import categorical_vi as tvi
from myfm_tpu_torch.ops.categorical import make_y_tiles
from myfm_tpu_torch.ops.variational import VariationalConfig

from .vi_cases import (
    HYP,
    ORDER,
    R,
    STATIC_FIELDS,
    TABLE_FIELDS,
    as_np,
    close,
    ea_plans,
    load_tiny,
    moments,
    onehot_plans,
)


@pytest.fixture(scope="module")
def tiny():
    return load_tiny()


@pytest.fixture(scope="module")
def tiny_binary():
    return load_tiny(binary=True)


def _assert_side_equal(ps, js):
    for f in ("xs", "feat_cols", "stack_xw", "stack_segb", "stack_feat"):
        got, want = as_np(getattr(ps, f)), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ps.n_cols == js.n_cols


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ea_plan_bit_equal(tiny, dtype):
    X, blocks, grouping, _ = tiny
    kw = dict(rank=4 * R, allow_side=True, fixed_ts=(32, 4))
    jp = jax_compile(X, blocks, grouping, None, dtype, **kw)
    pp = try_compile_categorical(X, blocks, grouping, None, dtype, "cpu",
                                 **kw)
    assert len(pp.tables) == len(jp.tables) == 5
    assert [si is None for si in pp.side] == [si is None for si in jp.side]
    assert sum(si is not None for si in pp.side) == 2
    for pt, jt in zip(pp.tables, jp.tables):
        for f in TABLE_FIELDS:
            got, want = as_np(getattr(pt, f)), np.asarray(getattr(jt, f))
            if f != "noise_feat":  # the port's draw ids are int64
                assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f)
        for f in STATIC_FIELDS:
            assert getattr(pt, f) == getattr(jt, f), f
    for ps, js in zip(pp.side, jp.side):
        if ps is not None:
            _assert_side_equal(ps, js)
    for prow, jrow in zip(pp.cross_ent, jp.cross_ent):
        for pm, jm in zip(prow, jrow):
            np.testing.assert_array_equal(as_np(pm), np.asarray(jm))
    np.testing.assert_array_equal(as_np(pp.group_index),
                                  np.asarray(jp.group_index))
    np.testing.assert_array_equal(as_np(pp.group_counts),
                                  np.asarray(jp.group_counts))
    assert (pp.n_rows, pp.n_features, pp.n_groups) == (
        jp.n_rows, jp.n_features, jp.n_groups)
    # the converted JAX plan carries its SideInfo across unchanged
    for ps, js in zip(plan_from_numpy(jp, "cpu").side, jp.side):
        if js is not None:
            _assert_side_equal(ps, js)


@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 0.05), (2, 0.9)])
def test_compile_side_info_bit_equal(seed, density):
    rng = np.random.RandomState(seed)
    Xs = sps.csr_matrix(
        (rng.random((40, 25)) < density) * (0.5 + rng.random((40, 25))))
    col_ids = 7 + np.arange(25)
    ours = compile_side_info(Xs, col_ids, 200, np.float32, "cpu")
    _assert_side_equal(ours, jax_side_info(Xs, col_ids, 200, np.float32))


def test_side_gates_equal_jax():
    from myfm_tpu import design_categorical as jdc

    assert (SIDE_DENSE_ELEMS, SIDE_MAX_COLORS) == (
        jdc.SIDE_DENSE_ELEMS, jdc.SIDE_MAX_COLORS)
    # every column conflicts with every other: one color per column
    wide = sps.csr_matrix(np.ones((3, SIDE_MAX_COLORS + 1)))
    assert compile_side_info(wide, np.arange(wide.shape[1]), 10**5,
                             np.float32, "cpu") is None


def _pass_both(jp, pp, ti, m, tau, fn_j, fn_p, cfg_kw, w0=0.4, alpha=1.7,
               with_eff=False):
    jcfg, pcfg = JaxConfig(**cfg_kw), VariationalConfig(**cfg_kw)
    jm = [jnp.asarray(m[k]) for k in ORDER]
    pm = [torch.as_tensor(m[k]) for k in ORDER]
    jeff = jvi.vi_eff_tables(jp, *jm) if with_eff else None
    peff = tvi.vi_eff_tables(pp, *pm) if with_eff else None
    jt = jax_y_tiles(jp, jnp.asarray(tau))[ti]
    pt = make_y_tiles(pp, torch.as_tensor(tau))[ti]
    got = fn_p(pp, ti, *pm, w0, alpha,
               *[torch.as_tensor(m[k]) for k in HYP], pp.group_index, pt,
               pcfg, peff)
    want = fn_j(jp, ti, *jm, w0, alpha, *[jnp.asarray(m[k]) for k in HYP],
                jp.group_index, jt, jcfg, True, jeff)
    for name, a, b in zip(ORDER, got, want):
        close(a, b, what=name)
    return got


@pytest.mark.parametrize("fit_linear", [True, False])
def test_vi_table_pass_matches_jax(fit_linear):
    """All three tables of a one-hot design, f64: the port's
    _vi_table_pass (kernel 1's VI layout, plain) equals JAX's."""
    jp, pp, y, rng = onehot_plans()
    m = moments(rng, pp.n_features, pp.n_groups)
    for ti in range(3):
        got = _pass_both(jp, pp, ti, m, y, jvi._vi_table_pass,
                         tvi._vi_table_pass, dict(fit_linear=fit_linear))
        if not fit_linear:
            np.testing.assert_array_equal(got[0].numpy(), m["w"])


@pytest.mark.parametrize("ti", [1, 3, 4])
def test_vi_passes_on_the_ea_plan(tiny_binary, ti):
    """Table passes of the binarized tiny timeSVD++ EA plan, f64, from the
    same moments: table 1 (the one-hot user ids) reads the EA tables' side
    moments; tables 3 and 4 (the users' implicit items, the items'
    implicit users) run kernel 2 and the color scan."""
    jp, pp = ea_plans(tiny_binary)
    rng = np.random.RandomState(3)
    m = moments(rng, pp.n_features, pp.n_groups)
    ea = pp.side[ti] is not None
    assert ea == (ti >= 3)
    fns = ((jvi._vi_ea_table_pass, tvi._vi_ea_table_pass) if ea else
           (jvi._vi_table_pass, tvi._vi_table_pass))
    _pass_both(jp, pp, ti, m, tiny_binary[3], *fns, {}, with_eff=True)


def test_kernel_operands_are_contiguous(tiny):
    """The CUDA wrappers take only contiguous operands (and raise on
    others): every operand both VI generators yield is contiguous."""
    _, pp = ea_plans(tiny)
    rng = np.random.RandomState(4)
    m = [torch.as_tensor(a) for a in
         (lambda d: (d["w"], d["w_var"], d["V"], d["V_var"]))(
             moments(rng, pp.n_features, pp.n_groups))]
    eff = tvi.vi_eff_tables(pp, *m)
    tau = make_y_tiles(pp, torch.as_tensor(tiny[3]))
    ops = [*next(tvi.vi_gram_operands(pp, 1, *m, tau[1], eff)),
           *next(tvi.vi_ea_gram_operands(pp, 3, *m, 0.2, tau[3], eff))]
    flat = [t for o in ops for t in (o if isinstance(o, list) else [o])]
    assert all(t.is_contiguous() for t in flat)


def _ea_oracle_problem(seed, R_, N=400, B1=13, B2=9, Fs=5):
    """Block 1 = [one-hot id | Fs side columns with values in (0.2, 1.2)];
    block 2 one-hot (the JAX package's EA test design, non-binary)."""
    rng = np.random.RandomState(seed)
    m1 = rng.randint(0, B1, N)
    side = (0.2 + rng.random((B1, Fs))) * (rng.random((B1, Fs)) < 0.6)
    m2 = rng.randint(0, B2, N)
    blocks = [
        RelationBlock(m1, sps.hstack([sps.eye(B1, format="csr"),
                                      sps.csr_matrix(side)]).tocsr()),
        RelationBlock(m2, sps.eye(B2, format="csr")),
    ]
    grouping = np.asarray([0] * B1 + [1] * Fs + [2] * B2, np.int32)
    plan = try_compile_categorical(None, blocks, grouping, None, np.float64,
                                   "cpu", rank=3 * R_, allow_side=True,
                                   fixed_ts=(32, 4))
    assert plan.side[2] is not None
    return (m1, side, m2), plan, rng


@pytest.mark.parametrize("R_,seed", [(3, 1), (1, 2)])
def test_ea_pass_matches_per_coordinate_oracle(R_, seed):
    """``_vi_ea_table_pass`` on non-binary side values == a numpy CAVI that
    walks the plan's colors feature by feature and coordinate by
    coordinate (w, then V_1..V_R), each update computed from row-space
    sums and the x2s / x3sv caches X2S = Σx²s, X3SV = Σx³sv̄ of the
    reference (variational.hpp:450-713), maintained after every
    coordinate.  float64, 1e-9 of scale."""
    (m1, side, m2), plan, rng = _ea_oracle_problem(seed, R_)
    N = m1.shape[0]
    B1, Fs = side.shape
    F, G_n = plan.n_features, plan.n_groups
    w, w_var = rng.normal(size=F), rng.random(F) * 0.3 + 0.05
    V, V_var = rng.normal(size=(F, R_)), rng.random((F, R_)) * 0.3 + 0.05
    lam_w, mu_w = rng.random(G_n) + 0.5, rng.normal(size=G_n) * 0.1
    lam_V = rng.random((G_n, R_)) + 0.5
    mu_V = rng.normal(size=(G_n, R_)) * 0.1
    w0, alpha, tau = 0.4, 1.7, rng.normal(size=N)
    t = [torch.as_tensor(a) for a in (w, w_var, V, V_var)]
    got = tvi._vi_ea_table_pass(
        plan, 2, *t, w0, alpha, *[torch.as_tensor(a) for a in (
            lam_w, mu_w, lam_V, mu_V)], plan.group_index,
        make_y_tiles(plan, torch.as_tensor(tau))[2], VariationalConfig(),
        tvi.vi_eff_tables(plan, *t))

    gi = plan.group_index.numpy()
    w, w_var, V, V_var = w.copy(), w_var.copy(), V.copy(), V_var.copy()
    x_of = side[m1]  # [N, Fs]
    X = np.zeros((N, F))
    X[np.arange(N), m1] = 1.0
    X[:, B1 : B1 + Fs] = x_of
    X[np.arange(N), B1 + Fs + m2] = 1.0
    Q, X2S, X3SV = X @ V, (X**2) @ V_var, (X**3) @ (V_var * V)
    e = w0 + X @ w + 0.5 * (Q**2 - (X**2) @ V**2).sum(axis=1) - tau
    for color in plan.side[2].stack_feat.numpy():
        for f in color[color < F]:
            x = x_of[:, f - B1]
            x2, x3 = x * x, x * x * x
            g = gi[f]
            quad = alpha * x2.sum() + lam_w[g]
            lin = alpha * (x2.sum() * w[f] - (x * e).sum()) + lam_w[g] * mu_w[g]
            e = e + x * (lin / quad - w[f])
            w[f], w_var[f] = lin / quad, 1.0 / quad
            for r in range(R_):
                v, s = V[f, r], V_var[f, r]
                phi = Q[:, r] - x * v
                sig = X2S[:, r] - x2 * s
                quad = alpha * ((x2 * phi * phi).sum() + (x2 * sig).sum()) \
                    + lam_V[g, r]
                cov = (x * (Q[:, r] * sig - (X3SV[:, r] - x3 * s * v))).sum()
                lin = alpha * (-(x * e * phi).sum()
                               + v * (x2 * phi * phi).sum()
                               + v * (x2 * sig).sum() - cov) \
                    + lam_V[g, r] * mu_V[g, r]
                v_new, s_new = lin / quad, 1.0 / quad
                e = e + x * phi * (v_new - v)
                Q[:, r] += x * (v_new - v)
                X2S[:, r] += x2 * (s_new - s)
                X3SV[:, r] += x3 * (s_new * v_new - s * v)
                V[f, r], V_var[f, r] = v_new, s_new
    for name, a, b in zip(ORDER, got, (w, w_var, V, V_var)):
        close(a, b, 1e-9, name)


@pytest.mark.parametrize("fit_linear", [True, False])
@pytest.mark.parametrize("Pf,B", [(1, 30), (5, 60)])
def test_dense_color_step_and_gram_update_match_jax(fit_linear, Pf, B):
    """One color step on a random rectangle Gram (rows_r·D lanes-major),
    with pad slots and rows that no feature of the color touches, and
    side values x ∈ {0, 1}.  The port's Gram holds [1 | e | q | σ | τ]
    (D = 3R+2); JAX's [1 | e | q | a | b | c] (D = 4R+2), where for such x
    a = c = σ and b = τ, so JAX's input is the port's with the σ columns
    repeated, and its output's first 3R+2 columns are the port's."""
    rng = np.random.RandomState(Pf + B)
    D, rows_r = 3 * R + 2, 2 + R
    G = rng.normal(size=(rows_r, D, B))
    cols = np.r_[0:D, 2 + R : 2 + 2 * R]  # JAX's columns in the port's
    Gj = G[:, cols].reshape(rows_r * (D + R), B)
    G = G.reshape(rows_r * D, B)
    segb = rng.randint(0, Pf + 1, B).astype(np.int32)
    xw = (rng.random(B) < 0.8) * (segb < Pf) * 1.0
    u0 = rng.normal(size=(Pf, 1 + R))
    s0 = rng.random((Pf, 1 + R)) * 0.3 + 0.05
    lam = rng.random((Pf, 1 + R)) + 0.5
    mu = rng.normal(size=(Pf, 1 + R)) * 0.1
    rest = (xw, segb, u0, s0, lam, mu)
    got = tvi._vi_dense_color_step(
        *[torch.as_tensor(a) for a in (G,) + rest], 1.3, R, fit_linear)
    want = jvi._vi_dense_color_step(
        *[jnp.asarray(a) for a in (Gj,) + rest], 1.3, R, fit_linear)
    close(got[0], want[0], what="u_new")
    close(got[1], want[1], what="var_new")
    close(got[2].reshape(rows_r, D, B),
          np.asarray(want[2]).reshape(rows_r, D + R, B)[:, :D], what="G")
    s_vec = rng.normal(size=(D, B))
    u_vec = rng.normal(size=(D, B))
    close(tvi._update_gram_lanes_u(torch.as_tensor(G),
                                    torch.as_tensor(s_vec),
                                    torch.as_tensor(u_vec), D),
           jvi._update_gram_lanes_u(jnp.asarray(G), jnp.asarray(s_vec),
                                    jnp.asarray(u_vec), D))
