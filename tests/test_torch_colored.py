"""The port's colored Gibbs engine and joint-row factor sweep
(myfm_tpu_torch/ops/gibbs.py: ``sweep_w``, ``sweep_V``,
``sweep_V_joint`` and their color steps) against the TPU package's,
float64, on the three row-space designs of test_torch_vi_rowspace.py:

* ``multihot``: a 200 x 12 multi-hot main table, no blocks;
* ``relational``: a multi-hot main table plus two multi-hot
  RelationBlocks, two unrolled colors per table, so that every table
  also has a stacked color tail;
* ``serial``: the relational design with every feature its own color.

From one plan and one state (JAX's, carried across with ``convert``),
each color step and each sweep (JAX's keys replayed into the port's
noise columns: column 0 for w, 1..R for the factors) agree within 1e-10
of their scale: the same draws from the same variates, summed in another
order.  Three chained ``gibbs_sweep``s per task and engine are in
test_torch_colored_chain.py (their JAX compiles are most of the cost).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.ops import gibbs as jg
from myfm_tpu.ops.forward import factor_q_single as jax_factor_q_single
from myfm_tpu.ops.forward import predict_score as jax_score
from myfm_tpu_torch.ops import gibbs as tg
from myfm_tpu_torch.ops.forward import factor_q_single

from .test_torch_joint import colored_noise
from .test_torch_vi_rowspace import DESIGNS, _case
from .vi_cases import close

R = 3
ALPHA = 1.7


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def plans():
    return {d: _case(d, "regression")[:2] for d in DESIGNS}


def _inputs(plan, seed=5):
    """Residuals, weights and hyperparameters of a mid-chain state."""
    rng = np.random.RandomState(seed)
    F, G = plan.n_features, plan.n_groups
    return dict(
        e=rng.normal(size=plan.n_rows), w=0.3 * rng.normal(size=F),
        V=0.3 * rng.normal(size=(F, R)),
        lam_w=np.abs(rng.normal(size=G)) + 0.5,
        mu_w=0.1 * rng.normal(size=G),
        lam_V=np.abs(rng.normal(size=(G, R))) + 0.5,
        mu_V=0.1 * rng.normal(size=(G, R)),
        noise=rng.normal(size=(F, R)),
    )


def _both(inp, *names):
    return ([jnp.asarray(inp[n]) for n in names],
            [torch.as_tensor(inp[n]) for n in names])


def _compare(got, want, names):
    for g, w, n in zip(got, want, names):
        close(g, w, what=n)


def _tables(jp, pp):
    """(what, JAX table, port table, block?) with an unrolled color."""
    out = [("main", jp.main, pp.main, False)]
    out += [(f"block{i}", jb, pb, True)
            for i, (jb, pb) in enumerate(zip(jp.blocks, pp.blocks))]
    return out


@pytest.mark.parametrize("design", DESIGNS)
def test_factor_q_single_matches_jax(plans, design):
    jp, pp = plans[design]
    v = np.random.RandomState(1).normal(size=pp.n_features)
    close(factor_q_single(pp, T(v)), jax_factor_q_single(jp, jnp.asarray(v)))


@pytest.mark.parametrize("design", DESIGNS)
def test_w_color_steps_match_jax(plans, design):
    """``_w_color_main`` / ``_w_color_block`` on each table's first
    unrolled color and ``_w_block_stack`` on each block's stack."""
    jp, pp = plans[design]
    inp = _inputs(pp)
    (je, jw, jl, jm, jn), (te, tw, tl, tm, tn) = _both(
        inp, "e", "w", "lam_w", "mu_w", "noise")
    jn, tn = jn[:, 0], tn[:, 0]
    jgi, tgi = jp.group_index, pp.group_index
    for what, jt, pt, block in _tables(jp, pp):
        if block:
            want = jax.jit(jg._w_color_block)(jt, jt.colors[0], je, jw,
                                              ALPHA, jl, jm, jn, jgi)
            got = tg._w_color_block(pt, pt.colors[0], te, tw, ALPHA, tl,
                                    tm, tn, tgi)
            _compare(got, want, (f"{what} e", f"{what} w"))
            want = jax.jit(jg._w_block_stack)(jt, jt.color_stack, je, jw,
                                              ALPHA, jl, jm, jn, jgi)
            got = tg._w_block_stack(pt, pt.color_stack, te, tw, ALPHA, tl,
                                    tm, tn, tgi)
            _compare(got, want, (f"{what} stack e", f"{what} stack w"))
        else:
            want = jax.jit(jg._w_color_main)(jt.colors[0], je, jw, ALPHA, jl,
                                             jm, jn, jgi)
            got = tg._w_color_main(pt.colors[0], te, tw, ALPHA, tl, tm, tn,
                                   tgi)
            _compare(got, want, (f"{what} e", f"{what} w"))


@pytest.mark.parametrize("design", DESIGNS)
def test_V_color_steps_match_jax(plans, design):
    """``_V_color_main`` / ``_V_color_block`` / ``_V_block_stack`` for
    one factor column, from its factor sums q."""
    jp, pp = plans[design]
    inp = _inputs(pp, seed=6)
    (je, jV, jl, jm, jn), (te, tV, tl, tm, tn) = _both(
        inp, "e", "V", "lam_V", "mu_V", "noise")
    jv, tv, jl, tl, jm, tm, jn, tn = (jV[:, 1], tV[:, 1], jl[:, 1], tl[:, 1],
                                      jm[:, 1], tm[:, 1], jn[:, 1], tn[:, 1])
    jq, tq = jax_factor_q_single(jp, jv), factor_q_single(pp, tv)
    jgi, tgi = jp.group_index, pp.group_index
    names = ("e", "q", "v")
    for what, jt, pt, block in _tables(jp, pp):
        if block:
            want = jax.jit(jg._V_color_block)(jt, jt.colors[0], je, jq, jv,
                                              ALPHA, jl, jm, jn, jgi)
            got = tg._V_color_block(pt, pt.colors[0], te, tq, tv, ALPHA, tl,
                                    tm, tn, tgi)
            _compare(got, want, [f"{what} {n}" for n in names])
            want = jax.jit(jg._V_block_stack)(jt, jt.color_stack, je, jq, jv,
                                              ALPHA, jl, jm, jn, jgi)
            got = tg._V_block_stack(pt, pt.color_stack, te, tq, tv, ALPHA,
                                    tl, tm, tn, tgi)
            _compare(got, want, [f"{what} stack {n}" for n in names])
        else:
            want = jax.jit(jg._V_color_main)(jt.colors[0], je, jq, jv, ALPHA,
                                             jl, jm, jn, jgi)
            got = tg._V_color_main(pt.colors[0], te, tq, tv, ALPHA, tl, tm,
                                   tn, tgi)
            _compare(got, want, [f"{what} {n}" for n in names])


@pytest.mark.parametrize("design", DESIGNS)
def test_V_joint_color_steps_match_jax(plans, design):
    """``_V_joint_color_main``, ``_block_joint_stats``,
    ``_V_joint_block_color`` with ``_update_joint_stats``, and
    ``_V_joint_block_stack`` (the solver's unrolled branch, R = 3)."""
    jp, pp = plans[design]
    inp = _inputs(pp, seed=7)
    (je, jV, jl, jm, jn), (te, tV, tl, tm, tn) = _both(
        inp, "e", "V", "lam_V", "mu_V", "noise")
    from myfm_tpu.ops.forward import factor_q as jax_factor_q
    from myfm_tpu_torch.ops.forward import factor_q

    jq, tq = jax_factor_q(jp, jV), factor_q(pp, tV)
    jgi, tgi = jp.group_index, pp.group_index
    for what, jt, pt, block in _tables(jp, pp):
        if block:
            jst = jax.jit(jg._block_joint_stats)(jt, je, jq)
            tst = tg._block_joint_stats(pt, te, tq)
            _compare(tst, jst, [f"{what} {n}" for n in ("E1", "Q1", "EQ",
                                                        "QQ")])
            want = jax.jit(jg._V_joint_block_color)(
                jt, jt.colors[0], jst, jV, ALPHA, jl, jm, jn, jgi)
            got = tg._V_joint_block_color(pt, pt.colors[0], tst, tV, ALPHA,
                                          tl, tm, tn, tgi)
            _compare(got, want, [f"{what} {n}" for n in ("V", "A", "b2")])
            _compare(
                tg._update_joint_stats(tst, got[1], got[2], pt.cardinality),
                jax.jit(jg._update_joint_stats)(jst, want[1], want[2],
                                                jt.cardinality),
                [f"{what} updated {n}" for n in ("E1", "Q1", "EQ", "QQ")])
            want = jax.jit(jg._V_joint_block_stack)(
                jt, jt.color_stack, je, jq, jV, ALPHA, jl, jm, jn, jgi)
            got = tg._V_joint_block_stack(pt, pt.color_stack, te, tq, tV,
                                          ALPHA, tl, tm, tn, tgi)
            _compare(got, want, [f"{what} stack {n}" for n in "eqV"])
        else:
            want = jax.jit(jg._V_joint_color_main)(
                jt.colors[0], je, jq, jV, ALPHA, jl, jm, jn, jgi)
            got = tg._V_joint_color_main(pt.colors[0], te, tq, tV, ALPHA, tl,
                                         tm, tn, tgi)
            _compare(got, want, [f"{what} {n}" for n in "eqV"])


@pytest.mark.parametrize("sweep", ["sweep_w", "sweep_V", "sweep_V_joint"])
@pytest.mark.parametrize("design", DESIGNS)
def test_sweeps_match_jax(plans, design, sweep):
    """Whole sweeps over every color of every table, JAX's key replayed
    into the port's noise columns."""
    jp, pp = plans[design]
    inp = _inputs(pp, seed=8)
    key = jax.random.PRNGKey(3)
    noise = colored_noise(jax.random.fold_in(key, 0), pp.n_features, R,
                          sweep == "sweep_V_joint")
    keys = jax.random.split(jax.random.fold_in(key, 0), 9)
    k_w, k_v = keys[4], keys[7]
    if sweep == "sweep_w":
        (je, jw, jl, jm), (te, tw, tl, tm) = _both(inp, "e", "w", "lam_w",
                                                   "mu_w")
        want = jax.jit(jg.sweep_w)(jp, je, jw, ALPHA, jl, jm, k_w)
        got = tg.sweep_w(pp, te, tw, ALPHA, tl, tm, noise[:, 0])
        _compare(got, want, ("w", "e"))
        return
    (je, jV, jl, jm), (te, tV, tl, tm) = _both(inp, "e", "V", "lam_V",
                                               "mu_V")
    want = jax.jit(getattr(jg, sweep))(jp, je, jV, ALPHA, jl, jm, k_v)
    got = getattr(tg, sweep)(pp, te, tV, ALPHA, tl, tm, noise[:, 1:])
    _compare(got, want, ("V", "e"))
    # e is maintained exactly by the pass: the forward agrees
    w0 = jnp.asarray(0.0)
    close(got[1] - te, jax_score(jp, w0, jnp.zeros(pp.n_features), want[0])
          - jax_score(jp, w0, jnp.zeros(pp.n_features), jV), tol=1e-9,
          what="Δe vs the forward's")
