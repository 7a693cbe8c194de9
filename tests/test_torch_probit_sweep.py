"""The probit tasks' sweeps in the port against the TPU package's, float64,
three chained sweeps on each engine, the port fed the variates JAX draws
from its own key splits (the pattern of test_torch_categorical.py and
test_torch_joint.py), plus ``init_categorical_state``.

Tolerance: 1e-10 of each field's scale.  The latent draws invert the
same log-space CDFs (ops/special.py, held to JAX at 1e-12) and the
ordered task's Newton mode stops on the same tests, so the chains agree
to the summation-order rounding of the sweeps themselves.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.design_categorical import try_compile_categorical as jcompile
from myfm_tpu.ops import categorical as jcat
from myfm_tpu.ops import gibbs as jgibbs
from myfm_tpu.ops import oprobit as jop
from myfm_tpu.ops.forward import predict_score as jax_score
from myfm_tpu_torch.convert import (
    categorical_state_from_numpy,
    plan_from_numpy,
    state_from_numpy,
)
from myfm_tpu_torch.ops import categorical as tcat
from myfm_tpu_torch.ops import gibbs as tgibbs
from myfm_tpu_torch.ops import oprobit as top

from .test_torch_categorical import _cf_blocks, _jax_sweep_variates
from .test_torch_joint import jax_sweep_variates, relational_plan

R = 3
# the TPU package's sweeps and init jitted, as its trainers run them
# (one XLA compile instead of one per eager operation)
JAX_CAT_SWEEP = jax.jit(jcat.categorical_sweep, static_argnums=(5, 6))
JAX_CAT_INIT = jax.jit(jcat.init_categorical_state, static_argnums=(4,))
JAX_GIBBS_SWEEP = jax.jit(jgibbs.gibbs_sweep, static_argnums=(4,))
FIELDS = ("w0", "w", "V", "e", "alpha", "mu_w", "lambda_w", "mu_V",
          "lambda_V", "cutpoints", "oprobit_alpha", "n_mh_accept")


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, name):
    if want is None:
        assert got is None, name
        return
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= 1e-10 * scale, (name, err, scale)


def _targets(task, score_like, rng):
    """±1 labels or 4 ordered classes from a noisy latent score."""
    z = score_like + rng.normal(size=score_like.size)
    if task == "classification":
        return np.where(z > 0.3, 1.0, -1.0)
    return np.searchsorted([-0.8, 0.2, 1.1], z).astype(np.float64)


def _configs(task, **kw):
    extra = dict(n_class=4, n_classes=(4,)) if task == "ordered" else {}
    return (jgibbs.GibbsConfig(task=task, **extra, **kw),
            tgibbs.GibbsConfig(task=task, **extra, **kw))


def jax_latent_variates(key, task, n, dtype=jnp.float64, nu=5.0,
                        groups=(4,)):
    """(u_latent, oprobit) as JAX's probit refresh draws them from the
    sweep's last key split."""
    tiny = jnp.finfo(dtype).tiny
    if task == "classification":
        return T(jax.random.uniform(key, (n,), dtype, tiny, 1.0)), None
    k_mh, k_z = jax.random.split(key)
    u = T(jax.random.uniform(k_z, (n,), dtype, tiny, 1.0))
    mh = []
    for g, K in enumerate(groups):
        kg = k_mh if g == 0 else jax.random.fold_in(k_mh, g)
        k_prop, k_u = jax.random.split(kg)
        k_n, k_g = jax.random.split(k_prop)
        mh.append(top.OprobitVariates(
            normal=T(jax.random.normal(k_n, (K - 1,), dtype=dtype)),
            chi=T(jax.random.gamma(k_g, jnp.asarray(nu / 2.0, dtype),
                                   dtype=dtype)),
            u_accept=T(jax.random.uniform(k_u, (), dtype=dtype)),
        ))
    return u, tuple(mh)


def _cat_inputs(task, seed=0):
    blocks, y_reg, grouping = _cf_blocks(seed=seed, n=400)
    rng = np.random.RandomState(seed + 1)
    y = _targets(task, y_reg - y_reg.mean(), rng)
    g = np.asarray(grouping, np.int32)
    jp = jcompile(None, blocks, g, None, np.float64, rank=R,
                  fixed_ts=(64, 4))
    jcfg, tcfg = _configs(task)
    key = jax.random.PRNGKey(seed)
    k_init, k_e = jax.random.split(key)
    core = jgibbs.init_state(jp, R, 0.1, k_init, jcfg, np.float64)
    y_arg = jnp.asarray(y.astype(np.int32) if task == "ordered" else y)
    js = JAX_CAT_INIT(jp, core, y_arg, k_e, jcfg)
    return jp, plan_from_numpy(jp, "cpu"), y, y_arg, jcfg, tcfg, core, \
        js, k_e


@pytest.mark.parametrize("task", ["classification", "ordered"])
def test_init_categorical_state_matches_jax(task):
    jp, pp, y, _, _, tcfg, core, js, k_e = _cat_inputs(task)
    u = None
    if task == "ordered":
        u, _ = jax_latent_variates(k_e, "classification", pp.n_rows)
    ps = tcat.init_categorical_state(
        pp, state_from_numpy(core, "cpu"), T(y), tcfg, u)
    for f in FIELDS:
        close(getattr(ps.core, f), getattr(js.core, f), f"core.{f}")
    for f in ("tau", "sum_e", "sum_e2"):
        close(getattr(ps, f), getattr(js, f), f)


@pytest.mark.parametrize("task", ["classification", "ordered"])
def test_three_categorical_sweeps_match_jax(task):
    jp, pp, y, y_arg, jcfg, tcfg, _, js, _ = _cat_inputs(task, seed=2)
    ps = categorical_state_from_numpy(js, "cpu")
    key = jax.random.PRNGKey(11)
    y_float = jnp.asarray(y)
    jt = jcat.make_y_tiles(jp, y_float)
    pt = tcat.make_y_tiles(pp, T(y))
    yp = T(y).long() if task == "ordered" else T(y)
    for it in range(3):
        k = jax.random.fold_in(key, it)
        js = JAX_CAT_SWEEP(jp, js, y_arg, jt, k, jcfg, True)
        v = _jax_sweep_variates(k, jp, R, jcfg)
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
    assert float(ps.core.alpha) == 1.0


@pytest.mark.parametrize("task", ["classification", "ordered"])
def test_three_joint_sweeps_match_jax(task):
    jp, tp, rng = relational_plan(seed=3)
    jcfg, tcfg = _configs(task, joint_rows=True)
    y = _targets(task, 0.5 * rng.normal(size=tp.n_rows), rng)
    y_arg = jnp.asarray(y.astype(np.int32) if task == "ordered" else y)
    key = jax.random.PRNGKey(4)
    st = jgibbs.init_state(jp, R, 0.1, key, jcfg, np.float64)
    if task == "ordered":
        st = jop.initialize_oprobit_state(jp, st, y_arg, jcfg, key)
    else:
        st = dataclasses.replace(
            st, e=jax_score(jp, st.w0, st.w, st.V) - y_arg)
    ts = state_from_numpy(st, "cpu")
    yp = T(y).long() if task == "ordered" else T(y)
    for it in range(3):
        k = jax.random.fold_in(key, 1 + it)
        st = JAX_GIBBS_SWEEP(jp, st, y_arg, k, jcfg)
        v = jax_sweep_variates(k, jp, R, jcfg)
        v.gamma_alpha = None
        v.u_latent, v.oprobit = jax_latent_variates(
            jax.random.split(k, 9)[8], task, tp.n_rows)
        ts = tgibbs.gibbs_sweep(tp, ts, yp, v, tcfg)
        for f in FIELDS:
            close(getattr(ts, f), getattr(st, f), f"{it}:{f}")
