"""The port's ordered-probit cutpoint sampler (myfm_tpu_torch/ops/oprobit.py)
against the TPU package's (myfm_tpu/ops/oprobit.py), float64.

* Objective, gradient and Hessian: 1e-10 relative.  The port writes the
  derivatives out; JAX takes them by automatic differentiation.
* The Newton mode: 1e-8 (both stop on the same gradient-norm test, so
  they agree to well inside it).
* One MH step and the two-group update: the port is fed the variates
  JAX draws internally (the same key splits), and takes the same accept
  decisions; α and the latent residuals to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.gibbs import _encode_ordered_targets as jax_encode
from myfm_tpu.ops import oprobit as jop
from myfm_tpu_torch.gibbs import _encode_ordered_targets
from myfm_tpu_torch.ops import oprobit as top

REG, NU = 1.0, 5.0


def _data(seed=0, n=500, cps=(-1.0, -0.2, 0.5, 1.4)):
    rng = np.random.RandomState(seed)
    score = rng.normal(size=n) * 1.5
    z = score + rng.normal(size=n)
    y = np.searchsorted(np.asarray(cps), z).astype(np.int64)
    return rng, score, y, len(cps) + 1


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("weighted", [False, True])
def test_objective_gradient_hessian_match_jax(weighted):
    rng, score, y, K = _data()
    w = (rng.random_sample(score.size) > 0.3).astype(np.float64) \
        if weighted else None
    f_j, g_j, h_j = (jax.jit(fn) for fn in jop.make_objective_fns(
        jnp.asarray(score), jnp.asarray(y), K, REG,
        weight=None if w is None else jnp.asarray(w)))
    f_t, d_t = top.make_objective_fns(T(score), T(y), K, REG,
                                      None if w is None else T(w))
    for alpha in (np.zeros(K - 1), rng.normal(size=K - 1) * 0.5,
                  np.array([-2.0, 1.0, -1.5, 0.3])):
        fa, ga, ha = d_t(T(alpha))
        a = jnp.asarray(alpha)
        np.testing.assert_allclose(float(f_t(T(alpha))), float(f_j(a)),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(fa), float(f_j(a)), rtol=1e-12)
        np.testing.assert_allclose(ga.numpy(), np.asarray(g_j(a)),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(ha.numpy(), np.asarray(h_j(a)),
                                   rtol=1e-10, atol=1e-10)


def test_newton_mode_matches_jax():
    _, score, y, K = _data(seed=1)
    fns = jop.make_objective_fns(jnp.asarray(score), jnp.asarray(y), K, REG)
    a_j, H_j = jax.jit(lambda a: jop._newton_minimize(fns, a))(
        jnp.zeros(K - 1))
    a_t, H_t = top._newton_minimize(
        top.make_objective_fns(T(score), T(y), K, REG),
        torch.zeros(K - 1, dtype=torch.float64))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-7)


def _jax_mh_variates(key, K, dtype=jnp.float64):
    """The variates jop.oprobit_mh_step draws from ``key``."""
    k_prop, k_u = jax.random.split(key)
    k_n, k_g = jax.random.split(k_prop)
    return top.OprobitVariates(
        normal=T(jax.random.normal(k_n, (K - 1,), dtype=dtype)),
        chi=T(jax.random.gamma(k_g, jnp.asarray(NU / 2.0, dtype),
                               dtype=dtype)),
        u_accept=T(jax.random.uniform(k_u, (), dtype=dtype)),
    )


def test_mh_step_matches_jax():
    _, score, y, K = _data(seed=2)
    alpha = np.array([-1.0, -0.3, -0.4, -0.1])
    accepted = 0
    for it in range(6):
        key = jax.random.PRNGKey(10 + it)
        a_j, c_j = jop.oprobit_mh_step(
            key, jnp.asarray(score), jnp.asarray(y), jnp.asarray(alpha),
            jnp.asarray(0, jnp.int32), K, REG, NU)
        a_t, c_t = top.oprobit_mh_step(
            T(score), T(y), T(alpha), torch.tensor(0, dtype=torch.int32), K,
            REG, NU, _jax_mh_variates(key, K))
        assert int(c_t) == int(c_j)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-10,
                                   atol=1e-12)
        accepted += int(c_t)
        alpha = np.asarray(a_j)
    assert 0 < accepted  # the chain moved


def test_two_group_update_and_init_match_jax():
    rng = np.random.RandomState(3)
    n = 600
    score = rng.normal(size=n)
    even = np.arange(n) % 2 == 0
    y = np.zeros(n, np.int64)
    for cp in (-0.5, 0.5):  # group 0: K = 3
        y[even] += (score[even] + rng.normal(size=even.sum()) > cp)
    y[~even] = (score[~even] + rng.normal(size=(~even).sum()) > 0)  # K = 2
    groups = [(3, np.where(even)[0].tolist()),
              (2, np.where(~even)[0].tolist())]
    y_enc = _encode_ordered_targets(groups, y)
    np.testing.assert_array_equal(y_enc, jax_encode(groups, y))
    n_classes = (3, 2)
    u = np.clip(rng.random_sample(n), np.finfo(np.float64).tiny, None)

    a0_j, g0_j, e0_j = jax.jit(
        lambda s_, y_, u_: jop.init_oprobit_groups(
            s_, y_, None, n_classes, REG, u=u_))(
        jnp.asarray(score), jnp.asarray(y_enc), jnp.asarray(u))
    a0_t, g0_t, e0_t = top.init_oprobit_groups(
        T(score), T(y_enc), n_classes, REG, T(u))
    for o, r in ((a0_t, a0_j), (g0_t, g0_j), (e0_t, e0_j)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-8,
                                   atol=1e-8)

    k_mh = jax.random.PRNGKey(7)
    acc = jnp.zeros(2, jnp.int32)
    a_j, g_j, c_j, e_j = jax.jit(
        lambda k_, s_, y_, a_, c_, u_: jop.oprobit_groups_update(
            k_, None, s_, y_, a_, c_, n_classes, REG, NU, u=u_))(
        k_mh, jnp.asarray(score), jnp.asarray(y_enc), a0_j, acc,
        jnp.asarray(u))
    variates = [_jax_mh_variates(k_mh if g == 0
                                 else jax.random.fold_in(k_mh, g), K)
                for g, K in enumerate(n_classes)]
    a_t, g_t, c_t, e_t = top.oprobit_groups_update(
        T(score), T(y_enc), T(a0_j), torch.zeros(2, dtype=torch.int32),
        n_classes, REG, NU, variates, T(u))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    for o, r in ((a_t, a_j), (g_t, g_j), (e_t, e_j)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
    # each row's latent value lies in its own group's class interval
    z = score - e_t.numpy()
    cuts = [np.r_[-np.inf, g_t.numpy()[:2], np.inf],
            np.r_[-np.inf, g_t.numpy()[2:], np.inf]]
    grp = np.where(even, 0, 1)
    loc = np.where(even, y, y)
    lo = np.array([cuts[g][c] for g, c in zip(grp, loc)])
    hi = np.array([cuts[g][c + 1] for g, c in zip(grp, loc)])
    assert np.all((z >= lo - 1e-12) & (z <= hi + 1e-12))


@pytest.mark.parametrize("groups,y,match", [
    ([(3, [0, 1, 2]), (2, [2, 3])], [0, 1, 2, 1], "overlaps"),
    ([(3, [0, 1])], [0, 1, 2, 1], "cover every row"),
    ([(2, [0, 1, 2, 3])], [0, 1, 2, 1], "targets outside"),
    ([(3, [0, 1, 2, 7])], [0, 1, 2, 1], "outside"),
])
def test_encode_ordered_targets_errors_like_jax(groups, y, match):
    y = np.asarray(y)
    with pytest.raises(ValueError, match=match):
        jax_encode(groups, y)
    with pytest.raises(ValueError, match=match):
        _encode_ordered_targets(groups, y)
