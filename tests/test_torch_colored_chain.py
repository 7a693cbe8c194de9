"""Three chained ``gibbs_sweep``s of the port's colored engine and of
its joint-row factor sweep (``sweep_strategy="joint"`` with
``fit_linear=False``) against the TPU package's, float64, for the
regression, classification and ordered-probit tasks, on the
``relational`` design of test_torch_vi_rowspace.py (a multi-hot main
table and two multi-hot blocks, two unrolled colors per table and a
stacked tail each).

From JAX's initial state (carried across with ``convert``) and JAX's
variates (its keys replayed; column 0 of the port's noise for w,
columns 1..R for the factors), every state field agrees within 1e-10 of
its scale after each sweep.  The probit tasks' targets come from a mild
latent score, as in test_torch_probit_sweep.py, so no row lies in the
deep tail where the TPU package's two-sided sampler loses digits
(ROADMAP Queue C2); the tolerance there is the same 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.ops import gibbs as jg
from myfm_tpu.ops import oprobit as jop
from myfm_tpu.ops.forward import predict_score as jax_score
from myfm_tpu_torch.convert import state_from_numpy
from myfm_tpu_torch.ops import gibbs as tg

from .test_torch_joint import colored_noise, jax_sweep_variates
from .test_torch_probit_sweep import FIELDS, _targets, jax_latent_variates
from .test_torch_vi_rowspace import _case
from .vi_cases import close

R = 3
JAX_GIBBS_SWEEP = jax.jit(jg.gibbs_sweep, static_argnums=(4,))


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def plans():
    return _case("relational", "regression")[:2]


ENGINES = {
    "colored": dict(joint_rows=False),
    "joint_nolinear": dict(joint_rows=True, fit_linear=False),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("task", ["regression", "classification", "ordered"])
def test_three_gibbs_sweeps_match_jax(plans, task, engine):
    """Three chained ``gibbs_sweep``s on the relational design from
    JAX's initial state: every state field within 1e-10 of its scale."""
    jp, pp = plans
    extra = dict(n_class=4, n_classes=(4,)) if task == "ordered" else {}
    jcfg = jg.GibbsConfig(task=task, **extra, **ENGINES[engine])
    tcfg = tg.GibbsConfig(task=task, **extra, **ENGINES[engine])
    rng = np.random.RandomState(11)
    y = (_targets(task, 0.5 * rng.normal(size=pp.n_rows), rng)
         if task != "regression" else rng.normal(size=pp.n_rows))
    y_arg = jnp.asarray(y.astype(np.int32) if task == "ordered" else y)
    key = jax.random.PRNGKey(4)
    st = jg.init_state(jp, R, 0.1, key, jcfg, np.float64)
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
        v.noise = colored_noise(k, pp.n_features, R, jcfg.joint_rows)
        if task != "regression":
            v.gamma_alpha = None
            v.u_latent, v.oprobit = jax_latent_variates(
                jax.random.split(k, 9)[8], task, pp.n_rows)
        ts = tg.gibbs_sweep(pp, ts, yp, v, tcfg)
        for f in FIELDS:
            want = getattr(st, f)
            if want is None:
                assert getattr(ts, f) is None, f
            else:
                close(getattr(ts, f), want, what=f"{it}:{f}")
    if not tcfg.fit_linear:
        assert float(ts.w.abs().max()) == 0.0
