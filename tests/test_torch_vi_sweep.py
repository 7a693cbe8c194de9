"""The port's VI sweep (myfm_tpu_torch/ops/categorical_vi.py) against the
TPU package's, float64, JAX's Pallas kernels in interpret mode:

* ``vi_refresh_rows`` and the entity+attribute reductions
  ``vi_eff_tables`` on the tiny timeSVD++ plan, one chunk and many;
* three chained ``categorical_vi_sweep``s on a one-hot design and on the
  tiny timeSVD++ entity+attribute design with binary side values (where
  the TPU package's color step is exact), from the same initial state
  (JAX's, carried across with ``convert``): every state field, the ELBO
  included, within 1e-10 of its scale.  CAVI is deterministic, so the
  two chains differ only in summation order (~1e-15 per op, a few
  hundred ops deep).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.ops import categorical_vi as jvi
from myfm_tpu.ops.categorical import make_y_tiles as jax_y_tiles
from myfm_tpu.ops.variational import VariationalConfig as JaxConfig
from myfm_tpu.ops.variational import vi_init_state as jax_vi_init
from myfm_tpu_torch.convert import categorical_vi_state_from_numpy
from myfm_tpu_torch.ops import categorical_vi as tvi
from myfm_tpu_torch.ops.categorical import make_y_tiles
from myfm_tpu_torch.ops.variational import VariationalConfig, vi_init_state

from .vi_cases import (
    ORDER,
    R,
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


@pytest.mark.parametrize("row_chunk", [1 << 20, 300])
def test_vi_refresh_rows_matches_jax(tiny, row_chunk):
    jp, pp = ea_plans(tiny)
    rng = np.random.RandomState(5)
    m = moments(rng, pp.n_features, pp.n_groups)
    jm = [jnp.asarray(m[k]) for k in ORDER]
    pm = [torch.as_tensor(m[k]) for k in ORDER]
    got = tvi.vi_refresh_rows(pp, 0.3, 0.01, *pm, row_chunk=row_chunk,
                              eff=tvi.vi_eff_tables(pp, *pm))
    want = jvi.vi_refresh_rows(jp, 0.3, 0.01, *jm,
                               eff=jvi.vi_eff_tables(jp, *jm))
    close(got[0], want[0], what="score")
    close(got[1], want[1], what="Σ Var(score)")
    eff_p, eff_j = tvi.vi_eff_tables(pp, *pm), jvi.vi_eff_tables(jp, *jm)
    for ep, ej in zip(eff_p, eff_j):
        assert (ep is None) == (ej is None)
        if ep is not None:
            for f in dataclasses.fields(ep):
                close(getattr(ep, f.name), getattr(ej, f.name),
                       what=f.name)


_STATE_FIELDS = ("w0", "w0_var", "w", "w_var", "V", "V_var", "e",
                 "e_var_sum", "alpha", "alpha_rate", "mu_w", "mu_w_var",
                 "lambda_w", "lambda_w_rate", "mu_V", "mu_V_var",
                 "lambda_V", "lambda_V_rate", "elbo")


@pytest.mark.parametrize("design", ["onehot", "ea"])
def test_three_sweeps_match_jax(tiny_binary, design):
    """Three chained categorical_vi_sweeps from the same initial state
    (JAX's, carried across), f64: every state field, the ELBO included,
    within 1e-10 of its scale.  The entity+attribute design is the tiny
    timeSVD++ one with binary side values, where the TPU package's color
    step is exact (see tests/test_torch_vi.py)."""
    if design == "ea":
        jp, pp = ea_plans(tiny_binary)
        y = tiny_binary[3]
    else:
        jp, pp, y, _ = onehot_plans()
    jcfg, pcfg = JaxConfig(), VariationalConfig()
    yj, yp = jnp.asarray(y), torch.as_tensor(y)
    core = jax_vi_init(jp, R, 0.1, jax.random.PRNGKey(0), jcfg, np.float64)
    js = jvi.init_categorical_vi_state(jp, core, yj, jcfg)
    ps = categorical_vi_state_from_numpy(js, "cpu")
    jt, pt = jax_y_tiles(jp, yj), make_y_tiles(pp, yp)
    sweep = jax.jit(jvi.categorical_vi_sweep, static_argnums=(4, 5))
    for it in range(3):
        js = sweep(jp, js, yj, jt, jcfg, True)
        ps = tvi.categorical_vi_sweep(pp, ps, yp, pt, pcfg)
        for f in _STATE_FIELDS:
            close(getattr(ps.core, f), getattr(js.core, f),
                   what=f"sweep {it} {f}")
    assert float(ps.core.elbo) != 0.0


def test_plain_flag_runs_the_same_sweep(tiny):
    """plain=True (the comparison path on the card) gives the same sweep
    on CPU tensors, bit for bit."""
    _, pp = ea_plans(tiny)
    cfg = VariationalConfig()
    y = torch.as_tensor(tiny[3])
    core = vi_init_state(pp, 2, 0.1, torch.Generator().manual_seed(0), cfg,
                         torch.float64, "cpu")
    st = tvi.init_categorical_vi_state(pp, core, y, cfg)
    yt = make_y_tiles(pp, y)
    a = tvi.categorical_vi_sweep(pp, st, y, yt, cfg)
    b = tvi.categorical_vi_sweep(pp, st, y, yt, cfg, plain=True)
    for f in _STATE_FIELDS:
        np.testing.assert_array_equal(as_np(getattr(a.core, f)),
                                      as_np(getattr(b.core, f)), err_msg=f)


def test_classification_task_raises():
    """The classification task on the fast path (it raised before the VI
    classifier was ported; the name is kept): three chained sweeps from
    JAX's initial state, τ included, on a one-hot plan, every field
    within 1e-10 of its scale."""
    jp, pp, y, _ = onehot_plans(N=100)
    y = np.where(y > np.median(y), 1.0, -1.0)
    jcfg = JaxConfig(task="classification")
    pcfg = VariationalConfig(task="classification")
    yj, yp = jnp.asarray(y), torch.as_tensor(y)
    core = jax_vi_init(jp, R, 0.1, jax.random.PRNGKey(0), jcfg, np.float64)
    js = jvi.init_categorical_vi_state(jp, core, yj, jcfg)
    ps = categorical_vi_state_from_numpy(js, "cpu")
    jt, pt = jax_y_tiles(jp, yj), make_y_tiles(pp, yp)
    sweep = jax.jit(jvi.categorical_vi_sweep, static_argnums=(4, 5))
    for it in range(3):
        js = sweep(jp, js, yj, jt, jcfg, True)
        ps = tvi.categorical_vi_sweep(pp, ps, yp, pt, pcfg)
        for f in _STATE_FIELDS:
            close(getattr(ps.core, f), getattr(js.core, f),
                  what=f"sweep {it} {f}")
        close(ps.tau, js.tau, what=f"sweep {it} tau")
    assert float(ps.core.alpha) == 1.0
