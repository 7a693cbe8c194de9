"""``VariationalFMClassifier`` of the port against the TPU package's, on
the VI fast path (kernels 1 and 2 through their plain versions here):

* three chained classification ``categorical_vi_sweep``s on the tiny
  timeSVD++ entity+attribute plan with binary side values (where the TPU
  package's color step is exact), from JAX's initial state carried
  across, τ included: every field within 1e-10 of its scale (the one-hot
  case is tests/test_torch_vi_sweep.py::test_classification_task_raises);
* the ELBO never falls over 20 float64 sweeps, on a one-hot plan and on
  the entity+attribute plan with the design's own side values;
* ``VariationalPredictor`` serving Φ(score) against JAX's on carried
  weights;
* the estimator: "auto" resolves as JAX's does, ``predict`` /
  ``predict_proba``, and a held-out log-loss inside JAX's seed spread.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu.containers import VariationalFM as JaxVFM
from myfm_tpu.ops import categorical_vi as jvi
from myfm_tpu.ops.categorical import make_y_tiles as jax_y_tiles
from myfm_tpu.ops.variational import VariationalConfig as JaxConfig
from myfm_tpu.ops.variational import vi_init_state as jax_vi_init
from myfm_tpu.predictor import VariationalPredictor as JaxVPredictor
from myfm_tpu_torch import VariationalFMClassifier, VariationalPredictor
from myfm_tpu_torch.containers import VariationalFM
from myfm_tpu_torch.convert import categorical_vi_state_from_numpy
from myfm_tpu_torch.ops import categorical_vi as tvi
from myfm_tpu_torch.ops.categorical import make_y_tiles
from myfm_tpu_torch.ops.variational import VariationalConfig, vi_init_state

from .test_torch_vi_sweep import _STATE_FIELDS
from .vi_cases import R, close, ea_plans, load_tiny, onehot_plans

CLS = "classification"


def _pm1(y):
    return np.where(y >= 4, 1.0, -1.0)


@pytest.fixture(scope="module")
def tiny_binary():
    return load_tiny(binary=True)


def test_ea_three_sweeps_match_jax(tiny_binary):
    jp, pp = ea_plans(tiny_binary)
    y = _pm1(tiny_binary[3])
    jcfg, pcfg = JaxConfig(task=CLS), VariationalConfig(task=CLS)
    yj, yp = jnp.asarray(y), torch.as_tensor(y)
    core = jax_vi_init(jp, R, 0.1, jax.random.PRNGKey(0), jcfg, np.float64)
    js = jvi.init_categorical_vi_state(jp, core, yj, jcfg)
    ps = categorical_vi_state_from_numpy(js, "cpu")
    close(ps.tau, yp, what="initial tau")
    jt, pt = jax_y_tiles(jp, yj), make_y_tiles(pp, yp)
    sweep = jax.jit(jvi.categorical_vi_sweep, static_argnums=(4, 5))
    for it in range(3):
        js = sweep(jp, js, yj, jt, jcfg, True)
        ps = tvi.categorical_vi_sweep(pp, ps, yp, pt, pcfg)
        for f in _STATE_FIELDS:
            close(getattr(ps.core, f), getattr(js.core, f),
                  what=f"sweep {it} {f}")
        close(ps.tau, js.tau, what=f"sweep {it} tau")


@pytest.mark.parametrize("design", ["onehot", "ea"])
def test_elbo_never_falls(design):
    """20 float64 classification sweeps: every update is an exact
    coordinate maximiser of the probit ELBO, so it never falls (beyond
    rounding).  The entity+attribute plan keeps the design's own
    fractional side values (x = 1/√n)."""
    if design == "onehot":
        _, pp, y, _ = onehot_plans()
        y = np.where(y > np.median(y), 1.0, -1.0)
    else:
        tiny = load_tiny()
        _, pp = ea_plans(tiny)
        y = _pm1(tiny[3])
    cfg = VariationalConfig(task=CLS)
    yp = torch.as_tensor(y)
    core = vi_init_state(pp, R, 0.1, torch.Generator().manual_seed(0), cfg,
                         torch.float64, "cpu")
    st = tvi.init_categorical_vi_state(pp, core, yp, cfg)
    yt = make_y_tiles(pp, yp)
    elbos = []
    for _ in range(20):
        st = tvi.categorical_vi_sweep(pp, st, yp, yt, cfg)
        elbos.append(float(st.core.elbo))
    elbos = np.array(elbos)
    assert np.isfinite(elbos).all() and torch.isfinite(st.tau).all()
    assert (np.diff(elbos) >= -1e-9 * np.abs(elbos[1:])).all(), elbos


def test_deep_scores_give_finite_latent_means():
    """Rows whose score lies far on the wrong side of their label keep a
    finite τ and ELBO in float32 and float64 (the log-space truncated
    normal moments)."""
    from myfm_tpu_torch.ops.variational import finish_task

    cfg = VariationalConfig(task=CLS)
    for dtype in (torch.float32, torch.float64):
        score = torch.tensor([-40.0, -12.0, 0.0, 12.0, 40.0], dtype=dtype)
        y = torch.tensor([1.0, 1.0, -1.0, -1.0, -1.0], dtype=dtype)
        e, tau, elbo = finish_task(score, y, cfg)
        assert torch.isfinite(tau).all() and torch.isfinite(elbo)
        assert (tau[:2] > 0).all() and (tau[2:] < 0).all()
        torch.testing.assert_close(e, score - tau)


def test_predictor_squashes_like_jax(tiny_binary):
    """Φ(score) of carried weights, against the TPU package's
    VariationalPredictor (f64, 1e-10)."""
    X, blocks, grouping, _ = tiny_binary
    F = len(grouping)
    rng = np.random.RandomState(0)
    w0, w, V = rng.normal(), rng.normal(size=F), 0.3 * rng.normal(size=(F, R))
    var = (1.0, np.ones(F), np.ones((F, R)))
    ref = JaxVPredictor(R, F, CLS, np.float64)
    ref.samples.append(JaxVFM(w0, w, V, *var))
    ours = VariationalPredictor(R, F, CLS, np.float64, "cpu")
    ours.samples.append(VariationalFM(w0, w, V, *var))
    got, want = ours.predict(X, blocks), ref.predict(X, blocks)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _onehot(n=1500, n_u=40, n_i=30, seed=0):
    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    rows = np.arange(n)
    X = sps.hstack([sps.csr_matrix((np.ones(n), (rows, u)), (n, n_u)),
                    sps.csr_matrix((np.ones(n), (rows, i)), (n, n_i))],
                   format="csr")
    z = (rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
         + (rng.normal(size=(n_u, 2))[u] * rng.normal(size=(n_i, 2))[i]
            ).sum(axis=1) + 0.5 * rng.normal(size=n))
    return X, (z > 0).astype(np.float64), [n_u, n_i]


def _fit(mod, seed, **kw):
    X, y, shapes = _onehot()
    tr, te = slice(0, 1200), slice(1200, None)
    fm = mod.VariationalFMClassifier(rank=2, random_seed=seed, **kw).fit(
        X[tr], y[tr], n_iter=20, group_shapes=shapes)
    assert fm.history_.engine == "fastpath"
    p = np.clip(fm.predict_proba(X[te]), 1e-12, 1 - 1e-12)
    return float(-np.mean(np.where(y[te] > 0, np.log(p), np.log(1 - p)))), fm


def test_estimator_surface_and_log_loss_within_jax_seed_spread():
    """Fits on a one-hot design: probabilities in (0, 1), predict is
    their 0.5 threshold, 20 ELBOs that never fall (float32, 1e-6 of
    their size), and the held-out log-loss, averaged over two seeds,
    inside JAX's three-seed range widened by that range on each side and
    below the base rate's."""
    ref = [_fit(myfm_tpu, s)[0] for s in (1, 2, 3)]
    runs = [_fit(myfm_tpu_torch, s, device="cpu") for s in (1, 2)]
    ours = np.mean([r[0] for r in runs])
    fm = runs[0][1]
    X, y, _ = _onehot()
    p = fm.predict_proba(X[1200:])
    assert ((p > 0) & (p < 1)).all()
    np.testing.assert_array_equal(fm.predict(X[1200:]), p > 0.5)
    elbos = np.asarray(fm.history_.elbos)
    assert elbos.shape == (20,) and np.isfinite(elbos).all()
    assert (np.diff(elbos) >= -1e-6 * np.abs(elbos[1:])).all()
    assert fm.w0_mean is not None and fm.V_var.shape == (70, 2)
    base = y[:1200].mean()
    yte = y[1200:]
    base_ll = -np.mean(np.where(yte > 0, np.log(base), np.log(1 - base)))
    spread = max(ref) - min(ref)
    assert ours < base_ll
    assert min(ref) - spread <= ours <= max(ref) + spread, (ours, ref)


def test_auto_resolves_like_jax_on_ea_design(tiny_binary):
    """On the timeSVD++ design "auto" takes the entity+attribute fast
    path in both packages."""
    X, blocks, grouping, y = tiny_binary
    yb = (y >= 4).astype(np.float64)
    kw = dict(X=X, y=yb, X_rel=blocks, n_iter=2, grouping=grouping)
    ours = VariationalFMClassifier(rank=2, device="cpu").fit(**kw)
    ref = myfm_tpu.VariationalFMClassifier(rank=2).fit(**kw)
    assert ours.history_.engine == ref.history_.engine == "fastpath"
    assert np.isfinite(ours.predict_proba(X, blocks)).all()
