"""The port's probit numerics (myfm_tpu_torch/ops/special.py) against the
TPU package's (myfm_tpu/ops/special.py), same uniforms in both.

Tolerance: 1e-12 of scale in float64 (max |Δ| over max(1, max |ref|)):
the two evaluate the same formulas on log_ndtr / ndtri, whose torch and
JAX implementations differ by a few ulps.  Below −20 JAX's float64
log_ndtr switches to a three-term asymptotic series that is 2e-11
relative off the exact value (scipy.special.log_ndtr, which torch
matches); bounds beyond |b| = 19.5 out to 30 are therefore held to
scipy's value at 1e-12 of scale and to JAX's at 1e-10.  In float32 the
formulas themselves are ill-conditioned near the upper tail (log Φ of
+5 is −3e-7, a few ulps), so the two packages' float32 results differ
by up to ~1e-3 there: float32 (bounds out to |b| = 12) is held to the
float64 result, the port's error no larger than twice JAX's own float32
error plus 1e-6 of scale.  The two-sided sampler inverts a survival
value near 1 when both bounds lie beyond 3 in one tail (so the draw's
last digits depend on ulps of ndtri near 1, up to ~1e-3 apart between
the two packages even in float64): there the two are held to 1e-2.
"""

import numpy as np
import pytest
import scipy.special as ss
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.ops import special as jsp
from myfm_tpu_torch.ops import special as tsp


def _jit(fn):
    """A JAX sampler jitted, its key argument left out (one compile per
    shape instead of one per eager operation)."""
    return jax.jit(lambda *args, u: fn(None, *args, u=u))


JAX_ONESIDED = _jit(jsp.truncated_std_normal_onesided)
JAX_TWOSIDED = _jit(jsp.truncated_std_normal_two_sided)

def _f64(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float64)


def close(ours, ref, dtype, name="", ref64=None):
    """float64: |ours − ref| <= 1e-12 of scale.  float32: against the
    float64 result ``ref64``, no worse than twice JAX's float32 ``ref``
    plus 1e-6 of scale."""
    ours, ref = _f64(ours), _f64(ref)
    assert np.isfinite(ours).all() == np.isfinite(ref).all(), name
    scale = max(1.0, float(np.abs(ref).max()))
    if dtype == np.float64:
        err = float(np.abs(ours - ref).max())
        assert err <= 1e-12 * scale, f"{name}: {err:.3e} of {scale:.3e}"
        return
    exact = _f64(ref64)
    err = float(np.abs(ours - exact).max())
    err_jax = float(np.abs(ref - exact).max())
    assert err <= 2 * err_jax + 1e-6 * scale, (
        f"{name}: {err:.3e} vs JAX's {err_jax:.3e} of {scale:.3e}")


def _exact_lower(u, lower):
    """The one-sided draw in numpy on scipy's log_ndtr / ndtri, with
    _inv_survival's clamps."""
    fi = np.finfo(np.float64)
    log_sf = np.log(u) + ss.log_ndtr(-lower)
    log_sf = np.clip(log_sf, np.log(fi.tiny) + 2.0, np.log1p(-4.0 * fi.eps))
    return np.maximum(-ss.ndtri(np.exp(log_sf)), lower)


def _uniforms(rng, n, dtype):
    """Uniforms with the extremes: the smallest positive float and 1 − ε
    (the round-to-1 case both clamps of _inv_survival exist for)."""
    fi = np.finfo(dtype)
    u = rng.random_sample(n).astype(dtype)
    u[:4] = [fi.tiny, fi.tiny, 1.0 - fi.eps, 1.0 - fi.eps / 2]
    return np.clip(u, fi.tiny, 1.0 - fi.eps / 2).astype(dtype)


@pytest.mark.parametrize("dtype,reach", [(np.float64, 19.5),
                                         (np.float32, 12.0)])
def test_truncated_normals_match_jax(dtype, reach):
    rng = np.random.RandomState(0)
    n = 400
    u = _uniforms(rng, n, dtype)
    bound = np.linspace(-reach, reach, n).astype(dtype)
    rng.shuffle(bound)
    greater = rng.random_sample(n) > 0.5
    ours = tsp.truncated_std_normal_onesided(
        torch.as_tensor(u), torch.as_tensor(bound), torch.as_tensor(greater))
    ref, ref64 = (JAX_ONESIDED(
        jnp.asarray(bound, dt), jnp.asarray(greater), u=jnp.asarray(u, dt)) for dt in (dtype, np.float64))
    close(ours, ref, dtype, "one-sided", ref64)
    # the draw respects its bound
    t = ours.numpy()
    assert np.all(np.where(greater, t >= bound, t <= bound))

    width = rng.random_sample(n).astype(dtype) * 3.0
    width[:8] = [0.0, 1e-6, 0.0, 1e-3, 50.0, 50.0, np.inf, np.inf]
    lower = bound.copy()
    upper = (bound + width).astype(dtype)
    lower[8:16] = -np.inf  # class 0: no lower bound
    ours = tsp.truncated_std_normal_two_sided(
        torch.as_tensor(u), torch.as_tensor(lower), torch.as_tensor(upper))
    t = ours.numpy()
    assert np.isfinite(t).all()
    assert np.all((t >= lower) & (t <= upper))
    deep = (upper < -3) | (lower > 3)
    ref, ref64 = (JAX_TWOSIDED(
        jnp.asarray(lower[~deep], dt), jnp.asarray(upper[~deep], dt),
        u=jnp.asarray(u[~deep], dt)) for dt in (dtype, np.float64))
    close(ours[~deep], ref, dtype, "two-sided", ref64)
    # deep in one tail both packages invert a survival value near 1:
    # they agree to that conditioning (and share its collapse onto the
    # upper bound beyond ~7.9 sd, ~4.9 in float32; ROADMAP Queue C)
    ref = np.asarray(JAX_TWOSIDED(
        jnp.asarray(lower[deep]), jnp.asarray(upper[deep]),
        u=jnp.asarray(u[deep])))
    assert deep.sum() >= 20
    np.testing.assert_allclose(t[deep], ref, rtol=0, atol=1e-2)


def test_far_tail_f64_matches_scipy_and_jax():
    """Bounds 20 < |b| <= 30: the one-sided draw against the exact numpy
    formula at 1e-12 and against JAX (its series log_ndtr) at 1e-10."""
    rng = np.random.RandomState(2)
    n = 300
    u = _uniforms(rng, n, np.float64)
    bound = rng.uniform(19.5, 30.0, n) * rng.choice([-1.0, 1.0], n)
    greater = rng.random_sample(n) > 0.5
    ours = tsp.truncated_std_normal_onesided(
        torch.as_tensor(u), torch.as_tensor(bound), torch.as_tensor(greater))
    sign = np.where(greater, 1.0, -1.0)
    close(ours, sign * _exact_lower(u, sign * bound), np.float64, "scipy")
    ref = np.asarray(JAX_ONESIDED(
        jnp.asarray(bound), jnp.asarray(greater), u=jnp.asarray(u)))
    err = float(np.abs(ours.numpy() - ref).max())
    assert err <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_log_cdf_helpers_match_jax(dtype):
    def both(name, *args):
        ours = getattr(tsp, name)(*[torch.as_tensor(a) for a in args])
        fn = jax.jit(getattr(jsp, name))
        ref, ref64 = (fn(*[jnp.asarray(a, dt) for a in args])
                      for dt in (dtype, np.float64))
        if isinstance(ours, tuple):
            for o, r, r64 in zip(ours, ref, ref64):
                close(o, r, dtype, name, r64)
        else:
            close(ours, ref, dtype, name, ref64)

    x = np.linspace(-19.5, 19.5, 391).astype(dtype)
    for name in ("std_cdf", "log_norm_pdf", "safe_lcdf", "safe_lccdf"):
        both(name, x)
    rng = np.random.RandomState(1)
    a = np.clip(rng.normal(size=500) * 8, -19, 19).astype(dtype)
    b = (a + np.abs(rng.normal(size=500)) * 3 + 1e-3).astype(dtype)
    a[:3], b[:3] = [-19.5, 15.0, -1e-4], [-19.0, 20.0, 1e-4]
    both("safe_ldiff", a, b)
    mu = np.linspace(-6, 6, 121).astype(dtype)
    for side in ("left", "right"):
        both(f"mean_var_truncated_normal_{side}", mu)


def test_uniform_open_excludes_zero():
    g = torch.Generator().manual_seed(0)
    u = tsp.uniform_open((100_000,), g, torch.float32, "cpu")
    assert float(u.min()) >= np.finfo(np.float32).tiny
    assert float(u.max()) < 1.0
    # ... and the truncated draws from it stay finite at a far bound
    t = tsp.truncated_std_normal_onesided(
        u, torch.full_like(u, 11.5), torch.ones_like(u, dtype=torch.bool))
    assert bool(torch.isfinite(t).all())
