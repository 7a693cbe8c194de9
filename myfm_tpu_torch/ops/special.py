"""Numerics for probit links: stable normal-CDF math and truncated normals.

PyTorch counterpart of ``myfm_tpu/ops/special.py``: log-space
formulations on ``torch.special.log_ndtr`` / ``ndtri``.  Every sampler
takes its uniforms ``u`` explicitly (drawn by ``uniform_open`` from a
``torch.Generator``, or handed in by a test), so the same uniforms give
the same draws in both packages.
"""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453

log_ndtr = torch.special.log_ndtr
ndtri = torch.special.ndtri


def uniform_open(shape, generator: torch.Generator, dtype,
                 device) -> torch.Tensor:
    """U[tiny, 1) variates, the TPU package's ``minval=tiny``: torch.rand
    can return exactly 0, whose log is −inf and would make one row's
    latent value infinite."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u.clamp_min(tiny)


def std_cdf(x):
    return torch.exp(log_ndtr(x))


def log_norm_pdf(x):
    return -0.5 * (x * x + LOG_2PI)


def safe_lcdf(x):
    """log Φ(x), stable in both tails."""
    return log_ndtr(x)


def safe_lccdf(x):
    """log (1 − Φ(x)) = log Φ(−x)."""
    return log_ndtr(-x)


def safe_ldiff(a, b):
    """log (Φ(b) − Φ(a)) for a < b, cancellation-free: flip to the side
    where both arguments are negative (Φ(b) − Φ(a) = Φ(−a) − Φ(−b)) and
    use log(e^lb − e^la) = lb + log1p(−e^(la − lb))."""
    flip = (a + b) > 0
    a2 = torch.where(flip, -b, a)
    b2 = torch.where(flip, -a, b)
    la = log_ndtr(a2)
    lb = log_ndtr(b2)
    diff = torch.clamp(la - lb, max=-1e-12)
    return lb + torch.log1p(-torch.exp(diff))


def _inv_survival(log_sf):
    """t with P(N(0,1) > t) = exp(log_sf), stable for tiny sf.

    Clamped at BOTH ends: float32 uniforms can round to 1.0, which would
    drive exp(log_sf) → 1 and ndtri → −inf — an infinite latent residual
    that NaNs the whole chain one sweep later (ordered probit's outermost
    classes have no finite bound for the final clip to recover with)."""
    fi = torch.finfo(log_sf.dtype)
    lo = torch.log(torch.tensor(fi.tiny, dtype=log_sf.dtype)) + 2.0
    hi = torch.log1p(torch.tensor(-4.0 * fi.eps, dtype=log_sf.dtype))
    log_sf = torch.clamp(log_sf, float(lo), float(hi))
    return -ndtri(torch.exp(log_sf))


def truncated_std_normal_lower(u, lower):
    """t ~ N(0,1) conditioned on t >= lower, from uniforms ``u`` in
    (0, 1): P(T > t) = u · P(T > lower), so
    t = −ndtri(exp(log u + log Φ(−lower))).  Accurate far into the tail
    (|lower| ≲ 12 in float32), beyond which the law is a point mass at
    ``lower`` to machine precision anyway."""
    log_sf = torch.log(u) + log_ndtr(-lower)
    return torch.maximum(_inv_survival(log_sf), lower)


def truncated_std_normal_onesided(u, bound, greater):
    """t ~ N(0,1) | (t >= bound) where ``greater``, else (t <= bound)."""
    sign = torch.where(greater, 1.0, -1.0).to(bound.dtype)
    return sign * truncated_std_normal_lower(u, sign * bound)


def truncated_std_normal_two_sided(u, lower, upper):
    """t ~ N(0,1) | lower <= t <= upper by the stable inverse CDF, from
    uniforms ``u``: work on the side where both bounds lie in the lower
    tail and interpolate the survival values in log space,
    log sf = lsf_lo + log(r + u (1 − r)), r = exp(lsf_hi − lsf_lo)."""
    flip = (lower + upper) > 0
    lo = torch.where(flip, -upper, lower)
    hi = torch.where(flip, -lower, upper)
    lsf_lo = log_ndtr(-lo)
    lsf_hi = log_ndtr(-hi)
    r = torch.exp(torch.clamp(lsf_hi - lsf_lo, max=0.0))
    log_sf = lsf_lo + torch.log(r + u * (1.0 - r))
    t = _inv_survival(log_sf)
    t = torch.minimum(torch.maximum(t, lo), hi)
    return torch.where(flip, -t, t)


def mean_var_truncated_normal_left(mu):
    """(mean, var, log Z) of N(mu, 1) truncated to x > 0; the hazard
    ratio φ(μ)/Φ(μ) in log space."""
    log_z = log_ndtr(mu)
    ratio = torch.exp(log_norm_pdf(mu) - log_z)
    mean = mu + ratio
    var = 1.0 - ratio * (ratio + mu)
    return mean, var, log_z


def mean_var_truncated_normal_right(mu):
    """(mean, var, log Z) of N(mu, 1) truncated to x < 0."""
    mean_m, var, log_z = mean_var_truncated_normal_left(-mu)
    return -mean_m, var, log_z
