"""Ordered-probit cutpoint sampler: Metropolis-within-Gibbs.

PyTorch counterpart of ``myfm_tpu/ops/oprobit.py``.  Cutpoints γ are
reparameterised as unconstrained α (γ₀ = α₀, γᵢ = γᵢ₋₁ + exp αᵢ); the
penalised ordinal-probit log-likelihood is maximised by a damped Newton
iteration, and a multivariate-t proposal centred at the mode (precision
= the Hessian, ν = nu_oprobit) drives a Metropolis-Hastings step.

Two departures from the TPU package, neither changing the arithmetic's
result beyond rounding:

* The gradient and Hessian of the row sum are written out analytically
  (per row, the 2 × 2 derivatives of log P(a < Z < b) in the bounds a,
  b, chained through γ(α)) instead of taken by automatic
  differentiation; one pass over the rows gives f, ∇f and ∇²f together.
  The per-cutpoint sums are one-hot matrix products, so they do not
  depend on atomics.
* The Newton loop runs on the host: the TPU package's ``lax.while_loop``
  becomes a Python loop that reads one flag per iteration (the accepted
  first trial step and the convergence test are decided together) and
  one more per extra line-search trial; ``_newton_minimize.syncs``
  counts them.

Every random input is an argument: the proposal's standard normals and
its χ² gamma variate, the accept uniform, and the latent uniforms (see
``OprobitVariates``), so the tests can feed both packages the same
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..parallel.collectives import psum, psum_many
from .special import (
    log_ndtr,
    log_norm_pdf,
    safe_ldiff,
    truncated_std_normal_two_sided,
)


@dataclasses.dataclass
class OprobitVariates:
    """The standard variates of one cutpoint group's MH step."""

    normal: torch.Tensor  # [K-1] the proposal's standard normals
    chi: torch.Tensor  # scalar, Gamma(ν/2, 1)
    u_accept: torch.Tensor  # scalar, U[0, 1)


def alpha_to_gamma(alpha):
    """γ₀ = α₀; γᵢ = γᵢ₋₁ + exp αᵢ."""
    return torch.cumsum(torch.cat([alpha[:1], torch.exp(alpha[1:])]), dim=0)


def gamma_to_alpha(gamma):
    return torch.cat([gamma[:1], torch.log(torch.diff(gamma))])


def _interval_logprob(lower, upper, lower_inf, upper_inf):
    """log P(lower < N(0,1) < upper) with possibly infinite bounds; the
    inactive branches get finite stand-in arguments."""
    low_s = torch.where(lower_inf, upper - 1.0, lower)
    up_s = torch.where(upper_inf, low_s + 1.0, upper)
    both = safe_ldiff(low_s, up_s)
    lo_only = log_ndtr(up_s)  # lower = −inf
    hi_only = log_ndtr(-low_s)  # upper = +inf
    return torch.where(lower_inf, lo_only,
                       torch.where(upper_inf, hi_only, both))


class _Objective:
    """f(α) = −Σᵢ wᵢ log P(γ_{yᵢ−1} − sᵢ < Z < γ_{yᵢ} − sᵢ) + ½ reg ‖α‖²
    and its derivatives.  Class 0 has no lower bound, class K−1 no upper
    one.  ``weight`` (a row mask) takes rows out of the likelihood.  On a
    sharded chain the row sums are summed over ``axis``, so every rank
    evaluates the whole design's objective and takes the same Newton and
    MH decisions."""

    def __init__(self, score, y, n_class: int, reg: float, weight=None,
                 axis=None):
        y = y.long()
        self.score = score
        self.reg = reg
        self.weight = weight
        self.axis = axis
        self.lower_inf = y == 0
        self.upper_inf = y == (n_class - 1)
        self.yl = torch.clamp(y - 1, 0, n_class - 2)
        self.yu = torch.clamp(y, 0, n_class - 2)
        dtype = score.dtype
        # one-hot maps from a row to the cutpoint its active bound uses
        m = n_class - 1
        self.Oa = torch.nn.functional.one_hot(self.yl, m).to(dtype)
        self.Oa = self.Oa * (~self.lower_inf)[:, None].to(dtype)
        self.Ob = torch.nn.functional.one_hot(self.yu, m).to(dtype)
        self.Ob = self.Ob * (~self.upper_inf)[:, None].to(dtype)

    def _bounds(self, alpha):
        gamma = alpha_to_gamma(alpha)
        return gamma[self.yl] - self.score, gamma[self.yu] - self.score

    def _total(self, ll, alpha):
        if self.weight is not None:
            ll = ll * self.weight
        return (-psum(torch.sum(ll), self.axis)
                + 0.5 * self.reg * torch.sum(alpha * alpha))

    def f(self, alpha):
        a, b = self._bounds(alpha)
        return self._total(
            _interval_logprob(a, b, self.lower_inf, self.upper_inf), alpha)

    def derivs(self, alpha):
        """(f, ∇f, ∇²f) at ``alpha`` in one pass over the rows."""
        a, b = self._bounds(alpha)
        ll = _interval_logprob(a, b, self.lower_inf, self.upper_inf)
        # φ(bound) / P per row, zero where the bound is infinite
        zero = torch.zeros_like(ll)
        ga = torch.where(self.lower_inf, zero,
                         torch.exp(log_norm_pdf(a) - ll))
        gb = torch.where(self.upper_inf, zero,
                         torch.exp(log_norm_pdf(b) - ll))
        # d ll/da = −ga, d ll/db = gb; second derivatives in (a, b)
        haa = a * ga - ga * ga
        hbb = -b * gb - gb * gb
        hab = ga * gb
        w = self.weight
        if w is not None:
            ga, gb, haa, hbb, hab = (x * w for x in (ga, gb, haa, hbb, hab))
        Oa, Ob = self.Oa, self.Ob
        g_gamma = Ob.T @ gb - Oa.T @ ga  # ∇_γ of the log-likelihood
        cross = Oa.T @ (hab[:, None] * Ob)
        H_gamma = (Oa.T @ (haa[:, None] * Oa) + Ob.T @ (hbb[:, None] * Ob)
                   + cross + cross.T)
        llw = ll if w is None else ll * w
        # the row sums over every rank, in one all-reduce
        nll, g_gamma, H_gamma = psum_many(self.axis, -torch.sum(llw),
                                          g_gamma, H_gamma)
        fval = nll + 0.5 * self.reg * torch.sum(alpha * alpha)
        # chain rule through γ(α): J[m, j] = ∂γ_m/∂α_j
        m = alpha.shape[0]
        e = torch.cat([torch.ones_like(alpha[:1]), torch.exp(alpha[1:])])
        J = torch.tril(torch.ones(m, m, dtype=alpha.dtype,
                                  device=alpha.device)) * e[None, :]
        grad_ll = J.T @ g_gamma
        # ∂²γ_m/∂α_j² = exp α_j for 1 <= j <= m, no cross terms
        tail = torch.flip(torch.cumsum(torch.flip(g_gamma, [0]), 0), [0])
        curv = torch.cat([torch.zeros_like(alpha[:1]), e[1:] * tail[1:]])
        H_ll = J.T @ H_gamma @ J + torch.diag(curv)
        eye = torch.eye(m, dtype=alpha.dtype, device=alpha.device)
        return fval, -grad_ll + self.reg * alpha, -H_ll + self.reg * eye


def make_objective_fns(score, y, n_class: int, reg: float, weight=None,
                       axis=None):
    """(f, derivs): the penalised negative log-likelihood and the
    function returning (f, ∇f, ∇²f) at once."""
    obj = _Objective(score, y, n_class, reg, weight, axis)
    return obj.f, obj.derivs


def _cholesky_nan(H):
    """Cholesky factor of H, all NaN where H is not positive definite
    (the TPU package's cholesky gives NaNs there)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _direction(H, g):
    """The Newton direction −H⁻¹g, or −g where it is not finite."""
    L = _cholesky_nan(H)
    d = -torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(torch.isnan(d).any(), -g, d)


def _newton_minimize(fns, alpha0, max_iter=100, max_halvings=30,
                     epsilon=1e-5, epsilon_rel=1e-5, delta=1e-5):
    """Damped Newton with step-halving line search (slack ``delta``),
    terminating on the gradient norm (absolute or relative), on
    stagnation, or on a failed line search; a NaN trial counts as a
    rejected step.  Returns (α, ∇²f(α))."""
    f, derivs = fns
    alpha = alpha0
    fval, g, H = derivs(alpha)

    def accepted(fc):
        return ~torch.isnan(fc) & (fc < fval * (1.0 + delta) + 1e-12)

    def read(*flags):
        _newton_minimize.syncs += 1
        return torch.stack(flags).tolist()

    for _ in range(max_iter):
        d = _direction(H, g)
        # trial step 1 with its derivatives: acceptance and the stopping
        # test come back in one read
        cand = alpha + d
        fc, gc, Hc = derivs(cand)
        ok, stop = read(accepted(fc), _stops(fc, fval, gc, cand, epsilon,
                                             epsilon_rel, delta))
        step, halvings = 1.0, 1
        while not ok and halvings < max_halvings:
            step *= 0.5
            halvings += 1
            cand = alpha + step * d
            fc = f(cand)
            (ok,) = read(accepted(fc))
            if ok:
                fc, gc, Hc = derivs(cand)
                (stop,) = read(_stops(fc, fval, gc, cand, epsilon,
                                      epsilon_rel, delta))
        if not ok:
            break  # no acceptable step: α stays and the loop ends
        alpha, fval, g, H = cand, fc, gc, Hc
        if stop:
            break
    return alpha, H


_newton_minimize.syncs = 0


def _stops(new_f, fval, g_new, new_alpha, epsilon, epsilon_rel, delta):
    """Converged (small gradient) or stalled (no progress in f) after
    an accepted step, as a 0-dim bool tensor."""
    gnorm = torch.linalg.vector_norm(g_new)
    anorm = torch.linalg.vector_norm(new_alpha)
    converged = (gnorm < epsilon) | (gnorm < epsilon_rel * anorm)
    big = torch.maximum(torch.maximum(new_f.abs(), fval.abs()),
                        torch.ones_like(fval))
    return converged | ((new_f - fval).abs() <= delta * big)


def _sample_mvt(H, nu: float, normal, chi):
    """x ~ multivariate-t(0, H⁻¹, ν) from standard normals and a
    Gamma(ν/2, 1) variate."""
    L = _cholesky_nan(H)
    x = torch.linalg.solve_triangular(L.T, normal[:, None], upper=True)[:, 0]
    return x / torch.sqrt(chi * 2.0 / nu)


def _log_p_mvt(H, mu, nu: float, x):
    """Unnormalised multivariate-t log-density."""
    d = x - mu
    q = d @ (H @ d)
    return torch.log1p(q / nu) * (-nu - H.shape[0]) / 2.0


def oprobit_mh_step(score, y, alpha_now, accept_count, n_class: int,
                    reg: float, nu: float, variates: OprobitVariates,
                    weight=None, axis=None):
    """One Metropolis-Hastings cutpoint update: Newton mode, a t proposal
    around it, accept on log u < log ratio (never on a NaN ratio).
    Returns (α, accept_count + accepted)."""
    f, derivs = make_objective_fns(score, y, n_class, reg, weight, axis)
    alpha_hat, H = _newton_minimize((f, derivs), alpha_now)
    cand = alpha_hat + _sample_mvt(H, nu, variates.normal, variates.chi)
    log_ratio = (-f(cand) - _log_p_mvt(H, alpha_hat, nu, cand)
                 + f(alpha_now) + _log_p_mvt(H, alpha_hat, nu, alpha_now))
    accept = (torch.log(variates.u_accept) < log_ratio) & ~torch.isnan(
        log_ratio)
    alpha_new = torch.where(accept, cand, alpha_now)
    return alpha_new, accept_count + accept.to(accept_count.dtype)


def sample_z_residual(u, score, y, gamma):
    """e = score − z with z ~ TN(score, 1; [γ_{y−1}, γ_y]) from uniforms
    ``u``; the edge classes' infinite bounds flow through the two-sided
    sampler."""
    y = y.long()
    inf = torch.full((1,), float("inf"), dtype=score.dtype,
                     device=score.device)
    lower = torch.cat([-inf, gamma])[y] - score
    upper = torch.cat([gamma, inf])[y] - score
    return -truncated_std_normal_two_sided(u, lower, upper)


# Several cutpoint groups share one FM (one ordinal scale each).  The
# group is encoded into the integer target: group g's classes occupy
# [Σ_{j<g} K_j, Σ_{j<g} K_j + K_g), so membership is a range test on y.
# Cutpoints and α concatenate to [Σ(K_g − 1)] vectors; accept counts are
# one per group.


def _group_rows(y_enc, K, yoff, dtype, weight):
    y_g = y_enc - yoff
    in_g = (y_g >= 0) & (y_g < K)
    m_g = in_g.to(dtype)
    if weight is not None:
        m_g = m_g * weight
    return in_g, m_g, torch.clamp(y_g, 0, K - 1)


def oprobit_groups_update(score, y_enc, alpha_cat, accept_counts,
                          n_classes: Sequence[int], reg: float, nu: float,
                          variates: Sequence[OprobitVariates], u,
                          weight=None, axis=None):
    """Per-group MH cutpoint step, then the latent residual redraw.
    Rows outside a group enter its objective with weight 0; every row
    draws its latent value once, from its own group's cutpoints, with
    its uniform in ``u``.  Returns (alpha_cat, gamma_cat, accept_counts,
    e)."""
    y_enc = y_enc.long()
    e = torch.zeros_like(score)
    alphas: List[torch.Tensor] = []
    gammas: List[torch.Tensor] = []
    accs: List[torch.Tensor] = []
    yoff = aoff = 0
    for g, K in enumerate(n_classes):
        in_g, m_g, y_gc = _group_rows(y_enc, K, yoff, score.dtype, weight)
        a_new, acc_new = oprobit_mh_step(
            score, y_gc, alpha_cat[aoff : aoff + K - 1], accept_counts[g],
            K, reg, nu, variates[g], weight=m_g, axis=axis,
        )
        gamma_g = alpha_to_gamma(a_new)
        e = torch.where(in_g, sample_z_residual(u, score, y_gc, gamma_g), e)
        alphas.append(a_new)
        gammas.append(gamma_g)
        accs.append(acc_new)
        yoff += K
        aoff += K - 1
    return torch.cat(alphas), torch.cat(gammas), torch.stack(accs), e


def init_oprobit_groups(score, y_enc, n_classes: Sequence[int], reg: float,
                        u, weight=None,
                        axis=None) -> Tuple[torch.Tensor, ...]:
    """Newton MAP cutpoints per group from α = 0, then the latent
    residual draw.  Returns (alpha_cat, gamma_cat, e)."""
    y_enc = y_enc.long()
    e = torch.zeros_like(score)
    alphas, gammas = [], []
    yoff = 0
    for K in n_classes:
        in_g, m_g, y_gc = _group_rows(y_enc, K, yoff, score.dtype, weight)
        alpha_hat, _ = _newton_minimize(
            make_objective_fns(score, y_gc, K, reg, m_g, axis),
            score.new_zeros(K - 1),
        )
        gamma = alpha_to_gamma(alpha_hat)
        e = torch.where(in_g, sample_z_residual(u, score, y_gc, gamma), e)
        alphas.append(alpha_hat)
        gammas.append(gamma)
        yoff += K
    if weight is not None:
        e = e * weight
    return torch.cat(alphas), torch.cat(gammas), e


def initialize_oprobit_core(score, core, y_int, cfg, u, weight=None):
    """The ordered task's initial state from precomputed scores: Newton
    MAP cutpoints, latent residuals, zero accept counts.  Returns
    (core, e)."""
    groups = cfg.cutpoint_group_classes
    alpha_hat, gamma, e = init_oprobit_groups(
        score, y_int, groups, cfg.reg_0, u, weight=weight, axis=cfg.axis,
    )
    core = dataclasses.replace(
        core, e=e, cutpoints=gamma, oprobit_alpha=alpha_hat,
        n_mh_accept=torch.zeros(len(groups), dtype=torch.int32,
                                device=score.device),
    )
    return core, e
