"""The plain version of the joint sweep's color tail
(myfm_tpu_torch/ops/joint_tail.py ``joint_tail_pass_reference``, which
``joint_tail_pass`` runs on CPU tensors) against the TPU package's
Pallas kernel in interpret mode and against its lax.scan twin (the
step sequence of myfm_tpu/ops/joint.py).

Tolerances: 1e-10 relative in float64 (the same formulas, summed in
another order), 2e-4 relative in float32 (as the TPU package's own
kernel-vs-scan test: the Gram-assembled S cancels two aggregates of its
own scale).  The CUDA kernel itself is held against this plain version
on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myfm_tpu.ops import joint as jjoint
from myfm_tpu.ops.pallas_joint_tail import joint_tail_pass as jax_tail
from myfm_tpu_torch.ops import joint_tail

NAMES = ("G", "Atot", "Ct", "u_new")


def tail_problem(C, B, Pf, R, seed=0, dtype=np.float64, single_row=False):
    """A structurally valid stack (the TPU package's test generator):
    per color each block row holds at most one feature slot, and the
    Gram is a genuine sum of z zᵀ."""
    rng = np.random.RandomState(seed)
    D = R + 2
    z = rng.normal(size=(8 * B, D))
    z[:, 0] = 1.0
    mapper = rng.randint(0, B, 8 * B)
    G = np.zeros((B, D, D))
    np.add.at(G, mapper, z[:, :, None] * z[:, None, :])
    xw = np.zeros((C, B))
    segb = np.full((C, B), Pf, dtype=np.int32)
    for c in range(C):
        perm = rng.permutation(B)
        used = 0
        for p in range(Pf):
            k = 1 if single_row else rng.randint(1, max(2, B // (2 * Pf)))
            rows = perm[used: used + k]
            used += k
            segb[c, rows] = p
            xw[c, rows] = rng.choice([-1.0, 1.0, 0.5]) * (
                1.0 + 0.1 * rng.random(k))
    ops = [G.reshape(B, D * D).T.copy(),
           0.05 * rng.normal(size=(R, B)), 0.05 * rng.normal(size=B),
           xw, segb,
           0.3 * rng.normal(size=(C, Pf, R + 1)),
           np.abs(rng.normal(size=(C, Pf, R + 1))) + 0.5,
           0.1 * rng.normal(size=(C, Pf, R + 1)),
           rng.normal(size=(C, Pf, R + 1))]
    return [o if o.dtype == np.int32 else o.astype(dtype) for o in ops]


def run_port(ops, alpha, D):
    t = [torch.as_tensor(o) for o in ops]
    alpha_t = torch.tensor(alpha, dtype=t[0].dtype)
    return [o.numpy() for o in joint_tail.joint_tail_pass(*t, alpha_t, D)]


def run_jax(ops, alpha, D):
    out = jax_tail(*[jnp.asarray(o) for o in ops], alpha, D,
                   interpret=True)
    return [np.asarray(o) for o in out]


def run_scan(ops, alpha, D):
    """The TPU package's scan body, color after color."""
    G, Atot, Ct, xw, segb, u0, lam, mu, xi = [jnp.asarray(o) for o in ops]
    u_all = []
    for c in range(xw.shape[0]):
        u_new, a0, A_B = jjoint._dense_color_step(
            G, xw[c], segb[c], u0[c], lam[c], mu[c], xi[c], alpha, D)
        Ct = Ct + a0 + jnp.sum(A_B * Atot, axis=0)
        Atot = Atot + A_B
        G = jjoint._update_gram_lanes(G, a0, A_B, D)
        u_all.append(u_new)
    return [np.asarray(o) for o in (G, Atot, Ct, jnp.stack(u_all))]


def assert_close(got, want, rtol):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g - w).max()) <= rtol * scale, name


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 2e-4)])
@pytest.mark.parametrize("C,B,Pf,R", [(7, 37, 4, 3), (1, 20, 8, 2),
                                      (3, 40, 1, 4)])
def test_plain_tail_matches_jax_kernel_and_scan(dtype, rtol, C, B, Pf, R):
    ops = tail_problem(C, B, Pf, R, seed=C + B, dtype=dtype)
    got = run_port(ops, 1.3, R + 2)
    assert_close(got, run_jax(ops, 1.3, R + 2), rtol)
    assert_close(got, run_scan(ops, 1.3, R + 2), rtol)


def test_single_row_features():
    ops = tail_problem(5, 30, 8, 3, seed=4, single_row=True)
    assert_close(run_port(ops, 0.7, 5), run_jax(ops, 0.7, 5), 1e-10)


def test_pad_slot_is_inert():
    """A slot that owns no block row leaves G, Atot and Ct as they were
    at the rows it would have touched, and still draws finite values."""
    C, B, Pf, R = 3, 16, 3, 2
    ops = tail_problem(C, B, Pf, R, seed=9)
    segb, xw = ops[4], ops[3]
    xw[segb == Pf - 1] = 0.0
    segb[segb == Pf - 1] = Pf
    got = run_port(ops, 1.1, R + 2)
    assert_close(got, run_jax(ops, 1.1, R + 2), 1e-10)
    untouched = (segb == Pf).all(axis=0)
    np.testing.assert_array_equal(got[0][:, untouched],
                                  ops[0][:, untouched])
    np.testing.assert_array_equal(got[2][untouched], ops[2][untouched])


def test_rank_one_gram_with_small_lambda():
    """One original row per block row makes every block row's Gram rank
    one, so a single-row feature's S is rank one and A = αS + diag(λ)
    is within a factor 2 of singular in every null direction of S: the
    draws scale like 1/√λ, and both packages still agree.  (The pivot
    floor itself is held against the TPU package on an indefinite A in
    tests/test_torch_joint.py.)"""
    C, B, Pf, R = 4, 24, 8, 3
    D = R + 2
    ops = tail_problem(C, B, Pf, R, seed=2, single_row=True)
    rng = np.random.RandomState(5)
    z = rng.normal(size=(B, D))
    z[:, 0] = 1.0
    ops[0] = (z[:, :, None] * z[:, None, :]).reshape(B, D * D).T.copy()
    ops[6] = np.full_like(ops[6], 1e-3)  # λ far below the S scale
    got = run_port(ops, 1.0, D)
    assert_close(got, run_jax(ops, 1.0, D), 1e-10)
    assert_close(got, run_scan(ops, 1.0, D), 1e-10)


def test_wrapper_takes_the_plain_version_on_cpu():
    ops = tail_problem(2, 10, 2, 2, seed=1)
    before = joint_tail.joint_tail_pass.launches
    t = [torch.as_tensor(o) for o in ops]
    one = torch.tensor(1.0, dtype=torch.float64)
    a = joint_tail.joint_tail_pass(*t, one, 4)
    b = joint_tail.joint_tail_pass_reference(*t, one, 4)
    assert joint_tail.joint_tail_pass.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="plain version"):
        joint_tail._check_cuda(*t, 1.0, 4)


@pytest.mark.parametrize("choice,device,rank,want", [
    (None, "cuda", 10, True),
    (None, "cuda", 32, True),  # D = 34, the TPU package's bound
    (None, "cuda", 33, False),
    (None, "cpu", 10, False),
    (False, "cuda", 10, False),
    (True, "cpu", 10, ValueError),
])
def test_tail_kernel_gate(choice, device, rank, want):
    """``joint_tail_kernel`` resolves on the plan's device and D alone:
    the kernel takes any feature-slot count Pf."""
    from types import SimpleNamespace

    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import _resolve_joint_tail

    plan = SimpleNamespace(device=torch.device(device))
    cfg = GibbsConfig(task="regression", joint_rows=True,
                      joint_tail_kernel=choice)
    if want is ValueError:
        with pytest.raises(ValueError, match="CUDA kernel"):
            _resolve_joint_tail(cfg, plan, rank)
    else:
        assert _resolve_joint_tail(cfg, plan, rank).joint_tail_kernel is want
