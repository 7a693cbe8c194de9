"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips without a card.
The file imports neither JAX nor the TPU package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, as a share of the plain output's largest entry: 1e-4 in
float32 (the kernel and the plain version sum up to ~10^4 rows per
carried chain in different orders) and 1e-10 in float64.  The joint
tail's float32 results are held to the float64 result instead (see
``test_joint_tail_kernel_matches_plain``).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from myfm_tpu_torch import MyFMGibbsRegressor
from myfm_tpu_torch.design_categorical import compile_categorical_table
from myfm_tpu_torch.ops import gram


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(T, S, n_cross, seed, dtype, R=32, N=20_000, B=300):
    """Kernel operands on a real packing, with entity 2 owning a quarter
    of the rows (a long chain of tiles) and entity 5 none."""
    rng = np.random.RandomState(seed)
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6
    ent[: N // 4] = 2
    tab = compile_categorical_table(
        ent, B, 0, N, dtype, "cpu", rank=R, fixed_ts=(T, S)
    )
    K = tab.n_tiles
    slot_f = tab.slot_f.numpy().reshape(K, T)
    valid = (slot_f < S)[:, :, None]
    gths = []
    for _ in range(n_cross):
        core = 0.3 * rng.normal(size=(K, T, 1 + R)) * valid
        qs = (core[:, :, 1:] ** 2).sum(axis=2, keepdims=True)
        gths.append(np.concatenate([core, qs], axis=2).astype(dtype))
    wv = 0.3 * rng.normal(size=(K, S, 1 + R))
    wvsl = np.concatenate(
        [wv, (wv[:, :, 1:] ** 2).sum(axis=2, keepdims=True)], axis=2
    ).astype(dtype)
    aux2 = np.stack(
        [slot_f, 3.0 + rng.normal(size=(K, T)) * valid[:, :, 0]], axis=1
    ).astype(dtype)
    flags = [tab.cont_in.numpy(), tab.cont_out.numpy(),
             tab.last_slot.numpy()]
    carry = rng.normal(size=(R + 2, R + 2)).astype(dtype)
    return aux2, gths, wvsl, flags, S, carry


def _run(args, device, fn):
    aux2, gths, wvsl, flags, S, carry = args

    def t(a):
        return torch.as_tensor(a, device=device)

    out, c = fn(t(aux2), [t(g) for g in gths], t(wvsl),
                *[t(f) for f in flags], S, t(carry))
    return out.cpu().numpy(), c.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("T,S,n_cross", [(16, 2, 2), (256, 8, 2),
                                         (128, 64, 1), (512, 1, 0)])
def test_gram_kernel_matches_plain(dtype, tol, T, S, n_cross):
    device = _cuda()
    args = _problem(T, S, n_cross, seed=T + S, dtype=dtype)
    before = gram.fused_tile_gram_cross.launches
    out, carry = _run(args, device, gram.fused_tile_gram_cross)
    torch.cuda.synchronize()
    assert gram.fused_tile_gram_cross.launches == before + 1
    ref, ref_carry = _run(args, device,
                          gram.fused_tile_gram_cross_reference)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out - ref).max()) <= tol * scale
    assert float(np.abs(carry - ref_carry).max()) <= tol * scale


@pytest.mark.cuda
def test_gram_kernel_unsorted_slots_and_handmade_flags():
    """Slots out of order inside a tile and flags that thread the carry
    through non-zero last slots: the kernel keeps the plain version's
    semantics."""
    device = _cuda()
    rng = np.random.RandomState(11)
    K, T, S, R = 70, 64, 4, 6
    slot = rng.randint(0, S, size=(K, T)).astype(np.float64)
    slot[:, -5:] = S
    valid = (slot < S)[:, :, None]
    gths = []
    for _ in range(2):
        core = rng.normal(size=(K, T, 1 + R)) * valid
        qs = (core[:, :, 1:] ** 2).sum(axis=2, keepdims=True)
        gths.append(np.concatenate([core, qs], axis=2))
    flags = [rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, S, K).astype(np.int32)]
    args = (np.stack([slot, rng.normal(size=(K, T))], axis=1), gths,
            rng.normal(size=(K, S, 2 + R)), flags, S,
            rng.normal(size=(R + 2, R + 2)))
    out, carry = _run(args, device, gram.fused_tile_gram_cross)
    ref, ref_carry = _run(args, device,
                          gram.fused_tile_gram_cross_reference)
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(carry, ref_carry, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_fit_on_card_goes_through_the_kernel():
    device = _cuda()
    rng = np.random.RandomState(0)
    n, n_u, n_i = 3000, 60, 40
    u = rng.randint(0, n_u, n)
    i = rng.randint(0, n_i, n)
    y = 3.0 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i] + (
        0.3 * rng.normal(size=n)
    )
    from myfm_tpu_torch import RelationBlock

    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    before = gram.fused_tile_gram_cross.launches
    fm = MyFMGibbsRegressor(rank=4, device=device).fit(
        None, y, X_rel=blocks, n_iter=30, n_kept_samples=20,
        group_shapes=[n_u, n_i],
    )
    assert fm.history_.engine == "fastpath"
    assert gram.fused_tile_gram_cross.launches > before
    pred = fm.predict(None, blocks)
    assert float(np.sqrt(np.mean((pred - y) ** 2))) < 0.45


# ---------------------------------------------------------------------------
# joint_tail_pass (csrc/joint_tail.cu)
# ---------------------------------------------------------------------------


def _tail_problem(C, B, Pf, R, seed, dtype, single_row=False, pad_slot=False):
    """A structurally valid tail stack: per color each block row holds at
    most one feature slot, and the Gram is a genuine sum of z zᵀ."""
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
    if pad_slot:
        xw[segb == Pf - 1] = 0.0
        segb[segb == Pf - 1] = Pf
    ops = [G.reshape(B, D * D).T.copy(),
           0.05 * rng.normal(size=(R, B)), 0.05 * rng.normal(size=B),
           xw, segb,
           0.3 * rng.normal(size=(C, Pf, R + 1)),
           np.abs(rng.normal(size=(C, Pf, R + 1))) + 0.5,
           0.1 * rng.normal(size=(C, Pf, R + 1)),
           rng.normal(size=(C, Pf, R + 1))]
    return [o if o.dtype == np.int32 else o.astype(dtype) for o in ops]


def _tail(fn, ops, device, alpha, D):
    t = [torch.as_tensor(o, device=device) for o in ops]
    alpha_t = torch.tensor(alpha, dtype=t[0].dtype, device=device)
    return [o.cpu().numpy() for o in fn(*t, alpha_t, D)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("C,B,Pf,R,single_row,pad_slot", [
    (7, 37, 4, 3, False, False),
    (20, 101, 8, 10, False, True),
    (15, 70, 1, 10, True, False),
    (6, 45, 8, 32, False, True),
    (9, 943, 8, 10, True, True),
    # per-slot arrays beyond shared memory: the workspace variant
    (4, 200, 40, 32, False, True),
    (5, 943, 300, 10, True, False),
])
def test_joint_tail_kernel_matches_plain(dtype, tol, C, B, Pf, R,
                                         single_row, pad_slot):
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    D = R + 2
    ops = _tail_problem(C, B, Pf, R, seed=C + B, dtype=dtype,
                        single_row=single_row, pad_slot=pad_slot)
    before = joint_tail.joint_tail_pass.launches
    got = _tail(joint_tail.joint_tail_pass, ops, device, 1.3, D)
    torch.cuda.synchronize()
    assert joint_tail.joint_tail_pass.launches == before + 1
    want = _tail(joint_tail.joint_tail_pass_reference, ops, device, 1.3, D)
    # float32 is held, like the plain version, to the float64 result: a
    # 33-dim draw from a random Gram is ill-conditioned enough that the
    # plain float32 version itself lies ~9e-4 of scale from it at D = 34
    ops64 = [o if o.dtype == np.int32 else o.astype(np.float64) for o in ops]
    exact = _tail(joint_tail.joint_tail_pass_reference, ops64, device, 1.3, D)
    for name, g, w, x in zip(("G", "Atot", "Ct", "u_new"), got, want, exact):
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(x).max()), 1.0)
        if dtype == np.float64:
            assert float(np.abs(g - w).max()) <= tol * scale, name
        else:
            plain_err = float(np.abs(w - x).max())
            assert float(np.abs(g - x).max()) <= max(
                tol * scale, 2.0 * plain_err), name
    if pad_slot:  # slot Pf-1 owns no rows: its state is left as it was
        untouched = (ops[4] == Pf).all(axis=0)
        np.testing.assert_array_equal(got[0][:, untouched],
                                      ops[0][:, untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("Pf,R", [(8, 10), (40, 32)])
def test_joint_tail_kernel_is_deterministic(dtype, Pf, R):
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    ops = _tail_problem(40, 300, Pf, R, seed=4, dtype=dtype)
    a = _tail(joint_tail.joint_tail_pass, ops, device, 0.9, R + 2)
    b = _tail(joint_tail.joint_tail_pass, ops, device, 0.9, R + 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_joint_fit_on_card_goes_through_the_tail_kernel():
    from myfm_tpu_torch import RelationBlock
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    rng = np.random.RandomState(1)
    n, n_u, n_i = 3000, 60, 40
    u = rng.randint(0, n_u, n)
    i = rng.randint(0, n_i, n)
    imp = sps.csr_matrix((rng.random((n_u, n_i)) > 0.6).astype(np.float64))
    y = 3.0 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i] + (
        0.3 * rng.normal(size=n))
    blocks = [RelationBlock(u, sps.hstack([sps.identity(n_u, format="csr"),
                                           imp], format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    before = joint_tail.joint_tail_pass.launches
    fm = MyFMGibbsRegressor(rank=4, device=device).fit(
        None, y, X_rel=blocks, n_iter=200, n_kept_samples=100,
        group_shapes=[n_u, n_i, n_i],
    )
    assert fm.history_.engine == "joint"
    assert joint_tail.joint_tail_pass.launches > before
    pred = fm.predict(None, blocks)
    assert np.isfinite(pred).all()
    assert float(np.sqrt(np.mean((pred - y) ** 2))) < 0.45


@pytest.mark.cuda
@pytest.mark.parametrize("rank,max_unrolled", [(10, 2), (10, 0), (32, 0)])
def test_joint_sweep_with_tail_kernel_matches_plain_on_real_plans(
        rank, max_unrolled):
    """One float64 joint sweep on the synthetic "tiny" timeSVD++ plan,
    tail kernel against plain tail, from one state and one set of
    variates.  ``max_unrolled_colors=0`` stacks the one-hot id colour
    into the tail (Pf 64 and 48 there), which at rank 32 (D = 34) puts
    the kernel's per-slot arrays beyond shared memory."""
    import dataclasses

    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.ops import joint_tail
    from myfm_tpu_torch.ops.gibbs import (
        GibbsConfig,
        draw_gibbs_variates,
        gibbs_sweep,
    )
    from myfm_tpu_torch.trainer import GibbsTrainer
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    device = _cuda()
    tr, te = load_synthetic_movielens("tiny", 0)
    X, _, blocks, _, grouping = build_feature_blocks(tr, te,
                                                     "timesvdpp_flipped")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plan = compile_design(
            X, blocks, grouping=np.asarray(grouping, np.int32),
            dtype=np.float64, joint_dense=True, joint_rank=rank,
            max_unrolled_colors=max_unrolled, device=device,
        )
        pfs = [int(b.dense_stack.feat.shape[1]) for b in plan.blocks
               if b.dense_stack is not None]
        assert pfs and (max_unrolled > 0 or min(pfs) > 8), pfs
        tr_ = GibbsTrainer(plan, tr["rating"],
                           GibbsConfig(task="regression", joint_rows=True),
                           rank, 0.1, 3, np.float64)
        assert tr_.cfg.joint_tail_kernel is True
        state = tr_._initialize()
        v = draw_gibbs_variates(plan, tr_.cfg, rank, tr_.generator,
                                torch.float64, device)
        before = joint_tail.joint_tail_pass.launches
        got = gibbs_sweep(plan, state, tr_.y, v, tr_.cfg)
        assert joint_tail.joint_tail_pass.launches == before + len(pfs)
        want = gibbs_sweep(plan, state, tr_.y, v, dataclasses.replace(
            tr_.cfg, joint_tail_kernel=False))
    finally:
        torch.use_deterministic_algorithms(False)
    for f in ("w", "V", "e"):
        g, w = getattr(got, f), getattr(want, f)
        assert bool(torch.isfinite(g).all()), f
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-10 * scale, f
