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

import contextlib

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


@pytest.mark.cuda
def test_recorded_fit_on_card_counts_kernel1_and_repeats_the_chain():
    """Per sweep one kernel-1 span per launch, and the same chain with
    recording on and off."""
    from myfm_tpu_torch import RelationBlock, clear_plan_cache, tracing

    device = _cuda()
    rng = np.random.RandomState(1)
    n, n_u, n_i, n_iter = 3000, 60, 40, 6
    u = rng.randint(0, n_u, n)
    i = rng.randint(0, n_i, n)
    y = 3.0 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    fits = []
    for record in (False, True):
        clear_plan_cache()
        before = gram.fused_tile_gram_cross.launches
        fm = MyFMGibbsRegressor(rank=4, random_seed=3, device=device)
        with (tracing.recording() if record
              else contextlib.nullcontext()) as rec:
            fm.fit(None, y, X_rel=blocks, n_iter=n_iter,
                   n_kept_samples=n_iter, group_shapes=[n_u, n_i])
        fits.append((fm, gram.fused_tile_gram_cross.launches - before, rec))
    (off, launches, _), (on, launches_on, rec) = fits
    assert launches == launches_on and launches % n_iter == 0
    per_sweep = [0] * n_iter
    for s in rec.spans:
        if s.name == "myfm.sweep.kernel1":
            per_sweep[s.sweep] += 1
    assert per_sweep == [launches // n_iter] * n_iter
    # each sweep's two harvests (hyperparameters, sample) are waited on
    # inside myfm.loop.drain
    assert rec.summary()["myfm.loop.drain"]["calls"] == 2 * n_iter
    for a, b in zip(off.predictor_.samples, on.predictor_.samples):
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.V, b.V)
    assert [h.alpha for h in off.history_.hypers] == [
        h.alpha for h in on.history_.hypers]


# ---------------------------------------------------------------------------
# joint_tail_pass (csrc/joint_tail.cu)
# ---------------------------------------------------------------------------


def _tail_problem(C, B, Pf, R, seed, dtype, single_row=False, pad_slot=False,
                  edge=None):
    """A structurally valid tail stack: per color each block row holds at
    most one feature slot, and the Gram is a genuine sum of z zᵀ.
    ``edge``: "empty_color" leaves every other color without rows (all its
    slots pads); "all_rows" gives slot 0 of every third color every block
    row."""
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
    if edge == "empty_color":
        xw[::2] = 0.0
        segb[::2] = Pf
    elif edge == "all_rows":
        segb[::3] = 0
        xw[::3] = rng.choice([-1.0, 0.5], size=xw[::3].shape)
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
@pytest.mark.parametrize("C,B,Pf,R,single_row,pad_slot,edge", [
    (7, 37, 4, 3, False, False, None),
    (20, 101, 8, 10, False, True, None),
    (15, 70, 1, 10, True, False, None),
    (6, 45, 8, 32, False, True, None),
    (9, 943, 8, 10, True, True, None),
    # per-slot arrays beyond shared memory: the workspace variant
    (4, 200, 40, 32, False, True, None),
    (5, 943, 300, 10, True, False, None),
    # colors whose slots own no rows at all
    (8, 64, 4, 10, False, False, "empty_color"),
    # one slot owning every block row (touched = B, beyond a warp's rows)
    (6, 300, 4, 10, False, False, "all_rows"),
    (4, 943, 8, 32, False, False, "all_rows"),
    # one slot per color
    (12, 90, 1, 4, False, False, None),
    # D = 34: Dp = 33 rows over 32 lanes, several live slots per color
    (5, 300, 12, 32, False, False, None),
    # the real tail's size: C = 1,068 colors at B = 943
    (1068, 943, 8, 10, False, True, None),
])
def test_joint_tail_kernel_matches_plain(dtype, tol, C, B, Pf, R,
                                         single_row, pad_slot, edge):
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    D = R + 2
    ops = _tail_problem(C, B, Pf, R, seed=C + B, dtype=dtype,
                        single_row=single_row, pad_slot=pad_slot, edge=edge)
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
@pytest.mark.parametrize("C,B,Pf,R,edge", [
    (40, 300, 8, 10, None), (40, 300, 40, 32, None),
    (40, 300, 1, 4, None), (40, 300, 12, 32, None),
    (12, 300, 4, 10, "all_rows"), (12, 64, 4, 10, "empty_color"),
    (1068, 943, 8, 10, None),
])
def test_joint_tail_kernel_is_deterministic(dtype, C, B, Pf, R, edge):
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    ops = _tail_problem(C, B, Pf, R, seed=4, dtype=dtype, edge=edge)
    a = _tail(joint_tail.joint_tail_pass, ops, device, 0.9, R + 2)
    b = _tail(joint_tail.joint_tail_pass, ops, device, 0.9, R + 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,Pf,R", [(40, 300, 8, 10), (5, 943, 300, 10)])
def test_joint_tail_timed_build_matches_production(C, B, Pf, R):
    """The chain's timed instantiation (the "joint_tail_timed" library)
    gives the production kernel's bits and counts cycles in every phase;
    per-slot arrays in shared memory (Pf 8) and in the workspace (Pf 300)."""
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    ops = _tail_problem(C, B, Pf, R, seed=7, dtype=np.float32)
    t = [torch.as_tensor(o, device=device) for o in ops]
    alpha = torch.tensor(0.9, device=device)
    want = joint_tail.joint_tail_pass(*t, alpha, R + 2)
    got, cycles = joint_tail.joint_tail_phases(*t, alpha, R + 2)
    for name, g, w in zip(("G", "Atot", "Ct", "u_new"), got, want):
        assert torch.equal(g, w), name
    assert (cycles[:len(joint_tail.PHASES)] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,Pf,edge", [
    (7, 37, 4, None), (1, 1, 1, None), (5, 31, 3, "empty_color"),
    (6, 300, 4, "all_rows"), (1068, 943, 8, None), (5, 943, 300, None),
    (3, 200, 1656, None),
])
def test_tail_lists_kernel_matches_plain(C, B, Pf, edge):
    """The prep kernel's lists (rows grouped by slot, live-slot starts,
    live ids and count) bit-equal to ``tail_lists_reference``, with colors
    whose segb is Pf everywhere."""
    from myfm_tpu_torch.ops import joint_tail

    device = _cuda()
    segb = _tail_problem(C, B, min(Pf, B), 2, seed=C + B + Pf,
                         dtype=np.float32, edge=edge)[4]
    segb[segb == min(Pf, B)] = Pf
    segb[C // 2] = Pf  # one color without rows
    sg = torch.as_tensor(segb, device=device)
    before = joint_tail.tail_lists.launches
    got = joint_tail.tail_lists(sg, Pf)
    torch.cuda.synchronize()
    assert joint_tail.tail_lists.launches == before + 1
    want = joint_tail.tail_lists_reference(sg, Pf)
    for name, g, w in zip(("rows", "lstart", "live"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


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


# ---------------------------------------------------------------------------
# the VI uses of csrc/fused_gram_cross.cu: kernel 1's VI layout and
# kernel 2 (fused_tile_gram)
# ---------------------------------------------------------------------------


def _vi_gram_problem(T, S, n_cross, R, seed, dtype, N=20_000, B=300):
    """Kernel 1 operands in the VI layout on a real packing: gathered rows
    [w | wvar | V | σ | sv | qs] (3 + 3R columns), own [w | V | qs]."""
    rng = np.random.RandomState(seed)
    ent = rng.randint(0, B, N)
    ent[: N // 4] = 2
    tab = compile_categorical_table(ent, B, 0, N, dtype, "cpu", rank=3 * R,
                                    fixed_ts=(T, S))
    K = tab.n_tiles
    slot_f = tab.slot_f.numpy().reshape(K, T)
    valid = (slot_f < S)[:, :, None]
    gths = []
    for _ in range(n_cross):
        V = 0.3 * rng.normal(size=(K, T, R))
        s = 0.1 * rng.random((K, T, R)) + 0.01
        body = np.concatenate(
            [rng.normal(size=(K, T, 1)), rng.random((K, T, 1)), V, s, s * V,
             (V * V).sum(axis=2, keepdims=True)], axis=2)
        gths.append((body * valid).astype(dtype))
    wv = 0.3 * rng.normal(size=(K, S, 1 + R))
    wvsl = np.concatenate(
        [wv, (wv[:, :, 1:] ** 2).sum(axis=2, keepdims=True)], axis=2
    ).astype(dtype)
    aux2 = np.stack(
        [slot_f, 3.0 + rng.normal(size=(K, T)) * valid[:, :, 0]], axis=1
    ).astype(dtype)
    flags = [tab.cont_in.numpy(), tab.cont_out.numpy(),
             tab.last_slot.numpy()]
    carry = rng.normal(size=(2 + R, 3 * R + 2)).astype(dtype)
    return aux2, gths, wvsl, flags, S, carry


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("T,S,n_cross,R", [(16, 2, 1, 1), (128, 4, 2, 10),
                                           (128, 8, 2, 32)])
def test_gram_kernel_vi_layout_matches_plain(dtype, tol, T, S, n_cross, R):
    device = _cuda()
    aux2, gths, wvsl, flags, S, carry = _vi_gram_problem(
        T, S, n_cross, R, seed=T + R, dtype=dtype)

    def run(fn):
        def t(a):
            return torch.as_tensor(a, device=device)

        out, c = fn(t(aux2), [t(g) for g in gths], t(wvsl),
                    *[t(f) for f in flags], S, t(carry), q_lo=2,
                    n_extra=2 * R, out_rows=2 + R)
        return out.cpu().numpy(), c.cpu().numpy()

    before = (gram.fused_tile_gram_cross.launches,
              gram.fused_tile_gram_cross.vi_launches)
    out, c = run(gram.fused_tile_gram_cross)
    torch.cuda.synchronize()
    assert (gram.fused_tile_gram_cross.launches,
            gram.fused_tile_gram_cross.vi_launches) == (before[0],
                                                        before[1] + 1)
    ref, ref_c = run(gram.fused_tile_gram_cross_reference)
    assert out.shape == ref.shape == (len(ref), 2 + R, 3 * R + 2)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out - ref).max()) <= tol * scale
    assert float(np.abs(c - ref_c).max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("T,S,R,Rq,out_rows", [
    (16, 2, 3, 12, None), (256, 4, 10, 40, 12), (128, 64, 10, 40, 12),
    (128, 1, 2, 5, 4),
])
def test_meta_gram_kernel_matches_plain(dtype, tol, T, S, R, Rq, out_rows):
    device = _cuda()
    rng = np.random.RandomState(T + S + R)
    N, B = 20_000, 300
    ent = rng.randint(0, B, N)
    ent[: N // 4] = 2
    tab = compile_categorical_table(ent, B, 0, N, dtype, "cpu", rank=Rq,
                                    fixed_ts=(T, S))
    K = tab.n_tiles
    ones = (tab.src.numpy().reshape(K, T) < N).astype(dtype)
    meta = np.stack([ones, 3.0 + rng.normal(size=(K, T)) * ones,
                     rng.random((K, T)) * ones], axis=2).astype(dtype)
    q_other = (0.3 * rng.normal(size=(K, T, Rq)) * ones[:, :, None]
               ).astype(dtype)
    wvsl = (0.3 * rng.normal(size=(K, S, 1 + R))).astype(dtype)
    D = Rq + 2
    carry = rng.normal(size=(out_rows or D, D)).astype(dtype)
    ops = [torch.as_tensor(a, device=device) for a in (
        meta, q_other, tab.slot.numpy().reshape(K, T), wvsl,
        tab.cont_in.numpy(), tab.cont_out.numpy(), tab.last_slot.numpy(),
    )]
    cy = torch.as_tensor(carry, device=device)
    before = gram.fused_tile_gram.launches
    out, c = gram.fused_tile_gram(*ops, S, cy, out_rows=out_rows)
    torch.cuda.synchronize()
    assert gram.fused_tile_gram.launches == before + 1
    ref, ref_c = gram.fused_tile_gram_reference(*ops, S, cy,
                                                out_rows=out_rows)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((c - ref_c).abs().max()) <= tol * scale


def _rect_problem(kernel, R, S, seed, K=70, T=16):
    """Operands of the Gram-rectangle pass (out_rows = 2 + R < D = 3R + 2)
    with slots out of order, invalid rows in the middle of every tile
    (slot S or -1 for kernel 1, ones = 0 for kernel 2) and flags that
    thread the carry through non-zero last slots.  Where T > 256 the
    pass lists runs 256 rows at a time: even tiles then hold a run that
    crosses row 256, odd tiles a slot that recurs after an invalid row
    256."""
    rng = np.random.RandomState(seed)
    slot = rng.randint(0, S, size=(K, T))
    slot[:, T // 3] = S
    slot[:, T // 2] = -1
    if T > 256:
        for k in range(K):
            if k % 2 == 0:
                slot[k, 250:263] = k % S
            else:
                slot[k, 255:258] = k % S
    flags = [rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, S, K).astype(np.int32)]
    D = 3 * R + 2
    carry = rng.normal(size=(2 + R, D))
    if kernel == "cross":
        if T > 256:
            slot[1::2, 256] = S
        gths = [rng.normal(size=(K, T, 3 + 3 * R)) for _ in range(2)]
        aux2 = np.stack([slot.astype(np.float64), rng.normal(size=(K, T))],
                        axis=1)
        return [aux2, gths, rng.normal(size=(K, S, 2 + R))] + flags, carry
    ones = (rng.random((K, T)) < 0.8).astype(np.float64)
    ones[:, T // 4] = 0.0
    if T > 256:
        ones[0::2, 250:263] = 1.0
        ones[1::2, 255:258] = [1.0, 0.0, 1.0]  # slot 256 kept, row invalid
    meta = np.stack([ones, rng.normal(size=(K, T)), rng.random((K, T))],
                    axis=2)
    slot = np.where(slot < 0, S, slot).astype(np.int32)
    return [meta, rng.normal(size=(K, T, 3 * R)), slot,
            rng.normal(size=(K, S, 1 + R))] + flags, carry


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("R,T", [(1, 16), (3, 16), (10, 16), (32, 16),
                                 (48, 16), (3, 300), (24, 300)])
@pytest.mark.parametrize("kernel", ["cross", "meta"])
def test_rect_gram_pass_matches_plain(kernel, R, T, S, dtype, tol):
    """Kernel 1's VI layout and kernel 2 through the register-tiled
    rectangle pass: out_rows and D not multiples of the 2 x 2 or 4 x 4
    register blocks (R = 48: more blocks than threads; R = 3 and 24 take
    2 x 2 and 4 x 4 across the run list's 256-row chunks), against the
    plain version, and two runs bit-equal."""
    device = _cuda()
    ops, carry = _rect_problem(kernel, R, S, seed=R * 100 + S + T, T=T)

    def t(a):
        a = torch.as_tensor(a, device=device)
        return a.to(tdt) if a.is_floating_point() else a

    tdt = torch.float32 if dtype == np.float32 else torch.float64

    ops = [[t(g) for g in o] if isinstance(o, list) else t(o) for o in ops]
    cy = t(carry)
    if kernel == "cross":
        fn, plain, counter = (gram.fused_tile_gram_cross,
                              gram.fused_tile_gram_cross_reference,
                              "vi_launches")
        kw = dict(q_lo=2, n_extra=2 * R, out_rows=2 + R)
    else:
        fn, plain, counter = (gram.fused_tile_gram,
                              gram.fused_tile_gram_reference, "launches")
        kw = dict(out_rows=2 + R)
    before = getattr(fn, counter)
    out, c = fn(*ops, S, cy, **kw)
    again, c2 = fn(*ops, S, cy, **kw)
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 2
    assert torch.equal(out, again) and torch.equal(c, c2)
    ref, ref_c = plain(*ops, S, cy, **kw)
    assert out.shape == ref.shape == (70 * S, 2 + R, 3 * R + 2)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((c - ref_c).abs().max()) <= tol * scale


def _square_problem(kernel, R, S, seed, T, K=70):
    """Operands of the square Gram pass (the full D x D Gram) for kernel 1's
    Gibbs layout ("cross", D = R + 2), kernel 2 with out_rows=None
    ("meta", D = R + 4) and kernel 3 ("rows", D = R + 2), with slots out
    of order, invalid rows in the middle of every tile (slot S or -1; for
    kernel 2 also ones = 0) and flags that thread the carry through
    non-zero last slots.  Where T > 256 even tiles hold a run that
    crosses row 256 and odd tiles a slot that recurs after an invalid row
    256.  Returns (operands, carry_in [D, D])."""
    rng = np.random.RandomState(seed)
    slot = rng.randint(0, S, size=(K, T))
    slot[:, T // 3] = S
    slot[:, T // 2] = -1
    if T > 256:
        slot[0::2, 250:263] = (np.arange(0, K, 2) % S)[:, None]
        slot[1::2, 255:258] = (np.arange(1, K, 2) % S)[:, None]
        slot[1::2, 256] = S
    flags = [rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, 2, K).astype(np.int32),
             rng.randint(0, S, K).astype(np.int32)]
    if kernel == "cross":
        gths = [rng.normal(size=(K, T, R + 2)) for _ in range(2)]
        aux2 = np.stack([slot.astype(np.float64), rng.normal(size=(K, T))],
                        axis=1)
        ops = [aux2, gths, rng.normal(size=(K, S, R + 2))] + flags
        return ops, rng.normal(size=(R + 2, R + 2))
    if kernel == "rows":
        ops = [rng.normal(size=(K, T, R + 2)), slot.astype(np.int32)] + flags
        return ops, rng.normal(size=(R + 2, R + 2))
    ones = (rng.random((K, T)) < 0.8).astype(np.float64)
    ones[:, T // 4] = 0.0
    if T > 256:
        ones[0::2, 250:263] = 1.0
        ones[1::2, 255:258] = 1.0
    meta = np.stack([ones, rng.normal(size=(K, T)), rng.random((K, T))],
                    axis=2)
    slot = np.where(slot < 0, S, slot).astype(np.int32)
    ops = [meta, rng.normal(size=(K, T, R + 2)), slot,
           rng.normal(size=(K, S, 1 + R))] + flags
    return ops, rng.normal(size=(R + 4, R + 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("R,T", [(1, 16), (3, 16), (10, 16), (32, 16),
                                 (48, 16), (3, 300), (32, 300), (1, 1024),
                                 (10, 1024)])
@pytest.mark.parametrize("kernel", ["cross", "meta", "rows"])
def test_square_gram_pass_matches_plain(kernel, R, T, S, dtype, tol):
    """Kernel 1's Gibbs layout, kernel 2 with out_rows=None and kernel 3
    through the square pass (the triangle of register blocks): D not a
    multiple of the block (R = 48: the 4 x 4 triangle), runs cut by the
    run list's 256-row chunks (T = 300, 1024), against the plain version,
    and two runs bit-equal."""
    device = _cuda()
    ops, carry = _square_problem(kernel, R, S, seed=R * 100 + S + T, T=T)
    tdt = torch.float32 if dtype == np.float32 else torch.float64

    def t(a):
        a = torch.as_tensor(a, device=device)
        return a.to(tdt) if a.is_floating_point() else a

    ops = [[t(g) for g in o] if isinstance(o, list) else t(o) for o in ops]
    cy = t(carry)
    fn, plain = {
        "cross": (gram.fused_tile_gram_cross,
                  gram.fused_tile_gram_cross_reference),
        "meta": (gram.fused_tile_gram, gram.fused_tile_gram_reference),
        "rows": (gram.tile_gram, gram.tile_gram_reference),
    }[kernel]
    before = fn.launches
    out, c = fn(*ops, S, cy)
    again, c2 = fn(*ops, S, cy)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(out, again) and torch.equal(c, c2)
    ref, ref_c = plain(*ops, S, cy)
    D = carry.shape[0]
    assert out.shape == ref.shape == (70 * S, D, D)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((c - ref_c).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_gram_kernels_refuse_tiles_beyond_shared_memory():
    device = _cuda()
    K, T, S, R = 2, 1024, 2, 32
    z = torch.zeros
    flags = [z(K, dtype=torch.int32, device=device) for _ in range(3)]
    with pytest.raises(ValueError, match="shared memory"):
        gram.fused_tile_gram_cross(
            z(K, 2, T, dtype=torch.float64, device=device),
            [z(K, T, 3 + 3 * R, dtype=torch.float64, device=device)],
            z(K, S, 2 + R, dtype=torch.float64, device=device), *flags, S,
            q_lo=2, n_extra=2 * R, out_rows=2 + R)
    with pytest.raises(ValueError, match="shared memory"):
        gram.fused_tile_gram(
            z(K, T, 3, dtype=torch.float64, device=device),
            z(K, T, 4 * R, dtype=torch.float64, device=device),
            z(K, T, dtype=torch.int32, device=device),
            z(K, S, 1 + R, dtype=torch.float64, device=device), *flags, S,
            out_rows=2 + R)
    # fp32 rectangle tiles whose dynamic stage fits (229,472 and 229,944
    # B) but not with the rectangle pass's run list on top
    R, S = 32, 2
    for T, launch in ((573, "cross"), (580, "meta")):
        flags = [z(K, dtype=torch.int32, device=device) for _ in range(3)]
        with pytest.raises(ValueError, match="shared memory"):
            if launch == "cross":
                gram.fused_tile_gram_cross(
                    z(K, 2, T, device=device),
                    [z(K, T, 3 + 3 * R, device=device)],
                    z(K, S, 2 + R, device=device), *flags, S, q_lo=2,
                    n_extra=2 * R, out_rows=2 + R)
            else:
                gram.fused_tile_gram(
                    z(K, T, 3, device=device), z(K, T, 3 * R, device=device),
                    z(K, T, dtype=torch.int32, device=device),
                    z(K, S, 1 + R, device=device), *flags, S,
                    out_rows=2 + R)
    # fp32 square tiles (kernel 1's Gibbs layout, kernel 3; R = 32, T =
    # 1650: 231,272 and 231,000 B of dynamic stage) that fit but not with
    # the run list on top
    T = 1650
    flags = [z(K, dtype=torch.int32, device=device) for _ in range(3)]
    with pytest.raises(ValueError, match="shared memory"):
        gram.fused_tile_gram_cross(
            z(K, 2, T, device=device), [z(K, T, 2 + R, device=device)],
            z(K, S, 2 + R, device=device), *flags, S)
    with pytest.raises(ValueError, match="shared memory"):
        gram.tile_gram(z(K, T, 2 + R, device=device),
                       z(K, T, dtype=torch.int32, device=device), *flags, S)


def _tiny_vi_plan(device, rank, dtype):
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    tr, te = load_synthetic_movielens("tiny", 0)
    X, _, blocks, _, grouping = build_feature_blocks(tr, te,
                                                     "timesvdpp_flipped")
    plan = try_compile_categorical(
        X, blocks, np.asarray(grouping, np.int32), None, dtype, device,
        rank=4 * rank, allow_side=True)
    assert plan is not None and plan.has_side
    return plan, tr["rating"]


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [3, 10])
def test_vi_sweep_with_kernels_matches_plain(rank):
    """One float64 CAVI sweep on the tiny timeSVD++ entity+attribute plan
    through both kernels against one through their plain versions, from
    one state: every field within 1e-10 of its scale."""
    from myfm_tpu_torch.ops.categorical_vi import categorical_vi_sweep
    from myfm_tpu_torch.ops.variational import VariationalConfig
    from myfm_tpu_torch.vi_trainer import CategoricalVITrainer

    device = _cuda()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plan, y = _tiny_vi_plan(device, rank, np.float64)
        tr = CategoricalVITrainer(plan, y, VariationalConfig(), rank, 0.1, 0,
                                  np.float64)
        state = tr._initialize()
        before = (gram.fused_tile_gram_cross.vi_launches,
                  gram.fused_tile_gram.launches)
        got = categorical_vi_sweep(plan, state, tr.y, tr.y_tiles, tr.cfg)
        n_ea = sum(si is not None for si in plan.side)
        assert gram.fused_tile_gram.launches == before[1] + n_ea
        assert gram.fused_tile_gram_cross.vi_launches > before[0]
        want = categorical_vi_sweep(plan, state, tr.y, tr.y_tiles, tr.cfg,
                                    plain=True)
    finally:
        torch.use_deterministic_algorithms(False)
    for f in ("w", "w_var", "V", "V_var", "e", "e_var_sum", "elbo"):
        g, w = getattr(got.core, f), getattr(want.core, f)
        assert bool(torch.isfinite(g).all()), f
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-10 * scale, f


@pytest.mark.cuda
def test_vi_fit_on_card_goes_through_both_kernels():
    from myfm_tpu_torch import VariationalFMRegressor
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    device = _cuda()
    tr, te = load_synthetic_movielens("tiny", 0)
    Xtr, Xte, btr, bte, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    before = (gram.fused_tile_gram_cross.vi_launches,
              gram.fused_tile_gram.launches)
    fm = VariationalFMRegressor(rank=4, device=device).fit(
        Xtr, tr["rating"], X_rel=btr, n_iter=20, grouping=grouping)
    assert fm.history_.engine == "fastpath"
    assert gram.fused_tile_gram_cross.vi_launches > before[0]
    assert gram.fused_tile_gram.launches > before[1]
    elbos = np.asarray(fm.history_.elbos)
    assert (np.diff(elbos) >= -1e-6 * np.abs(elbos[1:])).all()
    pred = fm.predict(Xte, bte)
    assert float(np.sqrt(np.mean((pred - te["rating"]) ** 2))) < (
        te["rating"].std())


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [3, 10])
def test_vi_classification_sweep_with_kernels_matches_plain(rank):
    """The classification task's float64 sweep on the tiny timeSVD++
    entity+attribute plan, one sweep in (so both kernels' target column
    carries latent means τ, not ±1): through both kernels against through
    their plain versions, every field and τ within 1e-10 of its scale."""
    from myfm_tpu_torch.ops.categorical_vi import categorical_vi_sweep
    from myfm_tpu_torch.ops.variational import VariationalConfig
    from myfm_tpu_torch.vi_trainer import CategoricalVITrainer

    device = _cuda()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plan, y = _tiny_vi_plan(device, rank, np.float64)
        tr = CategoricalVITrainer(
            plan, np.where(np.asarray(y) >= 4, 1.0, -1.0),
            VariationalConfig(task="classification"), rank, 0.1, 0,
            np.float64)
        state = tr._sweep(tr._initialize())
        before = gram.fused_tile_gram.launches
        got = categorical_vi_sweep(plan, state, tr.y, tr.y_tiles, tr.cfg)
        assert gram.fused_tile_gram.launches > before
        want = categorical_vi_sweep(plan, state, tr.y, tr.y_tiles, tr.cfg,
                                    plain=True)
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = [(getattr(got.core, f), getattr(want.core, f))
             for f in ("w", "w_var", "V", "V_var", "e", "e_var_sum", "elbo")]
    for g, w in pairs + [(got.tau, want.tau)]:
        assert bool(torch.isfinite(g).all())
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-10 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_rowspace_vi_sweep_on_card_matches_cpu(task):
    """One float64 row-space CAVI sweep (the colored sweep, plain
    PyTorch) on the card against the same sweep on the CPU, from one
    state, on the tiny timeSVD++ design: every field within 1e-10 of its
    scale (index_add_ sums in another order on the card)."""
    import dataclasses

    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.ops import variational as tv
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    device = _cuda()
    tr, te = load_synthetic_movielens("tiny", 0)
    X, _, blocks, _, grouping = build_feature_blocks(tr, te,
                                                     "timesvdpp_flipped")
    y = np.asarray(tr["rating"], np.float64)
    if task == "classification":
        y = np.where(y >= 4, 1.0, -1.0)
    cfg = tv.VariationalConfig(task=task)
    out = {}
    for dev in ("cpu", device):
        plan = compile_design(X, blocks, grouping=np.asarray(grouping),
                              dtype=np.float64, max_unrolled_colors=4,
                              device=dev)
        st = tv.vi_init_state(plan, 4, 0.1, torch.Generator().manual_seed(0),
                              cfg, torch.float64, "cpu")
        st = tv.VIState(**{f.name: getattr(st, f.name).to(dev)
                           for f in dataclasses.fields(st)})
        yt = torch.as_tensor(y, device=dev)
        score, ev = tv.vi_update_e_and_var(plan, st.w0, st.w0_var, st.w,
                                           st.w_var, st.V, st.V_var)
        st = dataclasses.replace(st, e=score - yt, e_var_sum=ev)
        out[str(dev)] = tv.vi_sweep(plan, st, yt, cfg)
    cpu, card = out["cpu"], out[str(device)]
    for f in dataclasses.fields(cpu):
        g, w = getattr(card, f.name).cpu(), getattr(cpu, f.name)
        assert bool(torch.isfinite(g).all()), f.name
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-10 * scale, f.name


# ---------------------------------------------------------------------------
# the colored Gibbs engine and the joint-row factor sweep (plain PyTorch:
# no TPU kernel lies on them)
# ---------------------------------------------------------------------------

COLORED_SWEEPS = ("sweep_w", "sweep_V", "sweep_V_joint")


def _colored_sweep(name, device, dtype, rank=4):
    """One colored-engine sweep (``name``) on the tiny timeSVD++ design,
    compiled on ``device`` in ``dtype``, from one float64 state and one
    set of float64 variates drawn on the CPU (cast to ``dtype``):
    returns (weights, e) on the CPU in float64."""
    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.ops import gibbs as tg
    from myfm_tpu_torch.ops.forward import predict_score
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    tr, te = load_synthetic_movielens("tiny", 0)
    X, _, blocks, _, grouping = build_feature_blocks(tr, te,
                                                     "timesvdpp_flipped")

    def plan_on(dev, np_dtype):
        return compile_design(X, blocks, grouping=np.asarray(grouping),
                              dtype=np_dtype, max_unrolled_colors=4,
                              device=dev)

    plan64 = plan_on("cpu", np.float64)
    cfg = tg.GibbsConfig()
    gen = torch.Generator().manual_seed(0)
    st = tg.init_state(plan64, rank, 0.1, gen, cfg, torch.float64, "cpu")
    st.e = predict_score(plan64, st.w0, st.w, st.V) - torch.as_tensor(
        np.asarray(tr["rating"], np.float64))
    v = tg.draw_gibbs_variates(plan64, cfg, rank, gen, torch.float64, "cpu")
    h = tg.draw_hypers(plan64, st, v, cfg)
    plan = plan_on(device, np.float64 if dtype == torch.float64
                   else np.float32)

    def c(t):
        return t.to(device=device, dtype=dtype)

    if name == "sweep_w":
        args = (h.w, h.alpha, h.lambda_w, h.mu_w, v.noise[:, 0])
    else:
        args = (h.V, h.alpha, h.lambda_V, h.mu_V, v.noise[:, 1:])
    out = getattr(tg, name)(plan, c(h.e), *map(c, args))
    return [t.double().cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", COLORED_SWEEPS)
def test_colored_sweep_on_card_matches_cpu(name):
    """A float64 sweep on the card against the same sweep on the CPU
    with the same variates, within 1e-9 of each output's scale (the
    segment sums' atomics add in another order on the card)."""
    device = _cuda()
    card = _colored_sweep(name, device, torch.float64)
    cpu = _colored_sweep(name, "cpu", torch.float64)
    for g, w, what in zip(card, cpu, ("weights", "e")):
        assert bool(torch.isfinite(g).all()), what
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-9 * scale, what


@pytest.mark.cuda
@pytest.mark.parametrize("name", COLORED_SWEEPS)
def test_colored_sweep_fp32_on_card_near_fp64(name):
    """The same sweep in float32 on the card against float64 on the
    card, within 1e-4 of each output's scale (7e-7 measured on the CPU
    for these three sweeps)."""
    device = _cuda()
    f32 = _colored_sweep(name, device, torch.float32)
    f64 = _colored_sweep(name, device, torch.float64)
    for g, w, what in zip(f32, f64, ("weights", "e")):
        assert bool(torch.isfinite(g).all()), what
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-4 * scale, what


# ---------------------------------------------------------------------------
# the Gibbs fast path's entity+attribute tables: the side features' color
# scan through joint_tail_pass (kernel 4)
# ---------------------------------------------------------------------------


def _tiny_ea_gibbs(device, rank, dtype):
    """The tiny timeSVD++ design's Gibbs plan with entity+attribute tables
    (implicit columns 1/√n), a trainer on it and its initial state."""
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    tr, te = load_synthetic_movielens("tiny", 0)
    X, _, blocks, _, grouping = build_feature_blocks(tr, te,
                                                     "timesvdpp_flipped")
    plan = try_compile_categorical(
        X, blocks, np.asarray(grouping, np.int32), None, dtype, device,
        rank=rank, allow_side=True)
    assert plan is not None and plan.has_side
    trainer = CategoricalGibbsTrainer(plan, tr["rating"],
                                      GibbsConfig(task="regression"), rank,
                                      0.1, 2, dtype)
    assert trainer.cfg.joint_tail_kernel is (rank + 2 <= 34)
    return plan, trainer, trainer._initialize()


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [10, 32])
def test_ea_scan_through_tail_kernel_matches_plain(rank):
    """Each side table's color scan on the operands a first sweep's EA
    pass builds (``tools/joint_tail.ea_stacks``: the sweep's drawn
    hyperparameters, the Gram from kernel 1 over the effective rows as
    [1 | e | Q], the side features' rows), ``ea_color_scan`` through
    kernel 4 against the plain loop: the scanned Gram (whose rows 1 and
    D+1 give the moments) and the drawn rows.  float64 within 1e-10 of
    scale; float32 (the same operands rounded) held, as the joint tail's
    tests hold it, to the float64 result within 1e-3 of scale or twice
    the plain float32 loop's own distance from it."""
    from myfm_tpu_torch.ops import joint_tail
    from myfm_tpu_torch.ops.categorical import ea_color_scan
    from myfm_tpu_torch.tools.joint_tail import ea_stacks

    device = _cuda()
    D = rank + 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plan, tr, st = _tiny_ea_gibbs(device, rank, np.float64)
        stacks = ea_stacks(plan, tr, st, rank)
        assert len(stacks) == 2
        for s in stacks:
            ops = [s["ops"][0], *s["ops"][3:]]  # no Atot / Ct
            exact = ea_color_scan(*ops, s["alpha"], D)
            for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
                o = [t if t.dtype == torch.int32 else t.to(dtype)
                     for t in ops]
                alpha = s["alpha"].to(dtype)
                before = joint_tail.joint_tail_pass.launches
                got = ea_color_scan(*o, alpha, D, kernel=True)
                torch.cuda.synchronize()
                assert joint_tail.joint_tail_pass.launches == before + 1
                want = ea_color_scan(*o, alpha, D)
                for name, g, w, x in zip(("G", "u"), got, want, exact):
                    assert bool(torch.isfinite(g).all()), name
                    scale = max(float(x.abs().max()), 1.0)
                    err = float((g.double() - x).abs().max())
                    if dtype == torch.float64:
                        assert err <= tol * scale, (name, err, scale)
                    else:
                        plain_err = float((w.double() - x).abs().max())
                        assert err <= max(tol * scale, 2.0 * plain_err), (
                            name, err, plain_err, scale)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["regression", "classification", "ordered"])
def test_ea_sweep_through_tail_kernel_matches_plain(task):
    """One float64 fast-path sweep on the tiny entity+attribute plan with
    the scans through kernel 4 against one with the plain loop, from one
    state and one set of variates: w, V, the moments and (probit tasks)
    the residual within 1e-10 of scale; kernel 4 launched once per side
    table."""
    import dataclasses

    from myfm_tpu_torch.ops import joint_tail
    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    device = _cuda()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plan, tr, _ = _tiny_ea_gibbs(device, 4, np.float64)
        y = tr.y.cpu().numpy()
        extra = {}
        if task == "classification":
            y = np.where(y >= 4, 1.0, -1.0)
        elif task == "ordered":
            y, extra = y - 1, dict(n_class=5)
        tr = CategoricalGibbsTrainer(plan, y, GibbsConfig(task=task, **extra),
                                     4, 0.1, 2, np.float64)
        st = tr._initialize()
        v = draw_sweep_variates(plan, tr.cfg, 4, tr.generator, torch.float64,
                                device)
        before = joint_tail.joint_tail_pass.launches
        got = categorical_sweep(plan, st, tr.y, tr.y_tiles, v, tr.cfg)
        assert joint_tail.joint_tail_pass.launches == before + 2
        want = categorical_sweep(plan, st, tr.y, tr.y_tiles, v,
                                 dataclasses.replace(tr.cfg,
                                                     joint_tail_kernel=False))
    finally:
        torch.use_deterministic_algorithms(False)
    fields = [(f, getattr(got.core, f), getattr(want.core, f))
              for f in ("w", "V", "e")]
    fields += [(f, getattr(got, f), getattr(want, f))
               for f in ("sum_e", "sum_e2")]
    for f, g, w in fields:
        if task == "regression" and f == "e":
            continue  # regression carries moments, not the residual
        assert bool(torch.isfinite(g).all()), f
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-10 * scale, f


@pytest.mark.cuda
@pytest.mark.parametrize("est", ["MyFMGibbsRegressor", "MyFMGibbsClassifier",
                                 "MyFMOrderedProbit"])
def test_ea_fit_on_card_goes_through_both_kernels(est):
    """The three Gibbs estimators on the tiny timeSVD++ design, "auto" at
    20 sweeps: the fast path, kernel 1 launched, kernel 4 launched twice
    a sweep (one scan per side table), and serving on the entity-space
    plan."""
    import myfm_tpu_torch
    from myfm_tpu_torch.ops import joint_tail
    from myfm_tpu_torch.ops.forward_categorical import (
        compile_categorical_inference,
    )
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    device = _cuda()
    tr, te = load_synthetic_movielens("tiny", 0)
    Xtr, Xte, btr, bte, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    r_tr, r_te = np.asarray(tr["rating"]), np.asarray(te["rating"])
    y = {"MyFMGibbsRegressor": r_tr,
         "MyFMGibbsClassifier": (r_tr >= 4).astype(np.int64),
         "MyFMOrderedProbit": (r_tr - 1).astype(np.int64)}[est]
    before = (gram.fused_tile_gram_cross.launches,
              joint_tail.joint_tail_pass.launches)
    fm = getattr(myfm_tpu_torch, est)(rank=4, device=device).fit(
        Xtr, y, X_rel=btr, n_iter=20, grouping=grouping)
    assert fm.history_.engine == "fastpath"
    assert gram.fused_tile_gram_cross.launches > before[0]
    assert joint_tail.joint_tail_pass.launches == before[1] + 2 * 20
    splan = compile_categorical_inference(Xte, bte, np.float32, device)
    assert sum(t.xs is not None for t in splan.tables) == 2
    if est == "MyFMGibbsRegressor":
        pred = fm.predict(Xte, bte)
        assert np.isfinite(pred).all()
        assert float(np.sqrt(np.mean((pred - r_te) ** 2))) < r_te.std()
    else:
        P = fm.predict_proba(Xte, bte)
        assert np.isfinite(P).all()


# ---------------------------------------------------------------------------
# tile_gram (kernel 3), the section levels (kernel 5) and the (slot, τ)
# probe (kernel 6); one probit sweep through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("T,S,D", [(16, 2, 5), (256, 8, 34), (1024, 4, 34)])
def test_tile_gram_kernel_matches_plain(dtype, tol, T, S, D):
    device = _cuda()
    rng = np.random.RandomState(T + S)
    N, B = 20_000, 300
    ent = rng.randint(0, B, N)
    ent[: N // 4] = 2
    tab = compile_categorical_table(ent, B, 0, N, dtype, device,
                                    fixed_ts=(T, S))
    z = torch.as_tensor(rng.normal(size=(N + 1, D)).astype(dtype),
                        device=device)
    z[N] = 0.0  # pad rows gather the zero row
    rows = z[tab.src.long()].view(tab.n_tiles, T, D)
    carry = torch.as_tensor(rng.normal(size=(D, D)).astype(dtype),
                            device=device)
    args = (rows, tab.slot.view(tab.n_tiles, T), tab.cont_in, tab.cont_out,
            tab.last_slot, S)
    if T * D * np.dtype(dtype).itemsize > gram.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            gram.tile_gram(*args)
        return
    before = gram.tile_gram.launches
    out, c = gram.tile_gram(*args, carry_in=carry)
    torch.cuda.synchronize()
    assert gram.tile_gram.launches == before + 1
    ref, rc = gram.tile_gram_reference(*args, carry_in=carry)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((c - rc).abs().max()) <= tol * scale
    G = gram.entity_grams(tab, rows, S, D)
    Gp = gram.entity_grams(tab, rows, S, D, plain=True)
    assert float((G - Gp).abs().max()) <= tol * max(
        float(Gp.abs().max()), 1.0)


@pytest.mark.cuda
def test_section_levels_on_the_card():
    """Every level within tolerance of its plain version, level 3 bit for
    bit the production kernel (tools/kernel_sections.check_sections)."""
    from myfm_tpu_torch.tools import kernel_sections as ks

    _cuda()
    ops = ks.synthetic_operands(256, 4, 32, n_rows=200_000)
    before = list(gram.gram_section.launches)
    ks.check_sections(ops, 4)
    assert [a - b for a, b in zip(gram.gram_section.launches, before)] \
        == [1, 1, 1, 1]
    # a real packing with continued entities and pad rows
    args = _problem(256, 8, 2, seed=3, dtype=np.float32)
    aux2, gths, wvsl, flags, S, _ = args
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    ks.check_sections([t(aux2), [t(g) for g in gths], t(wvsl),
                       *[t(f) for f in flags]], S)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2, 256), (300, 2, 256), (7, 2, 3000)])
def test_interleave_probe_is_the_transpose(shape):
    from myfm_tpu_torch.tools import kernel_sections as ks

    _cuda()
    ks.check_probe(torch.randn(shape, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["classification", "ordered"])
def test_probit_sweep_through_the_kernel_matches_plain(task):
    """One fast-path sweep of each probit task through kernel 1 vs one
    through its plain version, same state and variates (fp64)."""
    device = _cuda()
    from myfm_tpu_torch import RelationBlock
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    rng = np.random.RandomState(4)
    n, n_u, n_i = 5000, 80, 50
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    z = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    y = (np.where(z > 0, 1.0, -1.0) if task == "classification"
         else np.searchsorted([-1.0, 0.0, 1.0], z).astype(np.float64))
    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   device, rank=4)
    extra = dict(n_class=4) if task == "ordered" else {}
    tr = CategoricalGibbsTrainer(plan, y, GibbsConfig(task=task, **extra),
                                 4, 0.1, 0, np.float64)
    st = tr._initialize()
    v = draw_sweep_variates(plan, tr.cfg, 4, tr.generator, torch.float64,
                            device)
    before = gram.fused_tile_gram_cross.launches
    a = categorical_sweep(plan, st, tr.y, tr.y_tiles, v, tr.cfg)
    assert gram.fused_tile_gram_cross.launches > before
    b = categorical_sweep(plan, st, tr.y, tr.y_tiles, v, tr.cfg, plain=True)
    for f in ("w", "V", "e"):
        x, r = getattr(a.core, f), getattr(b.core, f)
        assert float((x - r).abs().max()) <= 1e-8 * max(
            float(r.abs().max()), 1.0), f
    if task == "ordered":
        assert torch.allclose(a.core.cutpoints, b.core.cutpoints,
                              rtol=1e-8)


# ---- the reduced-precision Gram modes of kernels 1, 2 and 5 ----

# Kernel vs plain in one Gram mode: every bf16 product is exact in f32,
# and both sides build the same z rows bit for bit (the e column's sums
# of squares in one order, csrc/gram_tile.cuh add_sq), so only the order
# of the f32 sums differs, as in IEEE.
MODE_TOL = 1e-5


_MODE_SHAPES = [(1, 16), (10, 16), (32, 16), (48, 16), (128, 16),
                (10, 300)]
# (kernel, R, T): the rectangle at R = 128 (D = 386) fits shared memory
# only in short tiles, so its T = 300 case is R = 32
_MODE_CASES = (
    [(k, R, T) for k in ("cross", "meta")
     for R, T in _MODE_SHAPES + [(128, 300)]]
    + [(k, R, T) for k in ("cross_rect", "meta_rect")
       for R, T in _MODE_SHAPES + [(32, 300)]]
)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["highest", "split", "bf16"])
@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("kernel,R,T", _MODE_CASES)
def test_gram_modes_match_plain(kernel, R, T, S, mode):
    """Kernels 1 and 2 in each Gram mode (fp32) against their plain
    versions in the same mode, within MODE_TOL of scale: the square
    (Gibbs layout; kernel 2 with out_rows=None) and the VI rectangle (D =
    3R + 2, out_rows = R + 2), with runs shorter than a 16-row k-chunk,
    pad rows, slots out of order, runs cut by the run list's 256-row
    chunks (T = 300), S = 1 and 64, and R = 128 (the IEEE square at D =
    130 included); the reduced modes also within the self-check's gates
    of IEEE, and two runs bit-equal."""
    device = _cuda()
    base = kernel.split("_")[0]
    rect = kernel.endswith("_rect")
    seed = R * 100 + S + T
    ops, carry = (_rect_problem(base, R, S, seed, T=T) if rect
                  else _square_problem(base, R, S, seed, T=T))

    def t(a):
        a = torch.as_tensor(a, device=device)
        return a.float() if a.is_floating_point() else a

    ops = [[t(g) for g in o] if isinstance(o, list) else t(o) for o in ops]
    cy = t(carry)
    fn, plain = {
        "cross": (gram.fused_tile_gram_cross,
                  gram.fused_tile_gram_cross_reference),
        "meta": (gram.fused_tile_gram, gram.fused_tile_gram_reference),
    }[base]
    kw = {}
    if rect:
        kw = (dict(q_lo=2, n_extra=2 * R, out_rows=2 + R) if base == "cross"
              else dict(out_rows=2 + R))
    counts = (fn.mode_launches["gibbs" if not rect else "vi"]
              if base == "cross" else fn.mode_launches)
    before = counts[mode]
    out, c = fn(*ops, S, cy, fast_matmul=mode, **kw)
    again, c2 = fn(*ops, S, cy, fast_matmul=mode, **kw)
    torch.cuda.synchronize()
    assert counts[mode] == before + 2
    assert torch.equal(out, again) and torch.equal(c, c2)
    ref, ref_c = plain(*ops, S, cy, fast_matmul=mode, **kw)
    assert out.shape == ref.shape
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= MODE_TOL * scale
    assert float((c - ref_c).abs().max()) <= MODE_TOL * scale
    if mode != "highest":
        ieee, _ = fn(*ops, S, cy, **kw)
        assert float((out - ieee).abs().max()) <= \
            gram.SELFCHECK_TOL[mode] * float(ieee.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_section_levels_in_modes(mode):
    """Kernel 5 at levels 1-3 in each reduced mode against its plain
    version in that mode, level 3 bit-equal to kernel 1 in the same mode
    (tools/kernel_sections.check_sections), on synthetic tiles and on a
    real packing."""
    from myfm_tpu_torch.tools import kernel_sections as ks

    _cuda()
    ops = ks.synthetic_operands(256, 4, 32, n_rows=200_000)
    before = list(gram.gram_section.mode_launches[mode])
    ks.check_sections(ops, 4, mode)
    assert [a - b for a, b in zip(gram.gram_section.mode_launches[mode],
                                  before)] == [0, 1, 1, 1]
    args = _problem(256, 8, 2, seed=3, dtype=np.float32)
    aux2, gths, wvsl, flags, S, _ = args
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    ks.check_sections([t(aux2), [t(g) for g in gths], t(wvsl),
                       *[t(f) for f in flags]], S, mode)
    with pytest.raises(ValueError, match="no Gram mode"):
        gram.gram_section(0, *ops, 4, mode)


@pytest.mark.cuda
def test_mode_selfcheck_and_resolution_on_the_card():
    """Both self-checks pass on the card; "auto" resolves to "split" for
    Gibbs below rank 64 and for VI, to "bf16" at rank >= 64; an explicit
    mode is kept (True as "split"); a mode with float64 raises."""
    import dataclasses

    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.ops.variational import VariationalConfig
    from myfm_tpu_torch.trainer import _resolve_gram_fast_matmul

    device = _cuda()
    assert gram.gram_fast_selfcheck("split", device)
    assert gram.gram_fast_selfcheck("bf16", device)
    g = GibbsConfig()
    f32 = np.float32

    def resolved(cfg, dtype=f32, rank=None):
        return _resolve_gram_fast_matmul(cfg, dtype, device,
                                         rank).gram_fast_matmul

    assert resolved(g, rank=32) == "split"
    assert resolved(g, rank=128) == "bf16"
    assert resolved(VariationalConfig()) == "split"
    assert resolved(g, np.float64, 128) is False
    assert resolved(dataclasses.replace(g, gram_fast_matmul=True)) == "split"
    assert resolved(dataclasses.replace(g, gram_fast_matmul="bf16"),
                    rank=32) == "bf16"
    assert resolved(dataclasses.replace(g, gram_fast_matmul=False),
                    rank=128) is False
    for mode in (True, "split", "bf16"):
        with pytest.raises(ValueError, match="float32"):
            resolved(dataclasses.replace(g, gram_fast_matmul=mode),
                     np.float64)
    # the kernels refuse a reduced mode in float64 as well
    args = _problem(32, 4, 1, seed=1, dtype=np.float64)
    with pytest.raises(ValueError, match="float32"):
        _run(args, device, lambda *a: gram.fused_tile_gram_cross(
            *a, fast_matmul="split"))


@pytest.mark.cuda
def test_rank128_fit_on_card_resolves_to_bf16():
    """A small rank-128 fit on the card takes the fast path in "bf16" and
    launches kernel 1 in that mode only."""
    _cuda()
    rng = np.random.RandomState(2)
    n, n_u, n_i = 4000, 60, 40
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    y = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i] + 3.0
    from myfm_tpu_torch import RelationBlock

    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    counts = gram.fused_tile_gram_cross.mode_launches["gibbs"]
    before = dict(counts)
    fm = MyFMGibbsRegressor(rank=128, random_seed=0, device="cuda").fit(
        None, y, X_rel=blocks, n_iter=3)
    assert fm.history_.engine == "fastpath"
    assert fm.history_.gram_fast_matmul == "bf16"
    assert counts["bf16"] > before["bf16"]
    assert counts["split"] == before["split"]
    assert counts["highest"] == before["highest"]
    assert np.isfinite(fm.predict(None, blocks)).all()


# ---- the wgmma pass (squares of D >= 64 in "split" / "bf16") and the
# in-order carry walk of kernels 1-3 ----

_WGMMA_CASES = (
    [("cross", R, T, S) for R in (62, 96, 128) for T in (16, 128, 300)
     for S in (1, 2, 8)]
    + [("meta", R, 300, 8) for R in (60, 128)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("kernel,R,T,S", _WGMMA_CASES)
def test_wgmma_pass_matches_plain(kernel, R, T, S, mode):
    """Kernel 1's Gibbs layout at D = 64, 98 and 130 (and kernel 2's
    square at D = 64 and 132) runs the wgmma pass in both reduced modes:
    ragged tiles (T = 16, 300: runs cut by the pass's 128-row chunks),
    pad rows, slots out of order, against the plain version within
    MODE_TOL of scale, two launches bit-equal."""
    device = _cuda()
    ops, carry = _square_problem(kernel, R, S, seed=R * 10 + S + T, T=T)

    def t(a):
        a = torch.as_tensor(a, device=device)
        return a.float() if a.is_floating_point() else a

    ops = [[t(g) for g in o] if isinstance(o, list) else t(o) for o in ops]
    cy = t(carry)
    fn, plain = {
        "cross": (gram.fused_tile_gram_cross,
                  gram.fused_tile_gram_cross_reference),
        "meta": (gram.fused_tile_gram, gram.fused_tile_gram_reference),
    }[kernel]
    D = carry.shape[0]
    assert gram.gram_pass(mode, D, D) == "wgmma"
    before = dict(fn.pass_launches)
    out, c = fn(*ops, S, cy, fast_matmul=mode)
    again, c2 = fn(*ops, S, cy, fast_matmul=mode)
    torch.cuda.synchronize()
    assert fn.pass_launches["wgmma"] == before["wgmma"] + 2
    assert fn.pass_launches["mma"] == before["mma"]
    assert torch.equal(out, again) and torch.equal(c, c2)
    ref, ref_c = plain(*ops, S, cy, fast_matmul=mode)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= MODE_TOL * scale
    assert float((c - ref_c).abs().max()) <= MODE_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("n_cross,T,aligned", [
    (1, 128, True), (3, 128, True), (2, 300, True), (2, 128, False),
])
def test_wgmma_pass_over_any_tables(n_cross, T, aligned, mode):
    """Kernel 1's wgmma pass at rank 128 over 600 tiles with one, two or
    three gathered tables, ragged T = 300, and a table whose rows are not
    16-byte aligned (the stage loads them value by value instead of in
    16-byte packs), against the plain version within MODE_TOL of scale,
    two launches bit-equal."""
    device = _cuda()
    R, S, K = 128, 2, 600
    ops, carry = _square_problem("cross", R, S, seed=T + n_cross, T=T, K=K)
    rng = np.random.RandomState(n_cross)
    gths = (ops[1] + [rng.normal(size=(K, T, R + 2))])[:n_cross]

    def t(a):
        a = torch.as_tensor(a, device=device)
        return a.float() if a.is_floating_point() else a

    gths = [t(g) for g in gths]
    if not aligned:
        flat = torch.empty(gths[0].numel() + 1, device=device)
        gths[0] = flat[1:].view_as(gths[0]).copy_(gths[0])
        assert gths[0].data_ptr() % 16 != 0
    ops = [t(ops[0]), gths] + [t(o) for o in ops[2:]]
    cy = t(carry)
    fn = gram.fused_tile_gram_cross
    before = dict(fn.pass_launches)
    out, c = fn(*ops, S, cy, fast_matmul=mode)
    again, c2 = fn(*ops, S, cy, fast_matmul=mode)
    torch.cuda.synchronize()
    assert fn.pass_launches["wgmma"] == before["wgmma"] + 2
    assert torch.equal(out, again) and torch.equal(c, c2)
    ref, ref_c = gram.fused_tile_gram_cross_reference(*ops, S, cy,
                                                      fast_matmul=mode)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= MODE_TOL * scale
    assert float((c - ref_c).abs().max()) <= MODE_TOL * scale


@pytest.mark.cuda
def test_carry_segments_fill_the_card():
    """The carry walk's segment length (carry_seg in csrc/gram_tile.cuh,
    read back from the workspace size ceil(K / G) * E): the longest of
    128 / 64 / 32 / 16 tiles that still gives 264 blocks of (segment, 64
    entries), at most 64 where E >= 4096."""
    _cuda()
    from myfm_tpu_torch.ops import _build

    lib = gram._bind(_build.load("fused_gram_cross"))

    def seg(K, E):
        n = lib.myfm_gram_carry_scratch(K, E) // E
        return next(G for G in (16, 32, 64, 128) if -(-K // G) == n)

    assert seg(4096, 34 * 34) == 128      # rank 32, Gibbs square
    assert seg(8192, 130 * 130) == 64     # rank 128
    assert seg(400, 12 * 32) == 16        # kernel 2 at ML-100k
    assert seg(180, 12 * 12) == 16        # a small call: fewest tiles
    assert seg(2000, 12 * 32) == 32       # 63 x 6 >= 264 > 32 x 6
    assert lib.myfm_gram_carry_sync(400, 12 * 32) == 1 + 25 * 6


def _chain_flags(case, K, S, rng):
    """(cont_in, cont_out, last_slot, carry_in nonzero) of a chain case:
    "span" one entity over all K tiles, "through" an S = 1 pass-through
    chain entered with a carry, "random" any flags."""
    if case == "span":
        ci, co = np.ones(K, np.int32), np.ones(K, np.int32)
        ci[0], co[-1] = 0, 0
        return ci, co, np.zeros(K, np.int32), False
    if case == "through":
        return (np.ones(K, np.int32), np.ones(K, np.int32),
                np.zeros(K, np.int32), True)
    return (rng.randint(0, 2, K).astype(np.int32),
            rng.randint(0, 2, K).astype(np.int32),
            rng.randint(0, S, K).astype(np.int32), True)


_CARRY_CASES = [("span", 300, 1), ("through", 257, 1), ("random", 129, 3),
                ("random", 1, 2), ("random", 700, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,K,S", _CARRY_CASES)
@pytest.mark.parametrize("kernel,mode,dtype", [
    ("cross", "highest", torch.float32), ("cross", "highest", torch.float64),
    ("cross", "bf16", torch.float32), ("cross_vi", "split", torch.float32),
    ("meta", "highest", torch.float64), ("meta", "split", torch.float32),
    ("rows", "highest", torch.float32), ("rows", "highest", torch.float64),
])
def test_carry_walk_is_the_in_order_carry(kernel, mode, dtype, case, K, S):
    """Kernels 1 (Gibbs layout at R = 62, the wgmma pass in bf16; its VI
    rectangle), 2 and 3 on chains of tiles: one entity over all K tiles,
    an S = 1 pass-through chain entered with a carry, random flags, K not
    a multiple of the walk's segments (16 to 128 tiles, by K and the
    width) nor of its 64-entry slices.  Each launch equals, bit for bit, the in-order carry
    (ops/gram.carry_in_order) applied to the same kernel's partials
    without a carry, and two launches give the same bits."""
    device = _cuda()
    rng = np.random.RandomState(K + S)
    T = 16
    R = 62 if kernel == "cross" else 6
    slot = np.sort(rng.randint(0, S, (K, T)), axis=1)
    slot[:, -2:] = S
    flags = _chain_flags(case, K, S, rng)
    ci, co, ls = (torch.as_tensor(f, device=device) for f in flags[:3])
    zero = torch.zeros(K, dtype=torch.int32, device=device)

    def t(a):
        return torch.as_tensor(a, device=device, dtype=dtype)

    kw = {} if mode == "highest" else dict(fast_matmul=mode)
    if kernel in ("cross", "cross_vi"):
        ext = dict(q_lo=2, n_extra=2 * R, out_rows=2 + R) \
            if kernel == "cross_vi" else {}
        kw.update(ext)
        q_lo, n_extra = ext.get("q_lo", 1), ext.get("n_extra", 0)
        W = q_lo + R + n_extra + 1
        aux2 = t(np.stack([slot, rng.normal(size=(K, T))], axis=1))
        gths = [t(rng.normal(size=(K, T, W)) * 0.5) for _ in range(2)]
        wvsl = t(rng.normal(size=(K, S, R + 2)) * 0.5)
        D, rows = R + n_extra + 2, ext.get("out_rows", R + n_extra + 2)

        def run(a, b, c, cin):
            return gram.fused_tile_gram_cross(aux2, gths, wvsl, a, b, c, S,
                                              cin, **kw)
    elif kernel == "meta":
        meta = t(np.stack([np.ones((K, T)), rng.normal(size=(K, T)),
                           rng.random((K, T))], axis=2))
        q = t(rng.normal(size=(K, T, R + 2)))
        sl = torch.as_tensor(slot.astype(np.int32), device=device)
        wvsl = t(rng.normal(size=(K, S, R + 1)) * 0.5)
        D = rows = R + 4

        def run(a, b, c, cin):
            return gram.fused_tile_gram(meta, q, sl, wvsl, a, b, c, S, cin,
                                        **kw)
    else:
        D = rows = R + 2
        zr = t(rng.normal(size=(K, T, D)))
        sl = torch.as_tensor(slot.astype(np.int32), device=device)

        def run(a, b, c, cin):
            return gram.tile_gram(zr, sl, a, b, c, S, cin)

    cin = t(rng.normal(size=(rows, D))) if flags[3] else None
    out, c = run(ci, co, ls, cin)
    again, c2 = run(ci, co, ls, cin)
    partial, _ = run(zero, zero, ls, None)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(c, c2)
    partial = partial.view(K, S, rows, D)
    want_c = gram.carry_in_order(partial, ci, co, ls, cin)
    assert torch.equal(out, partial.view(K * S, rows, D))
    assert torch.equal(c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_section_level3_is_production_on_the_wgmma_pass(mode):
    """Kernel 5's level 3 at rank 128 (D = 130, the wgmma pass) is bit for
    bit kernel 1 in the same mode, and level 2 its carry-free pass."""
    device = _cuda()
    args = _problem(128, 2, 2, seed=5, dtype=np.float32, R=128, N=6_000,
                    B=40)
    aux2, gths, wvsl, flags, S, _ = args
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    ops = [t(aux2), [t(g) for g in gths], t(wvsl), *[t(f) for f in flags]]
    before = dict(gram.fused_tile_gram_cross.pass_launches)
    out, c = gram.fused_tile_gram_cross(*ops, S, fast_matmul=mode)
    lv3, c3 = gram.gram_section(3, *ops, S, mode)
    lv2, _ = gram.gram_section(2, *ops, S, mode)
    torch.cuda.synchronize()
    assert gram.fused_tile_gram_cross.pass_launches["wgmma"] == \
        before["wgmma"] + 1
    assert torch.equal(out, lv3) and torch.equal(c, c3)
    K = aux2.shape[0]
    zero = torch.zeros(K, dtype=torch.int32, device=device)
    part, _ = gram.fused_tile_gram_cross(ops[0], ops[1], ops[2], zero, zero,
                                         ops[5], S, fast_matmul=mode)
    assert torch.equal(part, lv2)


@pytest.mark.cuda
def test_rank128_fit_runs_the_wgmma_pass():
    """Every kernel-1 launch of a small rank-128 fit ("auto" -> "bf16")
    runs the wgmma pass."""
    _cuda()
    rng = np.random.RandomState(3)
    n, n_u, n_i = 4000, 60, 40
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    y = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i] + 3.0
    from myfm_tpu_torch import RelationBlock

    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    passes = gram.fused_tile_gram_cross.pass_launches
    before = dict(passes)
    launches = gram.fused_tile_gram_cross.launches
    fm = MyFMGibbsRegressor(rank=128, random_seed=0, device="cuda").fit(
        None, y, X_rel=blocks, n_iter=2)
    assert fm.history_.gram_fast_matmul == "bf16"
    ran = gram.fused_tile_gram_cross.launches - launches
    assert ran > 0
    assert passes["wgmma"] - before["wgmma"] == ran
    assert passes["mma"] == before["mma"]
    assert passes["fma"] == before["fma"]


@pytest.mark.cuda
def test_pass_rule_and_ring_match_the_launcher():
    """ops/gram.gram_pass and the wgmma stage's ring size are the C
    launcher's (myfm_gram_pass, myfm_gram_ring_bytes)."""
    _cuda()
    from myfm_tpu_torch.ops import _build

    lib = gram._bind(_build.load("fused_gram_cross"))
    for mode in gram.GRAM_MODES:
        m = gram.GRAM_MODES.index(mode)
        for D in (12, 34, 63, 64, 98, 130, 132, 386):
            for rows in sorted({D, 2 + (D - 2) // 3, 1}):
                assert gram.GRAM_PASSES[lib.myfm_gram_pass(m, D, rows)] == \
                    gram.gram_pass(mode, D, rows)
            if mode != "highest":
                assert lib.myfm_gram_ring_bytes(D, m) == gram._stage_bytes(
                    "wgmma", mode, 0, 0, D, 4)


def _fit_surface_design(seed=0, n=6000, n_u=70, n_i=50):
    from myfm_tpu_torch import RelationBlock

    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    y = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i] + 3.0
    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    X = sps.csr_matrix((np.ones(n), (np.arange(n), rng.randint(0, 9, n))),
                       shape=(n, 9))
    grouping = np.repeat(np.arange(3, dtype=np.int32), [9, n_u, n_i])
    return X, blocks, y, grouping


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,masked", [(16, 2, False), (64, 8, True),
                                        (512, 4, True)])
def test_plan_derivation_on_card_is_bit_equal(T, S, masked, monkeypatch):
    """On a CUDA device compile_categorical_table derives src / slot on
    the card by default; every layout tensor equals the host pack's."""
    import dataclasses

    from myfm_tpu_torch import design_categorical as tdc

    _cuda()
    rng = np.random.RandomState(T)
    N, B = 50_000, 700
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6
    ent[: N // 4] = 2
    if masked:
        ent[rng.rand(N) < 0.1] = B
    calls = []
    real = tdc._derive_src_slot_device
    monkeypatch.setattr(tdc, "_derive_src_slot_device",
                        lambda *a: calls.append(1) or real(*a))
    dev = tdc.compile_categorical_table(ent, B, 0, N, np.float32, "cuda",
                                        fixed_ts=(T, S))
    assert calls == [1]  # the card derivation is the default on CUDA
    host = tdc.compile_categorical_table(ent, B, 0, N, np.float32, "cuda",
                                         fixed_ts=(T, S),
                                         derive_src_on_device=False)
    cpu = tdc.compile_categorical_table(ent, B, 0, N, np.float32, "cpu",
                                        fixed_ts=(T, S))
    for f in dataclasses.fields(dev):
        a, b, c = (getattr(x, f.name) for x in (dev, host, cpu))
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b), f.name
            assert torch.equal(a.cpu(), c), f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.cuda
@pytest.mark.parametrize("cls_name", ["MyFMGibbsRegressor",
                                      "MyFMOrderedProbit"])
def test_drain_on_card_equals_eager(cls_name):
    """The pipelined harvest on the card (snapshots copied on a side
    stream) gives the eager harvest's samples and trace, bit for bit,
    under deterministic algorithms."""
    import myfm_tpu_torch

    _cuda()
    X, blocks, y, grouping = _fit_surface_design()
    cls = getattr(myfm_tpu_torch, cls_name)
    target = (np.digitize(y, [2.0, 3.0, 4.0]) if cls_name.endswith("Probit")
              else y)
    fits = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for callback in (None, lambda *a: (False, None)):
            fm = cls(rank=8, random_seed=3, device="cuda")
            fm.fit(X, target, X_rel=blocks, n_iter=8, n_kept_samples=5,
                   grouping=list(grouping), callback=callback)
            fits.append(fm)
    finally:
        torch.use_deterministic_algorithms(False)
    lazy, eager = fits
    assert lazy.history_.engine == "fastpath"
    # every pinned buffer went back to the host allocator
    assert myfm_tpu_torch.trainer._HostCopy.pinned_bytes == 0
    for a, b in zip(lazy.predictor_.samples, eager.predictor_.samples):
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.V, b.V)
        for ca, cb in zip(a.cutpoints, b.cutpoints):
            np.testing.assert_array_equal(ca, cb)
    for a, b in zip(lazy.history_.hypers, eager.history_.hypers):
        assert a.alpha == b.alpha
        np.testing.assert_array_equal(a.lambda_V, b.lambda_V)
    assert (lazy.history_.n_mh_accept_trace
            == eager.history_.n_mh_accept_trace)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_resume_on_card_is_bit_equal(tmp_path, ordered):
    """A chain checkpointed after 3 sweeps and resumed in a fresh trainer
    draws the uninterrupted chain's last samples, bit for bit, under
    deterministic algorithms (the CUDA generator's state is restored)."""
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    _cuda()
    X, blocks, y, grouping = _fit_surface_design(seed=1)
    plan = try_compile_categorical(X, blocks, grouping, None, np.float32,
                                   "cuda", rank=8)
    cfg = GibbsConfig(task="ordered" if ordered else "regression",
                      n_class=4 if ordered else 0)
    target = np.digitize(y, [2.0, 3.0, 4.0]) if ordered else y
    path = str(tmp_path / "chain.npz")

    def trainer():
        return CategoricalGibbsTrainer(plan, target, cfg, 8, 0.1, 11)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full, _ = trainer().run(6, 6)
        trainer().run(3, 1, checkpoint_path=path, checkpoint_every=3)
        resumed, _ = trainer().run(6, 6, checkpoint_path=path, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(resumed.samples) == 3
    for a, b in zip(full.samples[-3:], resumed.samples):
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.V, b.V)
        for ca, cb in zip(a.cutpoints, b.cutpoints):
            np.testing.assert_array_equal(ca, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((81_000,), 3), ((81_000, 32), 3),
                                     ((200_000,), 700), ((200_000, 12), 700),
                                     ((81_000, 8), 40_000)])
def test_segment_sum_repeats_on_card(shape, n):
    """ops/segsum on CUDA tensors under heavy contention (81k rows into 3
    groups, 200k into 700): the same bits on every call, and index_add_'s
    sums in float64 within float32 rounding."""
    from myfm_tpu_torch.ops import segsum

    device = _cuda()
    rng = np.random.RandomState(n)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                        device=device)
    index = torch.as_tensor(rng.randint(0, n, shape[0]), device=device)
    first = segsum.segment_sum(x, index, n)
    for _ in range(5):
        assert torch.equal(segsum.segment_sum(x, index, n), first)
    out = torch.ones((n,) + shape[1:], device=device)
    again = segsum.add_at(out, index, x)
    for _ in range(3):
        assert torch.equal(segsum.add_at(out, index, x), again)
    want = torch.zeros((n,) + shape[1:], dtype=torch.float64).index_add_(
        0, index.cpu(), x.cpu().double())
    np.testing.assert_allclose(first.cpu().double().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-3)


def _default_ops_pair(fit):
    """Two fits from one seed under default ops; every kept sample and
    the hyper trace must be the same bits."""
    assert not torch.are_deterministic_algorithms_enabled()
    a, b = fit(), fit()
    assert a.history_.engine == b.history_.engine
    for x, y in zip(a.predictor_.samples, b.predictor_.samples):
        assert x.w0 == y.w0
        np.testing.assert_array_equal(x.w, y.w)
        np.testing.assert_array_equal(x.V, y.V)
        for cx, cy in zip(x.cutpoints, y.cutpoints):
            np.testing.assert_array_equal(cx, cy)
    for x, y in zip(a.history_.hypers, b.history_.hypers):
        assert x.alpha == y.alpha
        np.testing.assert_array_equal(x.mu_w, y.mu_w)
        np.testing.assert_array_equal(x.lambda_w, y.lambda_w)
        np.testing.assert_array_equal(x.mu_V, y.mu_V)
        np.testing.assert_array_equal(x.lambda_V, y.lambda_V)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("engine,cls_name", [
    ("fastpath", "MyFMGibbsRegressor"), ("fastpath", "MyFMOrderedProbit"),
    ("colored", "MyFMGibbsRegressor"), ("joint", "MyFMGibbsRegressor"),
    ("joint", "MyFMOrderedProbit")])
def test_same_seed_fits_repeat_under_default_ops(engine, cls_name):
    """A chain on the card is a function of its seed and plan: two fits
    from one seed, default torch ops, give the same bits."""
    import myfm_tpu_torch

    _cuda()
    X, blocks, y, grouping = _fit_surface_design(seed=4)
    if engine != "fastpath":
        from . import torch_shard_cases as cases

        X, blocks, y, grouping = cases.row_design(n=3000)
    cls = getattr(myfm_tpu_torch, cls_name)
    target = (np.digitize(y, np.quantile(y, [0.25, 0.5, 0.75]))
              if cls_name.endswith("Probit") else y)
    kw = {} if engine == "fastpath" else dict(sweep_strategy=engine)

    def fit():
        return cls(rank=8, random_seed=5, device="cuda", **kw).fit(
            X, target, X_rel=blocks, n_iter=4, n_kept_samples=4,
            grouping=list(grouping))

    assert _default_ops_pair(fit).history_.engine == engine


@pytest.mark.cuda
def test_world_size_one_nccl_fit_is_the_one_process_fit(tmp_path):
    """mesh= a one-rank NCCL group on the card: the fast path's chain and
    the sharded scorer's prediction are the one-process bits."""
    import torch.distributed as dist

    from myfm_tpu_torch.parallel.collectives import Axis

    _cuda()
    X, blocks, y, grouping = _fit_surface_design(seed=6)

    def fit(mesh):
        return MyFMGibbsRegressor(rank=8, random_seed=2, device="cuda:0",
                                  mesh=mesh).fit(
            X, y, X_rel=blocks, n_iter=4, n_kept_samples=2,
            grouping=list(grouping))

    one = fit(None)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    try:
        axis = Axis(dist.group.WORLD)
        sharded = fit(axis)
        pred = sharded.predictor_.predict(X, blocks, mesh=axis)
    finally:
        dist.destroy_process_group()
    assert sharded.history_.engine == "fastpath"
    for a, b in zip(one.predictor_.samples, sharded.predictor_.samples):
        assert a.w0 == b.w0
        np.testing.assert_array_equal(a.V, b.V)
    np.testing.assert_array_equal(pred, one.predict(X, blocks))
