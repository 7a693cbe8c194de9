#!/usr/bin/env python3
"""Smoke run of the PyTorch port (myfm_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It drives the port's two paths through ``MyFMGibbsRegressor.fit`` then
``predict`` and holds every CUDA kernel of each against its plain
PyTorch version:

* the categorical fast path, on the ML-10M-shaped all-categorical design
  (one-hot date main table, one-hot user and item RelationBlocks,
  rank 32);
* the joint engine, on synthetic ML-100k (fold 0 of 10) with the
  timeSVD++-flipped features (one-hot date main table; user and item
  blocks of one-hot ids plus N-hot implicit columns), rank 10, 200
  sweeps, which "auto" resolves to the joint engine.

Phases, one line each:

  device    the card (and nvidia-smi's name / power limit)
  build     nvcc builds every kernel from csrc/ (in parallel)
  data      the synthetic design and its fast-path plan
  kernel    fused_tile_gram_cross, kernel vs plain, at each table's
            first chunk of tiles (the main path's shapes), fp32 + fp64
  sweep     one categorical_sweep through the kernel vs one through
            the plain version, same state and variates
  fit       the estimator; the kernel's launch counter must rise
  predict   held-out RMSE, below std(y_test)
  jdata     the ML-100k timeSVD++-flipped design and its joint plan:
            (B, C, Pf) of each block's tail, compile time
  jkernel   joint_tail_pass, kernel vs plain, on each block's real tail
            stack from the Gram of the initial state, fp32 + fp64
  jsweep    one gibbs_sweep with the tail kernel vs one with the plain
            tail, same state and variates, deterministic torch ops
  jfit      the estimator through "auto"; must resolve to "joint" and
            launch the tail kernel
  jpredict  held-out RMSE through row-space serving, below std(y_test)

The last line is {"ok": true, "device": {...}}, printed only when
every phase passed; any failure exits non-zero.  Without a CUDA card,
or without the package beside this file, it exits non-zero at once.
"""

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
RANK = 32
N_ITER = 6  # < 200, so "auto" keeps the fast path
N_KEPT = 3
TEST_SHARE = 0.1
# |kernel − plain| over max|plain| of each Gram chunk: the two sum up to
# ~10^4 rows per carried chain in different orders (3e-7 in fp32 and
# 1.4e-15 in fp64 measured on an H100 at these shapes)
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
# one fp32 sweep, kernel vs plain: the Gram differences above flow
# through the draws (max |Δw|, |ΔV| measured 3e-5 on O(1) weights) and
# the exact moment algebra (Σe, Σe² measured 1e-7 to 2e-6 of their
# scale: the groupwise sums of the λ/μ draws use index_add_, whose
# atomics add in a different order on every run)
SWEEP_WEIGHT_TOL = 5e-4
SWEEP_MOMENT_TOL = 1e-4

GRAM_REPLACES = "myfm_tpu/ops/pallas_gram.py:602"
GRAM_SOURCE = "myfm_tpu_torch/csrc/fused_gram_cross.cu"

J_RANK = 10
J_N_ITER = 200  # >= 200 at <= 500k rows: "auto" prefers the joint engine
J_FEATURES = "timesvdpp_flipped"
# |kernel − plain| over max|plain| of each tail's outputs (G, Atot, Ct,
# u_new) after ~1k chained colors; fp32 is loose because the Gram-
# assembled S cancels two aggregates of its own scale (ops/joint.py)
JTAIL_TOL = {"float32": 1e-3, "float64": 1e-10}
# (measured on an H100: fp32 7e-6 to 3.6e-4, fp64 2e-14 to 5e-13)
# one fp32 sweep, tail kernel vs plain tail, every other op
# deterministic: max |Δw|, |ΔV| on O(1) weights (measured 8e-6, 1.5e-5)
JSWEEP_TOL = 1e-3
TAIL_REPLACES = "myfm_tpu/ops/pallas_joint_tail.py:368"
TAIL_SOURCE = "myfm_tpu_torch/csrc/joint_tail.cu"


def fail(message):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, message):
    print(f"[{phase}] {message}", flush=True)


def ptxas_summary(log):
    """'kernel<type[, flag]>: N regs' per entry function of an nvcc
    -Xptxas -v log, plus any line that reports spills."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '.*?\d([a-z_]+_kernel)I([fd])"
                      r"(?:Lb([01])E)?E", line)
        if m:
            dtype = "float" if m.group(2) == "f" else "double"
            flag = "" if m.group(3) is None else f", {m.group(3)}"
            name = f"{m.group(1)}<{dtype}{flag}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs")
            name = None
        if "spill" in line and " 0 bytes spill stores" not in line:
            out.append(line.strip())
    return out


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_design(seed):
    import scipy.sparse as sps

    from myfm_tpu_torch import RelationBlock
    from myfm_tpu_torch.utils.benchmark_data import (
        SyntheticMovieLensManager,
    )

    man = SyntheticMovieLensManager("10m", rank=8, random_seed=seed)
    data = man.load_rating_all()
    users = data["user_id"] - 1
    items = data["movie_id"] - 1
    days = data["day"]
    y = data["rating"]
    n = y.shape[0]
    n_users, n_items = man.n_users, man.n_items
    n_days = int(days.max()) + 1
    eye_u = sps.identity(n_users, format="csr")
    eye_i = sps.identity(n_items, format="csr")
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(n * TEST_SHARE)

    def design(rows):
        X = sps.csr_matrix(
            (np.ones(rows.size), (np.arange(rows.size), days[rows])),
            shape=(rows.size, n_days),
        )
        blocks = [RelationBlock(users[rows], eye_u),
                  RelationBlock(items[rows], eye_i)]
        return X, blocks, y[rows]

    grouping = [0] * n_days + [1] * n_users + [2] * n_items
    shape = dict(rows=n, users=n_users, items=n_items, days=n_days)
    return design(perm[n_test:]), design(perm[:n_test]), grouping, shape


def kernel_phase(torch, plan, state, y_tiles):
    """Kernel vs plain at each table's first chunk of tiles."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.ops.categorical import (
        eff_tables,
        table_gram_operands,
    )

    w, V = state.core.w, state.core.V
    eff = eff_tables(plan, w, V)
    rows = []
    for ti, t in enumerate(plan.tables):
        V_t = V[t.col_offset : t.col_offset + t.n_cols]
        own = torch.cat(
            [w[t.col_offset : t.col_offset + t.n_cols, None], V_t,
             (V_t * V_t).sum(1, keepdim=True)], dim=1,
        )
        ops = next(table_gram_operands(plan, ti, w, V, eff, own,
                                       y_tiles[ti]))
        S = t.tile_entities
        row = dict(table=ti, K=ops[0].shape[0], T=t.tile_rows, S=S,
                   n_cross=len(ops[1]))
        for dtype in (torch.float32, torch.float64):
            o = [ops[0].to(dtype), [g.to(dtype) for g in ops[1]],
                 ops[2].to(dtype), *ops[3:]]
            out, carry = gram.fused_tile_gram_cross(*o, S)
            ref, ref_carry = gram.fused_tile_gram_cross_reference(*o, S)
            torch.cuda.synchronize()
            err = max(float((out - ref).abs().max()),
                      float((carry - ref_carry).abs().max()))
            scale = max(float(ref.abs().max()), 1.0)
            name = str(dtype).split(".")[1]
            row[f"err_{name}"] = err
            row[f"rel_{name}"] = err / scale
            if not np.isfinite(err) or err > KERNEL_TOL[name] * scale:
                fail(f"kernel vs plain, table {ti} {name}: max abs err "
                     f"{err:.3e} > {KERNEL_TOL[name]:.0e} x {scale:.3e}")
            if dtype == torch.float32:
                row["ms"] = cuda_ms(
                    torch, lambda: gram.fused_tile_gram_cross(*o, S), 10
                )
                row["plain_ms"] = cuda_ms(
                    torch,
                    lambda: gram.fused_tile_gram_cross_reference(*o, S),
                    3,
                )
        rows.append(row)
    return rows


def sweep_phase(torch, plan, trainer, state):
    """One sweep through the kernel vs one through the plain version."""
    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )

    v = draw_sweep_variates(plan, trainer.cfg, RANK, trainer.generator,
                            torch.float32, trainer.device)
    args = (plan, state, trainer.y, trainer.y_tiles, v, trainer.cfg)
    t0 = time.perf_counter()
    a = categorical_sweep(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b = categorical_sweep(*args, plain=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = dict(kernel_s=t1 - t0, plain_s=t2 - t1)
    for f in ("w", "V"):
        x, z = getattr(a.core, f), getattr(b.core, f)
        if not bool(torch.isfinite(x).all()):
            fail(f"sweep: non-finite {f}")
        res[f"d{f}"] = float((x - z).abs().max())
        if res[f"d{f}"] > SWEEP_WEIGHT_TOL:
            fail(f"sweep: max |Δ{f}| {res[f'd{f}']:.3e} > "
                 f"{SWEEP_WEIGHT_TOL:.0e}")
    n = plan.n_rows
    e2 = float(b.sum_e2)
    res["dsum_e"] = abs(float(a.sum_e) - float(b.sum_e))
    res["dsum_e2"] = abs(float(a.sum_e2) - e2)
    if res["dsum_e"] > SWEEP_MOMENT_TOL * (n * e2) ** 0.5:
        fail(f"sweep: |Δ sum_e| {res['dsum_e']:.3e} over scale "
             f"{(n * e2) ** 0.5:.3e}")
    if res["dsum_e2"] > SWEEP_MOMENT_TOL * e2:
        fail(f"sweep: |Δ sum_e2| {res['dsum_e2']:.3e} over {e2:.3e}")
    return res


def build_joint_design():
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    train, test = load_synthetic_movielens("100k", 0)
    X_tr, X_te, b_tr, b_te, grouping = build_feature_blocks(
        train, test, J_FEATURES
    )
    return (X_tr, b_tr, train["rating"]), (X_te, b_te, test["rating"]), \
        grouping


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic torch ops (index_add_ without atomics), so a
    comparison's inputs are the same bits on every run."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def jkernel_phase(torch, plan, trainer, state):
    """joint_tail_pass kernel vs plain on each block's real tail (the
    caller runs it under ``deterministic``, so its inputs are the same
    bits on every run)."""
    from myfm_tpu_torch.ops.forward import factor_q
    from myfm_tpu_torch.ops.gibbs import draw_gibbs_variates, draw_hypers
    from myfm_tpu_torch.ops.joint import (
        build_block_gram,
        dense_tail_operands,
    )
    from myfm_tpu_torch.ops.joint_tail import (
        joint_tail_pass,
        joint_tail_pass_reference,
    )

    # the initial state's hyperparameters drawn as a sweep draws them
    v = draw_gibbs_variates(plan, trainer.cfg, J_RANK, trainer.generator,
                            torch.float32, trainer.device)
    h = draw_hypers(plan, state, v, trainer.cfg)
    U = torch.cat([h.w[:, None], h.V], dim=1)
    lam = torch.cat([h.lambda_w[:, None], h.lambda_V], dim=1)
    mu = torch.cat([h.mu_w[:, None], h.mu_V], dim=1)
    q = factor_q(plan, h.V)
    D = J_RANK + 2
    rows = []
    for bi, b in enumerate(plan.blocks):
        ds = b.dense_stack
        if ds is None:
            continue
        C, B = ds.xw.shape
        G = build_block_gram(b, h.e, q, flat=True).T.contiguous()
        ops32 = [G, G.new_zeros((J_RANK, B)), G.new_zeros((B,)), ds.xw,
                 ds.segb, *dense_tail_operands(b, U, lam, mu, v.noise,
                                               plan.group_index)]
        row = dict(block=bi, C=C, B=B, Pf=int(ds.feat.shape[1]))
        for dtype in (torch.float32, torch.float64):
            o = [t if t.dtype == torch.int32 else t.to(dtype)
                 for t in ops32]
            alpha = h.alpha.to(dtype)
            out = joint_tail_pass(*o, alpha, D)
            ref = joint_tail_pass_reference(*o, alpha, D)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            err, rel = 0.0, 0.0
            for a, r in zip(out, ref):
                if not bool(torch.isfinite(a).all()):
                    fail(f"jkernel block {bi} {name}: non-finite output")
                e_abs = float((a - r).abs().max())
                err = max(err, e_abs)
                rel = max(rel, e_abs / max(float(r.abs().max()), 1.0))
            row[f"err_{name}"] = err
            row[f"rel_{name}"] = rel
            if not rel <= JTAIL_TOL[name]:
                fail(f"jkernel block {bi} {name}: max err {rel:.3e} of "
                     f"scale > {JTAIL_TOL[name]:.0e}")
            if dtype == torch.float32:
                row["ms"] = cuda_ms(
                    torch, lambda: joint_tail_pass(*o, alpha, D), 5
                )
                row["plain_ms"] = cuda_ms(
                    torch, lambda: joint_tail_pass_reference(*o, alpha, D),
                    1,
                )
        rows.append(row)
    if not rows:
        fail("jkernel: no block of the plan has a tail stack")
    return rows


def jsweep_phase(torch, plan, trainer, state):
    """One sweep with the tail kernel vs one with the plain tail, from
    the same state and variates; every other op runs deterministically,
    so the difference is the tail's alone."""
    import dataclasses

    from myfm_tpu_torch.ops.gibbs import draw_gibbs_variates, gibbs_sweep

    v = draw_gibbs_variates(plan, trainer.cfg, J_RANK, trainer.generator,
                            torch.float32, trainer.device)
    res = {}
    outs = []
    with deterministic(torch):
        for tail in (True, True, False):
            cfg = dataclasses.replace(trainer.cfg, joint_tail_kernel=tail)
            t0 = time.perf_counter()
            outs.append(gibbs_sweep(plan, state, trainer.y, v, cfg))
            torch.cuda.synchronize()
            res["plain_s" if not tail else "kernel_s"] = (
                time.perf_counter() - t0
            )
    a, a2, b = outs
    for f in ("w", "V"):
        x, x2, z = getattr(a, f), getattr(a2, f), getattr(b, f)
        if not (bool(torch.isfinite(x).all())
                and bool(torch.isfinite(z).all())):
            fail(f"jsweep: non-finite {f}")
        res[f"d{f}"] = float((x - z).abs().max())
        res[f"rerun_d{f}"] = float((x - x2).abs().max())
        if res[f"d{f}"] > JSWEEP_TOL:
            fail(f"jsweep: max |Δ{f}| {res[f'd{f}']:.3e} > {JSWEEP_TOL:.0e}")
    return res


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        import myfm_tpu_torch  # noqa: F401 — the package beside this file
        from myfm_tpu_torch.ops import _build, gram, joint_tail
    except ImportError as exc:
        fail(f"the myfm_tpu_torch package is missing: {exc}")
    t_start = time.perf_counter()
    # the plain versions are the reference: full fp32 matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind} | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | count "
                  f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = [item for log in logs.values() for item in ptxas_summary(log)]
    say("build", f"{len(logs)} kernel source(s) built in "
                 f"{time.perf_counter() - t0:.1f} s; " + ", ".join(ptxas))

    from myfm_tpu_torch import MyFMGibbsRegressor
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    t0 = time.perf_counter()
    (X_tr, blocks_tr, y_tr), (X_te, blocks_te, y_te), grouping, shape = (
        build_design(SEED)
    )
    plan = try_compile_categorical(
        X_tr, blocks_tr, np.asarray(grouping, np.int32), None, np.float32,
        "cuda", rank=RANK,
    )
    if plan is None:
        fail("the design did not compile to the fast path")
    tiling = [(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
              for t in plan.tables]
    say("data", f"{shape} train {y_tr.size} test {y_te.size}; plan "
                f"(B, K, T, S) per table {tiling} in "
                f"{time.perf_counter() - t0:.1f} s")

    trainer = CategoricalGibbsTrainer(
        plan, y_tr, GibbsConfig(task="regression"), RANK, 0.1, SEED,
    )
    state = trainer._initialize()
    krows = kernel_phase(torch, plan, state, trainer.y_tiles)
    for r in krows:
        say("kernel", json.dumps(r))
    res = sweep_phase(torch, plan, trainer, state)
    say("sweep", json.dumps(res))
    del plan, trainer, state
    torch.cuda.empty_cache()

    stamps = []

    def timer(i, fm, hyper, history):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return False, None

    torch.cuda.reset_peak_memory_stats()
    gram.fused_tile_gram_cross.launches = 0
    t_fit = time.perf_counter()
    fm = MyFMGibbsRegressor(rank=RANK, random_seed=SEED, device="cuda").fit(
        X_tr, y_tr, X_rel=blocks_tr, n_iter=N_ITER, n_kept_samples=N_KEPT,
        grouping=grouping, callback=timer,
    )
    pred = fm.predict(X_te, blocks_te)
    torch.cuda.synchronize()
    launches = gram.fused_tile_gram_cross.launches
    peak = torch.cuda.max_memory_allocated()
    if fm.history_.engine != "fastpath":
        fail(f"fit resolved to {fm.history_.engine!r}, not the fast path")
    if launches <= 0:
        fail("the main path never launched fused_tile_gram_cross")
    ttfs = stamps[0] - t_fit
    sweeps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    say("fit", f"engine {fm.history_.engine}, {len(stamps)} sweeps, "
               f"time to first sweep {ttfs:.2f} s, {sweeps_per_s:.3f} "
               f"sweeps/s, kernel launches {launches}, peak device "
               f"memory {peak / 2**30:.2f} GiB")

    rmse = float(np.sqrt(np.mean((pred - y_te) ** 2)))
    std = float(y_te.std())
    if not (pred.shape == y_te.shape and np.isfinite(pred).all()
            and rmse < std):
        fail(f"predict: rmse {rmse} vs std(y_test) {std}")
    say("predict", f"{y_te.size} held-out rows, RMSE {rmse:.4f} < "
                   f"std(y_test) {std:.4f}; so far "
                   f"{time.perf_counter() - t_start:.1f} s")

    # ---- the joint engine: ML-100k timeSVD++-flipped, rank 10 ----
    del fm
    torch.cuda.empty_cache()
    from myfm_tpu_torch.design import compile_design, joint_auto_eligible
    from myfm_tpu_torch.trainer import GibbsTrainer

    t0 = time.perf_counter()
    (jX_tr, jb_tr, jy_tr), (jX_te, jb_te, jy_te), jgroup = (
        build_joint_design()
    )
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    jplan = compile_design(
        jX_tr, jb_tr, grouping=np.asarray(jgroup, np.int32),
        dtype=np.float32, joint_dense=True, joint_rank=J_RANK,
        device="cuda",
    )
    t_plan = time.perf_counter() - t0
    if not joint_auto_eligible(jplan, J_RANK, np.float32):
        fail("the ML-100k plan is not eligible for the joint engine")
    tails = [
        None if b.dense_stack is None else
        (b.block_size, *b.dense_stack.xw.shape[:1],
         int(b.dense_stack.feat.shape[1]))
        for b in jplan.blocks
    ]
    heads = [len(b.dense_colors) for b in jplan.blocks]
    say("jdata", f"train {jy_tr.size} test {jy_te.size}, features "
                 f"{jplan.n_features}, groups {jplan.n_groups}; (B, C, Pf) "
                 f"of each block's tail {tails}, head colors {heads}; "
                 f"features {t_feat:.1f} s, plan {t_plan:.1f} s")

    jtrainer = GibbsTrainer(
        jplan, jy_tr, GibbsConfig(task="regression", joint_rows=True),
        J_RANK, 0.1, SEED,
    )
    if jtrainer.cfg.joint_tail_kernel is not True:
        fail("the joint trainer did not resolve to the tail kernel")
    with deterministic(torch):
        jstate = jtrainer._initialize()
        jrows = jkernel_phase(torch, jplan, jtrainer, jstate)
    for r in jrows:
        say("jkernel", json.dumps(r))
    say("jsweep", json.dumps(jsweep_phase(torch, jplan, jtrainer, jstate)))
    del jplan, jtrainer, jstate
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    joint_tail.joint_tail_pass.launches = 0
    t_fit = time.perf_counter()
    jfm = MyFMGibbsRegressor(
        rank=J_RANK, random_seed=SEED, device="cuda"
    ).fit(jX_tr, jy_tr, X_rel=jb_tr, n_iter=J_N_ITER, grouping=jgroup,
          callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    jlaunches = joint_tail.joint_tail_pass.launches
    jpeak = torch.cuda.max_memory_allocated()
    if jfm.history_.engine != "joint":
        fail(f"joint fit resolved to {jfm.history_.engine!r}, not 'joint'")
    if jlaunches <= 0:
        fail("the joint path never launched joint_tail_pass")
    ttfs = stamps[0] - t_fit
    sweeps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    say("jfit", f"engine {jfm.history_.engine}, {len(stamps)} sweeps, "
                f"time to first sweep {ttfs:.2f} s, {sweeps_per_s:.3f} "
                f"sweeps/s, fit {t_fit_end - t_fit:.1f} s, tail kernel "
                f"launches {jlaunches}, peak device memory "
                f"{jpeak / 2**30:.3f} GiB")

    t0 = time.perf_counter()
    jpred = jfm.predict(jX_te, jb_te)
    t_pred = time.perf_counter() - t0
    jrmse = float(np.sqrt(np.mean((jpred - jy_te) ** 2)))
    jstd = float(jy_te.std())
    if not (jpred.shape == jy_te.shape and np.isfinite(jpred).all()
            and jrmse < jstd):
        fail(f"jpredict: rmse {jrmse} vs std(y_test) {jstd}")
    say("jpredict", f"{jy_te.size} held-out rows, {len(jfm.predictor_.samples)}"
                    f" samples in {t_pred:.2f} s, RMSE {jrmse:.4f} < "
                    f"std(y_test) {jstd:.4f}; whole run "
                    f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "fused_tile_gram_cross",
        "route": "cuda",
        "source": GRAM_SOURCE,
        "replaces": GRAM_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["err_float32"] for r in krows),
        "ms": sum(r["ms"] for r in krows),
        "plain_ms": sum(r["plain_ms"] for r in krows),
    }, {
        "name": "joint_tail_pass",
        "route": "cuda",
        "source": TAIL_SOURCE,
        "replaces": TAIL_REPLACES,
        "launches": jlaunches,
        "max_abs_err": max(r["err_float32"] for r in jrows),
        "ms": sum(r["ms"] for r in jrows),
        "plain_ms": sum(r["plain_ms"] for r in jrows),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
