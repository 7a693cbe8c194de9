"""Sharded fits on one CUDA card, against the one-process fits.

Two phases, each a dict of readings (``chip_smoke.py`` prints them as
its ``shard1`` and ``shard2`` lines):

  shard1  world size 1 over NCCL on cuda:0 (a ``FileStore`` rendezvous):
          ``MyFMGibbsRegressor(rank=32, mesh=<group>)`` on the synthetic
          ML-10M design, then ``predict`` through the sharded scorer;
          every kept sample, the hyper trace and the prediction must be
          the bits of the one-process fit from the same seed (the same
          plan, and an all-reduce over one rank returns its operand).
  shard2  world size 2: two spawned processes on cuda:0 over gloo, on
          the ML-100k timeSVD++-flipped design in float64 — the
          entity+attribute fast path (regression; kernels 1 and 4), the
          joint engine (ordered probit; kernel 4) and the VI fast path
          (kernel 1's VI layout and kernel 2).  Each rank's fit is held
          against the one-process fit from the same seed at rtol 1e-8 /
          atol 1e-10 (float64: the ranks sum the statistics in another
          order), the replicated state must be the same bits on both
          ranks, and each rank reports its kernels' launches and the
          collectives' calls, bytes and seconds (gloo on the rank's CUDA
          tensors).

  shardn  world size N over NCCL, one process per card (N = the cards
          visible, four on a four-card machine): the ML-10M fast
          path at rank 32 in float64, held against one process at rtol
          1e-8 / atol 1e-10, and in float32, whose distance from one
          process and rate beside one process's are reported; replicas
          bit-equal, kernel 1 launched on every rank; a chain
          checkpointed by rank 0 and resumed by every rank bit-equal to
          the uninterrupted one.  Not in the smoke, which needs one card.

A rank that fails or hangs fails the phase.

    python -m myfm_tpu_torch.tools.sharded [--phases shard1,shard2,shardn]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Sequence

import numpy as np
import torch

SEED = 0
RANK_10M = 32
N_ITER_10M = 6
N_KEPT_10M = 3
RANK_100K = 10
SHARD2_ITER = {"ea": 4, "joint": 4, "vi": 2}
SHARDN_ITER = 6
RTOL, ATOL = 1e-8, 1e-10
RANK_TIMEOUT_S = 600.0


class PhaseError(RuntimeError):
    """A sharded phase failed its check."""


def _counts():
    """Every kernel launch counter of the sharded paths."""
    from ..ops import gram, joint_tail

    return dict(
        gram_gibbs=gram.fused_tile_gram_cross.launches,
        gram_vi=gram.fused_tile_gram_cross.vi_launches,
        gram_meta=gram.fused_tile_gram.launches,
        joint_tail=joint_tail.joint_tail_pass.launches,
    )


def _delta(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after}


def _samples(fm):
    out = [("w0", np.array([s.w0 for s in fm.predictor_.samples])),
           ("w", np.stack([s.w for s in fm.predictor_.samples])),
           ("V", np.stack([s.V for s in fm.predictor_.samples]))]
    if fm.predictor_.samples[0].cutpoints:
        out.append(("cutpoints", np.stack(
            [np.concatenate(s.cutpoints) for s in fm.predictor_.samples])))
    for k in ("alpha", "mu_w", "lambda_w", "mu_V", "lambda_V"):
        out.append((k, np.stack([np.asarray(getattr(h, k), np.float64)
                                 for h in fm.history_.hypers])))
    return dict(out)


def _vi_out(fm):
    return dict(w0=np.array(fm.w0_mean), w=fm.w_mean, V=fm.V_mean,
                w_var=fm.w_var, V_var=fm.V_var,
                elbo=np.asarray(fm.history_.elbos))


def _diff(a, b):
    """(bit-equal, largest |a − b|, largest relative excess over
    rtol/atol) of two dicts of arrays."""
    equal, worst, excess = True, 0.0, 0.0
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape:
            raise PhaseError(f"{k}: shapes {x.shape} and {y.shape}")
        equal = equal and np.array_equal(x, y)
        if x.size:
            d = np.abs(x - y)
            worst = max(worst, float(d.max()))
            excess = max(excess, float((d / (ATOL + RTOL * np.abs(y))).max()))
    return equal, worst, excess


def _rendezvous(tag: str) -> str:
    from ..ops._build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"{tag}-", dir=BUILD_DIR)
    return d


def shard1(train, test, grouping, reference, device="cuda:0"):
    """World size 1 over NCCL; ``reference`` is (samples, prediction) of
    the one-process fit: ``_samples(fm)`` and ``fm.predict(test)``."""
    import torch.distributed as dist

    from .. import MyFMGibbsRegressor
    from ..ops import gram
    from ..parallel.collectives import Axis

    (X, blocks, y), (X_te, b_te, y_te) = train, test
    d = _rendezvous("shard1")
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{d}/store",
                            world_size=1, rank=0, device_id=dev)
    try:
        axis = Axis(dist.group.WORLD)
        stamps = []

        def timer(i, fm, hyper, history):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return False, None

        before = _counts()
        modes0 = dict(gram.fused_tile_gram_cross.mode_launches["gibbs"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fm = MyFMGibbsRegressor(rank=RANK_10M, random_seed=SEED,
                                device=device, mesh=axis).fit(
            X, y, X_rel=blocks, n_iter=N_ITER_10M,
            n_kept_samples=N_KEPT_10M, grouping=grouping, callback=timer)
        torch.cuda.synchronize()
        launches = _delta(before)
        modes = {k: v - modes0.get(k, 0) for k, v in
                 gram.fused_tile_gram_cross.mode_launches["gibbs"].items()}
        t1 = time.perf_counter()
        pred = fm.predictor_.predict(X_te, b_te, mesh=axis)
        predict_s = time.perf_counter() - t1
        ref_samples, ref_pred = reference
        equal, worst, _ = _diff(_samples(fm), ref_samples)
        p_equal = np.array_equal(pred, ref_pred)
        line = dict(
            world_size=1, backend=axis.backend, engine=fm.history_.engine,
            gram_mode=fm.history_.gram_fast_matmul, sweeps=len(stamps),
            time_to_first_sweep_s=stamps[0] - t0,
            sweeps_per_s=(len(stamps) - 1) / (stamps[-1] - stamps[0]),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            kernel_launches=launches, gram_launches_by_mode=modes,
            collective_calls=dict(axis.calls),
            collective_bytes=dict(axis.bytes), predict_s=predict_s,
            bit_equal=equal, max_abs_diff=worst, predict_bit_equal=p_equal,
            tolerance="bit-equal")
        if fm.history_.engine != "fastpath":
            raise PhaseError(f"shard1 resolved to {fm.history_.engine!r}")
        if launches["gram_gibbs"] < N_ITER_10M:
            raise PhaseError(f"shard1: kernel 1 launched "
                             f"{launches['gram_gibbs']} times in "
                             f"{N_ITER_10M} sweeps")
        if not (equal and p_equal):
            raise PhaseError(f"shard1: not the one-process chain ({line})")
        # the collectives alone, one sweep timed
        axis.timed = True
        axis.seconds.clear()
        MyFMGibbsRegressor(rank=RANK_10M, random_seed=SEED, device=device,
                           mesh=axis).fit(X, y, X_rel=blocks, n_iter=1,
                                          grouping=grouping)
        line["collective_s_one_timed_sweep"] = dict(axis.seconds)
        return line
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def design_100k():
    """(X, blocks, y, grouping) of the ML-100k timeSVD++-flipped design."""
    from ..utils.ml_features import (build_feature_blocks,
                                     load_synthetic_movielens)

    train, test = load_synthetic_movielens("100k", 0)
    X, _, blocks, _, grouping = build_feature_blocks(
        train, test, "timesvdpp_flipped")
    return X, blocks, np.asarray(train["rating"]), grouping


def shard2_fits(mesh, device, design=design_100k, sweeps=SHARD2_ITER):
    """The three float64 fits of shard2 on ``mesh`` (None: one
    process); per fit its outputs, engine and kernel launches."""
    from .. import (MyFMGibbsRegressor, MyFMOrderedProbit,
                    VariationalFMRegressor)

    X, blocks, y, grouping = design()
    yo = (y - 1).astype(np.int64)
    kw = dict(rank=RANK_100K, random_seed=SEED, dtype=np.float64,
              device=device, mesh=mesh)
    fits = (
        ("ea", lambda: MyFMGibbsRegressor(**kw).fit(
            X, y, X_rel=blocks, n_iter=sweeps["ea"],
            n_kept_samples=sweeps["ea"], grouping=grouping), _samples),
        ("joint", lambda: MyFMOrderedProbit(
            sweep_strategy="joint", **kw).fit(
            X, yo, X_rel=blocks, n_iter=sweeps["joint"],
            n_kept_samples=sweeps["joint"], grouping=grouping), _samples),
        ("vi", lambda: VariationalFMRegressor(**kw).fit(
            X, y, X_rel=blocks, n_iter=sweeps["vi"], grouping=grouping),
         _vi_out),
    )
    out = {}
    for name, fit, read in fits:
        before = _counts()
        t0 = time.perf_counter()
        fm = fit()
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()
        out[name] = dict(values=read(fm), engine=fm.history_.engine,
                         fit_s=time.perf_counter() - t0,
                         launches=_delta(before))
    return out


def _shard2_rank(rank, world, store, out_dir, device, design):
    import torch.distributed as dist

    from ..parallel.collectives import Axis, replicas_equal

    result, error = None, None
    try:
        if not str(device).startswith("cuda"):
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        axis = Axis(None)
        fits = shard2_fits(axis, device, design)
        for f in fits.values():
            f["replicated_bit_equal"] = replicas_equal(axis, [
                torch.as_tensor(np.ascontiguousarray(v)).reshape(-1)
                for v in f["values"].values()])
        result = dict(fits=fits, collective_calls=dict(axis.calls),
                      collective_bytes=dict(axis.bytes))
        # one EA sweep with the collectives timed
        axis.timed = True
        from .. import MyFMGibbsRegressor

        X, blocks, y, grouping = design()
        MyFMGibbsRegressor(rank=RANK_100K, random_seed=SEED,
                           dtype=np.float64, device=device, mesh=axis).fit(
            X, y, X_rel=blocks, n_iter=1, grouping=grouping)
        result["collective_s_one_timed_ea_sweep"] = dict(axis.seconds)
    except Exception:  # reported to the parent, which fails the phase
        error = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((result, error), f)
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world, target, args, timeout=RANK_TIMEOUT_S, tag="shard"):
    """Each rank's result of ``target(rank, world, store, out_dir,
    *args)`` from ``world`` spawned ranks (a ``FileStore`` rendezvous
    under the build directory); a rank that fails or hangs raises
    PhaseError."""
    import torch.multiprocessing as mp

    d = _rendezvous(tag)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, f"{d}/store", d) + tuple(args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung:
            raise PhaseError(
                f"{tag}: {len(hung)} rank(s) hung past {timeout} s")
        out = []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise PhaseError(f"{tag}: rank {r} exited with "
                                 f"{p.exitcode} and no result")
            with open(path, "rb") as f:
                result, error = pickle.load(f)
            if error:
                raise PhaseError(f"{tag}: rank {r} failed:\n{error}")
            out.append(result)
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# the kernels each shard2 fit must launch on every rank
SHARD2_NEEDS = {"ea": ("gram_gibbs", "joint_tail"), "joint": ("joint_tail",),
                "vi": ("gram_vi", "gram_meta")}


def shard2(device="cuda:0", design=design_100k, world=2):
    """World size 2 over gloo, two processes on ``device``; the readings
    (module docstring)."""
    if str(device).startswith("cuda"):
        from ..ops import _build

        _build.build_all()  # once here, not in each rank
    t0 = time.perf_counter()
    ranks = run_ranks(world, _shard2_rank, (device, design), tag="shard2")
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = shard2_fits(None, device, design)
    line = dict(world_size=world, backend="gloo", device=str(device),
                ranks_s=ranks_s, one_process_s=time.perf_counter() - t0,
                tolerance=dict(rtol=RTOL, atol=ATOL), fits={})
    for name, want in ref.items():
        row = dict(engine=want["engine"], one_process_fit_s=want["fit_s"],
                   one_process_launches=want["launches"], ranks=[])
        for r, rank in enumerate(ranks):
            got = rank["fits"][name]
            equal, worst, excess = _diff(got["values"], want["values"])
            row["ranks"].append(dict(
                rank=r, engine=got["engine"], fit_s=got["fit_s"],
                launches=got["launches"], bit_equal=equal,
                max_abs_diff=worst, max_err_over_tolerance=excess,
                replicated_bit_equal=got["replicated_bit_equal"]))
            if got["engine"] != want["engine"]:
                raise PhaseError(f"shard2 {name}: rank {r} resolved to "
                                 f"{got['engine']!r}, one process to "
                                 f"{want['engine']!r}")
            if excess > 1.0:
                raise PhaseError(f"shard2 {name}: rank {r} differs from the "
                                 f"one-process fit by {worst:.3e}")
            if not got["replicated_bit_equal"]:
                raise PhaseError(f"shard2 {name}: the ranks' replicated "
                                 "state differs")
            missing = [k for k in SHARD2_NEEDS[name]
                       if got["launches"][k] <= 0]
            if str(device).startswith("cuda") and missing:
                raise PhaseError(f"shard2 {name}: rank {r} never launched "
                                 f"{missing}")
        line["fits"][name] = row
    for key in ("collective_calls", "collective_bytes",
                "collective_s_one_timed_ea_sweep"):
        line[key] = [rank[key] for rank in ranks]
    return line


def _timer(stamps, cuda):
    def callback(i, fm, hyper, history):
        if cuda:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return False, None
    return callback


def shardn_fit(mesh, device, dtype, design, stamps=None):
    """The fast path's regression fit of ``shardn`` (rank 32,
    SHARDN_ITER sweeps) on ``mesh`` (None: one process)."""
    from .. import MyFMGibbsRegressor

    X, blocks, y, grouping = design()
    return MyFMGibbsRegressor(
        rank=RANK_10M, random_seed=SEED, dtype=dtype, device=device,
        mesh=mesh).fit(
        X, y, X_rel=blocks, n_iter=SHARDN_ITER, n_kept_samples=N_KEPT_10M,
        grouping=grouping,
        callback=None if stamps is None else _timer(
            stamps, str(device).startswith("cuda")))


def _rates(stamps, t0):
    return dict(time_to_first_sweep_s=stamps[0] - t0,
                sweeps_per_s=(len(stamps) - 1) / (stamps[-1] - stamps[0]))


def _shardn_rank(rank, world, store, out_dir, backend, design):
    """One rank of ``shardn``: the float64 and the float32 fit on its own
    card (``device="cuda"`` and ``LOCAL_RANK``, as under torchrun)."""
    import torch.distributed as dist

    from ..parallel.collectives import Axis, replicas_equal

    result, error = None, None
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        cuda = backend == "nccl"
        if cuda:
            torch.cuda.set_device(rank)  # as a torchrun script does
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        kw = {"device_id": torch.device("cuda", rank)} if cuda else {}
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank, **kw)
        axis = Axis(None)
        device = "cuda" if cuda else "cpu"
        result = {}
        for dtype in (np.float64, np.float32):
            stamps, before = [], _counts()
            t0 = time.perf_counter()
            fm = shardn_fit(axis, device, dtype, design, stamps)
            values = _samples(fm)
            result[np.dtype(dtype).name] = dict(
                values=values, engine=fm.history_.engine,
                launches=_delta(before), **_rates(stamps, t0),
                replicated_bit_equal=replicas_equal(axis, [
                    torch.as_tensor(np.ascontiguousarray(v)).reshape(-1)
                    for v in values.values()]))
        result.update(collective_calls=dict(axis.calls),
                      collective_bytes=dict(axis.bytes))
        result["resume_bit_equal"] = _resume_check(
            axis, device, design, os.path.join(out_dir, "chain.npz"))
        axis.timed = True
        axis.seconds.clear()
        shardn_fit(axis, device, np.float32, design)
        result["collective_s_timed_fit"] = dict(axis.seconds)
    except Exception:  # reported to the parent, which fails the phase
        error = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((result, error), f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _resume_check(axis, device, design, path):
    """A sharded chain of 4 sweeps against 2 checkpointed (rank 0
    writes) and resumed to 4 by every rank: the last 2 samples' bits."""
    from ..ops.gibbs import GibbsConfig
    from ..parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )

    X, blocks, y, grouping = design()

    def trainer():
        return ShardedCategoricalGibbsTrainer(
            X, blocks, y, GibbsConfig(task="regression"), RANK_10M, 0.1,
            SEED, mesh=axis, grouping=np.asarray(grouping, np.int32),
            device=device)

    full, _ = trainer().run(4, 2)
    trainer().run(2, 1, checkpoint_path=path, checkpoint_every=2)
    resumed, _ = trainer().run(4, 2, checkpoint_path=path, resume=True)
    return all(np.array_equal(a.V, b.V) and np.array_equal(a.w, b.w)
               for a, b in zip(full.samples, resumed.samples))


def shardn(world=None, backend="nccl", design=None):
    """World size N over NCCL, one process per card (N = the cards
    visible): the ML-10M fast path in float64, held against one process
    at rtol 1e-8 / atol 1e-10, and in float32 (its distance from one
    process reported, its rate beside one process's); replicas
    bit-equal; kernel 1 launched on every rank."""
    from .harvest import design as design_10m

    design = design or design_10m
    cuda = backend == "nccl"
    world = world or torch.cuda.device_count()
    if world < 2:
        raise PhaseError(f"shardn: {world} card(s); it needs two or more")
    device = "cuda:0" if cuda else "cpu"
    if cuda:
        from ..ops import _build

        _build.build_all()
    ref = {}
    for dtype in (np.float64, np.float32):
        stamps = []
        t0 = time.perf_counter()
        fm = shardn_fit(None, device, dtype, design, stamps)
        ref[np.dtype(dtype).name] = dict(values=_samples(fm),
                                         **_rates(stamps, t0))
        del fm
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(world, _shardn_rank, (backend, design), tag="shardn")
    line = dict(world_size=world, backend=backend,
                ranks_s=time.perf_counter() - t0,
                tolerance_float64=dict(rtol=RTOL, atol=ATOL), fits={})
    for name, want in ref.items():
        row = dict(one_process={k: want[k] for k in
                                ("time_to_first_sweep_s", "sweeps_per_s")},
                   ranks=[])
        for r, rank in enumerate(ranks):
            got = rank[name]
            equal, worst, excess = _diff(got["values"], want["values"])
            row["ranks"].append(dict(
                rank=r, engine=got["engine"], launches=got["launches"],
                time_to_first_sweep_s=got["time_to_first_sweep_s"],
                sweeps_per_s=got["sweeps_per_s"], bit_equal=equal,
                max_abs_diff=worst, max_err_over_tolerance=excess,
                replicated_bit_equal=got["replicated_bit_equal"]))
            if not got["replicated_bit_equal"]:
                raise PhaseError(f"shardn {name}: replicas differ")
            if not rank["resume_bit_equal"]:
                raise PhaseError(f"shardn: rank {r}'s resumed chain "
                                 "differs")
            if got["engine"] != "fastpath" or (
                    cuda and got["launches"]["gram_gibbs"] <= 0):
                raise PhaseError(f"shardn {name}: rank {r} ran "
                                 f"{got['engine']!r}, {got['launches']}")
            if name == "float64" and excess > 1.0:
                raise PhaseError(f"shardn: rank {r} differs from one "
                                 f"process by {worst:.3e}")
        line["fits"][name] = row
    for key in ("collective_calls", "collective_bytes",
                "collective_s_timed_fit", "resume_bit_equal"):
        line[key] = [rank[key] for rank in ranks]
    return line


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="shard1,shard2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sharded: no CUDA device")
    from .. import MyFMGibbsRegressor
    from .harvest import card_line, design as design_10m

    phases = args.phases.split(",")
    if "shard1" in phases:
        X, blocks, y, grouping = design_10m()
        n_te = min(100_000, y.shape[0])
        test = (X[:n_te], [type(b)(b.original_to_block[:n_te], b.data)
                           for b in blocks], y[:n_te])
        fm = MyFMGibbsRegressor(rank=RANK_10M, random_seed=SEED,
                                device="cuda:0").fit(
            X, y, X_rel=blocks, n_iter=N_ITER_10M,
            n_kept_samples=N_KEPT_10M, grouping=grouping,
            callback=lambda *a: (False, None))
        ref = (_samples(fm), fm.predict(test[0], test[1]))
        del fm
        print(json.dumps(dict(phase="shard1", **shard1(
            (X, blocks, y), test, grouping, ref))), flush=True)
    if "shard2" in phases:
        print(json.dumps(dict(phase="shard2", **shard2())), flush=True)
    if "shardn" in phases:
        print(json.dumps(dict(phase="shardn", **shardn())), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
