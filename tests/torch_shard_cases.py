"""Sharded fits of the port on the CPU, for the world-size-2 tests.

Imports torch, numpy, scipy and the port only: the ranks are spawned
processes, and ``tests/conftest.py`` (which imports JAX) is not loaded
in them.  ``run_ranks`` starts ``world`` ranks over gloo with a
``FileStore`` rendezvous in a temporary directory, runs every named case
on each rank and returns each rank's results; a rank that fails or
hangs fails the call.  Each case is a function of the data axis (None:
one process, the reference) returning a dict of numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import scipy.sparse as sps
import torch

R = 3
N_ITER = 5
SEED = 7


def cf_design(n_users=32, n_items=18, n=600, seed=0):
    """Two one-hot blocks (users, items) and a regression target."""
    from myfm_tpu_torch import RelationBlock

    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    y = (1.5 + rng.normal(size=n_users)[u] + rng.normal(size=n_items)[i]
         + 0.3 * rng.normal(size=n))
    blocks = [RelationBlock(u, sps.identity(n_users, format="csr")),
              RelationBlock(i, sps.identity(n_items, format="csr"))]
    return None, blocks, y, [0] * n_users + [1] * n_items


def ea_design(n_users=30, n_items=20, n=600, n_side=4, seed=1):
    """Users with [one-hot | 0/1 side features] (an entity+attribute
    table on the fast path), one-hot items."""
    from myfm_tpu_torch import RelationBlock

    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    side = (rng.random_sample((n_users, n_side)) < 0.4).astype(np.float64)
    user_x = sps.hstack([sps.identity(n_users), sps.csr_matrix(side)],
                        format="csr")
    y = (1.0 + rng.normal(size=n_users)[u] + rng.normal(size=n_items)[i]
         + side[u] @ rng.normal(size=n_side) + 0.3 * rng.normal(size=n))
    blocks = [RelationBlock(u, user_x),
              RelationBlock(i, sps.identity(n_items, format="csr"))]
    grouping = [0] * n_users + [1] * n_side + [2] * n_items
    return None, blocks, y, grouping


def row_design(n=503, n_main=12, n_users=25, seed=2):
    """A main table with three nonzeros per row plus a one-hot user
    block: the row-space engines (colored, joint)."""
    from myfm_tpu_torch import RelationBlock

    rng = np.random.RandomState(seed)
    cols = np.stack([rng.choice(n_main, 3, replace=False)
                     for _ in range(n)])
    X = sps.csr_matrix((rng.uniform(0.5, 1.5, 3 * n),
                        (np.repeat(np.arange(n), 3), cols.ravel())),
                       shape=(n, n_main))
    u = rng.randint(0, n_users, n)
    y = (X @ rng.normal(size=n_main) + rng.normal(size=n_users)[u]
         + 0.3 * rng.normal(size=n))
    blocks = [RelationBlock(u, sps.identity(n_users, format="csr"))]
    return X, blocks, y, [0] * n_main + [1] * n_users


def rating_design():
    """The entity+attribute design with 1-5 ratings as its target (the
    shape of ``tools.sharded.design_100k``'s)."""
    X, blocks, y, grouping = ea_design()
    return X, blocks, (ordinal(y, 5) + 1).astype(np.float64), grouping


def ordinal(y, k=4):
    """y cut into k classes by its quantiles."""
    return np.searchsorted(np.quantile(y, np.linspace(0, 1, k + 1)[1:-1]),
                           y).astype(np.int64)


def _kw(mesh, by_n_devices=False):
    """The estimators' arguments: ``mesh=`` the axis, or with
    ``by_n_devices`` ``n_devices=`` its size (the default group)."""
    if by_n_devices and mesh is not None:
        sharding = dict(n_devices=mesh.size)
    else:
        sharding = dict(mesh=mesh)
    return dict(rank=R, random_seed=SEED, dtype=np.float64, device="cpu",
                **sharding)


def _gibbs_out(fm, engine=None):
    out = dict(
        w0=np.array([s.w0 for s in fm.predictor_.samples]),
        w=np.stack([s.w for s in fm.predictor_.samples]),
        V=np.stack([s.V for s in fm.predictor_.samples]),
        alpha=np.array([h.alpha for h in fm.history_.hypers]),
        lambda_V=np.stack([h.lambda_V for h in fm.history_.hypers]),
        mu_w=np.stack([h.mu_w for h in fm.history_.hypers]),
        engine=np.array(fm.history_.engine),
    )
    cps = [s.cutpoints for s in fm.predictor_.samples]
    if cps and len(cps[0]):
        out["cutpoints"] = np.stack([np.concatenate(c) for c in cps])
    return out


def _gibbs_case(est_name, design, task=None, by_n_devices=False, **est_kw):
    def case(mesh):
        import myfm_tpu_torch as m

        X, blocks, y, grouping = design()
        if task == "classification":
            y = (y > np.median(y)).astype(np.int64)
        elif task == "ordered":
            y = ordinal(y)
        fm = getattr(m, est_name)(**_kw(mesh, by_n_devices), **est_kw).fit(
            X, y, X_rel=blocks, n_iter=N_ITER, n_kept_samples=3,
            grouping=grouping)
        out = _gibbs_out(fm)
        if est_name != "MyFMOrderedProbit":
            # the sharded scorer serves the entity-space designs; a
            # row-space design is scored whole on every rank
            out["predict"] = fm.predictor_.predict(
                sps.csr_matrix((len(y), 0)) if X is None else X, blocks,
                mesh=mesh if X is None else None)
        return out
    return case


def _vi_case(est_name, design, classify=False):
    def case(mesh):
        import myfm_tpu_torch as m

        X, blocks, y, grouping = design()
        if classify:
            y = (y > np.median(y)).astype(np.int64)
        fm = getattr(m, est_name)(**_kw(mesh)).fit(
            X, y, X_rel=blocks, n_iter=N_ITER, grouping=grouping)
        return dict(w0=np.array(fm.w0_mean), w=fm.w_mean, V=fm.V_mean,
                    w_var=fm.w_var, V_var=fm.V_var,
                    elbo=np.array(fm.history_.elbos),
                    engine=np.array(fm.history_.engine))
    return case


def reduce_scatter_off(mesh):
    """The fast path at the trainer level with the reduce-scatter off:
    every table's Gram is all-reduced whole."""
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    X, blocks, y, grouping = cf_design()
    g = np.asarray(grouping, np.int32)
    cfg = GibbsConfig(task="regression", gram_reduce_scatter=False)
    if mesh is None:
        plan = try_compile_categorical(X, blocks, g, None, np.float64, "cpu",
                                       rank=R)
        tr = CategoricalGibbsTrainer(plan, y, cfg, R, 0.1, SEED, np.float64)
    else:
        tr = ShardedCategoricalGibbsTrainer(
            X, blocks, y, cfg, R, 0.1, SEED, mesh=mesh, grouping=g,
            dtype=np.float64, device="cpu")
    pred, hist = tr.run(N_ITER, 3)
    return dict(V=np.stack([s.V for s in pred.samples]),
                w=np.stack([s.w for s in pred.samples]),
                alpha=np.array([h.alpha for h in hist.hypers]))


def checkpoint_resume(mesh, path=None):
    """The fast path's ordered chain, 4 sweeps in one go and 2 + 2
    through a checkpoint (rank 0 writes, every rank reads)."""
    import myfm_tpu_torch.parallel.sharding_categorical as sc
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer
    from myfm_tpu_torch.design_categorical import try_compile_categorical

    X, blocks, y, grouping = cf_design()
    y = ordinal(y)
    g = np.asarray(grouping, np.int32)
    cfg = GibbsConfig(task="ordered", n_class=4)

    def trainer():
        if mesh is None:
            plan = try_compile_categorical(X, blocks, g, None, np.float64,
                                           "cpu", rank=R)
            return CategoricalGibbsTrainer(plan, y, cfg, R, 0.1, SEED,
                                           np.float64)
        return sc.ShardedCategoricalGibbsTrainer(
            X, blocks, y, cfg, R, 0.1, SEED, mesh=mesh, grouping=g,
            dtype=np.float64, device="cpu")

    full, _ = trainer().run(4, 2)
    out = dict(full=np.stack([s.V for s in full.samples]))
    if path is not None:
        trainer().run(2, 1, checkpoint_path=path, checkpoint_every=2)
        resumed, _ = trainer().run(4, 2, checkpoint_path=path, resume=True)
        out["resumed"] = np.stack([s.V for s in resumed.samples])
    return out


def table_pass_inputs(seed=5):
    """The one-hot design, and weights, hyperparameters, noise and a
    target for one pass over its tables."""
    X, blocks, y, grouping = cf_design()
    rng = np.random.RandomState(seed)
    F, G = len(grouping), 2
    h = dict(w=rng.normal(size=F), V=rng.normal(size=(F, R)),
             tau=rng.normal(size=len(y)), w0=0.4, alpha=1.7,
             lambda_w=rng.random_sample(G) + 0.5,
             mu_w=0.1 * rng.normal(size=G),
             lambda_V=rng.random_sample((G, R)) + 0.5,
             mu_V=0.1 * rng.normal(size=(G, R)),
             noise_w=rng.normal(size=F), noise_V=rng.normal(size=(F, R)))
    return X, blocks, y, grouping, h


def table_pass(axis):
    """Both table passes of the one-hot design on this rank's sharded
    plan, chained, from ``table_pass_inputs``: (w, V, moments)."""
    from myfm_tpu_torch.ops import categorical as tcat
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.parallel.sharding_categorical import (
        compile_sharded_categorical,
    )

    X, blocks, y, grouping, h = table_pass_inputs()
    plan = compile_sharded_categorical(
        X, blocks, np.asarray(grouping, np.int32), axis, np.float64, "cpu",
        R)
    cfg = GibbsConfig(task="regression", axis=axis)
    tau = torch.as_tensor(h["tau"][plan.row_lo : plan.row_lo + plan.n_rows])
    tiles = tcat.make_y_tiles(plan, tau)
    w, V = torch.as_tensor(h["w"]), torch.as_tensor(h["V"])
    hyp = [torch.as_tensor(h[k]) for k in ("lambda_w", "mu_w", "lambda_V",
                                           "mu_V")]
    moments = None
    for ti in range(len(plan.tables)):
        w, V, moments = tcat._table_pass(
            plan, ti, w, V, h["w0"], h["alpha"], *hyp, plan.group_index,
            torch.as_tensor(h["noise_w"]), torch.as_tensor(h["noise_V"]),
            tiles[ti], cfg, want_moments=ti == len(plan.tables) - 1)
    return dict(w=w.numpy(), V=V.numpy(),
                moments=np.array([float(m) for m in moments]))


CASES = {
    "fast_reg": _gibbs_case("MyFMGibbsRegressor", cf_design),
    "fast_reg_odd": _gibbs_case(
        "MyFMGibbsRegressor", lambda: cf_design(n_users=31, n_items=19)),
    "fast_cls": _gibbs_case("MyFMGibbsClassifier", cf_design,
                            "classification", by_n_devices=True),
    "fast_ord": _gibbs_case("MyFMOrderedProbit", cf_design, "ordered"),
    "fast_rs_off": reduce_scatter_off,
    "ea_reg": _gibbs_case("MyFMGibbsRegressor", ea_design),
    "ea_ord": _gibbs_case("MyFMOrderedProbit", ea_design, "ordered"),
    "colored_ord": _gibbs_case("MyFMOrderedProbit", row_design, "ordered",
                               sweep_strategy="colored"),
    "colored_reg": _gibbs_case("MyFMGibbsRegressor", row_design,
                               sweep_strategy="colored"),
    "joint_reg": _gibbs_case("MyFMGibbsRegressor", row_design,
                             sweep_strategy="joint"),
    "joint_cls": _gibbs_case("MyFMGibbsClassifier", row_design,
                             "classification", sweep_strategy="joint"),
    "vi_reg": _vi_case("VariationalFMRegressor", cf_design),
    "vi_cls": _vi_case("VariationalFMClassifier", cf_design, classify=True),
    "vi_ea": _vi_case("VariationalFMRegressor", ea_design),
}


def _replicated(axis, result):
    """The replicated outputs are the same bits on every rank."""
    from myfm_tpu_torch.parallel.collectives import replicas_equal

    keys = sorted(k for k, v in result.items()
                  if isinstance(v, np.ndarray) and v.dtype.kind == "f")
    return replicas_equal(axis, [torch.as_tensor(np.ascontiguousarray(
        result[k])).reshape(-1) for k in keys])


def _rank_main(rank, world, init_file, out_dir, names, extra):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    results, error = {}, None
    try:
        from myfm_tpu_torch.parallel.collectives import Axis

        axis = Axis(None)
        for name in names:
            out = CASES[name](axis)
            out["replicated"] = np.array(_replicated(axis, out))
            results[name] = out
        for name, fn in extra:
            results[name] = fn(axis)
    except Exception:  # reported to the test process
        error = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((results, error), f)
        dist.destroy_process_group()


def run_ranks(tmp_dir, names, world=2, timeout=300.0, extra=()):
    """Each rank's {case: result} after running ``names`` (and the
    ``extra`` (name, fn(axis)) pairs) on ``world`` gloo ranks."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init_file = os.path.join(tmp_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_file, tmp_dir, names, extra))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise RuntimeError(f"{len(hung)} rank(s) hung past {timeout} s")
    out = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} exited with {p.exitcode} and no "
                               "result")
        with open(path, "rb") as f:
            results, error = pickle.load(f)
        if error:
            raise RuntimeError(f"rank {r} failed:\n{error}")
        out.append(results)
    return out
