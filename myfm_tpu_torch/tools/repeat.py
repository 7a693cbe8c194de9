"""Do two fits from one seed give the same chain on a CUDA card?

Each case fits one estimator twice from the same seed under default ops
and records, every sweep, the hyperparameters (α, μ_w, λ_w, μ_V, λ_V),
w0, w, V and the cutpoints.  Its JSON line names the first sweep where
the two chains differ and, in the sweep's draw order (α, w0, λ_w, μ_w,
λ_V, μ_V, then the weights of each hyper-group), the first quantity that
differs, with the largest difference of every quantity at that sweep
and at the end.  A third fit runs under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and the line
lists the ops torch warned about.

Cases (``--cases``, comma-separated):

  fast          MyFMGibbsRegressor, rank 32, the synthetic ML-10M design
                of the smoke (fast path), ``--sweeps`` sweeps
  fast_ordered  MyFMOrderedProbit on the same design
  colored       MyFMGibbsRegressor(sweep_strategy="colored"), rank 10, the
                ML-100k timeSVD++-flipped design
  joint         MyFMGibbsRegressor(sweep_strategy="joint"), rank 10, the
                same design

``--time N`` then times the fast path's pipelined fit of N sweeps (the
smoke's ``drain`` regression fit) with every float segment sum as it is
(``ops/segsum``) and with the atomic ``index_add_`` it replaced, in the
order atomic, deterministic, deterministic, atomic, in this one process;
``--time-rowspace N`` the same for the colored and the joint engines'
fits of N sweeps on the ML-100k design.  The last line is the card's
name and power limit.

    python -m myfm_tpu_torch.tools.repeat [--cases fast,colored]
        [--sweeps 6] [--time 100] [--time-rowspace 2]
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from .. import MyFMGibbsRegressor, MyFMOrderedProbit
from .harvest import card_line, design as design_10m

SEED = 0
HYPERS = ("alpha", "mu_w", "lambda_w", "mu_V", "lambda_V")


def design_100k():
    """(X, blocks, y, grouping) of the smoke's ML-100k joint design."""
    from ..utils.ml_features import (build_feature_blocks,
                                     load_synthetic_movielens)

    train, test = load_synthetic_movielens("100k", 0)
    X, _, blocks, _, grouping = build_feature_blocks(
        train, test, "timesvdpp_flipped")
    return X, blocks, train["rating"], grouping


def record(trace):
    """A callback that keeps every sweep's host values in ``trace``."""

    def callback(i, fm, hyper, history):
        row = {k: np.asarray(getattr(hyper, k), np.float64) for k in HYPERS}
        row.update(w0=np.float64(fm.w0), w=np.asarray(fm.w),
                   V=np.asarray(fm.V),
                   cutpoints=np.concatenate(
                       [np.ravel(c) for c in fm.cutpoints] or [np.zeros(0)]))
        trace.append(row)
        return False, None

    return callback


def first_difference(a, b, grouping):
    """(sweep, quantity, {quantity: largest difference} at that sweep),
    or (None, None, {}) where the traces are bit-equal."""
    groups = np.asarray(grouping)
    for s, (x, y) in enumerate(zip(a, b)):
        diffs, first = {}, None
        for k in ("alpha", "w0") + HYPERS[1:] + ("w", "V", "cutpoints"):
            d = np.abs(np.asarray(x[k], np.float64)
                       - np.asarray(y[k], np.float64))
            diffs[k] = float(d.max()) if d.size else 0.0
        order = ["alpha", "w0", "lambda_w", "mu_w", "lambda_V", "mu_V"]
        for k in order:
            if diffs[k] and first is None:
                first = k
        if first is None and (diffs["w"] or diffs["V"]):
            dw = np.abs(a[s]["w"] - b[s]["w"]) + np.abs(
                a[s]["V"] - b[s]["V"]).sum(axis=1)
            first = f"weights of group {int(groups[np.argmax(dw > 0)])}"
        if first is None and diffs["cutpoints"]:
            first = "cutpoints"
        if first is not None:
            return s, first, diffs
    return None, None, {}


def largest(a, b):
    return {k: float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max(initial=0.0))
            for k in a}


def run_case(name, sweeps, designs):
    if name.startswith("fast"):
        X, blocks, y, grouping = designs("10m")
        est, kw, rank = MyFMGibbsRegressor, {}, 32
        if name == "fast_ordered":
            est, y = MyFMOrderedProbit, (np.asarray(y) - 1).astype(np.int64)
    else:
        X, blocks, y, grouping = designs("100k")
        est, rank = MyFMGibbsRegressor, 10
        kw = dict(sweep_strategy=name)

    def fit(trace):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = est(rank=rank, random_seed=SEED, device="cuda", **kw).fit(
            X, y, X_rel=blocks, n_iter=sweeps, n_kept_samples=1,
            grouping=grouping, callback=record(trace))
        torch.cuda.synchronize()
        return fm, time.perf_counter() - t0

    a, b, c = [], [], []
    fm, s_a = fit(a)
    _, s_b = fit(b)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fit(c)
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    sweep, quantity, at = first_difference(a, b, grouping)
    return dict(case=name, engine=fm.history_.engine, rank=rank,
                sweeps=sweeps, bit_equal=sweep is None,
                first_sweep=sweep, first_quantity=quantity,
                diffs_at_first=at, diffs_at_end=largest(a[-1], b[-1]),
                fit_s=[s_a, s_b],
                deterministic_mode_vs_default=largest(a[-1], c[-1]),
                deterministic_mode_warned=nondet)


def _atomic_index_add(x, index, n, out=None, *, order=None,
                      ascending=False):
    """The float segment sum as it was: an atomic ``index_add_``."""
    if out is None:
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, index, x)
    return out.index_add(0, index, x)


def _atomic_chunks(summands, index, n, out, chunk, order=None):
    """The chunked sum (``build_block_gram``'s) as it was: row chunks
    added with an atomic ``index_add``."""
    for start in range(0, index.shape[0], chunk):
        sl = slice(start, start + chunk)
        out = out.index_add(0, index[sl], summands(sl))
    return out


def time_pairs(name, sweeps, design, **kw):
    """One engine's fit of ``sweeps`` sweeps, timed with the atomic sums
    and with ops/segsum's, in the order atomic, deterministic,
    deterministic, atomic after a warm-up fit (kernels, self-checks, the
    plan cache); every fit's V held against the first deterministic
    one's."""
    from ..ops import segsum

    X, blocks, y, grouping = design

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = MyFMGibbsRegressor(random_seed=SEED, device="cuda", **kw).fit(
            X, y, X_rel=blocks, n_iter=sweeps, n_kept_samples=sweeps,
            grouping=grouping)
        torch.cuda.synchronize()
        return fm, time.perf_counter() - t0

    fit()
    real = segsum._cuda_sum, segsum._chunks_in_order
    out, ref = [], None
    for variant in ("atomic", "deterministic", "deterministic", "atomic"):
        segsum._cuda_sum, segsum._chunks_in_order = (
            (_atomic_index_add, _atomic_chunks) if variant == "atomic"
            else real)
        try:
            fm, s = fit()
        finally:
            segsum._cuda_sum, segsum._chunks_in_order = real
        V = np.stack([smp.V for smp in fm.predictor_.samples])
        if variant == "deterministic" and ref is None:
            ref = V
        out.append(dict(case=name, variant=variant, sweeps=sweeps, fit_s=s,
                        sweeps_per_s=sweeps / s,
                        max_abs_diff_V_vs_first_deterministic=(
                            None if ref is None
                            else float(np.abs(V - ref).max()))))
    return out


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="fast,fast_ordered,colored,joint")
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--time", type=int, default=0)
    ap.add_argument("--time-rowspace", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repeat: no CUDA device")
    cache = {}

    def designs(which):
        if which not in cache:
            cache[which] = design_10m() if which == "10m" else design_100k()
        return cache[which]

    for name in filter(None, args.cases.split(",")):
        print(json.dumps(run_case(name, args.sweeps, designs)), flush=True)
    timed = []
    if args.time:
        timed.append(("fast", args.time, "10m", dict(rank=32)))
    if args.time_rowspace:
        timed += [(e, args.time_rowspace, "100k",
                   dict(rank=10, sweep_strategy=e))
                  for e in ("colored", "joint")]
    for name, sweeps, which, kw in timed:
        for line in time_pairs(name, sweeps, designs(which), **kw):
            print(json.dumps(line), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
