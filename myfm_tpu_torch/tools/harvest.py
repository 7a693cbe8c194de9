"""What the Gibbs loop's sample harvest costs on a CUDA card, on a chain
that keeps every sample.

``MyFMGibbsRegressor`` on the synthetic ML-10M design of the smoke
(90% of the rows; date one-hot plus user and item blocks), rank 32,
``--sweeps`` sweeps with every sample kept, the plan from the cache
after one warm-up fit.  Each round runs, in this order:

  eager        a user callback: every sweep's values read on the host
               at once (8 host syncs a sweep)
  pipelined    the default harvest (trainer._HostCopy): snapshots
               copied to pinned host buffers on a side stream, read
               three sweeps later, then copied into ordinary host memory
               and the pinned buffers released
  views        the same, but each kept sample holds numpy views of its
               pinned buffers (the design before the release), so every
               sweep needs new pinned memory

and prints one JSON line per fit: its seconds and sweeps/s (plan from
the cache and initialisation included), the host ms per sweep spent
starting the copies (``_HostCopy.__init__``) and reading them
(``wait``), the pinned blocks the host allocator made
(``num_host_alloc``) and the bytes it holds after the fit, and the
harvest's peak pinned bytes.  Rounds alternate, since a one-card
machine's host time varies from run to run.  The last line is the
card's name and power limit.

    python -m myfm_tpu_torch.tools.harvest [--sweeps 100] [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Sequence

import numpy as np
import scipy.sparse as sps
import torch

from .. import MyFMGibbsRegressor, RelationBlock
from .. import trainer as tt
from ..utils.benchmark_data import SyntheticMovieLensManager

RANK = 32
SEED = 0
TEST_SHARE = 0.1


def design(seed: int = SEED):
    """(X, blocks, y, grouping) of the smoke's fitted ML-10M rows."""
    man = SyntheticMovieLensManager("10m", rank=8, random_seed=seed)
    data = man.load_rating_all()
    users, items = data["user_id"] - 1, data["movie_id"] - 1
    days, y = data["day"], data["rating"]
    n = y.shape[0]
    n_days = int(days.max()) + 1
    rows = np.random.RandomState(seed).permutation(n)[int(n * TEST_SHARE):]
    X = sps.csr_matrix(
        (np.ones(rows.size), (np.arange(rows.size), days[rows])),
        shape=(rows.size, n_days))
    blocks = [RelationBlock(users[rows], sps.identity(man.n_users,
                                                      format="csr")),
              RelationBlock(items[rows], sps.identity(man.n_items,
                                                      format="csr"))]
    grouping = [0] * n_days + [1] * man.n_users + [2] * man.n_items
    return X, blocks, y[rows], grouping


def _wait_views(self):
    """``_HostCopy.wait`` as it was before the release: numpy views of
    the pinned buffers."""
    if self._event is not None:
        if not self._event.query():
            tt._count_sync()
            self._event.synchronize()
        self._event = None
        tt._HostCopy.pinned_bytes -= sum(h.nbytes for h in self._host)
        self._host = tuple(h.numpy() for h in self._host)
    return self._host


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("harvest: no CUDA device")
    X, blocks, y, grouping = design()

    def fit(n_iter, callback=None):
        fm = MyFMGibbsRegressor(rank=RANK, random_seed=SEED,
                                device="cuda").fit(
            X, y, X_rel=blocks, n_iter=n_iter, n_kept_samples=n_iter,
            grouping=grouping, callback=callback)
        torch.cuda.synchronize()
        return fm

    fit(2)  # the kernels, the self-checks and the plan cache
    host_s = {"init": 0.0, "wait": 0.0}
    real_init, real_wait = tt._HostCopy.__init__, tt._HostCopy.wait

    def timed(kind, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host_s[kind] += time.perf_counter() - t0
            return out
        return run

    variants = (("eager", lambda *a: (False, None), real_wait),
                ("pipelined", None, real_wait),
                ("views", None, _wait_views))
    tt._HostCopy.__init__ = timed("init", real_init)
    try:
        for rnd in range(args.rounds):
            for name, callback, wait in variants:
                tt._HostCopy.wait = timed("wait", wait)
                host_s.update(init=0.0, wait=0.0)
                tt._HostCopy.peak_pinned_bytes = tt._HostCopy.pinned_bytes
                before = torch.cuda.host_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fm = fit(args.sweeps, callback)
                s = time.perf_counter() - t0
                after = torch.cuda.host_memory_stats()
                print(json.dumps(dict(
                    round=rnd, harvest=name, sweeps=args.sweeps,
                    kept=len(fm.predictor_.samples), fit_s=s,
                    sweeps_per_s=args.sweeps / s,
                    init_ms_per_sweep=1e3 * host_s["init"] / args.sweeps,
                    wait_ms_per_sweep=1e3 * host_s["wait"] / args.sweeps,
                    host_allocs=(after.get("num_host_alloc", 0)
                                 - before.get("num_host_alloc", 0)),
                    host_alloc_bytes=after.get("allocated_bytes.current"),
                    peak_pinned_bytes=tt._HostCopy.peak_pinned_bytes)),
                    flush=True)
                del fm
    finally:
        tt._HostCopy.__init__, tt._HostCopy.wait = real_init, real_wait
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
