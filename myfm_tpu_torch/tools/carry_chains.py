"""How far the Gram kernels' carry has to travel: the chains of tiles that
one entity spans, read from a fast-path plan's flags.

Kernels 1-3 (csrc/gram_tile.cuh) hand an entity's running Gram from one
tile to the next in tile order: a tile with ``cont_in`` set waits for the
carry of the last tile before it with ``cont_out`` set.  A chain is a
maximal run of consecutive tiles linked that way inside one kernel call
(one chunk of ``chunk_tiles`` tiles; a chunk's first tile takes its
carry from the call's ``carry_in`` and waits for nothing).  Its length
in tiles less one is the number of hand-offs that must follow each other
in that call.

``chain_stats`` reads the flags of one table; run on the host (no card
needed, ~1 min and ~2 GB for the ML-10M shape):

    python -m myfm_tpu_torch.tools.carry_chains [--scale 10m] [--rank 32 128]

prints one JSON line per (rank, table) of the smoke's ML-10M design
(``chip_smoke.build_design``: 90% of the rows, date / user / item tables)
with the (T, S) the plan picks.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np


def chain_stats(cont_in, cont_out, chunk_tiles: Optional[int] = None
                ) -> Dict[str, int]:
    """Chain statistics of one table's flags (``cont_in`` / ``cont_out``
    [K], any array-like of 0/1; ``chunk_tiles`` tiles per kernel call,
    default all K): tiles, calls, continuing tiles (``cont_in`` set),
    chains of two or more tiles, the longest chain in tiles, and the
    hand-offs in all chains (continuing tiles that are not a call's
    first)."""
    ci = np.asarray(cont_in, dtype=np.int64).reshape(-1)
    co = np.asarray(cont_out, dtype=np.int64).reshape(-1)
    K = ci.shape[0]
    chunk = K if chunk_tiles is None else max(1, int(chunk_tiles))
    # tile k continues tile k - 1 inside one call
    link = np.zeros(K, dtype=bool)
    if K > 1:
        link[1:] = (ci[1:] != 0) & (co[:-1] != 0)
    link[np.arange(0, K, chunk)] = False
    # chain lengths: runs of links, plus their head tile
    heads = np.flatnonzero(~link)
    lengths = np.diff(np.append(heads, K))
    return dict(
        tiles=int(K),
        calls=int(-(-K // chunk)) if K else 0,
        chunk_tiles=int(chunk),
        continuing_tiles=int((ci != 0).sum()),
        chains=int((lengths >= 2).sum()),
        longest_chain_tiles=int(lengths.max()) if K else 0,
        hand_offs=int(link.sum()),
    )


def design_tables(scale: str, seed: int = 0, test_share: float = 0.1):
    """(name, entity ids, n_entities) of the smoke's fitted rows: the
    date, user and item tables of the synthetic MovieLens design, in the
    plan's table order."""
    from ..utils.benchmark_data import SyntheticMovieLensManager

    man = SyntheticMovieLensManager(scale, rank=8, random_seed=seed)
    data = man.load_rating_all()
    n = data["rating"].shape[0]
    perm = np.random.RandomState(seed).permutation(n)
    rows = perm[int(n * test_share):]
    days = data["day"]
    return [("days", days[rows], int(days.max()) + 1),
            ("users", data["user_id"][rows] - 1, man.n_users),
            ("items", data["movie_id"][rows] - 1, man.n_items)]


def main(argv=None):
    from ..design_categorical import compile_categorical_table

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="10m")
    ap.add_argument("--rank", type=int, nargs="+", default=[32, 128])
    args = ap.parse_args(argv)
    tables = design_tables(args.scale)
    n_rows = tables[0][1].shape[0]
    for rank in args.rank:
        for name, ent, B in tables:
            tab = compile_categorical_table(
                ent, B, 0, n_rows, np.float32, "cpu", rank=rank,
                max_inflation=4.0)
            row = dict(rank=rank, table=name, entities=B,
                       T=tab.tile_rows, S=tab.tile_entities)
            row.update(chain_stats(tab.cont_in.numpy(), tab.cont_out.numpy(),
                                   tab.chunk_tiles))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
