"""Shared inputs of the VI parity tests (tests/test_torch_vi*.py): the
tiny timeSVD++ design and a one-hot design, compiled by both packages at
a pinned (T, S), random moments from a seed, and the scale-relative
comparison."""

import os
import sys

import numpy as np
import scipy.sparse as sps
import torch

from myfm_tpu import RelationBlock as JaxBlock
from myfm_tpu.design_categorical import (
    try_compile_categorical as jax_compile,
)
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch.design_categorical import try_compile_categorical

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

TABLE_FIELDS = (
    "src", "slot", "slot_f", "ent_of_tile_row", "cont_in", "cont_out",
    "last_slot", "ent_slots", "final_part", "fin_win", "fin_idx",
    "fin_mask", "cardinality", "ent_main", "noise_feat",
)
STATIC_FIELDS = ("col_offset", "n_cols", "n_tiles", "tile_rows",
                 "tile_entities", "chunk_tiles", "max_fin")
R = 3


def as_np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, tol=1e-10, what=""):
    got, want = as_np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def load_tiny(binary=False):
    """The synthetic "tiny" MovieLens fold with the timeSVD++-flipped
    features: a one-hot date table, a user block [one-hot | N-hot
    implicit items] and an item block [one-hot | N-hot implicit users].

    The implicit columns hold 1/√n.  ``binary`` sets them to 1: with
    side values x ∈ {0, 1} the TPU package's entity+attribute VI color
    step is exact and the port must agree with it; with other values it
    is not (myfm_tpu_torch/ops/categorical_vi.py), and the port is held
    to an independent oracle instead."""
    from ml_features import build_feature_blocks, load_movielens

    tr, te = load_movielens("tiny", 0, synthetic=True)
    X, _, blocks, _, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    if binary:
        blocks = [type(b)(b.original_to_block,
                          sps.csr_matrix(b.data, copy=True).sign())
                  for b in blocks]
    return X, blocks, np.asarray(grouping, np.int32), np.array(
        tr.rating.values)


def ea_plans(tiny, ts=(64, 4)):
    X, blocks, grouping, y = tiny
    kw = dict(rank=4 * R, allow_side=True, fixed_ts=ts)
    jp = jax_compile(X, blocks, grouping, None, np.float64, **kw)
    pp = try_compile_categorical(X, blocks, grouping, None, np.float64,
                                 "cpu", **kw)
    assert jp is not None and pp is not None
    return jp, pp


def onehot_plans(seed=1, N=500, sizes=(13, 9, 7), ts=(32, 4)):
    rng = np.random.RandomState(seed)
    ents = [rng.randint(0, b, N) for b in sizes]
    ents[0][: N // 3] = 2  # an entity spanning several tiles
    blocks_p = [RelationBlock(e, sps.identity(b, format="csr"))
                for e, b in zip(ents, sizes)]
    blocks_j = [JaxBlock(e, sps.identity(b, format="csr"))
                for e, b in zip(ents, sizes)]
    grouping = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    jp = jax_compile(None, blocks_j, grouping, None, np.float64,
                     rank=3 * R, fixed_ts=ts)
    pp = try_compile_categorical(None, blocks_p, grouping, None, np.float64,
                                 "cpu", rank=3 * R, fixed_ts=ts)
    y = rng.normal(size=N) + 3.0
    return jp, pp, y, rng


def moments(rng, F, G_n):
    return dict(
        w=rng.normal(size=F), w_var=rng.random(F) * 0.3 + 0.05,
        V=rng.normal(size=(F, R)), V_var=rng.random((F, R)) * 0.3 + 0.05,
        lambda_w=rng.random(G_n) + 0.5, mu_w=rng.normal(size=G_n) * 0.1,
        lambda_V=rng.random((G_n, R)) + 0.5,
        mu_V=rng.normal(size=(G_n, R)) * 0.1,
    )


ORDER = ("w", "w_var", "V", "V_var")
HYP = ("lambda_w", "mu_w", "lambda_V", "mu_V")
