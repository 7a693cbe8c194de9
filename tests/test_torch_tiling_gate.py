"""The fast-path acceptance gate of the port against the TPU package's.

Both packages reject a table whose tiling pads its rows by more than
``max_inflation`` (4.0).  The TPU package decides with its own ranking
of tilings; the port keeps a host copy of that arithmetic
(``design_categorical.reference_tiling``), so "auto" resolves to the
same engine in both, while an accepted table is packed at the port's own
(T, S).  Checked over cardinality profiles (1, 2 and 3 rows per entity
over 20,000 entities, and a Zipf profile), ranks 10, 32 and 64, and the
widths each caller gates at: R (Gibbs), 3R (one-hot VI plans) and 4R
(entity+attribute VI plans, where the port tiles for 3R).
"""

import numpy as np
import pytest
import scipy.sparse as sps

import myfm_tpu
import myfm_tpu_torch
from myfm_tpu import design_categorical as jdc
from myfm_tpu_torch import design_categorical as pdc

N_ENT = 20_000
PROFILES = ("1", "2", "3", "zipf")
RANKS = (10, 32, 64)
WIDTHS = ("gibbs", "vi_onehot", "vi_ea")


def _counts(profile):
    if profile == "zipf":
        rng = np.random.RandomState(0)
        ent = np.minimum(rng.zipf(1.3, size=60_000), N_ENT) - 1
        return np.bincount(ent, minlength=N_ENT)
    return np.full(N_ENT, int(profile))


@pytest.mark.parametrize("width", [1, 3, 4])
@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("profile", PROFILES)
def test_reference_tiling_is_the_tpu_packages_choice(profile, rank, width):
    """(T, S, inflation) equal to the TPU package's choose_tiling at the
    same width, and the packed row count equal to its _packed_rows."""
    counts = _counts(profile)
    want = jdc.choose_tiling(counts, jdc.DEFAULT_TILE_ROWS,
                             jdc.DEFAULT_TILE_ENTITIES, width * rank)
    assert pdc.reference_tiling(counts, width * rank) == tuple(want)
    T, S, _ = want
    assert pdc._packed_rows(counts, T, S) == jdc._packed_rows(counts, T, S)


def _design(profile, mod, side):
    """Users with the profile's rows each (one row per user-row of the
    main order) and 50 items; with ``side`` the user block also carries
    one numeric side column, which makes its rows an entity+attribute
    table with the same cardinalities."""
    counts = _counts(profile)
    users = np.repeat(np.arange(N_ENT), counts)
    n = users.size
    items = np.random.RandomState(1).randint(0, 50, n)
    ublock = sps.identity(N_ENT, format="csr")
    if side:
        ublock = sps.hstack(
            [ublock, sps.csr_matrix(np.linspace(0.5, 1.5, N_ENT)[:, None])],
            format="csr")
    blocks = [mod.RelationBlock(users, ublock),
              mod.RelationBlock(items, sps.identity(50, format="csr"))]
    grouping = np.repeat([0, 1, 2] if side else [0, 1],
                         [N_ENT, 1, 50] if side else [N_ENT, 50])
    return blocks, grouping.astype(np.int32)


def _compile_both(profile, rank, width):
    side = width == "vi_ea"
    jb, grouping = _design(profile, myfm_tpu, side)
    pb, _ = _design(profile, myfm_tpu_torch, side)
    jrank = {"gibbs": rank, "vi_onehot": 3 * rank, "vi_ea": 4 * rank}[width]
    prank = {"gibbs": rank, "vi_onehot": 3 * rank, "vi_ea": 3 * rank}[width]
    jp = jdc.try_compile_categorical(None, jb, grouping, None, np.float32,
                                     rank=jrank, allow_side=side)
    pp = pdc.try_compile_categorical(None, pb, grouping, None, np.float32,
                                     "cpu", rank=prank, allow_side=side,
                                     gate_rank=jrank)
    return jp, pp, prank


def _old_rule(counts, rank):
    """The port's choice before the gate followed the TPU package's:
    choose_tiling alone, rejected above 4.0."""
    T, S, infl = pdc.choose_tiling(counts, rank, 4)
    return (T, S) if infl <= 4.0 else None


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("profile", PROFILES)
def test_compiles_agree_and_keep_earlier_tilings(profile, rank, width):
    """Both packages' fast-path compiles return a plan or both None; a
    user table the port accepted before keeps its (T, S), and one it
    newly accepts takes its least-padding tiling."""
    jp, pp, prank = _compile_both(profile, rank, width)
    assert (jp is None) == (pp is None)
    if pp is None:
        return
    counts = _counts(profile)
    before = _old_rule(counts, prank)
    user = pp.tables[0]
    got = (user.tile_rows, user.tile_entities)
    if before is not None:
        assert got == before
    else:
        T, S, infl = pdc.least_inflating_tiling(counts, prank, 4)
        assert got == (T, S)
    if width == "vi_ea":
        assert pp.side[-1] is not None


@pytest.mark.parametrize("family", ["gibbs", "vi"])
def test_single_row_users_fit_on_the_fast_path_like_jax(family):
    """4,000 users with one row each plus 50 items at rank 32: the TPU
    package fits on "fastpath", and the port now does too (it sent the
    design to the colored engine before its gate followed the TPU
    package's)."""
    rng = np.random.RandomState(0)
    n = 4000
    items = rng.randint(0, 50, n)
    y = rng.normal(size=n)

    def fit(mod, **kw):
        blocks = [mod.RelationBlock(np.arange(n),
                                    sps.identity(n, format="csr")),
                  mod.RelationBlock(items, sps.identity(50, format="csr"))]
        est = (mod.MyFMGibbsRegressor if family == "gibbs"
               else mod.VariationalFMRegressor)
        return est(rank=32, **kw).fit(
            None, y, X_rel=blocks, n_iter=1, group_shapes=[n, 50],
            callback=lambda *a: (True, None)).history_.engine

    assert fit(myfm_tpu) == fit(myfm_tpu_torch, device="cpu") == "fastpath"
