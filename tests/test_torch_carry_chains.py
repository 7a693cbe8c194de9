"""The Gram kernels' in-order carry on chains of tiles, on the CPU.

``ops/gram.carry_in_order`` is the plain version that the card's carry
walk is held to bit for bit (tests/test_torch_cuda.py
``test_carry_walk_is_the_in_order_carry``); here kernel 3's plain version,
which applies it, is held to the TPU package's kernel 3 (Pallas in
interpret mode, its grid's in-order carry) on the chain cases the card
tests use: one entity over every tile, an S = 1 pass-through chain entered
with a carry, and random flags.  Tolerance: float64, 1e-12 of scale (the
same sums; only the partials' products are ordered differently).  Then
the chain statistics that the carry's design was chosen by
(``tools/carry_chains.chain_stats``) on a small plan, against a hand
count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myfm_tpu.ops.pallas_gram import tile_gram as jax_tile_gram
from myfm_tpu_torch.design_categorical import compile_categorical_table
from myfm_tpu_torch.ops import gram
from myfm_tpu_torch.tools.carry_chains import chain_stats


def _chain_flags(case, K, S, rng):
    """(cont_in, cont_out, last_slot, carry_in nonzero) of a chain case,
    as the card tests build them."""
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


@pytest.mark.parametrize("case,K,S", [("span", 24, 1), ("through", 17, 1),
                                      ("random", 37, 3)])
def test_plain_carry_matches_the_tpu_kernel(case, K, S):
    rng = np.random.RandomState(K + S)
    T, D = 8, 4
    slot = np.sort(rng.randint(0, S, (K, T)), axis=1).astype(np.int32)
    slot[:, -2:] = S
    rows = rng.normal(size=(K, T, D))
    rows[slot == S] = 0.0  # pad rows are zero rows
    ci, co, ls, with_carry = _chain_flags(case, K, S, rng)
    cin = rng.normal(size=(D, D)) if with_carry else np.zeros((D, D))
    ours, our_c = gram.tile_gram_reference(
        torch.as_tensor(rows), torch.as_tensor(slot),
        *(torch.as_tensor(f) for f in (ci, co, ls)), S,
        torch.as_tensor(cin))
    want, want_c = jax_tile_gram(
        jnp.asarray(rows), jnp.asarray(slot), jnp.asarray(ci),
        jnp.asarray(co), jnp.asarray(ls), S=S, carry_in=jnp.asarray(cin),
        interpret=True)
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    assert float(np.abs(ours.numpy() - np.asarray(want)).max()) \
        <= 1e-12 * scale
    assert float(np.abs(our_c.numpy() - np.asarray(want_c)).max()) \
        <= 1e-12 * scale


def test_carry_in_order_is_in_place_and_keeps_quiet_tiles():
    """The carry lands in slot 0 of every continuing tile, in place; a
    tile with neither flag neither reads nor changes it; None is a zero
    carry."""
    p = torch.arange(4 * 2 * 1 * 1, dtype=torch.float64).view(4, 2, 1, 1)
    ci = torch.tensor([1, 0, 1, 1])
    co = torch.tensor([1, 0, 1, 0])
    ls = torch.tensor([1, 0, 0, 0])
    got = p.clone()
    c = gram.carry_in_order(got, ci, co, ls, torch.full((1, 1), 10.0))
    # tile 0: slot 0 += 10, carry = slot 1 (1); tile 1 quiet; tile 2:
    # slot 0 (4) += 1, carry = 5; tile 3: slot 0 (6) += 5, carry kept
    assert got.flatten().tolist() == [10.0, 1.0, 2.0, 3.0, 5.0, 5.0, 11.0,
                                      7.0]
    assert float(c) == 5.0
    zero = p.clone()
    gram.carry_in_order(zero, ci, co, ls)
    assert zero[0, 0].item() == 0.0


def test_chain_stats_count_a_small_plan():
    """Entity 0 spans 40 rows (tiles 0-2 at T = 16), entities 1 and 2
    share the last tiles: continuing tiles 1 and 2, one chain of three
    tiles; a 2-tile chunk cuts it after tile 1."""
    ent = np.repeat([0, 1, 2], [40, 5, 3])
    tab = compile_categorical_table(ent, 3, 0, ent.size, np.float64, "cpu",
                                    fixed_ts=(16, 2))
    ci, co = tab.cont_in.numpy(), tab.cont_out.numpy()
    assert ci.tolist() == [0, 1, 1, 0, 0]
    assert co.tolist() == [1, 1, 0, 0, 0]
    assert chain_stats(ci, co) == dict(
        tiles=5, calls=1, chunk_tiles=5, continuing_tiles=2, chains=1,
        longest_chain_tiles=3, hand_offs=2)
    assert chain_stats(ci, co, chunk_tiles=2) == dict(
        tiles=5, calls=3, chunk_tiles=2, continuing_tiles=2, chains=1,
        longest_chain_tiles=2, hand_offs=1)
