"""Kernel 3 (``tile_gram``) and the two probes of kernel 1 (kernels 5 and
6) through their plain PyTorch versions in myfm_tpu_torch/ops/gram.py,
against the TPU package's ``entity_grams`` / ``tile_gram_reference``
(Pallas in interpret mode) and against numpy; and the kernel build's
source hash.

Tolerances: float64 1e-10 and float32 1e-5 of each Gram's scale (the
same sums in another order); the section levels against numpy at 1e-12
(float64); the probe bit for bit.  The CUDA kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myfm_tpu.design_categorical import (
    compile_categorical_table as jax_compile_table,
)
from myfm_tpu.ops.pallas_gram import entity_grams as jax_entity_grams
from myfm_tpu.ops.pallas_gram import tile_gram_reference as jax_tile_ref
from myfm_tpu_torch.design_categorical import compile_categorical_table
from myfm_tpu_torch.ops import _build, gram

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _tile_rows(src, n_tiles, T, z):
    zpad = np.concatenate([z, np.zeros((1, z.shape[1]), z.dtype)])
    return zpad[np.minimum(np.asarray(src), z.shape[0])].reshape(
        n_tiles, T, z.shape[1])


def _close(got, want, dtype, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= TOL[dtype] * scale, name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (1024, 8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_entity_grams_match_jax(T, S, seed, dtype):
    rng = np.random.RandomState(seed)
    N, B, D = 700, 29, 5
    ent = rng.randint(0, B, N)
    ent[ent == 7] = 8  # an entity with zero rows
    jt = jax_compile_table(ent, B, 0, N, dtype, fixed_ts=(T, S),
                           derive_src_on_device=False)
    pt = compile_categorical_table(ent, B, 0, N, dtype, "cpu",
                                   fixed_ts=(T, S))
    z = rng.normal(size=(N, D)).astype(dtype)
    rows = _tile_rows(pt.src, pt.n_tiles, pt.tile_rows, z)
    ours = gram.entity_grams(pt, torch.as_tensor(rows), S, D, plain=True)
    want = jax_entity_grams(jt, jnp.asarray(rows), S, D, interpret=True)
    _close(ours.numpy(), want, dtype, "entity_grams")
    flat, carry = gram.tile_gram_reference(
        torch.as_tensor(rows), pt.slot.view(pt.n_tiles, T), pt.cont_in,
        pt.cont_out, pt.last_slot, S)
    jflat, jcarry = jax_tile_ref(
        jnp.asarray(rows), jnp.asarray(jt.slot).reshape(jt.n_tiles, T),
        jt.cont_in, jt.cont_out, jt.last_slot, S)
    _close(flat.numpy(), jflat, dtype, "flat")
    _close(carry.numpy(), jcarry, dtype, "carry")
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        gram.entity_grams(pt, torch.as_tensor(rows), S, D).numpy(),
        ours.numpy())
    # and every entity's Gram is the numpy one
    for u in (0, 7, 8, B - 1):
        r = z[ent == u].astype(np.float64)
        _close(ours[u].numpy(), r.T @ r, dtype, f"entity {u}")


def test_two_chunk_carry_and_default_carry():
    """Splitting the tiles into two calls, the first's carry handed to
    the second, gives the one-call Grams; ``carry_in=None`` is a zero
    carry (the TPU reference's None path raises, ROADMAP Queue C)."""
    rng = np.random.RandomState(5)
    N, B, D, T, S = 500, 7, 4, 16, 2
    ent = np.sort(rng.randint(0, B, N))
    pt = compile_categorical_table(ent, B, 0, N, np.float64, "cpu",
                                   fixed_ts=(T, S))
    rows = torch.as_tensor(_tile_rows(pt.src, pt.n_tiles, T,
                                      rng.normal(size=(N, D))))
    slot = pt.slot.view(pt.n_tiles, T)
    args = (pt.cont_in, pt.cont_out, pt.last_slot)
    whole, carry = gram.tile_gram(rows, slot, *args, S)
    k = pt.n_tiles // 2
    assert int(pt.cont_out[k - 1]) == 1  # the split cuts an entity
    a, ca = gram.tile_gram(rows[:k], slot[:k], *(x[:k] for x in args), S)
    b, cb = gram.tile_gram(rows[k:], slot[k:], *(x[k:] for x in args), S,
                           carry_in=ca)
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), whole.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cb.numpy(), carry.numpy(), rtol=1e-12)
    zero, _ = gram.tile_gram(rows, slot, *args, S,
                             carry_in=torch.zeros(D, D, dtype=rows.dtype))
    np.testing.assert_array_equal(zero.numpy(), whole.numpy())


def _kernel1_operands(rng, K=6, T=32, S=4, R=3, n_cross=2):
    slot = np.sort(rng.randint(0, S, (K, T)), axis=1).astype(np.float64)
    slot[:, -3:] = S  # pad rows
    aux2 = np.stack([slot, rng.normal(size=(K, T))], axis=1)
    gths = [rng.normal(size=(K, T, R + 2)) * 0.5 for _ in range(n_cross)]
    wvsl = rng.normal(size=(K, S, R + 2)) * 0.5
    ci = (rng.random_sample(K) > 0.5).astype(np.int32)
    co = (rng.random_sample(K) > 0.5).astype(np.int32)
    ls = np.full(K, S - 1, np.int32)
    return aux2, gths, wvsl, ci, co, ls, S


def _numpy_grams(z, slot, S):
    K, T, D = z.shape
    out = np.zeros((K, S, D, D))
    for k in range(K):
        for s in range(S):
            r = z[k][slot[k] == s]
            out[k, s] = r.T @ r
    return out


def test_section_levels_match_numpy():
    rng = np.random.RandomState(0)
    aux2, gths, wvsl, ci, co, ls, S = _kernel1_operands(rng)
    K, _, T = aux2.shape
    D = wvsl.shape[2]
    ops = [torch.as_tensor(aux2), [torch.as_tensor(g) for g in gths],
           torch.as_tensor(wvsl)] + [torch.as_tensor(x) for x in (ci, co, ls)]
    slot = aux2[:, 0].astype(int)
    total = sum(g.sum(axis=(1, 2)) for g in gths) + wvsl.sum(axis=(1, 2)) \
        + aux2.sum(axis=(1, 2))
    out0, c0 = gram.gram_section(0, *ops, S)
    assert c0 is None
    np.testing.assert_allclose(
        out0.numpy().reshape(K, S, D, D),
        np.broadcast_to(total[:, None, None, None], (K, S, D, D)),
        rtol=1e-12)
    want1 = _numpy_grams(gths[0], slot, S)
    want1[:, 0, 0, 0] += total
    out1, _ = gram.gram_section(1, *ops, S)
    np.testing.assert_allclose(out1.numpy().reshape(K, S, D, D), want1,
                               rtol=1e-12, atol=1e-12)
    z, _ = gram.cross_rows(ops[0], ops[1], ops[2], S)
    out2, _ = gram.gram_section(2, *ops, S)
    np.testing.assert_allclose(out2.numpy().reshape(K, S, D, D),
                               _numpy_grams(z.numpy(), slot, S),
                               rtol=1e-12, atol=1e-12)
    out3, c3 = gram.gram_section(3, *ops, S)
    ref3, rc3 = gram.fused_tile_gram_cross(*ops, S)
    np.testing.assert_array_equal(out3.numpy(), ref3.numpy())
    np.testing.assert_array_equal(c3.numpy(), rc3.numpy())
    with pytest.raises(ValueError, match="level"):
        gram.gram_section(4, *ops, S)


@pytest.mark.parametrize("shape", [(4, 2, 256), (3, 2, 1000)])
def test_interleave_probe_matches_numpy(shape):
    x = np.random.RandomState(1).normal(size=shape).astype(np.float32)
    for variant in gram.PROBE_VARIANTS:
        got = gram.interleave_probe(torch.as_tensor(x), variant).numpy()
        np.testing.assert_array_equal(got, np.transpose(x, (0, 2, 1)))
    with pytest.raises(ValueError, match="variant"):
        gram.interleave_probe(torch.as_tensor(x), "dot")


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header included by a source gives that source a new
    library name; a source that does not include it keeps its name."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = [p.name for p in _build.source_files("gram_sections")]
    assert names == ["gram_sections.cu", "gram_tile.cuh"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = tmp_path / "gram_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after["fused_gram_cross"] != before["fused_gram_cross"]
    assert after["gram_sections"] != before["gram_sections"]
    assert after["joint_tail"] == before["joint_tail"]
