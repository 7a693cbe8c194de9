"""The port's Gram kernels in their VI uses (myfm_tpu_torch/ops/gram.py)
against the TPU package's (myfm_tpu/ops/pallas_gram.py):

* kernel 1, ``fused_tile_gram_cross``, in the VI layout (q_lo = 2,
  n_extra = 2R, the [2 + R, D] rectangle of D = 3R + 2);
* kernel 2, ``fused_tile_gram``, the separate-meta variant, with the full
  square and with the rectangle.

Inputs are made with numpy from a seed on a real tile packing (an entity
whose rows span a chain of tiles, pad rows, a row-less entity) and fed to
both packages; the JAX kernels run in interpret mode.  Tolerances: float64
1e-10 of the output's scale (the same sums in another order, ~1e-15
relative); float32 1e-5 of scale (fp32 rounding over sums of at most a few
hundred rows).  The CUDA kernels are held against the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myfm_tpu.ops.pallas_gram import (
    fused_tile_gram as jax_meta_gram,
    fused_tile_gram_cross as jax_gram,
    fused_tile_gram_cross_reference as jax_gram_reference,
    fused_tile_gram_reference as jax_meta_reference,
)
from myfm_tpu_torch.design_categorical import compile_categorical_table
from myfm_tpu_torch.ops import gram


def _packing(T, S, seed, dtype, N=300, B=19):
    """A real packing: entity 2 owns a quarter of the rows (a chain of
    tiles), entity 5 none."""
    rng = np.random.RandomState(seed)
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6
    ent[: N // 4] = 2
    tab = compile_categorical_table(ent, B, 0, N, dtype, "cpu", rank=3,
                                    fixed_ts=(T, S))
    assert tab.cont_in.numpy().sum() > 0
    flags = [tab.cont_in.numpy(), tab.cont_out.numpy(),
             tab.last_slot.numpy()]
    return rng, tab, flags


def _vi_problem(T, S, n_cross, R, seed, dtype=np.float64):
    """Kernel 1 operands in the VI layout: gathered rows
    [w | wvar | V | σ | sv | qs] (3 + 3R columns), own [w | V | qs]."""
    rng, tab, flags = _packing(T, S, seed, dtype)
    K = tab.n_tiles
    slot_f = tab.slot_f.numpy().reshape(K, T)
    valid = (slot_f < S)[:, :, None]
    gths = []
    for _ in range(n_cross):
        V = rng.normal(size=(K, T, R))
        s = rng.random((K, T, R)) * 0.3 + 0.05
        body = np.concatenate(
            [rng.normal(size=(K, T, 1)), rng.random((K, T, 1)), V, s,
             s * V, (V * V).sum(axis=2, keepdims=True)], axis=2)
        gths.append((body * valid).astype(dtype))
    wv = rng.normal(size=(K, S, 1 + R))
    wvsl = np.concatenate(
        [wv, (wv[:, :, 1:] ** 2).sum(axis=2, keepdims=True)], axis=2
    ).astype(dtype)
    aux2 = np.stack([slot_f, rng.normal(size=(K, T)) * valid[:, :, 0]],
                    axis=1).astype(dtype)
    D = 3 * R + 2
    carry = rng.normal(size=(2 + R, D)).astype(dtype)
    return aux2, gths, wvsl, flags, S, carry


def _t(a):
    return torch.as_tensor(a)


def _port_vi(args, fn=gram.fused_tile_gram_cross):
    aux2, gths, wvsl, flags, S, carry = args
    R = wvsl.shape[2] - 2
    out, c = fn(_t(aux2), [_t(g) for g in gths], _t(wvsl),
                *[_t(f) for f in flags], S, _t(carry), q_lo=2,
                n_extra=2 * R, out_rows=2 + R)
    return out.numpy(), c.numpy()


def _close(a, b, tol):
    scale = max(float(np.abs(b).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("T,S,n_cross", [(16, 2, 1), (32, 4, 3)])
def test_vi_layout_plain_matches_jax_f64(R, T, S, n_cross):
    """The port's rectangle equals the first 2+R rows of JAX's kernel
    output (interpret mode, 8-row padded slots) and of its full-square
    jnp reference."""
    args = _vi_problem(T, S, n_cross, R, seed=T + R + n_cross)
    aux2, gths, wvsl, flags, S, carry = args
    rows, D = carry.shape
    out, c = _port_vi(args)
    assert out.shape[1:] == (rows, D) and c.shape == (rows, D)
    Dpr = -(-rows // 8) * 8
    cpad = np.zeros((Dpr, D))
    cpad[:rows] = carry
    common = (jnp.asarray(aux2), tuple(jnp.asarray(g) for g in gths),
              jnp.asarray(wvsl), *[jnp.asarray(f) for f in flags])
    ref, ref_c = jax_gram(*common, S=S, carry_in=jnp.asarray(cpad),
                          interpret=True, q_lo=2, n_extra=2 * R,
                          out_rows=rows)
    _close(out, np.asarray(ref)[:, :rows], 1e-10)
    _close(c, np.asarray(ref_c)[:rows], 1e-10)
    full_c = np.zeros((D, D))
    full_c[:rows] = carry
    ref2, ref2_c = jax_gram_reference(*common, S, jnp.asarray(full_c),
                                      q_lo=2, n_extra=2 * R)
    _close(out, np.asarray(ref2)[:, :rows], 1e-10)
    _close(c, np.asarray(ref2_c)[:rows], 1e-10)


def test_vi_layout_plain_matches_jax_f32():
    args = _vi_problem(32, 4, 2, 3, seed=9, dtype=np.float32)
    aux2, gths, wvsl, flags, S, carry = args
    out, c = _port_vi(args)
    ref, ref_c = jax_gram(
        jnp.asarray(aux2), tuple(jnp.asarray(g) for g in gths),
        jnp.asarray(wvsl), *[jnp.asarray(f) for f in flags], S=S,
        carry_in=jnp.asarray(np.pad(carry, ((0, 3), (0, 0)))),
        interpret=True, q_lo=2, n_extra=6, out_rows=5,
    )
    _close(out, np.asarray(ref)[:, :5], 1e-5)
    _close(c, np.asarray(ref_c)[:5], 1e-5)


def test_gibbs_layout_is_the_full_square_case():
    """q_lo = 1, n_extra = 0 and out_rows = D give the Gibbs kernel's
    output: the rectangle code path reduces to the square one."""
    rng, tab, flags = _packing(16, 2, 4, np.float64)
    K, T, S, R = tab.n_tiles, 16, 2, 3
    slot_f = tab.slot_f.numpy().reshape(K, T)
    gths = [_t(rng.normal(size=(K, T, R + 2)))]
    aux2 = _t(np.stack([slot_f, rng.normal(size=(K, T))], axis=1))
    wvsl = _t(rng.normal(size=(K, S, R + 2)))
    fl = [_t(f) for f in flags]
    a = gram.fused_tile_gram_cross(aux2, gths, wvsl, *fl, S)
    b = gram.fused_tile_gram_cross(aux2, gths, wvsl, *fl, S, out_rows=R + 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _meta_problem(T, S, R, Rq, seed, dtype=np.float64):
    """Kernel 2 operands: meta [ones | lin−τ | qs_other] with ones = 0 on
    pad rows (whose slot is 0, as in the packing), q_other [K, T, Rq],
    own [w | V] per slot."""
    rng, tab, flags = _packing(T, S, seed, dtype)
    K = tab.n_tiles
    slot = tab.slot.numpy().reshape(K, T)
    ones = (tab.src.numpy().reshape(K, T) < 300).astype(dtype)
    meta = np.stack([ones, rng.normal(size=(K, T)) * ones,
                     rng.random((K, T)) * ones], axis=2).astype(dtype)
    q_other = (rng.normal(size=(K, T, Rq)) * ones[:, :, None]).astype(dtype)
    wvsl = rng.normal(size=(K, S, 1 + R)).astype(dtype)
    return meta, q_other, slot, wvsl, flags, S


@pytest.mark.parametrize("out_rows", [None, "2+R"])
@pytest.mark.parametrize("R,T,S", [(1, 16, 2), (3, 32, 4)])
def test_meta_kernel_plain_matches_jax_f64(out_rows, R, T, S):
    meta, q_other, slot, wvsl, flags, S = _meta_problem(
        T, S, R, 4 * R, seed=R + T)
    D = 4 * R + 2
    rows = D if out_rows is None else 2 + R
    rng = np.random.RandomState(R)
    carry = rng.normal(size=(rows, D))
    kw = {} if out_rows is None else dict(out_rows=rows)
    out, c = gram.fused_tile_gram(
        _t(meta), _t(q_other), _t(slot), _t(wvsl),
        *[_t(f) for f in flags], S, _t(carry), **kw)
    assert out.shape[1:] == (rows, D) and c.shape == (rows, D)
    Dpr = -(-rows // 8) * 8 if out_rows is not None else D
    cpad = np.zeros((Dpr, D))
    cpad[:rows] = carry
    common = (jnp.asarray(meta), jnp.asarray(q_other), jnp.asarray(slot),
              jnp.asarray(wvsl), *[jnp.asarray(f) for f in flags])
    ref, ref_c = jax_meta_gram(*common, S=S, carry_in=jnp.asarray(cpad),
                               interpret=True, **kw)
    _close(out.numpy(), np.asarray(ref)[:, :rows], 1e-10)
    _close(c.numpy(), np.asarray(ref_c)[:rows], 1e-10)
    full_c = np.zeros((D, D))
    full_c[:rows] = carry
    ref2, ref2_c = jax_meta_reference(*common, S, jnp.asarray(full_c))
    _close(out.numpy(), np.asarray(ref2)[:, :rows], 1e-10)
    _close(c.numpy(), np.asarray(ref2_c)[:rows], 1e-10)


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    counts = (gram.fused_tile_gram_cross.launches,
              gram.fused_tile_gram_cross.vi_launches,
              gram.fused_tile_gram.launches)
    args = _vi_problem(16, 2, 2, 2, seed=1)
    np.testing.assert_array_equal(
        _port_vi(args)[0],
        _port_vi(args, gram.fused_tile_gram_cross_reference)[0])
    meta, q_other, slot, wvsl, flags, S = _meta_problem(16, 2, 2, 8, 2)
    ops = [_t(a) for a in (meta, q_other, slot, wvsl, *flags)]
    a = gram.fused_tile_gram(*ops, S, out_rows=4)
    b = gram.fused_tile_gram_reference(*ops, S, out_rows=4)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert counts == (gram.fused_tile_gram_cross.launches,
                      gram.fused_tile_gram_cross.vi_launches,
                      gram.fused_tile_gram.launches)


def test_meta_kernel_other_devices_raise_instead_of_falling_back():
    meta, q_other, slot, wvsl, flags, S = _meta_problem(16, 2, 2, 8, 3)

    def dev(a):
        return torch.empty(a.shape, dtype=torch.as_tensor(a).dtype,
                           device="meta")

    with pytest.raises(ValueError, match="not supported"):
        gram.fused_tile_gram(dev(meta), dev(q_other), dev(slot), dev(wvsl),
                             *[dev(f) for f in flags], S)
