"""The operand builders and the plain-version check of
myfm_tpu_torch/tools/vi_gram.py (the card loop of the Gram kernels: kernel
1's VI layout and kernel 2 at the VI shapes, kernel 1's Gibbs layout and
kernel 3 at the square shape) at a tiny size on the CPU, against the TPU
package's jnp oracles (myfm_tpu/ops/pallas_gram.py
``fused_tile_gram_cross_reference``, ``fused_tile_gram_reference`` and
``tile_gram_reference``; the VI rectangle is the first 2 + R rows of
their full square Gram).  Tolerance: float64 1e-10 of the output's scale
(the same sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myfm_tpu.ops.pallas_gram import (
    fused_tile_gram_cross_reference as jax_cross_reference,
    fused_tile_gram_reference as jax_meta_reference,
    tile_gram_reference as jax_rows_reference,
)
from myfm_tpu_torch.tools import vi_gram

TINY = dict(rank=2, n_rows=600, n_entities=40, device="cpu",
            fixed_ts=(16, 4))


def _jax(ops):
    return [tuple(jnp.asarray(g.numpy()) for g in o) if isinstance(o, list)
            else jnp.asarray(o.numpy()) for o in ops]


@pytest.mark.parametrize("name", list(vi_gram.KERNELS))
def test_operands_are_a_packed_first_chunk(name):
    build = vi_gram.KERNELS[name][0]
    ops, S, kw = build(**TINY)
    R = TINY["rank"]
    K = ops[0].shape[0]
    assert S == 4 and kw["out_rows"] == 2 + R
    assert all(int(f.shape[0]) == K for f in ops[-3:])
    assert int(ops[-3].sum()) > 0  # an entity continues across tiles
    if name.endswith("[vi]"):
        aux2, gths, wvsl = ops[:3]
        assert aux2.shape == (K, 2, 16) and wvsl.shape == (K, S, 2 + R)
        assert [tuple(g.shape) for g in gths] == [(K, 16, 3 + 3 * R)] * 2
        pad = aux2[:, 0] >= S
        assert bool(pad.any()) and all(
            float(g[pad].abs().max()) == 0.0 for g in gths)
    else:
        meta, q_other, slot, wvsl = ops[:4]
        assert meta.shape == (K, 16, 3) and q_other.shape == (K, 16, 3 * R)
        assert slot.dtype == torch.int32 and int(slot.max()) < S
        pad = meta[:, :, 0] == 0
        assert bool(pad.any()) and float(q_other[pad].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(vi_gram.KERNELS))
def test_plain_check_matches_the_jax_oracle(name):
    build, kernel, plain, _ = vi_gram.KERNELS[name]
    ops, S, kw = build(seed=3, **TINY)
    errs = vi_gram.check(kernel, plain, ops, S, kw)
    assert errs == dict.fromkeys(
        ["err_float32", "rel_float32", "err_float64", "rel_float64"], 0.0)
    ops = vi_gram.cast(ops, torch.float64)
    rows = kw["out_rows"]
    D = 3 * TINY["rank"] + 2
    out, carry = plain(*ops, S, **kw)
    assert out.shape == (ops[0].shape[0] * S, rows, D)
    zero = jnp.zeros((D, D), jnp.float64)
    if name.endswith("[vi]"):
        ref, ref_c = jax_cross_reference(*_jax(ops), S, zero, q_lo=2,
                                         n_extra=kw["n_extra"])
    else:
        ref, ref_c = jax_meta_reference(*_jax(ops), S, zero)
    ref = np.asarray(ref)[:, :rows]
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-10 * scale
    assert float(np.abs(carry.numpy() - np.asarray(ref_c)[:rows]).max()
                 ) <= 1e-10 * scale


@pytest.mark.parametrize("name", list(vi_gram.SQUARE_KERNELS))
def test_square_operands_are_a_packed_first_chunk(name):
    build = vi_gram.SQUARE_KERNELS[name][0]
    ops, S, kw = build(**TINY)
    D = TINY["rank"] + 2
    K = ops[0].shape[0]
    assert S == 4 and kw == {}
    assert all(int(f.shape[0]) == K for f in ops[-3:])
    assert int(ops[-3].sum()) > 0  # an entity continues across tiles
    if name == "fused_tile_gram_cross":
        aux2, gths, wvsl = ops[:3]
        assert aux2.shape == (K, 2, 16) and wvsl.shape == (K, S, D)
        assert [tuple(g.shape) for g in gths] == [(K, 16, D)] * 2
        pad = aux2[:, 0] >= S
        assert bool(pad.any()) and all(
            float(g[pad].abs().max()) == 0.0 for g in gths)
    else:
        rows, slot = ops[:2]
        assert rows.shape == (K, 16, D) and slot.shape == (K, 16)
        assert slot.dtype == torch.int32 and int(slot.max()) < S
        aux2 = vi_gram.gibbs_operands(**TINY)[0][0]
        pad = aux2[:, 0] >= S
        assert bool(pad.any()) and float(rows[pad].abs().max()) == 0.0
        assert torch.equal(slot[~pad].float(), aux2[:, 0][~pad])


@pytest.mark.parametrize("name", list(vi_gram.SQUARE_KERNELS))
def test_square_plain_check_matches_the_jax_oracle(name):
    build, kernel, plain, _ = vi_gram.SQUARE_KERNELS[name]
    ops, S, kw = build(seed=3, **TINY)
    errs = vi_gram.check(kernel, plain, ops, S, kw)
    assert errs == dict.fromkeys(
        ["err_float32", "rel_float32", "err_float64", "rel_float64"], 0.0)
    ops = vi_gram.cast(ops, torch.float64)
    D = TINY["rank"] + 2
    out, carry = plain(*ops, S)
    assert out.shape == (ops[0].shape[0] * S, D, D)
    zero = jnp.zeros((D, D), jnp.float64)
    if name == "fused_tile_gram_cross":
        ref, ref_c = jax_cross_reference(*_jax(ops), S, zero, q_lo=1,
                                         n_extra=0)
    else:
        ref, ref_c = jax_rows_reference(*_jax(ops), S, zero)
    scale = max(float(np.abs(np.asarray(ref)).max()), 1.0)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-10 * scale
    assert float(np.abs(carry.numpy() - np.asarray(ref_c)).max()
                 ) <= 1e-10 * scale


def test_device_time_is_the_median_duration_of_each_kernel():
    """Each kernel's median traced duration counts once per call, so a
    trace that lost some events, or holds a stray one, still gives the
    per-call time."""
    durations = {
        "void (anonymous namespace)::gram_tile_kernel<float, true>(...)":
            [800.0, 780.0, 820.0, 810.0, 9000.0],
        "void (anonymous namespace)::carry_segment_kernel<float>(...)":
            [100.0] * 10,
        "void (anonymous namespace)::carry_scan_kernel<float>(...)":
            [150.0] * 10,
        "void (anonymous namespace)::carry_apply_kernel<float>(...)":
            [50.0, 50.0],
        "void at::native::vectorized_elementwise_kernel<...>(...)": [2.0],
    }
    got = vi_gram.kernel_split(durations, reps=10)
    assert got["pass1_ms"] == pytest.approx(0.81)
    assert got["carry_ms"] == pytest.approx(0.3)
    assert got["other_ms"] == pytest.approx(0.002)
    assert got["device_ms"] == pytest.approx(1.112)
    assert got["captured"] == pytest.approx(28 / 50)


_PASS1 = "void (anonymous namespace)::gram_meta_tile_kernel<float, true>()"
_CARRY = "void (anonymous namespace)::carry_scan_kernel<float>()"


@pytest.mark.parametrize("durations", [
    {},  # no kernel at all
    {_PASS1: [10.0] * 10},  # the carry lost
    {_CARRY: [10.0] * 10},  # pass 1 lost
    {_PASS1: [10.0] * 4, _CARRY: [10.0] * 5},  # under half the events
    {_PASS1: [10.0] * 16, _CARRY: [10.0] * 15},  # over 1.5 times
], ids=["empty", "no-carry", "no-pass1", "too-few", "too-many"])
def test_device_time_refuses_an_incomplete_trace(durations):
    with pytest.raises(ValueError, match="incomplete trace"):
        vi_gram.kernel_split(durations, reps=10)


def test_device_time_retakes_traces_without_kernels(monkeypatch):
    """A warm-up call, one call traced to take what earlier traces left,
    then up to ``attempts`` traces of ``reps`` calls; none holds a CUDA
    kernel here, so it raises."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    with pytest.raises(RuntimeError, match="2 traces, none whole"):
        vi_gram.device_ms(lambda: calls.append(1), reps=3, attempts=2)
    assert len(calls) == 1 + 1 + 3 * 2


def test_main_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vi_gram.main([]) == 1
