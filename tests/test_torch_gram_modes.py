"""The reduced-precision Gram modes ("split", "bf16") of the port's
kernels 1, 2 and 5 (myfm_tpu_torch/ops/gram.py) against the TPU
package's (myfm_tpu/ops/pallas_gram.py, fast_matmul=mode, in interpret
mode), and the modes' resolution (trainer._resolve_gram_fast_matmul).

Both packages split every operand into hi = bf16(x) and lo = bf16(x −
hi) (round to nearest even, the same bits in both) and form hi·hi +
hi·lo + lo·hi ("split") or hi·hi ("bf16") in the operands' dtype, so the
same inputs give the same sums in another order.  Tolerances, as a share
of the output's largest entry: 1e-12 in float64 and 1e-6 in float32 (the
f32 rounding of sums of at most a few hundred exact products).  Passes
and sweeps that draw from the Grams keep the IEEE tests' 1e-10 (float64).
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.design_categorical import (
    try_compile_categorical as jax_try_compile,
)
from myfm_tpu.ops import categorical as jcat
from myfm_tpu.ops import categorical_vi as jvi
from myfm_tpu.ops.gibbs import GibbsConfig as JaxConfig
from myfm_tpu.ops.pallas_gram import (
    fused_tile_gram as jax_meta_gram,
    fused_tile_gram_cross as jax_gram,
    gram_fast_selfcheck as jax_selfcheck,
)
from myfm_tpu.ops.variational import VariationalConfig as JaxVIConfig
from myfm_tpu.trainer import _resolve_gram_fast_matmul as jax_resolve
from myfm_tpu_torch.design_categorical import (
    compile_categorical_table,
    try_compile_categorical,
)
from myfm_tpu_torch.ops import categorical as tcat
from myfm_tpu_torch.ops import categorical_vi as tvi
from myfm_tpu_torch.ops import gram
from myfm_tpu_torch.ops.gibbs import GibbsConfig
from myfm_tpu_torch.ops.variational import VariationalConfig
from myfm_tpu_torch.trainer import (
    CategoricalGibbsTrainer,
    _resolve_gram_fast_matmul,
)

from .vi_cases import HYP, ORDER, close, moments, onehot_plans

MODES = ("split", "bf16")
TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _t(a):
    return torch.as_tensor(a)


def _j(a):
    return jnp.asarray(a)


def _packing(T, S, seed, dtype, N, B):
    """A real packing: entity 2 owns a quarter of the rows (a chain of
    tiles), entity 5 none; with S = 1 and T = 16 most runs are shorter
    than the kernel's 16-row k-chunk only where an entity ends."""
    rng = np.random.RandomState(seed)
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6
    ent[: N // 4] = 2
    tab = compile_categorical_table(ent, B, 0, N, dtype, "cpu", rank=3,
                                    fixed_ts=(T, S))
    flags = [tab.cont_in.numpy(), tab.cont_out.numpy(),
             tab.last_slot.numpy()]
    return rng, tab, flags


def _cross_problem(T, S, R, n_cross, seed, dtype, vi):
    """Kernel 1's operands in the Gibbs layout ([lin | V | qs] gathered
    rows) or the VI layout ([w | wvar | V | σ | sv | qs]), and a carry."""
    rng, tab, flags = _packing(T, S, seed, dtype, N=300, B=19)
    K = tab.n_tiles
    slot_f = tab.slot_f.numpy().reshape(K, T)
    valid = (slot_f < S)[:, :, None]
    gths = []
    for _ in range(n_cross):
        V = rng.normal(size=(K, T, R))
        if vi:
            s = rng.random((K, T, R)) * 0.3 + 0.05
            body = np.concatenate(
                [rng.normal(size=(K, T, 1)), rng.random((K, T, 1)), V, s,
                 s * V, (V * V).sum(axis=2, keepdims=True)], axis=2)
        else:
            body = np.concatenate(
                [rng.normal(size=(K, T, 1)), V,
                 (V * V).sum(axis=2, keepdims=True)], axis=2)
        gths.append((body * valid).astype(dtype))
    wv = rng.normal(size=(K, S, 1 + R))
    wvsl = np.concatenate(
        [wv, (wv[:, :, 1:] ** 2).sum(axis=2, keepdims=True)], axis=2
    ).astype(dtype)
    aux2 = np.stack([slot_f, rng.normal(size=(K, T)) * valid[:, :, 0]],
                    axis=1).astype(dtype)
    D = (3 * R + 2) if vi else (R + 2)
    rows = (R + 2) if vi else D
    carry = rng.normal(size=(rows, D)).astype(dtype)
    return aux2, gths, wvsl, flags, S, carry


def _pad_rows(carry, rows):
    """The carry with the TPU kernel's 8-row padding of a rectangle."""
    Dpr = -(-rows // 8) * 8
    out = np.zeros((Dpr, carry.shape[1]), carry.dtype)
    out[:rows] = carry
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T,S,R,n_cross", [(16, 1, 3, 1), (32, 4, 4, 2),
                                           (64, 4, 6, 2)])
@pytest.mark.parametrize("vi", [False, True], ids=["gibbs", "vi"])
def test_kernel1_modes_match_jax(vi, T, S, R, n_cross, mode, dtype):
    """Kernel 1's plain version in each mode equals the JAX kernel in
    interpret mode: the Gibbs square and the VI rectangle (q_lo = 2,
    n_extra = 2R, out_rows = R + 2), with the carry threaded through a
    chain of tiles."""
    aux2, gths, wvsl, flags, S, carry = _cross_problem(
        T, S, R, n_cross, T + R + S, dtype, vi)
    rows, D = carry.shape
    kw = dict(q_lo=2, n_extra=2 * R, out_rows=rows) if vi else {}
    out, c = gram.fused_tile_gram_cross(
        _t(aux2), [_t(g) for g in gths], _t(wvsl), *[_t(f) for f in flags],
        S, _t(carry), fast_matmul=mode, **kw)
    ref, ref_c = jax_gram(
        _j(aux2), tuple(_j(g) for g in gths), _j(wvsl),
        *[_j(f) for f in flags], S=S,
        carry_in=_j(_pad_rows(carry, rows) if vi else carry),
        interpret=True, fast_matmul=mode, **kw)
    close(out.numpy(), np.asarray(ref)[:, :rows], TOL[dtype], "out")
    close(c.numpy(), np.asarray(ref_c)[:rows], TOL[dtype], "carry")


def _meta_problem(T, S, R, Rq, seed, dtype):
    """Kernel 2's operands: meta [ones | lin−τ | qs_other] with ones = 0
    on pad rows, q_other [K, T, Rq], own [w | V]."""
    rng, tab, flags = _packing(T, S, seed, dtype, N=300, B=19)
    K = tab.n_tiles
    slot = tab.slot.numpy().reshape(K, T)
    ones = (tab.src.numpy().reshape(K, T) < 300).astype(dtype)
    meta = np.stack([ones, rng.normal(size=(K, T)) * ones,
                     rng.random((K, T)) * ones], axis=2).astype(dtype)
    q_other = (rng.normal(size=(K, T, Rq)) * ones[:, :, None]).astype(dtype)
    wvsl = rng.normal(size=(K, S, 1 + R)).astype(dtype)
    return meta, q_other, slot, wvsl, flags, rng


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T,S,R", [(16, 1, 2), (32, 4, 3)])
@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_kernel2_modes_match_jax(rect, T, S, R, mode, dtype):
    """Kernel 2's plain version in each mode equals the JAX kernel in
    interpret mode, in the full square and the rectangle."""
    meta, q_other, slot, wvsl, flags, rng = _meta_problem(
        T, S, R, 4 * R, T + R, dtype)
    D = 4 * R + 2
    rows = 2 + R if rect else D
    carry = rng.normal(size=(rows, D)).astype(dtype)
    kw = dict(out_rows=rows) if rect else {}
    out, c = gram.fused_tile_gram(
        _t(meta), _t(q_other), _t(slot), _t(wvsl), *[_t(f) for f in flags],
        S, _t(carry), fast_matmul=mode, **kw)
    ref, ref_c = jax_meta_gram(
        _j(meta), _j(q_other), _j(slot), _j(wvsl), *[_j(f) for f in flags],
        S=S, carry_in=_j(_pad_rows(carry, rows) if rect else carry),
        interpret=True, fast_matmul=mode, **kw)
    close(out.numpy(), np.asarray(ref)[:, :rows], TOL[dtype], "out")
    close(c.numpy(), np.asarray(ref_c)[:rows], TOL[dtype], "carry")


def _variant_dot(a, zd, mode, dtype):
    """The TPU microbench's Gram product (scripts/
    microbench_kernel_sections.py variant_kernel): a [T, S*D] masked
    rows, zd [T, D] -> [S*D, D] in ``mode``."""
    def bdot(x, y):
        return jax.lax.dot_general(
            x, y, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=dtype)

    a_hi = a.astype(jnp.bfloat16)
    z_hi = zd.astype(jnp.bfloat16)
    if mode == "bf16":
        return bdot(a_hi, z_hi)
    a_lo = (a - a_hi.astype(dtype)).astype(jnp.bfloat16)
    z_lo = (zd - z_hi.astype(dtype)).astype(jnp.bfloat16)
    return bdot(a_hi, z_hi) + bdot(a_hi, z_lo) + bdot(a_lo, z_hi)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_kernel5_levels_match_the_tpu_arithmetic(level, mode, dtype):
    """Kernel 5's plain version at levels 1-3 in each mode: level 1 is the
    TPU microbench's mode product of the masked rows (its checksum
    added at [slot 0, 0, 0]), level 2 the JAX kernel 1 without the carry
    (zero flags), level 3 the JAX kernel 1 whole, all in ``mode``."""
    aux2, gths, wvsl, flags, S, _ = _cross_problem(32, 4, 4, 2, 11, dtype,
                                                   vi=False)
    K, _, T = aux2.shape
    D = wvsl.shape[2]
    ops = [_t(aux2), [_t(g) for g in gths], _t(wvsl)] + [_t(f)
                                                         for f in flags]
    out, carry = gram.gram_section(level, *ops, S, mode)
    if level == 1:
        slot = aux2[:, 0, :].astype(np.int64)
        m = (slot[:, :, None] == np.arange(S)).astype(dtype)
        want = np.stack([
            np.asarray(_variant_dot(
                _j((m[k][:, :, None] * gths[0][k][:, None, :]).reshape(
                    T, S * D)), _j(gths[0][k]), mode, dtype))
            for k in range(K)]).reshape(K, S, D, D)
        total = (sum(g.sum(axis=(1, 2)) for g in gths)
                 + wvsl.sum(axis=(1, 2)) + aux2.sum(axis=(1, 2)))
        want[:, 0, 0, 0] += total
        close(out.numpy(), want.reshape(K * S, D, D), TOL[dtype])
        return
    zero = np.zeros(K, np.int32)
    fl = flags if level == 3 else (zero, zero, flags[2])
    ref, ref_c = jax_gram(
        _j(aux2), tuple(_j(g) for g in gths), _j(wvsl), *[_j(f) for f in fl],
        S=S, carry_in=_j(np.zeros((D, D), dtype)), interpret=True,
        fast_matmul=mode)
    Dp = -(-D // 8) * 8
    close(out.numpy(), np.asarray(ref).reshape(K * S, Dp, D)[:, :D],
          TOL[dtype])
    if level == 3:
        close(carry.numpy(), np.asarray(ref_c), TOL[dtype])
        prod, _ = gram.fused_tile_gram_cross(*ops, S, fast_matmul=mode)
        np.testing.assert_array_equal(out.numpy(), prod.numpy())


def test_mode_values_normalise_as_the_tpu_kernels_do():
    assert gram.gram_mode(False) == gram.gram_mode(None) == "highest"
    assert gram.gram_mode(True) == "split"
    for mode in gram.GRAM_MODES:
        assert gram.gram_mode(mode) == mode
    with pytest.raises(ValueError, match="not one of"):
        gram.gram_mode("tf32")
    with pytest.raises(ValueError, match="no Gram mode"):
        aux2, gths, wvsl, flags, S, _ = _cross_problem(
            16, 2, 2, 1, 1, np.float32, vi=False)
        gram.gram_section(0, _t(aux2), [_t(g) for g in gths], _t(wvsl),
                          *[_t(f) for f in flags], S, "split")


def _hyper(rng, F, R, G_n):
    return dict(
        lambda_w=rng.random(G_n) + 0.5, mu_w=rng.normal(size=G_n) * 0.1,
        lambda_V=rng.random((G_n, R)) + 0.5,
        mu_V=rng.normal(size=(G_n, R)) * 0.1,
        noise_w=rng.normal(size=F), noise_V=rng.normal(size=(F, R)),
    )


@pytest.mark.parametrize("mode", MODES)
def test_table_pass_in_mode_matches_jax(mode):
    """Both table passes of a two-table design in ``mode``, chained, f64,
    with the same weights, hyperparameters and noise: the port's
    _table_pass equals JAX's (interpret-mode kernel in that mode)."""
    rng = np.random.RandomState(1)
    N, B1, B2, R, G_n = 300, 11, 7, 3, 2
    X = sps.hstack([
        sps.csr_matrix((np.ones(N), (np.arange(N), rng.randint(0, b, N))),
                       shape=(N, b)) for b in (B1, B2)]).tocsr()
    grouping = np.asarray([0] * B1 + [1] * B2, np.int32)
    jp = jax_try_compile(X, [], grouping, None, np.float64, rank=R,
                         fixed_ts=(32, 4))
    pp = try_compile_categorical(X, [], grouping, None, np.float64, "cpu",
                                 rank=R, fixed_ts=(32, 4))
    F = B1 + B2
    w, V = rng.normal(size=F), rng.normal(size=(F, R))
    tau = rng.normal(size=N)
    h = _hyper(rng, F, R, G_n)
    jcfg = JaxConfig(task="regression", gram_fast_matmul=mode)
    pcfg = GibbsConfig(task="regression", gram_fast_matmul=mode)
    jt = jcat.make_y_tiles(jp, _j(tau))
    pt = tcat.make_y_tiles(pp, _t(tau))
    wj, Vj, wp, Vp = _j(w), _j(V), _t(w), _t(V)
    names = ("lambda_w", "mu_w", "lambda_V", "mu_V")
    for ti in range(2):
        last = ti == 1
        wj, Vj, mj = jcat._table_pass(
            jp, ti, wj, Vj, 0.4, 1.7, *[_j(h[k]) for k in names],
            jp.group_index, _j(h["noise_w"]), _j(h["noise_V"]), jt[ti],
            jcfg, True, want_moments=last)
        wp, Vp, mp = tcat._table_pass(
            pp, ti, wp, Vp, 0.4, 1.7, *[_t(h[k]) for k in names],
            pp.group_index, _t(h["noise_w"]), _t(h["noise_V"]), pt[ti],
            pcfg, want_moments=last)
    close(wp, np.asarray(wj), 1e-10, "w")
    close(Vp, np.asarray(Vj), 1e-10, "V")
    for a, b in zip(mp, mj):
        close(a, np.asarray(b), 1e-10, "moments")
    # the mode reached the Grams: IEEE gives another result
    pcfg_ieee = dataclasses.replace(pcfg, gram_fast_matmul=False)
    wi, _, _ = tcat._table_pass(
        pp, 0, _t(w), _t(V), 0.4, 1.7, *[_t(h[k]) for k in names],
        pp.group_index, _t(h["noise_w"]), _t(h["noise_V"]), pt[0],
        pcfg_ieee)
    w1, _, _ = tcat._table_pass(
        pp, 0, _t(w), _t(V), 0.4, 1.7, *[_t(h[k]) for k in names],
        pp.group_index, _t(h["noise_w"]), _t(h["noise_V"]), pt[0], pcfg)
    assert not torch.equal(wi, w1)


def test_vi_table_pass_in_split_matches_jax():
    """The three one-hot tables' VI passes in "split" (kernel 1's VI
    layout), f64, from the same moments: the port's _vi_table_pass
    equals JAX's."""
    jp, pp, y, rng = onehot_plans()
    m = moments(rng, pp.n_features, pp.n_groups)
    jcfg = JaxVIConfig(gram_fast_matmul="split")
    pcfg = VariationalConfig(gram_fast_matmul="split")
    for ti in range(3):
        jm = [_j(m[k]) for k in ORDER]
        pm = [_t(m[k]) for k in ORDER]
        jt = jcat.make_y_tiles(jp, _j(y))[ti]
        pt = tcat.make_y_tiles(pp, _t(y))[ti]
        got = tvi._vi_table_pass(pp, ti, *pm, 0.4, 1.7,
                                 *[_t(m[k]) for k in HYP], pp.group_index,
                                 pt, pcfg, None)
        want = jvi._vi_table_pass(jp, ti, *jm, 0.4, 1.7,
                                  *[_j(m[k]) for k in HYP], jp.group_index,
                                  jt, jcfg, True, None)
        for name, a, b in zip(ORDER, got, want):
            close(a, b, 1e-10, name)


def test_forced_bf16_chain_recovers_the_signal():
    """The port of the TPU package's forced-bf16 chain
    (tests/test_categorical.py test_gram_bf16_mode_error_bound_and_
    recovery): kernel 2 in "bf16" within 2e-2 of IEEE at kernel level,
    and a fast-path chain with gram_fast_matmul="bf16" recovers planted
    one-hot effects (RMSE < 0.45 against a noise floor of 0.3)."""
    rng = np.random.RandomState(5)
    K, T, S, R = 2, 32, 4, 6
    meta = rng.normal(size=(K, T, 3)).astype(np.float32)
    meta[:, :, 0] = 1.0
    q = (rng.normal(size=(K, T, R)) * 0.4).astype(np.float32)
    slot = np.sort(rng.randint(0, S, (K, T)), axis=1).astype(np.int32)
    wvsl = (rng.normal(size=(K, S, 1 + R)) * 0.4).astype(np.float32)
    z = np.zeros(K, np.int32)
    ls = np.full(K, S - 1, np.int32)
    args = [_t(a) for a in (meta, q, slot, wvsl, z, z, ls)]
    hi, _ = gram.fused_tile_gram(*args, S)
    bf, _ = gram.fused_tile_gram(*args, S, fast_matmul="bf16")
    assert float((bf - hi).abs().max()) <= 2e-2 * float(hi.abs().max())

    n, n_u, n_i = 1500, 30, 20
    u = rng.randint(0, n_u, n)
    i = rng.randint(0, n_i, n)
    y = (2.0 + rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
         + 0.3 * rng.normal(size=n))
    rows = np.arange(n)
    X = sps.hstack([
        sps.csr_matrix((np.ones(n), (rows, u)), shape=(n, n_u)),
        sps.csr_matrix((np.ones(n), (rows, i)), shape=(n, n_i))],
        format="csr")
    plan = try_compile_categorical(
        X, [], np.array([0] * n_u + [1] * n_i, np.int32), None,
        np.float32, "cpu", rank=2)
    assert plan is not None
    tr = CategoricalGibbsTrainer(
        plan, y, GibbsConfig(task="regression", gram_fast_matmul="bf16"),
        2, 0.1, 7, np.float32)
    assert tr.cfg.gram_fast_matmul == "bf16"
    pred, hist = tr.run(60, 30)
    assert hist.gram_fast_matmul == "bf16"
    yhat = pred.predict(X)
    rmse = float(np.sqrt(np.mean((yhat - y) ** 2)))
    assert rmse < 0.45


def _norm(mode):
    return False if mode is False else gram.gram_mode(mode)


@pytest.mark.parametrize("value", [None, False, True, "split", "bf16"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [None, 32, 128])
def test_resolution_on_the_cpu_equals_jax(value, dtype, rank):
    """On the CPU the port resolves every gram_fast_matmul value like the
    JAX package off its accelerator (None -> False; an explicit value
    kept, True meaning "split" in both), for the Gibbs and VI configs."""
    for jcfg, pcfg in ((JaxConfig(gram_fast_matmul=value),
                        GibbsConfig(gram_fast_matmul=value)),
                       (JaxVIConfig(gram_fast_matmul=value),
                        VariationalConfig(gram_fast_matmul=value))):
        want = jax_resolve(jcfg, dtype, rank).gram_fast_matmul
        got = _resolve_gram_fast_matmul(pcfg, dtype, "cpu",
                                        rank).gram_fast_matmul
        assert got == _norm(want)
        if value is None:
            assert got is False


def test_selfcheck_is_false_off_the_card():
    for mode in MODES:
        assert gram.gram_fast_selfcheck(mode, "cpu") is False
        assert jax_selfcheck(mode) is False


def test_cpu_tensors_in_a_mode_take_the_plain_version_without_a_launch():
    aux2, gths, wvsl, flags, S, carry = _cross_problem(
        16, 2, 3, 2, 2, np.float32, vi=False)
    ops = [_t(aux2), [_t(g) for g in gths], _t(wvsl)] + [_t(f)
                                                         for f in flags]
    before = {k: dict(v) for k, v in
              gram.fused_tile_gram_cross.mode_launches.items()}
    for mode in MODES:
        a = gram.fused_tile_gram_cross(*ops, S, fast_matmul=mode)
        b = gram.fused_tile_gram_cross_reference(*ops, S, fast_matmul=mode)
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert before == gram.fused_tile_gram_cross.mode_launches
