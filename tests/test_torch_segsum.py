"""The float segment sums (``myfm_tpu_torch.ops.segsum``) on the CPU.

On CPU tensors the helpers are ``index_add_``; the card's two
deterministic routes (the masked dense sum for few segments, the sorted
``segment_reduce`` otherwise) are plain PyTorch too, so they run here on
CPU tensors through ``_cuda_sum`` and are held against ``index_add_``."""

import numpy as np
import pytest
import torch

from myfm_tpu_torch.ops import segsum

from . import torch_shard_cases as cases


def _case(shape, n, seed, empty=()):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape))
    index = rng.integers(0, n, size=shape[0])
    for s in empty:
        index[index == s] = (s + 1) % n
    return x, torch.as_tensor(index)


def _index_add(x, index, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    return out.index_add_(0, index, x)


@pytest.mark.parametrize("shape,n", [((1000,), 3), ((1000, 5), 3),
                                     ((5000,), 700), ((5000, 4), 700),
                                     ((64, 3, 3), 20)])
def test_segment_sum_is_index_add_on_the_cpu(shape, n):
    x, index = _case(shape, n, 0, empty=(1,))
    got = segsum.segment_sum(x, index, n)
    assert torch.equal(got, _index_add(x, index, n))
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_add_at_is_index_add_and_leaves_out_alone():
    x, index = _case((300, 2), 40, 1)
    out = torch.as_tensor(np.random.default_rng(2).standard_normal((40, 2)))
    before = out.clone()
    got = segsum.add_at(out, index, x)
    assert torch.equal(got, before.index_add(0, index, x))
    assert torch.equal(out, before)


@pytest.mark.parametrize("shape,n", [((81_000,), 3), ((20_000, 8), 3),
                                     ((5000,), 700), ((5000, 4), 700),
                                     ((3000, 2), 17)])
def test_card_routes_sum_what_index_add_sums(shape, n):
    """Both of the card's routes (dense below DENSE_MAX_SEGMENTS, sorted
    above) give index_add_'s sums, empty segments zero, and the same
    bits on a second call."""
    x, index = _case(shape, n, 3, empty=(2,))
    got = segsum._cuda_sum(x, index, n)
    np.testing.assert_allclose(got.numpy(), _index_add(x, index, n).numpy(),
                               rtol=1e-12, atol=1e-10)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert torch.equal(got, segsum._cuda_sum(x, index, n))


def test_card_route_add_at_adds_into_a_copy():
    x, index = _case((4000, 3), 500, 4)
    out = torch.ones(500, 3, dtype=x.dtype)
    got = segsum._cuda_sum(x, index, 500, out)
    np.testing.assert_allclose(got.numpy(),
                               torch.ones(500, 3, dtype=x.dtype)
                               .index_add(0, index, x).numpy(),
                               rtol=1e-12, atol=1e-10)
    assert torch.equal(out, torch.ones(500, 3, dtype=x.dtype))


def test_card_routes_are_exact_on_integers_in_float32():
    """Small integers sum exactly in float32 in any order: every route
    must give index_add_'s bits."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(-8, 8, size=(81_000,)), dtype=torch.float32)
    index = torch.as_tensor(rng.integers(0, 3, size=81_000))
    for n in (3, 40):
        assert torch.equal(segsum._cuda_sum(x, index, n),
                           _index_add(x, index, n))


@pytest.mark.parametrize("shape,n", [((5000,), 700), ((5000, 4), 700),
                                     ((3000, 2), 17), ((64, 3, 3), 20)])
def test_ascending_route_sums_what_index_add_sums(shape, n):
    """An ascending index (a color's slots) is summed where it lies:
    index_add_'s sums, empty segments zero, the same bits twice."""
    x, index = _case(shape, n, 6, empty=(3,))
    index = torch.sort(index).values
    got = segsum._cuda_sum(x, index, n, ascending=True)
    np.testing.assert_allclose(got.numpy(), _index_add(x, index, n).numpy(),
                               rtol=1e-12, atol=1e-10)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    assert torch.equal(got, segsum._cuda_sum(x, index, n, ascending=True))


def test_given_order_is_the_order_made_per_call():
    """A plan's order (``index_order``, made once) gives the bits the
    route gives when it sorts the index itself."""
    x, index = _case((6000, 3), 900, 7, empty=(5,))
    perm, offsets = segsum.index_order(index, 900)
    assert torch.equal(perm, torch.argsort(index, stable=True))
    assert offsets.shape == (901,) and int(offsets[-1]) == 6000
    assert int(offsets[6]) == int(offsets[5])  # the empty segment
    assert torch.equal(segsum._cuda_sum(x, index, 900, order=(perm, offsets)),
                       segsum._cuda_sum(x, index, 900))


@pytest.mark.parametrize("chunk", [1000, 4096, 1 << 20])
def test_chunked_sum_on_the_cpu_is_index_add_by_row_chunks(chunk):
    x, index = _case((5000, 3), 200, 8)
    out = torch.ones(200, 3, dtype=x.dtype)
    got = segsum.segment_sum_chunked(lambda rows: 2.0 * x[rows], index, 200,
                                     out, chunk)
    want = out.clone()
    for s in range(0, 5000, chunk):
        want = want.index_add(0, index[s : s + chunk], 2.0 * x[s : s + chunk])
    assert torch.equal(got, want)
    assert torch.equal(out, torch.ones(200, 3, dtype=x.dtype))


@pytest.mark.parametrize("chunk", [700, 5000])
def test_chunked_card_route_walks_the_index_order(chunk):
    """The card's chunked route: chunks of the stable order, each summed
    by segment; index_add_'s sums, the same bits twice, and in one chunk
    the bits of the unchunked ordered sum."""
    x, index = _case((5000, 2), 300, 9, empty=(4,))
    order = segsum.index_order(index, 300)
    out = torch.zeros(300, 2, dtype=x.dtype)

    def run():
        return segsum._chunks_in_order(lambda rows: x[rows], index, 300,
                                       out, chunk, order)

    got = run()
    np.testing.assert_allclose(got.numpy(), _index_add(x, index, 300).numpy(),
                               rtol=1e-12, atol=1e-10)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    assert torch.equal(got, run())
    if chunk >= 5000:
        assert torch.equal(got, segsum._cuda_sum(x, index, 300, order=order))


class _Rows:
    """The part of a data axis ``shard_design`` reads: a rank's rows."""

    def __init__(self, index, size):
        self.index, self.size = index, size

    def rows(self, n):
        n_local = -(-n // self.size)
        lo = min(self.index * n_local, n)
        return lo, min(lo + n_local, n)


def _colors(plan):
    for t in (plan.main,) + tuple(plan.blocks):
        for c in t.colors:
            yield c.seg
        if t.color_stack is not None:
            yield from t.color_stack.seg


@pytest.mark.parametrize("max_unrolled_colors", [0, 2, 16])
def test_color_slots_ascend_on_whole_and_sharded_plans(max_unrolled_colors):
    """The row-space engines sum a color's slots with ``ascending=True``:
    every color's (and stacked color's) ``seg`` of a compiled plan, and
    of each rank's shard, is non-decreasing."""
    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.parallel.sharding import shard_design

    plans = []
    for X, blocks, _, grouping in (cases.row_design(), cases.ea_design()):
        plan = compile_design(X, blocks, grouping=grouping,
                              dtype=np.float64,
                              max_unrolled_colors=max_unrolled_colors,
                              device="cpu")
        plans += [plan] + [shard_design(plan, _Rows(r, 3)) for r in range(3)]
    n_seen = 0
    for p in plans:
        for seg in _colors(p):
            assert bool((seg[1:] >= seg[:-1]).all())
            n_seen += 1
    assert n_seen > len(plans)


def test_cpu_plans_carry_no_orders():
    """On the CPU the sums are index_add_: compiled and sharded plans
    hold no summation orders (``with_segment_orders`` leaves them)."""
    from myfm_tpu_torch.design import compile_design, with_segment_orders
    from myfm_tpu_torch.parallel.sharding import shard_design

    X, blocks, _, grouping = cases.ea_design()
    plan = compile_design(X, blocks, grouping=grouping, dtype=np.float64,
                          device="cpu")
    for p in (plan, shard_design(plan, _Rows(1, 2)),
              with_segment_orders(plan)):
        assert p.main.coo_order is None
        assert all(b.coo_order is None and b.mapper_order is None
                   for b in p.blocks)
