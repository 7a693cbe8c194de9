"""The port's row-space design compilation (myfm_tpu_torch/design.py)
against the TPU package's: every array of the plan is bit-equal (same
values, same dtypes, same padding), for the joint engine's dense color
operands included, and the engine-resolution gates decide alike.  The
JAX package colors with its native planner where it is built; the
port's numpy greedy pass must assign exactly the same colors.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from myfm_tpu import design as jdesign
from myfm_tpu.relational import RelationBlock as JaxBlock
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch import design as tdesign
from myfm_tpu_torch.convert import design_plan_from_numpy


def assert_plan_equal(ours, ref, name="plan"):
    """Walk the port's plan and the JAX plan field by field."""
    if ours is None or ref is None:
        assert ours is None and ref is None, name
    elif isinstance(ours, torch.Tensor):
        want = np.asarray(ref)
        got = ours.cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif isinstance(ours, tuple):
        assert len(ours) == len(ref), name
        for k, (a, b) in enumerate(zip(ours, ref)):
            assert_plan_equal(a, b, f"{name}[{k}]")
    elif isinstance(ours, int):
        assert ours == ref, name
    else:
        # a field of the port's alone (the sharding fields row_lo and
        # n_total, the CUDA summation orders) must hold its default on a
        # one-process CPU plan
        for f in dataclasses.fields(ours):
            assert_plan_equal(getattr(ours, f.name),
                              getattr(ref, f.name, f.default),
                              f"{name}.{f.name}")


def relational_design(seed=0, n=400, n_users=40, n_items=18, n_days=7,
                      density=0.3):
    """A date main table plus a user block of [one-hot id | N-hot
    implicit items] and a one-hot item block: the timeSVD++ shape."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    imp = sps.csr_matrix(
        (rng.random((n_users, n_items)) < density)
        * (0.5 + rng.random((n_users, n_items)))
    )
    user_tab = sps.hstack([sps.identity(n_users, format="csr"), imp],
                          format="csr")
    item_tab = sps.identity(n_items, format="csr")
    X = sps.csr_matrix((np.ones(n), (np.arange(n), rng.randint(0, n_days, n))),
                       shape=(n, n_days))
    grouping = np.repeat(np.arange(4, dtype=np.int32),
                         [n_days, n_users, n_items, n_items])

    def blocks(cls):
        return [cls(u, user_tab), cls(i, item_tab)]

    return X, blocks, grouping


def both(X, blocks, **kw):
    ours = tdesign.compile_design(X, blocks(RelationBlock), device="cpu",
                                  **kw)
    ref = jdesign.compile_design(X, blocks(JaxBlock), **kw)
    return ours, ref


@pytest.mark.parametrize("kw", [
    dict(joint_dense=True),
    dict(joint_dense=True, max_unrolled_colors=2),
    dict(joint_dense=True, joint_rank=4),
    dict(joint_dense=True, joint_rank=20),  # head trimmed, no id split
    dict(joint_dense=True, dense_budget=100),  # budget exceeded
    dict(joint_dense=False),
    dict(joint_dense=True, for_training=False),
    dict(strategy="serial"),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compile_design_bit_equal(kw, dtype):
    X, blocks, grouping = relational_design()
    ours, ref = both(X, blocks, grouping=grouping, dtype=dtype, **kw)
    assert_plan_equal(ours, ref)
    assert_plan_equal(design_plan_from_numpy(ref, "cpu"), ref)


def test_joint_dense_plan_has_head_identity_split_and_tail():
    X, blocks, grouping = relational_design()
    ours, ref = both(X, blocks, grouping=grouping, dtype=np.float32,
                     joint_dense=True, max_unrolled_colors=2)
    user = ours.blocks[0]
    assert len(user.dense_colors) == 2
    assert user.dense_colors[0].id_feat is not None  # 40 ≥ 32 one-hot ids
    assert user.dense_stack is not None
    assert user.dense_stack.xw.shape[1] == 40
    assert_plan_equal(ours, ref)


def test_high_rank_drops_identity_split():
    X, blocks, grouping = relational_design()
    ours, _ = both(X, blocks, grouping=grouping, dtype=np.float32,
                   joint_dense=True, joint_rank=20)
    assert all(dc.id_feat is None for b in ours.blocks
               for dc in b.dense_colors)
    assert all(len(b.dense_colors) <= 4 for b in ours.blocks)


def test_main_table_without_blocks_and_grouping_default():
    rng = np.random.RandomState(3)
    X = sps.random(120, 30, density=0.15, random_state=rng, format="csr")
    ours = tdesign.compile_design(X, device="cpu")
    ref = jdesign.compile_design(X)
    assert_plan_equal(ours, ref)
    assert ours.n_groups == 1 and float(ours.group_counts[0]) == 30


@pytest.mark.parametrize("seed", range(4))
def test_greedy_color_equals_jax(seed):
    rng = np.random.RandomState(seed)
    csc = sps.random(300, 120, density=0.04, random_state=rng,
                     format="csc")
    ours = tdesign.greedy_color(csc)
    ref = jdesign.greedy_color(csc)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rank,fit_linear,dtype,sizes", [
    (10, True, np.float32, [100, 80]),
    (10, True, np.float32, [100, 20]),  # a group under 4(R+2)
    (10, False, np.float32, [100, 80]),
    (10, True, np.float64, [3, 2]),  # float64 takes any group size
    (200, True, np.float64, [100, 80]),  # above JOINT_AUTO_MAX_RANK
])
def test_joint_auto_candidate_equals_jax(rank, fit_linear, dtype, sizes):
    gi = np.repeat(np.arange(len(sizes)), sizes)
    assert tdesign.joint_auto_candidate(rank, fit_linear, dtype, gi) == (
        jdesign.joint_auto_candidate(rank, fit_linear, dtype, gi)
    )


@pytest.mark.parametrize("budget,rank,dtype", [
    (64 << 20, 4, np.float32),
    (100, 4, np.float32),  # the dense operands exceed the budget
    (64 << 20, 10, np.float32),  # groups of 18 < 4(R+2)
    (64 << 20, 10, np.float64),
])
def test_joint_auto_eligible_equals_jax(budget, rank, dtype):
    X, blocks, grouping = relational_design()
    ours, ref = both(X, blocks, grouping=grouping, dtype=dtype,
                     joint_dense=True, dense_budget=budget, joint_rank=rank)
    assert tdesign.joint_auto_eligible(ours, rank, dtype) == (
        jdesign.joint_auto_eligible(ref, rank, dtype)
    )


def test_constants_equal_jax():
    for name in ("IDENTITY_SPLIT_MIN", "JOINT_AUTO_MAX_RANK",
                 "JOINT_UNROLL_MAX_RANK"):
        assert getattr(tdesign, name) == getattr(jdesign, name)


def test_bad_inputs_raise_like_jax():
    X, blocks, grouping = relational_design()
    for bad in (grouping[:-1], np.where(grouping == 1, 5, grouping)):
        with pytest.raises(ValueError):
            jdesign.compile_design(X, blocks(JaxBlock), grouping=bad)
        with pytest.raises(ValueError):
            tdesign.compile_design(X, blocks(RelationBlock), grouping=bad,
                                   device="cpu")
