"""Multi-device Gibbs on the CPU: the port at world size 2 over gloo
(two spawned ranks, ``tests/torch_shard_cases.py``) against the
one-process port on the same design and seed, float64, at the TPU
package's sharded-parity tolerance (tests/test_sharded.py): every kept
sample, the hyper trace, the engine and the sharded prediction; the
replicated state the same bits on both ranks; a checkpoint written by
rank 0 and resumed by both; the argument errors.  Then one table pass of
the port's sharded fast path against the JAX package's under
``shard_map`` on a 2-device CPU mesh.

One spawn of the two ranks runs every case (module fixture)."""

import functools

import numpy as np
import pytest

from . import torch_shard_cases as cases

RTOL, ATOL = 1e-8, 1e-10

GIBBS = ("fast_reg", "fast_reg_odd", "fast_cls", "fast_ord", "fast_rs_off",
         "ea_reg", "ea_ord", "colored_ord", "colored_reg", "joint_reg",
         "joint_cls")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    ckpt = functools.partial(cases.checkpoint_resume,
                             path=str(d / "chain.npz"))
    return cases.run_ranks(str(d), list(GIBBS), extra=(("ckpt", ckpt),))


@pytest.mark.parametrize("name", GIBBS)
def test_world_size_two_equals_one_process(ranks, name):
    ref = cases.CASES[name](None)
    for rank in ranks:
        got = rank[name]
        assert bool(got["replicated"]), f"{name}: ranks' replicas differ"
        for key, want in ref.items():
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got[key], want, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {key}")
            else:
                assert got[key] == want, f"{name} {key}"


WORLD4 = ("fast_ord", "ea_reg", "colored_ord", "joint_cls", "vi_cls")


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return cases.run_ranks(str(tmp_path_factory.mktemp("shard4")),
                           list(WORLD4), world=4)


@pytest.mark.parametrize("name", WORLD4)
def test_world_size_four_equals_one_process(ranks4, name):
    """Four ranks, the row-space design's 503 rows split unevenly."""
    ref = cases.CASES[name](None)
    for rank in ranks4:
        assert bool(rank[name]["replicated"]), name
        for key, want in ref.items():
            if want.dtype.kind == "f":
                np.testing.assert_allclose(rank[name][key], want, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {key}")


def test_sharded_checkpoint_resumes_the_chain(ranks):
    ref = cases.checkpoint_resume(None)
    for rank in ranks:
        np.testing.assert_array_equal(rank["ckpt"]["resumed"],
                                      rank["ckpt"]["full"])
        np.testing.assert_allclose(rank["ckpt"]["full"], ref["full"],
                                   rtol=RTOL, atol=ATOL)


def test_n_devices_needs_an_initialised_group():
    import myfm_tpu_torch as m

    X, blocks, y, grouping = cases.cf_design()
    with pytest.raises(ValueError, match="n_devices=2"):
        m.MyFMGibbsRegressor(rank=2, n_devices=2, device="cpu").fit(
            X, y, X_rel=blocks, n_iter=2)


def test_mesh_needs_an_initialised_group():
    import myfm_tpu_torch as m

    X, blocks, y, grouping = cases.cf_design()
    with pytest.raises(ValueError, match="process group"):
        m.MyFMOrderedProbit(rank=2, mesh=object(), device="cpu").fit(
            X, cases.ordinal(y), X_rel=blocks, n_iter=2)


def test_sharded_table_pass_matches_jax_under_shard_map(tmp_path):
    """The port's table pass on a sharded plan at world size 2 (the
    table's Gram reduce-scattered by entity window, the draws
    all-gathered) against JAX's ``_table_pass`` under ``shard_map`` on a
    2-device CPU mesh, both given the same weights, hyperparameters and
    noise, at 1e-10."""
    jax_out = _jax_sharded_table_pass()
    ranks = cases.run_ranks(str(tmp_path), [],
                            extra=(("pass", cases.table_pass),))
    for rank in ranks:
        for key in ("w", "V", "moments"):
            np.testing.assert_allclose(rank["pass"][key], jax_out[key],
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=key)


def _jax_sharded_table_pass():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    from myfm_tpu.ops import categorical as jcat
    from myfm_tpu.ops.gibbs import GibbsConfig as JaxConfig
    from myfm_tpu.parallel.sharding_categorical import (
        compile_sharded_categorical,
    )

    X, blocks, y, grouping, h = cases.table_pass_inputs()
    from myfm_tpu import RelationBlock as JaxBlock

    jblocks = [JaxBlock(b.original_to_block, b.data) for b in blocks]
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    plan, n_local = compile_sharded_categorical(
        X, jblocks, np.asarray(grouping, np.int32), 2, np.float64,
        cases.R)
    cfg = JaxConfig(task="regression", axis_name="data", n_devices=2)
    tau = np.zeros(n_local * 2)
    tau[: len(h["tau"])] = h["tau"]
    plan_spec = jax.tree_util.tree_map(lambda _: P("data"), plan)

    def run(plan, tau):
        tiles = jcat.make_y_tiles(plan, tau)
        w, V = jnp.asarray(h["w"]), jnp.asarray(h["V"])
        moments = None
        for ti in range(len(plan.tables)):
            w, V, moments = jcat._table_pass(
                plan, ti, w, V, h["w0"], h["alpha"],
                *[jnp.asarray(h[k]) for k in ("lambda_w", "mu_w",
                                              "lambda_V", "mu_V")],
                plan.group_index, jnp.asarray(h["noise_w"]),
                jnp.asarray(h["noise_V"]), tiles[ti], cfg, True,
                want_moments=ti == len(plan.tables) - 1,
            )
        return w, V, jnp.stack(moments)

    w, V, mom = jax.jit(shard_map(
        run, mesh=mesh, in_specs=(plan_spec, P("data")),
        out_specs=(P(), P(), P()), check_vma=False))(plan, jnp.asarray(tau))
    return dict(w=np.asarray(w), V=np.asarray(V), moments=np.asarray(mom))


def test_sharded_tool_runs_its_card_phase_on_the_cpu():
    """``tools.sharded.shard2``, the smoke's world-size-2 phase, on the
    CPU at a small size: two gloo ranks, the three float64 fits held
    against one process and the replicas against each other."""
    from myfm_tpu_torch.tools import sharded

    line = sharded.shard2(device="cpu", design=cases.rating_design)
    assert set(line["fits"]) == {"ea", "joint", "vi"}
    for name, row in line["fits"].items():
        assert row["engine"] == {"ea": "fastpath", "joint": "joint",
                                 "vi": "fastpath"}[name]
        for r in row["ranks"]:
            assert r["replicated_bit_equal"]
            assert r["max_err_over_tolerance"] <= 1.0
    for calls in line["collective_calls"]:
        assert calls["all_reduce"] > 0
