"""Checkpoint and resume of the port's Gibbs trainers
(myfm_tpu_torch/checkpoint.py, ``run_mcmc_loop``): a chain interrupted
after 6 sweeps and resumed from its checkpoint in a fresh trainer draws
the last 4 samples of the uninterrupted 10-sweep chain (the generator's
state is part of the checkpoint), on every engine; a failed write
leaves no file behind; and a chain checkpoint of the TPU package loads
into the port's state (convert.state_from_jax_checkpoint)."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from myfm_tpu.design import compile_design as jax_compile_design
from myfm_tpu.ops.forward import predict_score as jax_predict_score
from myfm_tpu.ops.gibbs import GibbsConfig as JaxConfig
from myfm_tpu.trainer import GibbsTrainer as JaxGibbsTrainer
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch import checkpoint as tckpt
from myfm_tpu_torch.convert import state_from_jax_checkpoint
from myfm_tpu_torch.design import compile_design
from myfm_tpu_torch.design_categorical import try_compile_categorical
from myfm_tpu_torch.ops.forward import predict_score
from myfm_tpu_torch.ops.gibbs import GibbsConfig
from myfm_tpu_torch.trainer import CategoricalGibbsTrainer, GibbsTrainer


def _onehot(seed=0, n=400, nu=19, ni=13):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    X = sps.hstack([
        sps.csr_matrix((np.ones(n), (np.arange(n), u)), shape=(n, nu)),
        sps.csr_matrix((np.ones(n), (np.arange(n), i)), shape=(n, ni)),
    ]).tocsr()
    y = (rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
         + 0.3 * rng.normal(size=n))
    grouping = np.asarray([0] * nu + [1] * ni, np.int32)
    return X, [], y, grouping, rng.randint(0, 4, n)


def _relational(seed=1, n=300, nu=24, ni=14):
    """A date main table, a user block [one-hot id | N-hot implicit
    items] and a one-hot item block (the timeSVD++ shape, small)."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    imp = sps.csr_matrix((rng.random((nu, ni)) > 0.7)
                         * (0.5 + rng.random((nu, ni))))
    blocks = [
        RelationBlock(u, sps.hstack([sps.identity(nu, format="csr"), imp],
                                    format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    X = sps.csr_matrix((np.ones(n), (np.arange(n), rng.randint(0, 5, n))),
                       shape=(n, 5))
    grouping = np.repeat(np.arange(4, dtype=np.int32), [5, nu, ni, ni])
    y = rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
    return X, blocks, y, grouping, rng.randint(0, 3, n)


CASES = {
    # engine: (design, plan kind, task)
    "categorical": (_onehot, "fastpath", "regression"),
    "categorical_ordered": (_onehot, "fastpath", "ordered"),
    "entity_attribute": (_relational, "fastpath_side", "regression"),
    "colored": (_onehot, "colored", "regression"),
    "serial": (_onehot, "serial", "regression"),
    "joint": (_relational, "joint", "regression"),
}


def _trainer(case):
    make, kind, task = CASES[case]
    X, blocks, y, grouping, y_ord = make()
    n_class = int(y_ord.max()) + 1
    cfg = GibbsConfig(task=task, n_class=n_class if task == "ordered" else 0,
                      joint_rows=kind == "joint")
    target = y_ord if task == "ordered" else y
    if kind.startswith("fastpath"):
        plan = try_compile_categorical(
            X, blocks, grouping, None, np.float64, "cpu", rank=2,
            allow_side=kind == "fastpath_side")
        assert plan is not None
        assert plan.has_side == (kind == "fastpath_side")
        return CategoricalGibbsTrainer(plan, target, cfg, 2, 0.1, 42,
                                       np.float64)
    plan = compile_design(
        X, blocks, grouping=grouping, dtype=np.float64,
        strategy="serial" if kind == "serial" else "auto",
        joint_dense=kind == "joint", joint_rank=2, device="cpu")
    tr = GibbsTrainer(plan, target, cfg, 2, 0.1, 42, np.float64)
    assert tr.engine_name == ("joint" if kind == "joint" else "colored")
    return tr


@pytest.mark.parametrize("case", list(CASES))
def test_resume_reproduces_chain(tmp_path, case):
    ckpt = str(tmp_path / "chain.npz")
    full, h_full = _trainer(case).run(10, 10)
    _trainer(case).run(6, 1, checkpoint_path=ckpt, checkpoint_every=6)
    resumed, h_res = _trainer(case).run(10, 10, checkpoint_path=ckpt,
                                        resume=True)
    assert len(resumed.samples) == 4
    for a, b in zip(full.samples[-4:], resumed.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-12)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-12)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-12)
        for ca, cb in zip(a.cutpoints, b.cutpoints):
            np.testing.assert_allclose(ca, cb, rtol=1e-12)
    for a, b in zip(h_full.hypers[-4:], h_res.hypers):
        np.testing.assert_allclose(a.alpha, b.alpha, rtol=1e-12)
        np.testing.assert_allclose(a.lambda_V, b.lambda_V, rtol=1e-12)
    if CASES[case][2] == "ordered":
        assert h_full.n_mh_accept_trace[-4:] == h_res.n_mh_accept_trace


def test_checkpoint_round_trip_restores_state_and_generator(tmp_path):
    tr = _trainer("categorical_ordered")
    state = tr._sweep_call(tr._initialize())
    path = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(path, state, 1, (tr.generator,))
    want = torch.rand(5, generator=tr.generator)
    like = tr._initialize()
    got, it = tckpt.load_checkpoint(path, like, (tr.generator,))
    assert it == 1
    assert torch.equal(torch.rand(5, generator=tr.generator), want)
    for (name, a), (_, b) in zip(tckpt.state_fields(state),
                                 tckpt.state_fields(got)):
        if a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_failed_write_leaves_no_temp_file(tmp_path, monkeypatch):
    tr = _trainer("colored")
    state = tr._initialize()

    class Broken:
        def get_state(self):
            raise RuntimeError("generator state unavailable")

    path = tmp_path / "c.npz"
    with pytest.raises(RuntimeError):
        tckpt.save_checkpoint(str(path), state, 3, (Broken(),))
    assert os.listdir(tmp_path) == []

    # a write that fails half way, once the temporary file holds bytes
    def disk_full(f, **payload):
        f.write(b"partial")
        raise OSError("no space left on device")

    monkeypatch.setattr(tckpt.np, "savez", disk_full)
    with pytest.raises(OSError):
        tckpt.save_checkpoint(str(path), state, 3, (tr.generator,))
    assert os.listdir(tmp_path) == []


def test_loads_a_jax_checkpoint(tmp_path):
    """A 6-sweep chain of the TPU package, checkpointed there, loads into
    the port's state: the port's init_e (score - y) and scores of that
    state equal the TPU package's at float64."""
    X, _, y, grouping, _ = _onehot(seed=3, n=200, nu=11, ni=7)
    path = str(tmp_path / "jax.npz")
    jplan = jax_compile_design(X, [], grouping=grouping, dtype=np.float64)
    JaxGibbsTrainer(jplan, y, JaxConfig(task="regression"), 2, 0.1, 9,
                    np.float64).run(6, 1, checkpoint_path=path,
                                    checkpoint_every=6)
    plan = compile_design(X, [], grouping=grouping, dtype=np.float64,
                          device="cpu")
    tr = GibbsTrainer(plan, y, GibbsConfig(task="regression"), 2, 0.1, 9,
                      np.float64)
    state, it = state_from_jax_checkpoint(path, tr._initialize())
    assert it == 6
    with np.load(path) as data:
        jw0, jw, jV, je = (data[f"leaf_{k}"] for k in range(4))
    np.testing.assert_array_equal(state.V.numpy(), jV)
    score = predict_score(plan, state.w0, state.w, state.V).numpy()
    want = np.asarray(jax.jit(jax_predict_score)(
        jplan, jnp.asarray(jw0), jnp.asarray(jw), jnp.asarray(jV)))
    np.testing.assert_allclose(score, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(score - y, want - y, rtol=0, atol=1e-10)
    # the chain's carried residual is that state's init_e
    np.testing.assert_allclose(state.e.numpy(), score - y, rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(state.e.numpy(), je)
    # and the port continues the chain from it
    pred, _ = tr.run(8, 2, checkpoint_path=_port_copy(tmp_path, tr, state),
                     resume=True)
    assert len(pred.samples) == 2
    assert all(np.isfinite(s.V).all() for s in pred.samples)


def _port_copy(tmp_path, tr, state):
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, state, 6, (tr.generator,))
    return path
