"""The port's serving path (myfm_tpu_torch/ops/forward_categorical.py,
myfm_tpu_torch/predictor.py) against the TPU package's.

Weights are made with numpy from a seed (or carried across from JAX
containers by myfm_tpu_torch/convert.py) and scored by both packages.
Tolerance 1e-10 relative in float64: the same gathers and sums, in
another order.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from myfm_tpu import Predictor as JaxPredictor
from myfm_tpu.containers import FM as JaxFM
from myfm_tpu.ops import forward_categorical as jfc
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch.convert import predictor_from_numpy
from myfm_tpu_torch.ops import forward_categorical as tfc


def _design(seed=0, n=700, n_days=9, n_users=31, n_items=19):
    rng = np.random.RandomState(seed)
    days = rng.randint(0, n_days, n)
    X = sps.csr_matrix((np.ones(n), (np.arange(n), days)),
                       shape=(n, n_days))
    blocks = [
        RelationBlock(rng.randint(0, n_users, n),
                      sps.identity(n_users, format="csr")),
        RelationBlock(rng.randint(0, n_items, n),
                      sps.identity(n_items, format="csr")),
    ]
    return rng, X, blocks, n_days + n_users + n_items


def _weights(rng, S, F, R):
    return (rng.normal(size=S), rng.normal(size=(S, F)),
            0.5 * rng.normal(size=(S, F, R)))


@pytest.mark.parametrize("mode", ["sum", "probit_sum"])
@pytest.mark.parametrize("row_chunk", [128, 1 << 19])
def test_scores_samples_reduce_matches_jax(mode, row_chunk):
    rng, X, blocks, F = _design()
    w0s, ws, Vs = _weights(rng, 5, F, 4)
    jplan = jfc.compile_categorical_inference(X, blocks, np.float64)
    tplan = tfc.compile_categorical_inference(X, blocks, np.float64, "cpu")
    ref = jfc.scores_samples_reduce(
        jplan, jnp.asarray(w0s), jnp.asarray(ws), jnp.asarray(Vs),
        mode=mode, row_chunk=row_chunk,
    )
    out = tfc.scores_samples_reduce(
        tplan, torch.as_tensor(w0s), torch.as_tensor(ws),
        torch.as_tensor(Vs), mode=mode, row_chunk=row_chunk,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_predictor_carried_across_matches_jax(task):
    rng, X, blocks, F = _design(seed=2)
    R = 3
    jpred = JaxPredictor(R, F, task, np.float64)
    for w0, w, V in zip(*_weights(rng, 4, F, R)):
        jpred.samples.append(JaxFM(w0, w, V))
    tpred = predictor_from_numpy(jpred, "cpu")
    np.testing.assert_allclose(
        tpred.predict(X, blocks), jpred.predict(X, blocks), rtol=1e-10
    )


def test_non_categorical_design_raises():
    rng, X, blocks, F = _design(seed=3)
    X = X.tolil()
    X[0, 1] = 0.5  # row 0 is no longer one-hot
    from myfm_tpu_torch import FM, Predictor

    # regression on such a design is served by the row-space scorer
    # (tests/test_torch_joint_estimator.py); classification there is a
    # later slice
    pred = Predictor(2, F, "classification", np.float64, "cpu")
    pred.samples.append(FM(0.0, np.zeros(F), np.zeros((F, 2))))
    with pytest.raises(NotImplementedError, match="later slice"):
        pred.predict(X.tocsr(), blocks)
