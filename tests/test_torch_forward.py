"""The port's row-space FM forward (myfm_tpu_torch/ops/forward.py)
against the TPU package's, on plans compiled by both packages from the
same design and on the same weights: float64, 1e-12 relative (the two
sum the same products in a different order).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from myfm_tpu import design as jdesign
from myfm_tpu.ops import forward as jfwd
from myfm_tpu.relational import RelationBlock as JaxBlock
from myfm_tpu_torch import RelationBlock
from myfm_tpu_torch import design as tdesign
from myfm_tpu_torch.ops import forward as tfwd

TOL = 1e-12


def _design(seed, with_main=True, with_blocks=True):
    rng = np.random.RandomState(seed)
    n, nu, ni = 300, 23, 17
    X = (sps.random(n, 9, density=0.3, random_state=rng, format="csr")
         if with_main else None)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    ub = sps.hstack([sps.identity(nu, format="csr"),
                     sps.random(nu, ni, density=0.3, random_state=rng)],
                    format="csr")
    ib = sps.random(ni, 5, density=0.5, random_state=rng, format="csr")

    def blocks(cls):
        return [cls(u, ub), cls(i, ib)] if with_blocks else []

    return rng, X, blocks


def _plans(X, blocks, **kw):
    ours = tdesign.compile_design(X, blocks(RelationBlock),
                                  dtype=np.float64, device="cpu", **kw)
    ref = jdesign.compile_design(X, blocks(JaxBlock), dtype=np.float64,
                                 **kw)
    return ours, ref


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(ours.numpy() - ref).max()) <= TOL * scale


@pytest.mark.parametrize("with_main,with_blocks", [
    (True, True), (True, False), (False, True),
])
@pytest.mark.parametrize("rank", [0, 1, 5])
def test_predict_score_matches_jax(with_main, with_blocks, rank):
    rng, X, blocks = _design(rank + 2 * with_main + with_blocks,
                             with_main, with_blocks)
    ours, ref = _plans(X, blocks, for_training=False)
    F = ours.n_features
    w0, w, V = 0.3, rng.normal(size=F), rng.normal(size=(F, rank))
    got = tfwd.predict_score(ours, torch.tensor(w0, dtype=torch.float64),
                             torch.as_tensor(w),
                             torch.as_tensor(V))
    _close(got, jfwd.predict_score(ref, w0, jnp.asarray(w),
                                   jnp.asarray(V)))


def test_terms_match_jax_on_a_training_plan():
    rng, X, blocks = _design(7)
    ours, ref = _plans(X, blocks, for_training=True, joint_dense=True)
    F = ours.n_features
    w, V = rng.normal(size=F), rng.normal(size=(F, 4))
    tw, tV = torch.as_tensor(w), torch.as_tensor(V)
    jw, jV = jnp.asarray(w), jnp.asarray(V)
    _close(tfwd.linear_term(ours, tw), jfwd.linear_term(ref, jw))
    _close(tfwd.factor_q(ours, tV), jfwd.factor_q(ref, jV))
    _close(tfwd.pairwise_term(ours, tV), jfwd.pairwise_term(ref, jV))


def test_factor_chunking_matches_jax(monkeypatch):
    """With a tiny chunk budget the pairwise term runs one factor column
    at a time, as the TPU package's does, and gives the same scores."""
    monkeypatch.setattr(tfwd, "_CHUNK_ELEMENTS", 300)
    monkeypatch.setattr(jfwd, "_CHUNK_ELEMENTS", 300)
    assert tfwd._factor_chunk(6, 300) == jfwd._factor_chunk(6, 300) == 1
    rng, X, blocks = _design(11)
    ours, ref = _plans(X, blocks, for_training=False)
    V = rng.normal(size=(ours.n_features, 6))
    _close(tfwd.pairwise_term(ours, torch.as_tensor(V)),
           jfwd.pairwise_term(ref, jnp.asarray(V)))
