"""The fitted accuracy of the port's ``VariationalFMRegressor`` on the
synthetic "tiny" timeSVD++ design (the entity+attribute fast path).

CAVI is deterministic given its initial weights, but JAX's threefry and
torch's Philox generators draw different initial weights from one seed,
so the comparison with the TPU package is distributional: the port's
held-out RMSE, averaged over two seeds, must lie inside the TPU
package's seed-to-seed range over three seeds, widened by that range on
each side.  It runs on the design with binary side values, where the
TPU package's entity+attribute color step is exact; on the design's own
values (x = 1/√n) that step is not a coordinate maximiser
(myfm_tpu_torch/ops/categorical_vi.py), and the port is held to its own
ELBO and to std(y_test) there.  Measured on the CPU at rank 4, 15
sweeps, float32, seeds 1-3: binary side values, TPU package
1.0246-1.0264, port 1.0244-1.0255; the design's own values, port
1.0250-1.0261.  The ELBO
must not decrease by more than 1e-6 of its magnitude from one sweep to
the next (float32 rounding of a sum over ~10^4 terms; every CAVI update
is an exact coordinate maximiser).
"""

import os
import sys

import numpy as np
import scipy.sparse as sps

import myfm_tpu
import myfm_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def _tiny(binary):
    from ml_features import build_feature_blocks, load_movielens

    tr, te = load_movielens("tiny", 0, synthetic=True)
    Xtr, Xte, btr, bte, grouping = build_feature_blocks(
        tr, te, "timesvdpp_flipped")
    if binary:
        btr, bte = ([type(b)(b.original_to_block,
                             sps.csr_matrix(b.data, copy=True).sign())
                     for b in bs] for bs in (btr, bte))
    return (Xtr, btr, tr.rating.values, Xte, bte, te.rating.values,
            grouping)


def _fit(mod, data, seed, **kw):
    Xtr, btr, y, Xte, bte, yte, grouping = data
    fm = mod.VariationalFMRegressor(rank=4, random_seed=seed, **kw).fit(
        Xtr, y, X_rel=btr, n_iter=15, grouping=grouping)
    assert fm.history_.engine == "fastpath"
    pred = fm.predict(Xte, bte)
    elbos = np.asarray(fm.history_.elbos)
    assert elbos.shape == (15,) and np.isfinite(elbos).all()
    assert (np.diff(elbos) >= -1e-6 * np.abs(elbos[1:])).all()
    return float(np.sqrt(np.mean((pred - yte) ** 2)))


def test_tiny_timesvdpp_elbo_and_rmse_within_jax_seed_spread():
    data = _tiny(binary=True)
    ref = [_fit(myfm_tpu, data, s) for s in (1, 2, 3)]
    ours = np.mean([_fit(myfm_tpu_torch, data, s, device="cpu")
                    for s in (1, 2)])
    spread = max(ref) - min(ref)
    assert ours < data[5].std()
    assert min(ref) - spread <= ours <= max(ref) + spread, (ours, ref)


def test_tiny_timesvdpp_fractional_side_values_fit():
    data = _tiny(binary=False)
    assert _fit(myfm_tpu_torch, data, 1, device="cpu") < data[5].std()
