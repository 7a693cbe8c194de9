"""Multi-device CAVI on the CPU: the port's variational estimators at
world size 2 over gloo (``tests/torch_shard_cases.py``) against the
one-process port on the same design, float64, at the TPU package's
sharded-parity tolerance: the weights, their variances and the ELBO
trace, the replicated state the same bits on both ranks; and the
argument errors (the pattern of tests/test_sharded_vi.py)."""

import numpy as np
import pytest

from . import torch_shard_cases as cases

RTOL, ATOL = 1e-8, 1e-10

VI = ("vi_reg", "vi_cls", "vi_ea")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.run_ranks(str(tmp_path_factory.mktemp("shard_vi")),
                           list(VI))


@pytest.mark.parametrize("name", VI)
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


@pytest.mark.parametrize("strategy", ["colored", "serial"])
def test_sharded_vi_needs_the_fast_path(strategy):
    import myfm_tpu_torch as m

    X, blocks, y, grouping = cases.cf_design()
    with pytest.raises(NotImplementedError, match="categorical fast path"):
        m.VariationalFMRegressor(rank=2, n_devices=2, device="cpu",
                                 sweep_strategy=strategy).fit(
            X, y, X_rel=blocks, n_iter=2)


@pytest.mark.parametrize("est", ["VariationalFMRegressor",
                                 "VariationalFMClassifier"])
def test_sharded_vi_needs_an_initialised_group(est):
    import myfm_tpu_torch as m

    X, blocks, y, grouping = cases.cf_design()
    with pytest.raises(ValueError, match="n_devices=2"):
        getattr(m, est)(rank=2, n_devices=2, device="cpu").fit(
            X, (y > np.median(y)).astype(np.int64), X_rel=blocks, n_iter=2)
