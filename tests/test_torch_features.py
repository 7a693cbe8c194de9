"""The port's numpy-only data layer against the TPU package's pandas
one: the one-hot encoder (myfm_tpu_torch/utils/encoders), the shuffled
K-fold split (utils/benchmark_data/loader_base.py) and the MovieLens
feature sets of utils/ml_features.py (the counterpart of
examples/ml_features.py).  Everything is compared for exact equality.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from myfm_tpu.utils.benchmark_data.loader_base import (
    _fold_window as jax_fold_window,
)
from myfm_tpu.utils.benchmark_data.loader_base import (
    train_test_split_with_kfold as jax_split,
)
from myfm_tpu.utils.encoders import (
    CategoryValueToSparseEncoder as JaxEncoder,
)
from myfm_tpu_torch.utils.benchmark_data import train_test_split_with_kfold
from myfm_tpu_torch.utils.benchmark_data.loader_base import _fold_window
from myfm_tpu_torch.utils.encoders import CategoryValueToSparseEncoder
from myfm_tpu_torch.utils.ml_features import (
    FEATURE_SETS,
    build_feature_blocks,
    feature_flags,
    load_synthetic_movielens,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (a != b).nnz == 0


@pytest.mark.parametrize("handle_unknown", ["create", "ignore", "raise"])
@pytest.mark.parametrize("min_freq", [1, 2])
def test_encoder_equals_jax(handle_unknown, min_freq):
    rng = np.random.RandomState(min_freq)
    train = rng.randint(0, 30, 200)
    ours = CategoryValueToSparseEncoder(train, min_freq, handle_unknown)
    ref = JaxEncoder(train, min_freq, handle_unknown)
    assert len(ours) == len(ref)
    assert ours.names() == ref.names()
    known = rng.choice(ref.values[1:] if handle_unknown == "create"
                       else ref.values, 50)
    same_csr(ours.to_sparse(known), ref.to_sparse(known))
    assert [ours[x] for x in known[:5]] == [ref[x] for x in known[:5]]
    unseen = np.array([1000, 3, 2000])
    if handle_unknown == "raise":
        for enc in (ours, ref):
            with pytest.raises(KeyError):
                enc.to_sparse(unseen)
    else:
        same_csr(ours.to_sparse(unseen), ref.to_sparse(unseen))


@pytest.mark.parametrize("n,K", [(103, 10), (10, 10), (57, 4)])
def test_kfold_split_equals_jax(n, K):
    rng = np.random.RandomState(n)
    ratings = {"a": rng.normal(size=n), "b": rng.randint(0, 9, n)}
    df = pd.DataFrame(ratings)
    for fold in range(K):
        assert _fold_window(n, K, fold) == jax_fold_window(n, K, fold)
        tr, te = train_test_split_with_kfold(ratings, K, fold, 5)
        jtr, jte = jax_split(df, K, fold, 5)
        for col in ratings:
            np.testing.assert_array_equal(tr[col], jtr[col].values)
            np.testing.assert_array_equal(te[col], jte[col].values)
    with pytest.raises(ValueError):
        train_test_split_with_kfold(ratings, K, K)


def test_feature_flags_equal_the_example():
    import ml_features

    assert FEATURE_SETS == ml_features.FEATURE_SETS
    for f in FEATURE_SETS:
        assert feature_flags(f) == ml_features.feature_flags(f)
    with pytest.raises(ValueError):
        feature_flags("nope")


@pytest.mark.parametrize("scale", ["tiny", "100k"])
def test_feature_blocks_equal_the_example(scale):
    from ml_features import build_feature_blocks as ref_build
    from ml_features import load_movielens

    jtr, jte = load_movielens(scale, 0, synthetic=True)
    tr, te = load_synthetic_movielens(scale, 0)
    for col in ("user_id", "movie_id", "rating"):
        np.testing.assert_array_equal(tr[col], jtr[col].values)
        np.testing.assert_array_equal(te[col], jte[col].values)
    days = (jtr.timestamp - pd.Timestamp("2005-01-01")).dt.days.values
    np.testing.assert_array_equal(tr["day"], days)
    for feature in FEATURE_SETS:
        for strict in (True, False):
            ours = build_feature_blocks(tr, te, feature, strict)
            ref = ref_build(jtr, jte, feature, strict)
            for a, b in zip(ours[:2], ref[:2]):
                assert (a is None) == (b is None)
                if a is not None:
                    same_csr(a, b)
            for a, b in zip(ours[2] + ours[3], ref[2] + ref[3]):
                np.testing.assert_array_equal(a.original_to_block,
                                              b.original_to_block)
                same_csr(a.data, b.data)
            assert ours[4] == ref[4]
