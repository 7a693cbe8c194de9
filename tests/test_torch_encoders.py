"""The port's feature encoders against the JAX package's.

The same values, drawn from a numpy seed, go through
``myfm_tpu.utils.encoders`` and ``myfm_tpu_torch.utils.encoders``: the
CSR blocks must agree in ``indptr``, ``indices`` and ``data`` (exactly),
and the widths and names must be equal.
"""

import datetime

import numpy as np
import pandas as pd
import pytest

import myfm_tpu.utils.encoders as jenc
import myfm_tpu_torch.utils.encoders as tenc


def assert_csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _values(kind, n, seed):
    """n values of one kind: strings, integers or dates."""
    k = np.random.RandomState(seed).randint(0, 12, n)
    if kind == "str":
        return [f"v{x:02d}" for x in k]
    if kind == "int":
        return list(k.astype(np.int64))
    day0 = datetime.date(2001, 3, 1)
    return [day0 + datetime.timedelta(days=int(x)) for x in k]


def _pair(cls_name, *args, **kwargs):
    return (getattr(jenc, cls_name)(*args, **kwargs),
            getattr(tenc, cls_name)(*args, **kwargs))


def _same_outcome(fn_j, fn_t):
    """Both raise the same exception type, or both return equal CSR."""
    try:
        want = fn_j()
    except KeyError:
        with pytest.raises(KeyError):
            fn_t()
        return
    assert_csr_equal(fn_t(), want)


@pytest.mark.parametrize("kind", ["str", "int", "date"])
@pytest.mark.parametrize("handle_unknown", ["create", "ignore", "raise"])
@pytest.mark.parametrize("min_freq", [1, 3])
def test_category_encoder_matches_jax(kind, handle_unknown, min_freq):
    train = _values(kind, 60, seed=1)
    unseen = _values(kind, 40, seed=2)  # the same value set, other draws
    j, t = _pair("CategoryValueToSparseEncoder", train, min_freq=min_freq,
                 handle_unknown=handle_unknown)
    assert len(t) == len(j)
    assert t.names() == j.names()
    for values in (train, unseen):
        _same_outcome(lambda: j.to_sparse(values),
                      lambda: t.to_sparse(values))
    # one value at a time: __getitem__ and _get_index, unknowns included
    outside = {"str": "zz", "int": np.int64(99),
               "date": datetime.date(1990, 1, 1)}[kind]
    for x in [train[0], unseen[-1], outside]:
        for method in ("__getitem__", "_get_index"):
            try:
                want = getattr(j, method)(x)
            except KeyError:
                with pytest.raises(KeyError):
                    getattr(t, method)(x)
                continue
            assert getattr(t, method)(x) == want


def test_category_encoder_rejects_bad_mode():
    for mod in (jenc, tenc):
        with pytest.raises(ValueError):
            mod.CategoryValueToSparseEncoder(["a"], handle_unknown="drop")


def _genre_rows(n, seed, vocab=("Action", "Comedy", "Drama", "Horror",
                                "Romance", "Sci-Fi")):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        k = rng.randint(0, 4)
        toks = list(rng.choice(vocab, size=k))
        if rng.rand() < 0.2:
            toks.append("")  # empty token: dropped
        if rng.rand() < 0.2 and toks:
            toks.append(toks[0])  # duplicate token: dropped
        rows.append("|".join(toks))
    return rows


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("handle_unknown", ["create", "ignore", "raise"])
@pytest.mark.parametrize("min_freq", [1, 8])
def test_multi_value_encoder_matches_jax(normalize, handle_unknown,
                                         min_freq):
    train = _genre_rows(50, seed=3)
    test = _genre_rows(30, seed=4,
                       vocab=("Action", "Drama", "Western", "Noir"))
    j, t = _pair("MultipleValuesToSparseEncoder", train, min_freq=min_freq,
                 sep="|", normalize=normalize,
                 handle_unknown=handle_unknown)
    assert len(t) == len(j)
    assert t.names() == j.names()
    for rows in (train, test):
        _same_outcome(lambda: j.to_sparse(rows), lambda: t.to_sparse(rows))


@pytest.mark.parametrize("n_percentiles", [1, 4, 10])
@pytest.mark.parametrize("ties", [False, True])
def test_binning_encoder_matches_jax(n_percentiles, ties):
    rng = np.random.RandomState(5)
    x = rng.normal(size=80)
    if ties:
        x = np.round(x)  # repeated percentiles collapse into one edge
    x[rng.rand(80) < 0.1] = np.nan
    x_new = np.concatenate([rng.normal(scale=3, size=30), [np.nan]])
    j, t = _pair("BinningEncoder", x, n_percentiles=n_percentiles)
    np.testing.assert_array_equal(t.percentiles, j.percentiles)
    assert len(t) == len(j)
    assert t.names() == j.names()
    assert_csr_equal(t.to_sparse(x), j.to_sparse(x))
    assert_csr_equal(t.to_sparse(x_new), j.to_sparse(x_new))
    for mod in (jenc, tenc):
        with pytest.raises(ValueError):
            mod.BinningEncoder(x, n_percentiles=0)


def _frame(seed):
    rng = np.random.RandomState(seed)
    n = 40
    return pd.DataFrame({
        "user": rng.randint(0, 9, n),
        "genres": _genre_rows(n, seed + 1),
        "age": np.where(rng.rand(n) < 0.1, np.nan, rng.uniform(10, 70, n)),
        "zip": [f"z{k}" for k in rng.randint(0, 5, n)],
    })


def _df_encoder(mod, df):
    return (
        mod.DataFrameEncoder()
        .add_column("user", mod.CategoryValueToSparseEncoder(df["user"]))
        .add_column("genres", mod.MultipleValuesToSparseEncoder(
            df["genres"], sep="|"))
        .add_column("age", mod.BinningEncoder(df["age"], n_percentiles=5))
        .add_column("zip", mod.CategoryValueToSparseEncoder(
            df["zip"], handle_unknown="ignore"))
    )


@pytest.mark.parametrize("columns", ["frame", "dict"])
def test_dataframe_encoder_matches_jax(columns):
    df, df_new = _frame(6), _frame(7)
    j, t = _df_encoder(jenc, df), _df_encoder(tenc, df)
    assert t.encoder_shapes == j.encoder_shapes
    assert t.all_names() == j.all_names()
    assert list(t.col_encoders) == list(j.col_encoders)
    for frame in (df, df_new):
        # the port reads df[column], so a dict of numpy columns serves too
        given = frame if columns == "frame" else {
            c: frame[c].to_numpy() for c in frame.columns}
        assert_csr_equal(t.encode_df(given), j.encode_df(frame))
    for mod in (jenc, tenc):
        with pytest.raises(ValueError):
            mod.DataFrameEncoder().encode_df(df)
