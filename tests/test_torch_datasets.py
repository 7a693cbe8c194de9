"""The port's dataset utilities against the JAX package's.

``gen_dummy_rating_df`` / ``gen_dummy_X`` from one seed, the MovieLens
managers over zips written into ``tmp_path`` (the consent prompt and the
download are monkeypatched; nothing is fetched), and the shuffled K-fold
split on a DataFrame and on a dict of columns.
"""

import zipfile

import numpy as np
import pandas as pd
import pytest

import myfm_tpu.utils.benchmark_data as jbd
import myfm_tpu_torch.utils.benchmark_data as tbd
from myfm_tpu.utils import dummy_data as jdummy
from myfm_tpu.utils.benchmark_data import loader_base as jloader
from myfm_tpu_torch.utils import dummy_data as tdummy
from myfm_tpu_torch.utils.benchmark_data import loader_base as tloader


@pytest.mark.parametrize("seed,rank,size", [(0, 3, 100), (4, 5, 17),
                                            (9, 2, 301)])
def test_dummy_data_matches_jax(seed, rank, size):
    pd.testing.assert_frame_equal(
        tdummy.gen_dummy_rating_df(seed, factor_rank=rank, size=size,
                                   user_colname="u", rating_colname="r"),
        jdummy.gen_dummy_rating_df(seed, factor_rank=rank, size=size,
                                   user_colname="u", rating_colname="r"))
    tb, ty, tshapes = tdummy.gen_dummy_X(seed, factor_rank=rank, size=size)
    jb, jy, jshapes = jdummy.gen_dummy_X(seed, factor_rank=rank, size=size)
    np.testing.assert_array_equal(ty, jy)
    assert tshapes == jshapes
    for t, j in zip(tb, jb, strict=True):
        np.testing.assert_array_equal(t.original_to_block,
                                      j.original_to_block)
        assert (t.data != j.data).nnz == 0 and t.data.shape == j.data.shape


def _ratings_text(df, sep):
    return "".join(
        f"{r.userId}{sep}{r.itemId}{sep}{r.rating}{sep}"
        f"{int(pd.Timestamp(r.timestamp).timestamp())}\n"
        for r in df.itertuples(index=False))


def _write_double_colon_zip(path, member, seed=3, size=120):
    df = jdummy.gen_dummy_rating_df(random_seed=seed, size=size)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(member, _ratings_text(df, "::"))


_GENRES = ["unknown", "Action", "Comedy", "Drama"]


def _write_ml100k_zip(path):
    with zipfile.ZipFile(path, "w") as zf:
        for k, name in enumerate(["u.data"] + [
                f"u{f}.{part}" for f in range(1, 6)
                for part in ("base", "test")]):
            df = jdummy.gen_dummy_rating_df(random_seed=k, size=30 + k)
            zf.writestr(f"ml-100k/{name}", _ratings_text(df, "\t"))
        zf.writestr("ml-100k/u.user",
                    "1|24|M|technician|85711\n2|53|F|other|94043\n")
        zf.writestr("ml-100k/u.genre",
                    "".join(f"{g}|{i}\n" for i, g in enumerate(_GENRES)))
        flags = ["0|1|1|0", "1|0|0|0", "0|0|1|1"]
        zf.writestr("ml-100k/u.item", "".join(
            f"{i + 1}|Movie {i} (1995)|01-Jan-1995||http://x/{i}|{f}\n"
            for i, f in enumerate(flags)).encode("latin-1"))


_MANAGERS = {
    "MovieLens1MDataManager": ("ml-1m/ratings.dat", None),
    "MovieLens10MDataManager": ("ml-10M100K/ratings.dat", None),
    "MovieLens100kDataManager": (None, _write_ml100k_zip),
}


def _zip_for(name, path):
    member, writer = _MANAGERS[name]
    if writer is None:
        _write_double_colon_zip(path, member)
    else:
        writer(path)


@pytest.mark.parametrize("name", sorted(_MANAGERS))
def test_movielens_manager_matches_jax(name, tmp_path):
    path = tmp_path / "ml.zip"
    _zip_for(name, path)
    j, t = getattr(jbd, name)(path), getattr(tbd, name)(path)
    assert t.DOWNLOAD_URL == j.DOWNLOAD_URL
    assert t.DEFAULT_PATH == j.DEFAULT_PATH
    pd.testing.assert_frame_equal(t.load_rating_all(), j.load_rating_all())
    for a, b in zip(t.load_rating_kfold_split(4, 1, 7),
                    j.load_rating_kfold_split(4, 1, 7), strict=True):
        pd.testing.assert_frame_equal(a, b)
    if name == "MovieLens100kDataManager":
        for a, b in zip(t.load_rating_predefined_split(3),
                        j.load_rating_predefined_split(3), strict=True):
            pd.testing.assert_frame_equal(a, b)
        pd.testing.assert_frame_equal(t.load_user_info(), j.load_user_info())
        assert t.genres() == j.genres() == _GENRES
        pd.testing.assert_frame_equal(t.load_movie_info(),
                                      j.load_movie_info())
        with pytest.raises(ValueError):
            t.load_rating_predefined_split(6)
    with pytest.raises(ValueError):
        t.load_rating_kfold_split(5, 5)


@pytest.mark.parametrize("name", sorted(_MANAGERS))
def test_download_prompt_and_refusal_match_jax(name, tmp_path, monkeypatch):
    prompts = []

    def refuse(prompt):
        prompts.append(prompt)
        return "n"

    monkeypatch.setattr("builtins.input", refuse)
    for mod in (jbd, tbd):
        with pytest.raises(RuntimeError, match="abort"):
            getattr(mod, name)(tmp_path / "missing.zip")
    assert len(prompts) == 2 and prompts[0] == prompts[1]
    assert str(tmp_path / "missing.zip") in prompts[0]


@pytest.mark.parametrize("name", sorted(_MANAGERS))
def test_consented_download_matches_jax(name, tmp_path, monkeypatch, capsys):
    fetched = []

    def fake_fetch(url, dest):
        fetched.append(url)
        _zip_for(name, dest)

    monkeypatch.setattr("builtins.input", lambda *_: "Y")
    monkeypatch.setattr("urllib.request.urlretrieve", fake_fetch)
    outputs, frames = [], []
    for k, mod in enumerate((jbd, tbd)):
        man = getattr(mod, name)(tmp_path / f"dl{k}.zip")
        outputs.append(capsys.readouterr().out)
        frames.append(man.load_rating_all())
    assert fetched[0] == fetched[1]
    assert outputs[0] == outputs[1] == "start download...\ncomplete\n"
    pd.testing.assert_frame_equal(frames[1], frames[0])


def test_fetch_with_consent_matches_jax(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr("builtins.input", lambda prompt: calls.append(
        prompt) or "y")
    monkeypatch.setattr("urllib.request.urlretrieve",
                        lambda url, dest: calls.append((url, dest)))
    for mod in (jloader, tloader):
        mod._fetch_with_consent("http://host/x.zip", tmp_path / "x.zip")
    assert calls[:2] == calls[2:]
    assert capsys.readouterr().out == "start download...\ncomplete\n" * 2


@pytest.mark.parametrize("K,fold,seed", [(5, 0, 0), (5, 4, 3), (7, 2, 1),
                                         (3, 1, 42)])
def test_kfold_split_on_frames_and_dicts(K, fold, seed):
    df = jdummy.gen_dummy_rating_df(random_seed=11, size=101)
    want = jloader.train_test_split_with_kfold(df, K, fold, seed)
    got = tloader.train_test_split_with_kfold(df, K, fold, seed)
    for a, b in zip(got, want, strict=True):
        pd.testing.assert_frame_equal(a, b)
    # a dict of columns gives the same rows in the same order, as dicts
    cols = {c: df[c].to_numpy() for c in df.columns}
    split = tloader.train_test_split_with_kfold(cols, K, fold, seed)
    for part, frame in zip(split, want, strict=True):
        assert list(part) == list(cols)
        for c in cols:
            np.testing.assert_array_equal(part[c], frame[c].to_numpy())
    for mod in (jloader, tloader):
        with pytest.raises(ValueError):
            mod.train_test_split_with_kfold(df, K, K, seed)


def test_exports_match_jax():
    from myfm_tpu import utils as jutils
    from myfm_tpu_torch import utils as tutils

    for jmod, tmod in ((jutils, tutils), (jbd, tbd),
                       (jutils.encoders, tutils.encoders),
                       (jutils.callbacks, tutils.callbacks),
                       (jutils.dummy_data, tutils.dummy_data)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert hasattr(tmod, name)
