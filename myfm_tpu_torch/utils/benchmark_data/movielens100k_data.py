"""MovieLens-100k data manager.

Counterpart of ``myfm_tpu/utils/benchmark_data/movielens100k_data.py``:
the predefined u1..u5 splits, user/movie side information, and
per-movie genre strings joined by '|'.  pandas is imported when a
method reads a member.
"""

from __future__ import annotations

from io import BytesIO
from pathlib import Path
from typing import TYPE_CHECKING, List, Tuple

from .loader_base import MovieLensBase

if TYPE_CHECKING:  # pragma: no cover
    import pandas as pd

_RATING_COLS = ["user_id", "movie_id", "rating", "timestamp"]


class MovieLens100kDataManager(MovieLensBase):
    """Data manager for the MovieLens-100k dataset."""

    @property
    def DOWNLOAD_URL(self) -> str:
        return "http://files.grouplens.org/datasets/movielens/ml-100k.zip"

    @property
    def DEFAULT_PATH(self) -> Path:
        return Path("~/.ml-100k.zip").expanduser()

    def _read_member(self, name: str, **read_csv_kw) -> "pd.DataFrame":
        """``pd.read_csv`` over one member of the dataset zip."""
        import pandas as pd

        with BytesIO(self.zf.read(name)) as ifs:
            return pd.read_csv(ifs, header=None, **read_csv_kw)

    def _ratings(self, member: str) -> "pd.DataFrame":
        import pandas as pd

        df = self._read_member(member, sep="\t", names=_RATING_COLS)
        return df.assign(
            timestamp=pd.to_datetime(df["timestamp"], unit="s")
        )

    def load_rating_all(self) -> "pd.DataFrame":
        """All 100k ratings."""
        return self._ratings("ml-100k/u.data")

    def load_rating_predefined_split(
        self, fold: int
    ) -> Tuple["pd.DataFrame", "pd.DataFrame"]:
        """The dataset's predefined uN.base/uN.test split, fold 1..5."""
        if not (1 <= fold <= 5):
            raise ValueError("fold must be in 1..5")
        return (
            self._ratings(f"ml-100k/u{fold}.base"),
            self._ratings(f"ml-100k/u{fold}.test"),
        )

    def load_user_info(self) -> "pd.DataFrame":
        """User meta information (age, gender, occupation, zipcode)."""
        return self._read_member(
            "ml-100k/u.user", sep="|",
            names=["user_id", "age", "gender", "occupation", "zipcode"],
        )

    def genres(self) -> List[str]:
        """The 19 genre names, in the dataset's canonical order."""
        return list(self._read_member("ml-100k/u.genre", sep="|")[0])

    def load_movie_info(self) -> "pd.DataFrame":
        """Movie meta info; multiple genres joined by '|'."""
        import pandas as pd

        genres = self.genres()
        df_mov = self._read_member(
            "ml-100k/u.item", sep="|", encoding="latin-1"
        )
        df_mov.columns = (
            ["movie_id", "title", "release_date", "unk", "url"] + genres
        )
        df_mov["release_date"] = pd.to_datetime(df_mov.release_date)
        # one-hot genre columns -> 'Action|Thriller' strings, keeping
        # the canonical genre order within each movie
        flags = df_mov[genres].values.astype(bool)
        df_mov["genres"] = [
            "|".join(g for g, on in zip(genres, row) if on)
            for row in flags
        ]
        return df_mov
