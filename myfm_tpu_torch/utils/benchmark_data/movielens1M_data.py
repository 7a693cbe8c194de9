"""MovieLens-1M/10M data managers.

Counterpart of ``myfm_tpu/utils/benchmark_data/movielens1M_data.py``.
Both datasets ship '::'-separated ratings files; pandas' fast native
parser only takes single-character separators, so the shared loader
reads with ``sep=':'`` and keeps the even-numbered columns (the odd ones
are empty).  pandas is imported when a ratings member is read.
"""

from __future__ import annotations

from io import BytesIO
from pathlib import Path
from typing import TYPE_CHECKING

from .loader_base import MovieLensBase

if TYPE_CHECKING:  # pragma: no cover
    import pandas as pd


def read_ml1m10m_df(ifs: BytesIO) -> "pd.DataFrame":
    """Parse a '::'-separated ratings member (see module docstring)."""
    import pandas as pd

    raw = pd.read_csv(ifs, sep=":", header=None)
    df = raw.iloc[:, 0::2].copy()
    df.columns = ["user_id", "movie_id", "rating", "timestamp"]
    df["timestamp"] = pd.to_datetime(df.timestamp, unit="s")
    return df


class _DoubleColonRatingsManager(MovieLensBase):
    """Shared loader for the two '::'-separated MovieLens releases."""

    RATINGS_MEMBER: str

    def load_rating_all(self) -> "pd.DataFrame":
        with BytesIO(self.zf.read(self.RATINGS_MEMBER)) as ifs:
            return read_ml1m10m_df(ifs)


class MovieLens1MDataManager(_DoubleColonRatingsManager):
    DOWNLOAD_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
    DEFAULT_PATH = Path("~/.ml-1m.zip").expanduser()
    RATINGS_MEMBER = "ml-1m/ratings.dat"
