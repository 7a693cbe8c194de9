"""Seeded MovieLens-shaped ratings, drawn on the device.

The model is that of ``myfm_tpu_torch/utils/benchmark_data/synthetic.py``
(Pareto item popularity and user activity, a rank-8 latent score plus
user and item biases and noise, cut into 1..5 stars at fixed quantiles,
a day stamp within ``n_days``), rewritten for torch so that ten million
rows take well under a second on the card instead of ~8 s of numpy.

Every seed gets the same amount of work: how many ratings each user,
each item and each day has in the training rows and in the held-out rows
(the degree sequences of each split) is fixed, the users' and items'
drawn once from a fixed structural seed and the days' even, and
``--seed`` decides only which ids carry which degree, which user meets
which item on which day, the latent factors and the ratings.  So two
seeds give the kernels the same tile counts in another order, and their
runs differ by the data, not by the size of the work.

A configuration may state its own degree model in its ``dataset``:
``user_pareto`` and ``item_pareto`` ([shape, offset] of the Lomax
weights, by default [1.5, 0.5] and [1.2, 0.1]) and ``min_user_ratings``
(the least number of training rows of each user, by default 0).  Without
those keys the draws are the ones above, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the degree sequences' seed: part of the configuration, not of a run
STRUCTURE_SEED = 20_190_527
LATENT_RANK = 8
STAR_QUANTILES = (0.12, 0.30, 0.55, 0.80)


@dataclasses.dataclass
class Ratings:
    """One split of the ratings as host arrays (int64 ids, float64 stars)."""

    day: np.ndarray
    user: np.ndarray
    item: np.ndarray
    y: np.ndarray

    def __len__(self):
        return int(self.y.shape[0])


def _pareto(a: float, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Lomax(a) variates, numpy's ``RandomState.pareto``."""
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return (1.0 - u).pow(-1.0 / a) - 1.0


def degree_counts(n_rows: int, weights: torch.Tensor) -> torch.Tensor:
    """Counts summing to ``n_rows`` in proportion to ``weights``: the
    floors, then one more for the largest remainders."""
    share = weights / weights.sum() * n_rows
    counts = share.floor().long()
    short = n_rows - int(counts.sum())
    if short:
        counts[torch.argsort(share - counts, descending=True,
                             stable=True)[:short]] += 1
    return counts


def _seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def make_ratings(shape: dict, seed: int, device) -> tuple:
    """(train, test) ``Ratings`` for ``shape`` (keys ``rows``, ``users``,
    ``items``, ``days``, ``test_share``, and the degree model's optional
    ``user_pareto``, ``item_pareto``, ``min_user_ratings``) from
    ``seed``: ``int(rows * test_share)`` rows held out, each split's
    rows in random order."""
    n, n_users, n_items = shape["rows"], shape["users"], shape["items"]
    n_days = shape["days"]
    n_test = int(n * shape["test_share"])
    (a_user, off_user), (a_item, off_item) = (
        shape.get("user_pareto", (1.5, 0.5)),
        shape.get("item_pareto", (1.2, 0.1)))
    least = shape.get("min_user_ratings", 0)
    if least * n_users > n - n_test:
        raise ValueError("min_user_ratings exceeds the training rows")
    structure = _seed_generator(STRUCTURE_SEED, device)
    weights = dict(
        user=(_pareto(a_user, n_users, structure, device) + off_user),
        item=(_pareto(a_item, n_items, structure, device) + off_item),
        day=torch.ones(n_days, dtype=torch.float64, device=device))

    gen = _seed_generator(seed, device)

    def ids(weight, least=0):
        """One column, the held-out rows first: each split's degree
        sequence is fixed (``least`` rows of each id in the training
        split, the rest in proportion to ``weight``), the seed picks the
        ids that carry each degree and the rows' order."""
        owner = torch.randperm(len(weight), generator=gen, device=device)
        return torch.cat([
            torch.repeat_interleave(
                owner, floor + degree_counts(rows - floor * len(weight),
                                             weight))[
                torch.randperm(rows, generator=gen, device=device)]
            for rows, floor in ((n_test, 0), (n - n_test, least))])

    user = ids(weights["user"], least)
    item, day = (ids(weights[k]) for k in ("item", "day"))

    def normal(*size):
        return torch.randn(*size, generator=gen, dtype=torch.float64,
                           device=device)

    uf = normal(n_users, LATENT_RANK) / LATENT_RANK ** 0.5
    vf = normal(n_items, LATENT_RANK) / LATENT_RANK ** 0.5
    score = ((uf[user] * vf[item]).sum(dim=1)
             + 0.4 * normal(n_users)[user] + 0.4 * normal(n_items)[item]
             + 0.6 * normal(n))
    ranked = score.sort().values
    cuts = ranked[[int(q * (n - 1)) for q in STAR_QUANTILES]]
    stars = 1.0 + (score[:, None] >= cuts[None, :]).sum(dim=1).double()

    host = [t.cpu().numpy() for t in (day, user, item, stars)]
    test = Ratings(*(a[:n_test] for a in host))
    train = Ratings(*(a[n_test:] for a in host))
    return train, test
