"""The Netflix Prize data, as the ApproxJoin paper's §6.2 case study joins
it: ``qualifying.txt`` against ``training_set`` on MovieID.

Movie ids are 1..``movies``, not scrambled, as the dataset numbers them.
The movie of popularity rank ``r`` holds ``c_r = top_count * ((1 + q) /
(r + q)) ** exponent`` ratings, ``q`` fitted so that the counts, rounded by
largest remainder, total exactly the training rows; ids are given to ranks
by a permutation drawn from the seed.  Training values are ratings 1-5 with
``rating_p``; each qualifying row's movie is drawn in proportion to its
ratings, its value ``qualifying_value`` (0, so that ``v1 + v2`` is the
rating).  Rows are in random order.  The relations are ``[qualifying,
training]``: the smaller leads the strata.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.generators import generator


@functools.lru_cache(maxsize=8)
def _counts(movies: int, total: int, top: int, exponent: float) -> tuple:
    """Ratings of each popularity rank (1 first), exact total, by bisection
    on ``q`` in float64 (the same on every machine: no seed enters)."""
    if not top < total < movies * top:
        raise ValueError(f"netflix: {total} ratings cannot spread over "
                         f"{movies} movies with {top} at the top")
    r = np.arange(1, movies + 1, dtype=np.float64)

    def curve(q):
        return top * ((1.0 + q) / (r + q)) ** exponent

    lo, hi = 0.0, 1.0
    while curve(hi).sum() < total:
        hi *= 2.0
    for _ in range(200):
        mid = (lo + hi) / 2.0
        if curve(mid).sum() < total:
            lo = mid
        else:
            hi = mid
    c = curve(hi)
    base = np.floor(c).astype(np.int64)
    short = total - int(base.sum())
    # largest remainder; ties to the more popular rank
    order = np.argsort(-(c - base), kind="stable")
    base[order[:short]] += 1
    return tuple(base.tolist()), hi


def rank_counts(cfg: dict) -> np.ndarray:
    """The configuration's ratings of each rank, int64 [movies]."""
    counts, _ = _counts(int(cfg["movies"]), int(cfg["rows"][1]),
                        int(cfg["top_count"]), float(cfg["exponent"]))
    return np.asarray(counts, dtype=np.int64)


def fitted_q(cfg: dict) -> float:
    return _counts(int(cfg["movies"]), int(cfg["rows"][1]),
                   int(cfg["top_count"]), float(cfg["exponent"]))[1]


def generate(cfg: dict, seed: int, device) -> list:
    g = generator(seed, device)
    n_qual, n_train = (int(n) for n in cfg["rows"])
    counts = torch.as_tensor(rank_counts(cfg), device=device)
    ids = torch.randperm(counts.shape[0], generator=g, device=device) + 1
    keys = torch.repeat_interleave(ids, counts)
    keys = keys[torch.randperm(n_train, generator=g, device=device)]
    p = torch.tensor(cfg["rating_p"], dtype=torch.float64, device=device)
    cum = torch.cumsum(p, 0)
    u = torch.rand(n_train, generator=g, device=device, dtype=torch.float64)
    ratings = 1 + torch.searchsorted(cum[:-1].contiguous(), u, right=True)
    # each qualifying row picks a rating at random and takes its movie
    edge = torch.cumsum(counts, 0)
    pick = torch.randint(n_train, (n_qual,), generator=g, device=device)
    q_keys = ids[torch.searchsorted(edge, pick, right=True)]
    q_vals = torch.full((n_qual,), float(cfg["qualifying_value"]),
                        dtype=torch.float32, device=device)
    return [(q_keys, q_vals), (keys, ratings.to(torch.float32))]
