"""Netflix-Prize-like workload (paper §6.2).

training_set: ~100 M ratings of 17 770 movies; qualifying.txt: movie ids to
be scored.  The paper joins the two on MovieID and measures latency (no
meaningful aggregate; we still aggregate ratings so the same query machinery
runs).  Scaled generator keeps the movie-popularity skew (Zipf) that makes
this join stratified-sampling-relevant: popular movies have enormous strata.
The data is made with numpy from ``seed`` (the same draws as the JAX
implementation's generator) and placed on ``device``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.relation import Relation, relation
from repro_torch.data.synthetic import _scramble

NUM_MOVIES = 17_770


def ratings_tables(n_ratings: int = 1 << 16, n_qualifying: int = 1 << 13,
                   num_movies: int = NUM_MOVIES,
                   seed: int = 0, device="cuda") -> list[Relation]:
    """[training, qualifying] keyed by movie id; training value = rating."""
    rng = np.random.default_rng(seed)
    # Zipf movie popularity, ratings 1..5 skewed to 3-4 like the real data
    movie = np.minimum(rng.zipf(1.2, size=n_ratings), num_movies) - 1
    rating = rng.choice([1, 2, 3, 4, 5], p=[0.05, 0.10, 0.30, 0.35, 0.20],
                        size=n_ratings).astype(np.float32)
    qual_movie = np.minimum(rng.zipf(1.2, size=n_qualifying), num_movies) - 1
    training = relation(_scramble(movie.astype(np.uint32)), rating,
                        device=device)
    qualifying = relation(_scramble(qual_movie.astype(np.uint32)),
                          np.ones(n_qualifying, np.float32), device=device)
    return [qualifying, training]  # lead with the smaller relation
