"""Seeded serving traffic: the counterpart of
``bibfs_tpu/serve/loadgen.py``'s skewed pair sampler.

The rest of the JAX package's load harness (the open-loop load runs, the
churn, chaos and soak runs) comes with a later slice of the port (ROADMAP
Queue 1, item 10).
"""

from __future__ import annotations

import numpy as np


def sample_skewed_pairs(
    n: int, q: int, *, seed: int = 0, skew: float = 1.1,
    repeat_fraction: float = 0.25, pool: int = 64,
    degrees=None,
) -> np.ndarray:
    """``q`` (src, dst) pairs whose endpoint popularity is Zipf-distributed
    and whose stream repeats, seeded: the skewed traffic the distance
    oracle is for. Equal to the JAX package's sampler on the same
    arguments.

    - **endpoint skew**: each endpoint is drawn by Zipf rank
      (``P(rank r) ∝ r^-skew``) over the vertices ranked by ``(degree
      desc, id)`` when ``degrees`` is given (ids alone otherwise): the
      ranking landmark selection seeds from;
    - **pair repeats**: ``repeat_fraction`` of the stream re-issues pairs
      from a hot pool of the first ``pool`` sampled pairs, the pool itself
      Zipf-weighted.

    Self-pairs are re-ranked away, so every pair is non-trivial. Returns
    ``int64 [q, 2]``.
    """
    if q < 1:
        return np.zeros((0, 2), dtype=np.int64)
    rng = np.random.default_rng(seed)
    order = (
        np.lexsort((np.arange(n), -np.asarray(degrees)))
        if degrees is not None else np.arange(n)
    )
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), float(skew))
    w /= w.sum()
    ranks = rng.choice(n, size=(q, 2), p=w)
    same = ranks[:, 0] == ranks[:, 1]
    while same.any():  # re-rank the colliding endpoint (stays skewed)
        ranks[same, 1] = rng.choice(n, size=int(same.sum()), p=w)
        same = ranks[:, 0] == ranks[:, 1]
    pairs = order[ranks].astype(np.int64)
    pool = int(min(pool, q))
    if pool > 0 and repeat_fraction > 0 and q > pool:
        hot = pairs[:pool].copy()
        wp = 1.0 / np.power(
            np.arange(1, pool + 1, dtype=np.float64), float(skew)
        )
        wp /= wp.sum()
        mask = rng.random(q) < float(repeat_fraction)
        mask[:pool] = False  # the pool itself stays as drawn
        m = int(mask.sum())
        if m:
            pairs[mask] = hot[rng.choice(pool, size=m, p=wp)]
    return pairs
