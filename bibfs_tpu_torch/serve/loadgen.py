"""Seeded serving traffic: the counterpart of
``bibfs_tpu/serve/loadgen.py``'s skewed pair sampler and its query-mix
sampler (the typed traffic of the query kinds).

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


# ---- query-mix traffic (the taxonomy workload) -----------------------

#: mix-spec aliases -> canonical query kinds (bibfs_tpu_torch/query)
_MIX_ALIASES = {
    "pt": "pt", "p2p": "pt",
    "ms": "msbfs", "msbfs": "msbfs",
    "weighted": "weighted", "w": "weighted",
    "kshortest": "kshortest", "ks": "kshortest",
    "asof": "asof",
}


def parse_query_mix(spec: str) -> dict:
    """Parse a ``--mix`` spec (``pt=0.7,ms=0.2,weighted=0.1``) into
    normalized per-kind weights over the canonical kinds
    (``pt``/``msbfs``/``weighted``/``kshortest``/``asof``). Unknown
    kinds and non-positive totals fail loudly — a typo'd mix must not
    silently soak the wrong taxonomy."""
    weights: dict[str, float] = {}
    for field in filter(None, (f.strip() for f in str(spec).split(","))):
        key, eq, val = field.partition("=")
        kind = _MIX_ALIASES.get(key.strip().lower())
        if not eq or kind is None:
            raise ValueError(
                f"bad mix field {field!r} (expected kind=weight with "
                f"kind in {sorted(set(_MIX_ALIASES))})"
            )
        w = float(val)
        if w < 0:
            raise ValueError(f"negative mix weight in {field!r}")
        weights[kind] = weights.get(kind, 0.0) + w
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"query mix {spec!r} sums to zero")
    return {k: w / total for k, w in weights.items() if w > 0}


def sample_query_mix(n: int, q: int, mix: dict, *, seed: int = 0,
                     ms_sources: int = 16, k: int = 3,
                     weight_seed: int = 0, versions=()) -> list:
    """``q`` typed taxonomy queries drawn from a ``parse_query_mix``
    mix — the traffic shape for mixed-kind serving runs.
    ``ms_sources`` is each
    MultiSource query's source-set size, ``versions`` the historical
    store versions ``asof`` queries draw from (an ``asof`` weight with
    no versions falls back to ``pt`` — the mix parser cannot know the
    store's history). Self-pairs are re-drawn; fully reproducible per
    seed."""
    from bibfs_tpu_torch.query import (
        AsOf,
        KShortest,
        MultiSource,
        PointToPoint,
        Weighted,
    )

    mix = dict(mix)
    if mix.get("asof") and not versions:
        mix["pt"] = mix.get("pt", 0.0) + mix.pop("asof")
    kinds = sorted(mix)
    probs = np.array([mix[kd] for kd in kinds], dtype=np.float64)
    probs /= probs.sum()
    rng = np.random.default_rng(seed)
    draws = rng.choice(len(kinds), size=q, p=probs)

    def pair():
        s = int(rng.integers(n))
        d = int(rng.integers(n))
        while d == s:
            d = int(rng.integers(n))
        return s, d

    out = []
    for i in range(q):
        kind = kinds[draws[i]]
        s, d = pair()
        if kind == "pt":
            out.append(PointToPoint(s, d))
        elif kind == "msbfs":
            m = min(int(ms_sources), n - 1)
            sources = rng.choice(n, size=m, replace=False)
            out.append(MultiSource(
                tuple(int(x) for x in sources), d,
            ))
        elif kind == "weighted":
            out.append(Weighted(s, d, weight_seed=int(weight_seed)))
        elif kind == "kshortest":
            out.append(KShortest(s, d, k=int(k)))
        else:  # asof
            v = int(versions[int(rng.integers(len(versions)))])
            out.append(AsOf(PointToPoint(s, d), v))
    return out
