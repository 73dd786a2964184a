"""Seeded serving traffic and the fleet soak: the counterpart of
``bibfs_tpu/serve/loadgen.py``'s skewed pair sampler, its query-mix
sampler (the typed traffic of the query kinds) and :func:`run_fleet`
(the kill/restart + rolling-swap soak of ``bibfs_tpu_torch.fleet``).

The rest of the JAX package's load harness (the open-loop load runs, the
churn, chaos and the other soaks) comes with a later slice of the port
(ROADMAP Queue 1, item 10b).
"""

from __future__ import annotations

import sys
import threading
import time

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


def run_fleet(
    *,
    replicas: int = 3,
    graphs: int = 30,
    grid: tuple = (150, 150),
    perforation: float = 0.02,
    queries: int = 6000,
    qps_repeats: int = 2,
    chaos_queries: int = 3000,
    chaos_span_s: float = 24.0,
    hot_pool: int = 48,
    repeat_fraction: float = 0.85,
    cache_entries: int = 128,
    max_batch: int = 64,
    qps_factor: float | None = 2.0,
    recovery_bound_s: float = 10.0,
    roll_adds: int = 24,
    roll_dels: int = 8,
    burst_queries: int = 240,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The fleet serving soak, the counterpart of the JAX package's
    ``run_fleet``: a health-aware :class:`~bibfs_tpu_torch.fleet.Router`
    over N in-process engine replicas on ``device`` (default ``cuda``;
    every replica's engine, the single-replica baseline's too) — each
    with its OWN versioned graph store — driven
    through the workload the fleet exists for, with kill/restart chaos
    and a rolling swap landing mid-traffic. The claims, all gated:

    1. **horizontal throughput** — repeat-heavy traffic over many
       graphs (per-graph hot pools accessed cyclically, a cold fresh
       tail) is served by a single replica and then by the fleet, same
       replica config and submitter protocol (hot pools warmed first, one
       submitter thread per hash shard). Consistent-hash affinity means
       each fleet replica's bounded distance cache holds only ITS
       shard's hot set while the single replica thrashes the combined
       set — aggregate cache capacity (and solver parallelism) scales
       with the replica count, so fleet qps must reach ``qps_factor`` x
       single-replica qps (``None`` reports without gating — the
       quick shape);
    2. **kill/restart chaos, zero lost** — mid-traffic the replica
       owning the hottest graph is killed (queued tickets fail with
       structured internal errors; the router reroutes them and every
       later submission), then restarted; the health poller must
       re-admit it within ``recovery_bound_s`` of the restart, and
       every ticket of the run must resolve (reroutes, never losses);
    3. **rolling swap under load** — an edge-update batch that provably
       changes answers rolls across the fleet replica-at-a-time
       (drain -> roll -> ready-probe -> re-admit) while traffic flows:
       the fleet serves MIXED versions mid-roll and every answer must
       match ground truth for the version its serving replica declared
       (:class:`FleetTicket.declared_version`);
    4. **hot-graph spill** — a closed-loop burst on one graph with the
       spill threshold lowered must spill to less-loaded replicas
       (``bibfs_fleet_spills_total`` > 0) with answers still exact;
    5. **observability** — the fleet metric families render on a LIVE
       ``/metrics`` endpoint scraped over HTTP during the run.

    Ground truth is a fresh per-pair native BFS outside the fleet
    (audited against the NumPy serial solver on seeded subsamples),
    per graph version. Returns the payload (the JAX package's
    ``bench_fleet.json`` fields); it writes no file.
    """
    import urllib.request

    from bibfs_tpu_torch.fleet import Router, engine_replica
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.graph.generate import grid_graph
    from bibfs_tpu_torch.obs.http import start_metrics_server
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve.resilience import QueryError
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr
    from bibfs_tpu_torch.store import GraphStore

    class _Refused:
        """A submit the router refused outright (no healthy replica):
        rides the rows like a ticket so the verify pass classifies it."""

        def __init__(self, err):
            self.error = err
            self.result = None
            self.declared_version = None

        def wait(self, timeout=None):
            raise self.error

    t_setup = time.perf_counter()
    w, h = int(grid[0]), int(grid[1])
    n = w * h
    rng = np.random.default_rng(seed)
    names = [f"g{i}" for i in range(int(graphs))]
    edge_sets = {
        g: grid_graph(w, h, perforation=perforation, seed=seed + i)
        for i, g in enumerate(names)
    }
    # canonical undirected edge sets (u < v) — the update sampler's and
    # the truth rebuilds' common currency
    und = {
        g: np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
        for g, e in edge_sets.items()
    }
    csrs = {g: build_csr(n, e) for g, e in edge_sets.items()}

    def truth_solver(c):
        """Fresh per-pair ground truth outside the fleet (native when
        it loads, serial otherwise; audited below either way)."""
        try:
            from bibfs_tpu_torch.solvers.native import (
                NativeGraph,
                solve_native_graph,
            )

            ng = NativeGraph(
                n,
                np.ascontiguousarray(c[0], dtype=np.int64),
                np.ascontiguousarray(c[1], dtype=np.int32),
            )
            return lambda s, d: solve_native_graph(ng, s, d)
        except (ImportError, OSError):
            return lambda s, d: solve_serial_csr(n, *c, s, d)

    solvers = {g: truth_solver(csrs[g]) for g in names}
    truth1: dict = {g: {} for g in names}

    def truth_for(g, s, d, table=None):
        table = truth1[g] if table is None else table
        key = (int(s), int(d))
        if key not in table:
            solver = solvers[g] if table is truth1[g] else table["__solver__"]
            table[key] = solver(*key)
        return table[key]

    # per-graph hot pools, accessed CYCLICALLY by the stream maker:
    # the scanning access pattern under which an LRU bounded below the
    # working set keeps ~nothing (the single replica's regime) and one
    # bounded above its shard keeps ~everything (each fleet replica's)
    pools = {}
    for g in names:
        p = np.unique(
            rng.integers(0, n, size=(3 * int(hot_pool), 2)), axis=0
        )
        p = p[p[:, 0] != p[:, 1]][: int(hot_pool)]
        pools[g] = [(int(s), int(d)) for s, d in p]

    def make_stream(q, fresh_seed):
        r2 = np.random.default_rng(fresh_seed)
        pos = {g: 0 for g in names}
        out = []
        for i in range(q):
            g = names[i % len(names)]
            if r2.random() < repeat_fraction:
                s, d = pools[g][pos[g] % len(pools[g])]
                pos[g] += 1
            else:
                s, d = int(r2.integers(0, n)), int(r2.integers(0, n))
                if s == d:
                    d = (d + 1) % n
            out.append((g, s, d))
        return out

    def make_replica(idx):
        store = GraphStore(compact_threshold=None)
        for g in names:
            store.add(g, n, edge_sets[g])
        return engine_replica(
            f"r{idx}", store, cache_entries=cache_entries,
            max_batch=max_batch, device=device,
        )

    def drive_sharded(router, stream):
        """One submitter thread per hash shard (a front-end's sticky
        connections), closed-loop; returns ((g, s, d, ticket) rows,
        elapsed submit-start -> all-resolved)."""
        shards: dict = {}
        for item in stream:
            shards.setdefault(router.owner(item[0]), []).append(item)
        rows_per = [[] for _ in shards]

        def work(part, out):
            for g, s, d in part:
                try:
                    out.append((g, s, d, router.submit(s, d, g)))
                except Exception as e:
                    out.append((g, s, d, _Refused(e)))

        threads = [
            threading.Thread(target=work, args=(p, o))
            for p, o in zip(shards.values(), rows_per)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        router.flush(timeout=120.0)
        rows = [r for out in rows_per for r in out]
        for _g, _s, _d, ticket in rows:
            try:
                ticket.wait(timeout=120.0)
            except Exception:
                pass  # classified by the verify pass
        return rows, time.perf_counter() - t0

    lost, failed, mismatches = [], [], []
    truth2: dict = {}

    def verify(rows, tag, rolled_graph=None):
        for g, s, d, ticket in rows:
            if ticket.error is not None:
                failed.append({
                    "phase": tag, "graph": g, "query": [s, d],
                    "kind": getattr(ticket.error, "kind", "?"),
                    "error": str(ticket.error)[:200],
                })
                continue
            if ticket.result is None:
                lost.append((tag, g, s, d))
                continue
            if (g == rolled_graph
                    and (ticket.declared_version or 1) >= 2):
                ref = truth_for(g, s, d, table=truth2)
            else:
                ref = truth_for(g, s, d)
            res = ticket.result
            if res.found != ref.found or (
                ref.found and res.hops != ref.hops
            ):
                mismatches.append(
                    f"{tag} {g} v{ticket.declared_version} "
                    f"{s}->{d}: {res.found}/{res.hops} != "
                    f"{ref.found}/{ref.hops}"
                )

    metrics_server = start_metrics_server(0)
    old_si = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    single_router = fleet = None
    try:
        warm_stream = [
            (g, s, d) for g in names for (s, d) in pools[g]
        ]

        def timed_phase(router, tag, seed0):
            """Warm the hot pools, then ``qps_repeats`` timed passes
            with FRESH cold tails each (best-of, the compare_engines
            top-repeats convention: the A/B judges each configuration's
            ceiling, not one noisy scheduler window on a shared box).
            Returns (best qps, best pass's cache hits)."""
            warm_rows, _ = drive_sharded(router, warm_stream)
            verify(warm_rows, f"{tag}-warm")

            def hits():
                return sum(
                    router.replica(r).engine.stats()["cache_served"]
                    for r in router.replica_names
                )

            best_qps = best_hits = None
            for rep in range(max(int(qps_repeats), 1)):
                stream = make_stream(int(queries), seed0 + rep)
                h0 = hits()
                rows, el = drive_sharded(router, stream)
                verify(rows, tag)
                q = len(stream) / el if el > 0 else None
                if q is not None and (best_qps is None or q > best_qps):
                    best_qps, best_hits = q, hits() - h0
            return best_qps, best_hits

        # ---- phase 1: single replica vs fleet, same config/protocol --
        # spill only on real backlog (4x the flush depth): spilling on
        # a queue that merely filled its next micro-batch scatters hot
        # traffic and destroys the affinity under measurement (the
        # Router docstring's measured warning)
        spill_at = 4 * int(max_batch)
        single_router = Router(
            [make_replica(0)], poll_interval_s=0.25,
            spill_after=spill_at,
        )
        qps_single, single_hits = timed_phase(
            single_router, "single", seed + 101
        )
        single_router.close()
        single_router = None

        fleet = Router(
            [make_replica(i) for i in range(int(replicas))],
            poll_interval_s=0.2, spill_after=spill_at,
        )
        qps_fleet, fleet_hits = timed_phase(fleet, "fleet", seed + 201)
        ratio = (
            round(qps_fleet / qps_single, 3)
            if qps_single and qps_fleet else None
        )

        # ---- phase 2: kill/restart + rolling swap under load ---------
        hot_graph = "g0"
        victim = fleet.owner(hot_graph)
        # the update batch, chosen so ground truth provably changes:
        # long-range shortcuts into a large-diameter grid, plus edge
        # deletes (disjoint from the adds)
        live = set(map(tuple, und[hot_graph].tolist()))
        adds = []
        for i in range(n):
            if len(adds) >= int(roll_adds):
                break
            u, v = i, n - 1 - i
            e = (u, v) if u < v else (v, u)
            if u != v and e not in live and e not in adds:
                adds.append(e)
        del_pool = [e for e in sorted(live)][:: max(len(live) // 64, 1)]
        dels = [e for e in del_pool if e not in adds][: int(roll_dels)]
        live2 = (live - set(dels)) | set(adds)
        csr2 = build_csr(
            n, np.array(sorted(live2), dtype=np.int64)
        )
        truth2 = {"__solver__": truth_solver(csr2)}
        changed = sum(
            1 for (s, d) in pools[hot_graph]
            if (lambda a, b: (a.found, a.hops) != (b.found, b.hops))(
                truth_for(hot_graph, s, d),
                truth_for(hot_graph, s, d, table=truth2),
            )
        )

        stream_c = make_stream(int(chaos_queries), seed + 303)
        rate = len(stream_c) / float(chaos_span_s)
        if qps_fleet:
            rate = min(rate, 0.5 * qps_fleet)
        k_kill = max(1, int(0.15 * len(stream_c)))
        k_restart = max(k_kill + 1, int(0.40 * len(stream_c)))
        k_roll = max(k_restart + 1, int(0.60 * len(stream_c)))
        recovery_s = None
        t_restart = None
        roll_out = {}
        roll_thread = recovery_thread = None

        def watch_recovery():
            nonlocal recovery_s
            deadline = time.monotonic() + recovery_bound_s + 5.0
            while time.monotonic() < deadline:
                if fleet.table().get(victim) == "ready":
                    recovery_s = time.monotonic() - t_restart
                    return
                time.sleep(0.02)

        def do_roll():
            roll_out.update(fleet.rolling_swap(
                hot_graph, adds=adds, dels=dels,
                drain_timeout_s=60.0, ready_timeout_s=30.0,
            ))

        rows_c = []
        t0 = time.perf_counter()
        for i, (g, s, d) in enumerate(stream_c):
            if i == k_kill:
                fleet.replica(victim).kill()
            elif i == k_restart:
                fleet.replica(victim).restart()
                t_restart = time.monotonic()
                recovery_thread = threading.Thread(
                    target=watch_recovery, daemon=True
                )
                recovery_thread.start()
            elif i == k_roll:
                roll_thread = threading.Thread(
                    target=do_roll, name="bibfs-fleet-roll",
                    daemon=True,
                )
                roll_thread.start()
            delay = t0 + i / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                rows_c.append((g, s, d, fleet.submit(s, d, g)))
            except QueryError as e:
                failed.append({
                    "phase": "chaos-submit", "graph": g,
                    "query": [s, d],
                    "kind": getattr(e, "kind", "?"),
                    "error": str(e)[:200],
                })
        if roll_thread is not None:
            roll_thread.join(timeout=180.0)
        if recovery_thread is not None:
            recovery_thread.join(timeout=recovery_bound_s + 6.0)
        fleet.flush(timeout=120.0)
        for _g, _s, _d, ticket in rows_c:
            try:
                ticket.wait(timeout=120.0)
            except Exception:
                pass
        verify(rows_c, "chaos", rolled_graph=hot_graph)
        versions_mid = {
            "v1": sum(
                1 for g, _s, _d, t in rows_c
                if g == hot_graph and (t.declared_version or 1) < 2
            ),
            "v2": sum(
                1 for g, _s, _d, t in rows_c
                if g == hot_graph and (t.declared_version or 1) >= 2
            ),
        }
        post_versions = {
            r: fleet.replica(r).version(hot_graph)
            for r in fleet.replica_names
        }

        # ---- phase 3: hot-graph burst exercises the spill path -------
        spill_before = fleet.stats()["spills"]
        old_spill = fleet.spill_after
        fleet.spill_after = 4
        try:
            # FRESH pairs: a cache-served burst resolves inline and the
            # owner's queue never builds — the spill path needs queued
            # work on the hash owner, i.e. misses
            brng = np.random.default_rng(seed + 404)
            burst = []
            while len(burst) < int(burst_queries):
                s = int(brng.integers(0, n))
                d = int(brng.integers(0, n))
                if s != d:
                    burst.append((hot_graph, s, d))
            parts = [burst[i::3] for i in range(3)]
            burst_rows = [[] for _ in parts]

            def bwork(part, out):
                for g, s, d in part:
                    try:
                        out.append((g, s, d, fleet.submit(s, d, g)))
                    except Exception as e:
                        out.append((g, s, d, _Refused(e)))

            bthreads = [
                threading.Thread(target=bwork, args=(p, o))
                for p, o in zip(parts, burst_rows)
            ]
            for t in bthreads:
                t.start()
            for t in bthreads:
                t.join()
            fleet.flush(timeout=120.0)
            flat_burst = [r for out in burst_rows for r in out]
            for _g, _s, _d, ticket in flat_burst:
                try:
                    ticket.wait(timeout=120.0)
                except Exception:
                    pass
            verify(flat_burst, "burst", rolled_graph=hot_graph)
        finally:
            fleet.spill_after = old_spill
        spills = fleet.stats()["spills"] - spill_before

        # ---- truth audit: seeded subsample vs the serial solver ------
        audit_bad = []
        audit_rng = np.random.default_rng(seed + 7)
        for g in [names[int(i)] for i in
                  audit_rng.choice(len(names), size=2, replace=False)]:
            keys = list(truth1[g]) or [(0, n - 1)]
            pick = audit_rng.choice(
                len(keys), size=min(16, len(keys)), replace=False
            )
            for i in pick:
                s, d = keys[int(i)]
                ref = solve_serial_csr(n, *csrs[g], s, d)
                got = truth_for(g, s, d)
                if got.found != ref.found or (
                    ref.found and got.hops != ref.hops
                ):
                    audit_bad.append(
                        f"truth {g} {s}->{d}: {got.found}/{got.hops} "
                        f"!= serial {ref.found}/{ref.hops}"
                    )

        # ---- live /metrics render ------------------------------------
        from bibfs_tpu_torch.fleet import FLEET_METRIC_FAMILIES as families
        try:
            with urllib.request.urlopen(
                metrics_server.url, timeout=10
            ) as resp:
                render = resp.read().decode()
        except Exception:
            render = REGISTRY.render()  # still check; live_ok records
            live_scrape = False
        else:
            live_scrape = True
        metrics_missing = [m for m in families if m not in render]

        fstats = fleet.stats()
        stranded = sum(
            fleet.replica(r).load() for r in fleet.replica_names
            if fleet.replica(r).alive
        )
        submitted = (
            2 * len(warm_stream)
            + 2 * max(int(qps_repeats), 1) * int(queries)
            + len(rows_c) + int(burst_queries)
        )
        out = {
            "n_per_graph": n,
            "graphs": len(names),
            "replicas": int(replicas),
            "grid": f"{w}x{h}",
            "queries_per_phase": int(queries),
            "hot_pool": int(hot_pool),
            "repeat_fraction": float(repeat_fraction),
            "cache_entries": int(cache_entries),
            "qps": {
                "single": None if qps_single is None
                else round(qps_single, 1),
                "fleet": None if qps_fleet is None
                else round(qps_fleet, 1),
                "ratio": ratio,
                "factor_gate": qps_factor,
                "single_timed_cache_served": int(single_hits),
                "fleet_timed_cache_served": int(fleet_hits),
            },
            "chaos": {
                "queries": len(stream_c),
                "rate_qps": round(rate, 1),
                "span_s": float(chaos_span_s),
                "victim": victim,
                "recovery_bound_s": float(recovery_bound_s),
                "recovery_s": (
                    None if recovery_s is None else round(recovery_s, 3)
                ),
            },
            "roll": {
                **roll_out,
                "changed_answers": int(changed),
                "mixed_versions_served": versions_mid,
                "post_versions": post_versions,
            },
            "spill": {
                "burst_queries": int(burst_queries),
                "spills": int(spills),
            },
            "router": {
                "routed": {
                    r: fstats["replicas"][r]["routed"]
                    for r in fstats["replicas"]
                },
                "reroutes": fstats["reroutes"],
                "spills_total": fstats["spills"],
                "rolls": fstats["rolls"],
            },
            "tickets": {
                "submitted": submitted,
                "failed": len(failed),
                "lost": len(lost),
                "stranded_outstanding": int(stranded),
            },
            "failed_sample": failed[:10],
            "mismatches": mismatches[:10],
            "truth_audit_mismatches": audit_bad[:10],
            "metrics": {
                "url": metrics_server.url,
                "live_scrape": live_scrape,
                "missing": metrics_missing,
            },
            "setup_to_drain_s": round(
                time.perf_counter() - t_setup, 3
            ),
            # the gates
            "zero_lost": not lost and stranded == 0,
            "zero_failed": not failed,
            "verified_vs_truth": not mismatches and not audit_bad,
            "qps_ok": (
                True if qps_factor is None
                else bool(ratio is not None
                          and ratio >= float(qps_factor))
            ),
            "recovery_ok": bool(
                recovery_s is not None
                and recovery_s <= recovery_bound_s
            ),
            "roll_ok": bool(
                roll_out.get("ok")
                and changed > 0
                and all(v == 2 for v in post_versions.values())
            ),
            "reroutes_ok": fstats["reroutes"] > 0,
            "spill_ok": spills > 0,
            "metrics_ok": bool(live_scrape and not metrics_missing),
        }
        out["ok"] = bool(
            out["zero_lost"] and out["zero_failed"]
            and out["verified_vs_truth"] and out["qps_ok"]
            and out["recovery_ok"] and out["roll_ok"]
            and out["reroutes_ok"] and out["spill_ok"]
            and out["metrics_ok"]
        )
        return out
    finally:
        sys.setswitchinterval(old_si)
        if single_router is not None:
            single_router.close()
        if fleet is not None:
            fleet.close()
        metrics_server.close()


