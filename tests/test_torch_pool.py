"""The port's persistent rank pool (``parallel/pool.py``) on gloo ranks:
descriptors run in the order they were sent, a rank killed with SIGKILL
fails the descriptors in flight with ``MeshError`` and the pool kills the
others, a CPU engine's ladder then serves that flush exactly (the JAX
package's degrade-on-anything ladder) and the route's next half-open
probe respawns the pool; a CUDA engine fails the tickets of a real
``MeshError`` (``kind='internal'``, counted on the mesh breaker) and
degrades only the injected ``mesh`` / ``mesh_finish`` faults, as the
reference's chaos seam does; a wait past the timeout takes the pool
down; ``close()`` leaves no child process. One pool serves the module
where the case allows."""

import os
import signal
import time

import numpy as np
import pytest


@pytest.fixture(scope="module")
def pool():
    import torch

    from bibfs_tpu_torch.parallel.pool import MeshPool

    torch.set_num_threads(2)
    p = MeshPool(2, "cpu", timeout_s=300)
    yield p
    p.close()


def _graph(n=300, seed=3):
    from bibfs_tpu.graph.generate import gnp_random_graph

    return gnp_random_graph(n, 3.0 / n, seed=seed)


def _pairs(n, k, seed):
    rng = np.random.default_rng(seed)
    out = [(int(s), int(d)) for s, d in rng.integers(0, n, size=(4 * k, 2))
           if s != d]
    return out[:k]


def _oracle(n, edges, pairs, results):
    from bibfs_tpu.solvers.serial import solve_serial

    for (s, d), r in zip(pairs, results):
        ref = solve_serial(n, edges, s, d)
        assert (r.found, r.hops) == (ref.found, ref.hops), (s, d)


def _register(pool, key, n, edges, where=None):
    from bibfs_tpu_torch.solvers.sharded import build_host_graph, save_host_graph

    path = save_host_graph(build_host_graph(n, edges, pool.ranks),
                           os.path.join(pool.workdir, where or key))
    pool.graph(key, path)
    return path


def test_descriptors_run_in_order(pool):
    """A graph registered, used by three jobs sent back to back (none
    waited on), released and registered again under the same key with
    other edges: every rank runs them in the order sent, so each job sees
    the graph registered before it; the answers are waited on in reverse
    order. The ranks are the ones the pool spawned (no respawn)."""
    n = 300
    e1, e2 = _graph(n, 3), _graph(n, 4)
    gen = pool.generation
    _register(pool, "g", n, e1)
    pairs = _pairs(n, 6, 1)
    seqs = [pool.jobs([dict(kind="batch", graph="g", pairs=pairs[i::3],
                            mode=m)]) for i, m in enumerate(
                                ("sync", "fused", "pallas"))]
    pool.release("g")
    _register(pool, "g", n, e2, where="g-again")
    last = pool.jobs([dict(kind="batch", graph="g", pairs=pairs,
                           mode="sync")])
    got = pool.wait(last)["results"][0]
    _oracle(n, e2, pairs, got)
    for i, seq in reversed(list(enumerate(seqs))):
        _oracle(n, e1, pairs[i::3], pool.wait(seq)["results"][0])
    assert pool.generation == gen and pool.up
    pool.release("g")


def test_pool_counts_and_hello(pool):
    """``counts`` sums the ranks' kernel launch counts (none on the CPU,
    where the wrappers run their plain twins) and ``hello`` answers with
    rank 0's placement."""
    counts = pool.counts(reset=True)
    assert set(counts) >= {"fused_dual_round", "pull_dual", "pull_single",
                           "minor_level[minor8]"}
    assert all(v == 0 for v in counts.values())
    hello = pool.call("hello")
    assert hello["rank"] == 0 and hello["transport"] == "gloo"
    assert hello["pid"] in pool.pids()


def test_killed_rank_fails_launch_then_probe_respawns():
    """SIGKILL one rank of an engine's pool: the next flush's mesh launch
    fails with MeshError, the CPU engine's ladder serves that flush on the
    host exactly (counted mesh->host), and the mesh breaker's next
    half-open probe respawns the pool (a new generation, the graph shipped
    again) and serves on the mesh."""
    from bibfs_tpu_torch.serve import CircuitBreaker, QueryEngine, RetryPolicy
    from bibfs_tpu_torch.serve.routes import MeshConfig

    n = 300
    edges = _graph(n, 5)
    eng = QueryEngine(n, edges, mesh=MeshConfig(devices=2, shard_min_n=0),
                      flush_threshold=4, device="cpu")
    route = eng.routes["mesh"]
    route.breaker = CircuitBreaker(fail_threshold=1, reset_s=0.2)
    route.retry = RetryPolicy(2, base_ms=0.0)
    try:
        pairs = _pairs(n, 8, 2)
        _oracle(n, edges, pairs, eng.query_many(pairs))
        assert eng.stats()["mesh_queries"] == 8
        gen = route.pool.generation
        os.kill(route.pool.pids()[1], signal.SIGKILL)
        pairs2 = _pairs(n, 8, 3)
        _oracle(n, edges, pairs2, eng.query_many(pairs2))
        st = eng.stats()
        assert st["mesh_queries"] == 8 and st["host_queries"] == 8
        assert st["resilience"]["fallbacks"]["mesh->host"] == 1
        assert not route.pool.up
        time.sleep(0.3)  # the breaker's open window elapses
        pairs3 = _pairs(n, 8, 4)
        _oracle(n, edges, pairs3, eng.query_many(pairs3))
        assert eng.stats()["mesh_queries"] == 16
        assert route.pool.up and route.pool.generation == gen + 1
        assert route.breaker.state == "closed"
    finally:
        eng.close()


def _cuda_typed(monkeypatch, pool, n, edges, **kw):
    """A port engine whose device reads as ``cuda`` over a pool of CPU
    ranks (no card needed: ``mode="sync"``, no kernel build)."""
    import torch

    from bibfs_tpu_torch.ops import _cuda
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod
    from bibfs_tpu_torch.serve.routes import MeshConfig

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(_cuda, "lib", lambda source: None)
    monkeypatch.setattr(pool, "device", "cuda")
    return QueryEngine(n, edges, mode="sync", host_backend="serial",
                       exec_cache=ExecutableCache(), flush_threshold=4,
                       mesh=MeshConfig(pool=pool, shard_min_n=0), **kw)


def test_cuda_engine_fails_tickets_on_mesh_error(monkeypatch):
    """On a CUDA engine a dead pool is the mesh's failure, not a routing
    one: the flush's tickets fail with ``kind='internal'``, nothing is
    answered on another rung, and each failure counts on the mesh breaker
    (which opens, and whose probe respawns the pool)."""
    from bibfs_tpu_torch.parallel.pool import MeshPool
    from bibfs_tpu_torch.serve import CircuitBreaker, QueryError

    n = 300
    edges = _graph(n, 6)
    pool = MeshPool(2, "cpu", timeout_s=120)
    eng = _cuda_typed(monkeypatch, pool, n, edges)
    route = eng.routes["mesh"]
    route.breaker = CircuitBreaker(fail_threshold=2, reset_s=0.2)
    try:
        os.kill(pool.pids()[0], signal.SIGKILL)
        for k in range(2):
            out = eng.query_many(_pairs(n, 6, 10 + k), return_errors=True)
            assert all(isinstance(r, QueryError) and r.kind == "internal"
                       for r in out)
        st = eng.stats()
        assert st["mesh_queries"] == st["host_queries"] == 0
        assert not any(st["resilience"]["fallbacks"].values())
        assert route.breaker.snapshot()["opens"] == 1
        time.sleep(0.3)
        pairs = _pairs(n, 6, 20)
        _oracle(n, edges, pairs, eng.query_many(pairs))
        assert eng.stats()["mesh_queries"] == 6 and pool.generation == 2
    finally:
        eng.close()
        pool.close()


@pytest.mark.parametrize("site", ["mesh", "mesh_finish"])
def test_cuda_engine_degrades_injected_mesh_faults(monkeypatch, pool, site):
    """The chaos seam drives the ladder on a CUDA engine too: an injected
    ``mesh`` / ``mesh_finish`` fault retries and degrades the flush to the
    next eligible rung, counted, as the reference's ladder does."""
    from bibfs_tpu_torch.serve import FaultPlan, RetryPolicy

    n = 300
    edges = _graph(n, 7)
    eng = _cuda_typed(monkeypatch, pool, n, edges,
                      faults=FaultPlan.parse(f"{site}:times=2"),
                      retry=RetryPolicy(2, base_ms=0.0),
                      device_batches=False)  # the next rung: the host
    try:
        pairs = _pairs(n, 6, 30)
        _oracle(n, edges, pairs, eng.query_many(pairs))
        res = eng.stats()["resilience"]
        assert res["fallbacks"]["mesh->host"] == 1 and res["retries"] == 1
        assert eng.stats()["mesh_queries"] == 0
        pairs = _pairs(n, 6, 31)
        _oracle(n, edges, pairs, eng.query_many(pairs))
        assert eng.stats()["mesh_queries"] == 6
    finally:
        eng.close()


def test_wait_past_timeout_takes_the_pool_down():
    """A descriptor that outlasts its wait fails with MeshError, the pool
    is down (every later submit refused) until ``ensure_up``; ``close()``
    leaves no child process."""
    import multiprocessing

    from bibfs_tpu_torch.parallel.pool import MeshError, MeshPool

    n = 300
    pool = MeshPool(2, "cpu", timeout_s=120)
    pids = pool.pids()
    _register(pool, "g", n, _graph(n, 8))
    seq = pool.jobs([dict(kind="batch", graph="g", pairs=_pairs(n, 64, 9),
                          mode="alt")])
    with pytest.raises(MeshError, match="outlasted"):
        pool.wait(seq, timeout=0.0)
    assert not pool.up
    with pytest.raises(MeshError, match="down"):
        pool.jobs([])
    pool.ensure_up()
    assert pool.up and pool.generation == 2
    pids += pool.pids()
    pool.close()
    live = {p.pid for p in multiprocessing.active_children()}
    assert not live & set(pids)
    assert not os.path.exists(pool.workdir)
    with pytest.raises(MeshError, match="closed"):
        pool.ensure_up()
