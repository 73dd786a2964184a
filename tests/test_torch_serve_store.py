"""The port's store-backed and oracle-armed serving (``QueryEngine`` and
``PipelinedQueryEngine`` with ``store=`` / ``oracle_k=``,
``bibfs-torch-serve --store --oracle``) against the JAX package's on the
CPU, on the same seeded skewed traffic: answers, routes, counters and
cache stats across an update (the overlay route) and a compaction swap;
the swap barrier (a flush in flight finishes on the snapshot it pinned,
the next one takes the new snapshot, no cache entry outlives its
snapshot); the CLI's store and ``oracle`` commands."""

import io

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
COUNTERS = ("queries", "trivial", "oracle_served", "cache_served",
            "device_batches", "device_queries", "host_queries",
            "overlay_queries", "inserts_skipped")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _grid_and_twin():
    from bibfs_tpu_torch.graph.generate import grid_graph

    rows, cols = 18, 16
    n = rows * cols
    edges = grid_graph(rows, cols, perforation=0.05, seed=1)
    perm = np.random.default_rng(2).permutation(n)
    return n, edges, perm[edges]


def _traffic(n, edges, q, seed):
    from bibfs_tpu.serve.loadgen import sample_skewed_pairs as ref_sample

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.serve.loadgen import sample_skewed_pairs

    rp, _ci = build_csr(n, edges)
    kw = dict(seed=seed, skew=1.3, repeat_fraction=0.25, degrees=np.diff(rp))
    pairs = sample_skewed_pairs(n, q, **kw)
    np.testing.assert_array_equal(pairs, ref_sample(n, q, **kw))
    return pairs


def _stores(n, edges, twin, oracle_k=8):
    import bibfs_tpu.store as ref
    import bibfs_tpu_torch.store as port

    out = []
    for pkg, kw in ((ref, {}), (port, {"device": "cpu"})):
        store = pkg.GraphStore(compact_threshold=None, oracle_k=oracle_k,
                               **kw)
        store.add("grid", n, edges)
        store.add("twin", n, twin)
        for name in ("grid", "twin"):
            assert store.wait_for_index(name, timeout=60)
        out.append(store)
    return out


def _engines(kind, stores, **kw):
    from bibfs_tpu.serve import ExecutableCache as RefCache
    from bibfs_tpu.serve import PipelinedQueryEngine as RefPipe
    from bibfs_tpu.serve import QueryEngine as RefEngine

    from bibfs_tpu_torch.serve import (
        ExecutableCache,
        PipelinedQueryEngine,
        QueryEngine,
    )

    if kind == "pipelined":
        kw = dict(kw, max_wait_ms=None)
        ref = RefPipe(store=stores[0], exec_cache=RefCache(), **kw)
        port = PipelinedQueryEngine(store=stores[1], device="cpu",
                                    exec_cache=ExecutableCache(), **kw)
    else:
        ref = RefEngine(store=stores[0], exec_cache=RefCache(), **kw)
        port = QueryEngine(store=stores[1], device="cpu",
                           exec_cache=ExecutableCache(), **kw)
    return ref, port


def _same_wave(ref, port, pairs, graph):
    want = ref.query_many(pairs, graph=graph)
    got = port.query_many(pairs, graph=graph)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    sr, sp = ref.stats(), port.stats()
    for c in COUNTERS:
        assert sp[c] == sr[c], c
    assert sp["dist_cache"] == sr["dist_cache"]
    return got


def _check_truth(store, name, pairs, results):
    """Every answer against a search of the graph's live edges (the
    overlay's merged edges while updates are pending); oracle answers
    carry no path."""
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    ov = store.overlay(name)
    snap = store.current(name)
    live = ov.merged_edges() if ov is not None else snap.undirected_edges()
    rp, ci = build_csr(snap.n, live)
    for (s, d), r in zip(pairs, results):
        want = solve_serial_csr(snap.n, rp, ci, int(s), int(d))
        assert (r.found, r.hops) == (want.found, want.hops), (s, d)
        if r.path is not None:
            r.validate_path(snap.n, live, int(s), int(d))


@pytest.mark.parametrize("kind,device_batches", [
    ("sync", False), ("sync", True), ("pipelined", False),
])
def test_store_engines_equal_reference(kind, device_batches):
    """Skewed waves through both packages' engines over both stores: the
    oracle answers most of them at submit time (no path), the rest go to
    the cache and the solvers with the oracle's cutoff; then an update
    with a delete (the oracle steps aside, the overlay route answers,
    uncached), then a compaction (a new version and a rebuilt index)."""
    n, edges, twin = _grid_and_twin()
    stores = _stores(n, edges, twin)
    # the pipelined engine pops each wave whole (depth-only flushing)
    ref, port = _engines(kind, stores, flush_threshold=(
        8 if kind == "sync" else 1024), device_batches=device_batches,
        mode="minor8", cache_entries=16)
    try:
        pairs = _traffic(n, edges, 160, seed=3)
        got = _same_wave(ref, port, pairs[:100], "grid")
        _check_truth(stores[1], "grid", pairs[:100], got)
        oracle_served = port.counters["oracle_served"]
        assert oracle_served > 30
        assert all(r.path is None for r in got if r.levels == 0 and r.found
                   and r.hops > 0)
        twin_got = _same_wave(ref, port, pairs[:40], "twin")
        _check_truth(stores[1], "twin", pairs[:40], twin_got)
        # a live update with a delete: the overlay route, exact, uncached
        rng = np.random.default_rng(7)
        dels = [tuple(int(x) for x in edges[i])
                for i in rng.choice(len(edges), 6, replace=False)]
        for store in stores:
            store.update("grid", adds=[(0, n - 1)], dels=dels)
        assert stores[1].oracle("grid") is None
        got = _same_wave(ref, port, pairs[100:], "grid")
        _check_truth(stores[1], "grid", pairs[100:], got)
        assert port.counters["overlay_queries"] > 0
        # the compaction: version 2, a fresh index, the cache namespace new
        for store in stores:
            store.compact("grid")
            assert store.wait_for_index("grid", timeout=60)
        assert stores[1].current("grid").version == 2
        assert (stores[1].current("grid").digest
                == stores[0].current("grid").digest)
        got = _same_wave(ref, port, pairs[:100], "grid")
        _check_truth(stores[1], "grid", pairs[:100], got)
        sp, sr = port.stats(), ref.stats()
        assert sp["graph"]["graphs_resolved"] == sr["graph"]["graphs_resolved"]
        assert sp["graph"]["store_graph"] == sr["graph"]["store_graph"]
        if device_batches:
            assert port.counters["device_batches"] > 0
        assert not any(sp["resilience"]["errors"].values())
    finally:
        ref.close()
        port.close()
        for store in stores:
            store.close()
    st_p, st_r = stores[1].stats(), stores[0].stats()
    for name in ("grid", "twin"):
        a, b = st_p["graphs"][name], st_r["graphs"][name]
        assert a["oracle"]["hits"] == b["oracle"]["hits"], name
        assert (a["version"], a["digest"], a["swaps"]) == (
            b["version"], b["digest"], b["swaps"])


def test_inline_oracle_engines_equal_reference():
    """``oracle_k`` on an inline graph: the engine builds its index in the
    constructor (on the engine's device) and both packages answer the
    same traffic by the same routes, cutoffs included."""
    from bibfs_tpu.serve import ExecutableCache as RefCache
    from bibfs_tpu.serve import QueryEngine as RefEngine

    from bibfs_tpu_torch.serve import (
        ExecutableCache,
        PipelinedQueryEngine,
        QueryEngine,
    )

    n, edges, _twin = _grid_and_twin()
    pairs = _traffic(n, edges, 120, seed=5)
    kw = dict(oracle_k=6, flush_threshold=1024, cache_entries=8)
    ref = RefEngine(n, edges, exec_cache=RefCache(), **kw)
    port = QueryEngine(n, edges, device="cpu", exec_cache=ExecutableCache(),
                       **kw)
    pipe = PipelinedQueryEngine(n, edges, device="cpu", max_wait_ms=None,
                                exec_cache=ExecutableCache(), **kw)
    try:
        got = _same_wave(ref, port, pairs, None)
        assert port.counters["oracle_served"] > 0
        assert port.stats()["oracle"]["hits"] == ref.stats()["oracle"]["hits"]
        piped = pipe.query_many(pairs)
        assert [_fields(r)[:2] for r in piped] == [_fields(r)[:2] for r in got]
        assert pipe.counters["oracle_served"] == port.counters["oracle_served"]
    finally:
        ref.close()
        port.close()
        pipe.close()
    with pytest.raises(ValueError, match="oracle_k"):
        QueryEngine(n, edges, device="cpu", oracle_k=0)


def test_swap_barrier_and_no_stale_cache():
    """A flush in flight when the store swaps finishes on the snapshot it
    pinned; the next flush resolves the new snapshot; the old one retires
    when its last pin drops; a cached answer of the old version never
    answers the new one."""
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.solvers.serial import solve_serial
    from bibfs_tpu_torch.store import GraphSnapshot, GraphStore

    n, edges, twin = _grid_and_twin()
    store = GraphStore(compact_threshold=None)
    store.add("g", n, edges)
    eng = QueryEngine(store=store, device="cpu", flush_threshold=1024,
                      cache_entries=8)
    old = store.current("g")
    new = GraphSnapshot.build(n, twin, version=2)
    pairs = [(0, n - 1), (3, 200), (17, 130)]
    orig = eng._solve_host
    swapped = []

    def solve_then_swap(p, cutoffs=None):
        if not swapped:  # the swap lands mid-flush
            swapped.append(store.swap("g", new))
            assert eng.graph_id == old.digest  # this flush stays bound
        return orig(p, cutoffs)

    eng._solve_host = solve_then_swap
    try:
        first = eng.query_many(pairs)
        for (s, d), r in zip(pairs, first):
            assert r.hops == solve_serial(n, edges, s, d).hops
        assert swapped and not old.retired  # the engine's runtime pin
        second = eng.query_many(pairs)  # resolves the new snapshot
        for (s, d), r in zip(pairs, second):
            assert r.hops == solve_serial(n, twin, s, d).hops
        assert eng.counters["cache_served"] == 0  # no stale entry answered
        assert old.retired and eng.stats()["graph"]["version"] == 2
        assert eng.dist_cache.stats()["invalidations"] >= 1
        third = eng.query_many(pairs)
        assert [r.hops for r in third] == [r.hops for r in second]
        assert eng.counters["cache_served"] == len(pairs)
    finally:
        eng.close()
    assert new.refs == 1  # only the store's reference is left


def test_pipelined_flush_in_flight_at_swap():
    """The pipelined engine: a batch whose host solve is running when the
    store swaps resolves on its pinned snapshot; every ticket resolves, no
    ticket is lost or left outstanding, and later batches see the new
    version."""
    from bibfs_tpu_torch.serve import PipelinedQueryEngine
    from bibfs_tpu_torch.solvers.serial import solve_serial
    from bibfs_tpu_torch.store import GraphSnapshot, GraphStore

    n, edges, twin = _grid_and_twin()
    store = GraphStore(compact_threshold=None)
    store.add("g", n, edges)
    eng = PipelinedQueryEngine(store=store, device="cpu", max_wait_ms=None,
                               flush_threshold=1024)
    new = GraphSnapshot.build(n, twin, version=2)
    pairs = [(int(s), int(d)) for s, d in
             np.random.default_rng(4).integers(0, n, size=(30, 2)) if s != d]
    orig = eng._solve_host_isolated
    swapped = []

    def solve_then_swap(p, cutoffs=None):
        if not swapped:
            swapped.append(store.swap("g", new))
        return orig(p, cutoffs)

    eng._solve_host_isolated = solve_then_swap
    try:
        first = eng.query_many(pairs)
        second = eng.query_many(pairs)
        for (s, d), a, b in zip(pairs, first, second):
            assert a.hops == solve_serial(n, edges, s, d).hops
            assert b.hops == solve_serial(n, twin, s, d).hops
        st = eng.stats()
        assert st["pipeline"]["outstanding"] == 0
        assert not any(st["resilience"]["errors"].values())
    finally:
        eng.close()


def _write_store_dir(tmp_path):
    from bibfs_tpu.graph.io import write_graph_bin

    n, edges, twin = _grid_and_twin()
    write_graph_bin(tmp_path / "grid.bin", n, edges)
    write_graph_bin(tmp_path / "twin.bin", n, twin)
    return n, edges


def test_cli_store_and_oracle_commands_print_reference_lines(
        tmp_path, capsys, monkeypatch):
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    n, edges = _write_store_dir(tmp_path)
    e0 = tuple(int(x) for x in edges[0])
    stream = "\n".join([
        "graphs", "0 100", "use twin", "5 200", "use nope", "use grid",
        f"update del {e0[0]} {e0[1]}", "update add 0 287", "update add 0 1 2",
        "7 250", "0 287", "swap", "graphs", "0 287", "swap", "oracle",
        "oracle x", "update add 0 287",
    ]) + "\n"
    outs = []
    for main, extra in ((ref_main, []), (port_main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(stream))
        rc = main(["--store", str(tmp_path), "--oracle", "4", "--no-path",
                   *extra])
        outs.append((rc, capsys.readouterr()))
    (rc_r, ref), (rc_p, port) = outs

    def lines(out):  # the oracle status depends on the builder's timing
        return [ln for ln in out.splitlines()
                if not ln.startswith("oracle grid")]

    assert rc_r == rc_p == 0
    assert lines(port.out) == lines(ref.out)
    assert "graphs: *grid(v1) twin(v1)" in port.out
    assert "swap grid: v1 -> v2" in port.out
    assert "error invalid" in port.out
    status = [ln for ln in port.out.splitlines()
              if ln.startswith("oracle grid")]
    assert len(status) == 1 and "k=4" in status[0]
    assert "[Store] 2 graph(s), 1 swap(s)" in port.err


def test_cli_durable_flags_and_memory_name_the_durability_slice(
        tmp_path, capsys, monkeypatch):
    """The durability flags, once refused naming the durability slice, now
    run as the reference's do: each is accepted (exit 0) by both CLIs on a
    copy of one store directory, the stdin ``memory`` reply carries the
    reference's payload (tiers and bytes; the budget demotes, ``--no-mmap``
    leaves the recovered graphs hot), ``memory`` without ``--store`` and
    ``--durable`` without ``--store`` are refused by both."""
    import json
    import shutil

    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    src = tmp_path / "src"
    src.mkdir()
    _write_store_dir(src)

    def run(main, root, flags, stream, extra):
        monkeypatch.setattr("sys.stdin", io.StringIO(stream))
        rc = main(["--store", str(root), "--no-path", *flags, *extra])
        return rc, capsys.readouterr()

    def memory(out):
        got = [json.loads(ln[len("memory "):]) for ln in out.splitlines()
               if ln.startswith("memory ")]
        for reply in got:
            for g in reply["graphs"].values():
                g.pop("arrays", None)
        return got

    for flags in (["--durable"], ["--durable", "--fsync", "always"],
                  ["--durable", "--no-mmap"], ["--fsync", "off"],
                  ["--residency-budget", "100"], ["--no-mmap"]):
        outs = {}
        for who, main, extra in (("ref", ref_main, []),
                                 ("port", port_main, ["--device", "cpu"])):
            root = shutil.copytree(src, tmp_path / f"{who}-{len(flags)}"
                                   f"-{flags[-1].strip('-')}")
            first = run(main, root, flags, "memory\nupdate add 0 287\n"
                        "0 287\nmemory\n", extra)
            again = run(main, root, flags, "0 287\nmemory\n", extra)
            outs[who] = (first[0], again[0], first[1].out, again[1].out)
        (rc1, rc2, out1, out2), ref = outs["port"], outs["ref"]
        assert (rc1, rc2) == (ref[0], ref[1]) == (0, 0), flags
        assert memory(out1) == memory(ref[2]) and memory(out2) == memory(ref[3])
        plain = [ln for ln in out1.splitlines() if not ln.startswith("memory")]
        assert plain == [ln for ln in ref[2].splitlines()
                         if not ln.startswith("memory")]
        tiers = {g["tier"] for g in memory(out2)[-1]["graphs"].values()}
        if "--residency-budget" in flags:
            assert tiers == {"cold"}
        elif "--durable" in flags and "--no-mmap" not in flags:
            assert tiers == {"mapped"}
        else:
            assert tiers == {"hot"}
        # the durable runs answer the respawn with the acked edge
        if "--durable" in flags:
            assert "0 -> 287: length = 1" in out2
    for main, extra in ((ref_main, []), (port_main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("memory\n0 5\n"))
        assert main([str(src / "grid.bin"), *extra]) == 0
        assert "error invalid: 'memory' needs --store" in \
            capsys.readouterr().out
        assert main([str(src / "grid.bin"), "--durable", *extra]) == 2
        assert "--durable needs --store" in capsys.readouterr().err
    assert port_main([str(src / "grid.bin"), "--store", str(src),
                      "--device", "cpu"]) == 2
    assert "not both" in capsys.readouterr().err
