"""The PyTorch port's host rungs against the JAX package's on the CPU: the
native C++ runtime (``bibfs_tpu_torch.solvers.native``, built from the
port's own copy of ``bibfs_native.cpp``) against
``bibfs_tpu.solvers.native`` — single solves, scratch reuse over many
solves, the threaded batch at several thread counts, the deep-path cap,
the loader and its error paths — and the cutoff-seeded serial oracle
against ``bibfs_tpu.solvers.serial``. Every ``BFSResult`` field except
``time_s`` must be equal."""

import os
import struct

import numpy as np
import pytest

from tests.conftest import random_graph_cases

CASES = random_graph_cases(num=25, seed=42)
FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _gnp(n, avg, seed):
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    return gnp_random_graph(n, avg / n, seed=seed)


def test_library_is_built_from_the_port_source():
    """The port compiles its own byte-identical copy of the C++ source into
    its own build directory, and loads that library (never the JAX
    package's)."""
    from bibfs_tpu_torch.native import build
    from bibfs_tpu_torch.solvers import native

    ref_src = os.path.join(os.path.dirname(build.SRC), os.pardir, os.pardir,
                           "bibfs_tpu", "native", "bibfs_native.cpp")
    with open(build.SRC, "rb") as a, open(ref_src, "rb") as b:
        assert a.read() == b.read()
    so = build.ensure_built()
    assert os.path.dirname(so) == build.BUILD_DIR
    assert os.path.realpath(native._lib()._name) == os.path.realpath(so)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_native_solve_equals_reference(case):
    from bibfs_tpu.solvers.native import solve_native as ref_solve

    from bibfs_tpu_torch.solvers.api import solve
    from bibfs_tpu_torch.solvers.native import solve_native

    n, edges, src, dst = CASES[case]
    want = ref_solve(n, edges, src, dst)
    got = solve_native(n, edges, src, dst)
    assert _fields(got) == _fields(want)
    assert _fields(solve("native", n, edges, src, dst)) == _fields(want)
    if got.found:
        got.validate_path(n, edges, src, dst)


def test_native_csr_equals_reference():
    from bibfs_tpu.solvers.native import NativeGraph as RefGraph

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers.native import NativeGraph

    edges = _gnp(300, 3.0, 9)
    g = NativeGraph.build(300, edges)
    ref = RefGraph.build(300, edges)
    row_ptr, col_ind = build_csr(300, edges)
    np.testing.assert_array_equal(g.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(g.col_ind, ref.col_ind)
    np.testing.assert_array_equal(g.row_ptr, row_ptr)
    np.testing.assert_array_equal(g.col_ind, col_ind)


def test_scratch_reuse_equals_reference():
    """Sixty solves on one NativeGraph (the epoch-stamped scratch reused)
    equal the reference's solves field for field and the serial oracle in
    hops."""
    from bibfs_tpu.solvers.native import NativeGraph as RefGraph
    from bibfs_tpu.solvers.native import solve_native_graph as ref_solve

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers.native import NativeGraph, solve_native_graph
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    n = 2000
    edges = _gnp(n, 3.0, 5)
    g, gr = NativeGraph.build(n, edges), RefGraph.build(n, edges)
    row_ptr, col_ind = build_csr(n, edges)
    rng = np.random.default_rng(0)
    for _ in range(60):
        s, d = map(int, rng.integers(0, n, 2))
        got = solve_native_graph(g, s, d)
        assert _fields(got) == _fields(ref_solve(gr, s, d))
        want = solve_serial_csr(n, row_ptr, col_ind, s, d)
        assert (got.found, got.hops) == (want.found, want.hops)


@pytest.mark.parametrize("threads", [1, 2, 7, 64])
def test_native_batch_equals_reference(threads):
    """The threaded batch (each worker its own scratch over the shared
    CSR) equals the reference's batch at every thread count, including
    more threads than queries; one batch wall clock on every result."""
    from bibfs_tpu.solvers.native import NativeGraph as RefGraph
    from bibfs_tpu.solvers.native import solve_batch_native_graph as ref_batch

    from bibfs_tpu_torch.solvers.native import (
        NativeGraph,
        solve_batch_native_graph,
        solve_native_graph,
        time_batch_native,
    )

    n = 2000
    edges = _gnp(n, 3.0, 11)
    g, gr = NativeGraph.build(n, edges), RefGraph.build(n, edges)
    pairs = np.random.default_rng(2).integers(0, n, size=(23, 2))
    got = solve_batch_native_graph(g, pairs, threads=threads)
    want = ref_batch(gr, pairs, threads=threads)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert len({r.time_s for r in got}) == 1
    for (s, d), r in zip(pairs, got):
        one = solve_native_graph(g, int(s), int(d))
        assert (r.found, r.hops, r.path) == (one.found, one.hops, one.path)
    times, timed = time_batch_native(g, pairs, repeats=3, threads=threads)
    assert len(times) == 3
    assert [_fields(r) for r in timed] == [_fields(r) for r in got]


def test_native_batch_deep_path_cap_equals_reference():
    """On a path graph deeper than the 512-vertex default cap the batch
    reports hops only, as the reference does; a raised ``path_cap``
    restores the full path."""
    from bibfs_tpu.solvers.native import NativeGraph as RefGraph
    from bibfs_tpu.solvers.native import solve_batch_native_graph as ref_batch

    from bibfs_tpu_torch.solvers.native import (
        NativeGraph,
        solve_batch_native_graph,
        solve_native_graph,
    )

    n = 700
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g, gr = NativeGraph.build(n, edges), RefGraph.build(n, edges)
    single = solve_native_graph(g, 0, n - 1)
    assert single.hops == n - 1 and len(single.path) == n
    for cap in (None, n + 1):
        got = solve_batch_native_graph(g, [(0, n - 1), (0, 10)], path_cap=cap)
        want = ref_batch(gr, [(0, n - 1), (0, 10)], path_cap=cap)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert got[1].path == list(range(11))
        assert got[0].path == (None if cap is None else single.path)
    with pytest.raises(ValueError, match="path_cap"):
        solve_batch_native_graph(g, [(0, 1)], path_cap=0)
    with pytest.raises(ValueError, match="out of range"):
        solve_batch_native_graph(g, [(0, n)])


def test_native_io_equals_reference(tmp_path):
    from bibfs_tpu.solvers.native import read_graph_native as ref_read

    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.solvers.native import read_graph_native

    edges = np.array([[0, 1], [1, 2], [3, 0]])
    p = str(tmp_path / "g.bin")
    write_graph_bin(p, 4, edges)
    n, back = read_graph_native(p)
    n_ref, back_ref = ref_read(p)
    assert n == n_ref == 4
    np.testing.assert_array_equal(back, edges)
    np.testing.assert_array_equal(back, back_ref)


@pytest.mark.parametrize("kind,match", [
    ("missing", "cannot open"),
    ("truncated", "truncated"),
    ("out_of_range", "out of range"),
])
def test_native_io_errors_equal_reference(tmp_path, kind, match):
    from bibfs_tpu.solvers.native import read_graph_native as ref_read

    from bibfs_tpu_torch.solvers.native import read_graph_native

    p = tmp_path / f"{kind}.bin"
    if kind == "truncated":
        p.write_bytes(b"\x04\x00\x00\x00\x02\x00\x00\x00\x01\x00\x00\x00")
    elif kind == "out_of_range":  # n=2, one edge (0, 5)
        p.write_bytes(struct.pack("<4I", 2, 1, 0, 5))
    for reader in (read_graph_native, ref_read):
        with pytest.raises(RuntimeError, match=match):
            reader(str(p))


def test_loader_fuzz_equals_reference(tmp_path):
    """Mutated and truncated graph files either load to the same graph as
    the reference's native loader or fail in both."""
    from bibfs_tpu.solvers.native import read_graph_native as ref_read

    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.solvers.native import read_graph_native

    n = 60
    base = str(tmp_path / "base.bin")
    write_graph_bin(base, n, _gnp(n, 4.0, 8))
    blob = open(base, "rb").read()
    rng = np.random.default_rng(0)
    outcomes = set()
    for trial in range(60):
        b = bytearray(blob)
        kind = trial % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                b[int(rng.integers(len(b)))] = int(rng.integers(256))
        elif kind == 1:
            b = b[: int(rng.integers(len(b)))]
        else:
            b += bytes(rng.integers(0, 256, size=int(rng.integers(1, 16)),
                                    dtype=np.uint8))
        p = str(tmp_path / f"fuzz{trial}.bin")
        open(p, "wb").write(bytes(b))
        got = want = None
        try:
            got = read_graph_native(p)
        except RuntimeError as e:
            got = str(e)
        try:
            want = ref_read(p)
        except RuntimeError as e:
            want = str(e)
        assert type(got) is type(want)
        if isinstance(got, tuple):
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        outcomes.add(type(got))
    assert outcomes == {tuple, str}  # the corpus exercises both outcomes


@pytest.mark.parametrize("case", range(0, len(CASES), 3))
def test_serial_cutoff_equals_reference(case):
    """``solve_serial_csr(cutoff=)`` against the reference at the exact
    distance, a loose bound and a bound one too small (which reports
    not found, as the reference does)."""
    from bibfs_tpu.solvers.serial import solve_serial_csr as ref_serial

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    n, edges, src, dst = CASES[case]
    row_ptr, col_ind = build_csr(n, edges)
    base = solve_serial_csr(n, row_ptr, col_ind, src, dst)
    cutoffs = [None, 3 * n]
    if base.found:
        cutoffs += [base.hops, base.hops + 1, base.hops - 1]
    for cutoff in cutoffs:
        got = solve_serial_csr(n, row_ptr, col_ind, src, dst, cutoff=cutoff)
        want = ref_serial(n, row_ptr, col_ind, src, dst, cutoff=cutoff)
        assert _fields(got) == _fields(want), cutoff
        if cutoff is not None and base.found and cutoff >= base.hops:
            assert got.hops == base.hops


def test_cli_native_backend(tmp_path, capsys):
    """``bibfs-torch-solve --backend native``: one query and ``--pairs``."""
    from bibfs_tpu_torch.cli.solve import main
    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 120
    edges = _gnp(n, 3.0, 3)
    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, n, edges)
    want = solve_serial(n, edges, 0, n - 1)
    assert main([gpath, "0", str(n - 1), "--backend", "native"]) == 0
    out = capsys.readouterr().out
    if want.found:
        assert f"Shortest path length = {want.hops}" in out
    else:
        assert "No path found." in out
    assert "[Time] native bidirectional BFS" in out
    pairs = np.random.default_rng(4).integers(0, n, size=(6, 2))
    ppath = str(tmp_path / "p.txt")
    np.savetxt(ppath, pairs, fmt="%d")
    assert main([gpath, "--pairs", ppath, "--backend", "native",
                 "--no-path", "--repeat", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for (s, d), line in zip(pairs, lines):
        ref = solve_serial(n, edges, int(s), int(d))
        assert line == (f"{s} -> {d}: length = {ref.hops}" if ref.found
                        else f"{s} -> {d}: no path")
    assert lines[-1].startswith("[Time] native batch of 6 searches")
