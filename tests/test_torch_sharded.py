"""The port's vertex-sharded search and data-parallel batch
(bibfs_tpu_torch/solvers/sharded.py, solvers/batch_minor.py) on gloo
ranks against the JAX package's ``solve_sharded`` / ``solve_batch_dp`` on
its virtual CPU mesh of as many devices, at 1, 2 and 4 devices: every mode
on plain ELL (the endpoint in the last shard, ``src == dst``, an
unreachable pair), random graphs, the sharded batch, the data-parallel
batch, the CLI backend and the indivisible pad. The cases and the one
spawn per world size are in ``test_torch_sharded_cases.py``; the tiered
layout, ``--unroll``, the push/pull switch and the fields shared with the
dense search are in ``test_torch_sharded_tiered.py``."""

import numpy as np
import pytest

from tests.test_torch_sharded_cases import (
    BATCH_PAIRS,
    CASES,
    DP_PAIRS,
    ELL,
    MODES,
    WORLDS,
    _ref_graph,
    assert_same_raw,
    check_shared_with_dense,
    port,
    ref_raw,
)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_on_ell_matches_reference(world, mode):
    runs = port(world, "ell")
    for p in ELL[2]:
        got = runs["ell", mode, p, 1]
        assert got[0] == {"fused_alt": "pallas_alt"}.get(mode, mode)
        assert_same_raw(got, ref_raw("ell", world, mode, p), (mode, p))


@pytest.mark.parametrize("world", WORLDS)
def test_random_cases_match_reference(world):
    runs = port(world, "ell")
    for i, (_n, _e, s, d) in enumerate(CASES):
        assert_same_raw(runs[f"case{i}", "sync", (s, d), 1],
                        ref_raw(f"case{i}", world, "sync", (s, d)), i)


def _fields(r):
    return (r.found, r.hops, r.path, r.meet, r.levels, r.edges_scanned)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_matches_reference(world):
    """The sharded batch runs its queries one after another through the
    collective program; each equals the reference's vmapped batch."""
    from bibfs_tpu.solvers.sharded import solve_batch_sharded_graph

    for key, pairs, mode in (("ell", BATCH_PAIRS, "sync"),):
        got = port(world, "ell")["batch", key, mode]
        want = solve_batch_sharded_graph(_ref_graph(key, world), pairs,
                                         mode=mode)
        assert [_fields(r) for r in got] == [_fields(r) for r in want], key


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dt8", [False, True])
def test_data_parallel_batch_matches_reference(world, dt8):
    """The data-parallel batch (the graph replicated, each rank's slice
    of lane-padded queries) equals the reference's on a query mesh of as
    many devices, in ``minor`` and ``minor8``."""
    from bibfs_tpu.parallel.mesh import make_1d_mesh
    from bibfs_tpu.solvers import dense as jd
    from bibfs_tpu.solvers.batch_minor import QUERY_AXIS, solve_batch_dp

    n, e, _p = ELL
    gj = jd.DeviceGraph.build(n, e)
    want = solve_batch_dp(gj, DP_PAIRS, make_1d_mesh(world, axis=QUERY_AXIS),
                          dt8=dt8)
    got = port(world, "ell")["dp", dt8]
    assert len(got) == len(DP_PAIRS)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert {r.mode for r in got} == {"minor8" if dt8 else "minor"}


@pytest.mark.parametrize("world", WORLDS)
def test_profile_search_counts_rounds_and_collective_time(world):
    """``profile_search`` on gloo ranks: one dict a rank, a fused search's
    rounds (its host reads), the host's time inside the collectives within
    the wall, and no device numbers off the card."""
    runs = port(world, "ell")
    got, res = runs["profile", "fused"], runs["result", "fused"]
    assert [d["rank"] for d in got] == list(range(world))
    for d in got:
        assert d["rounds"] == res.host_syncs > 0
        assert 0 < d["collective_call_ms"] < d["wall_ms"]
        assert d["busy_ms"] is d["collective_kernel_ms"] is None


def test_reference_sharded_shares_recorded_fields_with_dense():
    """Every mode on the plain graph (two pairs); the tiered graphs' modes
    are in ``test_torch_sharded_tiered.py``."""
    check_shared_with_dense([("ell", m, ELL[2][:2]) for m in MODES], "ell")


def test_indivisible_rows_raise_in_both_packages():
    """``n_pad % size`` must be 0: both packages refuse the shard."""
    from bibfs_tpu.graph.csr import build_ell as jbuild
    from bibfs_tpu.parallel.mesh import make_1d_mesh
    from bibfs_tpu.solvers.sharded import ShardedGraph as JShardedGraph

    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.parallel.mesh import Mesh
    from bibfs_tpu_torch.solvers.sharded import ShardedGraph, build_host_graph

    edges = np.array([[0, 1], [1, 2]])
    g = build_ell(7, edges, pad_multiple=5)  # 10 rows over 4 ranks
    with pytest.raises(ValueError, match="not divisible"):
        ShardedGraph(g, Mesh(0, 4, "cpu", "gloo"))
    with pytest.raises(ValueError, match="not divisible"):
        JShardedGraph(jbuild(7, edges, pad_multiple=5), make_1d_mesh(4))
    with pytest.raises(ValueError, match="multiple of the 4-device"):
        build_host_graph(7, edges, 4, pad_multiple=6)


@pytest.mark.parametrize("mode", ["fused", "beamer_alt"])
def test_cli_sharded_backend_prints_the_serial_hops(tmp_path, mode):
    """``bibfs-torch-solve --backend sharded --devices 4 --device cpu``
    prints the hop count of ``--backend serial`` (two modes: each run
    spawns its four ranks)."""
    import contextlib
    import io

    from bibfs_tpu_torch.cli.solve import main
    from bibfs_tpu_torch.graph.io import write_graph_bin

    n, edges, pairs = ELL
    path = tmp_path / "g.bin"
    write_graph_bin(str(path), n, edges)
    src, dst = pairs[3]

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(path), str(src), str(dst), *argv]) == 0
        return buf.getvalue().splitlines()[0]

    want = run("--backend", "serial")
    assert want.startswith("Shortest path length = ")
    assert run("--backend", "sharded", "--devices", "4", "--device", "cpu",
               "--mode", mode) == want


@pytest.mark.parametrize("n,row_align,multiple", [(200, 1024, 3), (3000, 64, 4),
                                                   (50, 8, 7)])
def test_dp_table_and_repad_match_reference(n, row_align, multiple):
    """``serve/buckets.py``'s data-parallel table (``dp_aligned_ell``: rows
    on the fine ladder, width on its rung) and ``repad_rows`` equal the
    reference's array for array."""
    from bibfs_tpu.serve import buckets as jb

    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.serve import buckets as tb

    edges = gnp_random_graph(n, 5.0 / n, seed=n)
    gj = jb.dp_aligned_ell(n, edges, row_align=row_align)
    gt = tb.dp_aligned_ell(n, edges, row_align=row_align)
    for a, b in ((gj, gt), (jb.repad_rows(gj, multiple),
                            tb.repad_rows(gt, multiple))):
        assert (a.n, a.n_pad, a.width, a.num_edges) == (
            b.n, b.n_pad, b.width, b.num_edges)
        for f in ("nbr", "deg", "overflow"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert tb.repad_rows(gt, multiple).n_pad % multiple == 0
