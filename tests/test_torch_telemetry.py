"""Per-level telemetry in the PyTorch port (``bibfs_tpu_torch.obs.
telemetry`` and the ``telemetry=`` hooks) against ``bibfs_tpu`` on the
CPU: ``level_stats`` and every result field but the time equal the
reference's for the serial oracle, the native runtime and the dense
search's level-by-level drive in every mode on both layouts, unreachable
and trivial queries included; with telemetry off the results are the
plain solvers' and carry no ``level_stats``; ``bibfs-torch-solve
--level-stats`` prints the reference's ``[Level]`` lines."""

import dataclasses

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
DENSE_MODES = ("sync", "alt", "beamer", "beamer_alt", "pallas", "pallas_alt",
               "fused", "fused_alt", "sync_unfused")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


def _graphs():
    from bibfs_tpu_torch.graph.generate import rmat_graph

    n_r, e_r = rmat_graph(8, edge_factor=6, seed=1)
    return {
        "skiplink": (200, _skiplink_graph(200)),
        "rmat8": (n_r, e_r),
        # 0-1-2 and 3-4: 0 -> 4 is unreachable
        "split": (5, np.array([[0, 1], [1, 2], [3, 4]])),
    }


GRAPHS = _graphs()
QUERIES = {
    "skiplink": [(0, 190), (3, 60), (5, 5)],
    "rmat8": [(0, 5), (3, 200), (1, 255), (7, 7)],
    "split": [(0, 4), (0, 2)],
}


def _check_consistent(res):
    """Entries match the aggregate counters and the meet level is a real
    level."""
    ls = res.level_stats
    assert len(ls["levels"]) == res.levels
    assert sum(lv["edges"] for lv in ls["levels"]) == res.edges_scanned
    for i, lv in enumerate(ls["levels"]):
        assert lv["side"] in ("s", "t") and lv["dir"] in ("push", "pull")
        assert lv["level"] >= i + 1
    if res.found and res.hops > 0:
        assert 1 <= ls["meet_level"] <= res.levels
    if not res.found:
        assert ls["meet_level"] is None


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_serial_and_native_level_stats_equal_reference(name):
    from bibfs_tpu.solvers.native import solve_native as ref_native
    from bibfs_tpu.solvers.serial import solve_serial as ref_serial

    from bibfs_tpu_torch.solvers.native import solve_native
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges = GRAPHS[name]
    for s, d in QUERIES[name]:
        for port, ref in ((solve_serial, ref_serial),
                          (solve_native, ref_native)):
            got = port(n, edges, s, d, telemetry=True)
            want = ref(n, edges, s, d, telemetry=True)
            assert _fields(got) == _fields(want), (port.__name__, s, d)
            assert got.level_stats == want.level_stats, (port.__name__, s, d)
            _check_consistent(got)
            off = port(n, edges, s, d)
            assert off.level_stats is None
            assert _fields(off) == _fields(got)


@pytest.mark.parametrize("layout", ["ell", "tiered"])
@pytest.mark.parametrize("mode", DENSE_MODES)
def test_dense_level_stats_equal_reference(mode, layout):
    """The level-by-level drive: the reference's level records, meet
    level and result fields in every mode, the same fields as the
    untraced search, and push levels only in a Beamer mode."""
    from bibfs_tpu.solvers import dense as ref_dense

    from bibfs_tpu_torch.solvers import dense

    for name in ("rmat8", "split", "skiplink"):
        n, edges = GRAPHS[name]
        rg = ref_dense.DeviceGraph.build(n, edges, layout=layout)
        pg = dense.DeviceGraph.build(n, edges, layout=layout, device="cpu")
        for s, d in QUERIES[name]:
            got = dense.solve_dense_graph(pg, s, d, mode=mode, telemetry=True)
            want = ref_dense.solve_dense_graph(rg, s, d, mode=mode,
                                               telemetry=True)
            assert _fields(got) == _fields(want), (name, s, d)
            assert got.level_stats == want.level_stats, (name, s, d)
            _check_consistent(got)
            off = dense.solve_dense_graph(pg, s, d, mode=mode)
            assert off.level_stats is None
            assert _fields(off) == _fields(got)
            dirs = {lv["dir"] for lv in got.level_stats["levels"]}
            if not mode.startswith("beamer"):
                assert dirs <= {"pull"}


def test_dense_trivial_query_has_no_levels():
    from bibfs_tpu_torch.solvers.dense import solve_dense

    n, edges = GRAPHS["skiplink"]
    res = solve_dense(n, edges, 5, 5, telemetry=True, device="cpu")
    assert res.found and res.hops == 0
    assert res.level_stats == {"levels": [], "meet_level": None,
                               "meet": None}


def test_collector_passthrough_and_coerce():
    from bibfs_tpu_torch.obs.telemetry import LevelTelemetry, coerce
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges = GRAPHS["skiplink"]
    tel = LevelTelemetry()
    res = solve_serial(n, edges, 3, 60, telemetry=tel)
    assert res.level_stats["levels"] is tel.levels
    assert tel.n == n  # re-stamped per solve
    assert coerce(None) is None and coerce(False) is None
    assert isinstance(coerce(True), LevelTelemetry)
    assert coerce(tel) is tel


def test_frontier_fraction_histogram_and_opt_out():
    """Telemetry that knows ``n`` lands each level's frontier / n in the
    process histogram; ``n=0`` records the levels without it."""
    from bibfs_tpu_torch.obs.telemetry import (
        LevelTelemetry,
        frontier_fraction_hist,
    )
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges = GRAPHS["skiplink"]
    cell = frontier_fraction_hist().labels()  # the zero-label family's cell
    count0 = cell.count
    res = solve_serial(n, edges, 0, 190, telemetry=True)
    assert cell.count == count0 + res.levels
    quiet = LevelTelemetry(n=0)
    res = solve_serial(n, edges, 0, 190, telemetry=quiet)
    assert cell.count == count0 + res.levels and quiet.n == 0
    assert len(quiet.levels) == res.levels


def test_api_solve_telemetry_passthrough():
    from bibfs_tpu.solvers.api import solve as ref_solve

    from bibfs_tpu_torch.solvers.api import solve

    n, edges = GRAPHS["skiplink"]
    for backend in ("serial", "native", "dense"):
        extra = {"device": "cpu"} if backend == "dense" else {}
        res = solve(backend, n, edges, 0, 100, telemetry=True, **extra)
        want = ref_solve(backend, n, edges, 0, 100, telemetry=True)
        assert res.level_stats == want.level_stats, backend
        plain = solve(backend, n, edges, 0, 100, **extra)
        assert plain.level_stats is None
        a, b = dataclasses.asdict(plain), dataclasses.asdict(res)
        for key in ("time_s", "level_stats", "mode", "host_syncs"):
            a.pop(key), b.pop(key)
        assert a == b, backend


@pytest.mark.parametrize("extra", [
    ["--backend", "serial"], ["--backend", "native"],
    ["--backend", "dense", "--mode", "beamer"],
    ["--backend", "dense", "--mode", "pallas_alt", "--layout", "tiered"],
])
def test_cli_level_stats_prints_reference_lines(tmp_path, capsys, extra):
    from bibfs_tpu.cli import solve as jcli
    from bibfs_tpu.graph.io import write_graph_bin

    from bibfs_tpu_torch.cli import solve as tcli

    n, edges = GRAPHS["rmat8"]
    path = str(tmp_path / "g.bin")
    write_graph_bin(path, n, edges)

    def level_lines(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("[Level]", "Shortest", "No path"))]

    for s, d in ((3, 200), (7, 7)):
        assert jcli.main([path, str(s), str(d), *extra,
                          "--level-stats"]) == 0
        want = capsys.readouterr().out
        device = ["--device", "cpu"] if "dense" in extra else []
        assert tcli.main([path, str(s), str(d), *extra, *device,
                          "--level-stats"]) == 0
        got = capsys.readouterr().out
        assert level_lines(got) == level_lines(want)
        assert "[Level] meet_level=" in got


def test_cli_level_stats_is_single_query_only(tmp_path, capsys):
    from bibfs_tpu.graph.io import write_graph_bin

    from bibfs_tpu_torch.cli import solve as tcli

    n, edges = GRAPHS["skiplink"]
    path = str(tmp_path / "g.bin")
    write_graph_bin(path, n, edges)
    pairs = tmp_path / "p.txt"
    pairs.write_text("0 5\n")
    for argv in ([path, "--pairs", str(pairs), "--backend", "native"],
                 [path, "0", "5", "--backend", "serial", "--repeat", "2"]):
        with pytest.raises(SystemExit):
            tcli.main([*argv, "--level-stats"])
        assert "single-query" in capsys.readouterr().err
