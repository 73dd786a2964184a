"""``bibfs-torch-fleet`` (``bibfs_tpu_torch/fleet/cli.py``) on the CPU:
the counterpart of ``tests/test_serve_drain.py``'s fleet case (SIGTERM
drains a child fleet process to exit 0 with every queued answer printed,
a second SIGTERM ignored), the stdin commands (``use``, ``update``,
``roll``, ``kill``, ``restart``, ``replicas``, ``health``, queries)
printing the same lines as the JAX package's ``bibfs-fleet`` on the same
store, ``--device cuda`` refused where there is no card, and the
aggregated scrape: child replicas' registries relabelled with their
replica name, as the reference relabels them.

Every wait has a timeout: a child process's ``communicate`` and each
replica's spawn bound."""

import io
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bibfs_tpu_torch.graph.io import write_graph_bin
from bibfs_tpu_torch.solvers.serial import solve_serial

SPAWN_S = 120.0


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


N = 80
EDGES = _skiplink_graph(N)


def test_fleet_cli_sigterm_graceful_drain(tmp_path):
    """SIGTERM parity with ``bibfs-torch-serve``'s one-shot handler: the
    replicas drain, everything queued resolves and PRINTS, the process
    exits 0, and a second SIGTERM mid-drain is ignored."""
    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "bibfs_tpu_torch.fleet.cli",
         str(gpath), "--replicas", "2", "--no-path", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        # readiness barrier: the health reply proves the REPL (and its
        # SIGTERM handler) is installed before the signal fires
        proc.stdin.write("health\n")
        proc.stdin.flush()
        ready = proc.stdout.readline()
        assert ready.startswith("health "), ready
        proc.stdin.write("0 50\n3 40\n")
        proc.stdin.flush()
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)  # ignored mid-drain
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    for s, d in ((0, 50), (3, 40)):
        ref = solve_serial(N, EDGES, s, d)
        assert f"{s} -> {d}: length = {ref.hops}" in out.splitlines()
    assert "SIGTERM" in err


SCRIPT = """\
health
0 50
use a
3 40
update add 0 79
update del 10 11
update add x 1
roll
0 79
11 60
restart nope
replicas
use b
0 79
5 5
bogus line here
health
"""

#: the chaos drills: which replica a query lands on after a kill, and
#: when the poller re-admits a restart, depend on thread timing, so these
#: lines are checked in the port alone
CHAOS = """use a
kill r0
0 50
kill r1
3 40
restart r0
restart r1
kill nope
5 60
"""


def _run_cli(main, argv, monkeypatch, capsys,
             script: str = SCRIPT) -> tuple[int, list]:
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, out


def test_fleet_cli_stdin_commands_match_reference(tmp_path, monkeypatch,
                                                  capsys):
    """The same stdin script over the same two-graph store through the
    JAX package's ``bibfs-fleet`` and through ``bibfs-torch-fleet
    --device cpu`` prints the same lines: answers before and after a
    rolling swap of staged updates, the routing listing, usage errors
    and the table."""
    from bibfs_tpu.fleet.cli import main as ref_main
    from bibfs_tpu_torch.fleet.cli import main as port_main

    store = tmp_path / "store"
    store.mkdir()
    write_graph_bin(store / "a.bin", N, EDGES)
    write_graph_bin(store / "b.bin", N, _skiplink_graph(N)[: -5])
    argv = ["--store", str(store), "--replicas", "3", "--use", "a",
            "--spill-after", "0"]
    rc_ref, ref = _run_cli(ref_main, argv, monkeypatch, capsys)
    rc, out = _run_cli(port_main, argv + ["--device", "cpu"], monkeypatch,
                       capsys)
    assert (rc, out) == (rc_ref, ref)
    assert rc == 0
    edges_v2 = np.vstack([EDGES[~((EDGES[:, 0] == 10) & (EDGES[:, 1] == 11))],
                          [[0, 79]]])
    assert any(line.startswith("0 -> 79: length = 1 ") for line in out)
    hops = solve_serial(N, edges_v2, 11, 60).hops
    assert any(line.startswith(f"11 -> 60: length = {hops} ") for line in out)
    assert any(line.startswith("roll a: ok=True") for line in out)
    assert any(line.startswith("replicas: r0(engine)") for line in out)
    assert any(line.startswith("error invalid: unknown replica") for line in out)


def test_fleet_cli_kill_restart_drills(tmp_path, monkeypatch, capsys):
    """``kill NAME`` / ``restart NAME`` on stdin: with two of three
    replicas killed the queries still answer exactly (rerouted), both
    restarts answer ok, an unknown name is a usage error, and the run
    exits 0."""
    from bibfs_tpu_torch.fleet.cli import main

    store = tmp_path / "store"
    store.mkdir()
    write_graph_bin(store / "a.bin", N, EDGES)
    rc, out = _run_cli(main, ["--store", str(store), "--replicas", "3",
                              "--no-path", "--device", "cpu"],
                       monkeypatch, capsys, CHAOS)
    assert rc == 0
    for name in ("r0", "r1"):
        assert f"kill {name}: ok" in out and f"restart {name}: ok" in out
    assert any(line.startswith("error invalid: unknown replica 'nope'")
               for line in out)
    for s, d in ((0, 50), (3, 40), (5, 60)):
        hops = solve_serial(N, EDGES, s, d).hops
        assert f"{s} -> {d}: length = {hops}" in out


def test_fleet_cli_device_cuda_without_card_exits_2(tmp_path, capsys):
    """``--device cuda`` (the default) where there is no card: the
    replicas cannot be built and the CLI exits 2 instead of serving on
    the CPU."""
    import torch

    from bibfs_tpu_torch.fleet.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the replicas would serve on it")
    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    assert main([str(gpath), "--replicas", "2"]) == 2
    assert "Error building replicas" in capsys.readouterr().err


def test_relabel_metrics_parity():
    """A child's Prometheus text relabelled with its replica name, line
    for line as the JAX package relabels it."""
    from bibfs_tpu.fleet.cli import _relabel_metrics as ref_relabel
    from bibfs_tpu_torch.fleet.cli import _relabel_metrics

    text = (
        "# HELP bibfs_queries_total Queries\n"
        "# TYPE bibfs_queries_total counter\n"
        'bibfs_queries_total{engine="engine-0",route="host"} 7\n'
        "bibfs_up 1\n\n"
        'bibfs_fleet_routed_total{router="r",replica="p0"} 3\n'
    )
    for name in ("p0", "n1"):
        got = _relabel_metrics(text, name)
        assert got == ref_relabel(text, name)
        assert f'bibfs_up{{replica="{name}"}} 1' in got.splitlines()
    assert _relabel_metrics("", "p0") == ref_relabel("", "p0") == ""


def test_fleet_scrape_relabels_child_registries(tmp_path):
    """The aggregated scrape behind ``--metrics-port``: the router
    process's registry (fleet families included) plus each subprocess
    replica's registry fetched over its control surface, every child
    sample carrying ``replica="NAME"``; a dead child's part is skipped,
    never failing the scrape."""
    from bibfs_tpu_torch.fleet import FLEET_METRIC_FAMILIES, ProcessReplica, Router
    from bibfs_tpu_torch.fleet.cli import _FleetScrape

    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    router = Router(
        [ProcessReplica(f"p{i}", str(gpath), device="cpu",
                        spawn_timeout_s=SPAWN_S) for i in range(2)],
        poll_interval_s=0.2,
    )
    try:
        assert router.query(0, 50).hops == solve_serial(N, EDGES, 0, 50).hops
        scrape = _FleetScrape()
        scrape.router = router
        text = scrape.render()
        for fam in FLEET_METRIC_FAMILIES:
            assert fam in text, fam
        lines = text.splitlines()
        for name in ("p0", "p1"):
            assert any(f'{{replica="{name}",' in ln for ln in lines), name
        router.replica("p1").kill()
        text = scrape.render()
        assert any('{replica="p0",' in ln for ln in text.splitlines())
        assert not any('{replica="p1",' in ln for ln in text.splitlines())
    finally:
        router.close()
