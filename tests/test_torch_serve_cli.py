"""``bibfs-torch-serve`` prints the same result lines as ``bibfs-serve``
on the same ``.bin``, pairs file and stdin stream, sync and
``--pipeline`` (the port on ``--device cpu``); its stdin stream answers
``health`` / ``stats`` and bad lines in the stream, ``--inject-faults``
drives the resilience ladder, ``--stats-json`` writes the engine's
counters, and SIGTERM drains a subprocess with every queued result
printed. Under ``--store DIR --durable`` a stream and its respawn print
the reference's lines, recovery lines and ``memory`` payloads for each
``--fsync`` policy, and a server SIGKILLed after its acks comes back
with every acked update. Every wait has a timeout."""

import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    from bibfs_tpu.graph.io import write_graph_bin

    n = 120
    d = tmp_path_factory.mktemp("serve")
    edges = _skiplink_graph(n)
    # one isolated vertex: "no path" lines too
    write_graph_bin(d / "g.bin", n + 1, edges)
    pairs = np.random.default_rng(4).integers(0, n, size=(24, 2))
    pairs[3] = (5, 5)
    pairs[7] = (2, n)
    np.savetxt(d / "pairs.txt", pairs, fmt="%d")
    return str(d / "g.bin"), str(d / "pairs.txt"), n, edges, pairs


def _result_lines(out: str) -> list[str]:
    """The stream's lines but the control replies (whose JSON differs by
    package: the port adds ``device``)."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("health ", "stats "))]


def _error_lines(out: str) -> list[str]:
    return [ln for ln in _result_lines(out) if ln.startswith("error ")]


def _answer_lines(out: str) -> list[str]:
    return [ln for ln in _result_lines(out) if not ln.startswith("error ")]


def _run_both(capsys, monkeypatch, argv, stdin=None):
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    outs = []
    for main, extra in ((ref_main, []), (port_main, ["--device", "cpu"])):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        rc = main([*argv, *extra])
        outs.append((rc, capsys.readouterr()))
    return outs


@pytest.mark.parametrize("extra", [
    [], ["--no-path"], ["--pipeline", "--max-wait-ms", "20"],
    ["--pipeline", "--threshold", "8", "--mode", "minor8"],
    ["--threshold", "4", "--mode", "minor", "--layout", "tiered"],
])
def test_pairs_print_reference_lines(graph_file, capsys, monkeypatch, extra):
    gpath, ppath, *_ = graph_file
    (rc_r, ref), (rc_p, port) = _run_both(
        capsys, monkeypatch, [gpath, "--pairs", ppath, *extra])
    assert rc_r == rc_p == 0
    assert port.out.splitlines() == ref.out.splitlines()
    assert len(port.out.splitlines()) == 24
    assert "[Serve] 24 queries" in port.err


def test_pairs_lines_match_the_oracle(graph_file, capsys):
    from bibfs_tpu_torch.serve.cli import main
    from bibfs_tpu_torch.solvers.serial import solve_serial

    gpath, ppath, n, edges, pairs = graph_file
    assert main([gpath, "--pairs", ppath, "--no-path", "--pipeline",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for (s, d), line in zip(pairs, lines):
        ref = solve_serial(n + 1, edges, int(s), int(d))
        want = (f"{s} -> {d}: length = {ref.hops}" if ref.found
                else f"{s} -> {d}: no path")
        assert line == want


@pytest.mark.parametrize("pipeline", [False, True])
def test_stdin_stream_prints_reference_lines(graph_file, capsys, monkeypatch,
                                             pipeline):
    """A stream with queries, control commands and bad lines: the same
    result lines in the same order and the same error lines in the same
    order; ``health`` and ``stats`` answer one-line JSON. The two are
    compared as separate sequences: an error line prints when its input
    is read, a result line when its ticket resolves, and under
    ``--pipeline`` the deadline flusher resolves tickets on its own
    thread, so neither CLI orders errors against results."""
    gpath, *_ = graph_file
    stdin = ("0 50\nhealth\n\nbad line x\n3 40\nstats\nhealth now\n"
             "7 7\nx 4\n1 999\n2 120\n9 100\n")
    argv = [gpath] + (["--pipeline"] if pipeline else [])
    (rc_r, ref), (rc_p, port) = _run_both(capsys, monkeypatch, argv, stdin)
    assert rc_r == rc_p == 0
    assert _answer_lines(port.out) == _answer_lines(ref.out)
    assert _error_lines(port.out) == _error_lines(ref.out)
    assert any(ln.startswith("error invalid") for ln in port.out.splitlines())
    replies = [ln for ln in port.out.splitlines()
               if ln.startswith(("health ", "stats "))]
    assert [r.split(" ", 1)[0] for r in replies] == ["health", "stats"]
    health = json.loads(replies[0].split(" ", 1)[1])
    assert health["state"] == "ready"
    stats = json.loads(replies[1].split(" ", 1)[1])
    assert stats["device"] == "cpu" and "metrics_render" in stats
    if pipeline:
        assert "pipeline" in stats and "latency_ms" in stats


def test_stats_json_and_injected_faults(graph_file, tmp_path, capsys):
    """``--inject-faults`` fails every native host batch: the isolator
    bisects each batch down to single queries, which the serial rung
    answers; every answer is still the oracle's, and the stats file
    records the bisections, the fallbacks and the pipeline block."""
    from bibfs_tpu_torch.serve.cli import main
    from bibfs_tpu_torch.solvers.serial import solve_serial

    gpath, ppath, n, edges, pairs = graph_file
    spath = tmp_path / "stats.json"
    rc = main([gpath, "--pairs", ppath, "--no-path", "--pipeline",
               "--inject-faults", "host_batch:every=1",
               "--stats-json", str(spath), "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    for (s, d), line in zip(pairs, lines):
        ref = solve_serial(n + 1, edges, int(s), int(d))
        assert line.endswith(f"length = {ref.hops}" if ref.found
                             else "no path")
    stats = json.loads(spath.read_text())
    assert stats["queries"] == len(pairs)
    assert stats["resilience"]["fallbacks"]["host->serial"] >= 1
    assert stats["resilience"]["bisections"] >= 1
    assert stats["resilience"]["faults"]["fired_total"] >= 1
    assert not any(stats["resilience"]["errors"].values())
    assert "pipeline" in stats and "overlap" in stats


def test_bad_arguments_exit_2(graph_file, tmp_path, capsys):
    import torch

    from bibfs_tpu_torch.serve.cli import main

    gpath, *_ = graph_file
    assert main([str(tmp_path / "missing.bin"), "--device", "cpu"]) == 2
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n")
    assert main([gpath, "--pairs", str(bad), "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU fallback
        assert main([gpath, "--pairs", str(bad)]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_subprocess_sigterm_drains_queued_results(graph_file):
    """A pipelined server with queries queued past their deadline gets
    SIGTERM: it answers every queued query, then exits 0."""
    from bibfs_tpu_torch.solvers.serial import solve_serial

    gpath, _p, n, edges, _pairs = graph_file
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bibfs_tpu_torch.serve.cli", gpath,
         "--device", "cpu", "--pipeline", "--no-path",
         "--threshold", "1000", "--max-wait-ms", "600000"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
    )
    lines: queue.Queue = queue.Queue()

    def reader():
        for ln in proc.stdout:
            lines.put(ln.rstrip("\n"))
        lines.put(None)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    queries = [(0, 50), (3, 40), (9, 100)]
    try:
        for s, d in queries:
            proc.stdin.write(f"{s} {d}\n")
        proc.stdin.write("health\n")
        proc.stdin.flush()
        # the health reply says the loop (and its SIGTERM handler) is up;
        # the queries stay queued: no depth, no deadline, no EOF
        reply = lines.get(timeout=120.0)
        assert reply is not None and reply.startswith("health "), reply
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120.0)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    th.join(timeout=30.0)
    got = []
    while True:
        ln = lines.get(timeout=30.0)
        if ln is None:
            break
        got.append(ln)
    assert proc.returncode == 0, err
    assert "SIGTERM: draining" in err
    want = [f"{s} -> {d}: length = {solve_serial(n + 1, edges, s, d).hops}"
            for s, d in queries]
    assert got == want


def _store_dir(root, graph_file) -> str:
    import shutil

    os.makedirs(root, exist_ok=True)
    shutil.copy(graph_file[0], os.path.join(root, "g.bin"))
    return str(root)


@pytest.mark.parametrize("fsync", ["always", "batch", "off"])
def test_durable_stream_and_respawn_print_reference_lines(
        graph_file, tmp_path, capsys, monkeypatch, fsync):
    """``--store DIR --durable --fsync P``: a stream of updates, a swap and
    queries, then a second run on the same directory (the respawn), print
    the reference's lines in both runs, its ``[Store] recovered`` lines on
    stderr, and its ``memory`` payload; the respawn answers with every
    acked update."""
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    first = ("update add 0 119\n0 119\nupdate del 0 1\nswap\n"
             "update add 2 90\n2 90\nmemory\n")
    again = "0 119\n2 90\n0 1\ngraphs\nmemory\n"
    outs = {}
    for who, main, extra in (("ref", ref_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = _store_dir(tmp_path / who, graph_file)
        runs = []
        for stream in (first, again):
            monkeypatch.setattr("sys.stdin", io.StringIO(stream))
            rc = main(["--store", d, "--durable", "--fsync", fsync,
                       "--no-path", *extra])
            cap = capsys.readouterr()
            memory = [json.loads(ln[len("memory "):])
                      for ln in cap.out.splitlines()
                      if ln.startswith("memory ")]
            runs.append((
                rc, [ln for ln in cap.out.splitlines()
                     if not ln.startswith("memory ")],
                [ln for ln in cap.err.splitlines()
                 if ln.startswith("[Store] recovered")
                 or ln.startswith("[Store] serving")],
                memory,
            ))
        outs[who] = runs
    assert outs["port"] == outs["ref"]
    (rc1, out1, _e1, _m1), (rc2, out2, err2, mem2) = outs["port"]
    assert rc1 == rc2 == 0
    assert "0 -> 119: length = 1" in out2 and "2 -> 90: length = 1" in out2
    assert err2[0].endswith(f"(durable, fsync={fsync})")
    assert err2[1] == "[Store] recovered g: v2, 1 WAL record(s) replayed"
    assert mem2[0]["graphs"]["g"]["tier"] == "mapped"


def test_subprocess_sigkill_respawn_serves_every_acked_update(graph_file,
                                                              tmp_path):
    """A durable server (``--fsync always``) acks updates on stdin and is
    SIGKILLed with no drain; a respawn on the same directory recovers them
    from the WAL and answers with every acked edge."""
    from bibfs_tpu_torch.solvers.serial import solve_serial

    _g, _p, n, edges, _pairs = graph_file
    d = _store_dir(tmp_path / "store", graph_file)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "bibfs_tpu_torch.serve.cli", "--store", d,
           "--durable", "--fsync", "always", "--device", "cpu", "--no-path"]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    acked = [(0, 119), (3, 77), (10, 60)]
    lines: queue.Queue = queue.Queue()

    def reader():
        for ln in proc.stdout:
            lines.put(ln.rstrip("\n"))
        lines.put(None)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        for u, v in acked:
            proc.stdin.write(f"update add {u} {v}\n")
            proc.stdin.flush()
            reply = lines.get(timeout=120.0)
            assert reply == f"update g: +{acked.index((u, v)) + 1}/-0 pending"
        proc.kill()  # SIGKILL after the last ack
        proc.wait(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
        proc.stderr.close()
    th.join(timeout=30.0)
    assert proc.returncode == -signal.SIGKILL
    out = subprocess.run(cmd, input="".join(f"{u} {v}\n" for u, v in acked)
                         + "memory\n", capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[Store] recovered g: v1, 3 WAL record(s) replayed" in out.stderr
    got = [ln for ln in out.stdout.splitlines() if " -> " in ln]
    assert got == [f"{u} -> {v}: length = 1" for u, v in acked]
    assert solve_serial(n + 1, edges, 0, 119).hops > 1  # the update shows
    mem = [ln for ln in out.stdout.splitlines() if ln.startswith("memory ")]
    assert json.loads(mem[0][len("memory "):])["graphs"]["g"]["tier"] == \
        "mapped"
