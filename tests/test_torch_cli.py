"""``bibfs-torch-solve`` prints the same answer lines as ``bibfs-solve``."""

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    from bibfs_tpu.graph.generate import gnp_random_graph
    from bibfs_tpu.graph.io import write_graph_bin

    n = 400
    path = tmp_path_factory.mktemp("cli") / "g.bin"
    write_graph_bin(path, n, gnp_random_graph(n, 3.0 / n, seed=2))
    return str(path), n


def _answer_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines()
            if ln.startswith(("Shortest path length", "Path:", "No path"))]


@pytest.mark.parametrize("extra", [
    ["--backend", "serial"],
    ["--backend", "dense", "--mode", "sync"],
    ["--backend", "dense", "--mode", "fused", "--unroll", "2"],
    ["--backend", "dense", "--mode", "pallas_alt", "--layout", "tiered"],
    ["--backend", "dense", "--mode", "fused_alt", "--repeat", "2"],
])
def test_cli_prints_reference_lines(graph_file, extra, capsys):
    from bibfs_tpu.cli import solve as jcli

    from bibfs_tpu_torch.cli import solve as tcli

    path, n = graph_file
    for s, d in ((0, n - 1), (3, 3)):
        assert jcli.main([path, str(s), str(d), *extra]) == 0
        want = capsys.readouterr().out
        device = ["--device", "cpu"] if "dense" in extra else []
        assert tcli.main([path, str(s), str(d), *extra, *device]) == 0
        got = capsys.readouterr().out
        assert _answer_lines(got) == _answer_lines(want)
        assert _answer_lines(got)
        assert "[Time]" in got and "[TEPS]" in got


def test_cli_unreachable_and_errors(tmp_path, capsys, monkeypatch):
    import torch

    from bibfs_tpu.graph.io import write_graph_bin

    from bibfs_tpu_torch.cli import solve as tcli

    path = tmp_path / "two.bin"
    write_graph_bin(path, 4, np.array([[0, 1], [2, 3]]))
    assert tcli.main([str(path), "0", "3", "--backend", "dense",
                      "--device", "cpu"]) == 0
    assert "No path found." in capsys.readouterr().out
    assert tcli.main([str(tmp_path / "missing.bin"), "0", "1"]) == 2
    assert "Error reading graph" in capsys.readouterr().err
    # the dense backend defaults to CUDA and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main([str(path), "0", "1", "--backend", "dense"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli.main([str(path), "0", "1", "--backend", "serial", "--mode", "fused"])


def test_cli_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    """With no flags the CLI runs the dense search on CUDA, and raises
    without a card; the serial oracle runs only when asked for, and never
    claims the card."""
    import torch

    from bibfs_tpu.graph.io import write_graph_bin

    from bibfs_tpu_torch.cli import solve as tcli

    path = tmp_path / "line.bin"
    write_graph_bin(path, 3, np.array([[0, 1], [1, 2]]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main([str(path), "0", "2"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert tcli.main([str(path), "0", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Shortest path length = 2" in out and "[Time] dense" in out
    assert tcli.main([str(path), "0", "2", "--backend", "serial"]) == 0
    assert "[Time] serial" in capsys.readouterr().out
    assert tcli.main([str(path), "0", "2", "--backend", "serial",
                      "--device", "cpu"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tcli.main([str(path), "0", "2", "--backend", "serial", "--device", "cuda"])


def test_ab_runs_two_checkouts_in_turns(capsys):
    """``cli/ab.py`` against this very checkout as the parent (tiny graph,
    CPU): both load side by side, every solve agrees, each mode is timed
    in each checkout, and the modules it swapped are put back."""
    import json
    import sys
    from pathlib import Path

    from bibfs_tpu_torch.cli import ab
    from bibfs_tpu_torch.solvers import dense

    root = Path(ab.__file__).resolve().parents[2]
    before = {m: id(mod) for m, mod in sys.modules.items()
              if m.startswith("bibfs_tpu_torch")}
    assert ab.main([str(root), "--scale", "8", "--rounds", "2",
                    "--modes", "pallas,pallas_alt,sync", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["same_results"] is True and out["card"] == "cpu"
    for who in ("parent", "change"):
        for mode in ("pallas", "pallas_alt", "sync"):
            row = out[f"{who}/{mode}"]
            assert row["solves"] == 16 and row["median_ms"] > 0
    after = {m: id(mod) for m, mod in sys.modules.items()
             if m.startswith("bibfs_tpu_torch")}
    assert after == before and sys.modules["bibfs_tpu_torch.solvers.dense"] is dense


def test_ab_blocked_times_blocked_batches_of_both_checkouts(capsys):
    """``cli/ab.py --blocked`` against this very checkout as the parent
    (the 64x64 grid, a small batch, CPU): both checkouts' blocked batches
    agree on every raw output, each is timed with its host reads, and the
    modules it swapped are put back."""
    import json
    import sys
    from pathlib import Path

    from bibfs_tpu_torch.cli import ab
    from bibfs_tpu_torch.solvers import dense

    root = Path(ab.__file__).resolve().parents[2]
    assert ab.main([str(root), "--blocked", "grid-64x64", "--batch", "8",
                    "--rounds", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["same_results"] is True and out["card"] == "cpu"
    assert (out["geometry"], out["n"], out["batch"]) == ("grid-64x64", 4096, 8)
    for who in ("parent", "change"):
        row = out[f"{who}/blocked"]
        assert row["batches"] == 1 and row["median_ms"] > 0
        assert row["host_reads_per_batch"] > 2
    assert sys.modules["bibfs_tpu_torch.solvers.dense"] is dense


@pytest.mark.parametrize("geom", ["grid-20x20", "gnp-deg8-s10"])
def test_ab_kinds_times_both_checkouts_kernels(geom, capsys):
    """``cli/ab.py --kinds`` against this very checkout as the parent (a
    small grid and gnp graph, CPU): both checkouts' delta-stepping and
    restricted sweeps agree (distances, counts, planes, levels), each is
    timed in turns, and the modules it swapped are put back."""
    import json
    import sys
    from pathlib import Path

    from bibfs_tpu_torch.cli import ab
    from bibfs_tpu_torch.solvers import query_device

    root = Path(ab.__file__).resolve().parents[2]
    assert ab.main([str(root), "--kinds", geom, "--rounds", "2",
                    "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["same_results"] is True and out["card"] == "cpu"
    assert out["geometry"] == geom
    pairs = 1 if geom.startswith("grid") else 4
    assert len(out["delta_pairs"]) == pairs and out["candidates"] >= 1
    for who in ("parent", "change"):
        row = out[f"{who}/delta_stepping"]
        assert row["solves"] == 2 * pairs and row["median_ms"] > 0
        assert row["status"]["passes"] >= 2
        row = out[f"{who}/restricted_sweep"]
        assert row["solves"] == 2 and row["status"]["run"] >= 1
    assert sys.modules["bibfs_tpu_torch.solvers.query_device"] is query_device
    with pytest.raises(ValueError, match="no geometry"):
        ab.main([str(root), "--kinds", "ring-9", "--device", "cpu"])


def test_ab_build_split_parts_sum_to_the_build():
    """``cli/ab.py``'s ``build_split`` (what ``--oracle`` and
    ``chip_smoke.py`` phase 11 time) on a small grid on the CPU: the index
    equals the host build's, the four parts add up to the build, none is
    negative, and the functions it wrapped are put back."""
    import sys

    from bibfs_tpu_torch.cli import ab
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.graph.generate import grid_graph
    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.oracle import build_index, landmarks

    n = 24 * 20
    rp, ci = build_csr(n, grid_graph(24, 20, perforation=0.05, seed=1))
    wrapped = (md.sweep, landmarks.multi_source_dist,
               landmarks.select_landmarks, landmarks.device_csr)
    mods = {m: mod for m, mod in sys.modules.items()
            if m.startswith("bibfs_tpu_torch.")}
    idx, split = ab.build_split(mods, n, rp, ci, 12, "cpu", lambda: None)
    want = build_index(n, rp, ci, 12, device="host")
    np.testing.assert_array_equal(idx.landmarks, want.landmarks)
    np.testing.assert_array_equal(idx.dist, want.dist)
    parts = ("sweeps_ms", "copies_ms", "scoring_ms", "index_ms")
    assert split["sweeps_ms"] > 0 and all(split[p] >= 0 for p in parts)
    assert abs(sum(split[p] for p in parts) - split["build_ms"]) < 1e-6
    assert (md.sweep, landmarks.multi_source_dist, landmarks.select_landmarks,
            landmarks.device_csr) == wrapped


def _batch_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if " -> " in ln and ": " in ln]


@pytest.mark.parametrize("extra", [
    ["--mode", "minor8"],
    ["--mode", "minor"],
    ["--mode", "auto"],
    ["--mode", "sync"],
    ["--mode", "minor", "--layout", "tiered", "--repeat", "2"],
])
def test_cli_pairs_prints_reference_lines(graph_file, tmp_path, extra, capsys):
    """``--pairs FILE`` prints one line per pair exactly as ``bibfs-solve
    --pairs`` does, then the batch ``[Time]`` line."""
    from bibfs_tpu.cli import solve as jcli

    from bibfs_tpu_torch.cli import solve as tcli

    path, n = graph_file
    pairs = tmp_path / "pairs.txt"
    np.savetxt(pairs, [[0, n - 1], [3, 3], [5, 200], [1, 2], [7, 8]], fmt="%d")
    assert jcli.main([path, "--pairs", str(pairs), "--backend", "dense",
                      *extra]) == 0
    want = capsys.readouterr().out
    assert tcli.main([path, "--pairs", str(pairs), *extra,
                      "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _batch_lines(got) == _batch_lines(want) and len(_batch_lines(got)) == 5
    last = got.strip().splitlines()[-1]
    assert last.startswith("[Time] dense batch of 5 searches took ")
    assert last.endswith(" s/query)")


@pytest.mark.parametrize("argv", [
    ["0", "1", "--mode", "minor8"],  # batch-only mode without --pairs
    ["0", "1", "--mode", "auto", "--layout", "tiered"],
    ["--pairs", "PAIRS", "--mode", "minor", "--backend", "serial"],
    ["0", "1", "--pairs", "PAIRS"],  # --pairs with the positional pair
    ["--pairs", "PAIRS", "--mode", "minor8", "--layout", "tiered"],
    ["--pairs", "PAIRS", "--unroll", "2"],
    [],  # neither a pair nor --pairs
])
def test_cli_pairs_argument_checks(graph_file, tmp_path, argv, capsys):
    """The reference's argument checks: each of these is refused before
    any search runs, as ``bibfs-solve`` refuses it."""
    from bibfs_tpu.cli import solve as jcli

    from bibfs_tpu_torch.cli import solve as tcli

    path, _n = graph_file
    pairs = tmp_path / "pairs.txt"
    np.savetxt(pairs, [[0, 1]], fmt="%d")
    argv = [str(pairs) if a == "PAIRS" else a for a in argv]
    with pytest.raises(SystemExit) as want:
        jcli.main([path, *argv, "--backend", "dense"]
                  if "--backend" not in argv else [path, *argv])
    with pytest.raises(SystemExit) as got:
        tcli.main([path, *argv])
    assert got.value.code == want.value.code == 2
    capsys.readouterr()
