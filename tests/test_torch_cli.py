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
