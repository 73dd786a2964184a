"""The port's checkpoint and resume (``solvers/checkpoint.py``) against
the JAX package's on the CPU: the cases of ``tests/test_checkpoint.py``
on one device, on 1D meshes of 2 and 4 gloo ranks and on a 2x2 grid
(the mesh legs run in a ``parallel/pool.py`` pool, rank 0 writing the
file), and a resume across packages in both directions. A chunked or
resumed search gives the one-shot search's fields (found, hops, path,
meet, levels, edges scanned) exactly, and the reference's own chunked
search the same; a resumed result reports the whole search."""

import os
import shutil

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


@pytest.fixture(scope="module")
def pools():
    import torch

    from bibfs_tpu_torch.parallel.pool import MeshPool

    torch.set_num_threads(2)
    made = {w: MeshPool(w, "cpu", timeout_s=300) for w in (2, 4)}
    yield made
    for p in made.values():
        p.close()


def _graph(n=96, avg_deg=3.0, seed=11):
    from bibfs_tpu.graph.generate import gnp_random_graph

    return n, gnp_random_graph(n, avg_deg / n, seed=seed)


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _dense(n, edges, layout="ell"):
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    return DeviceGraph.build(n, edges, layout=layout, device="cpu")


def _one_shot(g, src, dst, mode="sync"):
    from bibfs_tpu_torch.solvers.dense import solve_dense_graph

    return solve_dense_graph(g, src, dst, mode=mode)


def _check(res, n, edges, src, dst, want=None):
    """``res`` against the serial oracle, and its fields against ``want``
    (the one-shot search) when given."""
    from bibfs_tpu.solvers.serial import solve_serial

    ora = solve_serial(n, edges, src, dst)
    assert (res.found, res.hops) == (ora.found, ora.hops), (src, dst)
    if want is not None:
        assert _fields(res) == _fields(want), (src, dst)


_REG: dict = {}


def _mesh_key(pools, world, n, edges, substrate="1d", layout="ell"):
    """A graph registered on the pool of ``world`` ranks: its 1D host
    graph, or its 2x2 blocks for ``substrate="2d"``."""
    from bibfs_tpu_torch.solvers.sharded import build_host_graph, save_host_graph
    from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost, grid_shape

    key = f"{substrate}-{world}-{layout}-{n}-{hash(edges.tobytes())}"
    if key not in _REG:
        pool = pools[world]
        path = os.path.join(pool.workdir, f"ck{len(_REG)}")
        if substrate == "2d":
            Sharded2DHost.build(n, edges, *grid_shape(world)).save(path)
        else:
            save_host_graph(build_host_graph(n, edges, world, layout=layout),
                            path)
        pool.graph(key, path)
        _REG[key] = True
    return key


def _on_mesh(pools, world, n, edges, kind, substrate="1d", layout="ell",
             **job):
    key = _mesh_key(pools, world, n, edges, substrate, layout)
    return pools[world].call("jobs", [dict(kind=kind, graph=key,
                                           substrate=substrate, **job)]
                             )["results"][0]


@pytest.mark.parametrize("mode", ["sync", "alt", "beamer", "pallas",
                                  "fused_alt"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_matches_one_shot_dense(mode, chunk):
    """Chunks of the dense round give the one-shot search's fields in every
    schedule (a fused mode runs its chunks on the pull kernels' twins) and
    the reference's chunked search's."""
    from bibfs_tpu.solvers import checkpoint as rck
    from bibfs_tpu.solvers import dense as rd

    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(seed=5)
    g, rg = _dense(n, edges), rd.DeviceGraph.build(n, edges)
    for src, dst in [(0, n - 1), (3, 3), (7, 60)]:
        res = ck.solve_checkpointed(g, src, dst, mode=mode, chunk=chunk)
        _check(res, n, edges, src, dst, _one_shot(g, src, dst, mode))
        ref = rck.solve_checkpointed(rg, src, dst, mode=mode, chunk=chunk)
        assert _fields(res) == _fields(ref)


def test_chunked_matches_oracle_tiered():
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(seed=9, avg_deg=4.0)
    g = _dense(n, edges, "tiered")
    res = ck.solve_checkpointed(g, 0, n - 1, mode="beamer", chunk=2)
    _check(res, n, edges, 0, n - 1, _one_shot(g, 0, n - 1, "beamer"))


def test_chunked_unreachable():
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n = 64
    edges = np.array([[0, 1], [1, 2], [10, 11], [11, 12]], dtype=np.uint32)
    res = ck.solve_checkpointed(_dense(n, edges), 0, 12, chunk=2)
    assert res is not None and not res.found


def test_crash_and_resume(tmp_path):
    """Stopped after one one-round chunk, the file holds the state; the
    resume reports the whole search (levels of the one-shot search, the
    pre-stop seconds included)."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=128, seed=3)
    g = _dense(n, edges)
    src, dst = 0, n - 1
    path = str(tmp_path / "search.ckpt")
    assert ck.solve_checkpointed(g, src, dst, chunk=1, path=path,
                                 max_chunks=1) is None
    meta, state = ck.load_checkpoint(path)
    assert meta.levels >= 1
    assert int(state["lvl_s"]) + int(state["lvl_t"]) >= 1
    res = ck.resume(path, g, src=src, dst=dst, chunk=4)
    _check(res, n, edges, src, dst, _one_shot(g, src, dst))
    meta2, _ = ck.load_checkpoint(path)
    assert res.time_s >= meta.elapsed_s > 0
    assert meta2.elapsed_s >= meta.elapsed_s
    assert np.isfinite(res.teps)


def test_chunk_must_be_positive():
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(seed=5)
    with pytest.raises(ValueError, match="chunk"):
        ck.solve_checkpointed(_dense(n, edges), 0, n - 1, chunk=0)


def test_resume_fingerprint_mismatch(tmp_path):
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(seed=3)
    g = _dense(n, edges)
    path = str(tmp_path / "search.ckpt")
    ck.solve_checkpointed(g, 0, n - 1, chunk=1, path=path, max_chunks=1)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.resume(path, g, src=1, dst=n - 1)
    n2, edges2 = _graph(n=64, seed=4)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.resume(path, _dense(n2, edges2), src=0, dst=n - 1)


def test_elastic_dense_to_sharded(pools, tmp_path):
    """A snapshot of the single-device search resumes on a 4-rank mesh
    (re-padded and re-sharded), and one of the mesh on the single
    device."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=160, seed=13)
    src, dst = 0, n - 1
    gd = _dense(n, edges)
    want = _one_shot(gd, src, dst)
    assert want.found and want.hops >= 3
    path = str(tmp_path / "d2s.ckpt")
    assert ck.solve_checkpointed(gd, src, dst, chunk=1, path=path,
                                 max_chunks=1) is None
    res = _on_mesh(pools, 4, n, edges, "resume", src=src, dst=dst, chunk=4,
                   path=path)
    _check(res, n, edges, src, dst, want)
    path2 = str(tmp_path / "s2d.ckpt")
    assert _on_mesh(pools, 4, n, edges, "checkpoint", src=src, dst=dst,
                    chunk=1, path=path2, max_chunks=1) is None
    _check(ck.resume(path2, gd, src=src, dst=dst, chunk=4), n, edges, src,
           dst, want)


def test_pallas_snapshot_resumes_on_1d_mesh(pools, tmp_path):
    """A snapshot written under ``pallas`` resumes on the 1D mesh in the
    same mode (kernel 3's twin on the ranks' shards)."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=160, seed=13)
    src, dst = 0, n - 1
    gd = _dense(n, edges)
    path = str(tmp_path / "pallas2s.ckpt")
    assert ck.solve_checkpointed(gd, src, dst, chunk=1, path=path,
                                 max_chunks=1, mode="pallas") is None
    res = _on_mesh(pools, 4, n, edges, "resume", src=src, dst=dst, chunk=4,
                   path=path)
    assert res.mode == "pallas"
    _check(res, n, edges, src, dst, _one_shot(gd, src, dst, "pallas"))


def test_pallas_tiered_chunked_and_resume(tmp_path):
    """Chunks and a resume under ``pallas`` on a tiered graph: the kernel
    table and the tier arrays go through every chunk."""
    from bibfs_tpu.graph.generate import gnp_random_graph

    from bibfs_tpu_torch.solvers import checkpoint as ck

    n = 300
    rng = np.random.default_rng(9)
    base = np.asarray(gnp_random_graph(n, 3.0 / n, seed=9), np.int64)
    star = np.stack([np.zeros(120, np.int64),
                     rng.choice(np.arange(1, n), 120, replace=False)], axis=1)
    edges = np.concatenate([base.reshape(-1, 2), star])
    g = _dense(n, edges, "tiered")
    assert g.tier_meta
    src, dst = 1, n - 1
    want = _one_shot(g, src, dst, "pallas")
    _check(ck.solve_checkpointed(g, src, dst, mode="pallas", chunk=2), n,
           edges, src, dst, want)
    path = str(tmp_path / "pt.ckpt")
    assert ck.solve_checkpointed(g, src, dst, chunk=1, path=path,
                                 max_chunks=1, mode="pallas") is None
    _check(ck.resume(path, g, src=src, dst=dst, chunk=4), n, edges, src, dst,
           want)


def test_sharded_chunked_modes(pools):
    """Chunks on the 1D mesh in the torch modes and both kernel modes give
    the one-shot search's fields."""
    n, edges = _graph(n=160, seed=21)
    gd = _dense(n, edges)
    for mode in ["sync", "alt", "beamer", "pallas", "pallas_alt"]:
        res = _on_mesh(pools, 4, n, edges, "checkpoint", src=2, dst=150,
                       chunk=2, mode=mode)
        _check(res, n, edges, 2, 150, _one_shot(gd, 2, 150, mode))


def test_refit_rejects_live_tail():
    from bibfs_tpu.solvers import checkpoint as rck

    from bibfs_tpu_torch.solvers import checkpoint as ck

    state = ck._init_state_np(64, 0, 40, 3, 2)
    rstate = rck._init_state_np(64, 0, 40, 3, 2)
    assert state.keys() == rstate.keys()
    for k in state:
        assert np.array_equal(state[k], rstate[k])
        assert np.asarray(state[k]).dtype == np.asarray(rstate[k]).dtype
    with pytest.raises(ValueError, match="live entries"):
        ck._refit(state, 32)  # dst=40 lives in the dropped tail
    grown = ck._refit(state, 128)
    assert grown["fr_t"].shape == (128,)
    assert grown["fr_t"][40] and not grown["fr_t"][64:].any()
    back = ck._refit(grown, 64)
    assert back["dist_s"].shape == (64,)
    rback = rck._refit(rck._refit(rstate, 128), 64)
    for k in back:
        assert np.array_equal(back[k], rback[k])


def test_mode_override_on_resume(tmp_path):
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=128, seed=30)
    g = _dense(n, edges)
    path = str(tmp_path / "m.ckpt")
    assert ck.solve_checkpointed(g, 0, n - 1, mode="sync", chunk=1,
                                 path=path, max_chunks=1) is None
    # the level-synchronous carry is schedule-portable: finish under alt
    res = ck.resume(path, g, src=0, dst=n - 1, mode="alt", chunk=4)
    _check(res, n, edges, 0, n - 1)
    assert res.mode == "alt"


def test_elastic_mesh_resize(pools, tmp_path):
    """A snapshot of a 4-rank mesh resumes on 2 ranks; a 2-rank snapshot
    with a smaller n_pad resumes on 4 (inert rows added or dropped)."""
    from bibfs_tpu_torch.solvers.sharded import build_host_graph

    n, edges = _graph(n=163, seed=13)
    src, dst = 0, n - 1
    want = _one_shot(_dense(n, edges), src, dst)
    assert want.found
    assert (build_host_graph(n, edges, 4).n_pad
            != build_host_graph(n, edges, 2).n_pad)
    for a, b in ((4, 2), (2, 4)):
        path = str(tmp_path / f"resize{a}.ckpt")
        assert _on_mesh(pools, a, n, edges, "checkpoint", src=src, dst=dst,
                        chunk=1, path=path, max_chunks=1) is None
        res = _on_mesh(pools, b, n, edges, "resume", src=src, dst=dst,
                       chunk=4, path=path)
        _check(res, n, edges, src, dst, want)


def test_chunked_2d_matches_one_shot(pools):
    n, edges = _graph(n=300, avg_deg=4.0, seed=13)
    gd = _dense(n, edges)
    for src, dst in [(0, n - 1), (4, 4), (3, 250)]:
        for mode in ("sync", "alt"):
            res = _on_mesh(pools, 4, n, edges, "checkpoint", substrate="2d",
                           src=src, dst=dst, chunk=2, mode=mode)
            _check(res, n, edges, src, dst, _one_shot(gd, src, dst, mode))


def _deep_pair(n, edges, src, hops=4):
    from bibfs_tpu.solvers.serial import solve_serial

    for dst in range(src + 1, n):
        r = solve_serial(n, edges, src, dst)
        if r.found and r.hops >= hops:
            return dst
    raise AssertionError("no deep pair")


def test_elastic_dense_to_2d_and_back(pools, tmp_path):
    """One snapshot, three substrates: stopped on one device under
    ``beamer``, resumed and stopped again on the 2x2 grid (its base
    schedule, ``md_*`` recomputed), finished on the 1D mesh."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=300, seed=13)
    src = 3
    dst = _deep_pair(n, edges, src)
    gd = _dense(n, edges)
    path = str(tmp_path / "tri.ckpt")
    assert ck.solve_checkpointed(gd, src, dst, mode="beamer", chunk=1,
                                 path=path, max_chunks=1) is None
    assert _on_mesh(pools, 4, n, edges, "resume", substrate="2d", src=src,
                    dst=dst, chunk=1, path=path, max_chunks=1) is None
    _meta, state = ck.load_checkpoint(path)
    fr = state["fr_s"] | state["fr_t"]
    deg = np.bincount(np.asarray(edges).reshape(-1), minlength=n)
    assert int(state["md_s"]) == int(deg[state["fr_s"][:n]].max(initial=0))
    assert fr.any()
    res = _on_mesh(pools, 4, n, edges, "resume", src=src, dst=dst, chunk=8,
                   path=path)
    _check(res, n, edges, src, dst, _one_shot(gd, src, dst, "beamer"))


def test_chunked_random_property_sweep():
    """Chunked execution on random graphs equals the one-shot search."""
    from tests.conftest import random_graph_cases

    from bibfs_tpu_torch.solvers import checkpoint as ck

    for i, (n, edges, src, dst) in enumerate(random_graph_cases(num=6,
                                                                seed=99)):
        g = _dense(n, edges)
        mode = "beamer" if i % 2 else "sync"
        res = ck.solve_checkpointed(g, src, dst, mode=mode, chunk=1 + i % 3)
        _check(res, n, edges, src, dst, _one_shot(g, src, dst, mode))


def test_corrupt_checkpoint_raises_cleanly(tmp_path):
    """A damaged file raises ValueError with the reason (OSError for an
    unreadable one), as the reference's does."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(seed=5)
    path = str(tmp_path / "c.ckpt")
    ck.solve_checkpointed(_dense(n, edges), 0, n - 1, chunk=1, path=path,
                          max_chunks=1)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 2])
    with pytest.raises((ValueError, OSError)):
        ck.load_checkpoint(path)
    open(path, "wb").write(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a valid checkpoint"):
        ck.load_checkpoint(path)
    np.savez(open(path, "wb"), foo=np.zeros(3))
    with pytest.raises(ValueError, match="not a valid checkpoint"):
        ck.load_checkpoint(path)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("substrate", ["dense", "1d", "2d"])
def test_cross_package_resume(direction, substrate, pools, tmp_path):
    """The file format is the reference's: a search stopped by one package
    finishes in the other, on one device, the 1D mesh or the 2x2 grid, and
    gives the one-shot search's fields (the written arrays and metadata
    equal key for key at the same n_pad)."""
    from bibfs_tpu.solvers import checkpoint as rck
    from bibfs_tpu.solvers import dense as rd

    from bibfs_tpu_torch.solvers import checkpoint as ck

    n, edges = _graph(n=200, seed=17)
    src = 1
    dst = _deep_pair(n, edges, src, hops=5)
    gd, rg = _dense(n, edges), rd.DeviceGraph.build(n, edges)
    want = _one_shot(gd, src, dst)
    path = str(tmp_path / "x.ckpt")
    if direction == "jax_to_port":
        assert rck.solve_checkpointed(rg, src, dst, chunk=1, path=path,
                                      max_chunks=2) is None
        if substrate == "dense":
            res = ck.resume(path, gd, src=src, dst=dst, chunk=4)
        else:
            res = _on_mesh(pools, 4, n, edges, "resume", substrate=substrate,
                           src=src, dst=dst, chunk=4, path=path)
        _check(res, n, edges, src, dst, want)
        return
    if substrate == "dense":
        assert ck.solve_checkpointed(gd, src, dst, chunk=1, path=path,
                                     max_chunks=2) is None
        rpath = str(tmp_path / "r.ckpt")
        assert rck.solve_checkpointed(rg, src, dst, chunk=1, path=rpath,
                                      max_chunks=2) is None
        mine, theirs = ck.load_checkpoint(path), rck.load_checkpoint(rpath)
        assert mine[0].levels == theirs[0].levels
        for k in theirs[1]:
            a, b = np.asarray(mine[1][k]), np.asarray(theirs[1][k])
            if a.ndim:  # the pads may differ: compare the n real rows
                a, b = a[:n], b[:n]
            assert np.array_equal(a, b) and a.dtype == b.dtype, k
    else:
        assert _on_mesh(pools, 4, n, edges, "checkpoint", substrate=substrate,
                        src=src, dst=dst, chunk=1, path=path,
                        max_chunks=2) is None
    shutil.copy(path, path + ".port")
    res = rck.resume(path, rg, src=src, dst=dst, chunk=4)
    assert _fields(res) == _fields(want)


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    """``bibfs-torch-solve --checkpoint/--chunk/--resume`` on the dense
    backend and on a 1D mesh prints the answer and the checkpoint line,
    and refuses what the reference CLI refuses."""
    from bibfs_tpu.solvers.serial import solve_serial

    from bibfs_tpu_torch.cli.solve import main
    from bibfs_tpu_torch.graph.io import write_graph_bin

    n, edges = _graph(n=200, seed=17)
    ref = solve_serial(n, edges, 1, 150)
    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, n, edges)
    for backend, extra in (("dense", []), ("sharded", ["--devices", "2"])):
        ck = str(tmp_path / f"{backend}.ckpt")
        for flags in (["--checkpoint", ck, "--chunk", "1"],
                      ["--checkpoint", ck, "--resume"]):
            rc = main([gpath, "1", "150", "--backend", backend, "--no-path",
                       "--device", "cpu"] + extra + flags)
            out = capsys.readouterr().out
            assert rc == 0
            assert (f"Shortest path length = {ref.hops}" if ref.found
                    else "No path found.") in out
            assert f"[Checkpoint] {ck}" in out
    for bad in (["--backend", "serial", "--checkpoint", "x"],
                ["--resume"], ["--chunk", "0"],
                ["--checkpoint", "x", "--repeat", "3"],
                ["--checkpoint", "x", "--unroll", "2"]):
        with pytest.raises(SystemExit):
            main([gpath, "1", "150", "--device", "cpu"] + bad)
