"""The port's durable graph store (``bibfs_tpu_torch.store.wal``,
``sidecar``, ``history``, ``graph.compress`` and the durable half of
``store.registry``) against ``bibfs_tpu.store`` on the CPU, exactly: the
WAL's bytes for the same batches and the replay of torn and bad-CRC
tails; the compressed bytes and their round trip; a sidecar written by
either package loaded by the other under ``verify="full"``; a durable
directory written by one package's store recovered by the other's (the
same digest, version, live edges and history), ``reconstruct_version``
of every version, the fault sites ``wal_write`` / ``wal_fsync`` /
``manifest_rename`` leaving the same recoverable state, the recovery
refusals, the landmark index a recovery adopts from the sidecar, and the
adaptive policy's sidecar through a durable store."""

import json
import os
import shutil
import struct

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
BATCHES = [
    (1, [(0, 5), (2, 7)], []),
    (1, [], [(0, 5)]),
    (2, [(9, 4)], [(3, 8)]),
    (2, [], []),
    (3, [(70000, 3), (1, 2 ** 31 - 1)], [(11, 12)] * 3),
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _wal_modules():
    import bibfs_tpu.store.wal as ref
    import bibfs_tpu_torch.store.wal as port

    return {"ref": ref, "port": port}


def _store_modules():
    import bibfs_tpu.store as ref
    import bibfs_tpu_torch.store as port

    return {"ref": ref, "port": port}


def _fault_plan(who: str, spec: str):
    if who == "ref":
        from bibfs_tpu.serve.faults import FaultPlan
    else:
        from bibfs_tpu_torch.serve.faults import FaultPlan
    return FaultPlan.parse(spec)


def _write(mod, path, batches, **kw):
    w = mod.WalWriter(path, **kw)
    for version, adds, dels in batches:
        w.append(version, adds, dels)
    w.close()
    return w


def _records(records):
    return [(v, [tuple(e) for e in a], [tuple(e) for e in d])
            for v, a, d in records]


# ---- the write-ahead log ---------------------------------------------
def test_wal_bytes_equal_reference(tmp_path):
    mods = _wal_modules()
    for who, mod in mods.items():
        _write(mod, tmp_path / f"{who}.wal.1", BATCHES)
    raw = {who: (tmp_path / f"{who}.wal.1").read_bytes() for who in mods}
    assert raw["port"] == raw["ref"]
    assert raw["port"].startswith(b"BWAL1\n")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_wal_replays_the_other_package(tmp_path, writer):
    mods = _wal_modules()
    path = tmp_path / "g.wal.1"
    _write(mods[writer], path, BATCHES)
    got = {who: mod.read_wal(path) for who, mod in mods.items()}
    assert _records(got["port"][0]) == _records(got["ref"][0]) == BATCHES
    assert got["port"][1:] == got["ref"][1:] == (os.path.getsize(path), False)


@pytest.mark.parametrize("damage", ["header", "payload", "crc", "magic",
                                    "inconsistent", "missing"])
def test_torn_and_bad_tails_replay_like_reference(tmp_path, damage):
    """A torn header or payload, a flipped byte of the last record, a
    foreign magic, a record whose CRC holds but whose counts disagree with
    its length, a missing file: both packages replay the same prefix,
    report the same good length and tear, and ``repair_wal`` truncates to
    the same bytes."""
    mods = _wal_modules()
    base = tmp_path / "base.wal.1"
    _write(mods["port"], base, BATCHES)
    data = bytearray(base.read_bytes())
    if damage == "header":
        data += b"\x10"
    elif damage == "payload":
        data += struct.pack("<II", 1000, 0) + b"\x00" * 4
    elif damage == "crc":
        data[-1] ^= 0xFF
    elif damage == "magic":
        data[:6] = b"NOTWAL"
    elif damage == "inconsistent":
        import zlib

        payload = struct.pack("<QII", 4, 2, 0) + struct.pack("<II", 1, 2)
        data += struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
    out = {}
    for who, mod in mods.items():
        path = tmp_path / f"{who}.wal.1"
        if damage != "missing":
            path.write_bytes(bytes(data))
        read = mod.read_wal(path)
        repaired = mod.repair_wal(path)
        out[who] = (_records(read[0]), read[1], read[2],
                    _records(repaired[0]), repaired[1],
                    path.read_bytes() if path.exists() else None)
    assert out["port"] == out["ref"]
    if damage in ("header", "payload", "crc", "inconsistent"):
        assert out["port"][2] is True
        assert len(out["port"][0]) == len(BATCHES) - (damage == "crc")


@pytest.mark.parametrize("policy,kw,fsyncs", [
    ("always", {}, len(BATCHES)),
    ("batch", {"batch_records": 2}, 3),
    ("off", {}, 1),
])
def test_wal_fsync_policies_equal_reference(tmp_path, monkeypatch, policy,
                                            kw, fsyncs):
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
    got = {}
    for who, mod in _wal_modules().items():
        calls.clear()
        w = _write(mod, tmp_path / f"{who}.wal.1", BATCHES, fsync=policy, **kw)
        got[who] = (w.fsyncs, len(calls), w.stats()["records"])
    assert got["port"] == got["ref"] == (fsyncs, fsyncs, len(BATCHES))
    with pytest.raises(ValueError, match="fsync policy"):
        _wal_modules()["port"].WalWriter(tmp_path / "x.wal.1",
                                         fsync="sometimes")


@pytest.mark.parametrize("site", ["wal_write", "wal_fsync"])
def test_refused_append_leaves_no_bytes_like_reference(tmp_path, site):
    """A fault at either site raises, counts nothing and rolls the file
    back to its length before the append, in both packages."""
    out = {}
    for who, mod in _wal_modules().items():
        plan = _fault_plan(who, f"{site}:times=1")
        path = tmp_path / f"{who}.wal.1"
        w = mod.WalWriter(path, fsync="always", fire=plan.fire)
        with pytest.raises(RuntimeError, match=site):
            w.append(1, [(2, 3)], [])
        w.append(1, [(0, 1)], [])
        w.append(1, [(4, 5)], [])
        w.close()
        out[who] = (w.records, path.read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][0] == 2


def test_segment_helpers_equal_reference(tmp_path):
    mods = _wal_modules()
    for seq in (3, 1, 10):
        _write(mods["port"], mods["port"].segment_path(tmp_path, "g", seq),
               BATCHES[:1])
    (tmp_path / "g.wal.x1").write_bytes(b"x")
    (tmp_path / "h.wal.2").write_bytes(b"x")
    got = {who: mod.list_segments(tmp_path, "g") for who, mod in mods.items()}
    assert got["port"] == got["ref"]
    assert [s for s, _ in got["port"]] == [1, 3, 10]
    assert (mods["port"].segment_path(tmp_path, "g", 4)
            == mods["ref"].segment_path(tmp_path, "g", 4))


# ---- the cold-tier codec ---------------------------------------------
def _csr_case(case):
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.graph.generate import grid_graph, rmat_graph

    if case == "random":
        rng = np.random.default_rng(3)
        n = 300
        return build_csr(n, rng.integers(0, n, size=(900, 2)))
    if case == "grid":
        return build_csr(23 * 17, grid_graph(23, 17, perforation=0.05, seed=1))
    if case == "rmat":
        n, edges = rmat_graph(10, 8, seed=2)
        return build_csr(n, edges)
    if case == "empty_tail":
        return build_csr(9, np.array([[0, 1], [1, 2]]))
    if case == "empty":
        return build_csr(5, np.zeros((0, 2), dtype=np.int64))
    big = (1 << 31) - 1  # five varint groups
    return (np.array([0, 2, 4], dtype=np.int64),
            np.array([1, big, 5, big - 7], dtype=np.int64))


@pytest.mark.parametrize("case", ["random", "grid", "rmat", "empty_tail",
                                  "empty", "big_ids"])
def test_compressed_bytes_equal_reference(case):
    from bibfs_tpu.graph import compress as ref

    from bibfs_tpu_torch.graph import compress as port

    row_ptr, col_ind = _csr_case(case)
    a, b = ref.encode_csr(row_ptr, col_ind), port.encode_csr(row_ptr, col_ind)
    assert (b.n, b.nnz) == (a.n, a.nnz)
    assert b.data.tobytes() == a.data.tobytes()
    assert np.array_equal(b.row_ptr, a.row_ptr)
    assert b.stats() == a.stats()
    for c in (a, b):  # the port decodes the reference's stream too
        rp, ci = port.decode_csr(c)
        assert np.array_equal(rp, row_ptr) and np.array_equal(ci, col_ind)
        assert ci.dtype == np.int64


def test_compress_refuses_what_the_reference_refuses():
    from bibfs_tpu.graph import compress as ref

    from bibfs_tpu_torch.graph import compress as port

    row_ptr, col_ind = _csr_case("grid")
    for mod in (ref, port):
        with pytest.raises(ValueError, match="sorted"):
            mod.encode_csr(np.array([0, 2]), np.array([5, 1]))
        with pytest.raises(ValueError, match="claims"):
            mod.encode_csr(row_ptr, col_ind[:-1])
        c = mod.encode_csr(row_ptr, col_ind)
        cut = mod.CompressedCSR(n=c.n, nnz=c.nnz, row_ptr=c.row_ptr,
                                data=c.data[:-1])
        with pytest.raises(ValueError, match="varint stream"):
            mod.decode_csr(cut)
        long = mod.CompressedCSR(n=1, nnz=1, row_ptr=np.array([0, 1]),
                                 data=np.array([0x80] * 6 + [1], np.uint8))
        with pytest.raises(ValueError, match="groups"):
            mod.decode_csr(long)


# ---- arrays sidecars -------------------------------------------------
def _sidecar_snapshot(pkg_name: str, n: int, edges, with_index: bool):
    """A snapshot of ``pkg_name``'s package with its ELL and tile tables
    built, and (optionally) its landmark index."""
    mods = _store_modules()
    snap = mods[pkg_name].GraphSnapshot.build(n, edges, version=1)
    snap.ell()
    snap.blocked()
    index = None
    if with_index:
        rp, ci = snap.csr()
        if pkg_name == "ref":
            from bibfs_tpu.oracle import build_index

            index = build_index(n, rp, ci, 6, digest=snap.digest)
        else:
            from bibfs_tpu_torch.oracle import build_index

            index = build_index(n, rp, ci, 6, digest=snap.digest,
                                device="host")
    return snap, index


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.get("meta", {}).get("oracle", {}).pop("built_at", None)
    return m


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sidecar_loads_in_the_other_package(tmp_path, writer):
    """Each package writes the sidecar of the same graph (every group: the
    ELL and tile tables, the landmark index); the manifests agree on every
    file's dtype, shape and BLAKE2b, and the other package maps the
    writer's directory under ``verify="full"`` to a snapshot of the same
    digest, pairs, CSR, native columns and tables."""
    from bibfs_tpu.graph.generate import grid_graph

    mods = _store_modules()
    n = 30 * 24
    edges = grid_graph(30, 24, perforation=0.05, seed=4)
    dirs = {}
    for who in ("ref", "port"):
        snap, index = _sidecar_snapshot(who, n, edges, with_index=True)
        root = tmp_path / who
        root.mkdir()
        dirs[who] = os.path.join(
            root, mods[who].write_sidecar(str(root), "g", snap,
                                          oracle_index=index))
    assert os.path.basename(dirs["port"]) == os.path.basename(dirs["ref"])
    assert _manifest(dirs["port"]) == _manifest(dirs["ref"])
    reader = "ref" if writer == "port" else "port"
    smap = mods[reader].load_sidecar(dirs[writer], verify="full")
    mapped = mods[reader].GraphSnapshot.from_sidecar(smap)
    mem = mods[reader].GraphSnapshot.build(n, edges)
    assert mapped.digest == mem.digest and mapped.tier == "mapped"
    assert np.array_equal(mapped.pairs, mem.pairs)
    for a, b in zip(mapped.csr(), mem.csr()):
        assert np.array_equal(a, b)
    assert np.array_equal(mapped.native_csr()[1], mem.csr()[1])
    ell, want = mapped.ell(), mem.ell()
    assert (ell.n_pad, ell.width) == (want.n_pad, want.width)
    assert np.array_equal(ell.nbr, want.nbr)
    assert np.array_equal(mapped.blocked().tab, mem.blocked().tab)
    assert smap.has("oracle.dist", "oracle.landmarks")


def test_sidecar_refuses_corruption_like_reference(tmp_path):
    mods = _store_modules()
    rng = np.random.default_rng(6)
    n = 120
    edges = rng.integers(0, n, size=(360, 2))
    for who, mod in mods.items():
        root = tmp_path / who
        root.mkdir()
        d = os.path.join(root, mod.write_sidecar(
            str(root), "g", mod.GraphSnapshot.build(n, edges)))
        with open(os.path.join(d, "pairs.bin"), "r+b") as f:
            f.seek(8)
            f.write(b"\xff\xff\xff\xff")
        for reader in mods.values():
            reader.load_sidecar(d, verify="size")
            with pytest.raises(ValueError, match="content hash"):
                reader.load_sidecar(d, verify="full")
            with pytest.raises(ValueError, match="digest"):
                reader.GraphSnapshot.from_sidecar(
                    reader.load_sidecar(d, verify="size"))
        target = os.path.join(d, "csr32_indices.bin")
        with open(target, "r+b") as f:
            f.truncate(os.path.getsize(target) - 4)
        for reader in mods.values():
            with pytest.raises(ValueError, match="bytes on disk"):
                reader.load_sidecar(d, verify="size")


def test_sidecar_rename_fault_cleans_up_like_reference(tmp_path):
    mods = _store_modules()
    n = 40
    edges = np.random.default_rng(8).integers(0, n, size=(80, 2))
    for who, mod in mods.items():
        root = tmp_path / who
        root.mkdir()
        snap = mod.GraphSnapshot.build(n, edges)
        plan = _fault_plan(who, "sidecar_rename:times=1")
        with pytest.raises(RuntimeError, match="sidecar_rename"):
            mod.write_sidecar(str(root), "g", snap, fire=plan.fire)
        assert os.listdir(root) == []
        d = mod.write_sidecar(str(root), "g", snap, fire=plan.fire)
        assert d == mod.sidecar_dir_name("g", snap)
        assert mod.write_sidecar(str(root), "g", snap) == d  # kept as is


# ---- durable directories ---------------------------------------------
N = 40 * 40


def _grid():
    from bibfs_tpu.graph.generate import grid_graph

    return grid_graph(40, 40, perforation=0.02, seed=3)


def _seed_dir(root, names=("g",)):
    from bibfs_tpu.graph.io import write_graph_bin

    os.makedirs(root, exist_ok=True)
    for name in names:
        write_graph_bin(os.path.join(root, f"{name}.bin"), N, _grid())
    return str(root)


def _batch(rng, live: set, k_add: int, k_del: int):
    adds = []
    while len(adds) < k_add:
        u, v = (int(x) for x in rng.integers(0, N, 2))
        e = (min(u, v), max(u, v))
        if u != v and e not in live and e not in adds:
            adds.append(e)
    pool = sorted(live)
    dels = [pool[int(i)] for i in rng.choice(len(pool), k_del, replace=False)]
    live.update(adds)
    live.difference_update(dels)
    return adds, dels


def _live(store, name="g") -> set:
    ov = store.overlay(name)
    edges = (ov.merged_edges() if ov is not None
             else store.current(name).undirected_edges())
    return {(int(u), int(v)) for u, v in np.asarray(edges).tolist()}


def _drive(pkg, d, **kw):
    """One seeded run of a durable store on ``d``: two update batches, a
    compaction checkpoint, two more batches (the second adds only), a
    declared-truth swap, one more batch; returns the live edge sets after
    each commit and the store's last stats."""
    store = pkg.GraphStore.from_dir(d, durable=True, fsync="always",
                                    compact_threshold=None,
                                    retain_history=True, **kw)
    rng = np.random.default_rng(11)
    live = _live(store)
    for k_add, k_del in ((6, 2), (4, 3)):
        store.update("g", *_batch(rng, live, k_add, k_del))
    store.compact("g")
    store.update("g", *_batch(rng, live, 3, 2))
    store.update("g", *_batch(rng, live, 5, 0))
    v = store.current("g").version
    store.swap("g", pkg.GraphSnapshot.build(
        N, np.array(sorted(live)), version=v + 1))
    store.update("g", *_batch(rng, live, 2, 1))
    assert _live(store) == live
    stats = store.stats()["graphs"]["g"]
    store.close()
    return live, stats


def _recovered(pkg, d):
    store = pkg.GraphStore.from_dir(d, durable=True, compact_threshold=None,
                                    retain_history=True)
    g = store.stats()["graphs"]["g"]
    out = {
        "digest": g["digest"], "version": g["version"], "live": _live(store),
        "history": store.history("g"),
        "recovered": {k: v for k, v in g["durable"]["recovered"].items()
                      if k not in ("recovery_s", "split_s", "index_adopted")},
        "wal_seq": g["durable"]["wal_seq"], "bin": g["durable"]["bin"],
        "arrays": g["durable"]["arrays"],
        "versions": {e["version"]: store.reconstruct_version(
            "g", e["version"]).digest for e in store.history("g")},
    }
    store.close()
    return out


def _analytics_state(d) -> dict:
    """The analytics result store's directory: each entry's arrays and its
    ``meta.json`` but the solve time, by relative path."""
    import numpy as np

    out = {}
    for root, _dirs, files in sorted(os.walk(d)):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, d)
            if fname.endswith(".npy"):
                out[rel] = np.load(path).tolist()
            else:
                with open(path) as f:
                    meta = json.load(f)
                meta["scalars"].pop("time_s", None)
                out[rel] = meta
    return out


def _dir_state(d) -> dict:
    """Every file a durable store leaves: WAL segments, bins and history
    byte for byte, manifests and sidecar manifests as JSON, and the
    analytics result store's entries (:func:`_analytics_state`)."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name == "analytics":
            out[name] = _analytics_state(path)
        elif os.path.isdir(path):
            out[name] = _manifest(path)
        elif name.endswith(".json"):
            with open(path) as f:
                out[name] = json.load(f)
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def test_durable_directories_equal_reference(tmp_path):
    """The same seeded run by each package's store leaves the same files:
    every WAL segment, checkpoint ``.bin``, manifest, history entry and
    sidecar manifest."""
    mods = _store_modules()
    states, lives = {}, {}
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who)
        lives[who], _stats = _drive(pkg, d)
        states[who] = _dir_state(d)
    assert lives["port"] == lives["ref"]
    assert sorted(states["port"]) == sorted(states["ref"])
    for name in states["ref"]:
        assert states["port"][name] == states["ref"][name], name


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_durable_directory_recovers_in_the_other_package(tmp_path, writer):
    """One package's store writes the directory, and each package recovers
    a copy of it: the same digest, version, live edges, history, replay
    counts and reconstructed versions; every acked update is there."""
    mods = _store_modules()
    d = _seed_dir(tmp_path / "w")
    live, _stats = _drive(mods[writer], d)
    got = {}
    for who, pkg in mods.items():
        copy = shutil.copytree(d, tmp_path / f"r-{who}")
        got[who] = _recovered(pkg, str(copy))
    assert got["port"] == got["ref"]
    assert got["port"]["live"] == live
    assert len(got["port"]["history"]) == 3
    assert got["port"]["recovered"]["replayed_records"] == 1


def _history_modules():
    import bibfs_tpu.store.history as ref
    import bibfs_tpu_torch.store.history as port

    return {"ref": ref, "port": port}


@pytest.mark.parametrize("route", ["bin", "wal_replay"])
def test_reconstruct_version_equal_reference(tmp_path, route):
    """Every committed version reconstructs to the recorded digest in both
    packages: from its retained ``.bin``, or (the compaction's bin removed)
    from the seed and the WAL segments below its ``wal_seq``; a version
    whose proof is gone is refused by both."""
    mods = _history_modules()
    d = _seed_dir(tmp_path / "w")
    _drive(_store_modules()["port"], d)
    hist = mods["port"].load_history(d, "g")
    assert hist == mods["ref"].load_history(d, "g")
    assert [e["version"] for e in hist] == [1, 2, 3]
    if route == "wal_replay":
        os.unlink(os.path.join(d, hist[1]["bin"]))
    got = {}
    for who, mod in mods.items():
        got[who] = {}
        for e in hist:
            snap = mod.reconstruct_version(d, "g", e["version"])
            assert snap.digest == e["digest"]
            got[who][e["version"]] = (snap.digest, snap.num_edges,
                                      snap.version)
        with pytest.raises(ValueError, match="no history entry"):
            mod.reconstruct_version(d, "g", 99)
    assert got["port"] == got["ref"]
    if route == "wal_replay":
        os.unlink(os.path.join(d, "g.bin"))
        for mod in mods.values():
            with pytest.raises(ValueError, match="no seed"):
                mod.reconstruct_version(d, "g", 2)


@pytest.mark.parametrize("site", ["wal_write", "wal_fsync",
                                  "manifest_rename"])
def test_fault_sites_leave_the_same_recoverable_state(tmp_path, site):
    """A fault at each durability seam: the refused update (or failed
    checkpoint) raises in both packages with nothing acked, the files left
    behind are the same, and both packages recover them to the same graph
    with every acked update."""
    mods = _store_modules()
    states, got = {}, {}
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who)
        store = pkg.GraphStore.from_dir(d, durable=True, fsync="always",
                                        compact_threshold=None)
        store._faults = _fault_plan(who, f"{site}:times=1")
        rng = np.random.default_rng(13)
        live = _live(store)
        acked = set(live)
        adds, dels = _batch(rng, live, 4, 1)
        if site == "manifest_rename":
            store.update("g", adds, dels)
            acked = set(live)
            with pytest.raises(RuntimeError, match=site):
                store.compact("g")
        else:
            with pytest.raises(RuntimeError, match=site):
                store.update("g", adds, dels)
            assert store.overlay("g") is None
            store.update("g", adds, dels)  # the retry acks
            acked = set(live)
        store.update("g", *_batch(rng, live, 2, 0))
        acked = set(live)
        assert _live(store) == acked
        store.close()
        states[who] = _dir_state(d)
        got[who] = _recovered(pkg, d)
        assert got[who]["live"] == acked
    assert sorted(states["port"]) == sorted(states["ref"])
    for name in states["ref"]:
        if name.endswith(".history.json"):
            continue
        assert states["port"][name] == states["ref"][name], name
    assert got["port"] == got["ref"]


def test_torn_tail_and_forked_history_like_reference(tmp_path, capsys):
    """A torn tail on the live segment is truncated (both packages replay
    the same records, and appends resume); a torn segment that is not the
    last refuses the graph in both, a sibling graph still loads."""
    mods = _store_modules()
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who, names=("g", "ok"))
        store = pkg.GraphStore.from_dir(d, durable=True, fsync="always",
                                        compact_threshold=None)
        store.update("g", adds=[(0, N - 1)])
        store.close()
        seg = os.path.join(d, "g.wal.1")
        with open(seg, "ab") as f:
            f.write(b"\xff\x00\x00\x00\xde\xad")
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        rec = store.stats()["graphs"]["g"]["durable"]["recovered"]
        assert rec["torn_tail_truncated"] and rec["replayed_records"] == 1
        store.update("g", adds=[(1, N - 2)])
        store._faults = _fault_plan(who, "manifest_rename:times=1")
        with pytest.raises(RuntimeError, match="manifest_rename"):
            store.compact("g")  # segment switched, manifest not committed
        store.update("g", adds=[(2, N - 3)])  # lands in segment 2
        store.close()
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 3)
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        assert store.names() == ["ok"]
        assert "forked history" in store.load_errors[0]["error"]
        store.close()
    assert capsys.readouterr().err.count("skipping graph 'g'") == 2


def test_recovery_refusals_like_reference(tmp_path):
    """A checkpoint ``.bin`` that does not hash to its manifest is served
    from its intact sidecar, and skipped once the sidecar is gone; a torn
    sidecar falls back to the ``.bin`` (hot, the same digest); ``add``
    refuses a name with durable state; ``retain_history`` needs a
    ``wal_dir``."""
    from bibfs_tpu.graph.io import write_graph_bin

    mods = _store_modules()
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who, names=("g", "ok"))
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        store.update("g", adds=[(0, N - 1)])
        store.compact("g")
        digest = store.current("g").digest
        arrays = store.stats()["graphs"]["g"]["durable"]["arrays"]
        store.close()
        with open(os.path.join(d, "g.manifest.json")) as f:
            ckpt = json.load(f)["bin"]
        write_graph_bin(os.path.join(d, ckpt), N, _grid()[:-2])
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        assert store.current("g").digest == digest
        assert store.current("g").tier == "mapped"
        store.close()
        pairs_file = os.path.join(d, arrays, "pairs.bin")
        with open(pairs_file, "r+b") as f:
            f.write(b"\x00" * 16)
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        assert store.names() == ["ok"]
        assert "digest" in store.load_errors[0]["error"]
        store.close()
        shutil.rmtree(os.path.join(d, arrays))
        with pytest.raises(ValueError, match="durable state"):
            pkg.GraphStore(wal_dir=d).add("g", N, _grid())
        with pytest.raises(ValueError, match="retain_history"):
            pkg.GraphStore(retain_history=True)
        with pytest.raises(ValueError, match="not a directory"):
            pkg.GraphStore(wal_dir=os.path.join(d, "nope"))


def test_torn_sidecar_falls_back_to_the_bin(tmp_path, capsys):
    mods = _store_modules()
    got = {}
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who)
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        arrays = store.stats()["graphs"]["g"]["durable"]["arrays"]
        store.close()
        with open(os.path.join(d, arrays, "pairs.bin"), "r+b") as f:
            f.write(b"\x00" * 16)
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        rec = store.stats()["graphs"]["g"]["durable"]["recovered"]
        got[who] = (store.current("g").digest, store.current("g").tier,
                    rec["remapped"], store.stats()["graphs"]["g"]["durable"][
                        "arrays"])
        store.close()
    assert got["port"] == got["ref"]
    assert got["port"][1:] == ("hot", False, None)
    assert capsys.readouterr().err.count("sidecar remap failed") == 2


def test_threshold_compaction_after_recovery_like_reference(tmp_path):
    mods = _store_modules()
    got = {}
    for who, pkg in mods.items():
        d = _seed_dir(tmp_path / who)
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        store.update("g", adds=[(0, i) for i in range(100, 106)])
        store.close()
        store = pkg.GraphStore.from_dir(d, durable=True, compact_threshold=4)
        store.close()  # joins the compaction the recovery started
        snap = store.current("g")
        got[who] = (snap.version, snap.digest, sorted(os.listdir(d)))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2


def test_durable_metric_families_render(tmp_path):
    from bibfs_tpu.obs.names import DURABLE_METRIC_FAMILIES

    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.store import GraphStore
    from bibfs_tpu_torch.store.wal import DURABLE_METRIC_FAMILIES as port_fams

    assert port_fams == DURABLE_METRIC_FAMILIES
    d = _seed_dir(tmp_path)
    store = GraphStore.from_dir(d, durable=True, fsync="always",
                                compact_threshold=None, obs_label="t-dur")
    store.update("g", adds=[(0, N - 1)])
    store.compact("g")
    store.close()
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None,
                                obs_label="t-dur2")
    render = REGISTRY.render()
    for family in DURABLE_METRIC_FAMILIES:
        assert family in render, family
    assert 'bibfs_store_remap_total{store="t-dur2",graph="g"} 1' in render
    assert 'bibfs_checkpoints_total{store="t-dur",graph="g"} 1' in render
    store.close()


# ---- the landmark index through a checkpoint --------------------------
@pytest.mark.parametrize("replay", ["none", "adds", "dels"])
def test_recovery_adopts_the_checkpointed_index(tmp_path, replay):
    """A durable compaction on an oracle store writes its new snapshot's
    index into the sidecar; a recovery that maps it adopts it with no
    sweep, the replayed adds repaired in, and every distance equals the
    reference's host sweep from the same landmarks over the recovered live
    graph. A replayed delete leaves no index (as a live delete does)."""
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.oracle.trees import multi_source_bfs

    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.store import GraphStore

    d = _seed_dir(tmp_path)
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None,
                                oracle_k=8, device="cpu")
    assert store.wait_for_index("g", timeout=60)
    store.update("g", adds=[(0, N - 1)], dels=[tuple(_grid()[0])])
    v2 = store.compact("g")
    st = store.stats()["graphs"]["g"]
    assert st["oracle"]["ready"] and st["oracle"]["index"]["version"] == 2
    assert store.oracle("g").index.gen == st["oracle"]["gen"]
    sidecar = os.path.join(d, st["durable"]["arrays"])
    with open(os.path.join(sidecar, "manifest.json")) as f:
        assert {"oracle.dist", "oracle.landmarks"} <= set(
            json.load(f)["arrays"])
    if replay == "adds":
        store.update("g", adds=[(1, N - 2), (2, 700)])
    elif replay == "dels":
        store.update("g", dels=[(0, N - 1)])
    store.close()
    before = md._sweeps_run
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None,
                                oracle_k=8, device="cpu")
    try:
        rec = store.stats()["graphs"]["g"]["durable"]["recovered"]
        assert store.current("g").digest == v2.digest
        if replay == "dels":
            assert not rec["index_adopted"] and store.oracle("g") is None
            return
        assert rec["index_adopted"] and md._sweeps_run == before
        orc = store.oracle("g")
        assert orc is not None
        edges = np.array(sorted(_live(store)))
        rp, ci = build_csr(N, edges)
        want = multi_source_bfs(N, rp, ci, orc.index.landmarks)
        assert np.array_equal(orc.index.dist, want)
        assert orc.index.repaired_edges == (2 if replay == "adds" else 0)
    finally:
        store.close()


def test_policy_sidecar_round_trip_through_a_durable_store(tmp_path):
    """An adaptive engine over a durable store saves its learned policy as
    ``policy.json`` in the store's directory at close; a new engine over the
    recovered store loads it and its first decision is the learned route;
    the reference's router reads the same file to the same order."""
    from bibfs_tpu.graph.generate import gnp_random_graph
    from bibfs_tpu.serve.policy import AdaptiveRouter as RefRouter

    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve.policy import POLICY_SIDECAR
    from bibfs_tpu_torch.store import GraphStore

    n = 700
    edges = gnp_random_graph(n, 30.0 / n, seed=6)
    d = tmp_path / "store"
    d.mkdir()
    store = GraphStore(wal_dir=str(d), compact_threshold=None)
    store.add("g", n, edges)
    kw = dict(blocked=True, adaptive=True, device_batches=True,
              cache_entries=0, flush_threshold=4, device="cpu")
    eng = QueryEngine(store=store, graph="g", **kw)
    rng = np.random.default_rng(17)
    try:
        for _ in range(6):
            qp = rng.integers(0, n, size=(160, 2))
            eng.query_many(qp[qp[:, 0] != qp[:, 1]])
        learned = eng.stats()["adaptive"]
        digest = learned["first_decision"]["digest"]
        route = learned["digests"][digest]["last"]["route"]
        assert learned["digests"][digest]["last"]["reason"] == "learned"
        assert learned["path"] == os.path.join(str(d), POLICY_SIDECAR)
    finally:
        eng.close()
        store.close()
    assert (d / POLICY_SIDECAR).exists()
    store = GraphStore.from_dir(str(d), durable=True, compact_threshold=None)
    eng = QueryEngine(store=store, graph="g", **kw)
    try:
        st = eng.stats()["adaptive"]
        assert st["loaded"]
        qp = rng.integers(0, n, size=(160, 2))
        eng.query_many(qp[qp[:, 0] != qp[:, 1]])
        first = eng.stats()["adaptive"]["first_decision"]
        assert first["digest"] == digest
        assert (first["route"], first["reason"]) == (route, "learned")
    finally:
        eng.close()
        store.close()
    ladder = ("blocked", "device", "host")
    ref = RefRouter(label="t-ref", routes=ladder,
                    path=str(d / POLICY_SIDECAR))
    assert ref.loaded
    assert ref.order(digest, 256, ladder)[0][0] == route


def test_sidecar_layouts_ride_every_sidecar(tmp_path):
    """``sidecar_layouts=("ell", "blocked")`` writes the ELL and tile
    tables into the sidecars of the registration, a compaction and a swap;
    the reference maps the last one under ``verify="full"`` to tables equal
    to its own builds of that graph, and a recovery serves from the mapped
    ELL with the reference's answers. An unknown layout is refused."""
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.solvers.serial import solve_serial_csr
    from bibfs_tpu.store import GraphSnapshot as RefSnapshot
    from bibfs_tpu.store import load_sidecar as ref_load

    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.store import GraphSnapshot, GraphStore

    d = tmp_path / "store"
    d.mkdir()
    store = GraphStore(wal_dir=str(d), compact_threshold=None,
                       retain_history=True,
                       sidecar_layouts=("ell", "blocked"))
    store.add("g", N, _grid())
    sidecars = [store.stats()["graphs"]["g"]["durable"]["arrays"]]
    store.update("g", adds=[(0, N - 1)])
    store.compact("g")
    sidecars.append(store.stats()["graphs"]["g"]["durable"]["arrays"])
    store.swap("g", GraphSnapshot.build(N, _grid()[1:], version=3))
    sidecars.append(store.stats()["graphs"]["g"]["durable"]["arrays"])
    store.close()
    assert len(set(sidecars)) == 3
    for name in sidecars:
        with open(d / name / "manifest.json") as f:
            arrays = set(json.load(f)["arrays"])
        assert {"ell.nbr", "ell.deg", "blocked.tab", "blocked.bcol"} <= arrays
    mapped = RefSnapshot.from_sidecar(ref_load(d / sidecars[-1], verify="full"))
    want = RefSnapshot.build(N, _grid()[1:])
    assert np.array_equal(mapped.ell().nbr, want.ell().nbr)
    assert np.array_equal(mapped.blocked().tab, want.blocked().tab)
    store = GraphStore.from_dir(str(d), durable=True, compact_threshold=None)
    try:
        assert isinstance(store.current("g").ell().nbr, np.memmap)
        eng = QueryEngine(store=store, device="cpu", device_batches=True,
                          flush_threshold=4)
        pairs = np.random.default_rng(9).integers(0, N, size=(40, 2))
        rp, ci = build_csr(N, _grid()[1:])
        for (s, t), r in zip(pairs, eng.query_many(pairs, graph="g")):
            w = solve_serial_csr(N, rp, ci, int(s), int(t))
            assert (r.found, r.hops) == (w.found, w.hops)
        assert eng.counters["device_queries"] > 0
        eng.close()
    finally:
        store.close()
    with pytest.raises(ValueError, match="sidecar layouts"):
        GraphStore(sidecar_layouts=("tiered",))
