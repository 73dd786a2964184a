"""Kernels 1, 3 and 4 at a shard's geometry: the local rows of one rank
of a 4-rank vertex-sharded search, their table slots global ids, the
frontier over the global id space (``id_space``), the rows placed at a
nonzero ``row_offset``. The plain twins (what a CPU tensor runs) against
the JAX package's Pallas kernels in interpret mode at the same geometry
(``prepare_*_tables(..., id_space=n_glob)``), exactly; on a CUDA card only,
each CUDA kernel against its twin there."""

import numpy as np
import pytest

INF32 = 1 << 30
WORLD = 4


def _shard(n: int, rank: int, seed: int):
    """A G(n, 6/n) graph's rank-``rank`` shard of ``WORLD`` ranks and a
    seeded mid-search state: local rows, the global frontiers, the local
    dist and parent rows (the source side at level 2, the target side at
    level 3)."""
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    g = build_ell(n, gnp_random_graph(n, 6.0 / n, seed=seed),
                  pad_multiple=8 * WORLD)
    n_loc = g.n_pad // WORLD
    off = rank * n_loc
    rng = np.random.default_rng(seed)
    out = dict(n_glob=g.n_pad, n_loc=n_loc, off=off,
               nbr=g.nbr[off:off + n_loc], deg=g.deg[off:off + n_loc])
    for side, lvl in (("s", 2), ("t", 3)):
        dist = np.full(g.n_pad, INF32, np.int32)
        vis = rng.random(n) < 0.3
        dist[:n][vis] = rng.integers(0, lvl + 1, int(vis.sum()))
        par = np.where(dist < INF32, rng.integers(0, n, g.n_pad), -1)
        out[f"fr_{side}"] = dist == lvl
        out[f"dist_{side}"] = dist[off:off + n_loc]
        out[f"par_{side}"] = par[off:off + n_loc].astype(np.int32)
    return out


SHARDS = [(300, 2, 5), (1000, 1, 6), (1000, 3, 7)]


@pytest.mark.parametrize("n,rank,seed", SHARDS)
def test_pull_twins_at_shard_geometry_match_pallas(n, rank, seed):
    """Kernels 4 and 3 (plain versions, ``run_pull`` / ``run_pull_dual``)
    over a shard's rows with the global frontier equal the reference's
    interpret-mode kernels over its ``id_space`` tables."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_expand as jpe

    from bibfs_tpu_torch.ops import pull_expand as tpe

    s = _shard(n, rank, seed)
    jt = jpe.prepare_pallas_tables(jnp.asarray(s["nbr"]), jnp.asarray(s["deg"]),
                                   id_space=s["n_glob"])
    tt = tpe.prepare_pallas_tables(torch.as_tensor(s["nbr"]),
                                   torch.as_tensor(s["deg"]),
                                   id_space=s["n_glob"])
    assert int(tt[0].max()) == s["n_glob"]  # the dead slots' global sentinel
    vs, vt = (s[f"dist_{x}"] < INF32 for x in "st")

    def same(got, want):
        """``(nf, parent)`` pairs: the next frontier in full, the parent
        where it is set (the Pallas raw parent is key garbage elsewhere,
        the port's -1)."""
        for i in range(0, len(got), 2):
            nf = got[i].numpy()
            assert nf.any()
            assert np.array_equal(nf, np.asarray(want[i])[: s["n_loc"]])
            pc = got[i + 1].numpy()
            assert np.array_equal(pc[nf], np.asarray(want[i + 1])[: s["n_loc"]][nf])
            assert (pc[~nf] == -1).all()
            assert (pc[nf] >= 0).all() and (pc[nf] < s["n_glob"]).all()

    same(tpe.run_pull(tt, torch.as_tensor(s["fr_s"]), torch.as_tensor(vs)),
         jpe.run_pull(jt, jnp.asarray(s["fr_s"]), jnp.asarray(vs)))
    same(tpe.run_pull_dual(tt, torch.as_tensor(s["fr_s"]),
                           torch.as_tensor(s["fr_t"]), torch.as_tensor(vs),
                           torch.as_tensor(vt)),
         jpe.run_pull_dual(jt, jnp.asarray(s["fr_s"]), jnp.asarray(s["fr_t"]),
                           jnp.asarray(vs), jnp.asarray(vt)))


@pytest.mark.parametrize("n,rank,seed", SHARDS)
def test_fused_twin_at_shard_geometry_matches_pallas(n, rank, seed):
    """Kernel 1 (plain version, ``fused_dual_level``) over a shard's rows
    with the global dual row equals the reference's ``fused_dual_level``
    over its ``id_space`` tables: rows and the eight reductions; and the
    round with ``row_offset`` votes the meet at the global id."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_fused as jpf

    from bibfs_tpu_torch.ops import fused_level as tfl

    s = _shard(n, rank, seed)
    n_loc, ids = s["n_loc"], s["n_glob"]
    dual = s["fr_s"].astype(np.uint8) | (s["fr_t"].astype(np.uint8) << 1)
    nt, dt = tfl.prepare_fused_tables(torch.as_tensor(s["nbr"]),
                                      torch.as_tensor(s["deg"]), id_space=ids)
    rows = {k: torch.as_tensor(s[k]) for k in ("dist_s", "dist_t", "par_s",
                                                "par_t")}
    got = tfl.fused_dual_level(torch.as_tensor(dual), nt, dt, rows["dist_s"],
                               rows["dist_t"], rows["par_s"], rows["par_t"],
                               3, 4)
    nj, dj = jpf.prepare_fused_tables(jnp.asarray(s["nbr"]),
                                      jnp.asarray(s["deg"]), id_space=ids)
    rp, ip = nj.shape[1], jpf.pad_rows(ids)

    def pad(a, fill, width):
        out = np.full(width, fill, np.int32)
        out[: a.shape[0]] = a
        return jnp.asarray(out).reshape(1, width)

    want = jpf.fused_dual_level(
        pad(dual.astype(np.int32), 0, ip), nj, dj,
        pad(s["dist_s"], INF32, rp), pad(s["dist_t"], INF32, rp),
        pad(s["par_s"], -1, rp), pad(s["par_t"], -1, rp),
        jnp.int32(3), jnp.int32(4), ks=jpf.key_stride(ids))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0])[0, :n_loc])
    for a, b in zip(got[1:5], want[1:5]):
        assert np.array_equal(a.numpy(), np.asarray(b)[0, :n_loc])
    assert list(got[5:11]) == [int(x) for x in want[5:11]]
    assert got[11] == int(want[11])
    if got[11] < INF32:
        assert got[12] == int(want[12])
    # the round itself: the meet key carries row_offset + the local row
    bits = tfl._bits_of_row(torch.as_tensor(dual), 2, 3, ids)
    state = tfl._level_state(3, 4, 1, "cpu")
    acc, key = tfl.new_scratch("cpu")
    work = {k: v.clone() for k, v in rows.items()}
    tfl.fused_dual_round(nt, dt, bits, work["dist_s"], work["dist_t"],
                         work["par_s"], work["par_t"], state, acc, key,
                         id_space=ids, row_offset=s["off"])
    mval, midx = tfl.decode_meet(int(key[0]))
    assert mval == got[11]
    if mval < INF32:
        assert midx == got[12] + s["off"]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,rank,seed", SHARDS + [(50_000, 3, 8)])
def test_cuda_kernels_at_shard_geometry_match_twins(cuda_device, n, rank,
                                                    seed):
    """Kernels 1, 3 and 4 on the card at a shard's geometry (global ids in
    the table, a global frontier, ``row_offset > 0``) against their twins
    on the same inputs, exactly."""
    import torch

    from bibfs_tpu_torch.ops import bitmap as bm
    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.ops import pull_expand as pe
    from bibfs_tpu_torch.ops.expand import pack_dual

    s = _shard(n, rank, seed)
    assert s["off"] > 0
    ids = s["n_glob"]
    dev = cuda_device
    nbr_t, deg = fl.prepare_fused_tables(torch.as_tensor(s["nbr"]).to(dev),
                                         torch.as_tensor(s["deg"]).to(dev),
                                         id_space=ids)
    fr_s, fr_t = (torch.as_tensor(s[k]).to(dev) for k in ("fr_s", "fr_t"))
    vs, vt = (torch.as_tensor(s[f"dist_{x}"] < INF32).to(dev) for x in "st")
    bits = bm.pack_bits(fr_s, bm.frontier_words(ids))
    pair = pe.pack_front(fr_s, fr_t, ids)
    for got, want in (
            (pe.pull_single(nbr_t, deg, bits, vs, id_space=ids),
             pe.pull_single_plain(nbr_t, deg, bits, vs, id_space=ids)),
            (pe.pull_dual(nbr_t, deg, pair, vs, vt, id_space=ids),
             pe.pull_dual_plain(nbr_t, deg, pair, vs, vt, id_space=ids))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    dual = pack_dual(fr_s, fr_t)
    runs = []
    for fn in (fl.fused_dual_round, fl.fused_dual_round_plain):
        b = dict(bits=fl._bits_of_row(dual, 2, 3, ids),
                 **{k: torch.as_tensor(s[k]).to(dev)
                    for k in ("dist_s", "dist_t", "par_s", "par_t")})
        state = fl._level_state(3, 4, 1, dev)
        acc, key = fl.new_scratch(dev)
        fn(nbr_t, deg, b["bits"], b["dist_s"], b["dist_t"], b["par_s"],
           b["par_t"], state, acc, key, id_space=ids, row_offset=s["off"])
        runs.append([b[k] for k in ("bits", "dist_s", "dist_t", "par_s",
                                    "par_t")] + [acc, key])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
