"""The PyTorch port's level code (bibfs_tpu_torch.ops.expand) against
bibfs_tpu.ops.expand on seeded random mid-search states, plain ELL and
tiered, exactly."""

import numpy as np
import pytest

INF32 = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _state(layout, n, avg, seed, density=0.05):
    """A seeded mid-search state (numpy) over a G(n, avg/n) graph (ELL)
    or an RMAT graph (tiered), as both packages' inputs."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.graph.csr import build_ell, build_tiered
    from bibfs_tpu.graph.generate import gnp_random_graph, rmat_graph

    rng = np.random.default_rng(seed)
    if layout == "tiered":
        n, edges = rmat_graph(n, edge_factor=int(avg), seed=seed)
        h = build_tiered(n, edges)
        assert h.tiers
        tiers = [(t.start, t.count, t.nbr, h.hub_ids[: t.nbr.shape[0]])
                 for t in h.tiers]
        hub_rank = h.hub_rank
    else:
        edges = gnp_random_graph(n, avg / n, seed=seed)
        h = build_ell(n, edges)
        tiers, hub_rank = [], None
    n_pad = h.n_pad
    fr_s = np.zeros(n_pad, bool)
    fr_s[rng.integers(0, n, max(1, int(n * density)))] = True
    fr_t = np.zeros(n_pad, bool)
    fr_t[rng.integers(0, n, max(1, int(n * density)))] = True
    dist_s = np.where(rng.random(n_pad) < 0.1, rng.integers(0, 5, n_pad),
                      INF32).astype(np.int32)
    dist_t = np.where(rng.random(n_pad) < 0.1, rng.integers(0, 5, n_pad),
                      INF32).astype(np.int32)
    dist_s[fr_s] = 3
    dist_t[fr_t] = 2
    dist_s[n:] = INF32
    dist_t[n:] = INF32
    par = np.where(dist_s < INF32, rng.integers(0, n, n_pad), -1).astype(np.int32)
    arrays = dict(fr_s=fr_s, fr_t=fr_t, dist_s=dist_s, dist_t=dist_t, par=par,
                  nbr=h.nbr, deg=h.deg)
    if hub_rank is not None:
        arrays["hub_rank"] = hub_rank
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    j["tiers"] = tuple((s, c, jnp.asarray(a), jnp.asarray(b)) for s, c, a, b in tiers)
    t["tiers"] = tuple((s, c, torch.as_tensor(a), torch.as_tensor(b))
                       for s, c, a, b in tiers)
    return j, t, n_pad, h


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


CASES = [("ell", 1_000, 2.2, 0), ("ell", 4_000, 3.0, 1), ("ell", 3_001, 1.5, 2),
         ("tiered", 10, 8, 7), ("tiered", 11, 4, 3)]
CASE_IDS = [f"{c[0]}-{c[1]}-{c[3]}" for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pull_and_dual_pull(case):
    from bibfs_tpu.ops import expand as je

    from bibfs_tpu_torch.ops import expand as te

    j, t, _n_pad, _h = _state(*case)
    for fr in ("fr_s", "fr_t"):
        a = je.expand_pull(j[fr], j["dist_s"] < INF32, j["nbr"], j["deg"])
        b = te.expand_pull(t[fr], t["dist_s"] < INF32, t["nbr"], t["deg"])
        for x, y in zip(a, b):
            _eq(x, y)
    _eq(je.pack_dual(j["fr_s"], j["fr_t"]), te.pack_dual(t["fr_s"], t["fr_t"]))
    a = je.expand_pull_dual(je.pack_dual(j["fr_s"], j["fr_t"]),
                            j["dist_s"] < INF32, j["dist_t"] < INF32,
                            j["nbr"], j["deg"])
    b = te.expand_pull_dual(te.pack_dual(t["fr_s"], t["fr_t"]),
                            t["dist_s"] < INF32, t["dist_t"] < INF32,
                            t["nbr"], t["deg"])
    for x, y in zip(a, b):
        _eq(x, y)
    _eq(je.frontier_count(j["fr_s"]), te.frontier_count(t["fr_s"]))
    _eq(je.frontier_degree_sum(j["fr_t"], j["deg"]),
        te.frontier_degree_sum(t["fr_t"], t["deg"]))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tiered_levels(case):
    """expand_pull_tiered / expand_pull_dual_tiered (base pull + hub tiers)
    and the tier folds on their own."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import expand as je

    from bibfs_tpu_torch.ops import expand as te

    j, t, n_pad, _h = _state(*case)
    a = je.expand_pull_tiered(j["fr_s"], j["par"], j["dist_s"], j["nbr"],
                              j["deg"], j["tiers"], jnp.int32(4), inf=INF32)
    b = te.expand_pull_tiered(t["fr_s"], t["par"], t["dist_s"], t["nbr"],
                              t["deg"], t["tiers"], torch.tensor(4, dtype=torch.int32),
                              inf=INF32)
    for x, y in zip(a, b):
        _eq(x, y)
    a = je.expand_pull_dual_tiered(
        j["fr_s"], j["fr_t"], j["par"], j["dist_s"], j["par"], j["dist_t"],
        j["nbr"], j["deg"], j["tiers"], jnp.int32(4), jnp.int32(3), inf=INF32)
    b = te.expand_pull_dual_tiered(
        t["fr_s"], t["fr_t"], t["par"], t["dist_s"], t["par"], t["dist_t"],
        t["nbr"], t["deg"], t["tiers"], torch.tensor(4, dtype=torch.int32),
        torch.tensor(3, dtype=torch.int32), inf=INF32)
    for x, y in zip(a, b):
        _eq(x, y)
    # the tier folds alone, from a base pull's (nf, par)
    vis_j, vis_t = j["dist_s"] < INF32, t["dist_s"] < INF32
    nf_j, pc_j = je.expand_pull(j["fr_s"], vis_j, j["nbr"], j["deg"])
    nf_t, pc_t = te.expand_pull(t["fr_s"], vis_t, t["nbr"], t["deg"])
    a = je.apply_tiers(nf_j, jnp.where(nf_j, pc_j, j["par"]), j["fr_s"], vis_j,
                       j["deg"], j["tiers"], n_pad)
    b = te.apply_tiers(nf_t, torch.where(nf_t, pc_t, t["par"]), t["fr_s"],
                       vis_t, t["deg"], t["tiers"], n_pad)
    for x, y in zip(a, b):
        _eq(x, y)
    vt_j, vt_t = j["dist_t"] < INF32, t["dist_t"] < INF32
    a = je.apply_tiers_dual(nf_j, pc_j, nf_j, pc_j,
                            je.pack_dual(j["fr_s"], j["fr_t"]), vis_j, vt_j,
                            j["deg"], j["tiers"], n_pad)
    b = te.apply_tiers_dual(nf_t, pc_t, nf_t, pc_t,
                            te.pack_dual(t["fr_s"], t["fr_t"]), vis_t, vt_t,
                            t["deg"], t["tiers"], n_pad)
    for x, y in zip(a, b):
        _eq(x, y)


def test_tier_parent_combines_by_max():
    """A hub reached by both its base slots and a tier slot keeps the
    LARGER candidate parent (scatter-max), not the tier's overwrite —
    and the port agrees with the reference on such a hub."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import expand as je

    from bibfs_tpu_torch.ops import expand as te

    j, t, n_pad, h = _state("tiered", 10, 8, 7, density=0.3)
    vis = t["dist_s"] < INF32
    nf, pc = te.expand_pull(t["fr_s"], vis, t["nbr"], t["deg"])
    base_par = torch.where(nf, pc, t["par"])
    nf2, par2 = te.apply_tiers(nf, base_par, t["fr_s"], vis, t["deg"],
                               t["tiers"], n_pad)
    hubs = torch.as_tensor(h.hub_ids[h.hub_ids >= 0]).long()
    both = nf[hubs] & (par2[hubs] != base_par[hubs])
    assert bool(both.any())  # a base hit improved by a larger tier parent
    assert bool((par2[hubs] >= base_par[hubs]).all())
    a = je.apply_tiers(jnp.asarray(nf.numpy()), jnp.asarray(base_par.numpy()),
                       j["fr_s"], j["dist_s"] < INF32, j["deg"], j["tiers"], n_pad)
    _eq(a[1], par2)


@pytest.mark.parametrize("case,k", [(CASES[0], 128), (CASES[1], 32),
                                    (CASES[3], 128), (CASES[4], 16)],
                         ids=["ell-k128", "ell-overflow", "tiered-k128",
                              "tiered-overflow"])
def test_push(case, k):
    """The Beamer push path over the frontier's index list, including a
    frontier larger than K (winners past K drop)."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import expand as je
    from bibfs_tpu.solvers.dense import push_span

    from bibfs_tpu_torch.ops import expand as te

    j, t, _n_pad, h = _state(*case, density=0.01)
    meta = tuple((tr.start, tr.count, tr.nbr.shape[1])
                 for tr in getattr(h, "tiers", ()))
    _span, ncov = push_span(h.width, meta)
    fidx = np.full(k, -1, np.int32)
    live = np.flatnonzero(np.asarray(j["fr_s"]))[:k]
    fidx[: live.size] = live
    hub_j = j.get("hub_rank")
    hub_t = t.get("hub_rank")
    a = je.expand_push_tiered(jnp.asarray(fidx), j["par"], j["dist_s"],
                              j["nbr"], j["deg"], hub_j, j["tiers"][:ncov],
                              jnp.int32(4), inf=INF32)
    b = te.expand_push_tiered(torch.as_tensor(fidx), t["par"], t["dist_s"],
                              t["nbr"], t["deg"], hub_t, t["tiers"][:ncov],
                              torch.tensor(4, dtype=torch.int32), inf=INF32)
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        _eq(x, y)
