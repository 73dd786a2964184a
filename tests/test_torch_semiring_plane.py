"""The port's semiring planes (``bibfs_tpu_torch.ops.semiring_plane``,
``graph.blocked.build_blocked_weights``, ``ops.msbfs_device.
msbfs_plane_blocked``) against the JAX package's on the CPU, on the same
seeded inputs: the weight table byte for byte; the two tile products and
the fixpoints' planes bit for bit with the same rounds (integer-valued
data, exact in float32); the triangle chunks' counts exactly; the K-source
blocked sweep's int16 plane exactly; PageRank's ranks within 1e-6 (float
sums in another order) with the same iterations, or one off where the JAX
package's last delta lies within 1e-7 of the tolerance (the two sides
straddle it). The graphs: G(150, 8 / 150) (n not a tile multiple), two
components, an empty graph and a 20x20 grid. The kernels of
``csrc/semiring.cu`` against their twins need the card (``cuda`` marker,
skipped here)."""

import numpy as np
import pytest

#: PageRank ranks: float32 sums in another order than XLA's
RANK_TOL = 1e-6
#: how near the tolerance a last delta must lie for one iteration more or
#: less to be the other side of it
STRADDLE = 1e-7


def _graphs():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    two = np.concatenate([gnp_random_graph(70, 10 / 70, seed=4),
                          70 + gnp_random_graph(80, 9 / 80, seed=5)])
    return {
        "gnp150": (150, gnp_random_graph(150, 8 / 150, seed=21)),
        "two": (150, two),
        "empty": (150, np.zeros((0, 2), dtype=np.int64)),
        "grid20": (400, grid_graph(20, 20)),
    }


GRAPHS = _graphs()
NAMES = tuple(GRAPHS)


def _blocked(name):
    from bibfs_tpu.graph.blocked import build_blocked as ref_build

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.graph.csr import canonical_pairs

    n, edges = GRAPHS[name]
    pairs = canonical_pairs(n, edges)
    return n, pairs, build_blocked(n, pairs=pairs), ref_build(n, pairs=pairs)


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _j(a):
    import jax.numpy as jnp

    return jnp.asarray(np.array(a))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_weight_table_byte_for_byte(name, seed):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    _n, pairs, bg, rg = _blocked(name)
    got = build_blocked_weights(bg, pairs, seed=seed)
    want = ref_w(rg, pairs, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _planes(n_pad, c, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 4, size=(n_pad, c)).astype(np.float32)
    # float values with +inf holes: the (min, +) sums round alike
    floats = rng.random((n_pad, c), dtype=np.float32) * 50
    floats[rng.random((n_pad, c)) < 0.3] = np.inf
    return ints, floats


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("name", NAMES)
def test_tile_products_equal_jax(name, c):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, pairs, bg, rg = _blocked(name)
    ints, floats = _planes(bg.n_pad, c, c)
    for rc in (1, bg.nblocks):
        got = port.plustimes_plane(_t(ints), _t(bg.tab), _t(bg.bcol), rc=rc)
        want = ref.plustimes_plane(_j(ints), _j(rg.tab), _j(rg.bcol), rc=rc)
        assert np.array_equal(got.numpy(), np.asarray(want))
        got = port.minplus_plane(_t(floats), _t(bg.tab), _t(bg.bcol), rc=rc,
                                 from_tab=True)
        want = ref.minplus_plane(_j(floats), _j(rg.tab), _j(rg.bcol), rc=rc,
                                 from_tab=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
        wtab = ref_w(rg, pairs, seed=2)
        got = port.minplus_plane(_t(floats), _t(wtab), _t(bg.bcol), rc=rc,
                                 from_tab=False)
        want = ref.minplus_plane(_j(floats), _j(wtab), _j(rg.bcol), rc=rc,
                                 from_tab=False)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert port.minplus_chunk_rows(bg.bwidth, c) == ref.minplus_chunk_rows(
        rg.bwidth, c)


def _sssp_init(n, n_pad, c, seed):
    srcs = np.random.default_rng(seed).choice(n, size=c, replace=False)
    init = np.full((n_pad, c), np.inf, dtype=np.float32)
    init[srcs, np.arange(c)] = 0.0
    return init


@pytest.mark.parametrize("name", NAMES)
def test_sssp_blocked_exact_rounds_equal(name):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, pairs, bg, rg = _blocked(name)
    for seed, c in ((0, 3), (1, 1)):
        init = _sssp_init(n, bg.n_pad, c, seed)
        before = port.minplus_fixpoint.launches
        got, rounds = port.sssp_blocked(
            _t(build_blocked_weights(bg, pairs, seed=seed)), _t(bg.bcol),
            _t(init))
        assert port.minplus_fixpoint.launches == before  # the CPU twin
        want, want_rounds = ref.sssp_blocked(
            _j(ref_w(rg, pairs, seed=seed)), _j(rg.bcol), _j(init))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(want_rounds)


@pytest.mark.parametrize("name", NAMES)
def test_components_blocked_exact_rounds_equal(name):
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, rg = _blocked(name)
    init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds = port.components_blocked(_t(bg.tab), _t(bg.bcol), _t(init))
    want, want_rounds = ref.components_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)


def test_fixpoint_round_cap_like_jax():
    """A cap below the fixpoint stops both after exactly that many
    sweeps, on the same plane."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, rg = _blocked("grid20")
    init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds = port.minplus_fixpoint_plain(
        _t(bg.tab), _t(bg.bcol), _t(init), from_tab=True, max_rounds=5)
    kern = ref._get_minplus_fixpoint(
        rg.nblocks, rg.bwidth, 1, ref.minplus_chunk_rows(rg.bwidth, 1), 128,
        True, 5)
    want, want_rounds = kern(_j(rg.tab), _j(rg.bcol), _j(init))
    assert rounds == int(want_rounds) == 5
    assert np.array_equal(got.numpy(), np.asarray(want))


def _iters_agree(iters, want_iters, want_delta, tol) -> bool:
    """Equal, or one off where the JAX package's last delta lies within
    :data:`STRADDLE` of the tolerance the two sides resolve."""
    tol_eff = max(float(tol), 5e-7)
    if iters == want_iters:
        return True
    return abs(iters - want_iters) == 1 and abs(want_delta - tol_eff) <= STRADDLE


@pytest.mark.parametrize("tol,max_iters", [(1e-8, 100), (1e-4, 100),
                                           (1e-8, 7)])
@pytest.mark.parametrize("name", NAMES)
def test_pagerank_blocked_within_tolerance(name, tol, max_iters):
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked(name)
    kw = dict(n=n, damping=0.85, tol=tol, max_iters=max_iters)
    ranks, iters, delta = port.pagerank_blocked(_t(bg.tab), _t(bg.bcol),
                                                _t(bg.deg), **kw)
    want, want_iters, want_delta = ref.pagerank_blocked(
        _j(rg.tab), _j(rg.bcol), _j(rg.deg), **kw)
    assert np.max(np.abs(ranks.numpy() - np.asarray(want))) <= RANK_TOL
    assert _iters_agree(iters, int(want_iters), float(want_delta), tol)
    assert iters <= max_iters
    assert abs(delta - float(want_delta)) <= RANK_TOL


def _jax_chunk_plane(n, n_pad, pairs, c0):
    """The reference route's host-built chunk plane (its
    ``TrianglesBlockedRoute``)."""
    from bibfs_tpu.graph.csr import build_csr

    rp, ci = build_csr(n, pairs=pairs)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    c1 = min(n, c0 + 256)
    plane = np.zeros((n_pad, 256), np.float32)
    m = (ci >= c0) & (ci < c1)
    plane[src[m], ci[m] - c0] = 1.0
    return plane


@pytest.mark.parametrize("name", NAMES)
def test_triangle_chunks_exact(name):
    import torch

    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.analytics.semiring import ref_triangles_intersect
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, pairs, bg, rg = _blocked(name)
    total = torch.zeros(1, dtype=torch.int64)
    want_total = 0
    for c0 in range(0, n, 256):
        plane = _jax_chunk_plane(n, bg.n_pad, pairs, c0)
        assert np.array_equal(
            port.triangle_plane(_t(bg.tab), _t(bg.bcol), c0).numpy(), plane)
        got = port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), c0)
        want = int(ref.triangles_chunk_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(plane)))
        assert int(got) == want
        port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), c0, total)
        want_total += want
    assert int(total) == want_total
    rp, ci = build_csr(n, pairs=pairs)
    assert want_total // 6 == ref_triangles_intersect(n, rp, ci)
    with pytest.raises(ValueError, match="multiple"):
        port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), 3)


@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("name", NAMES)
def test_msbfs_plane_blocked_exact(name, k):
    from bibfs_tpu.ops import msbfs_device as ref_ms
    from bibfs_tpu.solvers.dense import BlockedDeviceGraph as RefGraph

    from bibfs_tpu_torch.ops import msbfs_device as port_ms
    from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph

    n, _pairs, bg, rg = _blocked(name)
    srcs = np.random.default_rng(k).choice(n, size=k, replace=False)
    got = port_ms.msbfs_plane_blocked(BlockedDeviceGraph.from_host(
        bg, device="cpu"), srcs)
    want = ref_ms.msbfs_plane_blocked(RefGraph.from_host(rg), srcs)
    assert got.dtype == np.int16 and np.array_equal(got, want)


def test_msbfs_plane_blocked_edges():
    from bibfs_tpu_torch.ops import msbfs_device as port_ms
    from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph

    _n, _pairs, bg, _rg = _blocked("gnp150")
    g = BlockedDeviceGraph.from_host(bg, device="cpu")
    assert port_ms.msbfs_plane_blocked(g, []).shape == (150, 0)
    with pytest.raises(ValueError, match="out of range"):
        port_ms.msbfs_plane_blocked(g, [150])


# ---- the kernels against their twins, on the card --------------------------

def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_graph(name):
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.graph.csr import canonical_pairs

    dev = _card()
    n, edges = GRAPHS[name]
    pairs = canonical_pairs(n, edges)
    bg = build_blocked(n, pairs=pairs)  # the port's alone: no JAX on a card
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    w = put(build_blocked_weights(bg, pairs, seed=1))
    return n, bg, put(bg.tab), put(bg.bcol), put(bg.deg), w


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 8, 13])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_minplus_fixpoint_equals_twin(name, c):
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, bg, tab, bcol, _deg, w = _card_graph(name)
    init = torch.from_numpy(_sssp_init(n, bg.n_pad, c, c)).to(tab.device)
    before = port.minplus_fixpoint.launches
    got, rounds = port.sssp_blocked(w, bcol, init)
    assert port.minplus_fixpoint.launches == before + 1
    want, want_rounds = port.minplus_fixpoint_plain(w, bcol, init,
                                                    from_tab=False)
    assert torch.equal(got, want) and rounds == want_rounds
    labels = torch.arange(bg.n_pad, dtype=torch.float32,
                          device=tab.device)[:, None]
    got, rounds = port.components_blocked(tab, bcol, labels)
    want, want_rounds = port.minplus_fixpoint_plain(tab, bcol, labels,
                                                    from_tab=True)
    assert torch.equal(got, want) and rounds == want_rounds
    got, rounds = port.minplus_fixpoint(tab, bcol, labels, from_tab=True,
                                        max_rounds=2)
    want, _ = port.minplus_fixpoint_plain(tab, bcol, labels, from_tab=True,
                                          max_rounds=2)
    assert torch.equal(got, want) and rounds == min(2, want_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-8, 1e-4])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_pagerank_equals_twin(name, tol):
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _bg, tab, bcol, deg, _w = _card_graph(name)
    kw = dict(n=n, damping=0.85, tol=tol, max_iters=100)
    ranks, iters, delta = port.pagerank_blocked(tab, bcol, deg, **kw)
    again, iters2, _ = port.pagerank_blocked(tab, bcol, deg, **kw)
    assert torch.equal(ranks, again) and iters == iters2  # run to run
    want, want_iters, want_delta = port.pagerank_blocked_plain(
        tab, bcol, deg, **kw)
    assert float((ranks - want).abs().max()) <= RANK_TOL
    assert _iters_agree(iters, want_iters, want_delta, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_tricount_equals_twin(name):
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _bg, tab, bcol, _deg, _w = _card_graph(name)
    for c0 in range(0, n, 256):
        before = port.triangles_chunk_blocked.launches
        got = port.triangles_chunk_blocked(tab, bcol, c0)
        assert port.triangles_chunk_blocked.launches == before + 1
        want = port.triangles_chunk_blocked_plain(tab, bcol, c0)
        assert torch.equal(got, want)
