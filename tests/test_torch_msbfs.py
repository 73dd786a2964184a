"""The port's level-range sweep (``bibfs_tpu_torch.ops.msbfs_device``:
``msbfs_levels`` and its plain twin ``msbfs_levels_plain``, what the CUDA
sweep kernel runs in one launch) against the JAX package's host sweep
(``bibfs_tpu.oracle.trees.multi_source_bfs``) on the CPU, exactly: the
plane after levels ``1..L`` is the reference's with every distance above
``L`` unreached, for K = 1, 32, 33, 64, 65, 100, 129, 200 (one to eight
words) on a grid and on a graph of many components; a range from a mid
state equals the one-level loop; the depth cap raises; the frontier bound
equals a hand count; an index build uploads its CSR once."""

import numpy as np
import pytest

K_VALUES = (1, 32, 33, 64, 65, 100, 129, 200)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _graph(name: str):
    """``(n, row_ptr, col_ind)``: a perforated 24x20 grid, or a sparse
    G(300, 1.2 / 300) of many components (isolated vertices included)."""
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    if name == "grid":
        n = 24 * 20
        edges = grid_graph(24, 20, perforation=0.05, seed=1)
    else:
        n = 300
        edges = gnp_random_graph(n, 1.2 / n, seed=3)
    rp, ci = build_csr(n, edges)
    return n, rp, ci


def _tensors(rp, ci):
    import torch

    return torch.from_numpy(rp), torch.from_numpy(ci.astype(np.int32))


def _packed(bits: np.ndarray, words: int):
    """``bool [n, c]`` columns as ``int32 [n, words]`` mask words."""
    import torch

    from bibfs_tpu_torch.ops.msbfs_device import WORD_BITS, pack_words

    full = np.zeros((bits.shape[0], words * WORD_BITS), dtype=bool)
    full[:, :bits.shape[1]] = bits
    return pack_words(torch.from_numpy(full))


@pytest.mark.parametrize("k", K_VALUES)
@pytest.mark.parametrize("graph", ["grid", "components"])
def test_level_range_twin_equals_reference_truncated(graph, k):
    import torch

    from bibfs_tpu.oracle.trees import multi_source_bfs as ref_bfs

    from bibfs_tpu_torch.ops import msbfs_device as md

    n, rp, ci = _graph(graph)
    rng = np.random.default_rng(k)
    # the components graph draws with repeats: duplicate sources
    src = rng.choice(n, size=k, replace=graph == "components")
    want = ref_bfs(n, rp, ci, src)
    depth = int(want.max())
    rpt, cit = _tensors(rp, ci)
    words = md.state_words(k)
    for last in sorted({1, 5, depth}):
        reach, pending, dist = md.seed_state(n, torch.from_numpy(src))
        assert reach.shape == (n, words)
        nxt, st = md.msbfs_levels(rpt, cit, pending, reach, dist, 1, last)
        cut = np.where(want > last, -1, want)
        np.testing.assert_array_equal(dist.numpy(), cut)
        assert st == {"levels": min(last, depth),
                      "run": min(last, depth + 1)}
        assert torch.equal(nxt, _packed(cut == last, words))
        assert torch.equal(reach, _packed(cut >= 0, words))


@pytest.mark.parametrize("graph", ["grid", "components"])
def test_range_from_mid_state_equals_level_loop(graph):
    """Levels from a mid-sweep state: the range equals the one-level loop
    on every output, stops after the first level that finds nothing, and
    leaves its input ``pending`` as it was."""
    import torch

    from bibfs_tpu_torch.ops import msbfs_device as md

    n, rp, ci = _graph(graph)
    rpt, cit = _tensors(rp, ci)
    src = np.random.default_rng(9).choice(n, size=40, replace=False)
    reach, pending, dist = md.seed_state(n, torch.from_numpy(src))
    flag = torch.zeros(1, dtype=torch.int32)
    for level in range(1, 4):
        pending = md.msbfs_level(rpt, cit, pending, reach, dist, level, flag)
    loop = [t.clone() for t in (pending, reach, dist)]
    again = [t.clone() for t in (pending, reach, dist)]
    pending0 = pending.clone()
    nxt, st = md.msbfs_levels(rpt, cit, pending, reach, dist, 4, 1000)
    assert torch.equal(pending, pending0)
    lp, lr, ld = loop
    run = last_new = 0
    for level in range(4, 1001):
        flag.zero_()
        lp = md.msbfs_level(rpt, cit, lp, lr, ld, level, flag)
        run += 1
        if int(flag) == 0:
            break
        last_new = level
    assert st == {"levels": last_new, "run": run}
    assert torch.equal(nxt, lp) and not bool(nxt.any())
    assert torch.equal(reach, lr) and torch.equal(dist, ld)
    # a span that ends before the sweep does hands back its frontier
    pending, reach, dist = again
    mid, st = md.msbfs_levels(rpt, cit, pending, reach, dist, 4, 6)
    assert st == {"levels": 6, "run": 3} and bool(mid.any())
    assert int(dist.max()) == 6


def test_range_twin_depth_cap_raises(monkeypatch):
    """A level above the int16 range (lowered to 20 here) that finds a
    vertex raises the reference's ValueError and stamps nothing above the
    range; a range that stays inside it runs."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.ops import msbfs_device as md

    n = 30
    rp, ci = build_csr(n, np.array([[i, i + 1] for i in range(n - 1)]))
    rpt, cit = _tensors(rp, ci)
    monkeypatch.setattr(md, "INT16_MAX", 20)
    reach, pending, dist = md.seed_state(n, torch.tensor([0, 3]))
    with pytest.raises(ValueError, match="int16"):
        md.msbfs_levels(rpt, cit, pending, reach, dist, 1, 40)
    assert int(dist.max()) == 20
    reach, pending, dist = md.seed_state(n, torch.tensor([0, 3]))
    _nxt, st = md.msbfs_levels(rpt, cit, pending, reach, dist, 1, 20)
    assert st == {"levels": 20, "run": 20}


def test_state_words_pad_to_vector_loads():
    import torch

    from bibfs_tpu_torch.ops import msbfs_device as md

    got = {k: md.state_words(k) for k in (1, 32, 33, 64, 65, 96, 100, 128,
                                          129, 257)}
    assert got == {1: 1, 32: 1, 33: 2, 64: 2, 65: 4, 96: 4, 100: 4, 128: 4,
                   129: 8, 257: 12}
    reach, pending, dist = md.seed_state(10, torch.tensor([1, 2, 2]))
    assert reach.shape == pending.shape == (10, 1) and dist.shape == (10, 3)


@pytest.mark.parametrize("graph", ["grid", "components"])
def test_frontier_bytes_equals_hand_count(graph):
    """``frontier_bytes`` against a loop over levels, vertices and words
    on a seeded sweep's plane (K = 40: two words, the second partial)."""
    from bibfs_tpu.oracle.trees import multi_source_bfs as ref_bfs

    from bibfs_tpu_torch.ops import msbfs_device as md

    n, rp, ci = _graph(graph)
    k = 40
    plane = ref_bfs(n, rp, ci,
                    np.random.default_rng(4).choice(n, size=k, replace=True))
    got = md.frontier_bytes(rp, ci, plane)
    depth = int(plane.max())
    assert got.shape == (depth + 2,) and got[0] == 0
    words = [slice(0, 32), slice(32, k)]
    for level in range(1, depth + 2):
        want = 2 * int((plane == level).sum())
        pend = [(plane[:, w] == level - 1).any(axis=1) for w in words]
        for v in range(n):
            nbrs = ci[rp[v]:rp[v + 1]]
            if any(p[v] for p in pend):
                want += 16 + 4 * nbrs.size
            for w, p in zip(words, pend):
                want += 4 * int(p[v])
                want += 4 * int(p[nbrs].any())
                want += 8 * int((plane[v, w] == level).any())
        assert got[level] == want, level


def test_index_build_uploads_the_csr_once(monkeypatch):
    """A landmark build's sweeps (several batches) read one CSR upload,
    and the index equals the host build's."""
    import torch

    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.oracle import build_index

    n, rp, ci = _graph("grid")
    uploads = []
    upload = md.upload_csr

    def counted(row_ptr, col_ind, device=None):
        if not isinstance(row_ptr, torch.Tensor):  # a host CSR: a copy
            uploads.append(device)
        return upload(row_ptr, col_ind, device)

    monkeypatch.setattr(md, "upload_csr", counted)
    before = md.sweeps_run()
    got = build_index(n, rp, ci, 20, device="cpu")  # two batches of 10
    assert md.sweeps_run() - before >= 2 and len(uploads) == 1
    want = build_index(n, rp, ci, 20, device="host")
    np.testing.assert_array_equal(got.landmarks, want.landmarks)
    np.testing.assert_array_equal(got.dist, want.dist)
