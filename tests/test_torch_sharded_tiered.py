"""The port's vertex-sharded search on the tiered layout (a skewed RMAT
and a star hub, hub tiers sharded by hub rank), its ``--unroll`` parity,
Beamer's push/pull switch and the raw outputs it shares with the dense
search, against the JAX package's ``solve_sharded`` on its virtual CPU
mesh; cases and spawns in ``test_torch_sharded_cases.py``."""

import numpy as np
import pytest

from tests.test_torch_sharded_cases import (
    ELL,
    LINE,
    RMAT,
    STAR,
    TIERED_MODES,
    UNROLLS,
    WORLDS,
    _ref_graph,
    assert_same_raw,
    check_shared_with_dense,
    port,
    ref_raw,
)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["rmat", "star"])
@pytest.mark.parametrize("mode", TIERED_MODES)
def test_tiered_modes_match_reference(world, key, mode):
    runs = port(world, "tiered")
    for p in (RMAT if key == "rmat" else STAR)[2]:
        assert_same_raw(runs[key, mode, p, 1], ref_raw(key, world, mode, p),
                        (key, mode, p))


@pytest.mark.parametrize("mode,unroll", UNROLLS)
def test_unroll_parity_matches_reference(mode, unroll):
    """``--unroll`` changes nothing: every output equals the reference's
    at the same unroll and the port's at unroll 1, on a line that stops
    mid-block and on the random graph, at 4 devices."""
    world = 4
    runs = port(world, "tiered")
    for key, p in (("line", (0, LINE[0] - 1)), ("ell", ELL[2][3])):
        got = runs[key, mode, p, unroll]
        assert_same_raw(got, ref_raw(key, world, mode, p, unroll),
                        (key, mode, unroll))
        base = runs[key, mode, p, 1]
        assert got[1:3] + got[5:] == base[1:3] + base[5:]
        assert np.array_equal(got[3], base[3])


@pytest.mark.parametrize("world", WORLDS)
def test_beamer_push_pull_switching_matches_reference(world):
    """A push cap of 2 makes the search cross push -> pull and the
    pull -> push rebuild of the replicated list mid-search."""
    p = ELL[2][0]
    assert_same_raw(port(world, "tiered")["ell", "beamer", p, "cap2"],
                    ref_raw("ell", world, "beamer", p, push_cap=2), "cap2")


def _fields(r):
    return (r.found, r.hops, r.path, r.meet, r.levels, r.edges_scanned)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_tiered_batch_matches_reference(world):
    """The sharded batch runs its queries one after another through the
    collective program; each equals the reference's vmapped batch."""
    from bibfs_tpu.solvers.sharded import solve_batch_sharded_graph

    for key, pairs, mode in (("rmat", RMAT[2], "beamer"),):
        got = port(world, "tiered")["batch", key, mode]
        want = solve_batch_sharded_graph(_ref_graph(key, world), pairs,
                                         mode=mode)
        assert [_fields(r) for r in got] == [_fields(r) for r in want], key


@pytest.mark.parametrize("key", ["rmat", "star"])
def test_reference_sharded_shares_recorded_fields_with_dense(key):
    """The tiered graphs' modes (the plain graph's in
    ``test_torch_sharded.py``)."""
    check_shared_with_dense(
        [(key, m, (RMAT if key == "rmat" else STAR)[2][:1])
         for m in TIERED_MODES], "tiered")
