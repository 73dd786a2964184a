"""The port's collectives (bibfs_tpu_torch/parallel/collectives.py) over
gloo ranks on the CPU against the JAX package's on its virtual CPU mesh.

One spawn of ranks per world size (2 and 4) runs every collective case
(``collectives.on_shards``); the reference runs the same global arrays
through ``shard_map`` on a mesh of as many devices. Tolerance: none."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

WORLDS = (2, 4)
N_LOCS = (16, 32, 40)  # incl. non-multiples of 32
M_SIZES = (1, 7, 32, 33, 40, 256, 1000)
_RUNS: dict = {}


def _frontiers(world: int, n_loc: int):
    rng = np.random.default_rng(1000 * world + n_loc)
    n = world * n_loc
    return rng.random(n) < 0.4, rng.random(n) < 0.3


def _ties(world: int):
    """Per-rank (value, global arg) pairs with ties on the minimum (ranks
    0 and the last share it, the last with the lower arg) and a negative
    value."""
    vals = np.full(world, 9, np.int32)
    vals[0] = vals[-1] = -3
    args = np.arange(world, dtype=np.int32) * 100 + 50
    args[-1] = 7
    return vals, args


def _calls(world: int) -> list:
    calls = []
    for n_loc in N_LOCS:
        fr_s, fr_t = _frontiers(world, n_loc)
        calls.append(("all_gather_bits", fr_s))
        calls.append(("all_gather_bits_dual", fr_s, fr_t))
    calls.append(("global_min_and_argmin", *_ties(world)))
    return calls


def port(world: int) -> list:
    """Every case's rank-0 value from one spawn of ``world`` gloo ranks."""
    if world not in _RUNS:
        from bibfs_tpu_torch.parallel.collectives import on_shards
        from bibfs_tpu_torch.parallel.mesh import launch

        _RUNS[world] = launch(on_shards, world, _calls(world), device="cpu",
                              timeout_s=300)
    return _RUNS[world]


def _reference_gather(world: int, fn, *arrays):
    from bibfs_tpu.parallel.mesh import VERTEX_AXIS, make_1d_mesh, shard_map

    mesh = make_1d_mesh(world)

    @partial(shard_map, mesh=mesh, in_specs=(P(VERTEX_AXIS),) * len(arrays),
             out_specs=P(), check_vma=False)
    def body(*shards):
        return fn(*shards, VERTEX_AXIS)

    return np.asarray(body(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("m", M_SIZES)
def test_pack_unpack_roundtrip_matches_reference(m):
    from bibfs_tpu.parallel import collectives as jc

    from bibfs_tpu_torch.parallel import collectives as tc

    import torch

    rng = np.random.default_rng(m)
    fr = rng.random(m) < 0.3
    words = tc.pack_bits(torch.as_tensor(fr))
    assert words.dtype == torch.int32 and words.shape == (-(-m // 32),)
    ref = np.asarray(jc.pack_bits(jnp.asarray(fr)))
    assert np.array_equal(words.numpy().view(np.uint32), ref)
    assert np.array_equal(tc.unpack_bits(words, m).numpy(), fr)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_loc", N_LOCS)
def test_all_gather_bits_matches_reference(world, n_loc):
    from bibfs_tpu.parallel.collectives import all_gather_bits

    fr_s, _ = _frontiers(world, n_loc)
    got = port(world)[2 * N_LOCS.index(n_loc)][0]
    assert np.array_equal(got, fr_s)
    assert np.array_equal(got, _reference_gather(world, all_gather_bits, fr_s))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_loc", N_LOCS)
def test_all_gather_bits_dual_matches_reference(world, n_loc):
    from bibfs_tpu.parallel.collectives import all_gather_bits_dual

    fr_s, fr_t = _frontiers(world, n_loc)
    got = port(world)[2 * N_LOCS.index(n_loc) + 1][0]
    want = _reference_gather(world, all_gather_bits_dual, fr_s, fr_t)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, fr_s.astype(np.uint8) | (fr_t.astype(np.uint8) << 1))


@pytest.mark.parametrize("world", WORLDS)
def test_global_min_and_argmin_ties_match_reference(world):
    """The lowest value, then the lowest global id among the ranks at it."""
    from bibfs_tpu.parallel.collectives import global_min_and_argmin

    vals, args = _ties(world)
    gmin, garg = port(world)[-1]
    assert (int(gmin[0]), int(garg[0])) == (-3, 7)
    want = _reference_gather(
        world, lambda v, a, ax: jnp.stack(global_min_and_argmin(v[0], a[0], ax)),
        vals, args)
    assert (int(gmin[0]), int(garg[0])) == tuple(int(x) for x in want)


@pytest.mark.parametrize("n_loc", [1, 31, 32, 33, 1_000_000 // 8, 1 << 18])
def test_frontier_exchange_bytes_matches_reference(n_loc):
    from bibfs_tpu.parallel import collectives as jc

    from bibfs_tpu_torch.parallel import collectives as tc

    for packed in (True, False):
        assert (tc.frontier_exchange_bytes(n_loc, packed)
                == jc.frontier_exchange_bytes(n_loc, packed))
    if n_loc >= 1 << 10:
        assert (tc.frontier_exchange_bytes(n_loc, False)
                / tc.frontier_exchange_bytes(n_loc, True)) >= 7.9


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_kernel_rows_equal_packed_global_frontiers(world):
    """The kernels' gathered rows (a bitmap for kernels 1 and 4, a pair
    row for kernel 3) equal the global frontier packed in one piece,
    where the shards fill whole words and where they do not."""
    import torch

    from bibfs_tpu_torch.ops.bitmap import frontier_words, pack_bits
    from bibfs_tpu_torch.ops.pull_expand import pack_front
    from bibfs_tpu_torch.parallel.collectives import _global_rows

    for n_loc in (16, 40, 128, 200):
        fr_s, fr_t = (torch.as_tensor(f) for f in _frontiers(world, n_loc))
        n = world * n_loc
        shards = lambda f, per: torch.stack([  # noqa: E731
            pack_bits(x, -(-n_loc // per)) for x in f.view(world, -1)])
        bits = _global_rows(shards(fr_s, 32), n_loc, 32, frontier_words(n))
        assert torch.equal(bits, pack_bits(fr_s, frontier_words(n)))
        inter = torch.stack([fr_s, fr_t], 1).view(world, -1)
        pairs = _global_rows(torch.stack([pack_bits(x, -(-n_loc // 16))
                                          for x in inter]),
                             n_loc, 16, 2 * frontier_words(n))
        assert torch.equal(pairs, pack_front(fr_s, fr_t, n))
