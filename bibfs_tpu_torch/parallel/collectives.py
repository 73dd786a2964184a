"""Collective helpers over a 1D mesh: the counterpart of
``bibfs_tpu/parallel/collectives.py``, over ``torch.distributed``.

| reference (``shard_map``)      | here (:class:`~.mesh.Mesh`)            |
|--------------------------------|----------------------------------------|
| ``psum`` / ``pmax``            | :func:`sum_allreduce` / :func:`max_allreduce` |
| ``pmin`` pair (value, then id) | :func:`global_min_and_argmin` (one MIN of a 64-bit key) |
| ``all_gather`` of packed words | :func:`all_gather_bits`, :func:`all_gather_bits_dual` |
| ``all_gather`` over axis ``r``  | :func:`all_gather_rows` (a 2D grid's row axis) |
| ``pmax`` over axis ``c``        | :func:`max_allreduce_cols` (a 2D grid's column axis) |
| ``ppermute`` by ``_transpose_perm`` | :func:`transpose_permute` (point-to-point sends) |

The frontier crosses the wire packed 32 vertices to a word, each shard's
``ceil(n_loc / 32)`` words in the bit order of
:mod:`bibfs_tpu_torch.ops.bitmap` (bit ``u & 31`` of word ``u >> 5``),
so a rank ships ``n_loc / 8`` bytes instead of ``n_loc`` bools; the
words are int32 here where the reference's are uint32, bit for bit the
same. :func:`gather_bitmap` and :func:`gather_pairs` return the gathered
frontier as the level kernels' rows (a bitmap, a pair row) over the
global id space.

The transport (NCCL across cards, gloo on the CPU, gloo through pinned
host buffers for ranks sharing a card) is the mesh's; these helpers do
not see it.
"""

from __future__ import annotations

import numpy as np
import torch

from bibfs_tpu_torch.ops import bitmap

PACK_W = 32  # vertices per packed word


def sum_allreduce(x, mesh) -> torch.Tensor:
    """Sum across the mesh."""
    return mesh.all_reduce(x, "sum")


def max_allreduce(x, mesh) -> torch.Tensor:
    """Max across the mesh."""
    return mesh.all_reduce(x, "max")


def pack_bits(fr) -> torch.Tensor:
    """``bool[m]`` as ``int32[ceil(m / 32)]`` little-endian words."""
    return bitmap.pack_bits(fr, -(-fr.shape[0] // PACK_W))


def unpack_bits(words, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: the first ``m`` bits as ``bool[m]``."""
    return bitmap.unpack_bits(words, m)


def _unpack_shard_words(words, n_loc: int) -> torch.Tensor:
    """``int32[ndev, ..., nw]`` -> ``bool[ndev, ..., n_loc]``: each
    shard's words unpacked and its pad-to-word gap stripped (``n_loc``
    need not be a multiple of 32)."""
    shifts = torch.arange(PACK_W, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n_loc] > 0


def all_gather_bits(fr, mesh) -> torch.Tensor:
    """Each rank's ``bool[n_loc]`` packed, one all-gather of the words,
    unpacked on every rank: the global ``bool[size * n_loc]``."""
    allw = mesh.all_gather(pack_bits(fr))  # [ndev, nw]
    return _unpack_shard_words(allw, fr.shape[0]).reshape(-1)


def all_gather_bits_dual(fr_s, fr_t, mesh) -> torch.Tensor:
    """Both sides' packed frontiers in one all-gather (a ``[2, nw]``
    payload per rank): the global dual code ``uint8[n]`` (bit 0 the
    source side, bit 1 the target side), as
    :func:`bibfs_tpu_torch.ops.expand.pack_dual` codes it."""
    planes = torch.stack([pack_bits(fr_s), pack_bits(fr_t)])
    bits = _unpack_shard_words(mesh.all_gather(planes), fr_s.shape[0])
    code = bits[:, 0, :].to(torch.uint8) | (bits[:, 1, :].to(torch.uint8) << 1)
    return code.reshape(-1)


def _global_rows(allw, n_loc: int, per_word: int, out_words: int):
    """The gathered shard rows ``int32[ndev, ..., nw]`` (``per_word``
    vertices a word, each shard's row starting at a word) as rows of
    ``out_words`` words over the concatenated vertices, ``int32[...,
    out_words]``. Where ``n_loc`` fills whole words the shard rows only
    concatenate; otherwise each shard's bits are unpacked, stripped and
    packed again."""
    ndev, nw = allw.shape[0], allw.shape[-1]
    lead = allw.shape[1:-1]
    rows = allw.reshape(ndev, -1, nw).transpose(0, 1)  # [k, ndev, nw]
    if n_loc % per_word == 0:
        out = allw.new_zeros((rows.shape[0], out_words))
        out[:, : ndev * nw] = rows.reshape(rows.shape[0], -1)
    else:
        bits = _unpack_shard_words(rows, n_loc * (PACK_W // per_word))
        out = torch.stack([bitmap.pack_bits(b.reshape(-1), out_words)
                           for b in bits])
    return out.reshape(*lead, out_words)


def gather_bitmap(words, n_loc: int, mesh, id_space: int) -> torch.Tensor:
    """All ranks' local bitmaps (``words``: ``int32[..., ceil(n_loc /
    32)]``, one row per leading index) gathered in one all-gather as
    bitmap rows over ``id_space = size * n_loc`` vertices,
    ``int32[..., frontier_words(id_space)]``: kernel 1's and kernel 4's
    frontier."""
    return _global_rows(mesh.all_gather(words), n_loc, 32,
                        bitmap.frontier_words(id_space))


def gather_pairs(words, n_loc: int, mesh, id_space: int) -> torch.Tensor:
    """All ranks' local pair rows (``words``: ``ceil(n_loc / 16)`` words
    each, bits ``2 (u & 15)`` and ``2 (u & 15) + 1`` the source and target
    side) gathered as one pair row over ``id_space`` vertices: kernel
    3's frontier."""
    return _global_rows(mesh.all_gather(words), n_loc, 16,
                        2 * bitmap.frontier_words(id_space))


def frontier_exchange_bytes(n_loc: int, packed: bool = True) -> int:
    """Wire bytes a rank sends for one frontier exchange: packed words,
    or one bool per vertex."""
    return (-(-n_loc // PACK_W)) * 4 if packed else n_loc


def global_min_and_argmin(local_min, local_arg, mesh):
    """Global ``(min value, arg at the min)`` across ranks; ``local_arg``
    must be a GLOBAL id. Ties go to the smallest arg among the ranks at
    the min, as the reference's two ``pmin``. Here one MIN over the int64
    key ``value * 2^32 + (arg + 2^31)`` orders (value, arg) the same way
    for any int32 pair."""
    key = (local_min.to(torch.int64) << 32) + (local_arg.to(torch.int64) + 2**31)
    g = mesh.all_reduce(key, "min")
    return (g >> 32).to(torch.int32), ((g & 0xFFFFFFFF) - 2**31).to(torch.int32)


def all_gather_rows(words, grid) -> torch.Tensor:
    """The packed words of every rank on this rank's row axis of a 2D grid
    (:class:`~.mesh.Mesh2D`; the ranks of its column), stacked in row
    order: ``[R, *words.shape]``. A rank ships ``words`` once."""
    return grid.row_axis.all_gather(words)


def max_allreduce_cols(x, grid) -> torch.Tensor:
    """Max across this rank's column axis of a 2D grid (the ranks of its
    row)."""
    return grid.col_axis.all_reduce(x, "max")


def transpose_perm(R: int, C: int) -> tuple:
    """The reference's fixed ``ppermute`` pairs (``sharded2d.
    _transpose_perm``): fold slice ``s = r C + c`` moves to the rank whose
    column gather needs it, grid ``(s % R, s // R)``, linear ``(s % R) C +
    s // R``."""
    return tuple((s, (s % R) * C + s // R) for s in range(R * C))


def transpose_permute(words, grid) -> torch.Tensor:
    """The 2D search's transpose: this rank's packed owned slice sent to
    its :func:`transpose_perm` target over the whole grid, point to point
    (each rank ships its ``words`` once and receives one slice)."""
    return grid.world.permute(words, transpose_perm(grid.R, grid.C))


def on_shards(mesh, calls: list) -> list:
    """Run collectives of this module on host arrays split across the
    mesh (a rank body for :func:`~.mesh.launch`): each call is ``(name,
    *arrays)``, every array split along its first axis into ``size``
    equal shards, rank ``r`` passing its shard ``r`` (as a tensor on its
    device) to ``name(*shards, mesh)``. Returns each call's value on this
    rank, tensors as numpy arrays."""
    out = []
    for name, *arrays in calls:
        shards = [torch.as_tensor(np.split(a, mesh.size)[mesh.rank]
                                  ).to(mesh.device) for a in arrays]
        val = globals()[name](*shards, mesh)
        vals = val if isinstance(val, tuple) else (val,)
        out.append(tuple(v.cpu().numpy() for v in vals))
    return out
