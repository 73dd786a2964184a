"""Blocked (tiled) adjacency: the counterpart of
``bibfs_tpu/graph/blocked.py``.

A BFS level's frontier expansion ``next[u] = OR_v A[u, v] AND F[v]`` is a
boolean matrix-vector product, and a batched level over B queries a
boolean matrix-matrix product ``A @ F`` with ``F`` the ``[n, 2B]``
frontier plane. Tiled into dense ``128 x 128`` int8 blocks it is the
workload of the card's int8 tensor cores
(:mod:`bibfs_tpu_torch.ops.blocked_expand`). The trade is arithmetic for
locality: a vertex scans ``tile`` candidate neighbours per stored block
instead of ``width`` ELL slots, so the layout wins on dense-ish and
banded (grid) graphs whose nonempty tiles are few; the serving route
(:mod:`bibfs_tpu_torch.serve.routes.blocked`) owns that decision.

Layout (block-sparse, only nonempty tiles stored), the JAX package's:

- the vertex space is padded to ``tile`` (128) and cut into ``nblocks``
  tile rows and tile columns;
- a tile ``(bi, bj)`` is nonempty when some edge ``(u, v)`` has
  ``u // tile == bi`` and ``v // tile == bj`` (the pairs are mirrored, so
  the tile structure is symmetric);
- nonempty tiles are packed per block row: ``bcol[bi, k]`` is the k-th
  nonempty tile's block column (sentinel ``nblocks`` past the row's
  count) and ``tab[bi, k]`` its dense int8 0/1 adjacency.

``bwidth`` is the most nonempty tiles of any block row, so the table is
one ``[nblocks, bwidth, tile, tile]`` array. The weighted tile table
(``build_blocked_weights``) comes with the query kinds (ROADMAP Queue 1,
item 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bibfs_tpu_torch.graph.csr import canonical_pairs

#: the tile edge: 128 rows of int8 are the tensor-core kernel's M and K
TILE = 128


@dataclasses.dataclass
class BlockedGraph:
    """Host-side blocked adjacency (module docstring).

    - ``tab``: int8 ``[nblocks, bwidth, tile, tile]``: slot k of block row
      bi is the dense adjacency tile against block column ``bcol[bi, k]``
      (all zero for sentinel slots).
    - ``bcol``: int32 ``[nblocks, bwidth]`` block columns, sentinel
      ``nblocks`` for dead slots.
    - ``deg``: int32 ``[n_pad]`` true degrees (edge-scan accounting).
    """

    n: int
    n_pad: int
    tile: int
    nblocks: int
    bwidth: int
    num_edges: int  # undirected unique edge count
    nnz_blocks: int  # nonempty tiles stored
    tab: np.ndarray
    bcol: np.ndarray
    deg: np.ndarray

    @property
    def tab_bytes(self) -> int:
        return int(self.tab.nbytes)

    @property
    def block_density(self) -> float:
        """Fraction of the full block grid stored."""
        return self.nnz_blocks / float(self.nblocks * self.nblocks or 1)


def _tile_grid(n: int, tile: int) -> tuple[int, int]:
    """``(n_pad, nblocks)`` of the tile grid: the one place the padding
    formula lives, so the build, the meta precheck and the serving
    eligibility gate agree on the grid."""
    tile = int(tile)
    n_pad = max(tile, -(-int(n) // tile) * tile)
    return n_pad, n_pad // tile


def blocked_meta(n: int, pairs: np.ndarray, *,
                 tile: int = TILE) -> tuple[int, int, int]:
    """``(nblocks, bwidth, nnz_blocks)`` of the tiling without building the
    table: one sorted pass over the canonical pairs, on the grid math of
    :func:`build_blocked`."""
    tile = int(tile)
    _n_pad, nblocks = _tile_grid(n, tile)
    if pairs is None or not pairs.size:
        return nblocks, 1, 0
    keys = np.unique((pairs[:, 0] // tile) * nblocks + pairs[:, 1] // tile)
    counts = np.bincount(keys // nblocks, minlength=nblocks)
    return nblocks, max(1, int(counts.max())), int(keys.size)


def build_blocked(
    n: int,
    edges: np.ndarray | None = None,
    *,
    pairs: np.ndarray | None = None,
    tile: int = TILE,
) -> BlockedGraph:
    """Tile the canonical pairs into a :class:`BlockedGraph`: one sort over
    the pairs' (block row, block column) keys gives the nonempty tiles,
    each tile's slot in its row and the scatter into ``tab``."""
    if pairs is None:
        pairs = canonical_pairs(n, edges)
    tile = int(tile)
    n_pad, nblocks = _tile_grid(n, tile)
    deg = np.zeros(n_pad, dtype=np.int32)
    if pairs.size:
        deg[:n] = np.bincount(pairs[:, 0], minlength=n)
    if not pairs.size:
        return BlockedGraph(
            n=int(n), n_pad=n_pad, tile=tile, nblocks=nblocks, bwidth=1,
            num_edges=0, nnz_blocks=0,
            tab=np.zeros((nblocks, 1, tile, tile), dtype=np.int8),
            bcol=np.full((nblocks, 1), nblocks, dtype=np.int32),
            deg=deg,
        )
    br = pairs[:, 0] // tile
    bc = pairs[:, 1] // tile
    uniq, inv = np.unique(br * nblocks + bc, return_inverse=True)
    rows = (uniq // nblocks).astype(np.int64)
    cols = (uniq % nblocks).astype(np.int64)
    counts = np.bincount(rows, minlength=nblocks)
    bwidth = max(1, int(counts.max()))
    # each tile's slot in its block row (uniq is sorted: a row's tiles are
    # consecutive)
    row_start = np.zeros(nblocks + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(uniq.size) - row_start[rows]
    bcol = np.full((nblocks, bwidth), nblocks, dtype=np.int32)
    bcol[rows, slot] = cols
    tab = np.zeros((nblocks, bwidth, tile, tile), dtype=np.int8)
    tab[br, slot[inv], pairs[:, 0] % tile, pairs[:, 1] % tile] = 1
    return BlockedGraph(
        n=int(n), n_pad=n_pad, tile=tile, nblocks=nblocks, bwidth=bwidth,
        num_edges=int(pairs.shape[0]) // 2, nnz_blocks=int(uniq.size),
        tab=tab, bcol=bcol, deg=deg,
    )


def blocked_bucket_key(g: BlockedGraph) -> tuple:
    """The program-shape identity of a blocked table, distinct from the
    ``("ell", ...)`` keys; the route extends it with its placement
    (:func:`bibfs_tpu_torch.serve.buckets.placement_bucket_key`)."""
    return ("blocked", g.nblocks, g.bwidth, g.tile)
