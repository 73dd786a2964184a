"""Blocked frontier expansion, one BFS level as masked block products: the
counterpart of ``bibfs_tpu/ops/blocked_expand.py``.

The op is ``reach = A @ F > 0``, with ``A`` the block-sparse tiled
adjacency of :class:`bibfs_tpu_torch.graph.blocked.BlockedGraph` and ``F``
a frontier plane whose columns are both sides of every query of a batch
(source columns ``0..B-1``, target columns ``B..2B-1``), so one sweep of
the table advances every search. Products of 0/1 values are exact
(a count is at most ``bwidth * tile``), and ``> 0`` reads the OR.

- :func:`expand_blocked_plane` is the plain torch twin of the JAX
  package's function of the same name, on its ``[n_pad, C]`` plane:
  a gather of one ``[tile, C]`` frontier sub-plane per (block row, slot),
  then one batched product per chunk of ``rc`` block rows. It computes in
  float32 whatever the plane type (exact below 2^24; the card has no
  integer batched product).
- :func:`blocked_level` is one round of the blocked search, the
  expansion with the level body's masked stamp
  (``bibfs_tpu/solvers/dense.py:214-216``): on query-major planes
  (``plane [2B, n_pad]``, ``dist int32 [2B, n_pad]``) it stamps
  ``dist = lvl`` where ``reach & dist >= INF32 & live[c mod B]`` and
  returns that mask as the next plane. A CUDA tensor launches the
  hand-written kernel ``blocked_level_kernel``
  (``csrc/blocked_expand.cu``: int8 tensor-core products through
  ``mma.sync`` m16n8k32, one block per (column group, block row), the
  row's live tiles only) or raises; a CPU tensor runs
  :func:`blocked_level_plain`. Launches count in
  ``blocked_level.launches``.

The budgets and the fit rule are the JAX package's, so the serving route
takes the same (graph, batch) shapes in both packages.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.graph.blocked import TILE
from bibfs_tpu_torch.ops import _cuda

INF32 = 1 << 30

#: working-set budget of one expansion chunk: the gathered frontier block
#: ``[rc, bwidth, tile, C]`` at the plane type plus the ``[rc, tile, C]``
#: accumulator (the JAX package's figure)
BLOCKED_CHUNK_BUDGET_BYTES = 384 * 2**20

#: ceiling on the resident blocked table: past it the block structure is
#: not compact and the ELL routes carry the graph better
BLOCKED_TAB_BUDGET_BYTES = 256 * 2**20


def resolve_plane_dtype(dt=None, device=None) -> torch.dtype:
    """The frontier-plane type: int8 on a CUDA device (the tensor cores'
    input type), float32 on the CPU (its fast matrix product). ``dt``
    (``"int8"``, ``"float32"`` or a torch dtype) forces a choice."""
    if dt is not None:
        return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))
    dev = torch.device("cpu" if device is None else device)
    return torch.int8 if dev.type == "cuda" else torch.float32


def chunk_block_rows(bwidth: int, c: int, itemsize: int,
                     tile: int = TILE) -> int:
    """Block rows per expansion chunk under the working-set budget (at
    least 1)."""
    per_row = tile * c * (bwidth * itemsize + 4)
    return max(1, BLOCKED_CHUNK_BUDGET_BYTES // max(per_row, 1))


def blocked_fits(nblocks: int, bwidth: int, b: int,
                 itemsize: int = 4) -> bool:
    """Whether the blocked path takes this (graph, batch) shape: the int8
    table under its budget and the dual-plane state (frontier and dist at
    ``[n_pad, 2B]``) under the chunk budget."""
    tab_bytes = nblocks * bwidth * TILE * TILE  # int8 storage
    if tab_bytes > BLOCKED_TAB_BUDGET_BYTES:
        return False
    plane_bytes = nblocks * TILE * 2 * b * (itemsize + 4)
    return plane_bytes <= BLOCKED_CHUNK_BUDGET_BYTES


def expand_blocked_plane(fr, tab, bcol, *, rc: int):
    """One frontier-plane expansion ``(A @ fr) > 0``: ``fr`` is a 0/1
    ``[n_pad, C]`` plane, ``tab`` int8 ``[nblocks, bwidth, tile, tile]``,
    ``bcol`` int32 ``[nblocks, bwidth]`` with sentinel ``nblocks`` (it reads
    an appended zero tile). Returns bool ``[n_pad, C]``: every vertex with
    a frontier neighbour, discovered or not."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    c = fr.shape[1]
    f2 = fr.reshape(nblocks, tile, c).float()
    f2p = torch.cat([f2, f2.new_zeros(1, tile, c)], dim=0)
    outs = []
    for i0 in range(0, nblocks, rc):
        tab_c = tab[i0:i0 + rc].float()  # [r, bwidth, tile, tile]
        # one [tile, C] frontier sub-plane per (block row, slot), contracted
        # over (slot, in-tile column) against the tiles
        fr_c = f2p[bcol[i0:i0 + rc].long()]  # [r, bwidth, tile, C]
        r = tab_c.shape[0]
        a = tab_c.permute(0, 2, 1, 3).reshape(r, tile, bwidth * tile)
        outs.append(torch.bmm(a, fr_c.reshape(r, bwidth * tile, c)))
    return torch.cat(outs, dim=0).reshape(nblocks * tile, c) > 0


def blocked_level_plain(tab, bcol, plane, dist, live, lvl: int, *,
                        rc: int | None = None):
    """Plain twin of :func:`blocked_level`: the expansion of the transposed
    plane, then the masked stamp, in place on ``dist``."""
    nblocks = bcol.shape[0]
    if rc is None:
        rc = chunk_block_rows(bcol.shape[1], plane.shape[0],
                              plane.element_size())
    reach = expand_blocked_plane(plane.T, tab, bcol, rc=min(rc, nblocks)).T
    # live[c mod B] for each of the C = 2B columns
    new = reach & (dist >= INF32) & live.to(torch.bool).repeat(2)[:, None]
    dist.copy_(torch.where(new, lvl, dist))
    return new.to(plane.dtype)


def check_blocked(tab, bcol, plane, dist, live) -> None:
    """Validate one launch's inputs on the card (shapes, types, one
    device, contiguous); a search checks once and then launches with
    ``checked=True``."""
    if tab.dim() != 4 or tab.shape[2:] != (TILE, TILE) or bcol.dim() != 2:
        raise ValueError("tab must be [nblocks, bwidth, 128, 128] with "
                         "bcol [nblocks, bwidth]")
    nblocks, bwidth = bcol.shape
    if tab.shape[:2] != (nblocks, bwidth):
        raise ValueError("tab and bcol disagree on (nblocks, bwidth)")
    if not 0 < nblocks <= 65535:
        raise ValueError(f"{nblocks} block rows exceed the kernel's grid")
    c, n_pad = plane.shape
    if n_pad != nblocks * TILE or c % 2 or live.shape != (c // 2,):
        raise ValueError("plane must be [2B, nblocks * 128] with live [B]")
    if dist.shape != plane.shape:
        raise ValueError("dist must have the plane's shape")
    _cuda.check_dtype(torch.int8, tab=tab, plane=plane)
    _cuda.check_dtype(torch.int32, bcol=bcol, dist=dist, live=live)
    _cuda.check_cuda(tab.device, tab=tab, bcol=bcol, plane=plane, dist=dist,
                     live=live)


def blocked_level(tab, bcol, plane, dist, live, lvl: int, *,
                  rc: int | None = None, checked: bool = False):
    """One blocked round on query-major planes (module docstring): returns
    the next plane and stamps ``dist`` in place. ``rc`` is the twin's
    chunk (the kernel needs none); ``checked`` skips the validation
    (:func:`check_blocked`)."""
    if not plane.is_cuda:
        return blocked_level_plain(tab, bcol, plane, dist, live, lvl, rc=rc)
    if not checked:
        check_blocked(tab, bcol, plane, dist, live)
    c, n_pad = plane.shape
    nblocks, bwidth = bcol.shape
    plane_n = torch.empty_like(plane)  # the kernel writes every entry
    _cuda.launch(
        "blocked_expand", "bibfs_blocked_level",
        tab.data_ptr(), bcol.data_ptr(), nblocks, bwidth, plane.data_ptr(),
        plane_n.data_ptr(), dist.data_ptr(), n_pad, c, live.data_ptr(),
        int(lvl),
    )
    _cuda.count_launch(blocked_level)
    return plane_n


blocked_level.launches = 0
