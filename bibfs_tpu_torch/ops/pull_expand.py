"""Pull expansion of one level over the slot-major sentinel table: kernels
3 and 4 of the dense search (modes ``pallas`` and ``pallas_alt``).

- :func:`pull_dual` (CUDA ``pull_dual_kernel``, csrc/pull_expand.cu)
  replaces ``bibfs_tpu/ops/pallas_expand.py::_pull_kernel_dual``: both
  sides' next frontier and parent from one dual-coded frontier row.
- :func:`pull_single` (CUDA ``pull_kernel``) replaces ``_pull_kernel``:
  the single-side form.

The table is the TPU kernels' slot-major table without their padding:
``nbr_t int32[width, n_rows]``, dead slots holding the sentinel id
``n_rows`` (:func:`sentinel_transposed_table`). The dist update, the
hub tiers and the max degree stay outside the kernel, as plain torch
(:func:`pallas_pull_level`, :func:`pallas_pull_level_dual`).

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain torch twin (``*_plain``) for CPU tensors. The raw parent output
is the first-hit-slot neighbour where the new-frontier output is set and
-1 everywhere else. Each wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops.expand import (
    apply_tiers,
    apply_tiers_dual,
    max_new_degree,
    pack_dual,
)


def sentinel_transposed_table(nbr, deg):
    """The table of all four kernels: the ``[n_rows, width]`` ELL table
    with its dead slots masked to the sentinel id ``n_rows`` (whose
    frontier value reads 0), transposed to slot-major ``int32[width,
    n_rows]``. The CUDA kernels take any row count and width, so nothing is
    padded."""
    n_rows, width = nbr.shape
    mask = torch.arange(width, device=nbr.device)[None, :] < deg[:, None]
    return torch.where(mask, nbr.to(torch.int32), n_rows).T.contiguous()


def prepare_pallas_tables(nbr, deg) -> tuple:
    """The pull kernels' table as a one-element tuple ``(nbr_t,)``
    (:func:`sentinel_transposed_table`)."""
    return (sentinel_transposed_table(nbr, deg),)


def gather_bits(front, nbr_t, n_rows: int):
    """Plain lookup ``front[nbr_t[:, :n_rows]]`` as uint8 ``[width, n_rows]``;
    a sentinel id (``>= len(front)``) reads 0."""
    ext = torch.cat([front.to(torch.uint8), front.new_zeros(1, dtype=torch.uint8)])
    idx = nbr_t[:, :n_rows].long().clamp(0, front.shape[0])
    return ext[idx]


def claim_plain(hit, rows, unvisited):
    """Plain first-hit-slot claim: ``hit bool[width, n]`` over the table rows
    ``rows int32[width, n]``. Returns ``(nf bool[n], parent int32[n])`` with
    parent -1 where ``nf`` is unset."""
    wp = hit.shape[0]
    slots = torch.arange(wp, device=hit.device)[:, None]
    j = torch.where(hit, slots, wp).min(dim=0).values
    nf = (j < wp) & unvisited
    parent = rows.gather(0, j.clamp(max=wp - 1)[None, :])[0]
    return nf, torch.where(nf, parent, -1)


def _check_table(nbr_t):
    if nbr_t.dtype != torch.int32 or nbr_t.dim() != 2:
        raise ValueError("nbr_t must be a 2-D int32 table")


def pull_single_plain(nbr_t, frontier, visited):
    """Plain twin of :func:`pull_single`."""
    n_rows = visited.shape[0]
    hit = gather_bits(frontier, nbr_t, n_rows) > 0
    return claim_plain(hit, nbr_t[:, :n_rows], ~visited)


def pull_single(nbr_t, frontier, visited):
    """One side's ``(next_frontier bool[n_rows], parent int32[n_rows])``
    for ``n_rows = len(visited)`` table rows; ``frontier bool`` is indexed
    by the table's ids."""
    _check_table(nbr_t)
    if not nbr_t.is_cuda:
        return pull_single_plain(nbr_t, frontier, visited)
    n_rows = visited.shape[0]
    if n_rows > nbr_t.shape[1]:
        raise ValueError("visited has more rows than the table")
    front = frontier.to(torch.bool).contiguous()
    vis = visited.to(torch.bool).contiguous()
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, frontier=front, visited=vis)
    nf = torch.empty(n_rows, dtype=torch.bool, device=nbr_t.device)
    pc = torch.empty(n_rows, dtype=torch.int32, device=nbr_t.device)
    _cuda.launch(
        "pull_expand", "bibfs_pull", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, front.data_ptr(), front.shape[0],
        vis.data_ptr(), nf.data_ptr(), pc.data_ptr(),
    )
    pull_single.launches += 1
    return nf, pc


pull_single.launches = 0


def pull_dual_plain(nbr_t, dual, vis_s, vis_t):
    """Plain twin of :func:`pull_dual`."""
    n_rows = vis_s.shape[0]
    vals = gather_bits(dual, nbr_t, n_rows)
    rows = nbr_t[:, :n_rows]
    nf_s, pc_s = claim_plain((vals & 1) > 0, rows, ~vis_s)
    nf_t, pc_t = claim_plain((vals & 2) > 0, rows, ~vis_t)
    return nf_s, pc_s, nf_t, pc_t


def pull_dual(nbr_t, dual, vis_s, vis_t):
    """Both sides' ``(nf_s, pc_s, nf_t, pc_t)`` from one dual-coded uint8
    frontier row (:func:`bibfs_tpu_torch.ops.expand.pack_dual`)."""
    _check_table(nbr_t)
    if not nbr_t.is_cuda:
        return pull_dual_plain(nbr_t, dual, vis_s, vis_t)
    n_rows = vis_s.shape[0]
    if n_rows > nbr_t.shape[1] or vis_t.shape[0] != n_rows:
        raise ValueError("visited rows must match and fit the table")
    if dual.dtype != torch.uint8:
        raise ValueError("dual must be uint8 (pack_dual)")
    vs = vis_s.to(torch.bool).contiguous()
    vt = vis_t.to(torch.bool).contiguous()
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, dual=dual, vis_s=vs, vis_t=vt)
    dev = nbr_t.device
    nf_s = torch.empty(n_rows, dtype=torch.bool, device=dev)
    nf_t = torch.empty(n_rows, dtype=torch.bool, device=dev)
    pc_s = torch.empty(n_rows, dtype=torch.int32, device=dev)
    pc_t = torch.empty(n_rows, dtype=torch.int32, device=dev)
    _cuda.launch(
        "pull_expand", "bibfs_pull_dual", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, dual.data_ptr(), dual.shape[0],
        vs.data_ptr(), vt.data_ptr(), nf_s.data_ptr(), pc_s.data_ptr(),
        nf_t.data_ptr(), pc_t.data_ptr(),
    )
    pull_dual.launches += 1
    return nf_s, pc_s, nf_t, pc_t


pull_dual.launches = 0


def run_pull(tables: tuple, frontier, visited):
    """Single-side raw kernel pass: ``(next_frontier, parent_candidate)``
    over the table's rows ``[0, len(visited))``."""
    (nbr_t,) = tables
    return pull_single(nbr_t, frontier, visited)


def run_pull_dual(tables: tuple, fr_s, fr_t, vis_s, vis_t):
    """Both sides' raw kernel pass: ``(nf_s, pc_s, nf_t, pc_t)``; one
    dual-coded frontier row serves both sides."""
    (nbr_t,) = tables
    return pull_dual(nbr_t, pack_dual(fr_s, fr_t).contiguous(), vis_s, vis_t)


def pallas_pull_level_dual(
    fr_s, fr_t, par_s, dist_s, par_t, dist_t, tables, deg, tiers, lvl_s,
    lvl_t, *, inf: int,
):
    """Both sides of a lock-step round through the dual kernel, with the
    return contract of ``expand_pull_dual_tiered``: ``(nf_s, par_s, dist_s,
    md_s, nf_t, par_t, dist_t, md_t)``. Hub tiers run as torch ops around
    the kernel through the same ``apply_tiers_dual``."""
    n_pad = par_s.shape[0]
    vis_s = dist_s < inf
    vis_t = dist_t < inf
    nf_s, pc_s, nf_t, pc_t = run_pull_dual(tables, fr_s, fr_t, vis_s, vis_t)
    par_s = torch.where(nf_s, pc_s, par_s)
    par_t = torch.where(nf_t, pc_t, par_t)
    if tiers:
        nf_s, par_s, nf_t, par_t = apply_tiers_dual(
            nf_s, par_s, nf_t, par_t, pack_dual(fr_s, fr_t),
            vis_s, vis_t, deg, tiers, n_pad,
        )
    dist_s = torch.where(nf_s & ~vis_s, lvl_s, dist_s)
    dist_t = torch.where(nf_t & ~vis_t, lvl_t, dist_t)
    return (nf_s, par_s, dist_s, max_new_degree(nf_s, deg),
            nf_t, par_t, dist_t, max_new_degree(nf_t, deg))


def pallas_pull_level(frontier, par, dist, tables, deg, tiers, lvl_next, *, inf: int):
    """One side's pull level through the single kernel, with the return
    contract of ``expand_pull_tiered``: ``(next_frontier, par, dist,
    max_deg_of_new_frontier)``."""
    n_pad = par.shape[0]
    visited = dist < inf
    nf, pcand = run_pull(tables, frontier, visited)
    par = torch.where(nf, pcand, par)
    nf, par = apply_tiers(nf, par, frontier, visited, deg, tiers, n_pad)
    dist = torch.where(nf & (dist >= inf), lvl_next, dist)
    return nf, par, dist, max_new_degree(nf, deg)
