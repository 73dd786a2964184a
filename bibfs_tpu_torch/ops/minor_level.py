"""One lock-step level of the batch-minor search (modes ``minor`` and
``minor8``): B queries at once over ``[n_rows, B]`` planes, the queries on
the minor axis.

- :func:`minor_level` (CUDA ``minor_level_kernel<T>``,
  csrc/batch_minor.cu) replaces the XLA program
  ``bibfs_tpu/solvers/batch_minor.py::_level_scan``: int32 planes (mode
  ``minor``, the parent is the vertex id) or int8 planes (mode
  ``minor8``, the parent is the ELL slot, decoded later by the host).
- :func:`minor_level_plain` is its plain torch twin, the port of
  ``_level_scan`` chunked over ``tc`` rows as the reference is.

Both rewrite ``dist_s``, ``dist_t``, ``par_s`` and ``par_t`` in place and
return ``(dual_n, counts, key)``: the next dual frontier plane (bit 0 the
source side, bit 1 the target side), ``counts int32[3, B]`` (each side's
new frontier size and the edges scanned: the degrees of the old frontier
rows of both sides, times ``active``) and the meet vote ``key int64[B]``,
the least ``(dist_s + dist_t) << 32 | v`` over the rows both sides have
visited, or :data:`NO_MEET` (:func:`decode_meet` splits it). A claim takes
the lowest live slot of the row whose neighbour holds the side's bit,
which is the row's least ``slot * ks + nbr`` key of the reference.

The table is the one of all the port's kernels (``nbr_t int32[width,
n_tab]``, :func:`bibfs_tpu_torch.ops.pull_expand.sentinel_transposed_table`);
a row's live slots are its first ``min(deg, width)``, and plane rows past
the table's have none. A CUDA tensor launches the kernel or raises; a CPU
tensor runs the twin. :func:`minor_level` counts its launches per
instantiation in ``.launches``.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.ops import _cuda

INF32 = 1 << 30
INF8 = 127
NO_MEET = -1  # the empty meet key (all bits set) as an int64
LANES = 128  # the plane width is a multiple of this
_PLANES = {torch.int32: ("minor", INF32), torch.int8: ("minor8", INF8)}


def plane_inf(dtype: torch.dtype) -> int:
    """The unvisited distance of a plane type."""
    return _PLANES[dtype][1]


def decode_meet(key):
    """``(mval, midx)`` int32 of a meet key: ``(INF32, -1)`` where empty."""
    empty = key == NO_MEET
    mval = torch.where(empty, INF32, key >> 32).to(torch.int32)
    midx = torch.where(empty, -1, key & 0xFFFFFFFF).to(torch.int32)
    return mval, midx


def minor_level_plain(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t,
                      lvl: int, active, *, tc: int | None = None):
    """Plain twin of :func:`minor_level`: the reference's chunk scan, ``tc``
    plane rows a step (the whole plane when None)."""
    n_rows, b = dual.shape
    pdt = dual.dtype
    inf = plane_inf(pdt)
    width, n_tab = nbr_t.shape
    tc = n_rows if tc is None else tc
    dev = dual.device
    dual_n = torch.empty_like(dual)
    counts = torch.zeros(3, b, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int64).max
    key = torch.full((b,), big, dtype=torch.int64, device=dev)
    act = active.to(torch.bool)[None, :]
    slot_par = pdt == torch.int8
    slots = torch.arange(width, device=dev, dtype=torch.int32)[:, None, None]
    for r0 in range(0, n_rows, tc):
        r1 = min(r0 + tc, n_rows)
        t1 = min(r1, n_tab)
        nbr_c = torch.full((width, r1 - r0), n_tab, dtype=torch.int32, device=dev)
        deg_c = torch.zeros(r1 - r0, dtype=torch.int32, device=dev)
        if t1 > r0:
            nbr_c[:, : t1 - r0] = nbr_t[:, r0:t1]
            deg_c[: t1 - r0] = deg[r0:t1]
        live = slots[:, :, 0] < deg_c[None, :]  # [width, tc]
        # THE gather: one B-wide frontier row per live (slot, vertex)
        idx = torch.where(live, nbr_c, 0).long()
        vals = torch.where(live[:, :, None], dual[idx], 0)
        dual_c = dual[r0:r1]
        rows = torch.arange(r0, r1, device=dev, dtype=torch.int64)[:, None]
        nf = []
        for bit, d_p, p_p in ((0, dist_s, par_s), (1, dist_t, par_t)):
            hit = ((vals >> bit) & 1) > 0
            first = torch.where(hit, slots, width).amin(dim=0)  # [tc, b]
            d_c, p_c = d_p[r0:r1], p_p[r0:r1]
            claim = (first < width) & (d_c >= inf) & act
            if slot_par:
                psel = first.to(pdt)
            else:
                psel = nbr_c.T.gather(1, first.clamp(0, width - 1).long())
            d_c.copy_(torch.where(claim, lvl, d_c))
            p_c.copy_(torch.where(claim, psel.to(pdt), p_c))
            nf.append(claim)
            # scanned edges: this side's OLD frontier rows, times active
            fr_old = ((dual_c >> bit) & 1).to(torch.int32)
            counts[2] += (fr_old * deg_c[:, None]).sum(0, dtype=torch.int32) \
                * active.to(torch.int32)
            counts[bit] += claim.sum(0, dtype=torch.int32)
        dual_n[r0:r1] = (nf[0].to(pdt) | (nf[1].to(pdt) << 1))
        # the meet vote on the updated planes, in int32
        ds2, dt2 = dist_s[r0:r1], dist_t[r0:r1]
        both = (ds2 < inf) & (dt2 < inf)
        sums = ds2.to(torch.int64) + dt2.to(torch.int64)
        k = torch.where(both, (sums << 32) | rows, big)
        key = torch.minimum(key, k.amin(dim=0))
    return dual_n, counts, torch.where(key == big, NO_MEET, key)


def check_minor(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t, active,
                lvl: int) -> None:
    """Validate one launch's inputs on the card (shapes, dtypes, one
    device, contiguous); a search checks its planes once and then
    launches with ``checked=True``."""
    if nbr_t.dtype != torch.int32 or nbr_t.dim() != 2:
        raise ValueError("nbr_t must be a 2-D int32 table")
    if dual.dtype not in _PLANES:
        raise ValueError(f"planes must be int32 or int8, got {dual.dtype}")
    n_rows, b = dual.shape
    width, n_tab = nbr_t.shape
    if b % LANES or n_rows < n_tab or deg.shape[0] < n_tab:
        raise ValueError("planes must be [n_rows >= table rows, B % 128 == 0]")
    if active.shape != (b,):
        raise ValueError("active must hold one entry per query")
    planes = dict(dual=dual, dist_s=dist_s, dist_t=dist_t, par_s=par_s,
                  par_t=par_t)
    if any(p.shape != dual.shape for p in planes.values()):
        raise ValueError("every plane must have the dual plane's shape")
    _cuda.check_dtype(dual.dtype, **planes)
    _cuda.check_dtype(torch.int32, deg=deg, active=active)
    if dual.dtype == torch.int8 and (width > 127 or not 0 < lvl < INF8):
        raise ValueError("int8 planes hold slots below 127 and levels below 127")
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, deg=deg, active=active, **planes)


def _launch(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t, lvl, active):
    n_rows, b = dual.shape
    dual_n = torch.empty_like(dual)
    # the kernel adds into both: zeroed counters and the empty meet key
    counts = torch.zeros(3, b, dtype=torch.int32, device=dual.device)
    key = torch.full((b,), NO_MEET, dtype=torch.int64, device=dual.device)
    _cuda.launch(
        "batch_minor", "bibfs_minor_level", dual.element_size(),
        nbr_t.data_ptr(), nbr_t.stride(0), nbr_t.shape[0], nbr_t.shape[1],
        deg.data_ptr(), n_rows, b, dual.data_ptr(), dual_n.data_ptr(),
        dist_s.data_ptr(), dist_t.data_ptr(), par_s.data_ptr(),
        par_t.data_ptr(), int(lvl), active.data_ptr(), counts.data_ptr(),
        key.data_ptr(),
    )
    return dual_n, counts, key


def minor_level(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t, lvl: int,
                active, *, tc: int | None = None, checked: bool = False):
    """One level over all queries; see the module docstring. ``tc`` is the
    twin's chunk (the kernel needs none); ``checked`` skips the
    validation (:func:`check_minor`)."""
    if not dual.is_cuda:
        return minor_level_plain(nbr_t, deg, dual, dist_s, dist_t, par_s,
                                 par_t, lvl, active, tc=tc)
    if not checked:
        check_minor(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t, active, lvl)
    out = _launch(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t, lvl, active)
    minor_level.launches[_PLANES[dual.dtype][0]] += 1
    return out


minor_level.launches = {"minor": 0, "minor8": 0}
