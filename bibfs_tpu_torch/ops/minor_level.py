"""One lock-step level of the batch-minor search (modes ``minor`` and
``minor8``): B queries at once over ``[n_rows, B]`` planes, the queries on
the minor axis.

The search state is packed as pair rows (``[n_rows, B / 16]`` int32
words, the pair-row order of :mod:`bibfs_tpu_torch.ops.bitmap`: bit
``2 (q & 15)`` of word ``q >> 4`` holds query ``q`` on the source side,
bit ``2 (q & 15) + 1`` on the target side): ``front``, the frontier, and
``vis``, the visited set (bit set where ``dist < inf``). The distance and parent
planes stay ``[n_rows, B]`` of the plane type. :func:`pack_front`,
:func:`unpack_front`, :func:`pack_vis` and :func:`unpack_sides` convert.

- :func:`minor_level` (CUDA ``minor_level_kernel<T>``,
  csrc/batch_minor.cu) replaces the XLA program
  ``bibfs_tpu/solvers/batch_minor.py::_level_scan``: int32 planes (mode
  ``minor``, the parent is the vertex id) or int8 planes (mode
  ``minor8``, the parent is the ELL slot, decoded later by the host).
- :func:`minor_level_packed_plain` is its plain torch twin: unpack, run
  :func:`minor_level_plain`, pack.
- :func:`minor_level_plain` is the port of ``_level_scan`` on the
  unpacked ``dual`` plane (bit 0 the source side, bit 1 the target side),
  chunked over ``tc`` rows as the reference is.

:func:`minor_level_plain` rewrites ``dist_s``, ``dist_t``, ``par_s`` and
``par_t`` in place and returns ``(dual_n, counts, key)``: the next dual
frontier plane, ``counts int32[3, B]`` (each side's new frontier size and
the edges scanned: the degrees of the old frontier rows of both sides,
times ``active``) and the meet vote ``key int64[B]``, the least
``(dist_s + dist_t) << 32 | v`` over the rows both sides have visited, or
:data:`NO_MEET` (:func:`decode_meet` splits it). A claim takes the lowest
live slot of the row whose neighbour holds the side's bit, which is the
row's least ``slot * ks + nbr`` key of the reference.

The packed level also updates ``vis`` in place, returns the packed
``front_n`` in place of ``dual_n``, and takes the previous level's key:
a distance never changes once set, so this level's full vote is the
previous one min-folded (:func:`fold_keys`) with the votes of the
(row, query) pairs claimed now. Given the full vote of its input state
(:func:`meet_vote`), it returns the full vote of its output state.

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
from bibfs_tpu_torch.ops.bitmap import pack_lanes, unpack_lanes

INF32 = 1 << 30
INF8 = 127
NO_MEET = -1  # the empty meet key (all bits set) as an int64
LANES = 128  # the plane width is a multiple of this
_PLANES = {torch.int32: ("minor", INF32), torch.int8: ("minor8", INF8)}
_BIG = torch.iinfo(torch.int64).max


def plane_inf(dtype: torch.dtype) -> int:
    """The unvisited distance of a plane type."""
    return _PLANES[dtype][1]


def decode_meet(key):
    """``(mval, midx)`` int32 of a meet key: ``(INF32, -1)`` where empty."""
    empty = key == NO_MEET
    mval = torch.where(empty, INF32, key >> 32).to(torch.int32)
    midx = torch.where(empty, -1, key & 0xFFFFFFFF).to(torch.int32)
    return mval, midx


def fold_keys(a, b):
    """The lesser of two meet keys per query, :data:`NO_MEET` the greatest."""
    m = torch.minimum(torch.where(a == NO_MEET, _BIG, a),
                      torch.where(b == NO_MEET, _BIG, b))
    return torch.where(m == _BIG, NO_MEET, m)


def meet_vote(dist_s, dist_t):
    """The full meet vote of two distance planes: per query the least
    ``(dist_s + dist_t) << 32 | v`` over the rows both sides have visited,
    else :data:`NO_MEET`."""
    inf = plane_inf(dist_s.dtype)
    both = (dist_s < inf) & (dist_t < inf)
    sums = dist_s.to(torch.int64) + dist_t.to(torch.int64)
    rows = torch.arange(dist_s.shape[0], device=dist_s.device,
                        dtype=torch.int64)[:, None]
    k = torch.where(both, (sums << 32) | rows, _BIG).amin(dim=0)
    return torch.where(k == _BIG, NO_MEET, k)


def pack_sides(side_s, side_t) -> torch.Tensor:
    """Two ``bool[n, B]`` planes as pair rows, ``int32[n, B / 16]``."""
    n, b = side_s.shape
    return pack_lanes(torch.stack([side_s, side_t], dim=2).view(n, 2 * b))


def unpack_sides(words) -> tuple[torch.Tensor, torch.Tensor]:
    """Each side's ``bool[n, B]`` of pair rows (``vis`` or ``front``)."""
    n, w = words.shape
    both = unpack_lanes(words).view(n, 16 * w, 2)
    return both[:, :, 0], both[:, :, 1]


def pack_vis(dist_s, dist_t) -> torch.Tensor:
    """The visited words of two distance planes (bit set below inf)."""
    inf = plane_inf(dist_s.dtype)
    return pack_sides(dist_s < inf, dist_t < inf)


def pack_front(dual) -> torch.Tensor:
    """A dual frontier plane (bit 0 source, bit 1 target) as packed words."""
    return pack_sides((dual & 1) > 0, (dual & 2) > 0)


def unpack_front(front, dtype: torch.dtype) -> torch.Tensor:
    """The dual frontier plane of type ``dtype`` of packed words."""
    fs, ft = unpack_sides(front)
    return fs.to(dtype) | (ft.to(dtype) << 1)


def minor_level_plain(nbr_t, deg, dual, dist_s, dist_t, par_s, par_t,
                      lvl: int, active, *, tc: int | None = None):
    """The reference's level on the unpacked ``dual`` plane: its chunk scan,
    ``tc`` plane rows a step (the whole plane when None)."""
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


def minor_level_packed_plain(nbr_t, deg, front, vis, dist_s, dist_t, par_s,
                             par_t, lvl: int, active, key, *,
                             tc: int | None = None):
    """Plain twin of :func:`minor_level`: :func:`minor_level_plain` on the
    unpacked frontier, then the outputs packed, ``vis`` rebuilt from the
    updated distance planes and the vote folded into ``key``."""
    dual = unpack_front(front, dist_s.dtype)
    dual_n, counts, k = minor_level_plain(nbr_t, deg, dual, dist_s, dist_t,
                                          par_s, par_t, lvl, active, tc=tc)
    vis.copy_(pack_vis(dist_s, dist_t))
    return pack_front(dual_n), counts, fold_keys(key, k)


def check_minor(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t, active,
                key, lvl: int) -> None:
    """Validate one launch's inputs on the card (shapes, dtypes, one
    device, contiguous); a search checks its planes once and then
    launches with ``checked=True``."""
    if nbr_t.dtype != torch.int32 or nbr_t.dim() != 2:
        raise ValueError("nbr_t must be a 2-D int32 table")
    if dist_s.dtype not in _PLANES:
        raise ValueError(f"planes must be int32 or int8, got {dist_s.dtype}")
    n_rows, b = dist_s.shape
    width, n_tab = nbr_t.shape
    if b % LANES or n_rows < n_tab or deg.shape[0] < n_tab:
        raise ValueError("planes must be [n_rows >= table rows, B % 128 == 0]")
    if active.shape != (b,) or key.shape != (b,):
        raise ValueError("active and key must hold one entry per query")
    planes = dict(dist_s=dist_s, dist_t=dist_t, par_s=par_s, par_t=par_t)
    if any(p.shape != dist_s.shape for p in planes.values()):
        raise ValueError("every plane must have dist_s's shape")
    if front.shape != (n_rows, b // 16) or vis.shape != front.shape:
        raise ValueError("front and vis must be [n_rows, B / 16] pair rows")
    _cuda.check_dtype(dist_s.dtype, **planes)
    _cuda.check_dtype(torch.int32, deg=deg, active=active, front=front, vis=vis)
    _cuda.check_dtype(torch.int64, key=key)
    if dist_s.dtype == torch.int8 and (width > 127 or not 0 < lvl < INF8):
        raise ValueError("int8 planes hold slots below 127 and levels below 127")
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, deg=deg, active=active,
                     front=front, vis=vis, key=key, **planes)


def _launch(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t, lvl, active,
            key):
    n_rows, b = dist_s.shape
    front_n = torch.empty_like(front)
    # the kernel adds into zeroed counters and min-folds into the key
    counts = torch.zeros(3, b, dtype=torch.int32, device=front.device)
    key_n = key.clone()
    _cuda.launch(
        "batch_minor", "bibfs_minor_level", dist_s.element_size(),
        nbr_t.data_ptr(), nbr_t.stride(0), nbr_t.shape[0], nbr_t.shape[1],
        deg.data_ptr(), n_rows, b, front.data_ptr(), front_n.data_ptr(),
        vis.data_ptr(), dist_s.data_ptr(), dist_t.data_ptr(), par_s.data_ptr(),
        par_t.data_ptr(), int(lvl), active.data_ptr(), counts.data_ptr(),
        key_n.data_ptr(),
    )
    return front_n, counts, key_n


def minor_level(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t,
                lvl: int, active, key, *, tc: int | None = None,
                checked: bool = False):
    """One level over all queries on the packed state; see the module
    docstring. Returns ``(front_n, counts, key_n)`` and updates ``vis``
    and the distance and parent planes in place. ``tc`` is the twin's
    chunk (the kernel needs none); ``checked`` skips the validation
    (:func:`check_minor`)."""
    if not front.is_cuda:
        return minor_level_packed_plain(nbr_t, deg, front, vis, dist_s, dist_t,
                                        par_s, par_t, lvl, active, key, tc=tc)
    if not checked:
        check_minor(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t,
                    active, key, lvl)
    out = _launch(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t, lvl,
                  active, key)
    _cuda.count_launch(minor_level, _PLANES[dist_s.dtype][0])
    return out


minor_level.launches = {"minor": 0, "minor8": 0}
