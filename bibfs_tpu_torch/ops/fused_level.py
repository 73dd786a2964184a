"""One whole search round per kernel launch: kernels 1 and 2 of the dense
search (modes ``fused`` and ``fused_alt``), plus the one-thread fold.

- :func:`fused_dual_round` (CUDA ``fused_dual_kernel``,
  csrc/fused_level.cu) replaces
  ``bibfs_tpu/ops/pallas_fused.py::_fused_kernel``: a lock-step round for
  both sides, with every per-round reduction and the meet vote.
- :func:`fused_single_round` (CUDA ``fused_single_kernel``) replaces
  ``_fused_kernel_single``: an alt round for the smaller side, chosen on
  the device (``cnt_s <= cnt_t``).
- :func:`fold_round` (CUDA ``fold_round_kernel``) applies a round's
  reductions to the scalar state, as the JAX solver's scalar fixup does.

The search state never leaves the device: the scalar state is one int32
row (:data:`STATE_SLOTS`), the per-round reductions go to ``acc int32[6]``
and a 64-bit meet key ``int64[1]`` (``(sum << 32) | id``; -1, all ones,
when empty). dist and par rows are updated in place. The frontiers are
bitmaps, ``bits int32[2, 2, words]`` (:func:`new_frontier`): side, then
level parity, then little-endian words of 32 vertices (bit ``u & 31`` of
word ``u >> 5``, as :func:`pack_bits`). Side ``s`` at level ``lvl`` of the
state row lives in ``bits[s, lvl & 1]``; a round writes the other parity
of the side it advances, so the host swaps no buffer and an alt round
leaves the passive side's bitmap in place. A round whose search has
stopped does nothing, so a host may launch several rounds between reads
of the state.

A shard of the vertex-sharded search
(:mod:`bibfs_tpu_torch.solvers.sharded`) runs the round kernels over its
own rows with ``id_space`` (the global row count: the bitmaps span it, the
table's slots are global ids, the sentinel is ``id_space``) and
``row_offset`` (the global id of local row 0, which the meet key carries);
the next bitmaps are written for the local rows' words only, and the
caller gathers them. One device passes neither (``id_space = n_rows``,
``row_offset = 0``).

The functional forms :func:`fused_dual_level` / :func:`fused_single_level`
keep the JAX contract (a uint8 dual row in and out: bit 0 source side,
bit 1 target side) and pack and unpack around one round.

Fit: the port's gates are its own. The kernels have no VMEM budget and
no parent-key bound (the first hit slot gives the parent, with no
``slot * KS + nbr`` key), so any plain ELL table with int32 ids fits; the
one rule kept is the layout one: tiered graphs run the ``pallas`` modes,
as in the JAX solver (``solvers/dense.resolve_mode``). The single-side
kernel stages the active bitmap in shared memory when it fits
(:func:`stage_fits`) and reads it from device memory otherwise.

CPU tensors run the plain torch twins (``*_plain``); CUDA tensors launch
the kernels or raise. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops.bitmap import (
    frontier_words,
    pack_bits,
    set_bits,
    stage_fits,
    unpack_bits,
)
from bibfs_tpu_torch.ops.pull_expand import (
    _check_table,
    claim_plain,
    gather_bits,
    sentinel_transposed_table,
)

INF32 = 1 << 30
NO_MEET = -1  # the empty meet key: all ones as a 64-bit unsigned
STATE_SLOTS = ("lvl_s", "lvl_t", "best", "meet", "cnt_s", "cnt_t",
               "md_s", "md_t", "ds_s", "ds_t", "levels", "edges")
S = {k: i for i, k in enumerate(STATE_SLOTS)}
_BIG64 = (1 << 63) - 1


def prepare_fused_tables(nbr, deg, id_space: int | None = None) -> tuple:
    """``(nbr_t, deg)``: the one table of all four kernels
    (:func:`sentinel_transposed_table`, sentinel ``id_space``) and the
    degree row, unpadded."""
    return sentinel_transposed_table(nbr, deg, id_space), deg


def new_frontier(src: int, dst: int, n_rows: int, device) -> torch.Tensor:
    """The search's frontier bitmaps at level 0 of both sides:
    ``int32[2, 2, frontier_words(n_rows)]`` with ``src`` set in the source
    side's parity 0 and ``dst`` in the target side's."""
    # made on the device: a host-built row would cost a blocking copy
    bits = torch.zeros(2, 2, frontier_words(n_rows), dtype=torch.int32,
                       device=device)
    for side, v in ((0, src), (1, dst)):
        set_bits(bits[side, 0], [v])
    return bits


def new_state(src: int, dst: int, deg) -> torch.Tensor:
    """The initial scalar state: both frontiers hold one vertex whose
    degree is the max degree and degree sum of its side."""
    same = src == dst
    st = torch.tensor(
        [0, 0, 0 if same else INF32, src if same else -1, 1, 1,
         0, 0, 0, 0, 0, 0],
        dtype=torch.int32, device=deg.device,
    )
    ends = torch.tensor([src, dst, src, dst], device=deg.device)
    st[S["md_s"]:S["ds_t"] + 1] = deg[ends]
    return st


def new_scratch(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Cleared per-round accumulators ``(acc int32[6], meet_key int64[1])``."""
    return (torch.zeros(6, dtype=torch.int32, device=device),
            torch.full((1,), NO_MEET, dtype=torch.int64, device=device))


def active(st: list) -> bool:
    """The search goes on: ``lvl_s + lvl_t < best`` and both frontiers
    non-empty (``st`` is the state row as a list)."""
    return (st[S["lvl_s"]] + st[S["lvl_t"]] < st[S["best"]]
            and st[S["cnt_s"]] > 0 and st[S["cnt_t"]] > 0)


def decode_meet(key: int) -> tuple[int, int]:
    """``(meet_val, meet_idx)`` of a meet key; ``(INF32, -1)`` when empty."""
    if key == NO_MEET:
        return INF32, -1
    return key >> 32, key & 0xFFFFFFFF


def _fold_side(acc, key, side: int, nf, deg, d_a, d_b, row_offset: int = 0):
    """Plain accumulation of one side's round reductions and the meet
    candidates of ``(d_a, d_b)`` (global ids from ``row_offset``), as the
    kernels' atomics do."""
    nd = torch.where(nf, deg, 0)
    acc[side] += nf.sum(dtype=torch.int32)
    acc[2 + side] = torch.maximum(acc[2 + side], nd.max())
    acc[4 + side] += nd.sum(dtype=torch.int32)
    both = (d_a < INF32) & (d_b < INF32)
    ids = row_offset + torch.arange(d_a.shape[0], device=d_a.device)
    cand = torch.where(both, ((d_a + d_b).long() << 32) | ids, _BIG64).min()
    cur = key[0]
    new = torch.where(cur == NO_MEET, cand, torch.minimum(cur, cand))
    key[0] = torch.where(cand == _BIG64, cur, new)


def _claim_side(nbr_t, bits, side: int, lvl: int, dist, par, id_space: int):
    """Plain claim of one side from its bitmap (over ``id_space``
    vertices) at level ``lvl``: updates ``dist``/``par`` in place, writes
    the next bitmap's words of the local rows into the other parity and
    returns the new frontier ``bool[n_rows]``."""
    n_rows = dist.shape[0]
    front = unpack_bits(bits[side, lvl & 1], id_space)
    hit = gather_bits(front, nbr_t, n_rows) > 0
    nf, p = claim_plain(hit, nbr_t[:, :n_rows], dist >= INF32)
    dist.copy_(torch.where(nf, lvl + 1, dist))
    par.copy_(torch.where(nf, p, par))
    tiles = -(-n_rows // 32)
    bits[side, (lvl + 1) & 1, :tiles] = pack_bits(nf, tiles)
    return nf


def fused_dual_round_plain(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t,
                           state, acc, key, *, id_space: int | None = None,
                           row_offset: int = 0):
    """Plain twin of :func:`fused_dual_round` (reads the state on the
    host)."""
    st = state.tolist()
    if not active(st):
        return
    ids = nbr_t.shape[1] if id_space is None else id_space
    nf_s = _claim_side(nbr_t, bits, 0, st[S["lvl_s"]], dist_s, par_s, ids)
    nf_t = _claim_side(nbr_t, bits, 1, st[S["lvl_t"]], dist_t, par_t, ids)
    _fold_side(acc, key, 0, nf_s, deg2, dist_s, dist_t, row_offset)
    _fold_side(acc, key, 1, nf_t, deg2, dist_s, dist_t, row_offset)


def check_round(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t, state, acc,
                key, *, id_space: int | None = None) -> None:
    """Validate the buffers of a round on the card (shapes, dtypes, one
    device, contiguous): the bitmaps span ``id_space`` vertices (default
    the table's rows). A search checks its buffers once and then launches
    with ``checked=True``."""
    _check_table(nbr_t)
    n_rows = nbr_t.shape[1]
    rows = (deg2, dist_s, dist_t, par_s, par_t)
    if any(r.shape[0] != n_rows for r in rows):
        raise ValueError("deg/dist/par rows must match the table's rows")
    ids = n_rows if id_space is None else id_space
    if ids < n_rows or bits.shape != (2, 2, frontier_words(ids)):
        raise ValueError("bits must be [2, 2, frontier_words(id_space)] "
                         "(new_frontier)")
    if state.shape[0] < len(STATE_SLOTS) or acc.shape[0] < 6 or key.shape[0] < 1:
        raise ValueError("state/acc/key are too short")
    _cuda.check_dtype(torch.int32, bits=bits, deg2=deg2, dist_s=dist_s,
                      dist_t=dist_t, par_s=par_s, par_t=par_t, state=state,
                      acc=acc)
    _cuda.check_dtype(torch.int64, key=key)
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, deg2=deg2, bits=bits,
                     dist_s=dist_s, dist_t=dist_t, par_s=par_s, par_t=par_t,
                     state=state, acc=acc, key=key)


def _launch_round(fn: str, checked: bool, nbr_t, deg2, bits, dist_s, dist_t,
                  par_s, par_t, state, acc, key, *flags: int,
                  id_space: int | None = None, row_offset: int = 0) -> None:
    """Launch one round kernel; ``flags`` are the launcher's trailing ints
    (the single-side kernel's ``staged``)."""
    if not checked:
        check_round(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t, state,
                    acc, key, id_space=id_space)
    ids = nbr_t.shape[1] if id_space is None else id_space
    _cuda.launch(
        "fused_level", fn, nbr_t.data_ptr(), nbr_t.stride(0), nbr_t.shape[0],
        nbr_t.shape[1], ids, row_offset, deg2.data_ptr(), bits.data_ptr(),
        bits.shape[2],
        dist_s.data_ptr(), dist_t.data_ptr(), par_s.data_ptr(),
        par_t.data_ptr(), state.data_ptr(), acc.data_ptr(), key.data_ptr(),
        *flags,
    )


def _single_round_unstaged(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t,
                           state, acc, key) -> None:
    """The single-side kernel's unstaged instantiation (the bitmap read
    through ``__ldg``), which :func:`fused_single_round` takes only where
    the bitmap does not fit shared memory; ``chip_smoke.py`` and the CUDA
    test hold it against the plain twin where the wrapper stages. Not
    counted in ``.launches``; the search never calls it."""
    _launch_round("bibfs_fused_single", False, nbr_t, deg2, bits, dist_s,
                  dist_t, par_s, par_t, state, acc, key, 0)


def fused_dual_round(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t, state,
                     acc, key, *, id_space: int | None = None,
                     row_offset: int = 0, checked: bool = False) -> None:
    """One lock-step round for both sides, in place: claims the next
    frontiers into the other parity of ``bits`` and into dist/par, and
    accumulates counts, max degrees, degree sums and the meet vote into
    ``acc``/``key``. Does nothing when the state says the search has
    stopped. ``id_space`` / ``row_offset`` place the table's rows in a
    global id space (a shard; the module docstring). ``checked`` skips the
    validation a caller has already run (:func:`check_round`)."""
    if not nbr_t.is_cuda:
        return fused_dual_round_plain(nbr_t, deg2, bits, dist_s, dist_t,
                                      par_s, par_t, state, acc, key,
                                      id_space=id_space, row_offset=row_offset)
    _launch_round("bibfs_fused_dual", checked, nbr_t, deg2, bits, dist_s,
                  dist_t, par_s, par_t, state, acc, key, id_space=id_space,
                  row_offset=row_offset)
    _cuda.count_launch(fused_dual_round)


fused_dual_round.launches = 0


def _alt_side(st: list) -> int:
    """The side an alt round advances: the smaller frontier, source on a
    tie."""
    return 0 if st[S["cnt_s"]] <= st[S["cnt_t"]] else 1


def fused_single_round_plain(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t,
                             state, acc, key, *, id_space: int | None = None,
                             row_offset: int = 0):
    """Plain twin of :func:`fused_single_round`."""
    st = state.tolist()
    if not active(st):
        return
    side = _alt_side(st)
    dist_a, dist_p = (dist_s, dist_t) if side == 0 else (dist_t, dist_s)
    par_a = par_s if side == 0 else par_t
    ids = nbr_t.shape[1] if id_space is None else id_space
    nf = _claim_side(nbr_t, bits, side, st[S["lvl_s"] + side], dist_a, par_a,
                     ids)
    _fold_side(acc, key, side, nf, deg2, dist_a, dist_p, row_offset)


def fused_single_round(nbr_t, deg2, bits, dist_s, dist_t, par_s, par_t,
                       state, acc, key, *, id_space: int | None = None,
                       row_offset: int = 0, checked: bool = False) -> None:
    """One alt round, in place, for the side the state picks (the smaller
    frontier): the other side's bitmap stays where it is and its rows are
    only read (for the meet vote). The kernel stages the active bitmap in
    shared memory when :func:`stage_fits`. ``id_space`` / ``row_offset``
    as in :func:`fused_dual_round`."""
    if not nbr_t.is_cuda:
        return fused_single_round_plain(nbr_t, deg2, bits, dist_s, dist_t,
                                        par_s, par_t, state, acc, key,
                                        id_space=id_space,
                                        row_offset=row_offset)
    _launch_round("bibfs_fused_single", checked, nbr_t, deg2, bits, dist_s,
                  dist_t, par_s, par_t, state, acc, key,
                  int(stage_fits(bits.shape[2])), id_space=id_space,
                  row_offset=row_offset)
    _cuda.count_launch(fused_single_round)


fused_single_round.launches = 0


def fold_round_plain(state, acc, key, *, alt: bool) -> None:
    """Plain twin of :func:`fold_round`."""
    st = state.tolist()
    if active(st):
        side = _alt_side(st)
        mval, midx = decode_meet(int(key[0]))
        if mval < st[S["best"]]:
            st[S["best"]], st[S["meet"]] = mval, midx
        a = acc.tolist()
        for s in (side,) if alt else (0, 1):
            st[S["edges"]] += st[S["ds_s"] + s]
            st[S["lvl_s"] + s] += 1
            st[S["cnt_s"] + s] = a[s]
            st[S["md_s"] + s] = a[2 + s]
            st[S["ds_s"] + s] = a[4 + s]
        st[S["levels"]] += 1 if alt else 2
        state[: len(st)] = torch.tensor(st, dtype=torch.int32)
    acc.zero_()
    key.fill_(NO_MEET)


def fold_round(state, acc, key, *, alt: bool, checked: bool = False) -> None:
    """Apply a round's reductions to the state (best/meet, levels, edges
    += the degree sums of the frontier the round expanded, the new counts,
    max degrees and degree sums, the level numbers), when the search was
    active; then clear ``acc`` and ``key``."""
    if not state.is_cuda:
        return fold_round_plain(state, acc, key, alt=alt)
    if not checked:
        _cuda.check_dtype(torch.int32, state=state, acc=acc)
        _cuda.check_dtype(torch.int64, key=key)
        _cuda.check_cuda(state.device, state=state, acc=acc, key=key)
    _cuda.launch("fused_level", "bibfs_fold_round", state.data_ptr(),
                 acc.data_ptr(), key.data_ptr(), int(alt))
    _cuda.count_launch(fold_round)


fold_round.launches = 0


def _level_state(lvl_s: int, lvl_t: int, cnt_s: int, device) -> torch.Tensor:
    st = torch.zeros(len(STATE_SLOTS), dtype=torch.int32)
    st[S["lvl_s"]], st[S["lvl_t"]] = lvl_s - 1, lvl_t - 1
    st[S["best"]], st[S["meet"]] = INF32, -1
    st[S["cnt_s"]], st[S["cnt_t"]] = cnt_s, 1
    return st.to(device)


def _bits_of_row(dual_row, lvl_s: int, lvl_t: int, n_rows: int):
    """The bitmaps of a uint8 dual row whose sides are at levels
    ``(lvl_s, lvl_t)`` of the state row."""
    bits = torch.zeros(2, 2, frontier_words(n_rows), dtype=torch.int32,
                       device=dual_row.device)
    for side, lvl in ((0, lvl_s), (1, lvl_t)):
        fr = ((dual_row[:n_rows] >> side) & 1) > 0
        bits[side, lvl & 1] = pack_bits(fr, bits.shape[2])
    return bits


def _row_of_bits(bits, lvl_s: int, lvl_t: int, n_rows: int):
    """The uint8 dual row of the bitmaps at levels ``(lvl_s, lvl_t)``."""
    fs = unpack_bits(bits[0, lvl_s & 1], n_rows).to(torch.uint8)
    ft = unpack_bits(bits[1, lvl_t & 1], n_rows).to(torch.uint8)
    return fs | (ft << 1)


def fused_dual_level(dual_row, nbr_t, deg2, dist_s, dist_t, par_s, par_t,
                     lvl_s: int, lvl_t: int):
    """Functional form of one lock-step round at levels ``(lvl_s, lvl_t)``
    (the contract of the JAX ``fused_dual_level``): returns ``(dual_next,
    dist_s', dist_t', par_s', par_t', cnt_s, cnt_t, md_s, md_t, degsum_s,
    degsum_t, meet_val, meet_idx)`` with the scalars as ints; the inputs
    are left untouched. ``dual_row`` spans the id space (the global row
    of a shard, whose table holds global ids), the dist and par rows and
    ``dual_next`` the table's rows; ``meet_idx`` is a local row, as the
    reference's."""
    dev = nbr_t.device
    ds, dt, ps, pt = (x.clone() for x in (dist_s, dist_t, par_s, par_t))
    n_rows = ds.shape[0]
    ids = dual_row.shape[0]
    bits = _bits_of_row(dual_row, lvl_s - 1, lvl_t - 1, ids)
    state = _level_state(lvl_s, lvl_t, 1, dev)
    acc, key = new_scratch(dev)
    fused_dual_round(nbr_t, deg2, bits, ds, dt, ps, pt, state, acc, key,
                     id_space=ids)
    out = _row_of_bits(bits, lvl_s, lvl_t, n_rows)
    return (out, ds, dt, ps, pt, *acc.tolist(), *decode_meet(int(key[0])))


def fused_single_level(dual_row, nbr_t, deg2, dist_a, dist_p, par_a,
                       lvl_a: int, *, bit: int):
    """Functional form of one alt round advancing side ``bit`` (the
    contract of the JAX ``fused_single_level``): returns ``(dual_next,
    dist_a', par_a', cnt, md, degsum, meet_val, meet_idx)``; the passive
    side's frontier bits pass through."""
    dev = nbr_t.device
    da, pa = dist_a.clone(), par_a.clone()
    spare = torch.full_like(pa, -1)
    n_rows = da.shape[0]
    # cnt_s <= cnt_t picks the source side, cnt_s > cnt_t the target side;
    # the passive side sits at level 1
    lvl_s, lvl_t = (lvl_a, 1) if bit == 0 else (1, lvl_a)
    bits = _bits_of_row(dual_row, lvl_s - 1, lvl_t - 1, n_rows)
    state = _level_state(lvl_s, lvl_t, 1 + bit, dev)
    acc, key = new_scratch(dev)
    if bit == 0:
        sides = (da, dist_p, pa, spare)
    else:
        sides = (dist_p, da, spare, pa)
    fused_single_round(nbr_t, deg2, bits, *sides, state, acc, key)
    if bit == 0:
        out = _row_of_bits(bits, lvl_s, lvl_t - 1, n_rows)
    else:
        out = _row_of_bits(bits, lvl_s - 1, lvl_t, n_rows)
    a = acc.tolist()
    return (out, da, pa, a[bit], a[2 + bit], a[4 + bit],
            *decode_meet(int(key[0])))
