"""Frontier bitmaps, the form in which the level kernels read and write a
frontier.

- A bitmap row holds one bit per vertex in little-endian ``int32`` words:
  bit ``u & 31`` of word ``u >> 5`` (the bit order of
  ``bibfs_tpu/parallel/collectives.pack_bits``), ``frontier_words(n)``
  words for ``n`` vertices.
- A pair row holds both sides of a lock-step round, two bits per vertex:
  bit ``2 (u & 15)`` (source side) and ``2 (u & 15) + 1`` (target side)
  of word ``u >> 4``, ``2 * frontier_words(n)`` words, so one load
  answers both sides.

The bits past ``n`` are zero. A row is a whole number of 16-byte pieces,
so the kernels can stage it in shared memory with ``cp.async.bulk``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# dynamic shared memory a staged kernel may take: a block's 227 KB less
# 2 KB kept for its static shared memory
STAGE_MAX_BYTES = 227 * 1024 - 2048


def frontier_words(n_rows: int) -> int:
    """Words per bitmap row: ``ceil(n_rows / 32)`` rounded up to a multiple
    of 4 (whole 16-byte pieces). It is also the number of 32-row warp
    tiles a kernel that writes the row covers."""
    return -(-n_rows // 128) * 4


def stage_fits(words: int) -> bool:
    """Whether a single-side kernel stages a bitmap row of ``words``
    words in shared memory (up to about 1.84M rows)."""
    return words * 4 <= STAGE_MAX_BYTES


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_bits(fr, words: int) -> torch.Tensor:
    """``bool[n]`` as a bitmap row of ``words`` words. A word's bits are
    distinct, so their int32 sum is the word (the top bit's ``-2 ** 31``
    plus the rest never overflows)."""
    n = fr.shape[0]
    if words * 32 < n:
        raise ValueError(f"{words} words cannot hold {n} bits")
    b = F.pad(fr.to(torch.int32), (0, words * 32 - n))
    return (b.view(words, 32) << _shifts(b.device)).sum(dim=1, dtype=torch.int32)


def unpack_bits(words, n: int) -> torch.Tensor:
    """The first ``n`` bits of a bitmap row as ``bool[n]``."""
    bits = (words[:, None] >> _shifts(words.device)) & 1
    return bits.reshape(-1)[:n] > 0


def pack_pairs(fr_s, fr_t, words: int) -> torch.Tensor:
    """Both sides' ``bool[n]`` frontiers as a pair row of ``words`` words:
    the bitmap of the two rows interleaved (source, target, source, ...)."""
    return pack_bits(torch.stack([fr_s, fr_t], dim=1).view(-1), words)


def unpack_pairs(words, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The source and target sides' ``bool[n]`` of a pair row."""
    both = unpack_bits(words, 2 * n).view(n, 2)
    return both[:, 0], both[:, 1]


def set_bits(row, bits) -> None:
    """Set the bits ``bits`` (indices into the row) of a zeroed bitmap row
    on the device: one write per word they touch, the words made on the
    host (a host-built row would cost a blocking copy)."""
    words: dict[int, int] = {}
    for b in bits:
        words[b >> 5] = words.get(b >> 5, 0) | 1 << (b & 31)
    for i, w in words.items():
        row[i] = w - (1 << 32) if w >= 1 << 31 else w


def pack_lanes(bits) -> torch.Tensor:
    """``bool[n, B]`` (``B`` a multiple of 32) as ``int32[n, B / 32]``:
    one bitmap row per row of ``bits``, bit ``q & 31`` of word ``q >> 5``
    for column ``q`` (the batch-minor search's per-query bits)."""
    n, b = bits.shape
    if b % 32:
        raise ValueError(f"{b} columns are not whole 32-bit words")
    x = bits.to(torch.int32).view(n, b // 32, 32) << _shifts(bits.device)
    return x.sum(dim=2, dtype=torch.int32)


def unpack_lanes(words) -> torch.Tensor:
    """The ``bool[n, 32 * w]`` of ``int32[n, w]`` words (:func:`pack_lanes`)."""
    n, w = words.shape
    return (((words[:, :, None] >> _shifts(words.device)) & 1) > 0).view(n, 32 * w)
