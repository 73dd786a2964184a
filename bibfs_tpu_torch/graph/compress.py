"""Varint+delta compressed CSR adjacency, the cold tier of the graph
store: the counterpart of ``bibfs_tpu/graph/compress.py``, byte for byte
the same encoding.

A graph that serves no hot traffic should not pin O(E) int64 neighbour
ids in memory. Canonical CSR rows are sorted ascending, so each row is
stored as its first neighbour and then the gaps to each predecessor
(**delta**, all ``>= 1`` after dedup), each value as 1-5 little-endian
7-bit groups with a continuation high bit (**varint**, LEB128): a small
gap costs one byte instead of eight.

``row_ptr`` stays raw int64 (``n+1`` entries), so row ``u``'s values are
the ``row_ptr[u+1] - row_ptr[u]`` varints from the ``row_ptr[u]``-th
encoded value. Encode and decode are NumPy-vectorized: byte lengths by
thresholds and ``cumsum`` offsets on the way in; a continuation-bit scan,
at most 5 masked shift/or passes and a segmented ``cumsum`` un-delta on
the way out. The round trip is exact; the store's residency accountant
(``store/registry.py``) demotes a graph to this object and a promote
decodes it back to the identical CSR.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: LEB128 group-count thresholds: value < _THRESH[k] needs k+1 bytes.
#: 5 groups cover 35 bits — vertex ids are < 2**31 by the on-disk
#: uint32 contract (graph/io.py), so gaps always fit.
_THRESH = tuple(np.int64(1) << (7 * k) for k in range(1, 6))
_MAX_GROUPS = 5


@dataclasses.dataclass(frozen=True)
class CompressedCSR:
    """One graph's cold-tier adjacency: raw ``row_ptr`` + the
    varint+delta neighbor stream (module docstring)."""

    n: int
    nnz: int  # directed entries (2E for the mirrored canonical CSR)
    row_ptr: np.ndarray  # int64 [n+1]
    data: np.ndarray  # uint8 varint stream

    @property
    def compressed_bytes(self) -> int:
        return int(self.data.nbytes + self.row_ptr.nbytes)

    @property
    def raw_bytes(self) -> int:
        """What the decoded (row_ptr, col_ind) pair costs resident."""
        return int(self.row_ptr.nbytes + 8 * self.nnz)

    @property
    def ratio(self) -> float:
        """Raw/compressed — > 1 is a win; the neighbor stream alone
        typically lands 4–8x on clustered graphs."""
        return self.raw_bytes / float(self.compressed_bytes or 1)

    def stats(self) -> dict:
        return {
            "n": self.n,
            "nnz": self.nnz,
            "compressed_bytes": self.compressed_bytes,
            "raw_bytes": self.raw_bytes,
            "ratio": round(self.ratio, 3),
        }


def _deltas(row_ptr: np.ndarray, col_ind: np.ndarray) -> np.ndarray:
    """Within-row deltas: first neighbor absolute, rest gaps — all
    non-negative because canonical rows are sorted ascending."""
    vals = np.ascontiguousarray(col_ind, dtype=np.int64).copy()
    if vals.size:
        vals[1:] -= col_ind[:-1]
        starts = np.asarray(row_ptr[:-1], dtype=np.int64)
        starts = starts[starts < vals.size]  # trailing empty rows
        vals[starts] = col_ind[starts]
    if vals.size and int(vals.min()) < 0:
        raise ValueError(
            "CSR rows must be sorted ascending (canonical_pairs order) "
            "to delta-encode"
        )
    return vals


def encode_csr(row_ptr: np.ndarray, col_ind: np.ndarray) -> CompressedCSR:
    """Encode one canonical CSR into the cold-tier layout (vectorized)."""
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    n = int(row_ptr.shape[0]) - 1
    nnz = int(row_ptr[-1]) if row_ptr.size else 0
    if nnz != int(np.asarray(col_ind).shape[0]):
        raise ValueError(
            f"row_ptr claims {nnz} entries but col_ind has "
            f"{np.asarray(col_ind).shape[0]}"
        )
    vals = _deltas(row_ptr, col_ind)
    # bytes per value by threshold comparison (k+1 groups when
    # value >= 2**(7k)); values are non-negative so 5 groups suffice
    nbytes = np.ones(vals.shape[0], dtype=np.int64)
    for t in _THRESH[:-1]:
        nbytes += vals >= t
    offsets = np.zeros(vals.shape[0] + 1, dtype=np.int64)
    np.cumsum(nbytes, out=offsets[1:])
    data = np.zeros(int(offsets[-1]), dtype=np.uint8)
    for k in range(_MAX_GROUPS):
        sel = nbytes > k
        if not sel.any():
            break
        group = ((vals[sel] >> (7 * k)) & 0x7F).astype(np.uint8)
        cont = (nbytes[sel] > k + 1).astype(np.uint8) << 7
        data[offsets[:-1][sel] + k] = group | cont
    return CompressedCSR(n=n, nnz=nnz, row_ptr=row_ptr, data=data)


def decode_csr(c: CompressedCSR) -> tuple[np.ndarray, np.ndarray]:
    """Decode back to the exact ``(row_ptr, col_ind)`` pair
    (vectorized; module docstring). Raises ``ValueError`` on a stream
    whose varint count disagrees with ``row_ptr`` — a truncated or
    foreign byte stream must fail loudly, never decode approximately."""
    data = np.ascontiguousarray(c.data, dtype=np.uint8)
    row_ptr = np.ascontiguousarray(c.row_ptr, dtype=np.int64)
    if c.nnz == 0:
        return row_ptr, np.zeros(0, dtype=np.int64)
    ends = np.flatnonzero((data & 0x80) == 0)
    if ends.size != c.nnz:
        raise ValueError(
            f"varint stream holds {ends.size} values; row_ptr claims "
            f"{c.nnz}"
        )
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if int(lengths.max()) > _MAX_GROUPS:
        raise ValueError(
            f"varint longer than {_MAX_GROUPS} groups — not a value "
            "this encoder produced"
        )
    vals = np.zeros(c.nnz, dtype=np.int64)
    for k in range(int(lengths.max())):
        sel = lengths > k
        vals[sel] |= (data[starts[sel] + k] & 0x7F).astype(np.int64) << (7 * k)
    # segmented un-delta: absolute id = within-row prefix sum of deltas
    cs = np.cumsum(vals)
    before = np.concatenate((np.zeros(1, dtype=np.int64), cs))[row_ptr[:-1]]
    col = cs - np.repeat(before, np.diff(row_ptr))
    return row_ptr, col


def encode_snapshot_csr(snapshot) -> CompressedCSR:
    """Encode a :class:`~bibfs_tpu_torch.store.snapshot.GraphSnapshot`'s CSR
    — the residency accountant's demote step (the snapshot's memoized
    builder supplies the canonical CSR whatever tier it is in)."""
    row_ptr, col_ind = snapshot.csr()
    return encode_csr(row_ptr, col_ind)
