// One round of the blocked search: the frontier expansion of every query
// of a batch as int8 tensor-core products over the tiled adjacency, with
// the level body's masked stamp.
//
// blocked_level_kernel replaces the XLA program of
// bibfs_tpu/ops/blocked_expand.py expand_blocked_plane (a dot_general, no
// Pallas kernel there) together with the stamp of its caller,
// bibfs_tpu/solvers/dense.py _make_blocked_body (dense.py:214-216). For
// plane columns c < C = 2B (source sides 0..B-1, target sides B..2B-1):
//
//   acc[u, c] = sum_k sum_v tab[bi, k, u, v] * F[bcol[bi, k] * 128 + v, c]
//   new       = acc > 0 && dist[c, u] >= INF && live[c mod B]
//   dist[c, u] = lvl where new; F'[c, u] = new
//
// Layout (ops/blocked_expand.py): the table is int8 [nblocks, bwidth, 128,
// 128], row-major per tile (u, then v), with bcol int32 [nblocks, bwidth]
// (sentinel nblocks for dead slots). The planes are query-major: the
// frontier F and F' int8 [C, n_pad], dist int32 [C, n_pad]. A column's
// 128 entries of one block column are 128 consecutive bytes, which is the
// k-major ("col") B operand of mma.m16n8k32.row.col.s8 as it stands: no
// transpose on the way into shared memory.
//
// Bound on the H100: device-memory bytes. A round must read the live
// tiles (16 KB each) and the plane (C * n_pad bytes), write the next
// plane, and read dist where a column reaches a vertex (4 B) and write it
// where a vertex is new. The int8 products (live tiles * 128 * 128 * C
// multiply-adds) take a small share of the tensor cores' rate at these
// shapes, so the kernel is bound by bytes.
//
// Design: a block of 8 warps takes one group of kCols plane columns
// (blockIdx.x: the fast index, so the groups sharing a tile run together
// and read it from L2) and one block row (blockIdx.y). It walks the row's
// live slots only (a sentinel slot is skipped, never multiplied): per
// slot it stages the 128x128 tile and the kCols x 128 frontier sub-plane
// of the slot's block column in shared memory with 16-byte loads (rows
// padded to 144 bytes, so the 32-bit fragment loads below hit 32 distinct
// banks), then warp w multiplies rows 16w..16w+15 of the tile against all
// kCols columns, kCols / 8 m16n8k32 products per 32-wide k step, into
// int32 accumulators in registers (products of 0/1 are exact: a count is
// at most bwidth * 128). The epilogue reads dist only where the count is
// positive and the query live (32-byte sectors of 8 consecutive rows of
// one column), stamps the new entries, and writes the next plane through
// shared memory as 16-byte stores of whole column segments; a block row
// with no live slot writes zeros. Later work: wgmma with TMA-fed tiles,
// and the per-column counts and meet vote in the epilogue (ROADMAP).
#include "level_common.cuh"

namespace {

constexpr int kTile = 128;      // tile edge: M and K of a block's product
constexpr int kCols = 64;       // plane columns per block: N
constexpr int kThreads = 256;   // 8 warps, 16 tile rows each
constexpr int kLd = kTile + 16; // shared-memory row stride in bytes

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
blocked_level_kernel(const int8_t* __restrict__ tab,
                     const int32_t* __restrict__ bcol, int64_t nblocks,
                     int bwidth, const int8_t* __restrict__ plane,
                     int8_t* __restrict__ plane_n, int32_t* __restrict__ dist,
                     int64_t n_pad, int64_t c_total,
                     const int32_t* __restrict__ live, int32_t lvl) {
  __shared__ __align__(16) int8_t s_tab[kTile * kLd];
  __shared__ __align__(16) int8_t s_fr[kCols * kLd];

  const int64_t c0 = (int64_t)blockIdx.x * kCols;
  const int64_t bi = blockIdx.y;
  const int64_t half = c_total / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in the group

  int acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int k = 0; k < bwidth; ++k) {
    const int64_t bj = bcol[bi * bwidth + k];  // one value for the block
    if (bj >= nblocks) continue;               // a sentinel slot
    __syncthreads();  // the previous slot's fragment loads are done
    const int4* src = reinterpret_cast<const int4*>(
        tab + (bi * bwidth + k) * (int64_t)(kTile * kTile));
    for (int i = threadIdx.x; i < kTile * kTile / 16; i += kThreads) {
      *reinterpret_cast<int4*>(s_tab + (i >> 3) * kLd + (i & 7) * 16) = src[i];
    }
    for (int i = threadIdx.x; i < kCols * kTile / 16; i += kThreads) {
      const int c = i >> 3;
      int4 v = make_int4(0, 0, 0, 0);
      if (c0 + c < c_total) {
        v = *reinterpret_cast<const int4*>(plane + (c0 + c) * n_pad +
                                           bj * kTile + (i & 7) * 16);
      }
      *reinterpret_cast<int4*>(s_fr + c * kLd + (i & 7) * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTile; ks += 32) {
      const int8_t* a = s_tab + (warp * 16 + gid) * kLd + ks + tig * 4;
      const uint32_t a0 = lds32(a);
      const uint32_t a1 = lds32(a + 8 * kLd);
      const uint32_t a2 = lds32(a + 16);
      const uint32_t a3 = lds32(a + 8 * kLd + 16);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int8_t* b = s_fr + (j * 8 + gid) * kLd + ks + tig * 4;
        const uint32_t b0 = lds32(b);
        const uint32_t b1 = lds32(b + 16);
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
              "+r"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }

  // epilogue: accumulator e of n-tile j holds row warp*16 + gid (+8 for
  // e >= 2) and column j*8 + tig*2 (+1 for odd e)
  __syncthreads();  // s_fr becomes the output stage
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + tig * 2 + (e & 1);
      const int u = warp * 16 + gid + (e >> 1) * 8;
      const int64_t cg = c0 + c;
      int8_t now = 0;
      if (acc[j][e] > 0 && cg < c_total && live[cg < half ? cg : cg - half]) {
        int32_t* d = dist + cg * n_pad + bi * kTile + u;
        if (*d >= bibfs::kInf) {
          *d = lvl;
          now = 1;
        }
      }
      s_fr[c * kLd + u] = now;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCols * kTile / 16; i += kThreads) {
    const int c = i >> 3;
    if (c0 + c < c_total) {
      *reinterpret_cast<int4*>(plane_n + (c0 + c) * n_pad + bi * kTile +
                               (i & 7) * 16) =
          *reinterpret_cast<const int4*>(s_fr + c * kLd + (i & 7) * 16);
    }
  }
}

}  // namespace

// One blocked round: `plane` and `plane_n` int8 [c, n_pad], `dist` int32
// [c, n_pad] (stamped in place), `live` int32 [c / 2]; n_pad = nblocks *
// 128, and every pointer is 16-byte aligned (torch allocations are).
extern "C" int bibfs_blocked_level(const void* tab, const void* bcol,
                                   int64_t nblocks, int bwidth,
                                   const void* plane, void* plane_n, void* dist,
                                   int64_t n_pad, int64_t c, const void* live,
                                   int lvl, void* stream) {
  if (nblocks < 1 || nblocks > 65535 || c < 2 || c % 2 ||
      n_pad != nblocks * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((c + kCols - 1) / kCols), (unsigned)nblocks);
  blocked_level_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tab, (const int32_t*)bcol, nblocks, bwidth,
      (const int8_t*)plane, (int8_t*)plane_n, (int32_t*)dist, n_pad, c,
      (const int32_t*)live, (int32_t)lvl);
  return (int)cudaGetLastError();
}
