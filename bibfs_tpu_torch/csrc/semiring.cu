// The whole-graph analytics fixpoints over the blocked tile tables, each
// one launch.
//
// They replace the XLA while_loops of the reference's
// bibfs_tpu/ops/semiring_plane.py (not Pallas kernels):
//
// - minplus_fixpoint_kernel (_build_minplus_fixpoint, :105, through
//   sssp_blocked :199 and components_blocked :213): Jacobi (min, +) sweeps
//   nd[u, c] = min(d[u, c], min over stored (u, v) of w_uv + d[v, c]) over
//   f32 planes [n_pad, C], until a sweep lowers nothing (that sweep
//   counted) or max_rounds ran. The table is the f32 weight table of
//   [nblocks, bwidth, 128, 128] (+inf off the edges), or the int8 adjacency
//   read as 0 (edge) / +inf (none) for min-label propagation.
// - pagerank_kernel (_build_pagerank, :138, through pagerank_blocked :226):
//   damped power iteration r' = mask (base + damping (A c + mass / n)),
//   c = r / deg on rows of nonzero degree, mass the rank of the live rows of
//   zero degree, until the L1 step delta is at most tol or max_iters ran.
// - tricount_kernel (_build_tricount, :180, through triangles_chunk_blocked
//   :244): one 256-column chunk's sum((A @ P) * P) with P[u, j] = A[u, c0 +
//   j], the ordered pairs of triangles through the chunk's vertices.
// - pack_tile_rows_kernel replaces no program of the reference: it packs
//   the int8 tiles one bit an entry (bit j of word w of tile row r of slot
//   s is tab[b, s, r, 32 w + j]), 16 bytes a tile row instead of 128, once
//   per uploaded graph, stored slot-minor ([nblocks][128][bwidth][4]: a
//   row's slots side by side, so a warp's lanes on a row's slots, or on
//   one row of 32 slots, read 512 consecutive bytes); the PageRank and
//   triangle kernels read only the packed rows. Bound: the int8 table read
//   once, an eighth of it written.
//
// Exactness. Distances, labels and counts are integers: the (min, +) sums
// are exact in f32 below 2^24 (the serving gates hold that bound) and a min
// does not depend on order, so the planes equal the reference's bit for bit.
// The triangle count is integer arithmetic throughout. PageRank's ranks are
// f32 sums: every reduction has one fixed order (a lane's slots in turn and
// a warp's butterfly for a row; a block's warps in turn for an item; the
// items by a fixed tree that does not depend on the grid), and there are no
// float atomics, so a run gives the same ranks as the last, held to the
// reference by a tolerance.
//
// Design.
// 1. Persistent cooperative grids with a grid barrier between sweeps or
//    power steps (level_common.cuh grid_barrier); the planes ping-pong
//    between two buffers (Jacobi: a sweep reads only the buffer the last one
//    finished, so its rounds are the reference's) and a round's "changed"
//    flag lives in one of three words of the launch's zeroed working block
//    (the one two rounds ahead is cleared by block 0 at the start of a round:
//    every block has read it by then). The host reads one status word.
// 2. (min, +) sweeps: a work item is 32 rows of one block row; its 8 warps
//    take 4 rows each, a warp's lanes the in-tile columns v = lane + 32 k
//    (each 128-wide tile row is four coalesced loads). For each stored tile
//    of the block row the block stages the plane's column block transposed
//    in shared memory ([columns][128], no bank conflicts) and skips the tile
//    when that block is all +inf; sentinel slots (bcol == nblocks) are
//    skipped unread.
// 3. PageRank is latency-bound, not bandwidth-bound: a step reads 16 bytes
//    of packed row a stored slot (nnz_tiles 128 16 bytes, 12.8 MB on a
//    79 x 79 table, which stays in the 50 MB L2 from step to step) and 4
//    bytes of contrib an edge. So a step has no barrier but the grid's and
//    no staging: a warp takes a row u, lane l u's slots l, l + 32, ... (one
//    16-byte load each); the warp lists the row's set columns in shared
//    memory (a popcount and a warp scan give each lane its offsets) and
//    its lanes load contrib for four entries at a time, so a row is two
//    trips, not one a column. contrib (4 n_pad bytes) is read through L1
//    (ld.global.ca): the grid barrier's ld.acquire.gpu orders those weak
//    loads after every block's writes of the last step (PTX memory model:
//    acquire, then bar.sync), so no stale line is read. The epilogue writes
//    the next ranks and the next step's contrib = r / deg (0 where deg is
//    0) and the item's partial sums of the L1 delta and the dangling mass.
// 4. Triangles: an entry of (A @ P) * P is nonzero only where P is, i.e. at
//    an edge (x, u) with x in the chunk, and there it is the number of
//    common neighbours of x and u. A block takes (block row bx of the
//    chunk, slot s, a piece q of 32 of bu's slots, bu = bcol[bx, s]): warp
//    0 lists once, a lane a slot k = 32 q + lane, which slot of row bx
//    holds bu's column k (a binary search: bcol rows ascend, sentinels last,
//    as graph/blocked.py builds them), and every row x of bx in the chunk
//    reads its edges into bu from its packed row of slot s; for each edge
//    a lane ANDs x's and u's packed rows at its column (16 bytes each, 4
//    popcounts). The pieces of one (bx, s) build its list once between
//    them; the launch has 2 bwidth ceil(bwidth / 32) blocks of 16 warps
//    (474 on a 79-wide table, one wave), a warp 8 rows, the next row's
//    loads in flight while a row's edges are walked. One int64 atomicAdd a
//    block.
//
// Bounds on the H100: a sweep reads every stored tile the skip rule keeps
// and the plane; a power step the packed rows, bcol and the vectors; a
// triangle chunk the packed rows of its edges' tiles, far less than the
// dense product's 2 nnz_tiles 128^2 256 int8 operations; the pack reads the
// int8 table once and writes an eighth of it.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemRows = 32;                    // rows of a work item
constexpr int kParts = kTile / kItemRows;        // work items a block row
constexpr int kRowsPerWarp = kItemRows / kWarps;  // rows a warp
constexpr int kCols = 8;                         // plane columns a pass
constexpr u64 kWaitNs = 5000000000ull;
constexpr float kFInf = __builtin_inff();

enum Ctl : int { kBar = 0, kErr = 1, kFlag = 2 /* 2, 3, 4 */, kCtlLen = 8 };
enum Err : int { kErrBarrier = 2 };

__device__ __forceinline__ u64 ld_volatile(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ bool barrier(u64* ctl) {
  return bibfs::grid_barrier(ctl + kBar, ctl + kErr, (u64)kErrBarrier, kWaitNs);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---- D1: the (min, +) fixpoint ----------------------------------------------

struct MinplusArgs {
  const void* table;      // f32 weights, or int8 adjacency (kFromTab)
  const int32_t* bcol;    // [nblocks, bwidth], sentinel nblocks
  int64_t nblocks;
  int bwidth;
  int c;                  // plane columns
  int64_t max_rounds;
  float* planes;          // [2, n_pad, c]; buffer 0 holds the start
  u64* ctl;               // [kCtlLen], zero at launch
  int64_t* status;        // [0]: rounds, or -error
};

template <bool kFromTab, int CB>
__global__ void __launch_bounds__(kThreads)
minplus_fixpoint_kernel(MinplusArgs a) {
  __shared__ float d_t[CB][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t items = a.nblocks * kParts;
  const int64_t plane_len = a.nblocks * kTile * (int64_t)a.c;
  int64_t rounds = 0;
  for (int64_t r = 0;; ++r) {
    const float* d = a.planes + (r & 1) * plane_len;
    float* nd = a.planes + ((r + 1) & 1) * plane_len;
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[kFlag + (r + 1) % 3] = 0;
    int changed = 0;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      const int64_t bi = item / kParts;
      const int row0 = (int)(item % kParts) * kItemRows + warp * kRowsPerWarp;
      for (int c0 = 0; c0 < a.c; c0 += CB) {
        float acc[kRowsPerWarp][CB];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) acc[j][cc] = kFInf;
        }
        for (int s = 0; s < a.bwidth; ++s) {
          const int32_t bj = __ldg(a.bcol + bi * a.bwidth + s);
          if (bj < 0 || bj >= a.nblocks) continue;  // a sentinel slot
          __syncthreads();  // the last tile's readers are done with d_t
          int finite = 0;
          for (int idx = threadIdx.x; idx < CB * kTile; idx += kThreads) {
            const int cc = idx / kTile, v = idx % kTile;
            float x = kFInf;
            if (c0 + cc < a.c) x = __ldcg(d + ((int64_t)bj * kTile + v) * a.c + c0 + cc);
            d_t[cc][v] = x;
            finite |= x < kFInf;
          }
          if (!__syncthreads_or(finite)) continue;  // nothing here can lower
          const int64_t tile0 = (bi * a.bwidth + s) * (int64_t)kTile * kTile;
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int64_t rowp = tile0 + (int64_t)(row0 + j) * kTile;
            float w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (kFromTab) {
                w[k] = __ldg((const int8_t*)a.table + rowp + lane + 32 * k) > 0 ? 0.0f : kFInf;
              } else {
                w[k] = __ldg((const float*)a.table + rowp + lane + 32 * k);
              }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int cc = 0; cc < CB; ++cc) {
                acc[j][cc] = fminf(acc[j][cc], __fadd_rn(w[k], d_t[cc][lane + 32 * k]));
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int64_t u = bi * kTile + row0 + j;
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) {
            const float m = warp_min(acc[j][cc]);
            if (lane == cc && c0 + cc < a.c) {
              const int64_t at = u * a.c + c0 + cc;
              const float old = __ldcg(d + at);
              const float nv = fminf(old, m);
              nd[at] = nv;
              changed |= nv < old;
            }
          }
        }
      }
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) {
      atomicExch(a.ctl + kFlag + r % 3, 1ull);
    }
    if (!barrier(a.ctl)) break;
    rounds = r + 1;
    if (ld_volatile(a.ctl + kFlag + r % 3) == 0 || rounds >= a.max_rounds) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const u64 err = ld_volatile(a.ctl + kErr);
    a.status[0] = err ? -(int64_t)err : rounds;
  }
}

// ---- the packed tile rows -------------------------------------------------------

// Nonzero bytes of a word as four bits, byte b at bit b.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  const uint32_t m = __vcmpne4(v, 0u) & 0x01010101u;
  return (m | m >> 7 | m >> 14 | m >> 21) & 0xfu;
}

// The packed rows are stored slot-minor, bits[b][r][s][w] (a tile row of
// every slot of a block row together), so that the lanes of a warp that
// take a row's slots read consecutive 16-byte words. bits[b][r][s][w] bit j
// = (tab[b][s][r][32 w + j] != 0). A warp takes row r of 8 slots s0 ..
// s0 + 7 of block row b: lane l reads columns 32 (l % 4) .. + 31 of slot
// s0 + l / 4 (two 16-byte loads; the warp's reads are eight 128-byte rows)
// and writes word l % 4 of it (the warp's 128 bytes of output contiguous).
__global__ void __launch_bounds__(kThreads)
pack_tile_rows_kernel(const uint4* __restrict__ tab, int64_t nblocks,
                      int bwidth, uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int groups = (bwidth + 7) / 8;
  const int64_t units = nblocks * kTile * groups;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t un = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); un < units;
       un += warps) {
    const int64_t br = un / groups;  // b 128 + r
    const int s = (int)(un % groups) * 8 + (lane >> 2);
    if (s >= bwidth) continue;
    const int64_t b = br / kTile, r = br % kTile;
    const uint4* src = tab + (((b * bwidth + s) * kTile + r) * kTile + 32 * (lane & 3)) / 16;
    const uint4 v0 = __ldcs(src), v1 = __ldcs(src + 1);  // read once: stream it
    bits[(br * bwidth + s) * 4 + (lane & 3)] =
        nibble(v0.x) | nibble(v0.y) << 4 | nibble(v0.z) << 8 | nibble(v0.w) << 12 |
        nibble(v1.x) << 16 | nibble(v1.y) << 20 | nibble(v1.z) << 24 | nibble(v1.w) << 28;
  }
}

__device__ __forceinline__ uint32_t popc4(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

// ---- D2: PageRank -------------------------------------------------------------

constexpr int kPrRows = kWarps;  // rows of a PageRank work item, a warp each

struct PagerankArgs {
  const uint4* bits;      // [nblocks][128][bwidth] packed tile rows
  const int32_t* bcol;
  const int32_t* deg;     // [n_pad]
  int64_t nblocks;
  int bwidth;
  int64_t n;
  float base;             // (1 - damping) / n
  float damping;
  float tol;
  int64_t max_iters;
  float* ranks;           // [2, n_pad]
  float* contrib;         // [2, n_pad]: r / deg (0 where deg is 0)
  float* part;            // [2 parity][2: delta, mass][items]
  u64* ctl;
  int64_t* status;        // [0]: iterations or -error, [1]: delta's bits
};

// The items' two partial sums (delta, mass) in one fixed order: thread t adds
// items t, t + kThreads, ... in turn, then each warp's butterfly, then the
// warps in order. It does not depend on the grid, and every block computes
// the same totals.
__device__ float2 sum_items(const float* d, const float* m, int64_t items) {
  __shared__ float2 wsum[kWarps];
  __shared__ float2 total;
  float x = 0.0f, y = 0.0f;
  for (int64_t i = threadIdx.x; i < items; i += kThreads) {
    x = __fadd_rn(x, __ldcg(d + i));
    y = __fadd_rn(y, __ldcg(m + i));
  }
  x = warp_sum(x);
  y = warp_sum(y);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = make_float2(x, y);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.0f, 0.0f);
    for (int w = 0; w < kWarps; ++w) {
      t.x = __fadd_rn(t.x, wsum[w].x);
      t.y = __fadd_rn(t.y, wsum[w].y);
    }
    total = t;
  }
  __syncthreads();
  return total;  // rewritten only after the next call's first barrier
}

constexpr int kPrSlots = 4;    // slots a lane loads at once: 128 a warp
constexpr int kPrCap = 4096 / kWarps;  // columns a warp lists at once: 16 KB a block
constexpr int kPrGather = 4;   // contributions a lane loads at once

__device__ __forceinline__ uint32_t word_of(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// Row u's sum of contrib over its set columns, in one fixed order. For each
// group of 128 slots the lanes load their slots' packed rows (lane l slots
// l, l + 32, l + 64, l + 96), count their set columns, and list them in
// shared memory in (lane, slot, column) order, at offsets from a warp
// scan; then lane l loads entries l, l + 32, ... of the list four at a
// time and adds them in turn. A row costs two L2 trips a group, not one a
// column. The warp's butterfly follows in the caller.
__device__ float row_sum(const PagerankArgs& a, const float* con, int64_t bi,
                         int r, int32_t* list) {
  const int lane = threadIdx.x & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc = 0.0f;
  for (int s0 = 0; s0 < a.bwidth; s0 += 32 * kPrSlots) {
    uint4 w[kPrSlots];
    int32_t col0[kPrSlots];
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < kPrSlots; ++t) {
      const int s = s0 + lane + 32 * t;
      int32_t bj = -1;
      w[t] = zero;
      if (s < a.bwidth) {
        bj = __ldg(a.bcol + bi * a.bwidth + s);
        w[t] = __ldg(a.bits + (bi * kTile + r) * a.bwidth + s);
      }
      if (bj < 0 || bj >= a.nblocks) w[t] = zero;  // a sentinel slot
      col0[t] = bj * kTile;
      cnt += __popc(w[t].x) + __popc(w[t].y) + __popc(w[t].z) + __popc(w[t].w);
    }
    int off = cnt;  // the warp's inclusive scan, then exclusive
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, off, o);
      if (lane >= o) off += x;
    }
    const int total = __shfl_sync(0xffffffffu, off, 31);
    off -= cnt;
    for (int base = 0; base < total; base += kPrCap) {
      int at = off;
#pragma unroll
      for (int t = 0; t < kPrSlots; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t m = word_of(w[t], k);
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            if (at >= base && at < base + kPrCap) list[at - base] = col0[t] + 32 * k + j;
            ++at;
          }
        }
      }
      __syncwarp();
      const int here = total - base < kPrCap ? total - base : kPrCap;
      for (int e0 = 0; e0 < here; e0 += 32 * kPrGather) {
        float v[kPrGather];
#pragma unroll
        for (int h = 0; h < kPrGather; ++h) {
          const int e = e0 + lane + 32 * h;
          v[h] = e < here ? __ldca(con + list[e]) : 0.0f;
        }
#pragma unroll
        for (int h = 0; h < kPrGather; ++h) {
          if (e0 + lane + 32 * h < here) acc = __fadd_rn(acc, v[h]);
        }
      }
      __syncwarp();  // the list is rewritten for the next pass
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) pagerank_kernel(PagerankArgs a) {
  __shared__ float red[kWarps][2];
  __shared__ int32_t lists[kWarps][kPrCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_pad = a.nblocks * kTile;
  const int64_t items = n_pad / kPrRows;
  const float nf = (float)a.n;
  // the start: r = mask / n, its contributions, and per item the mass of
  // its dangling live rows
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    if (warp == 0) {
      float m = 0.0f;
      if (lane < kPrRows) {
        const int64_t u = item * kPrRows + lane;
        const int32_t dg = __ldg(a.deg + u);
        const float x = u < a.n ? __fdiv_rn(1.0f, nf) : 0.0f;
        a.ranks[u] = x;
        a.contrib[u] = dg > 0 ? __fdiv_rn(x, (float)dg) : 0.0f;
        m = dg > 0 ? 0.0f : x;
      }
      m = warp_sum(m);
      if (lane == 0) {
        a.part[item] = 0.0f;  // parity 0: delta, mass
        a.part[items + item] = m;
      }
    }
  }
  int64_t it = 0;
  float delta = kFInf;
  bool ok = barrier(a.ctl);
  float mass = ok ? sum_items(a.part, a.part + items, items).y : 0.0f;
  while (ok && delta > a.tol && it < a.max_iters) {
    const int64_t p = it & 1, q = (it + 1) & 1;
    const float* cur = a.ranks + p * n_pad;
    float* nxt = a.ranks + q * n_pad;
    const float* con = a.contrib + p * n_pad;
    float* ncon = a.contrib + q * n_pad;
    float* out = a.part + q * 2 * items;
    const float spread = __fdiv_rn(mass, nf);
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      // a warp a row u (row_sum); lane 0 loads what the epilogue needs first
      const int64_t u = item * kPrRows + warp;
      int32_t dg = 0;
      float old = 0.0f;
      if (lane == 0) {
        dg = __ldg(a.deg + u);
        old = __ldcg(cur + u);
      }
      const float acc = row_sum(a, con, u / kTile, (int)(u % kTile), lists[warp]);
      const float y = warp_sum(acc);
      if (lane == 0) {
        const float rn = u < a.n
            ? __fadd_rn(a.base, __fmul_rn(a.damping, __fadd_rn(y, spread)))
            : 0.0f;
        nxt[u] = rn;
        ncon[u] = dg > 0 ? __fdiv_rn(rn, (float)dg) : 0.0f;
        red[warp][0] = fabsf(__fsub_rn(rn, old));
        red[warp][1] = u < a.n && dg == 0 ? rn : 0.0f;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float ds = 0.0f, ms = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          ds = __fadd_rn(ds, red[w][0]);
          ms = __fadd_rn(ms, red[w][1]);
        }
        out[item] = ds;
        out[items + item] = ms;
      }
      __syncthreads();
    }
    ok = barrier(a.ctl);
    if (!ok) break;
    ++it;
    const float2 t = sum_items(out, out + items, items);
    delta = t.x;
    mass = t.y;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const u64 err = ld_volatile(a.ctl + kErr);
    a.status[0] = err ? -(int64_t)err : it;
    a.status[1] = (int64_t)__float_as_uint(delta);
  }
}

// ---- D3: one chunk's triangle count ---------------------------------------------

// the widest block row tricount_kernel takes (its grid: the chunk's block
// rows x bwidth x ceil(bwidth / 32) blocks; nothing of it in shared memory)
constexpr int kTriMaxWidth = 4096;
constexpr int kTriThreads = 512;  // 16 warps: 8 rows a warp
constexpr int kTriWarps = kTriThreads / 32;

// Block (bx, s, q): the edges (x, u) of the chunk's rows x of block row bx in
// slot s (u in block bu = bcol[bx, s]), and their common neighbours in the
// block columns bu holds at slots 32 q .. 32 q + 31. Warp 0 finds, a lane
// each, the slot of row bx that holds bu's column 32 q + lane (a binary
// search: bcol rows ascend, sentinels last), once for the block; lane l of
// every warp then ANDs x's and u's packed rows at that column (16 bytes
// each) for each edge. The q pieces of one (bx, s) together are its list,
// built once.
__global__ void __launch_bounds__(kTriThreads)
tricount_kernel(const uint4* __restrict__ bits, const int32_t* __restrict__ bcol,
                int64_t nblocks, int bwidth, int64_t c0, int rows, u64* out) {
  __shared__ int32_t match[32];
  __shared__ u64 red[kTriWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pieces = (bwidth + 31) / 32;
  const int64_t b = blockIdx.x;
  const int q = (int)(b % pieces);
  const int s = (int)(b / pieces % bwidth);
  const int64_t bx = c0 / kTile + b / ((int64_t)pieces * bwidth);
  const int32_t* cols_x = bcol + bx * bwidth;
  const int32_t bu = __ldg(cols_x + s);
  if (bu < 0 || bu >= nblocks) return;  // a sentinel slot: the whole block
  const int k = 32 * q + lane;
  if (warp == 0) {
    const int32_t ck = k < bwidth ? __ldg(bcol + (int64_t)bu * bwidth + k)
                                  : (int32_t)nblocks;
    int lo = 0, hi = bwidth;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(cols_x + mid) < ck) lo = mid + 1; else hi = mid;
    }
    const bool hit = ck >= 0 && ck < nblocks && lo < bwidth &&
                     __ldg(cols_x + lo) == ck;
    match[lane] = hit ? lo : -1;
  }
  __syncthreads();
  const int i = match[lane];
  const int64_t left = c0 + rows - bx * kTile;  // the chunk's rows in bx
  const int xr_end = left < kTile ? (int)left : kTile;
  // row xr's word of slot j of block row bx: rows_x[xr * bwidth + j]; row
  // c's of bu's slot k: rows_u[c * bwidth]
  const uint4* rows_x = bits + bx * kTile * bwidth;
  const uint4* rows_u = bits + (int64_t)bu * kTile * bwidth + (i >= 0 ? k : 0);
  const int xi = i >= 0 ? i : 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  u64 total = 0;
  // the warp's rows xr = warp, warp + 16, ...; the next row's loads are
  // issued before this row's edges are walked
  int xr = warp;
  uint4 e = zero, xv = zero;
  if (xr < xr_end) {
    e = __ldg(rows_x + (int64_t)xr * bwidth + s);  // x's edges into bu
    if (i >= 0) xv = __ldg(rows_x + (int64_t)xr * bwidth + xi);
  }
  while (xr < xr_end) {
    const int nx = xr + kTriWarps;
    uint4 e2 = zero, xv2 = zero;
    if (nx < xr_end) {
      e2 = __ldg(rows_x + (int64_t)nx * bwidth + s);
      if (i >= 0) xv2 = __ldg(rows_x + (int64_t)nx * bwidth + xi);
    }
    if (i >= 0) {
      uint32_t cnt = 0;
      const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        uint32_t m = ew[wi];
        while (m) {  // two edges' loads in flight at a time
          const int ca = 32 * wi + __ffs(m) - 1;
          m &= m - 1;
          const uint4 ua = __ldg(rows_u + (int64_t)ca * bwidth);
          uint4 ub = zero;
          if (m) {
            const int cb = 32 * wi + __ffs(m) - 1;
            m &= m - 1;
            ub = __ldg(rows_u + (int64_t)cb * bwidth);
          }
          cnt += popc4(xv, ua) + popc4(xv, ub);
        }
      }
      total += cnt;
    }
    e = e2;
    xv = xv2;
    xr = nx;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 t = 0;
    for (int w = 0; w < kTriWarps; ++w) t += red[w];
    if (t) atomicAdd(out, t);
  }
}

template <class K>
int coop_blocks(K kernel, int64_t items, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t fit = (int64_t)sms * per_sm;
  *blocks = (int)(items < fit ? (items > 0 ? items : 1) : fit);
  return 0;
}

template <class K>
int launch_coop(K kernel, int64_t items, void* args, void* stream) {
  int blocks = 0;
  const int rc = coop_blocks(kernel, items, &blocks);
  if (rc != 0) return rc;
  void* argv[] = {args};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(kThreads), argv, 0,
                                          (cudaStream_t)stream);
}

}  // namespace

// One (min, +) fixpoint (module comment) in one cooperative launch. table
// f32 (from_tab 0) or int8 (from_tab 1) [nblocks, bwidth, 128, 128], bcol
// int32 [nblocks, bwidth]; planes f32 [2, nblocks * 128, c] with the start in
// buffer 0 (the result lands in buffer rounds & 1); ctl [8] int64 zero;
// status [1] int64 receives the rounds, or minus the error code. The launch's
// error code is returned.
extern "C" int bibfs_minplus_fixpoint(const void* table, int from_tab,
                                      const void* bcol, int64_t nblocks,
                                      int bwidth, int c, int64_t max_rounds,
                                      void* planes, void* ctl, void* status,
                                      void* stream) {
  if (nblocks < 1 || nblocks * kTile > INT32_MAX || bwidth < 1 || c < 1 ||
      max_rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  MinplusArgs a;
  a.table = table;
  a.bcol = (const int32_t*)bcol;
  a.nblocks = nblocks;
  a.bwidth = bwidth;
  a.c = c;
  a.max_rounds = max_rounds;
  a.planes = (float*)planes;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  const int64_t items = nblocks * kParts;
  if (from_tab) {
    return c == 1 ? launch_coop(minplus_fixpoint_kernel<true, 1>, items, &a, stream)
                  : launch_coop(minplus_fixpoint_kernel<true, kCols>, items, &a, stream);
  }
  return c == 1 ? launch_coop(minplus_fixpoint_kernel<false, 1>, items, &a, stream)
                : launch_coop(minplus_fixpoint_kernel<false, kCols>, items, &a, stream);
}

// Pack the int8 tiles' rows, one bit an entry (pack_tile_rows_kernel): tab
// int8 [nblocks, bwidth, 128, 128] (16-byte aligned), bits int32 [nblocks,
// 128, bwidth, 4] (slot-minor). The launch's error code is returned.
extern "C" int bibfs_pack_tile_rows(const void* tab, int64_t nblocks, int bwidth,
                                    void* bits, void* stream) {
  if (nblocks < 1 || bwidth < 1 || (uintptr_t)tab % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t units = nblocks * kTile * ((bwidth + 7) / 8);
  const int64_t want = (units + kWarps - 1) / kWarps;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  pack_tile_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)tab, nblocks, bwidth, (uint32_t*)bits);
  return (int)cudaGetLastError();
}

// One PageRank solve (module comment) in one cooperative launch over the
// packed tile rows bits int32 [nblocks, 128, bwidth, 4] (16-byte aligned),
// deg int32 [n_pad] (0 on pad rows), n live rows; ranks and contrib f32 [2,
// n_pad] (the ranks in buffer iterations & 1), part f32 [2, 2, n_pad / 8]
// scratch, ctl [8] int64 zero; status [2] int64 receives the iterations (or
// minus the error code) and the last delta's f32 bits.
extern "C" int bibfs_pagerank(const void* bits, const void* bcol, const void* deg,
                              int64_t nblocks, int bwidth, int64_t n, float base,
                              float damping, float tol, int64_t max_iters,
                              void* ranks, void* contrib, void* part, void* ctl,
                              void* status, void* stream) {
  if (nblocks < 1 || nblocks * kTile > INT32_MAX || bwidth < 1 || n < 1 ||
      n > nblocks * kTile || (uintptr_t)bits % 16) {
    return (int)cudaErrorInvalidValue;
  }
  PagerankArgs a;
  a.bits = (const uint4*)bits;
  a.bcol = (const int32_t*)bcol;
  a.deg = (const int32_t*)deg;
  a.nblocks = nblocks;
  a.bwidth = bwidth;
  a.n = n;
  a.base = base;
  a.damping = damping;
  a.tol = tol;
  a.max_iters = max_iters;
  a.ranks = (float*)ranks;
  a.contrib = (float*)contrib;
  a.part = (float*)part;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  return launch_coop(pagerank_kernel, nblocks * kTile / kPrRows, &a, stream);
}

// One chunk's ordered-pair triangle total (module comment): rows c0 .. c0 +
// rows - 1 (c0 a multiple of 128, rows at most 256) over the packed tile rows
// bits int32 [nblocks, 128, bwidth, 4] (16-byte aligned; bcol rows
// ascending, sentinels last; bwidth at most kTriMaxWidth), added into out
// int64 [1]. The launch's error code is returned.
extern "C" int bibfs_tricount(const void* bits, const void* bcol, int64_t nblocks,
                              int bwidth, int64_t c0, int rows, void* out,
                              void* stream) {
  if (nblocks < 1 || bwidth < 1 || bwidth > kTriMaxWidth || c0 < 0 ||
      c0 % kTile || rows < 1 || rows > 2 * kTile ||
      c0 + rows > nblocks * kTile || (uintptr_t)bits % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t row_blocks = (rows + kTile - 1) / kTile;
  const int64_t blocks = row_blocks * bwidth * ((bwidth + 31) / 32);
  tricount_kernel<<<(unsigned)blocks, kTriThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)bits, (const int32_t*)bcol, nblocks, bwidth, c0, rows,
      (u64*)out);
  return (int)cudaGetLastError();
}
