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
//   counted) or max_rounds ran. The edges are the set bits of the packed
//   tile rows (below); w_uv is that entry of the f32 weight table of
//   [nblocks, bwidth, 128, 128] (+inf off the edges), or 0 for min-label
//   propagation (no table read at all).
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
//   one row of 32 slots, read 512 consecutive bytes); the other three
//   kernels read only the packed rows. Bound: the int8 table read once, an
//   eighth of it written.
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
//    finished, so its rounds are the reference's). The host reads one status
//    word.
// 2. (min, +) sweeps, edge-driven over a changed-block-row worklist.
//    - A row is a group of G lanes' (G the power of two that gives a lane
//      at most 4 of the row's slots: 1 on a lattice's 3-slot rows, 32 on a
//      dense graph's). The lanes load their slots' packed rows, list the
//      set entries in shared memory (a popcount and a group scan give each
//      lane its offsets), then take the listed entries a few at a time:
//      the entry's own f32 weight (one 32-byte sector, not the 512-byte
//      tile row; labels read none) and its row's plane columns, the min of
//      the sums per column; a group butterfly, then min(old, that) is
//      written. Sentinel slots are skipped unread. The warp's groups walk
//      their rows together and every warp collective names the whole warp
//      (shuffles of width G): per-group masks in a converged warp split it
//      into one path a group.
//    - Worklist: block row bi cannot change at sweep r unless a block row
//      it reads (bcol[bi, :]) lowered an entry at sweep r - 1, since d[u]
//      already bounds min_v(w_uv + d[v]) when no d[v] moved. Each sweep
//      ORs the block rows it lowered into a bitmap of nblocks bits (three
//      rotate in the launch's zeroed working block; the one a sweep will
//      write was cleared by block 0 two sweeps before, when every block had
//      read it). Sweep r + 1 works on the block rows that read a changed
//      one AND on the changed ones themselves: the planes ping-pong, so a
//      row that changed must still write its value into the other buffer
//      (which holds the value from before that change); an inactive row's
//      two buffers already agree. Sweep 0 takes every block row. Every
//      block builds the same worklist from the bitmap and bcol (a flat scan
//      of bcol, kept in shared memory when it fits, and a scan of the
//      words), and the grid's lane groups walk its rows in order.
//    - One-block stretches: while a sweep's rows fill at most kMpSoloRounds
//      passes of one block's lane groups (512 rows at a lane a row), block 0
//      runs it alone, with __syncthreads between sweeps and the changed
//      rows kept in shared memory, while the other blocks park on an epoch
//      word (level_common.cuh park / unpark, as delta_stepping_kernel does);
//      when the worklist grows, block 0 stores the sweep and the changed
//      rows and wakes the grid, which resumes with grid barriers. A row
//      costs two dependent L2 trips (its packed rows, then its entries'
//      values), so a block walks more rows than one pass slower than the
//      grid walks them with a barrier: one pass is the most a stretch
//      takes.
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
// Bounds on the H100: a sweep reads the packed rows of its worklist's block
// rows, a sector per stored edge's weight (SSSP) and the plane rows it reads
// and writes; a power step the packed rows, bcol and the vectors; a
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
constexpr u64 kWaitNs = 5000000000ull;
constexpr float kFInf = __builtin_inff();

// a launch's zeroed working words: the grid barrier's arrivals, the error
// code, and D1's park epoch, beat and the sweep a parked grid resumes at
enum Ctl : int { kBar = 0, kErr = 1, kEpoch = 2, kBeat = 3, kSweep = 4, kCtlLen = 8 };
enum Err : int { kErrBarrier = 2 };

__device__ __forceinline__ u64 ld_volatile(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ bool barrier(u64* ctl) {
  return bibfs::grid_barrier(ctl + kBar, ctl + kErr, (u64)kErrBarrier, kWaitNs);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
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

// ---- D1: the (min, +) fixpoint ----------------------------------------------

constexpr int kMpThreads = 512;
constexpr int kMpWarps = kMpThreads / 32;
constexpr int kMpMaxRows = 16384;              // block rows the kernel takes
constexpr int kMpMapWords = kMpMaxRows / 32;   // a bitmap of them
constexpr int kMpSlots = 4;       // slots a lane loads at once
constexpr int kMpListLane = 8;    // list entries a lane's group holds per lane
// bcol entries a block keeps in (dynamic) shared memory: the whole of bcol
// when it fits, read by every sweep's worklist and rows
constexpr int kMpBcolCache = 12288;
// a sweep runs in block 0 alone while its rows' lane groups fill at most
// kMpSoloRounds passes of one block
constexpr int kMpSoloRounds = 1;

enum MpStatus : int { kMpRounds = 0, kMpSolo = 1, kMpGrid = 2, kMpActive = 3 };

struct MinplusArgs {
  const uint4* bits;      // [nblocks][128][bwidth] packed tile rows
  const float* weights;   // f32 [nblocks, bwidth, 128, 128], or null: labels
  const int32_t* bcol;    // [nblocks, bwidth], sentinel nblocks
  int64_t nblocks;
  int bwidth;
  int c;                  // plane columns
  int group;              // lanes a row (a power of two, at most 32)
  int bcol_shared;        // bcol is copied into shared memory (stage_bits)
  int64_t max_rounds;
  float* planes;          // [2, n_pad, c]; buffer 0 holds the start
  u64* ctl;               // [kCtlLen] words, then 3 changed-row bitmaps
  int map_words;          // 32-bit words of one bitmap (even)
  int64_t* status;        // [4]: rounds (or -error), sweeps one block / grid, active rows
};

struct MpShared {
  uint32_t act[kMpMapWords];   // the sweep's block rows
  uint32_t mine[kMpMapWords];  // the last sweep's changed rows, then the block's
  int32_t pre[kMpMapWords + 1];  // active rows before each word of act
  int32_t wsum[kMpWarps];
  int2 list[kMpThreads * kMpListLane];  // (column, weight offset) a set entry
};

__device__ __forceinline__ uint32_t* chg_of(const MinplusArgs& a, int64_t r) {
  return reinterpret_cast<uint32_t*>(a.ctl + kCtlLen) + (r % 3) * a.map_words;
}

// act's exclusive prefix counts into pre (pre[W] the total); clears mine.
// All threads; returns the total. Up to 32 words (1,024 block rows) one warp
// scans them; more take a block scan, two words a thread.
__device__ int scan_active(MpShared& sh, int W) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (W <= 32) {
    if (warp == 0) {
      const int a0 = lane < W ? __popc(sh.act[lane]) : 0;
      int x = a0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < W) sh.pre[lane] = x - a0;
      if (lane == W - 1) sh.pre[W] = x;
    } else if (t - 32 < W) {
      sh.mine[t - 32] = 0u;
    }
    __syncthreads();
    return sh.pre[W];
  }
  const int a0 = 2 * t < W ? __popc(sh.act[2 * t]) : 0;
  const int a1 = 2 * t + 1 < W ? __popc(sh.act[2 * t + 1]) : 0;
  int x = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.wsum[warp] = x;
  for (int w = t; w < W; w += kMpThreads) sh.mine[w] = 0u;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kMpWarps ? sh.wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kMpWarps) sh.wsum[lane] = v;
  }
  __syncthreads();
  const int excl = (warp ? sh.wsum[warp - 1] : 0) + x - a0 - a1;
  if (2 * t < W) sh.pre[2 * t] = excl;
  if (2 * t + 1 < W) sh.pre[2 * t + 1] = excl + a0;
  const int total = sh.wsum[kMpWarps - 1];
  if (t == 0) sh.pre[W] = total;
  __syncthreads();
  return total;
}

// The lanes of a row (or of a block row's slots): G = a.group lanes, this
// lane's place lig in its group, the group's first lane in the warp and its
// lanes as a mask. Every warp collective below runs on the whole warp (full
// mask, shuffles of width G) with trip counts the same for the warp's
// groups: a converged warp whose lanes name different masks is split and
// runs its groups one after another.
struct Group {
  int G, lig, first;
  unsigned mask;
  __device__ __forceinline__ explicit Group(int g)
      : G(g), lig(threadIdx.x & (g - 1)), first((threadIdx.x & 31) & ~(g - 1)) {
    mask = g == 32 ? 0xffffffffu : ((1u << g) - 1u) << first;
  }
  // whether any lane of this group has pred (all lanes of the warp call it)
  __device__ __forceinline__ bool any(bool pred) const {
    return (__ballot_sync(0xffffffffu, pred) & mask) != 0u;
  }
};

// Sweep r's worklist into sh.act: every block row at sweep 0; after it, the
// block rows that lowered an entry at sweep r - 1 (their values go into the
// other buffer) and every block row that reads one of them (bcol). Those
// rows come from chg_of(r - 1), or, after a sweep block 0 ran alone
// (local), from sh.mine, which is then stored into chg_of(r - 1) for the
// grid to read should it resume. A lane group a block row tests its slots
// (a batch of loads at a time, stopping after a changed one); a block row
// that changed is not tested. All threads; returns the active block rows
// (0: the last sweep lowered nothing).
__device__ int worklist(const MinplusArgs& a, MpShared& sh, const int32_t* bcol,
                        int64_t r, int W, bool local) {
  const int t = threadIdx.x;
  if (r == 0) {
    for (int w = t; w < W; w += kMpThreads) {
      const int64_t left = a.nblocks - 32 * (int64_t)w;
      sh.act[w] = left >= 32 ? ~0u : (1u << left) - 1u;
    }
    __syncthreads();
    return scan_active(sh, W);
  }
  uint32_t* prev = chg_of(a, r - 1);
  for (int w = t; w < W; w += kMpThreads) {
    uint32_t x;
    if (local) {
      x = sh.mine[w];
      prev[w] = x;
    } else {
      x = __ldcg(prev + w);
      sh.mine[w] = x;
    }
    sh.act[w] = x;
  }
  __syncthreads();
  const Group grp(a.group);
  const int per = kMpThreads / grp.G;
  for (int b0 = 0; b0 < a.nblocks; b0 += per) {  // the same trips for every group
    const int bi = b0 + t / grp.G;
    bool hit = false;
    if (bi < a.nblocks && !(sh.mine[bi >> 5] >> (bi & 31) & 1u)) {
      const int32_t* cols = bcol + (int64_t)bi * a.bwidth;
      for (int s0 = 0; s0 < a.bwidth && !hit; s0 += grp.G * kMpSlots) {
        int32_t bj[kMpSlots];
#pragma unroll
        for (int k = 0; k < kMpSlots; ++k) {  // loads issued together
          const int s = s0 + grp.lig + grp.G * k;
          bj[k] = s < a.bwidth ? cols[s] : -1;
        }
#pragma unroll
        for (int k = 0; k < kMpSlots; ++k) {
          hit |= bj[k] >= 0 && bj[k] < a.nblocks && (sh.mine[bj[k] >> 5] >> (bj[k] & 31) & 1u);
        }
      }
    }
    if (grp.any(hit) && grp.lig == 0) {
      atomicOr(&sh.act[bi >> 5], 1u << (bi & 31));
    }
  }
  __syncthreads();
  return scan_active(sh, W);
}

// The a-th active block row of sh.act.
__device__ __forceinline__ int64_t nth_active(const MpShared& sh, int W, int a) {
  int lo = 0, hi = W;  // pre[lo] <= a < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (sh.pre[mid] <= a) lo = mid; else hi = mid;
  }
  uint32_t m = sh.act[lo];
  for (int k = a - sh.pre[lo]; k > 0; --k) m &= m - 1u;
  return 32 * (int64_t)lo + __ffs(m) - 1;
}

// Row u's plane columns c0 .. c0 + CB - 1 of the row v (an entry's column)
// into x: +inf past the plane's width. Read through L1: a grid barrier's or a
// parked block's ld.acquire.gpu, then bar.sync, order these weak loads after
// every write of the last sweep (and in one block, bar.sync alone).
template <int CB>
__device__ __forceinline__ void load_cols(const float* p, int left, bool vec,
                                          float (&x)[CB]) {
  if constexpr (CB >= 4) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < CB; j += 4) {
        float4 f = make_float4(kFInf, kFInf, kFInf, kFInf);
        if (j < left) f = __ldca(reinterpret_cast<const float4*>(p + j));
        x[j] = f.x;
        x[j + 1] = f.y;
        x[j + 2] = f.z;
        x[j + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) x[j] = j < left ? __ldca(p + j) : kFInf;
}

// One row u = 128 bi + row of one sweep, by a group of G lanes (lane lig of
// the group; a group whose row is not valid loads nothing and writes
// nothing, but joins its warp's collectives): for each chunk of CB plane
// columns, the lanes
// load their slots' packed rows (lig, lig + G, ...; kMpSlots at a time),
// list the set entries in the group's shared list in (lane, slot, column)
// order at offsets from a group scan, then take the entries lig, lig + G,
// ... kGather at a time: the entry's weight (its own 4 bytes of the table,
// one sector, not the tile row; 0 for labels) and its row's plane columns,
// min of the sums. A group butterfly gives every lane the row's minima;
// lane lig writes the chunk's columns j with j % G == lig: min(old, that).
// Returns whether this lane lowered a value.
template <int CB>
__device__ bool sweep_row(const MinplusArgs& a, const int32_t* bcol, const float* d,
                          float* nd, int64_t bi, int row, bool valid,
                          const Group& grp, int2* list) {
  constexpr int kGather = CB == 8 ? 2 : 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int G = grp.G, lig = grp.lig;
  const int cap = kMpListLane * G;
  const int64_t u = bi * kTile + row;
  const uint4* rbits = a.bits + u * a.bwidth;
  const int32_t* cols = bcol + bi * a.bwidth;
  const float* wrow = a.weights ? a.weights + (bi * a.bwidth * kTile + row) * kTile
                                : nullptr;
  const bool vec = a.c % 4 == 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  bool lowered = false;
  for (int c0 = 0; c0 < a.c; c0 += CB) {
    const int left = a.c - c0;
    float acc[CB], old[CB];  // old: the row's own values, this lane's columns
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      acc[j] = kFInf;
      old[j] = valid && j % G == lig && j < left ? __ldca(d + u * a.c + c0 + j) : kFInf;
    }
    for (int s0 = 0; s0 < a.bwidth; s0 += G * kMpSlots) {
      uint4 w[kMpSlots];
      int32_t col0[kMpSlots];
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < kMpSlots; ++t) {
        const int s = s0 + lig + G * t;
        int32_t bj = -1;
        w[t] = zero;
        if (valid && s < a.bwidth) {
          bj = cols[s];
          w[t] = __ldg(rbits + s);
        }
        if (bj < 0 || bj >= a.nblocks) w[t] = zero;  // a sentinel slot
        col0[t] = bj * kTile;
        cnt += __popc(w[t].x) + __popc(w[t].y) + __popc(w[t].z) + __popc(w[t].w);
      }
      int off = cnt;  // the group's inclusive scan, then exclusive
      for (int o = 1; o < G; o <<= 1) {
        const int y = __shfl_up_sync(kAll, off, o, G);
        if (lig >= o) off += y;
      }
      const int total = __shfl_sync(kAll, off, G - 1, G);
      off -= cnt;
      const int most = __reduce_max_sync(kAll, total);  // the warp's passes
      for (int base = 0; base < most; base += cap) {
        int at = off;
#pragma unroll
        for (int t = 0; t < kMpSlots; ++t) {
          const int wo = (s0 + lig + G * t) * kTile * kTile;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t m = word_of(w[t], k);
            while (m) {
              const int j = __ffs(m) - 1;
              m &= m - 1u;
              if (at >= base && at < base + cap) {
                list[at - base] = make_int2(col0[t] + 32 * k + j, wo + 32 * k + j);
              }
              ++at;
            }
          }
        }
        __syncwarp();
        const int here = total - base < cap ? (total > base ? total - base : 0) : cap;
        for (int e0 = 0; e0 < here; e0 += G * kGather) {
          float wt[kGather];
          float x[kGather][CB];
#pragma unroll
          for (int h = 0; h < kGather; ++h) {
            const int e = e0 + lig + G * h;
            wt[h] = kFInf;
#pragma unroll
            for (int j = 0; j < CB; ++j) x[h][j] = kFInf;
            if (e < here) {
              const int2 en = list[e];
              wt[h] = wrow ? __ldg(wrow + en.y) : 0.0f;
              load_cols<CB>(d + (int64_t)en.x * a.c + c0, left, vec, x[h]);
            }
          }
#pragma unroll
          for (int h = 0; h < kGather; ++h) {
#pragma unroll
            for (int j = 0; j < CB; ++j) acc[j] = fminf(acc[j], __fadd_rn(wt[h], x[h][j]));
          }
        }
        __syncwarp();  // the list is rewritten for the next pass
      }
    }
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        acc[j] = fminf(acc[j], __shfl_xor_sync(kAll, acc[j], o, G));
      }
    }
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (valid && j % G == lig && j < left) {
        const float nv = fminf(old[j], acc[j]);
        nd[u * a.c + c0 + j] = nv;
        lowered |= nv < old[j];
      }
    }
  }
  return lowered;
}

// One sweep r over the worklist in sh (A active block rows): the grid's lane
// groups, or block 0's alone (solo), walk the active rows and mark the block
// rows they lowered in sh.mine. On the grid each block then ORs its marks
// into chg_of(r), one atomicOr a word; block 0 alone keeps them there.
template <int CB>
__device__ void minplus_sweep(const MinplusArgs& a, MpShared& sh,
                              const int32_t* bcol, int64_t r, int W, int A,
                              bool solo) {
  const int64_t plane_len = a.nblocks * kTile * (int64_t)a.c;
  const float* d = a.planes + (r & 1) * plane_len;
  float* nd = a.planes + ((r + 1) & 1) * plane_len;
  const Group grp(a.group);
  int2* list = sh.list + (threadIdx.x / grp.G) * (kMpListLane * grp.G);
  const int64_t per = kMpThreads / grp.G;
  const int64_t groups = solo ? per : per * gridDim.x;
  // the warp's first group's unit: the warp walks its units together
  const int64_t wq = (solo ? 0 : (int64_t)blockIdx.x * per) + (threadIdx.x & ~31) / grp.G;
  const int in_warp = (threadIdx.x & 31) / grp.G;
  const int64_t units = (int64_t)A * kTile;
  for (int64_t q0 = wq; q0 < units; q0 += groups) {
    const int64_t q = q0 + in_warp;
    const bool valid = q < units;
    const int64_t bi = valid ? nth_active(sh, W, (int)(q / kTile)) : 0;
    if (sweep_row<CB>(a, bcol, d, nd, bi, (int)(q % kTile), valid, grp, list)) {
      const uint32_t bit = 1u << (bi & 31);
      if (!(sh.mine[bi >> 5] & bit)) atomicOr(&sh.mine[bi >> 5], bit);
    }
  }
  __syncthreads();
  if (solo) return;
  uint32_t* out = chg_of(a, r);
  for (int w = threadIdx.x; w < W; w += kMpThreads) {
    if (sh.mine[w]) atomicOr(out + w, sh.mine[w]);
  }
}

template <int CB>
__global__ void __launch_bounds__(kMpThreads, 1)
minplus_fixpoint_kernel(MinplusArgs a) {
  __shared__ MpShared sh;
  const int W = (int)((a.nblocks + 31) >> 5);
  const int32_t* bcol = a.bcol;
  if (a.bcol_shared) {  // read-only for the launch: one copy a block
    int32_t* cached = reinterpret_cast<int32_t*>(stage_bits);
    const int n = (int)a.nblocks * a.bwidth;
    for (int i = threadIdx.x; i < n; i += kMpThreads) cached[i] = __ldg(a.bcol + i);
    __syncthreads();
    bcol = cached;
  }
  const int64_t solo_cap = (int64_t)kMpSoloRounds * kMpThreads;
  u64 seen = 0;         // the park epoch this block knows
  bool alone = false;   // block 0 runs a one-block stretch
  int64_t r = 0, solo_sweeps = 0, grid_sweeps = 0, active = 0;
  for (;;) {
    const int A = r < a.max_rounds ? worklist(a, sh, bcol, r, W, alone) : 0;
    if (A == 0) {  // the last sweep lowered nothing, or max_rounds ran
      if (alone && threadIdx.x == 0) bibfs::unpark(a.ctl + kEpoch, seen + 1);
      break;
    }
    const bool solo = (int64_t)A * kTile * a.group <= solo_cap;
    if (solo && blockIdx.x != 0) {
      const u64 e = bibfs::park(a.ctl + kEpoch, seen, a.ctl + kBeat,
                                a.ctl + kErr, (u64)kErrBarrier, kWaitNs);
      if (e == bibfs::kParkGaveUp || (e & 1ull)) break;
      seen = e;
      r = (int64_t)ld_volatile(a.ctl + kSweep);
      continue;
    }
    if (solo) {
      alone = true;
    } else if (alone) {  // the stretch ends: the grid resumes at sweep r
      if (threadIdx.x == 0) {
        a.ctl[kSweep] = (u64)r;
        bibfs::unpark(a.ctl + kEpoch, seen + 2);
      }
      seen += 2;
      alone = false;
    }
    if (blockIdx.x == 0) {  // every block read it two sweeps ago
      uint32_t* next = chg_of(a, r + 1);
      for (int w = threadIdx.x; w < W; w += kMpThreads) next[w] = 0u;
    }
    minplus_sweep<CB>(a, sh, bcol, r, W, A, solo);
    if (solo) {
      __syncthreads();
      if (threadIdx.x == 0) *reinterpret_cast<volatile u64*>(a.ctl + kBeat) = (u64)r + 1;
      ++solo_sweeps;
    } else {
      if (!barrier(a.ctl)) break;
      ++grid_sweeps;
    }
    active += A;
    ++r;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const u64 err = ld_volatile(a.ctl + kErr);
    a.status[kMpRounds] = err ? -(int64_t)err : r;
    a.status[kMpSolo] = solo_sweeps;
    a.status[kMpGrid] = grid_sweeps;
    a.status[kMpActive] = active;
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
int coop_blocks(K kernel, int threads, int64_t items, int* blocks, size_t dyn = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t fit = (int64_t)sms * per_sm;
  *blocks = (int)(items < fit ? (items > 0 ? items : 1) : fit);
  return 0;
}

template <class K>
int launch_coop(K kernel, int threads, int64_t items, void* args, void* stream,
                size_t dyn = 0) {
  int blocks = 0;
  const int rc = coop_blocks(kernel, threads, items, &blocks, dyn);
  if (rc != 0) return rc;
  void* argv[] = {args};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(threads), argv, dyn,
                                          (cudaStream_t)stream);
}

}  // namespace

// One (min, +) fixpoint (module comment) in one cooperative launch over the
// packed tile rows bits int32 [nblocks, 128, bwidth, 4] (16-byte aligned):
// weights f32 [nblocks, bwidth, 128, 128] (finite exactly at the set bits),
// or null for labels (0 on every edge); bcol int32 [nblocks, bwidth]; planes
// f32 [2, nblocks * 128, c] with the start in buffer 0 (the result lands in
// buffer rounds & 1); ctl int64 [8 + 3 ceil(nblocks / 64)] zero; status [4]
// int64 receives the rounds (or minus the error code), the sweeps run in
// one block and on the grid, and the active block rows summed over sweeps.
// The launch's error code is returned.
extern "C" int bibfs_minplus_fixpoint(const void* bits, const void* weights,
                                      const void* bcol, int64_t nblocks,
                                      int bwidth, int c, int64_t max_rounds,
                                      void* planes, void* ctl, void* status,
                                      void* stream) {
  if (nblocks < 1 || nblocks > kMpMaxRows || bwidth < 1 || c < 1 ||
      max_rounds < 1 || (uintptr_t)bits % 16) {
    return (int)cudaErrorInvalidValue;
  }
  MinplusArgs a;
  a.bits = (const uint4*)bits;
  a.weights = (const float*)weights;
  a.bcol = (const int32_t*)bcol;
  a.nblocks = nblocks;
  a.bwidth = bwidth;
  a.c = c;
  // lanes a row: enough that a lane loads at most kMpSlots slots at once
  a.group = 1;
  while (a.group < 32 && a.group * kMpSlots < bwidth) a.group <<= 1;
  a.max_rounds = max_rounds;
  a.planes = (float*)planes;
  a.ctl = (u64*)ctl;
  a.map_words = (int)(2 * ((nblocks + 63) / 64));
  a.status = (int64_t*)status;
  const int64_t slots = nblocks * bwidth;
  a.bcol_shared = slots <= kMpBcolCache;
  const size_t dyn = a.bcol_shared ? (size_t)slots * sizeof(int32_t) : 0;
  const int which = c == 1 ? 0 : c <= 4 ? 1 : 2;
  void (*const kernel)(MinplusArgs) =
      which == 0 ? minplus_fixpoint_kernel<1>
                 : which == 1 ? minplus_fixpoint_kernel<4> : minplus_fixpoint_kernel<8>;
  static bool ready[3] = {false, false, false};  // bcol's cache allowed
  if (!ready[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMpBcolCache * (int)sizeof(int32_t));
    if (err != cudaSuccess) return (int)err;
    ready[which] = true;
  }
  // sweep 0's lane groups over every row, at most the card's resident blocks
  const int64_t want = (nblocks * kTile * a.group + kMpThreads - 1) / kMpThreads;
  return launch_coop(kernel, kMpThreads, want, &a, stream, dyn);
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
  return launch_coop(pagerank_kernel, kThreads, nblocks * kTile / kPrRows, &a,
                     stream);
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
