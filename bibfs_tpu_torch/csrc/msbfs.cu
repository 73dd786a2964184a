// The bitmask-packed multi-source BFS of the oracle's index builds: K
// searches advance together, each vertex carrying Wp uint32 reach words
// (bit k & 31 of word k >> 5 says "search k has reached this vertex"; Wp is
// ceil(K / 32) padded to 1, 2 or a multiple of 4 so a vertex's words are one
// vector load). A level does, for every vertex v and word w:
//
//   acc               = OR over neighbours u of v of pending[u, w]
//   fresh             = acc & ~reach[v, w]
//   reach[v, w]      |= fresh;  pending_next[v, w] = fresh
//   dist[v, 32 w + b] = level for each set bit b of fresh
//
// msbfs_sweep_kernel replaces the XLA while_loop of the reference's ELL
// sweep (bibfs_tpu/ops/msbfs_device.py _build_msbfs_kernel,
// msbfs_device.py:89-232; not a Pallas kernel) and, like it, runs the whole
// level loop in one dispatch. The output is the reference's int16 [n, K]
// plane (-1 unreachable) bit for bit: a search reaches a vertex at its BFS
// level whatever order the ORs take, and each (vertex, search) is stamped
// once.
//
// Bound on the H100: device-memory bytes. A level needs the CSR rows and
// pending words of the vertices with pending bits, the reach words of their
// neighbours, the changed reach and next pending words, and one int16 stamp
// per new (vertex, search) bit; its integer work is a few operations per
// gathered word, far below the card's rate. A sweep's least time is the sum
// over its levels.
//
// Design.
// 1. One persistent launch per sweep. A cooperative grid (no more blocks
//    than the card holds at once, so every block is resident and a waiting
//    block cannot starve one that has not started) loops over the levels
//    [first, last] from a given state, with a grid-wide barrier (arrival
//    tickets on one device counter, a bounded wait) after each level. The
//    card decides when to stop: a level that finds no new bit ends the
//    sweep, and a level above max_level that finds one sets the error word.
//    The host reads a small status block once. One level is the same kernel
//    with first == last. The working words (the barrier's arrivals,
//    frontier sizes and degree sums) live in one block per device and
//    stream that is zero at launch: the last block to leave resets it, so
//    a launch needs no fill before it.
// 2. Frontier-driven levels. The frontier's size and degree sum are summed
//    on the card (one atomic per block) as a level finds it. A sparse level
//    pushes from a list of the frontier: for each listed u and neighbour v
//    it ORs u's pending words that v lacks into v's next pending words with
//    atomicOr; the bits the OR newly set are this level's for v, so the
//    thread that set them ORs them into reach and stamps them (once each),
//    and the first thread to give v a bit lists v for the next level (for
//    K <= 64 one 64-bit atomicOr covers v's words and its old value says
//    who was first; wider states ask a per-vertex level mark).
// 3. A dense-pull switch (Beamer's rule): when the frontier's degree sum
//    reaches dense_edges (a share of the CSR's entries, read by every block
//    after the barrier, so every block decides alike) the level pulls
//    instead: a vertex reads its CSR row once and each neighbour's words in
//    one vector load (uint2 for K <= 64, uint4 for K <= 128), a vertex whose
//    words already hold every search skips its row, and every vertex's next
//    pending words are written, so a pull needs no list and makes none. A
//    push after a pull first lists the frontier with a block-wise
//    compaction (one atomic per block and chunk, not one per vertex).
// 4. Lane groups: `lanes` threads (the graph's mean degree rounded up to a
//    power of two) share a vertex's row in both directions, so a level's
//    latency is a few dependent loads, not a row's length of them.
// The caller's pending words are only read (level `first` reads them);
// later levels rotate through three scratch buffers: a level reads one,
// writes the next, and zeroes in the third the rows of the frontier before
// it (by its list, or the whole buffer when there is none), so the buffer
// the next level pushes into is zero after the one barrier. Lists rotate
// alike; frontier sizes and degree sums through four slots.
// Device state beside reach, dist and the caller's pending words, for n
// vertices: three scratch pending buffers (12 Wp n bytes; one for a single
// level), three lists (12 n), the level marks (4 n, used for K > 64), the
// per-device block of 16 int64 working words and 6 int64 status words.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;  // resident blocks per SM the registers allow
constexpr int kWarps = kThreads / 32;
constexpr unsigned kStage = 2048;  // a block's staged list entries
constexpr int kPull = 2;           // vertices a group pulls at a time
// a barrier wait longer than this ends the sweep with kErrBarrier
constexpr u64 kWaitNs = 5000000000ull;

// the int64 working block, zero at launch and reset by the last block to
// leave: the barrier's arrivals, frontier sizes and degree sums by level
// (four slots each), the compaction's fill counter, the error word and the
// blocks that have left
enum Ctl : int {
  kBar = 0, kCnt = 1, kDeg = 5, kFill = 9, kErr = 10, kExit = 11,
  kCtlLen = 16
};
// the int64 status words the host reads once
enum Status : int {
  kLast = 0,    // the last level that found a new bit
  kDense = 1,   // dense (pull) levels run
  kSparse = 2,  // sparse (push) levels run
  kStErr = 3,   // kErrDepth, kErrBarrier or 0
  kRun = 4,     // levels run
  kGrid = 5,    // blocks of the launch
  kStatusLen = 6
};
enum Err : int { kErrDepth = 1, kErrBarrier = 2 };

struct SweepArgs {
  const int64_t* row_ptr;
  const int32_t* col_ind;
  int32_t n, wp, k, first, last, max_level, lanes;
  int64_t dense_edges;
  const uint32_t* pend;  // the state's pending words, read by level first
  uint32_t* scratch[3];  // the levels' next pending words, in turn
  uint32_t* reach;
  int16_t* dist;
  int32_t* lists;     // [3, n]
  int32_t* mark;      // [n], read when VW == 4
  u64* ctl;           // [kCtlLen], zero at launch and at exit
  int64_t* status;    // [kStatusLen], written by the kernel
  int32_t* flag;      // optional: set to 1 when a level found a new bit
};

using bibfs::arrive;

__device__ __forceinline__ u64 ld_ctl(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// the shared grid barrier (level_common.cuh) on the working block's
// arrivals, giving up with kErrBarrier in the error word after kWaitNs
__device__ __forceinline__ bool grid_barrier(u64* ctl) {
  return bibfs::grid_barrier(ctl + kBar, ctl + kErr, (u64)kErrBarrier, kWaitNs);
}

template <int VW>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&w)[VW]) {
  if constexpr (VW == 4) {
    const uint4 t = __ldcg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (VW == 2) {
    const uint2 t = __ldcg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else {
    w[0] = __ldcg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&w)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

// the bits of word w that belong to a search
__device__ __forceinline__ uint32_t full_word(int w, int k) {
  const int lo = 32 * w;
  if (lo + 32 <= k) return 0xffffffffu;
  if (lo >= k) return 0u;
  return (1u << (k - lo)) - 1u;
}

__device__ __forceinline__ void stamp(int16_t* row, int w, uint32_t bits,
                                      int16_t lv) {
  int16_t* p = row + 32 * w;
  for (; bits; bits &= bits - 1u) p[__ffs(bits) - 1] = lv;
}

// A push lists the next frontier in two steps: entries are staged in the
// block's shared memory (a shared counter, one atomic per group of
// converged lanes) and copied out at the end of the level with one device
// atomic per block; the one counter every block shares sees a few hundred
// atomics a level, not one per vertex. A full stage lists directly.
struct Stage {
  int32_t v[kStage];
  unsigned size;
};

__device__ __forceinline__ void append(Stage& st, int32_t* list, u64* cnt,
                                       int32_t v) {
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned at = 0;
  if (g.thread_rank() == 0) at = atomicAdd(&st.size, g.size());
  at = g.shfl(at, 0) + g.thread_rank();
  if (at < kStage) {
    st.v[at] = v;
    return;
  }
  cg::coalesced_group over = cg::coalesced_threads();
  unsigned base = 0;
  if (over.thread_rank() == 0) base = (unsigned)atomicAdd(cnt, (u64)over.size());
  list[over.shfl(base, 0) + over.thread_rank()] = v;
}

// copy the stage out to the list and empty it (all threads call it)
__device__ __forceinline__ void flush(Stage& st, int32_t* list, u64* cnt) {
  __shared__ unsigned base;
  __syncthreads();
  const unsigned m = st.size < kStage ? st.size : kStage;
  if (threadIdx.x == 0 && m) base = (unsigned)atomicAdd(cnt, (u64)m);
  __syncthreads();
  for (unsigned j = threadIdx.x; j < m; j += kThreads) list[base + j] = st.v[j];
  __syncthreads();
  if (threadIdx.x == 0) st.size = 0;
}

// add every thread's x into *dx and y into *dy: one atomic each per block
// (all threads call it)
__device__ __forceinline__ void block_add(u64 x, u64* dx, u64 y, u64* dy) {
  __shared__ u64 part[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, o);
    y += __shfl_down_sync(0xffffffffu, y, o);
  }
  if (lane == 0) {
    part[0][warp] = x;
    part[1][warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? part[0][lane] : 0ull;
    y = lane < kWarps ? part[1][lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, o);
      y += __shfl_down_sync(0xffffffffu, y, o);
    }
    if (lane == 0 && x) atomicAdd(dx, x);
    if (lane == 0 && y) atomicAdd(dy, y);
  }
}

// List the vertices whose pending words are not all zero: each block scans
// a chunk of kThreads vertices at a time and reserves its entries with one
// atomic on *fill (all threads call it).
template <int VW>
__device__ void compact(const uint32_t* pend, int wp, int64_t n, int32_t* list,
                        u64* fill) {
  __shared__ unsigned warp_at[kWarps];
  __shared__ unsigned block_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t start = (int64_t)blockIdx.x * kThreads; start < n; start += step) {
    const int64_t v = start + threadIdx.x;
    uint32_t any = 0u;
    if (v < n) {
      for (int c = 0; c < wp / VW; ++c) {
        uint32_t w[VW];
        load<VW>(pend + v * wp + c * VW, w);
#pragma unroll
        for (int j = 0; j < VW; ++j) any |= w[j];
      }
    }
    const unsigned on = __ballot_sync(0xffffffffu, any != 0u);
    if (lane == 0) warp_at[warp] = __popc(on);
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = warp_at[w];
        warp_at[w] = total;
        total += c;
      }
      block_at = total ? (unsigned)atomicAdd(fill, (u64)total) : 0u;
    }
    __syncthreads();
    if (any) {
      list[block_at + warp_at[warp] + __popc(on & ((1u << lane) - 1u))] = (int32_t)v;
    }
    __syncthreads();
  }
}

// OR cand into v's next pending words; fresh gets the bits this OR set.
// Returns whether this OR was the first to give v a bit, where one atomic
// covers all of v's words (VW <= 2: the row was zero before the level);
// with more words the caller asks the level mark instead.
template <int VW>
__device__ __forceinline__ bool or_fresh(uint32_t* p, const uint32_t (&cand)[VW],
                                         uint32_t (&fresh)[VW]) {
  if constexpr (VW == 2) {
    const u64 c = (u64)cand[0] | ((u64)cand[1] << 32);
    const u64 old = atomicOr(reinterpret_cast<u64*>(p), c);
    const u64 f = c & ~old;
    fresh[0] = (uint32_t)f;
    fresh[1] = (uint32_t)(f >> 32);
    return old == 0ull;
  } else if constexpr (VW == 1) {
    const uint32_t old = atomicOr(p, cand[0]);
    fresh[0] = cand[0] & ~old;
    return old == 0u;
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      fresh[j] = cand[j] ? cand[j] & ~atomicOr(p + j, cand[j]) : 0u;
    }
    return false;
  }
}

template <int VW>
__device__ __forceinline__ void or_into(uint32_t* p, const uint32_t (&w)[VW]) {
  if constexpr (VW == 2) {
    atomicOr(reinterpret_cast<u64*>(p), (u64)w[0] | ((u64)w[1] << 32));
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      if (w[j]) atomicOr(p + j, w[j]);
    }
  }
}

// Lane groups: `lanes` consecutive threads (a power of two <= 32, from the
// graph's mean degree) share one listed vertex (a push) or one vertex (a
// pull), each taking every lanes-th CSR entry of its row.
struct Lanes {
  int64_t id, count;   // this group, the groups of the grid
  int lane, size;      // the thread's lane in it, its size
  unsigned mask;       // the group's lanes in the warp
  uint32_t own;        // the bits b with b % size == lane: its share of stamps
};

__device__ __forceinline__ Lanes lanes_of(int size) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  Lanes g;
  g.size = size;
  g.id = tid / size;
  g.count = (int64_t)gridDim.x * kThreads / size;
  g.lane = (int)(tid % size);
  const int first = (threadIdx.x & 31) & ~(size - 1);
  g.mask = (size == 32 ? 0xffffffffu : ((1u << size) - 1u)) << first;
  g.own = 0u;
  for (int b = g.lane; b < 32; b += size) g.own |= 1u << b;
  return g;
}

// One step of a dense level for the group g: vertices v0 + u g.count for
// u < kPull, their CSR rows read once and each neighbour's words in one
// vector load, the kPull rows' loads in flight together. Counts the
// vertices that gained a bit and their degrees.
template <int VW>
__device__ __forceinline__ void pull(const SweepArgs& a, const Lanes& g,
                                     int64_t v0, const uint32_t* cur,
                                     uint32_t* nxt, bool stamps, int16_t lv,
                                     u64& cnt_acc, u64& deg_acc) {
  int64_t beg[kPull], end[kPull];
  bool got[kPull];
#pragma unroll
  for (int u = 0; u < kPull; ++u) {
    const int64_t v = v0 + u * g.count;
    beg[u] = v < a.n ? __ldg(a.row_ptr + v) : 0;
    end[u] = v < a.n ? __ldg(a.row_ptr + v + 1) : 0;
    got[u] = false;
  }
  for (int c = 0; c < a.wp / VW; ++c) {
    uint32_t r[kPull][VW], acc[kPull][VW];
    bool skip[kPull];
#pragma unroll
    for (int u = 0; u < kPull; ++u) {
      const int64_t v = v0 + u * g.count;
      skip[u] = v >= a.n;
#pragma unroll
      for (int j = 0; j < VW; ++j) r[u][j] = acc[u][j] = 0u;
      if (skip[u]) continue;
      load<VW>(a.reach + v * a.wp + c * VW, r[u]);
      bool full = true;  // a vertex every search has reached skips its row
#pragma unroll
      for (int j = 0; j < VW; ++j) full &= r[u][j] == full_word(c * VW + j, a.k);
      skip[u] = full;
    }
    for (int64_t t = g.lane;; t += g.size) {
      int64_t col[kPull];
      bool more = false;
#pragma unroll
      for (int u = 0; u < kPull; ++u) {
        const bool in = !skip[u] && beg[u] + t < end[u];
        col[u] = in ? __ldg(a.col_ind + beg[u] + t) : -1;
        more |= in;
      }
      if (!more) break;
#pragma unroll
      for (int u = 0; u < kPull; ++u) {
        if (col[u] < 0) continue;
        uint32_t p[VW];
        load<VW>(cur + col[u] * a.wp + c * VW, p);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[u][j] |= p[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kPull; ++u) {
      const int64_t v = v0 + u * g.count;
      if (v >= a.n) continue;
      bool any = false;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        for (int o = g.size >> 1; o > 0; o >>= 1) {
          acc[u][j] |= __shfl_xor_sync(g.mask, acc[u][j], o);
        }
        acc[u][j] &= ~r[u][j];
        r[u][j] |= acc[u][j];
        any |= acc[u][j] != 0u;
      }
      const int64_t at = v * a.wp + c * VW;
      if (g.lane == 0) {  // only v's group writes v in a dense level
        store<VW>(nxt + at, acc[u]);
        if (any) store<VW>(a.reach + at, r[u]);
      }
      if (any && stamps) {
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          stamp(a.dist + v * a.k, c * VW + j, acc[u][j] & g.own, lv);
        }
      }
      got[u] |= any;
    }
  }
#pragma unroll
  for (int u = 0; u < kPull; ++u) {
    if (got[u] && g.lane == 0) {
      ++cnt_acc;
      deg_acc += (u64)(end[u] - beg[u]);
    }
  }
}

// the pending words level `first + i` reads, and the ones it writes
__device__ __forceinline__ const uint32_t* cur_of(const SweepArgs& a, int i) {
  return i == 0 ? a.pend : a.scratch[(i - 1) % 3];
}

// The levels [first, last]; returns early (the error word set) when a
// grid barrier times out.
template <int VW>
__device__ void sweep_levels(const SweepArgs& a) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t n = a.n;
  const int nvec = a.wp / VW;
  u64* ctl = a.ctl;
  __shared__ Stage stage;
  if (threadIdx.x == 0) stage.size = 0;  // read after the barrier's sync
  // zero the scratch buffers; count the vertices with pending bits and
  // their degrees
  u64 cnt_acc = 0, deg_acc = 0;
  for (int64_t v = tid; v < n; v += stride) {
    uint32_t any = 0u;
    for (int c = 0; c < nvec; ++c) {
      const int64_t at = v * a.wp + c * VW;
      const uint32_t z[VW] = {};
      store<VW>(a.scratch[0] + at, z);
      if (a.scratch[1] != a.scratch[0]) {
        store<VW>(a.scratch[1] + at, z);
        store<VW>(a.scratch[2] + at, z);
      }
      uint32_t w[VW];
      load<VW>(a.pend + at, w);
#pragma unroll
      for (int j = 0; j < VW; ++j) any |= w[j];
    }
    if (VW == 4) a.mark[v] = 0;
    if (any) {
      ++cnt_acc;
      deg_acc += (u64)(__ldg(a.row_ptr + v + 1) - __ldg(a.row_ptr + v));
    }
  }
  block_add(cnt_acc, ctl + kCnt, deg_acc, ctl + kDeg);
  if (!grid_barrier(ctl)) return;

  const Lanes g = lanes_of(a.lanes);
  int dense_levels = 0, sparse_levels = 0, run = 0, last_new = a.first - 1;
  int err = 0;
  // the frontier of this level and of the one before: sizes, degree sum,
  // and whether a list of it exists (a push made it, or a compaction)
  int64_t size = (int64_t)ld_ctl(ctl + kCnt), old_size = 0;
  int64_t deg = (int64_t)ld_ctl(ctl + kDeg);
  bool listed = false, old_listed = true;
  for (int i = 0;; ++i) {
    const int level = a.first + i;
    if (size == 0 || level > a.last) break;
    const uint32_t* cur = cur_of(a, i);
    uint32_t* nxt = a.scratch[i % 3];
    // the next level's buffer: it holds the frontier of level i - 1 when
    // i >= 2, and is still zero from the pre-pass before that
    uint32_t* old = i >= 2 ? a.scratch[(i + 1) % 3] : nullptr;
    int32_t* list = a.lists + (int64_t)(i % 3) * n;
    int32_t* next_list = a.lists + (int64_t)((i + 1) % 3) * n;
    const int32_t* old_list = a.lists + (int64_t)((i + 2) % 3) * n;
    u64* next_cnt = ctl + kCnt + (i + 1) % 4;
    u64* next_deg = ctl + kDeg + (i + 1) % 4;
    const bool dense = deg >= a.dense_edges;  // the same in every block
    if (lead) {  // the slots the next level fills; no block reads them now
      ctl[kCnt + (i + 2) % 4] = 0;
      ctl[kDeg + (i + 2) % 4] = 0;
    }
    if (!dense && !listed) {  // a push walks a list of its frontier
      compact<VW>(cur, a.wp, n, list, ctl + kFill);
      if (!grid_barrier(ctl)) return;
      if (lead) ctl[kFill] = 0;  // the next compaction is levels away
      listed = true;
    }
    // zero the pending rows of the level before: the next level may push
    // there (by its list, or the whole buffer when no list was made)
    const uint32_t z[VW] = {};
    if (old != nullptr && old_listed) {
      for (int64_t f = tid; f < old_size; f += stride) {
        const int64_t u = __ldcg(old_list + f);
        for (int c = 0; c < nvec; ++c) store<VW>(old + u * a.wp + c * VW, z);
      }
    } else if (old != nullptr) {
      for (int64_t at = tid * VW; at < n * a.wp; at += stride * VW) {
        store<VW>(old + at, z);
      }
    }
    const bool stamps = level <= a.max_level;
    const int16_t lv = (int16_t)level;
    cnt_acc = 0;
    deg_acc = 0;
    if (dense) {
      // pull: a group per vertex, kPull vertices at a time; every
      // vertex's next pending words are written, zero or not
      for (int64_t v = g.id; v < n; v += kPull * g.count) {
        pull<VW>(a, g, v, cur, nxt, stamps, lv, cnt_acc, deg_acc);
      }
    } else {
      // push from the list: a group per listed vertex
      for (int64_t f = g.id; f < size; f += g.count) {
        const int64_t u = __ldcg(list + f);
        const int64_t beg = __ldg(a.row_ptr + u), end = __ldg(a.row_ptr + u + 1);
        for (int c = 0; c < nvec; ++c) {
          uint32_t p[VW];
          load<VW>(cur + u * a.wp + c * VW, p);
          uint32_t some = 0u;
#pragma unroll
          for (int j = 0; j < VW; ++j) some |= p[j];
          if (!some) continue;
          for (int64_t e = beg + g.lane; e < end; e += g.size) {
            const int64_t v = __ldg(a.col_ind + e);
            const int64_t at = v * a.wp + c * VW;
            uint32_t r[VW], cand[VW], fresh[VW];
            load<VW>(a.reach + at, r);
            uint32_t want = 0u;
#pragma unroll
            for (int j = 0; j < VW; ++j) {
              cand[j] = p[j] & ~r[j];
              want |= cand[j];
            }
            if (!want) continue;
            // the bits this OR set are v's new bits: stamped here, once
            const bool first = or_fresh<VW>(nxt + at, cand, fresh);
            uint32_t got = 0u;
#pragma unroll
            for (int j = 0; j < VW; ++j) got |= fresh[j];
            if (!got) continue;
            or_into<VW>(a.reach + at, fresh);
            if (stamps) {
#pragma unroll
              for (int j = 0; j < VW; ++j) stamp(a.dist + v * a.k, c * VW + j, fresh[j], lv);
            }
            if (VW == 4 ? atomicExch(a.mark + v, level) != level : first) {
              append(stage, next_list, next_cnt, (int32_t)v);
              deg_acc += (u64)(__ldg(a.row_ptr + v + 1) - __ldg(a.row_ptr + v));
            }
          }
        }
      }
    }
    if (!dense) flush(stage, next_list, next_cnt);
    block_add(cnt_acc, next_cnt, deg_acc, next_deg);
    ++run;
    if (dense) ++dense_levels; else ++sparse_levels;
    if (!grid_barrier(ctl)) return;
    old_size = size;
    old_listed = listed;
    size = (int64_t)ld_ctl(next_cnt);
    deg = (int64_t)ld_ctl(next_deg);
    listed = !dense;  // a push listed the next frontier as it found it
    if (size > 0) {
      last_new = level;
      if (level > a.max_level) {  // a distance the int16 plane cannot hold
        err = kErrDepth;
        break;
      }
    }
  }
  if (lead) {
    a.status[kLast] = last_new;
    a.status[kDense] = dense_levels;
    a.status[kSparse] = sparse_levels;
    a.status[kRun] = run;
    a.status[kGrid] = gridDim.x;
    if (err) atomicExch(ctl + kErr, (u64)err);
    if (a.flag != nullptr && last_new >= a.first) *a.flag = 1;
  }
}

template <int VW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
msbfs_sweep_kernel(const SweepArgs a) {
  sweep_levels<VW>(a);
  // Leave: the last block out has seen every other block pass its last
  // barrier (or give up on one), so it can publish the error word and
  // zero the working block for the next launch.
  __syncthreads();
  if (threadIdx.x == 0 && arrive(a.ctl + kExit) + 1 == gridDim.x) {
    a.status[kStErr] = (int64_t)ld_ctl(a.ctl + kErr);
    for (int j = 0; j < kCtlLen; ++j) a.ctl[j] = 0;
  }
}

template <int VW>
int launch_sweep(SweepArgs a, void* stream) {
  static int sms = 0, per_sm = 0;  // per instantiation, on first use
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, msbfs_sweep_kernel<VW>, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  // every block resident at once (the barrier's premise), and no more
  // blocks than the vertices need
  const int64_t fit = (int64_t)sms * per_sm;
  const int64_t need = ((int64_t)a.n + kThreads - 1) / kThreads;
  const int blocks = (int)(need < fit ? (need > 0 ? need : 1) : fit);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)msbfs_sweep_kernel<VW>, dim3(blocks), dim3(kThreads), args,
      0, (cudaStream_t)stream);
}

}  // namespace

// Levels [first, last] of the sweep from the state (pending, reach, dist),
// in one cooperative launch; pending is only read. wp is 1, 2 or a
// multiple of 4; s0, s1, s2 are [n, wp] scratch (all three the same buffer
// when first == last), lists [3 n] and mark [n] int32 scratch; ctl is the
// stream's [16] int64 working block, zero before the launch and after it;
// status [6] int64 receives the last level with a new bit, the dense and
// sparse levels, the error word, the levels run and the blocks; flag may be
// null; lanes (a power of two <= 32) threads share a vertex. The launch's
// error code is returned.
extern "C" int bibfs_msbfs_sweep(const void* row_ptr, const void* col_ind,
                                 int64_t n, int wp, int k, int64_t dense_edges,
                                 int lanes, const void* pending, void* s0,
                                 void* s1, void* s2, void* reach, void* dist,
                                 void* lists, void* mark, void* ctl,
                                 void* status, int first, int last,
                                 int max_level, void* flag, void* stream) {
  if (n < 0 || n > INT32_MAX || wp < 1 || (wp > 2 && wp % 4) || first < 1 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  SweepArgs a;
  a.row_ptr = (const int64_t*)row_ptr;
  a.col_ind = (const int32_t*)col_ind;
  a.n = (int32_t)n;
  a.wp = wp;
  a.k = k;
  a.first = first;
  a.last = last;
  a.max_level = max_level;
  a.lanes = lanes;
  a.dense_edges = dense_edges;
  a.pend = (const uint32_t*)pending;
  a.scratch[0] = (uint32_t*)s0;
  a.scratch[1] = (uint32_t*)s1;
  a.scratch[2] = (uint32_t*)s2;
  a.reach = (uint32_t*)reach;
  a.dist = (int16_t*)dist;
  a.lists = (int32_t*)lists;
  a.mark = (int32_t*)mark;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  a.flag = (int32_t*)flag;
  if (wp >= 4) return launch_sweep<4>(a, stream);
  if (wp == 2) return launch_sweep<2>(a, stream);
  return launch_sweep<1>(a, stream);
}
