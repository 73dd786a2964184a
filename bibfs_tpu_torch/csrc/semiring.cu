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
//
// Exactness. Distances, labels and counts are integers: the (min, +) sums
// are exact in f32 below 2^24 (the serving gates hold that bound) and a min
// does not depend on order, so the planes equal the reference's bit for bit.
// The triangle count is integer arithmetic throughout. PageRank's ranks are
// f32 sums: every reduction has one fixed order (a warp's butterfly, a
// block's warps in turn, the work items in index order), so a run gives the
// same ranks as the last, held to the reference by a tolerance.
//
// Design.
// 1. Persistent cooperative grids with a grid barrier between sweeps or
//    power steps (level_common.cuh grid_barrier); the planes ping-pong
//    between two buffers (Jacobi: a sweep reads only the buffer the last one
//    finished, so its rounds are the reference's) and a round's "changed"
//    flag lives in one of three words of the launch's zeroed working block
//    (the one two rounds ahead is cleared by block 0 at the start of a round:
//    every block has read it by then). The host reads one status word.
// 2. A work item is 32 rows of one block row; its 8 warps take 4 rows each,
//    a warp's lanes the in-tile columns v = lane + 32 k (each 128-wide tile
//    row is four coalesced loads; a thread per row would read a 512-byte
//    stride). For each stored tile of the block row the block stages the
//    plane's column block transposed in shared memory ([columns][128], no
//    bank conflicts) and skips the tile when that block holds nothing that
//    can matter (all +inf for a (min, +) sweep, all zero for a power step);
//    sentinel slots (bcol == nblocks) are skipped unread.
// 3. Triangles: an entry of (A @ P) * P is nonzero only where P is, i.e. at
//    an edge (x, u) with x in the chunk, and there it is the number of
//    common neighbours of x and u. A block takes one chunk row x; its warps
//    find x's edges in its tile rows. The edges of one slot share u's block
//    row, so a warp first lists the block columns rows x / 128 and u / 128
//    both hold (a binary search a lane: bcol rows ascend, sentinels last, as
//    graph/blocked.py builds them); then for each edge a lane ANDs one 32-bit
//    word of the two 128-byte tile rows a listed column (row x's staged in
//    shared memory, u's loads independent of each other) and counts the
//    common bytes by popcount. One int64 atomicAdd a block.
//
// Bounds on the H100: a sweep or power step reads every stored tile the
// skip rule keeps and the plane; a triangle chunk needs the edges' tile
// rows, far less than the dense product's 2 nnz_tiles 128^2 256 int8
// operations.

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

// ---- D2: PageRank -------------------------------------------------------------

struct PagerankArgs {
  const int8_t* tab;
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
  float* part;            // [2 parity][2: delta, mass][items]
  u64* ctl;
  int64_t* status;        // [0]: iterations or -error, [1]: delta's bits
};

// The items' partial sums of one kind, in item order: warp 0's lanes take
// items lane, lane + 32, ... in turn, then the butterfly. Every block
// computes the same total.
__device__ float sum_items(const float* p, int64_t items) {
  __shared__ float total;
  if (threadIdx.x < 32) {
    float x = 0.0f;
    for (int64_t i = threadIdx.x; i < items; i += 32) x = __fadd_rn(x, __ldcg(p + i));
    x = warp_sum(x);
    if (threadIdx.x == 0) total = x;
  }
  __syncthreads();
  const float t = total;
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads) pagerank_kernel(PagerankArgs a) {
  __shared__ float ct[kTile];
  __shared__ float red[kWarps][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_pad = a.nblocks * kTile;
  const int64_t items = a.nblocks * kParts;
  const float nf = (float)a.n;
  // the start: r = mask / n, and the mass of its dangling live rows
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    if (warp == 0) {
      const int64_t u = item * kItemRows + lane;
      const float x = u < a.n ? __fdiv_rn(1.0f, nf) : 0.0f;
      a.ranks[u] = x;
      const float m = warp_sum(__ldg(a.deg + u) > 0 ? 0.0f : x);
      if (lane == 0) a.part[items + item] = m;  // parity 0, mass
    }
  }
  int64_t it = 0;
  float delta = kFInf;
  bool ok = barrier(a.ctl);
  float mass = ok ? sum_items(a.part + items, items) : 0.0f;
  while (ok && delta > a.tol && it < a.max_iters) {
    const float* cur = a.ranks + (it & 1) * n_pad;
    float* nxt = a.ranks + ((it + 1) & 1) * n_pad;
    float* out = a.part + ((it + 1) & 1) * 2 * items;
    const float spread = __fdiv_rn(mass, nf);
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      const int64_t bi = item / kParts;
      const int row0 = (int)(item % kParts) * kItemRows + warp * kRowsPerWarp;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.0f;
      for (int s = 0; s < a.bwidth; ++s) {
        const int32_t bj = __ldg(a.bcol + bi * a.bwidth + s);
        if (bj < 0 || bj >= a.nblocks) continue;
        __syncthreads();
        int nonzero = 0;
        if (threadIdx.x < kTile) {
          const int64_t v = (int64_t)bj * kTile + threadIdx.x;
          const int32_t dg = __ldg(a.deg + v);
          const float x = dg > 0 ? __fdiv_rn(__ldcg(cur + v), (float)dg) : 0.0f;
          ct[threadIdx.x] = x;
          nonzero = x != 0.0f;
        }
        if (!__syncthreads_or(nonzero)) continue;
        const int64_t tile0 = (bi * a.bwidth + s) * (int64_t)kTile * kTile;
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int8_t* row = a.tab + tile0 + (int64_t)(row0 + j) * kTile;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (__ldg(row + lane + 32 * k)) acc[j] = __fadd_rn(acc[j], ct[lane + 32 * k]);
          }
        }
      }
      float dsum = 0.0f, msum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int64_t u = bi * kTile + row0 + j;
        const float y = warp_sum(acc[j]);
        const float rn = u < a.n
            ? __fadd_rn(a.base, __fmul_rn(a.damping, __fadd_rn(y, spread)))
            : 0.0f;
        const float old = __ldcg(cur + u);
        if (lane == 0) nxt[u] = rn;
        dsum = __fadd_rn(dsum, fabsf(__fsub_rn(rn, old)));
        if (u < a.n && __ldg(a.deg + u) == 0) msum = __fadd_rn(msum, rn);
      }
      if (lane == 0) {
        red[warp][0] = dsum;
        red[warp][1] = msum;
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
    delta = sum_items(out, items);
    mass = sum_items(out + items, items);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const u64 err = ld_volatile(a.ctl + kErr);
    a.status[0] = err ? -(int64_t)err : it;
    a.status[1] = (int64_t)__float_as_uint(delta);
  }
}

// ---- D3: one chunk's triangle count ---------------------------------------------

// the widest block row tricount_kernel takes: its shared memory holds row x's
// bwidth tile rows and each warp's list of matched slots (160 B a slot)
constexpr int kTriMaxWidth = 300;

extern __shared__ __align__(16) uint32_t tri_smem[];

__global__ void __launch_bounds__(kThreads)
tricount_kernel(const int8_t* __restrict__ tab, const int32_t* __restrict__ bcol,
                int64_t nblocks, int bwidth, int64_t c0, u64* out) {
  __shared__ u64 red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t x = c0 + blockIdx.x;
  const int64_t bx = x / kTile;
  const int xr = (int)(x % kTile);
  const int32_t* cols_x = bcol + bx * bwidth;
  constexpr int64_t kTileWords = kTile * kTile / 4;
  // row x's 128-byte tile rows, a slot's 32 words apart (zero at sentinels)
  uint32_t* rowx = tri_smem;
  for (int idx = threadIdx.x; idx < bwidth * 32; idx += kThreads) {
    const int s = idx >> 5;
    const int32_t bj = __ldg(cols_x + s);
    rowx[idx] = bj >= 0 && bj < nblocks
        ? __ldg(reinterpret_cast<const uint32_t*>(tab) +
                (bx * bwidth + s) * kTileWords + (int64_t)xr * 32 + (idx & 31))
        : 0u;
  }
  // this warp's matched slots (i << 16 | k): bcol[bx, i] == bcol[bu, k]
  int32_t* matched = reinterpret_cast<int32_t*>(tri_smem + bwidth * 32) + warp * bwidth;
  __syncthreads();
  u64 total = 0;
  for (int s = warp; s < bwidth; s += kWarps) {
    const int32_t bu = __ldg(cols_x + s);
    if (bu < 0 || bu >= nblocks) continue;
    // the block columns both rows hold: each lane looks one of row bu's up
    // in row bx's (ascending, sentinels last) by binary search
    const int32_t* cols_u = bcol + (int64_t)bu * bwidth;
    int m = 0;
    for (int k0 = 0; k0 < bwidth; k0 += 32) {
      const int k = k0 + lane;
      const int32_t ck = k < bwidth ? __ldg(cols_u + k) : (int32_t)nblocks;
      int lo = 0, hi = bwidth;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(cols_x + mid) < ck) lo = mid + 1; else hi = mid;
      }
      const bool hit = ck >= 0 && ck < nblocks && lo < bwidth && __ldg(cols_x + lo) == ck;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hit) matched[m + __popc(hits & ((1u << lane) - 1u))] = (lo << 16) | k;
      m += __popc(hits);
    }
    __syncwarp();
    const uint32_t word = rowx[s * 32 + lane];  // bytes 4 lane .. 4 lane + 3
    const uint32_t* urows = reinterpret_cast<const uint32_t*>(tab) +
                            (int64_t)bu * bwidth * kTileWords + lane;
#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
      unsigned edges = __ballot_sync(0xffffffffu, (word >> (8 * b)) & 0xffu);
      while (edges) {
        const int l = __ffs(edges) - 1;
        edges &= edges - 1;
        const uint32_t* urow = urows + (int64_t)(4 * l + b) * 32;  // u = bu 128 + 4 l + b
        uint32_t cnt = 0;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const int32_t ik = matched[j];
          cnt += __popc(rowx[(ik >> 16) * 32 + lane] &
                        __ldg(urow + (int64_t)(ik & 0xffff) * kTileWords));
        }
        total += cnt;
      }
    }
    __syncwarp();  // the list is rewritten for the warp's next slot
  }
  // each byte of a 0/1 row is one bit of the popcount: total is the sum over
  // x's edges of the common neighbours, counted by the 32 lanes' words
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 t = 0;
    for (int w = 0; w < kWarps; ++w) t += red[w];
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

// One PageRank solve (module comment) in one cooperative launch over the int8
// tiles, deg int32 [n_pad] (0 on pad rows), n live rows; ranks f32 [2, n_pad]
// (the result in buffer iterations & 1), part f32 [2, 2, nblocks * 4]
// scratch, ctl [8] int64 zero; status [2] int64 receives the iterations (or
// minus the error code) and the last delta's f32 bits.
extern "C" int bibfs_pagerank(const void* tab, const void* bcol, const void* deg,
                              int64_t nblocks, int bwidth, int64_t n, float base,
                              float damping, float tol, int64_t max_iters,
                              void* ranks, void* part, void* ctl, void* status,
                              void* stream) {
  if (nblocks < 1 || nblocks * kTile > INT32_MAX || bwidth < 1 || n < 1 ||
      n > nblocks * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  PagerankArgs a;
  a.tab = (const int8_t*)tab;
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
  a.part = (float*)part;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  return launch_coop(pagerank_kernel, nblocks * kParts, &a, stream);
}

// One chunk's ordered-pair triangle total (module comment): rows c0 .. c0 +
// rows - 1 of the int8 tiles (c0 a multiple of 128; bcol rows ascending,
// sentinels last; bwidth at most kTriMaxWidth), added into out int64 [1].
// The launch's error code is returned.
extern "C" int bibfs_tricount(const void* tab, const void* bcol, int64_t nblocks,
                              int bwidth, int64_t c0, int rows, void* out,
                              void* stream) {
  if (nblocks < 1 || bwidth < 1 || bwidth > kTriMaxWidth || c0 < 0 ||
      c0 % kTile || rows < 1 || c0 + rows > nblocks * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)bwidth * (32 + kWarps) * sizeof(uint32_t);
  tricount_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)tab, (const int32_t*)bcol, nblocks, bwidth, c0, (u64*)out);
  return (int)cudaGetLastError();
}
