// The device rungs of two query kinds, each one persistent cooperative
// launch per solve.
//
// delta_stepping_kernel replaces the XLA while_loop of the reference's
// device delta-stepping (bibfs_tpu/solvers/query_device.py
// _build_delta_kernel, query_device.py:50-126; not a Pallas kernel): the
// weighted single-source search to one target over an ELL table, as
// bucketed relaxation passes. With `tgt` int32 [n_pad, width] (dead slots
// point at the dump row n_pad), `wts` f32 [n_pad, width] and the f32 bucket
// width delta, bucket bi holds the vertices whose distance d has
// lo <= d < hi, lo = f32(bi) * delta and hi = f32(bi + 1) * delta. A pass
// over a class of edges (light: w <= delta, heavy: the rest) is a pull:
//
//   cand[v, j] = dist[tgt[v, j]] + wts[v, j]  where tgt[v, j] is in bucket
//                                              bi and slot j in the class
//   next[v]    = min(dist[v], min_j cand[v, j])
//
// reading one distance buffer and writing the other (Jacobi: the reference
// relaxes from the distances before the pass, and the number of light
// passes, hence the relaxation count, depends on it). A bucket runs light
// passes until one changes nothing, then one heavy pass; the search goes on
// while some finite distance is >= lo and dist[dst] >= lo. The output is the
// reference's: the distances bit for bit (every sum is __fadd_rn and every
// bound __fmul_rn, so nothing is contracted into an FMA), the non-empty
// buckets and the relaxations (candidates below F_INF, summed over passes).
//
// restricted_sweep_kernel replaces the XLA while_loop of the reference's
// batched restricted BFS (query_device.py:226-291 _build_restricted_kernel;
// not a Pallas kernel): the spur candidates of one Yen iteration as the
// columns of an int32 [n, B] distance plane over the CSR, 32 candidates a
// uint32 word. It is the bit-plane level of msbfs.cu with three changes:
// the state is seeded from the plane (dist 0 at the spur and 1 at the
// allowed first hops, stamped by the caller; the reach words also hold every
// banned node's bit, so a banned node is never stamped), a column freezes
// once its dst is stamped (the level's active bits are the columns whose
// dst was unstamped when the level began, as the reference's `act`), and
// the stamps are int32 levels with no depth limit. A level pulls: for every
// vertex v and word w, want = active & ~reach[v, w]; when want is not zero
// the row ORs its neighbours' frontier words, and the bits of want it finds
// are stamped. Reach and frontier words ping-pong between two buffers, so
// the active mask read from reach[dst] is never the level's own writes.
//
// Bounds on the H100: device-memory bytes. A delta pass reads the ELL
// table (8 bytes a slot) and writes the distance vector; a restricted level
// reads the frontier's CSR rows and words and writes the changed words and
// stamps (md.frontier_bytes's count). Both do a few operations per byte.
//
// Working state: a [16] int64 block per device and stream, zero at launch
// and reset by the last block to leave (the barrier's arrivals, per-pass
// flags in four rotating slots, the relaxation total, the error word, the
// blocks that have left), and [6] int64 status words the host reads once.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr u64 kWaitNs = 5000000000ull;
constexpr float kFInf = 3e38f;          // F_INF: unreachable on the f32 line
constexpr int32_t kInf32 = 1 << 30;     // INF32: unstamped in the int32 plane

enum Ctl : int {
  kBar = 0, kFlag = 1,  // flags: two words a slot, four slots (1..8)
  kRelax = 9, kErr = 10, kExit = 11, kCtlLen = 16
};
enum Err : int { kErrBarrier = 2, kErrLevels = 3 };

__device__ __forceinline__ u64 ld_ctl(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ bool barrier(u64* ctl) {
  return bibfs::grid_barrier(ctl + kBar, ctl + kErr, (u64)kErrBarrier, kWaitNs);
}

// the flag words of pass p; the lead clears the slot of pass p + 2 before
// pass p runs (every block read it before the barrier of pass p - 1 ended)
__device__ __forceinline__ u64* flags_of(u64* ctl, int64_t p) {
  return ctl + kFlag + 2 * (int)(p & 3);
}

// OR every thread's f0 and f1 into the flag words (all threads call it).
// Through a shared word: the barrier reduction (__syncthreads_or) ended
// the restricted sweep with an illegal instruction on the H100.
__device__ __forceinline__ void set_flags(u64* f, bool f0, bool f1) {
  __shared__ int any[2];
  if (threadIdx.x == 0) any[0] = any[1] = 0;
  __syncthreads();
  if (f0) atomicOr(&any[0], 1);
  if (f1) atomicOr(&any[1], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (any[0]) atomicExch(f, 1ull);
    if (any[1]) atomicExch(f + 1, 1ull);
  }
}

// sum every thread's x into *dx, one atomic per block (all threads call it)
__device__ __forceinline__ void block_sum(u64 x, u64* dx) {
  __shared__ u64 part[kThreads / 32];
  x = bibfs::warp_reduce(x, bibfs::SumOp());
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0ull;
    x = bibfs::warp_reduce(x, bibfs::SumOp());
    if (threadIdx.x == 0 && x) atomicAdd(dx, x);
  }
}

// Leave: the last block out has seen every other block pass its last
// barrier (or give up on one); it publishes the relaxation total and the
// error word and zeroes the working block for the next launch.
__device__ __forceinline__ void leave(u64* ctl, int64_t* status, int relax_at,
                                      int err_at) {
  __syncthreads();
  if (threadIdx.x == 0 && bibfs::arrive(ctl + kExit) + 1 == gridDim.x) {
    if (relax_at >= 0) status[relax_at] = (int64_t)ld_ctl(ctl + kRelax);
    status[err_at] = (int64_t)ld_ctl(ctl + kErr);
    for (int j = 0; j < kCtlLen; ++j) ctl[j] = 0;
  }
}

// ---- delta-stepping ---------------------------------------------------------

struct DeltaArgs {
  const int32_t* tgt;
  const float* wts;
  int64_t n_pad;
  int width;
  int32_t src, dst;
  float delta;
  float* dist[2];
  u64* ctl;
  int64_t* status;
};

enum DeltaStatus : int {
  kDCur = 0,      // the buffer holding the final distances
  kDBuckets = 1,  // non-empty buckets
  kDRelax = 2,    // relaxations
  kDPasses = 3,   // relaxation passes
  kDErr = 4,
  kDGrid = 5,
};

// One relaxation pass of the class `heavy` from the bucket [lo, hi):
// cur -> nxt. A light pass flags whether any distance dropped; the heavy
// pass flags whether the bucket held a vertex (from cur) and whether a
// finite distance >= hi remains (the next bucket's pending test, from nxt).
__device__ __forceinline__ void relax_pass(const DeltaArgs& a, const float* cur,
                                           float* nxt, float lo, float hi,
                                           bool heavy, u64* flags, u64& relax) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  bool f0 = false, f1 = false;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < a.n_pad;
       v += stride) {
    const float dv = __ldcg(cur + v);
    float best = dv;
    const int32_t* trow = a.tgt + v * a.width;
    const float* wrow = a.wts + v * a.width;
    for (int j = 0; j < a.width; ++j) {
      const int32_t u = __ldg(trow + j);
      if ((int64_t)u >= a.n_pad) continue;  // a dead slot: the dump row
      const float w = __ldg(wrow + j);
      if ((w <= a.delta) == heavy) continue;  // not this pass's class
      const float du = __ldcg(cur + u);
      if (!(du >= lo && du < hi)) continue;  // not in the bucket
      const float cand = __fadd_rn(du, w);
      if (cand < kFInf) ++relax;
      best = fminf(best, cand);
    }
    nxt[v] = best;
    if (heavy) {
      f0 |= dv >= lo && dv < hi;
      f1 |= best < kFInf && best >= hi;
    } else {
      f0 |= best < dv;
    }
  }
  set_flags(flags, f0, f1);
}

__device__ void delta_run(const DeltaArgs& a) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  u64* ctl = a.ctl;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < a.n_pad;
       v += stride) {
    a.dist[0][v] = v == a.src ? 0.0f : kFInf;
  }
  if (!barrier(ctl)) return;
  int cur = 0;
  int64_t pass = 0, buckets = 0;
  u64 relax = 0;
  bool pending = true;  // bucket 0 holds the source
  for (int64_t bi = 0;; ++bi) {
    const float lo = __fmul_rn((float)bi, a.delta);
    if (!pending || !(__ldcg(a.dist[cur] + a.dst) >= lo)) break;
    const float hi = __fmul_rn((float)(bi + 1), a.delta);
    // light passes to the fixpoint (at least one)
    for (;;) {
      u64* f = flags_of(ctl, pass);
      if (lead) {
        u64* g = flags_of(ctl, pass + 2);
        g[0] = g[1] = 0;
      }
      relax_pass(a, a.dist[cur], a.dist[cur ^ 1], lo, hi, false, f, relax);
      if (!barrier(ctl)) return;
      ++pass;
      cur ^= 1;
      if (ld_ctl(f) == 0) break;
    }
    // the heavy pass, once, from what the bucket settled
    u64* f = flags_of(ctl, pass);
    if (lead) {
      u64* g = flags_of(ctl, pass + 2);
      g[0] = g[1] = 0;
    }
    relax_pass(a, a.dist[cur], a.dist[cur ^ 1], lo, hi, true, f, relax);
    if (!barrier(ctl)) return;
    ++pass;
    cur ^= 1;
    buckets += ld_ctl(f) != 0;
    pending = ld_ctl(f + 1) != 0;
  }
  block_sum(relax, ctl + kRelax);
  if (lead) {
    a.status[kDCur] = cur;
    a.status[kDBuckets] = buckets;
    a.status[kDPasses] = pass;
    a.status[kDGrid] = gridDim.x;
  }
}

__global__ void __launch_bounds__(kThreads)
delta_stepping_kernel(const DeltaArgs a) {
  delta_run(a);
  leave(a.ctl, a.status, kDRelax, kDErr);
}

// ---- the restricted batch BFS ----------------------------------------------

struct SweepArgs {
  const int64_t* row_ptr;
  const int32_t* col_ind;
  int64_t n;
  int b, wp;  // candidate columns, words a vertex (ceil(b / 32))
  int32_t dst;
  int32_t* dist;         // [n, b], seeded, stamped in place
  const int8_t* blocked;  // [n, b], nonzero: banned for that column
  uint32_t* reach[2];    // [n, wp]: stamped or banned
  uint32_t* front[2];    // [n, wp]: stamped at the level before
  u64* ctl;
  int64_t* status;
};

enum SweepStatus : int {
  kSLast = 0,  // the last level that stamped
  kSRun = 1,   // levels run
  kSErr = 2,
  kSGrid = 3,
};

__device__ void sweep_run(const SweepArgs& a) {
  extern __shared__ uint32_t act[];  // [wp]: this level's unfrozen columns
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  u64* ctl = a.ctl;
  // the state from the seeded plane: reach = stamped or banned,
  // front = stamped 1
  bool any = false;
  for (int64_t v = tid; v < a.n; v += stride) {
    for (int w = 0; w < a.wp; ++w) {
      uint32_t r = 0u, f = 0u;
      for (int c = 32 * w; c < 32 * w + 32 && c < a.b; ++c) {
        const int32_t d = a.dist[v * a.b + c];
        const uint32_t bit = 1u << (c & 31);
        if (d < kInf32 || a.blocked[v * a.b + c] != 0) r |= bit;
        if (d == 1) f |= bit;
      }
      a.reach[0][v * a.wp + w] = r;
      a.front[0][v * a.wp + w] = f;
      any |= f != 0u;
    }
  }
  set_flags(flags_of(ctl, 0), any, false);
  if (!barrier(ctl)) return;
  bool go = ld_ctl(ctl + kFlag) != 0;
  int64_t p = 1, run = 0;
  int32_t last = 1;
  for (int32_t level = 2; go; ++level) {
    if ((int64_t)level > a.n + 1) {  // every level stamps: cannot happen
      if (lead) atomicExch(ctl + kErr, (u64)kErrLevels);
      break;
    }
    const int c = (int)(run & 1);
    const uint32_t* reach = a.reach[c];
    const uint32_t* front = a.front[c];
    uint32_t* reach_nxt = a.reach[c ^ 1];
    uint32_t* front_nxt = a.front[c ^ 1];
    u64* f = flags_of(ctl, p);
    if (lead) {
      u64* g = flags_of(ctl, p + 2);
      g[0] = g[1] = 0;
    }
    // a column is active while its dst is unstamped: reach minus banned
    for (int w = threadIdx.x; w < a.wp; w += kThreads) {
      uint32_t banned = 0u;
      for (int cc = 32 * w; cc < 32 * w + 32 && cc < a.b; ++cc) {
        if (a.blocked[(int64_t)a.dst * a.b + cc] != 0) banned |= 1u << (cc & 31);
      }
      act[w] = ~(__ldcg(reach + (int64_t)a.dst * a.wp + w) & ~banned);
    }
    __syncthreads();
    bool found = false;
    for (int64_t v = tid; v < a.n; v += stride) {
      const int64_t beg = __ldg(a.row_ptr + v), end = __ldg(a.row_ptr + v + 1);
      for (int w = 0; w < a.wp; ++w) {
        const uint32_t r = __ldcg(reach + v * a.wp + w);
        const uint32_t want = act[w] & ~r;
        uint32_t acc = 0u;
        for (int64_t e = beg; want != 0u && e < end && (acc & want) != want; ++e) {
          const int32_t u = __ldg(a.col_ind + e);
          acc |= __ldcg(front + (int64_t)u * a.wp + w);
        }
        const uint32_t fresh = acc & want;
        reach_nxt[v * a.wp + w] = r | fresh;
        front_nxt[v * a.wp + w] = fresh;
        for (uint32_t bits = fresh; bits; bits &= bits - 1u) {
          a.dist[v * a.b + 32 * w + __ffs(bits) - 1] = level;
        }
        found |= fresh != 0u;
      }
    }
    set_flags(f, found, false);
    if (!barrier(ctl)) return;
    ++run;
    ++p;
    go = ld_ctl(f) != 0;
    if (go) last = level;
  }
  if (lead) {
    a.status[kSLast] = last;
    a.status[kSRun] = run;
    a.status[kSGrid] = gridDim.x;
  }
}

__global__ void __launch_bounds__(kThreads)
restricted_sweep_kernel(const SweepArgs a) {
  sweep_run(a);
  leave(a.ctl, a.status, -1, kSErr);
}

// the blocks of a cooperative launch of `kernel`: every block resident at
// once (the barrier's premise), and no more than `rows` need
template <class K>
int coop_blocks(K kernel, size_t smem, int64_t rows, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t fit = (int64_t)sms * per_sm;
  const int64_t need = (rows + kThreads - 1) / kThreads;
  *blocks = (int)(need < fit ? (need > 0 ? need : 1) : fit);
  return 0;
}

}  // namespace

// One delta-stepping solve (module comment) in one cooperative launch.
// tgt int32 / wts f32 [n_pad, width]; dist0, dist1 f32 [n_pad] scratch (the
// final distances land in the one status[0] names); ctl the stream's [16]
// int64 working block, zero before the launch and after it; status [6]
// int64 receives the final buffer, buckets, relaxations, passes, the error
// word and the blocks. The launch's error code is returned.
extern "C" int bibfs_delta_stepping(const void* tgt, const void* wts,
                                    int64_t n_pad, int width, int src, int dst,
                                    float delta, void* dist0, void* dist1,
                                    void* ctl, void* status, void* stream) {
  if (n_pad < 1 || width < 0 || src < 0 || src >= n_pad || dst < 0 ||
      dst >= n_pad || !(delta > 0.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  DeltaArgs a;
  a.tgt = (const int32_t*)tgt;
  a.wts = (const float*)wts;
  a.n_pad = n_pad;
  a.width = width;
  a.src = src;
  a.dst = dst;
  a.delta = delta;
  a.dist[0] = (float*)dist0;
  a.dist[1] = (float*)dist1;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  int blocks = 0;
  const int rc = coop_blocks(delta_stepping_kernel, 0, n_pad, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)delta_stepping_kernel,
                                          dim3(blocks), dim3(kThreads), args,
                                          0, (cudaStream_t)stream);
}

// One Yen iteration's restricted sweep (module comment) in one cooperative
// launch, over the CSR row_ptr int64 [n + 1] / col_ind int32. dist int32
// [n, b] holds the seeds and receives the stamps; blocked int8 [n, b];
// reach0/1 and front0/1 uint32 [n, ceil(b / 32)] scratch; ctl as above;
// status [6] int64 receives the last level that stamped, the levels run,
// the error word and the blocks. The launch's error code is returned.
extern "C" int bibfs_restricted_sweep(const void* row_ptr, const void* col_ind,
                                      int64_t n, int b, int dst, void* dist,
                                      const void* blocked, void* reach0,
                                      void* reach1, void* front0, void* front1,
                                      void* ctl, void* status, void* stream) {
  if (n < 1 || n > INT32_MAX || b < 1 || dst < 0 || dst >= n) {
    return (int)cudaErrorInvalidValue;
  }
  SweepArgs a;
  a.row_ptr = (const int64_t*)row_ptr;
  a.col_ind = (const int32_t*)col_ind;
  a.n = n;
  a.b = b;
  a.wp = (b + 31) / 32;
  a.dst = dst;
  a.dist = (int32_t*)dist;
  a.blocked = (const int8_t*)blocked;
  a.reach[0] = (uint32_t*)reach0;
  a.reach[1] = (uint32_t*)reach1;
  a.front[0] = (uint32_t*)front0;
  a.front[1] = (uint32_t*)front1;
  a.ctl = (u64*)ctl;
  a.status = (int64_t*)status;
  const size_t smem = (size_t)a.wp * sizeof(uint32_t);
  int blocks = 0;
  const int rc = coop_blocks(restricted_sweep_kernel, smem, n, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)restricted_sweep_kernel,
                                          dim3(blocks), dim3(kThreads), args,
                                          smem, (cudaStream_t)stream);
}
