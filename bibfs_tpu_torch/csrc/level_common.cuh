// Device code shared by the four level kernels (pull_expand.cu,
// fused_level.cu) and the persistent kernels (msbfs.cu, query_device.cu):
// the one first-hit-slot claim (claim_chunked), the
// frontier lookups it takes (BitsFront: kernels 1, 4 and unstaged 2;
// StagedFront, filled by stage_bitmap: staged kernel 2; PairFront: kernel
// 3), warp reductions, the persistent kernels' grid barrier and the parking
// of their one-block stretches.
//
// Tables are slot-major: nbr_t[j * stride + v] is the j-th neighbour of
// vertex row v. A row's live slots are a prefix of length min(deg[v],
// width), so a claim bounded by the degree never reads a dead slot (which
// holds the sentinel id, the id space: the table's row count on one
// device, the global vertex count on a shard of a vertex-sharded search).
// On a tiered base table a hub row's degree exceeds the width and the bound
// is the width.
//
// Frontiers are bitmaps of uint32 words: one bit per vertex (bit u & 31 of
// word u >> 5) per side, or, for the dual pull kernel, one pair row of 2
// bits per vertex (bits 2 (u & 15) and 2 (u & 15) + 1 of word u >> 4 for
// the source and the target side).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// the staged kernel's copy of the active bitmap (dynamic shared memory)
extern __shared__ __align__(128) uint32_t stage_bits[];

namespace bibfs {

constexpr int32_t kInf = 1 << 30;               // unreached distance
constexpr int kBlock = 256;                     // threads per block
constexpr int kChunk = 8;                       // slots per chunk of independent loads
constexpr unsigned kBulkBytes = 16384;          // bytes per cp.async.bulk request
constexpr unsigned long long kNoMeet = ~0ull;   // empty meet-vote key

// The fused search's scalar state, one int32 row on the device.
enum StateSlot : int {
  kLvlS = 0, kLvlT, kBest, kMeet, kCntS, kCntT, kMdS, kMdT, kDsS, kDsT,
  kLevels, kEdges, kStateLen
};
// Per-round accumulators: [cnt_s, cnt_t, md_s, md_t, ds_s, ds_t].
enum AccSlot : int { kAccCnt = 0, kAccMd = 2, kAccDs = 4, kAccLen = 6 };

// The search goes on while lvl_s + lvl_t < best and both frontiers are
// non-empty (the provably-correct stop of the dense solver).
__device__ __forceinline__ bool search_active(const int32_t* state) {
  return state[kLvlS] + state[kLvlT] < state[kBest] && state[kCntS] > 0 &&
         state[kCntT] > 0;
}

// Frontier lookups. A claim first issues a chunk's loads, load(u, need),
// then reads the hits out of what came back, hits(w, u, need): the bits
// of `need` (1 = source side, 2 = target side) whose frontier holds
// vertex u. Kept apart, the loads of a chunk are all in flight before
// the first one is used. Ids outside [0, n) load nothing and read as no
// hit, so a slot past a row's end (u = -1) finds nothing.

// One bitmap per side read through the read-only path: f0 answers bit 0,
// f1 bit 1 (unused by a one-side claim).
struct BitsFront {
  const uint32_t* __restrict__ f0;
  const uint32_t* __restrict__ f1;
  uint32_t n;
  struct Word {
    uint32_t w0, w1;
  };
  __device__ __forceinline__ Word load(int32_t u, unsigned need) const {
    const bool ok = (uint32_t)u < n;
    return {ok && (need & 1u) ? __ldg(f0 + (u >> 5)) : 0u,
            ok && (need & 2u) ? __ldg(f1 + (u >> 5)) : 0u};
  }
  __device__ __forceinline__ unsigned hits(Word w, int32_t u, unsigned) const {
    const unsigned sh = (uint32_t)u & 31u;
    return ((w.w0 >> sh) & 1u) | (((w.w1 >> sh) & 1u) << 1);
  }
};

// One side's bitmap staged in shared memory (stage_bitmap).
struct StagedFront {
  uint32_t n;
  typedef uint32_t Word;
  __device__ __forceinline__ Word load(int32_t u, unsigned need) const {
    return (uint32_t)u < n && (need & 1u) ? stage_bits[u >> 5] : 0u;
  }
  __device__ __forceinline__ unsigned hits(Word w, int32_t u, unsigned) const {
    return (w >> ((uint32_t)u & 31u)) & 1u;
  }
};

// Both sides in one row of 2 bits per vertex: one load answers both.
struct PairFront {
  const uint32_t* __restrict__ f;
  uint32_t n;
  typedef uint32_t Word;
  __device__ __forceinline__ Word load(int32_t u, unsigned need) const {
    return (uint32_t)u < n && need ? __ldg(f + (u >> 4)) : 0u;
  }
  __device__ __forceinline__ unsigned hits(Word w, int32_t u, unsigned need) const {
    return (w >> (((uint32_t)u & 15u) << 1)) & need;
  }
};

// THE claim of all four kernels. Row v's first `live` slots are walked in
// chunks of kChunk: the chunk's slot loads (coalesced across a warp, the
// table being slot-major) are issued together, then its kChunk frontier
// loads, then the lowest hit slot per wanted side (bits of `want`) gives
// *par0 / *par1. The next chunk is read only while a wanted side has no
// hit, so a row reads at most kChunk - 1 slots past its first hit.
// Returns the bits that were found.
template <class Front>
__device__ __forceinline__ unsigned claim_chunked(
    const int32_t* __restrict__ nbr_t, int64_t stride, int live, int64_t v,
    const Front& front, unsigned want, int32_t* par0, int32_t* par1) {
  unsigned got = 0u;
  for (int c = 0; c < live && got != want; c += kChunk) {
    int32_t u[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      u[k] = c + k < live ? __ldg(nbr_t + (int64_t)(c + k) * stride + v) : -1;
    }
    const unsigned need = want & ~got;
    typename Front::Word w[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) w[k] = front.load(u[k], need);
    // descending, so the lowest hit slot writes last
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      const unsigned h = front.hits(w[k], u[k], need);
      if (h & 1u) *par0 = u[k];
      if (h & 2u) *par1 = u[k];
      got |= h;
    }
  }
  return got;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (a multiple of 16, from a 16-byte aligned address) of
// device memory into stage_bits with cp.async.bulk on one mbarrier, and
// make every thread of the block wait for it. Called by all threads.
__device__ __forceinline__ void stage_bitmap(const uint32_t* src, uint32_t bytes,
                                             unsigned long long* bar) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(bytes) : "memory");
    const uint32_t dst = smem_addr(stage_bits);
    for (uint32_t off = 0; off < bytes; off += kBulkBytes) {
      const uint32_t len = bytes - off < kBulkBytes ? bytes - off : kBulkBytes;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          ::"r"(dst + off), "l"((const char*)src + off), "r"(len), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
  }
}

struct SumOp {
  template <class T> __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  template <class T> __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct MinOp {
  template <class T> __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T x, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// ---- the persistent kernels' grid barrier (msbfs.cu, query_device.cu) ----

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long arrive(unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], 1;"
               : "=l"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of a cooperative grid arrives, then all leave; false (and
// *err set to `code`) when the wait outlasts wait_ns. The arrivals on *bar
// only grow: a block's ticket says its round, and the round ends when
// every block of the grid has a ticket in it. The arrival releases the
// block's writes and the wait acquires every other block's; state the
// blocks change between barriers is read through L2 (__ldcg), never from
// a stale L1 line.
__device__ inline bool grid_barrier(unsigned long long* bar,
                                    unsigned long long* err,
                                    unsigned long long code,
                                    unsigned long long wait_ns) {
  __shared__ int ok;
  __syncthreads();
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long ticket = arrive(bar);
    const unsigned long long done = (ticket / gridDim.x + 1) * gridDim.x;
    if (ticket + 1 != done) {
      const unsigned long long t0 = now_ns();
      while (ld_acquire(bar) < done) {
        if (now_ns() - t0 > wait_ns) {
          atomicExch(err, code);
          ok = 0;
          break;
        }
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
  return ok != 0;
}

// ---- one-block stretches of the persistent kernels (query_device.cu) ----
// A persistent kernel may run a stretch of narrow passes in block 0 alone,
// with __syncthreads between them, while the other blocks park on an epoch
// word. Block 0 ends the stretch by storing epoch + 2 (the grid resumes:
// the state it publishes before the store is theirs) or epoch + 1 (the
// kernel is done: they leave). While the stretch runs, block 0 bumps a beat
// word every pass; a parked block gives up (*err set to `code`) only after
// wait_ns without a beat, so a long stretch is no timeout.

constexpr unsigned long long kParkGaveUp = ~0ull;

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The wait of a parked block (all threads call it): returns the epoch block
// 0 stored, or kParkGaveUp. `seen` is the epoch the stretch began at.
__device__ inline unsigned long long park(const unsigned long long* epoch,
                                          unsigned long long seen,
                                          const unsigned long long* beat,
                                          unsigned long long* err,
                                          unsigned long long code,
                                          unsigned long long wait_ns) {
  __shared__ unsigned long long got;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t0 = now_ns(), last = ld_relaxed(beat);
    unsigned ns = 32;
    for (;;) {
      const unsigned long long e = ld_acquire(epoch);
      if (e != seen) {
        got = e;
        break;
      }
      const unsigned long long b = ld_relaxed(beat);
      if (b != last) {
        last = b;
        t0 = now_ns();
      } else if (now_ns() - t0 > wait_ns) {
        atomicExch(err, code);
        got = kParkGaveUp;
        break;
      }
      __nanosleep(ns);
      if (ns < 1024) ns <<= 1;
    }
  }
  __syncthreads();
  return got;
}

// Block 0's thread 0 ends a stretch: every write of the block before this
// call (the caller's __syncthreads and this fence order them) is visible to
// a block that reads the new epoch.
__device__ __forceinline__ void unpark(unsigned long long* epoch,
                                       unsigned long long value) {
  __threadfence();
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(epoch), "l"(value)
               : "memory");
}

}  // namespace bibfs

extern "C" const char* bibfs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
