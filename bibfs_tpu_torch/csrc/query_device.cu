// The device rungs of two query kinds, each one persistent cooperative
// launch per solve.
//
// delta_stepping_kernel replaces the XLA while_loop of the reference's
// device delta-stepping (bibfs_tpu/solvers/query_device.py
// _build_delta_kernel, query_device.py:50-126; not a Pallas kernel): the
// weighted single-source search to one target over an ELL table, as
// bucketed relaxation passes. With `tgt` int32 [n_pad, width] (dead slots
// point at the dump row n_pad and follow a row's live ones), `wts` f32
// [n_pad, width] and the f32 bucket width delta, bucket bi holds the
// vertices whose distance d has lo <= d < hi, lo = f32(bi) * delta and
// hi = f32(bi + 1) * delta. The reference's pass over a class of edges
// (light: w <= delta, heavy: the rest) is a Jacobi pull,
//
//   next[v] = min(dist[v], min over in-bucket u, (u, v) of the class,
//                 of dist[u] + w),
//
// a bucket runs light passes until one changes nothing, then one heavy
// pass, and the search goes on while some finite distance is >= lo and
// dist[dst] >= lo. The output is the reference's: the distances bit for bit
// (every sum is __fadd_rn and every bound __fmul_rn), the non-empty buckets,
// the relaxations (candidates below F_INF, summed over passes) and the
// passes.
//
// restricted_sweep_kernel replaces the XLA while_loop of the reference's
// batched restricted BFS (query_device.py:226-291 _build_restricted_kernel;
// not a Pallas kernel): the spur candidates of one Yen iteration as the
// columns of an int32 [n, B] distance plane over the CSR, 32 candidates a
// uint32 word. It is the bit-plane BFS of msbfs.cu with three changes: the
// state is seeded from index lists of the seeded entries (the caller stamps
// 0 at each spur and 1 at its allowed first hops in the plane; the reach
// words also hold every banned (node, column) bit, so a banned node is never
// stamped), a column freezes once its dst is stamped (the reference's
// `act`), and the stamps are int32 levels with a level limit.
//
// Bounds on the H100: device-memory bytes. A delta pass needs the rows of
// the vertices in its bucket, the distances of their targets and the
// distances it lowers; a restricted level the frontier's CSR rows and words
// and the changed words and stamps (md.frontier_bytes's count). Both do a
// few operations per byte.
//
// Design (a pass or level touches only what changed, not every vertex).
// 1. Frontier-driven Jacobi delta passes. Membership of a bucket only grows
//    (a light relaxation from inside it never goes below its floor), and a
//    member whose distance did not change since its last push cannot lower
//    anything. So a pass pushes only from the vertices whose distance the
//    previous pass lowered (the changed list) that lie in the bucket; a
//    bucket's first pass pushes from every member, found by a scan of the
//    far list (every vertex reached and not yet settled, kept as a list);
//    the heavy pass pushes once from the bucket's member list. A push is an
//    atomicMin of the candidate's float bits (the distances are
//    non-negative) into the other distance buffer; the pass reads only the
//    buffer the previous pass finished (Jacobi: the result, and whether the
//    pass changed anything, equal the reference's full pull), and brings the
//    other buffer up to date at the previous pass's changed entries only.
//    The first thread to lower a target (its atomicMin found a value not
//    below the pass's start) lists it for the next pass, tagged when the
//    target was beyond the bucket as the pass began; the one that reaches
//    it (from F_INF) beyond the bucket adds it to the far list.
// 2. Counts without a scan. A light pass relaxes the light slots of the
//    bucket's members, the heavy pass their heavy slots (the table is
//    symmetric and the weight hash is), so the relaxations are running
//    degree sums: a member's degrees are added when it first pushes (the
//    far scan's members, and changed entries in the bucket whose tag says
//    they joined in the pass before). The search goes on while vertices reached
//    minus vertices settled (members, and vertices a heavy pass brought
//    below the bucket's top) is not zero; empty buckets run as in the
//    reference, so the pass count is its own.
// 3. One-block stretches. When the entries the next pass walks number at
//    most solo_cap, block 0 runs it alone, __syncthreads between passes and
//    its counters in shared memory, for as long as that holds; the other
//    blocks park on an epoch word (level_common.cuh park). When the work
//    grows, block 0 publishes its counters and state and the grid resumes
//    with grid barriers. A one-block pass's changed list stays in shared
//    memory for the next one-block pass (its ring gets it when the grid
//    takes over), and its counts are 32-bit shared offsets folded in after
//    the pass. A grid-500x500 solve's wavefront (a few hundred to 1,400
//    entries a pass) runs wholly in block 0: a pass costs a few dependent
//    L2 round trips, not a grid barrier.
// 4. Pushed restricted levels with a dense-pull switch, as msbfs.cu: a
//    sparse level pushes from the list of the vertices stamped at the level
//    before (for each neighbour v, the frontier bits v lacks are ORed into
//    v's next words with atomicOr; the thread whose OR set a bit stamps it,
//    and the first to give v a bit this level lists it); a level whose
//    frontier's degree sum reaches dense_edges pulls every vertex (a push
//    after it first lists the frontier block-wise). A column is active at
//    level L while dist[dst, c] >= L: unstamped, or stamped by this very
//    level, which is the reference's `act` read at the level's start, with
//    no second reach buffer. Narrow sparse levels (a frontier of at most
//    solo_cap vertices) run in block 0 alone as in 3.
// 5. Lists are rings of a power-of-two length >= n with monotone counters
//    (never reset within a launch: a list is the range [base, count) of its
//    ring), appended through a block's shared stage with one atomic per
//    block and chunk. Lane groups (`lanes` threads, from the mean degree)
//    share a row; a lane issues kChunk slot loads at once.
//
// Working state: a [64] int64 block per device and stream, zero at launch
// and reset by the last block to leave (the barrier's arrivals, the park
// epoch and beat, the error word, the blocks that have left, the list
// counters, the accumulators and the state block 0 hands the grid), and
// [8] int64 status words the host reads once.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;          // slots a lane loads at once
constexpr int kWords = 4;          // a vertex's plane words loaded at once
constexpr unsigned kStage = 1024;  // a block's staged entries of one list
constexpr unsigned kSoloList = 2048;  // a one-block pass's shared changed list
constexpr int32_t kOut = INT32_MIN;   // a changed entry's tag bit
constexpr u64 kWaitNs = 5000000000ull;
constexpr float kFInf = 3e38f;     // F_INF: unreachable on the f32 line

enum Ctl : int {
  kBar = 0, kEpoch = 1, kBeat = 2, kErr = 3, kExit = 4,
  kCnt = 8,      // list counters
  kAcc = 16,     // accumulators
  kMirror = 24,  // the state block 0 hands the grid
  kCtlLen = 64
};
enum Err : int { kErrBarrier = 2, kErrDepth = 3 };

__device__ __forceinline__ u64 ld_ctl(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ bool barrier(u64* ctl) {
  return bibfs::grid_barrier(ctl + kBar, ctl + kErr, (u64)kErrBarrier, kWaitNs);
}

// ---- lists -------------------------------------------------------------------

struct Stage {
  int32_t v[kStage];
  unsigned n;
};

// Stage v (a grid pass) for the ring whose counter is the working block's
// *cnt; a full stage appends straight to the ring.
__device__ __forceinline__ void append(Stage& st, int32_t* ring, u64 mask,
                                       u64* cnt, int32_t v) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned m = __activemask();
  const int lead = __ffs(m) - 1;
  unsigned at = 0;
  if (lane == lead) at = atomicAdd(&st.n, (unsigned)__popc(m));
  at = __shfl_sync(m, at, lead) + __popc(m & below);
  if (at < kStage) {
    st.v[at] = v;
    return;
  }
  const unsigned o = __activemask();
  const int olead = __ffs(o) - 1;
  u64 base = 0;
  if (lane == olead) base = atomicAdd(cnt, (u64)__popc(o));
  base = __shfl_sync(o, base, olead) + __popc(o & below);
  ring[base & mask] = v;
}

// Copy the K stages out to their rings and empty them (all threads call it).
template <int K>
__device__ __forceinline__ void flush(Stage* st, int32_t* const (&ring)[K],
                                      u64* const (&cnt)[K], u64 mask) {
  __shared__ u64 base[K];
  __syncthreads();
  // constant indices only: a runtime index would put ring and cnt in local
  // memory
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (threadIdx.x == (unsigned)k) {
      const unsigned m = min(st[k].n, kStage);
      base[k] = m ? atomicAdd(cnt[k], (u64)m) : 0ull;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned m = min(st[k].n, kStage);
    for (unsigned j = threadIdx.x; j < m; j += kThreads) {
      ring[k][(base[k] + j) & mask] = st[k].v[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < K) st[threadIdx.x].n = 0;
}

// Sum every thread's x[j] over the block and add the block's sums to the
// working block's accumulators acc[j], one atomic each (all threads call
// it).
template <int K>
__device__ __forceinline__ void grid_totals(u64 (&x)[K], u64* acc) {
  __shared__ u64 part[K][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x[j] = bibfs::warp_reduce(x[j], bibfs::SumOp());
    if (lane == 0) part[j][warp] = x[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      u64 y = lane < kWarps ? part[j][lane] : 0ull;
      y = bibfs::warp_reduce(y, bibfs::SumOp());
      if (lane == 0 && y) atomicAdd(acc + j, y);
    }
  }
  __syncthreads();
}

// Where a pass appends list entries: in a one-block pass straight to the
// ring, at the count the pass began with plus a shared 32-bit offset (no
// stage, no flush); across the grid through the block's stage.
template <int K>
struct Out {
  bool solo;
  Stage* stage;
  int32_t* ring[K];
  u64* cnt[K];    // the working block's counters (grid)
  u64 at[K];      // the counts when the pass began (solo)
  unsigned* off;  // the pass's offsets (solo, shared)
  int32_t* near;  // list 0's first kSoloList entries (solo, shared), or null
  u64 mask;

  __device__ __forceinline__ void put(int k, int32_t v) const {
    if (!solo) {
      append(stage[k], ring[k], mask, cnt[k], v);
      return;
    }
    const int lane = threadIdx.x & 31;
    const unsigned m = __activemask();
    const int lead = __ffs(m) - 1;
    unsigned o = 0;
    if (lane == lead) o = atomicAdd(off + k, (unsigned)__popc(m));
    o = __shfl_sync(m, o, lead) + __popc(m & ((1u << lane) - 1u));
    if (k == 0 && near != nullptr && o < kSoloList) {
      near[o] = v;
    } else {
      ring[k][(at[k] + o) & mask] = v;
    }
  }
};

// A pass's totals: across the grid one atomic per block into the working
// block's accumulators; in one block a warp's sum into the pass's shared
// 32-bit totals (all threads call it).
template <int K>
__device__ __forceinline__ void pass_totals(const unsigned (&x)[K], bool solo,
                                            unsigned* tot, u64* acc) {
  if (solo) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned y = __reduce_add_sync(0xffffffffu, x[j]);
      if ((threadIdx.x & 31) == 0 && y) atomicAdd(tot + j, y);
    }
    return;
  }
  u64 w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = x[j];
  grid_totals<K>(w, acc);
}

// Lane groups: `size` consecutive threads of a block share one row.
struct Group {
  int id, count;     // this group in the block, the block's groups
  int lane, size;    // the thread's lane in it, its size
  int lead;          // the group's first lane in the warp
  unsigned mask;     // the group's lanes in the warp
};

__device__ __forceinline__ Group group_of(int size) {
  Group g;
  g.size = size;
  g.id = threadIdx.x / size;
  g.count = kThreads / size;
  g.lane = threadIdx.x % size;
  g.lead = (threadIdx.x & 31) & ~(size - 1);
  g.mask = (size == 32 ? 0xffffffffu : ((1u << size) - 1u)) << g.lead;
  return g;
}

// Copy n words between a state struct and the working block's mirror.
__device__ __forceinline__ void to_mirror(u64* ctl, const void* st, int n) {
  for (int j = 0; j < n; ++j) ctl[kMirror + j] = static_cast<const u64*>(st)[j];
}
__device__ __forceinline__ void from_mirror(const u64* ctl, void* st, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    static_cast<u64*>(st)[j] = ld_ctl(ctl + kMirror + j);
  }
}

// Leave: the last block out has seen every other block pass its last
// barrier (or give up on one); it publishes the error word and zeroes the
// working block for the next launch.
__device__ __forceinline__ void leave(u64* ctl, int64_t* status, int err_at) {
  __syncthreads();
  if (threadIdx.x == 0 && bibfs::arrive(ctl + kExit) + 1 == gridDim.x) {
    status[err_at] = (int64_t)ld_ctl(ctl + kErr);
    for (int j = 0; j < kCtlLen; ++j) ctl[j] = 0;
  }
}

// ---- delta-stepping ---------------------------------------------------------

// rings: changed lists L0, L1 (pass p reads L[p & 1]), member lists M0, M1
// and far lists F0, F1 (bucket bi's members in M[bi & 1]; it scans
// F[bi & 1] and fills F[(bi + 1) & 1])
enum DList : int { kL0 = 0, kM0 = 2, kF0 = 4, kDLists = 6 };
// accumulators: the light and heavy degrees of newly counted members,
// vertices reached, vertices a heavy pass brought below the bucket's top
enum DAcc : int { kNewLight = 0, kNewHeavy = 1, kReached = 2, kCrossed = 3,
                  kDAcc = 4 };
enum Kind : int { kFirst = 0, kLight = 1, kHeavy = 2 };
// a pusher: push only (heavy, or a member already counted), or count it
// first (a member the far scan found, or one that joined the pass before)
enum Push : int { kPushOnly = 0, kMember = 1 };
enum DOut : int { kOutL = 0, kOutF = 1, kOutM = 2 };

struct DeltaArgs {
  const int32_t* tgt;
  const float* wts;
  int64_t n_pad;
  int width, lanes;
  int32_t src, dst;
  float delta;
  int64_t solo_cap, max_passes;
  float* dist[2];
  int32_t* rings;     // [kDLists, mask + 1]
  u64 mask;
  u64* ctl;
  int64_t* status;
};

enum DeltaStatus : int {
  kDCur = 0,      // the buffer holding the final distances
  kDBuckets = 1,  // non-empty buckets
  kDRelax = 2,    // relaxations
  kDPasses = 3,   // relaxation passes
  kDErr = 4,
  kDGrid = 5,     // blocks
  kDSolo = 6,     // passes block 0 ran alone
  kDGridPasses = 7,
};

// Every block's copy of the search state (thread 0 writes it after a pass;
// block 0 hands it to the grid through the mirror).
struct DState {
  int64_t pass, bucket;
  int32_t kind, solo, done, err;
  int32_t near, pad;  // the next pass's changed list is in shared memory
  u64 base[kDLists];
  u64 cnt[kDLists];
  u64 acc[kDAcc];
  u64 s_light, s_heavy, relax, buckets, settled, reached;
  u64 solo_passes, grid_passes;
};
constexpr int kDStateWords = sizeof(DState) / 8;
static_assert(sizeof(DState) % 8 == 0 && kDStateWords <= kCtlLen - kMirror,
              "DState must fit the mirror");

struct DShared {
  DState st;
  u64 live[kDLists];  // a one-block stretch's list counts
  unsigned off[3];  // a one-block pass's appends to its three lists
  unsigned tot[kDAcc];  // and its totals
  int32_t pu[kThreads];
  float pd[kThreads];
  uint8_t pf[kThreads];
  unsigned npush;
  union {
    Stage out[3];                 // the grid's stages
    int32_t near[2][kSoloList];   // a one-block pass's changed lists
  };
};

__device__ __forceinline__ int32_t* ring_of(const DeltaArgs& a, int k) {
  return a.rings + (int64_t)k * (int64_t)(a.mask + 1);
}

// the distance buffer pass p reads (a select: a runtime index into the
// arguments would copy them to local memory)
__device__ __forceinline__ float* dist_of(const DeltaArgs& a, int64_t p) {
  return (p & 1) ? a.dist[1] : a.dist[0];
}

// Push u's slots of this pass's class (all lanes of u's group call it);
// `newly`: count u's light and heavy degrees.
__device__ __forceinline__ void push_row(
    const DeltaArgs& a, const Group& g, int32_t u, float du, bool newly,
    bool heavy, float hi, const float* R, float* W, const Out<3>& out,
    unsigned (&acc)[kDAcc]) {
  const int32_t* trow = a.tgt + (int64_t)u * a.width;
  const float* wrow = a.wts + (int64_t)u * a.width;
  for (int j0 = g.lane; j0 < a.width; j0 += g.size * kChunk) {
    int32_t v[kChunk];
    float w[kChunk], c[kChunk], dv[kChunk];
    int old[kChunk];
    bool go[kChunk];
    bool dead = false;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int j = j0 + t * g.size;
      v[t] = j < a.width ? __ldg(trow + j) : (int32_t)a.n_pad;
      w[t] = j < a.width ? __ldg(wrow + j) : 0.0f;
    }
    // a new member joins the member list while its row is on its way
    if (newly && j0 == 0) out.put(kOutM, u);
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool live = (int64_t)v[t] < a.n_pad;
      const bool light = w[t] <= a.delta;
      dead |= !live;
      if (newly && live) {
        acc[kNewLight] += light;
        acc[kNewHeavy] += !light;
      }
      go[t] = live && light != heavy;
      c[t] = __fadd_rn(du, w[t]);
      dv[t] = 0.0f;
      old[t] = 0;
    }
    // the pass-start distance and the push, in flight together
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (!go[t]) continue;
      dv[t] = __ldcg(R + v[t]);
      old[t] = atomicMin(reinterpret_cast<int*>(W + v[t]), __float_as_int(c[t]));
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (!go[t] || !(c[t] < dv[t])) continue;
      const float o = __int_as_float(old[t]);
      if (o >= dv[t]) {  // the first to lower v in this pass lists it,
        // tagged when v was beyond the bucket as the pass began
        out.put(kOutL, dv[t] >= hi ? v[t] | kOut : v[t]);
        if (dv[t] == kFInf) {
          ++acc[kReached];
          if (!(c[t] < hi)) out.put(kOutF, v[t]);
        }
      }
      if (heavy && dv[t] >= hi && o >= hi && c[t] < hi) ++acc[kCrossed];
    }
    if (dead) break;  // a row's live slots are a prefix
  }
}

// A pusher's turn (all lanes of its group): its row is pushed; a new
// member joins the member list and its degrees are counted.
__device__ __forceinline__ void push_member(
    const DeltaArgs& a, const Group& g, int32_t u, float du, int flag,
    bool heavy, float hi, const float* R, float* W, const Out<3>& out,
    unsigned (&acc)[kDAcc]) {
  push_row(a, g, u, du, flag == kMember, heavy, hi, R, W, out, acc);
}

// One pass of the kind sh.st.kind, by the grid or (solo) by block 0 alone.
// Entries are walked in chunks of kThreads a block, one thread an entry
// (phase A: the up-to-date copy, the class of the entry). With one lane a
// row the thread pushes its own entry; with more, the pushers are staged
// and one lane group a pusher pushes (phase B).
__device__ __forceinline__ void delta_pass(const DeltaArgs& a, DShared& sh,
                                           bool solo) {
  const DState& st = sh.st;
  const int kind = st.kind;
  const bool heavy = kind == kHeavy;
  const int64_t p = st.pass;
  const u64 blocks = solo ? 1 : gridDim.x, block = solo ? 0 : blockIdx.x;
  const float lo = __fmul_rn((float)st.bucket, a.delta);
  const float hi = __fmul_rn((float)(st.bucket + 1), a.delta);
  const float* R = dist_of(a, p);
  float* W = dist_of(a, p + 1);
  const int lin = kL0 + (int)(p & 1), lout = kL0 + (int)((p + 1) & 1);
  const int mk = kM0 + (int)(st.bucket & 1);
  const int fin = kF0 + (int)(st.bucket & 1);
  const int fout = kF0 + (int)((st.bucket + 1) & 1);
  const int xk = kind == kFirst ? fin : mk;
  const u64 nl = st.cnt[lin] - st.base[lin];
  const u64 nx = kind == kLight ? 0ull : st.cnt[xk] - st.base[xk];
  const u64 total = nl + nx;
  const int32_t* in_l = ring_of(a, lin);
  const int32_t* in_x = ring_of(a, xk);
  const u64 base_l = st.base[lin], base_x = st.base[xk];
  const int lists[3] = {lout, fout, mk};
  Out<3> out;
  out.solo = solo;
  out.stage = sh.out;
  out.off = sh.off;
  out.near = solo ? sh.near[(p + 1) & 1] : nullptr;
  out.mask = a.mask;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.ring[k] = ring_of(a, lists[k]);
    out.cnt[k] = a.ctl + kCnt + lists[k];
    out.at[k] = solo ? sh.live[lists[k]] : 0ull;
  }
  const Group g = group_of(a.lanes);
  const bool staged = a.lanes > 1;
  unsigned acc[kDAcc] = {0u, 0u, 0u, 0u};
  for (u64 c0 = block * kThreads; c0 < total; c0 += blocks * kThreads) {
    if (staged) {
      if (threadIdx.x == 0) sh.npush = 0;
      __syncthreads();
    }
    const u64 i = c0 + threadIdx.x;
    if (i < total) {
      int32_t u;
      float du;
      int flag = -1;
      if (i < nl) {
        // bring the other buffer up to date where the last pass changed it
        const int32_t e = st.near && i < kSoloList
                              ? sh.near[p & 1][i]
                              : __ldcg(in_l + ((base_l + i) & a.mask));
        u = e & ~kOut;
        du = __ldcg(R + u);
        atomicMin(reinterpret_cast<int*>(W + u), __float_as_int(du));
        // a member that joined the pass before is counted now
        if (kind == kLight && du >= lo && du < hi) flag = e < 0 ? kMember : kPushOnly;
      } else {
        u = __ldcg(in_x + ((base_x + i - nl) & a.mask));
        du = __ldcg(R + u);
        if (heavy) {
          flag = kPushOnly;
        } else if (!(du < hi)) {  // still beyond the bucket: keep it
          out.put(kOutF, u);
        } else if (du >= lo) {    // the far scan's member
          flag = kMember;
        }                          // below lo: settled, dropped
      }
      if (flag >= 0) {
        if (staged) {
          const unsigned at = atomicAdd(&sh.npush, 1u);
          sh.pu[at] = u;
          sh.pd[at] = du;
          sh.pf[at] = (uint8_t)flag;
        } else {
          push_member(a, g, u, du, flag, heavy, hi, R, W, out, acc);
        }
      }
    }
    if (staged) {
      __syncthreads();
      const unsigned np = sh.npush;
      for (unsigned k = g.id; k < np; k += g.count) {
        push_member(a, g, sh.pu[k], sh.pd[k], sh.pf[k], heavy, hi, R, W, out,
                    acc);
      }
    }
    if (!solo) flush<3>(sh.out, out.ring, out.cnt, a.mask);
  }
  pass_totals<kDAcc>(acc, solo, sh.tot, a.ctl + kAcc);
}

// After a pass (thread 0 of every working block): read the counters, fold
// the pass into the state, pick the next pass and whether block 0 runs it
// alone. The counters go to the state's arrays, indexed there.
__device__ __forceinline__ void delta_advance(const DeltaArgs& a, DShared& sh,
                                              bool solo) {
  DState& st = sh.st;
  const int kind = st.kind;
  const int lin = kL0 + (int)(st.pass & 1), lout = kL0 + (int)((st.pass + 1) & 1);
  const int fin = kF0 + (int)(st.bucket & 1), fout = kF0 + (int)((st.bucket + 1) & 1);
  const int mk = kM0 + (int)(st.bucket & 1);
  u64* live = sh.live;
  if (solo) {  // fold the pass's shared offsets and totals into the counts
    live[lout] += sh.off[kOutL];
    live[fout] += sh.off[kOutF];
    live[mk] += sh.off[kOutM];
    sh.off[kOutL] = sh.off[kOutF] = sh.off[kOutM] = 0;
  }
#pragma unroll
  for (int k = 0; k < kDLists; ++k) st.cnt[k] = solo ? live[k] : ld_ctl(a.ctl + kCnt + k);
  u64 d[kDAcc];
#pragma unroll
  for (int j = 0; j < kDAcc; ++j) {
    if (solo) {
      d[j] = sh.tot[j];
      sh.tot[j] = 0;
    } else {
      const u64 x = ld_ctl(a.ctl + kAcc + j);
      d[j] = x - st.acc[j];
      st.acc[j] = x;
    }
  }
  st.reached += d[kReached];
  if (kind == kFirst) st.base[fin] = st.cnt[fin];  // the far list is spent
  const u64 changed = st.cnt[lout] - st.base[lout];
  st.base[lin] = st.cnt[lin];  // the next pass's changed list starts empty
  ++st.pass;
  if (solo) ++st.solo_passes; else ++st.grid_passes;
  st.near = solo;
  if (kind != kHeavy) {
    st.relax += st.s_light + d[kNewLight];
    st.s_light += d[kNewLight];
    st.s_heavy += d[kNewHeavy];
    st.kind = changed ? kLight : kHeavy;
  } else {
    const u64 members = st.cnt[mk] - st.base[mk];
    st.relax += st.s_heavy;
    st.buckets += members != 0;
    st.settled += members + d[kCrossed];
    ++st.bucket;
    const float lo = __fmul_rn((float)st.bucket, a.delta);
    const float dd = __ldcg(dist_of(a, st.pass) + a.dst);
    if (st.reached <= st.settled || !(dd >= lo)) {
      st.done = 1;
    } else {
      st.kind = kFirst;
      st.s_light = st.s_heavy = 0;
      const int m2 = kM0 + (int)(st.bucket & 1);
      st.base[m2] = st.cnt[m2];
    }
  }
  if (!st.done && st.pass >= a.max_passes) {
    st.done = 1;
    st.err = kErrDepth;
  }
  if (!st.done) {
    const int nin = kL0 + (int)(st.pass & 1);
    u64 work = st.cnt[nin] - st.base[nin];
    if (st.kind != kLight) {
      const int x = st.kind == kFirst ? kF0 + (int)(st.bucket & 1)
                                      : kM0 + (int)(st.bucket & 1);
      work += st.cnt[x] - st.base[x];
    }
    st.solo = (int64_t)work <= a.solo_cap;
  }
}

// Block 0 ends a one-block stretch: the changed list the next pass reads
// goes to its ring, the counters and the state to the working block, then
// the parked blocks wake (all of block 0's threads call it).
__device__ __forceinline__ void delta_resume(const DeltaArgs& a, DShared& sh,
                                             u64& seen) {
  if (!sh.st.done) {
    const int lin = kL0 + (int)(sh.st.pass & 1);
    const u64 base = sh.st.base[lin];
    const u64 m = min(sh.st.cnt[lin] - base, (u64)kSoloList);
    int32_t* ring = ring_of(a, lin);
    for (u64 i = threadIdx.x; i < m; i += kThreads) {
      ring[(base + i) & a.mask] = sh.near[sh.st.pass & 1][i];
    }
    __syncthreads();
    if (threadIdx.x < 3) sh.out[threadIdx.x].n = 0;
  }
  if (threadIdx.x == 0) {
    if (!sh.st.done) {
      sh.st.near = 0;
      for (int k = 0; k < kDLists; ++k) a.ctl[kCnt + k] = sh.st.cnt[k];
      for (int j = 0; j < kDAcc; ++j) a.ctl[kAcc + j] = sh.st.acc[j];
      to_mirror(a.ctl, &sh.st, kDStateWords);
    }
    bibfs::unpark(a.ctl + kEpoch, sh.st.done ? seen + 1 : seen + 2);
  }
  seen += 2;
  __syncthreads();
}

__device__ __forceinline__ void delta_run(const DeltaArgs& a, DShared& sh) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t v = tid; v < a.n_pad; v += stride) {
    const float d = v == a.src ? 0.0f : kFInf;
    a.dist[0][v] = d;
    a.dist[1][v] = d;
  }
  if (tid == 0) {  // the far list of bucket 0: the source
    ring_of(a, kF0)[0] = a.src;
    a.ctl[kCnt + kF0] = 1;
  }
  if (threadIdx.x == 0) {
    DState& st = sh.st;
    st.pass = st.bucket = 0;
    st.kind = kFirst;
    st.done = st.err = 0;
    st.near = st.pad = 0;
    for (int k = 0; k < kDLists; ++k) st.base[k] = st.cnt[k] = 0;
    for (int j = 0; j < kDAcc; ++j) st.acc[j] = 0;
    st.cnt[kF0] = 1;
    st.s_light = st.s_heavy = st.relax = st.buckets = st.settled = 0;
    st.reached = 1;
    st.solo_passes = st.grid_passes = 0;
    st.solo = 1 <= a.solo_cap;
  }
  if (threadIdx.x < 3) sh.out[threadIdx.x].n = 0;
  if (!barrier(a.ctl)) return;
  u64 seen = 0;  // the park epoch this block knows
  bool alone = false;
  for (;;) {  // every way into an iteration ends in a sync: sh.st is read
    if (sh.st.done) break;
    const bool solo = sh.st.solo;
    if (solo && blockIdx.x != 0) {
      const u64 e = bibfs::park(a.ctl + kEpoch, seen, a.ctl + kBeat,
                                a.ctl + kErr, (u64)kErrBarrier, kWaitNs);
      if (e == bibfs::kParkGaveUp || (e & 1ull)) return;
      seen = e;
      from_mirror(a.ctl, &sh.st, kDStateWords);
      __syncthreads();
      continue;
    }
    if (solo && !alone) {  // the stretch's counters, from the grid's
      if (threadIdx.x < kDLists) sh.live[threadIdx.x] = sh.st.cnt[threadIdx.x];
      if (threadIdx.x < 3) sh.off[threadIdx.x] = 0;
      if (threadIdx.x < kDAcc) sh.tot[threadIdx.x] = 0;
      alone = true;
      __syncthreads();
    }
    delta_pass(a, sh, solo);
    if (!solo) {
      if (!barrier(a.ctl)) return;
    } else {
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      delta_advance(a, sh, solo);
      if (solo) *reinterpret_cast<volatile u64*>(a.ctl + kBeat) = (u64)sh.st.pass;
    }
    __syncthreads();
    if (solo && (!sh.st.solo || sh.st.done)) {  // the stretch ends
      delta_resume(a, sh, seen);
      alone = false;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const DState& st = sh.st;
    a.status[kDCur] = st.pass & 1;
    a.status[kDBuckets] = (int64_t)st.buckets;
    a.status[kDRelax] = (int64_t)st.relax;
    a.status[kDPasses] = st.pass;
    a.status[kDGrid] = gridDim.x;
    a.status[kDSolo] = (int64_t)st.solo_passes;
    a.status[kDGridPasses] = (int64_t)st.grid_passes;
    if (st.err) atomicExch(a.ctl + kErr, (u64)st.err);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
delta_stepping_kernel(const DeltaArgs a) {
  __shared__ DShared sh;
  delta_run(a, sh);
  leave(a.ctl, a.status, kDErr);
}

// ---- the restricted batch BFS ----------------------------------------------

// counters: the frontier lists (level L's in slot L % 3); accumulators:
// the vertices that gained a bit and their degrees
enum SAcc : int { kSize = 0, kDeg = 1, kSAcc = 2 };
enum Step : int { kLevel = 0, kCompact = 1 };

struct SweepArgs {
  const int64_t* row_ptr;
  const int32_t* col_ind;
  int64_t n;
  int b, wp, lanes;   // candidate columns, words a vertex, a row's threads
  int32_t dst;
  int64_t dense_edges, solo_cap;
  int32_t max_level;
  int32_t* dist;         // [n, b], seeded by the caller, stamped in place
  const int32_t* seeds;  // [n_seeds, 2] (row, column): first hops first
  int64_t n_seeds, n_hops;
  uint32_t* reach;       // [n, wp]: seeded, stamped or banned
  uint32_t* front[3];    // [n, wp]: stamped at a level, in turn
  int32_t* mark;         // [n]: the level that last listed a vertex (wp > 1)
  int32_t* rings;        // [3, mask + 1]
  u64 mask;
  u64* ctl;
  int64_t* status;
};

enum SweepStatus : int {
  kSLast = 0,    // the last level that stamped
  kSRun = 1,     // levels run
  kSErr = 2,
  kSGrid = 3,    // blocks
  kSDense = 4,   // levels pulled
  kSSparse = 5,  // levels pushed
  kSSolo = 6,    // levels block 0 ran alone
  kSGridLevels = 7,
};

struct SState {
  int32_t level;  // the level the next step runs
  int32_t last, run, dense, sparse, step, solo, done, err;
  int32_t listed, old_listed, pad;
  u64 base[3], cnt[3];
  u64 acc[kSAcc];
  u64 size, deg;            // the frontier (stamped at level - 1)
  u64 cur_base, cur_end;    // its list, when listed
  u64 old_base, old_end;    // the list of the frontier before, when old_listed
  u64 solo_levels, grid_levels;
};
constexpr int kSStateWords = sizeof(SState) / 8;
static_assert(sizeof(SState) % 8 == 0 && kSStateWords <= kCtlLen - kMirror,
              "SState must fit the mirror");

struct SShared {
  SState st;
  u64 live[3];           // a one-block stretch's list counts
  unsigned off[1];       // a one-block level's appends to its list
  unsigned tot[kSAcc];   // and its totals
  Stage out[1];
};

__device__ __forceinline__ int32_t* ring_of(const SweepArgs& a, int k) {
  return a.rings + (int64_t)k * (int64_t)(a.mask + 1);
}

// front buffer i % 3 (a select, as dist_of)
__device__ __forceinline__ uint32_t* front_of(const SweepArgs& a, int i) {
  const int k = i % 3;
  return k == 0 ? a.front[0] : k == 1 ? a.front[1] : a.front[2];
}

__device__ __forceinline__ void stamp(int32_t* row, uint32_t bits, int32_t lv) {
  for (; bits; bits &= bits - 1u) row[__ffs(bits) - 1] = lv;
}

// the words of each vertex's row, zeroed (the prologue)
__device__ __forceinline__ void zero_words(uint32_t* p, int64_t len,
                                           int64_t tid, int64_t stride) {
  for (int64_t j = tid; j < len; j += stride) p[j] = 0u;
}

// The prologue's second step: the seeded entries into reach and the level-1
// frontier, which it lists.
__device__ __forceinline__ void sweep_seed(const SweepArgs& a, SShared& sh) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int32_t* const ring[1] = {ring_of(a, 1)};
  u64* const cnt[1] = {a.ctl + kCnt + 1};
  u64 acc[kSAcc] = {0ull, 0ull};
  for (int64_t c0 = (int64_t)blockIdx.x * kThreads; c0 < a.n_seeds; c0 += stride) {
    const int64_t s = c0 + threadIdx.x;
    if (s < a.n_seeds) {
      const int32_t r = a.seeds[2 * s], c = a.seeds[2 * s + 1];
      const uint32_t bit = 1u << (c & 31);
      const int64_t at = (int64_t)r * a.wp + (c >> 5);
      atomicOr(a.reach + at, bit);
      if (s < a.n_hops) {
        const uint32_t was = atomicOr(a.front[0] + at, bit);
        const bool first = a.wp == 1 ? was == 0u : atomicExch(a.mark + r, 1) != 1;
        if (first) {
          append(sh.out[0], ring[0], a.mask, cnt[0], r);
          ++acc[kSize];
          acc[kDeg] += (u64)(__ldg(a.row_ptr + r + 1) - __ldg(a.row_ptr + r));
        }
      }
    }
    flush<1>(sh.out, ring, cnt, a.mask);
  }
  grid_totals<kSAcc>(acc, a.ctl + kAcc);
}

// List the vertices with a word in `front` (grid; all threads call it):
// one atomic per block and chunk of kThreads vertices.
__device__ __forceinline__ void sweep_compact(const SweepArgs& a,
                                              const uint32_t* front,
                                              int32_t* list, u64* cnt) {
  __shared__ unsigned warp_at[kWarps];
  __shared__ u64 block_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t start = (int64_t)blockIdx.x * kThreads; start < a.n; start += step) {
    const int64_t v = start + threadIdx.x;
    uint32_t any = 0u;
    if (v < a.n) {
      for (int w = 0; w < a.wp; ++w) any |= __ldcg(front + v * a.wp + w);
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
      block_at = total ? atomicAdd(cnt, (u64)total) : 0ull;
    }
    __syncthreads();
    if (any) {
      const u64 at = block_at + warp_at[warp] + __popc(on & ((1u << lane) - 1u));
      list[at & a.mask] = (int32_t)v;
    }
    __syncthreads();
  }
}

// One level (sh.st.level) by the grid or (solo) by block 0 alone: the
// active columns, the old frontier's words zeroed, then a push from the
// frontier's list or (dense, grid only) a pull of every vertex.
__device__ __forceinline__ void sweep_level(const SweepArgs& a, SShared& sh,
                                            bool solo, uint32_t* act) {
  const SState& st = sh.st;
  const int32_t L = st.level;
  const int i = L - 2;
  const uint32_t* cur = front_of(a, i);
  uint32_t* nxt = front_of(a, i + 1);
  uint32_t* old = front_of(a, i + 2);
  const bool dense = (int64_t)st.deg >= a.dense_edges;
  const int64_t blocks = solo ? 1 : gridDim.x, block = solo ? 0 : blockIdx.x;
  const int64_t stride = blocks * kThreads;
  const int64_t tid = block * kThreads + threadIdx.x;
  // a column is active while its dst is unstamped, or stamped by this level
  for (int c0 = 0; c0 < 32 * a.wp; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const bool on = c < a.b && __ldcg(a.dist + (int64_t)a.dst * a.b + c) >= L;
    const uint32_t m = __ballot_sync(0xffffffffu, on);
    if ((threadIdx.x & 31) == 0 && c < 32 * a.wp) act[c >> 5] = m;
  }
  // zero the words of the frontier before: the next level writes there
  if (st.old_listed) {
    const int32_t* ol = ring_of(a, (L - 2) % 3);
    for (u64 f = tid; f < st.old_end - st.old_base; f += stride) {
      const int64_t u = __ldcg(ol + ((st.old_base + f) & a.mask));
      for (int w = 0; w < a.wp; ++w) old[u * a.wp + w] = 0u;
    }
  } else {
    zero_words(old, a.n * a.wp, tid, stride);
  }
  __syncthreads();
  const int slot = L % 3;
  Out<1> out;
  out.solo = solo;
  out.stage = sh.out;
  out.off = sh.off;
  out.mask = a.mask;
  out.ring[0] = ring_of(a, slot);
  out.cnt[0] = a.ctl + kCnt + slot;
  out.at[0] = solo ? sh.live[slot] : 0ull;
  const Group g = group_of(a.lanes);
  const int64_t gid = block * g.count + g.id, gcount = blocks * g.count;
  uint32_t own = 0u;  // the bits a lane stamps in a pull
  for (int bt = g.lane; bt < 32; bt += g.size) own |= 1u << bt;
  unsigned acc[kSAcc] = {0u, 0u};
  if (dense) {
    for (int64_t v = gid; v < a.n; v += gcount) {
      const int64_t beg = __ldg(a.row_ptr + v), end = __ldg(a.row_ptr + v + 1);
      bool any = false;
      for (int w = 0; w < a.wp; ++w) {
        const int64_t at = v * a.wp + w;
        const uint32_t r = __ldcg(a.reach + at);
        const uint32_t want = act[w] & ~r;
        if (!want) continue;
        uint32_t got = 0u;
        for (int64_t e = beg + g.lane; e < end; e += g.size) {
          got |= __ldcg(cur + (int64_t)__ldg(a.col_ind + e) * a.wp + w);
        }
        for (int o = g.size >> 1; o > 0; o >>= 1) got |= __shfl_xor_sync(g.mask, got, o);
        const uint32_t fresh = got & want;
        if (!fresh) continue;
        if (g.lane == 0) {  // only v's group writes v in a pull
          nxt[at] = fresh;
          a.reach[at] = r | fresh;
        }
        stamp(a.dist + v * a.b + 32 * w, fresh & own, L);
        any = true;
      }
      if (any && g.lane == 0) {
        ++acc[kSize];
        acc[kDeg] += (unsigned)(end - beg);
      }
    }
  } else {
    const int32_t* list = ring_of(a, (L - 1) % 3);
    const u64 n_list = st.cur_end - st.cur_base;
    for (u64 f = gid; f < n_list; f += gcount) {
      const int64_t u = __ldcg(list + ((st.cur_base + f) & a.mask));
      const int64_t beg = __ldg(a.row_ptr + u), end = __ldg(a.row_ptr + u + 1);
      // kWords of u's words at a time: their loads, then each neighbour's,
      // then its ORs, each batch in flight together
      for (int w0 = 0; w0 < a.wp; w0 += kWords) {
        uint32_t pw[kWords];
        uint32_t some = 0u;
#pragma unroll
        for (int t = 0; t < kWords; ++t) {
          pw[t] = w0 + t < a.wp ? __ldcg(cur + u * a.wp + w0 + t) & act[w0 + t] : 0u;
          some |= pw[t];
        }
        if (!some) continue;
        for (int64_t e = beg + g.lane; e < end; e += g.size) {
          const int64_t v = __ldg(a.col_ind + e);
          const int64_t at = v * a.wp + w0;
          uint32_t cand[kWords], was[kWords];
#pragma unroll
          for (int t = 0; t < kWords; ++t) {
            cand[t] = pw[t] ? pw[t] & ~__ldcg(a.reach + at + t) : 0u;
          }
          // the bits an OR set are v's new bits: stamped here, once
#pragma unroll
          for (int t = 0; t < kWords; ++t) {
            was[t] = cand[t] ? atomicOr(nxt + at + t, cand[t]) : 0u;
          }
          bool got = false;
#pragma unroll
          for (int t = 0; t < kWords; ++t) {
            const uint32_t fresh = cand[t] & ~was[t];
            if (!fresh) continue;
            atomicOr(a.reach + at + t, fresh);
            stamp(a.dist + v * a.b + 32 * (w0 + t), fresh, L);
            got = true;
          }
          if (!got) continue;
          const bool first = a.wp == 1 ? was[0] == 0u : atomicExch(a.mark + v, L) != L;
          if (first) {
            out.put(0, (int32_t)v);
            ++acc[kSize];
            acc[kDeg] += (unsigned)(__ldg(a.row_ptr + v + 1) - __ldg(a.row_ptr + v));
          }
        }
      }
    }
    if (!solo) flush<1>(sh.out, out.ring, out.cnt, a.mask);
  }
  pass_totals<kSAcc>(acc, solo, sh.tot, a.ctl + kAcc);
}

// the next step after the frontier changed: a compaction (grid) when a
// push needs a list the pull did not make; block 0 alone for a narrow push
__device__ __forceinline__ void sweep_next(const SweepArgs& a, SState& st) {
  const bool dense = (int64_t)st.deg >= a.dense_edges;
  st.step = !dense && !st.listed ? kCompact : kLevel;
  st.solo = st.step == kLevel && !dense && st.old_listed &&
            (int64_t)st.size <= a.solo_cap;
}

__device__ __forceinline__ void sweep_advance(const SweepArgs& a, SShared& sh,
                                              bool solo) {
  SState& st = sh.st;
  if (solo) {  // fold the level's shared offset into its list's count
    sh.live[st.level % 3] += sh.off[0];
    sh.off[0] = 0;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) st.cnt[k] = solo ? sh.live[k] : ld_ctl(a.ctl + kCnt + k);
  if (st.step == kCompact) {  // the frontier is listed now
    st.cur_end = st.cnt[(st.level - 1) % 3];
    st.listed = 1;
    sweep_next(a, st);
    return;
  }
  u64 d[kSAcc];
#pragma unroll
  for (int j = 0; j < kSAcc; ++j) {
    if (solo) {
      d[j] = sh.tot[j];
      sh.tot[j] = 0;
    } else {
      const u64 x = ld_ctl(a.ctl + kAcc + j);
      d[j] = x - st.acc[j];
      st.acc[j] = x;
    }
  }
  const int32_t L = st.level;
  const bool dense = (int64_t)st.deg >= a.dense_edges;
  ++st.run;
  if (dense) ++st.dense; else ++st.sparse;
  if (solo) ++st.solo_levels; else ++st.grid_levels;
  st.old_listed = st.listed;
  st.old_base = st.cur_base;
  st.old_end = st.cur_end;
  st.listed = !dense;
  st.cur_base = st.base[L % 3];
  st.cur_end = st.cnt[L % 3];
  st.size = d[kSize];
  st.deg = d[kDeg];
  st.base[(L + 1) % 3] = st.cnt[(L + 1) % 3];  // the next level's list
  if (st.size) st.last = L;
  st.level = L + 1;
  if (st.size == 0) {
    st.done = 1;
  } else if (st.level > a.max_level) {
    st.done = 1;
    st.err = kErrDepth;
  } else {
    sweep_next(a, st);
  }
}

__device__ __forceinline__ void sweep_run(const SweepArgs& a, SShared& sh,
                                          uint32_t* act) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t words = a.n * a.wp;
  zero_words(a.reach, words, tid, stride);
  for (int k = 0; k < 3; ++k) zero_words(a.front[k], words, tid, stride);
  if (a.wp > 1) {
    for (int64_t v = tid; v < a.n; v += stride) a.mark[v] = 0;
  }
  if (threadIdx.x == 0) sh.out[0].n = 0;
  if (!barrier(a.ctl)) return;
  sweep_seed(a, sh);
  if (!barrier(a.ctl)) return;
  if (threadIdx.x == 0) {
    SState& st = sh.st;
    st.level = 2;
    st.last = 1;
    st.run = st.dense = st.sparse = 0;
    st.done = st.err = 0;
    for (int k = 0; k < 3; ++k) {
      st.cnt[k] = ld_ctl(a.ctl + kCnt + k);
      st.base[k] = 0;
    }
    for (int j = 0; j < kSAcc; ++j) st.acc[j] = ld_ctl(a.ctl + kAcc + j);
    st.size = st.acc[kSize];
    st.deg = st.acc[kDeg];
    st.cur_base = 0;             // level 1's list: slot 1
    st.cur_end = st.cnt[1];
    st.listed = st.old_listed = 1;
    st.old_base = st.old_end = 0;
    st.solo_levels = st.grid_levels = 0;
    if (st.size == 0) {
      st.done = 1;
    } else if (st.level > a.max_level) {
      st.done = 1;
      st.err = kErrDepth;
    } else {
      sweep_next(a, st);
    }
  }
  u64 seen = 0;
  bool alone = false;
  __syncthreads();
  for (;;) {  // every way into an iteration ends in a sync: sh.st is read
    if (sh.st.done) break;
    const bool solo = sh.st.solo;
    if (solo && blockIdx.x != 0) {
      const u64 e = bibfs::park(a.ctl + kEpoch, seen, a.ctl + kBeat,
                                a.ctl + kErr, (u64)kErrBarrier, kWaitNs);
      if (e == bibfs::kParkGaveUp || (e & 1ull)) return;
      seen = e;
      from_mirror(a.ctl, &sh.st, kSStateWords);
      __syncthreads();
      continue;
    }
    if (solo && !alone) {
      if (threadIdx.x < 3) sh.live[threadIdx.x] = sh.st.cnt[threadIdx.x];
      if (threadIdx.x == 0) sh.off[0] = 0;
      if (threadIdx.x < kSAcc) sh.tot[threadIdx.x] = 0;
      alone = true;
      __syncthreads();
    }
    if (sh.st.step == kCompact) {  // never alone
      const int slot = (sh.st.level - 1) % 3;
      sweep_compact(a, front_of(a, sh.st.level - 2), ring_of(a, slot),
                    a.ctl + kCnt + slot);
    } else {
      sweep_level(a, sh, solo, act);
    }
    if (!solo) {
      if (!barrier(a.ctl)) return;
    } else {
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      sweep_advance(a, sh, solo);
      if (solo) *reinterpret_cast<volatile u64*>(a.ctl + kBeat) = (u64)sh.st.level;
    }
    __syncthreads();
    if (solo && (!sh.st.solo || sh.st.done)) {  // the grid resumes
      if (threadIdx.x == 0) {
        if (!sh.st.done) {
          for (int k = 0; k < 3; ++k) a.ctl[kCnt + k] = sh.st.cnt[k];
          for (int j = 0; j < kSAcc; ++j) a.ctl[kAcc + j] = sh.st.acc[j];
          to_mirror(a.ctl, &sh.st, kSStateWords);
        }
        bibfs::unpark(a.ctl + kEpoch, sh.st.done ? seen + 1 : seen + 2);
      }
      seen += 2;
      alone = false;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const SState& st = sh.st;
    a.status[kSLast] = st.last;
    a.status[kSRun] = st.run;
    a.status[kSGrid] = gridDim.x;
    a.status[kSDense] = st.dense;
    a.status[kSSparse] = st.sparse;
    a.status[kSSolo] = (int64_t)st.solo_levels;
    a.status[kSGridLevels] = (int64_t)st.grid_levels;
    if (st.err) atomicExch(a.ctl + kErr, (u64)st.err);
  }
}

// two blocks an SM: a dense level's pull has twice the lane groups
__global__ void __launch_bounds__(kThreads, 2)
restricted_sweep_kernel(const SweepArgs a) {
  extern __shared__ uint32_t act[];  // [wp]: this level's active columns
  __shared__ SShared sh;
  sweep_run(a, sh, act);
  leave(a.ctl, a.status, kSErr);
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

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// One delta-stepping solve (module comment) in one cooperative launch.
// tgt int32 / wts f32 [n_pad, width] (a symmetric table: every edge in both
// rows, one weight); lanes (a power of two <= 32) threads share a row; a
// pass whose entries number at most solo_cap runs in block 0 alone; a solve
// past max_passes passes sets the depth error. dist0, dist1 f32 [n_pad]
// scratch (the final distances land in the one status[0] names); rings
// int32 [6, ring_len] scratch (ring_len a power of two >= n_pad); ctl the
// stream's [64] int64 working block, zero before the launch and after it;
// status [8] int64 receives the final buffer, buckets, relaxations, passes,
// the error word, the blocks and the passes run by block 0 alone and by the
// grid. The launch's error code is returned.
extern "C" int bibfs_delta_stepping(const void* tgt, const void* wts,
                                    int64_t n_pad, int width, int lanes,
                                    int src, int dst, float delta,
                                    int64_t solo_cap, int64_t max_passes,
                                    void* dist0, void* dist1, void* rings,
                                    int64_t ring_len, void* ctl, void* status,
                                    void* stream) {
  if (n_pad < 1 || n_pad > INT32_MAX || width < 0 || src < 0 || src >= n_pad ||
      dst < 0 || dst >= n_pad || !(delta > 0.0f) || !pow2(lanes) || lanes > 32 ||
      !pow2(ring_len) || ring_len < n_pad || max_passes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  DeltaArgs a;
  a.tgt = (const int32_t*)tgt;
  a.wts = (const float*)wts;
  a.n_pad = n_pad;
  a.width = width;
  a.lanes = lanes;
  a.src = src;
  a.dst = dst;
  a.delta = delta;
  a.solo_cap = solo_cap;
  a.max_passes = max_passes;
  a.dist[0] = (float*)dist0;
  a.dist[1] = (float*)dist1;
  a.rings = (int32_t*)rings;
  a.mask = (u64)ring_len - 1;
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
// launch, over the CSR row_ptr int64 [n + 1] / col_ind int32 with lanes
// threads a row. dist int32 [n, b] holds the seeds and receives the stamps;
// seeds int32 [n_seeds, 2] the seeded (row, column) entries, the n_hops
// first hops first, then the spurs and the banned nodes. A level whose
// frontier's degree sum reaches dense_edges pulls; a pushed level of at most
// solo_cap frontier vertices runs in block 0 alone; a level above max_level
// sets the depth error. reach, front0-2 uint32 [n, ceil(b / 32)], mark
// int32 [n] and rings int32 [3, ring_len] scratch (ring_len a power of two
// >= n); ctl as above; status [8] int64 receives the last level that
// stamped, the levels run, the error word, the blocks, the levels pulled
// and pushed, and the levels run by block 0 alone and by the grid. The
// launch's error code is returned.
extern "C" int bibfs_restricted_sweep(
    const void* row_ptr, const void* col_ind, int64_t n, int b, int lanes,
    int dst, int64_t dense_edges, int64_t solo_cap, int max_level, void* dist,
    const void* seeds, int64_t n_seeds, int64_t n_hops, void* reach,
    void* front0, void* front1, void* front2, void* mark, void* rings,
    int64_t ring_len, void* ctl, void* status, void* stream) {
  if (n < 1 || n > INT32_MAX || b < 1 || dst < 0 || dst >= n || !pow2(lanes) ||
      lanes > 32 || n_seeds < 0 || n_hops < 0 || n_hops > n_seeds ||
      !pow2(ring_len) || ring_len < n) {
    return (int)cudaErrorInvalidValue;
  }
  SweepArgs a;
  a.row_ptr = (const int64_t*)row_ptr;
  a.col_ind = (const int32_t*)col_ind;
  a.n = n;
  a.b = b;
  a.wp = (b + 31) / 32;
  a.lanes = lanes;
  a.dst = dst;
  a.dense_edges = dense_edges;
  a.solo_cap = solo_cap;
  a.max_level = max_level;
  a.dist = (int32_t*)dist;
  a.seeds = (const int32_t*)seeds;
  a.n_seeds = n_seeds;
  a.n_hops = n_hops;
  a.reach = (uint32_t*)reach;
  a.front[0] = (uint32_t*)front0;
  a.front[1] = (uint32_t*)front1;
  a.front[2] = (uint32_t*)front2;
  a.mark = (int32_t*)mark;
  a.rings = (int32_t*)rings;
  a.mask = (u64)ring_len - 1;
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
