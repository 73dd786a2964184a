// One whole search round per launch, with the state kept on the device.
//
// fused_dual_kernel replaces bibfs_tpu/ops/pallas_fused.py _fused_kernel
// (a lock-step round for both sides); fused_single_kernel replaces
// _fused_kernel_single (an alt round for the smaller side only).
// fold_round_kernel replaces the scalar fixup the dense solver applies
// after each fused round (bibfs_tpu/solvers/dense.py, dense_fused_kernel
// and dense_fused_alt_kernel bodies) and runs on one thread.
//
// Bound on the H100: device-memory bytes. A round reads the live slots of
// the unvisited rows (4 B each) until each wanted side has a hit, their
// degrees, the dist rows (4 B per side per row) and the frontier bitmaps,
// and writes the next bitmaps plus dist and par of each newly reached
// vertex. Integer work (a few operations per slot) is never the bound.
// The card moves whole 32-byte sectors, and a sector of the slot-major
// table is one slot of 8 consecutive rows: it is read when any of the 8
// rows needs that slot, so the bytes moved exceed the slots needed.
//
// The frontier is a bitmap, one bit per vertex per side (uint32 words,
// bit u & 31 of word u >> 5), in two parity buffers per side:
// bits[side][lvl & 1] is the frontier at that side's level lvl, read
// from the state row. A round reads parity lvl & 1 and writes parity
// (lvl + 1) & 1, so the host swaps nothing, and an alt round leaves the
// passive side's bitmap where it is.
//
// What holds a row-at-a-time claim back, and what each design step does
// about it:
// 1. A dependent load chain per thread (slot j, then its frontier word,
//    then slot j + 1). The claim (claim_chunked in level_common.cuh, the
//    one claim of all four kernels) reads deg[v] once, bounds the row by
//    min(deg, width) instead of testing a sentinel, and walks it in
//    chunks of kChunk slots: the chunk's slot loads (coalesced across
//    the warp, the table being slot-major) are issued together, then its
//    frontier lookups, then the lowest hit slot per wanted side is taken.
//    The next chunk is read only while a wanted side has no hit, so a row
//    reads at most kChunk - 1 slots past its first hit.
// 2. Many small blocks, each with its own reductions and atomics. The
//    grid is persistent: as many blocks as the card holds at once, each
//    warp striding over tiles of 32 consecutive rows and loading its next
//    tile's dist and deg entries while it claims the current one. Counts,
//    max degrees, degree sums and the meet key stay in registers across
//    the loop and are reduced once per block (warp shuffles, one shared
//    exchange, one set of atomics).
// 3. A byte per vertex, so each random lookup moves a 32-byte L2 sector
//    for one useful byte. The bitmap is 8x smaller (128 KB per side at
//    2^20 vertices), read through the read-only path, and a warp writes
//    its tile's next frontier as one word per side with __ballot_sync.
// 4. (single-side kernel) The active side's bitmap is staged into shared
//    memory at the start of the round by Hopper's bulk asynchronous copy
//    (cp.async.bulk completing on an mbarrier) when it fits one block's
//    227 KB (up to about 1.8M rows); every lookup then hits shared
//    memory. Above that the same template reads it through __ldg.
//
// Exactness is that of the reference: the lowest hit slot gives the
// parent (no slot * KS + nbr key), the meet vote is an atomicMin on the
// 64-bit key (sum << 32) | vertex (lowest sum, then lowest id), and the
// counts, maxima and sums are order-free integers, so any grid size and
// either instantiation of the single-side kernel give the same result.
//
// A shard of a vertex-sharded search (bibfs_tpu_torch/solvers/sharded.py)
// launches the same kernels over its own rows: the table holds global ids
// in [0, id_space) (the sentinel is id_space), the input bitmaps span the
// id space, local row v is global vertex row_offset + v (the meet key's
// id), and the next bitmaps are written for the local tiles only. A single
// device passes id_space = n_rows and row_offset = 0.
//
// The level kernels read the state row and return at once when the
// search has stopped; the fold applies the round to the state under the
// same test and clears the accumulators. A host can so launch several
// rounds between reads of the state: rounds past the end do nothing.
#include "level_common.cuh"

using namespace bibfs;

namespace {

constexpr int kStagedBlock = 1024;   // one block per SM holds a 128 KB bitmap

__device__ __forceinline__ unsigned long long meet_key(int32_t d_a, int32_t d_b,
                                                       int64_t v) {
  if (d_a >= kInf || d_b >= kInf) return kNoMeet;
  return ((unsigned long long)(uint32_t)(d_a + d_b) << 32) | (uint32_t)v;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}

// One row's dist entries (two sides) and degree, which decide whether
// and how far the row is walked.
struct Row {
  int32_t d0, d1, dg;
};

// Row v's entries, for the next tile a warp will take: loaded a tile
// ahead, their latency hides behind the current tile's claim. Rows past
// n_rows read as unreachable and are never claimed.
__device__ __forceinline__ Row load_row(const int32_t* d0, const int32_t* d1,
                                        const int32_t* __restrict__ deg,
                                        int64_t v, int64_t n_rows) {
  Row r{kInf, kInf, 0};
  if (v < n_rows) {
    r.d0 = d0[v];
    r.d1 = d1[v];
    r.dg = __ldg(deg + v);
  }
  return r;
}

// Reduce the block's tally once and make one set of atomics into `acc`
// and `meet`. t = {cnt_a, cnt_b, md_a, md_b, ds_a, ds_b}: side a lands at
// acc offset side_a, side b at 1 - side_a. The counts are already
// warp-uniform (popcounts of the ballots); the rest are per thread.
template <int kWarps>
__device__ __forceinline__ void flush_tally(int (&t)[6], unsigned long long key,
                                            int side_a, int32_t* acc,
                                            unsigned long long* meet) {
  __shared__ int part[kWarps][6];
  __shared__ unsigned long long part_key[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 2; i < 4; ++i) t[i] = warp_reduce(t[i], MaxOp{});
#pragma unroll
  for (int i = 4; i < 6; ++i) t[i] = warp_reduce(t[i], SumOp{});
  key = warp_reduce(key, MinOp{});
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) part[warp][i] = t[i];
    part_key[warp] = key;
  }
  __syncthreads();
  if (warp != 0) return;
  int x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = lane < kWarps ? part[lane][i] : 0;
  key = lane < kWarps ? part_key[lane] : kNoMeet;
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = warp_reduce(x[i], SumOp{});
#pragma unroll
  for (int i = 2; i < 4; ++i) x[i] = warp_reduce(x[i], MaxOp{});
#pragma unroll
  for (int i = 4; i < 6; ++i) x[i] = warp_reduce(x[i], SumOp{});
  key = warp_reduce(key, MinOp{});
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (x[s]) {
        const int side = s ? 1 - side_a : side_a;
        atomicAdd(acc + kAccCnt + side, x[s]);
        atomicMax(acc + kAccMd + side, x[2 + s]);
        atomicAdd(acc + kAccDs + side, x[4 + s]);
      }
    }
    if (key != kNoMeet) atomicMin(meet, key);
  }
}

// The lock-step round: both sides claim from one read of each row.
__global__ void __launch_bounds__(kBlock) fused_dual_kernel(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t n_rows,
    int64_t id_space, int64_t row_offset, const int32_t* __restrict__ deg,
    uint32_t* bits, int64_t nw_pad, int32_t* dist_s, int32_t* dist_t,
    int32_t* par_s, int32_t* par_t, const int32_t* __restrict__ state,
    int32_t* acc, unsigned long long* meet) {
  if (!search_active(state)) return;  // the same answer for every thread
  const int32_t lvl_s = state[kLvlS];
  const int32_t lvl_t = state[kLvlT];
  const uint32_t* in_s = bits + (lvl_s & 1) * nw_pad;
  const uint32_t* in_t = bits + (2 + (lvl_t & 1)) * nw_pad;
  uint32_t* out_s = bits + ((lvl_s + 1) & 1) * nw_pad;
  uint32_t* out_t = bits + (2 + ((lvl_t + 1) & 1)) * nw_pad;
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (n_rows + 31) >> 5;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  int t[6] = {0, 0, 0, 0, 0, 0};
  unsigned long long key = kNoMeet;
  int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  Row next = load_row(dist_s, dist_t, deg, (tile << 5) + lane, n_rows);
  for (; tile < tiles; tile += step) {
    const int64_t v = (tile << 5) + lane;
    const Row row = next;
    next = load_row(dist_s, dist_t, deg, ((tile + step) << 5) + lane, n_rows);
    unsigned got = 0u;
    if (v < n_rows) {
      int32_t d_s = row.d0;
      int32_t d_t = row.d1;
      const unsigned want = (d_s >= kInf ? 1u : 0u) | (d_t >= kInf ? 2u : 0u);
      if (want) {
        const int32_t dg = row.dg;
        int32_t p_s = -1, p_t = -1;
        got = claim_chunked(nbr_t, stride, min(dg, wp), v,
                            BitsFront{in_s, in_t, (uint32_t)id_space}, want,
                            &p_s, &p_t);
        if (got & 1u) {
          d_s = lvl_s + 1;
          dist_s[v] = d_s;
          par_s[v] = p_s;
          t[2] = max(t[2], dg);
          t[4] += dg;
        }
        if (got & 2u) {
          d_t = lvl_t + 1;
          dist_t[v] = d_t;
          par_t[v] = p_t;
          t[3] = max(t[3], dg);
          t[5] += dg;
        }
      }
      key = umin64(key, meet_key(d_s, d_t, row_offset + v));
    }
    const unsigned ws = __ballot_sync(0xffffffffu, got & 1u);
    const unsigned wt = __ballot_sync(0xffffffffu, got & 2u);
    if (lane == 0) {
      out_s[tile] = ws;
      out_t[tile] = wt;
    }
    t[0] += __popc(ws);
    t[1] += __popc(wt);
  }
  flush_tally<kWarps>(t, key, 0, acc, meet);
}

// The alt round: the smaller frontier (the source on a tie), chosen from
// the state on the device, claims; the other side is only read.
template <bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStagedBlock : kBlock)
fused_single_kernel(const int32_t* __restrict__ nbr_t, int64_t stride, int wp,
                    int64_t n_rows, int64_t id_space, int64_t row_offset,
                    const int32_t* __restrict__ deg,
                    uint32_t* bits, int64_t nw_pad, int32_t* dist_s,
                    int32_t* dist_t, int32_t* par_s, int32_t* par_t,
                    const int32_t* __restrict__ state, int32_t* acc,
                    unsigned long long* meet) {
  if (!search_active(state)) return;
  const int side = state[kCntS] <= state[kCntT] ? 0 : 1;
  const int32_t lvl = state[kLvlS + side];
  const uint32_t* in = bits + (2 * side + (lvl & 1)) * nw_pad;
  uint32_t* out = bits + (2 * side + ((lvl + 1) & 1)) * nw_pad;
  int32_t* dist_a = side ? dist_t : dist_s;
  const int32_t* dist_p = side ? dist_s : dist_t;
  int32_t* par_a = side ? par_t : par_s;
  constexpr int kWarps = (kStaged ? kStagedBlock : kBlock) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (n_rows + 31) >> 5;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  int t[6] = {0, 0, 0, 0, 0, 0};
  unsigned long long key = kNoMeet;
  int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  Row next = load_row(dist_a, dist_p, deg, (tile << 5) + lane, n_rows);
  if constexpr (kStaged) {  // the first rows load while the bitmap copies
    __shared__ __align__(8) unsigned long long bar;
    stage_bitmap(in, (uint32_t)(nw_pad * 4), &bar);
  }
  for (; tile < tiles; tile += step) {
    const int64_t v = (tile << 5) + lane;
    const Row row = next;
    next = load_row(dist_a, dist_p, deg, ((tile + step) << 5) + lane, n_rows);
    unsigned got = 0u;
    if (v < n_rows) {
      int32_t d_a = row.d0;
      const int32_t d_p = row.d1;
      if (d_a >= kInf) {
        const int32_t dg = row.dg;
        int32_t p = -1, unused = -1;
        if constexpr (kStaged) {
          got = claim_chunked(nbr_t, stride, min(dg, wp), v,
                              StagedFront{(uint32_t)id_space}, 1u, &p, &unused);
        } else {
          got = claim_chunked(nbr_t, stride, min(dg, wp), v,
                              BitsFront{in, nullptr, (uint32_t)id_space}, 1u,
                              &p, &unused);
        }
        if (got) {
          d_a = lvl + 1;
          dist_a[v] = d_a;
          par_a[v] = p;
          t[2] = max(t[2], dg);
          t[4] += dg;
        }
      }
      key = umin64(key, meet_key(d_a, d_p, row_offset + v));
    }
    const unsigned w = __ballot_sync(0xffffffffu, got);
    if (lane == 0) out[tile] = w;
    t[0] += __popc(w);
  }
  flush_tally<kWarps>(t, key, side, acc, meet);
}

}  // namespace

// Apply one round's reductions to the state: best = min, meet take,
// levels += 2 (dual) or 1 (alt), edges += the degree sums of the frontier
// this round expanded (produced by the previous round), then the new
// counts, max degrees and degree sums; then clear the accumulators.
__global__ void fold_round_kernel(int32_t* state, int32_t* acc,
                                  unsigned long long* meet, int alt) {
  if (search_active(state)) {
    const int side = state[kCntS] <= state[kCntT] ? 0 : 1;
    const unsigned long long key = *meet;
    if (key != kNoMeet) {
      const int32_t mval = (int32_t)(key >> 32);
      if (mval < state[kBest]) {
        state[kBest] = mval;
        state[kMeet] = (int32_t)(key & 0xffffffffull);
      }
    }
    for (int s = 0; s < 2; ++s) {
      if (alt && s != side) continue;
      state[kEdges] += state[kDsS + s];
      state[kLvlS + s] += 1;
      state[kCntS + s] = acc[kAccCnt + s];
      state[kMdS + s] = acc[kAccMd + s];
      state[kDsS + s] = acc[kAccDs + s];
    }
    state[kLevels] += alt ? 1 : 2;
  }
  for (int i = 0; i < kAccLen; ++i) acc[i] = 0;
  *meet = kNoMeet;
}

namespace {

typedef void (*RoundKernel)(const int32_t*, int64_t, int, int64_t, int64_t,
                            int64_t, const int32_t*, uint32_t*, int64_t,
                            int32_t*, int32_t*, int32_t*, int32_t*,
                            const int32_t*, int32_t*, unsigned long long*);

// Blocks of `kernel` the card holds at once with `dyn` bytes of dynamic
// shared memory each: SMs x resident blocks per SM, queried at the first
// launch (and again when the device or `dyn` changes). A staged kernel
// is also allowed, once, all the dynamic shared memory a block can opt in
// to.
struct Resident {
  int dev = -1;
  size_t dyn = 0;
  int blocks = 0;
  int max_dyn = -1;
};

int resident_blocks(RoundKernel kernel, int block, size_t dyn, Resident* r,
                    int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != r->dev || dyn != r->dyn) {
    if (dyn > 0 && (dev != r->dev || r->max_dyn < 0)) {
      int optin = 0;
      cudaFuncAttributes attr;
      if ((e = cudaDeviceGetAttribute(
               &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
          (e = cudaFuncGetAttributes(&attr, (const void*)kernel)))
        return (int)e;
      r->max_dyn = optin - (int)attr.sharedSizeBytes;
      e = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               r->max_dyn);
      if (e != cudaSuccess) return (int)e;
    }
    if (dyn > 0 && (int64_t)dyn > r->max_dyn) return (int)cudaErrorInvalidValue;
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           block, dyn)))
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    r->dev = dev;
    r->dyn = dyn;
    r->blocks = sms * per_sm;
  }
  *blocks = r->blocks;
  return 0;
}

// One launch of `kernel` over n_rows rows in tiles of 32 on a persistent
// grid: the resident block count (or fewer blocks when there are fewer
// tiles), each warp striding over the tiles.
int launch_round(RoundKernel kernel, int block, size_t dyn, Resident* r,
                 const void* nbr_t, int64_t stride, int wp, int64_t n_rows,
                 int64_t id_space, int64_t row_offset, const void* deg,
                 void* bits, int64_t nw_pad, void* dist_s, void* dist_t,
                 void* par_s, void* par_t, const void* state, void* acc,
                 void* meet, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (n_rows + 31) / 32;
  const int64_t warps = block / 32;
  int64_t grid = (tiles + warps - 1) / warps;
  int resident = 0;
  const int e = resident_blocks(kernel, block, dyn, r, &resident);
  if (e != 0) return e;
  if (grid > resident) grid = resident;
  kernel<<<(unsigned)grid, block, dyn, (cudaStream_t)stream>>>(
      (const int32_t*)nbr_t, stride, wp, n_rows, id_space, row_offset,
      (const int32_t*)deg, (uint32_t*)bits, nw_pad, (int32_t*)dist_s,
      (int32_t*)dist_t,
      (int32_t*)par_s, (int32_t*)par_t, (const int32_t*)state, (int32_t*)acc,
      (unsigned long long*)meet);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 1. `bits` holds 4 rows of nw_pad words over the id space.
extern "C" int bibfs_fused_dual(const void* nbr_t, int64_t stride, int wp,
                                int64_t n_rows, int64_t id_space,
                                int64_t row_offset, const void* deg, void* bits,
                                int64_t nw_pad, void* dist_s, void* dist_t,
                                void* par_s, void* par_t, const void* state,
                                void* acc, void* meet, void* stream) {
  static Resident r;
  return launch_round(&fused_dual_kernel, kBlock, 0, &r, nbr_t, stride, wp,
                      n_rows, id_space, row_offset, deg, bits, nw_pad,
                      dist_s, dist_t, par_s, par_t, state, acc, meet, stream);
}

// Kernel 2. staged = 1 copies the active bitmap (nw_pad * 4 bytes) into
// shared memory first and takes 1024-thread blocks; staged = 0 reads it
// through __ldg.
extern "C" int bibfs_fused_single(const void* nbr_t, int64_t stride, int wp,
                                  int64_t n_rows, int64_t id_space,
                                  int64_t row_offset, const void* deg,
                                  void* bits, int64_t nw_pad, void* dist_s,
                                  void* dist_t,
                                  void* par_s, void* par_t, const void* state,
                                  void* acc, void* meet, int staged,
                                  void* stream) {
  static Resident r, rs;
  if (staged) {
    if (nw_pad % 4 != 0) return (int)cudaErrorInvalidValue;
    return launch_round(&fused_single_kernel<true>, kStagedBlock,
                        (size_t)nw_pad * 4, &rs, nbr_t, stride, wp, n_rows,
                        id_space, row_offset, deg, bits, nw_pad, dist_s,
                        dist_t, par_s, par_t, state, acc, meet, stream);
  }
  return launch_round(&fused_single_kernel<false>, kBlock, 0, &r, nbr_t,
                      stride, wp, n_rows, id_space, row_offset, deg, bits,
                      nw_pad, dist_s, dist_t, par_s, par_t, state, acc, meet,
                      stream);
}

extern "C" int bibfs_fold_round(void* state, void* acc, void* meet, int alt,
                                void* stream) {
  fold_round_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int32_t*)state, (int32_t*)acc, (unsigned long long*)meet, alt);
  return (int)cudaGetLastError();
}
