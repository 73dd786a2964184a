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
// the unvisited rows (4 B each, plus a frontier byte each), the dist rows
// (4 B per side per row) and the frontier row, and writes the next
// frontier row plus dist and par of each newly reached vertex. The
// frontier row (1 B per vertex) stays in the 50 MB L2 at 2^20 vertices.
//
// Design:
// - One thread per vertex row; the frontier lookup dual_in[nbr_t[j, v]]
//   happens inside the kernel, behind a bounds check that makes the
//   sentinel id read as no hit. A side that is already visited is not
//   looked up, and a row stops at its first sentinel slot.
// - The first hit slot gives the parent (the lowest-slot rule), so no
//   slot*KS+nbr key is needed.
// - dist and par are updated in place: each thread reads and writes only
//   its own row entry. The frontier row is ping-ponged between two
//   buffers (dual_in, dual_out), since threads read other rows' bits.
// - Blocks run in no order, so the TPU's sequential-grid (1,1)
//   accumulators become a block reduction plus one atomic per block into
//   `acc` (counts and degree sums by atomicAdd, max degree by atomicMax)
//   and, for the meet vote, an atomicMin on the 64-bit key
//   (sum << 32) | vertex: lowest sum first, then lowest id. Integer sums,
//   mins and maxes are order-free, so the results are deterministic.
// - The level kernels read lvl + 1 from the state row and return at once
//   when the search has stopped; the fold applies the round to the state
//   under the same test and clears the accumulators. A host can so launch
//   several rounds between reads of the state: rounds past the end do
//   nothing.
#include "level_common.cuh"

using namespace bibfs;

__device__ __forceinline__ unsigned long long meet_key(int32_t d_a, int32_t d_b,
                                                       int64_t v) {
  if (d_a >= kInf || d_b >= kInf) return kNoMeet;
  return ((unsigned long long)(uint32_t)(d_a + d_b) << 32) | (uint32_t)v;
}

__global__ void __launch_bounds__(kBlock) fused_dual_kernel(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t n_rows,
    const int32_t* __restrict__ deg, const uint8_t* __restrict__ dual_in,
    int64_t id_space, uint8_t* __restrict__ dual_out, int32_t* dist_s,
    int32_t* dist_t, int32_t* par_s, int32_t* par_t,
    const int32_t* __restrict__ state, int32_t* acc,
    unsigned long long* meet) {
  if (!search_active(state)) return;  // the same answer for every thread
  const int32_t lvl_s = state[kLvlS] + 1;
  const int32_t lvl_t = state[kLvlT] + 1;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int cnt_s = 0, cnt_t = 0, md_s = 0, md_t = 0, ds_s = 0, ds_t = 0;
  unsigned long long key = kNoMeet;
  if (v < n_rows) {
    int32_t d_s = dist_s[v];
    int32_t d_t = dist_t[v];
    const unsigned want = (d_s >= kInf ? 1u : 0u) | (d_t >= kInf ? 2u : 0u);
    int32_t p_s = -1, p_t = -1;
    unsigned got = 0u;
    if (want) {
      got = claim_first_slot(nbr_t, stride, wp, v, dual_in, id_space, want,
                             &p_s, &p_t);
    }
    if (got) {
      const int32_t dg = deg[v];
      if (got & 1u) {
        d_s = lvl_s;
        dist_s[v] = lvl_s;
        par_s[v] = p_s;
        cnt_s = 1; md_s = dg; ds_s = dg;
      }
      if (got & 2u) {
        d_t = lvl_t;
        dist_t[v] = lvl_t;
        par_t[v] = p_t;
        cnt_t = 1; md_t = dg; ds_t = dg;
      }
    }
    dual_out[v] = (uint8_t)got;
    key = meet_key(d_s, d_t, v);
  }
  cnt_s = block_reduce(cnt_s, SumOp{}, 0);
  cnt_t = block_reduce(cnt_t, SumOp{}, 0);
  md_s = block_reduce(md_s, MaxOp{}, 0);
  md_t = block_reduce(md_t, MaxOp{}, 0);
  ds_s = block_reduce(ds_s, SumOp{}, 0);
  ds_t = block_reduce(ds_t, SumOp{}, 0);
  key = block_reduce(key, MinOp{}, kNoMeet);
  if (threadIdx.x == 0) {
    if (cnt_s) {
      atomicAdd(acc + kAccCnt, cnt_s);
      atomicMax(acc + kAccMd, md_s);
      atomicAdd(acc + kAccDs, ds_s);
    }
    if (cnt_t) {
      atomicAdd(acc + kAccCnt + 1, cnt_t);
      atomicMax(acc + kAccMd + 1, md_t);
      atomicAdd(acc + kAccDs + 1, ds_t);
    }
    if (key != kNoMeet) atomicMin(meet, key);
  }
}

__global__ void __launch_bounds__(kBlock) fused_single_kernel(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t n_rows,
    const int32_t* __restrict__ deg, const uint8_t* __restrict__ dual_in,
    int64_t id_space, uint8_t* __restrict__ dual_out, int32_t* dist_s,
    int32_t* dist_t, int32_t* par_s, int32_t* par_t,
    const int32_t* __restrict__ state, int32_t* acc,
    unsigned long long* meet) {
  if (!search_active(state)) return;
  // the alt schedule advances the smaller frontier, the source on a tie
  const int side = state[kCntS] <= state[kCntT] ? 0 : 1;
  const unsigned bit = 1u << side;
  const unsigned passive = 3u ^ bit;
  const int32_t lvl = state[kLvlS + side] + 1;
  int32_t* dist_a = side ? dist_t : dist_s;
  const int32_t* dist_p = side ? dist_s : dist_t;
  int32_t* par_a = side ? par_t : par_s;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int cnt = 0, md = 0, ds = 0;
  unsigned long long key = kNoMeet;
  if (v < n_rows) {
    int32_t d_a = dist_a[v];
    const int32_t d_p = dist_p[v];
    int32_t p[2] = {-1, -1};
    unsigned got = 0u;
    if (d_a >= kInf) {
      got = claim_first_slot(nbr_t, stride, wp, v, dual_in, id_space, bit,
                             &p[0], &p[1]);
    }
    if (got) {
      const int32_t dg = deg[v];
      d_a = lvl;
      dist_a[v] = lvl;
      par_a[v] = p[side];
      cnt = 1; md = dg; ds = dg;
    }
    dual_out[v] = (uint8_t)((dual_in[v] & passive) | got);
    key = meet_key(d_a, d_p, v);
  }
  cnt = block_reduce(cnt, SumOp{}, 0);
  md = block_reduce(md, MaxOp{}, 0);
  ds = block_reduce(ds, SumOp{}, 0);
  key = block_reduce(key, MinOp{}, kNoMeet);
  if (threadIdx.x == 0) {
    if (cnt) {
      atomicAdd(acc + kAccCnt + side, cnt);
      atomicMax(acc + kAccMd + side, md);
      atomicAdd(acc + kAccDs + side, ds);
    }
    if (key != kNoMeet) atomicMin(meet, key);
  }
}

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

typedef void (*RoundKernel)(const int32_t*, int64_t, int, int64_t,
                            const int32_t*, const uint8_t*, int64_t, uint8_t*,
                            int32_t*, int32_t*, int32_t*, int32_t*,
                            const int32_t*, int32_t*, unsigned long long*);

static int launch_round(RoundKernel kernel, const void* nbr_t, int64_t stride,
                        int wp, int64_t n_rows, const void* deg,
                        const void* dual_in, int64_t id_space, void* dual_out,
                        void* dist_s, void* dist_t, void* par_s, void* par_t,
                        const void* state, void* acc, void* meet,
                        void* stream) {
  if (n_rows > 0) {
    kernel<<<grid_for(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbr_t, stride, wp, n_rows, (const int32_t*)deg,
        (const uint8_t*)dual_in, id_space, (uint8_t*)dual_out,
        (int32_t*)dist_s, (int32_t*)dist_t, (int32_t*)par_s, (int32_t*)par_t,
        (const int32_t*)state, (int32_t*)acc, (unsigned long long*)meet);
  }
  return (int)cudaGetLastError();
}

extern "C" int bibfs_fused_dual(const void* nbr_t, int64_t stride, int wp,
                                int64_t n_rows, const void* deg,
                                const void* dual_in, int64_t id_space,
                                void* dual_out, void* dist_s, void* dist_t,
                                void* par_s, void* par_t, const void* state,
                                void* acc, void* meet, void* stream) {
  return launch_round(fused_dual_kernel, nbr_t, stride, wp, n_rows, deg,
                      dual_in, id_space, dual_out, dist_s, dist_t, par_s,
                      par_t, state, acc, meet, stream);
}

extern "C" int bibfs_fused_single(const void* nbr_t, int64_t stride, int wp,
                                  int64_t n_rows, const void* deg,
                                  const void* dual_in, int64_t id_space,
                                  void* dual_out, void* dist_s, void* dist_t,
                                  void* par_s, void* par_t, const void* state,
                                  void* acc, void* meet, void* stream) {
  return launch_round(fused_single_kernel, nbr_t, stride, wp, n_rows, deg,
                      dual_in, id_space, dual_out, dist_s, dist_t, par_s,
                      par_t, state, acc, meet, stream);
}

extern "C" int bibfs_fold_round(void* state, void* acc, void* meet, int alt,
                                void* stream) {
  fold_round_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int32_t*)state, (int32_t*)acc, (unsigned long long*)meet, alt);
  return (int)cudaGetLastError();
}
