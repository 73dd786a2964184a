// Device code shared by the four level kernels (pull_expand.cu,
// fused_level.cu): the first-hit-slot claim and a block reduction.
//
// Tables are slot-major and sentinel-padded: nbr_t[j * stride + v] is the
// j-th neighbour of vertex row v, and every dead slot holds an id >=
// id_space (the sentinel), so the live slots of a row are a prefix. The
// frontier is one byte per vertex; bit 0 is the source side and bit 1 the
// target side.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bibfs {

constexpr int32_t kInf = 1 << 30;               // unreached distance
constexpr int kBlock = 256;                     // threads (vertex rows) per block
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

// THE claim routine of all four kernels. Walk row v's slots in order and,
// for each bit of `want` (1 = source side, 2 = target side), record in
// *par0 / *par1 the neighbour of the lowest slot whose frontier byte has
// that bit. Stops at the first sentinel slot or once every wanted bit is
// found. Returns the bits that were found. A sentinel id reads as no hit
// through the bounds check, so the frontier row is never read past its end.
__device__ __forceinline__ unsigned claim_first_slot(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t v,
    const uint8_t* __restrict__ front, int64_t id_space, unsigned want,
    int32_t* par0, int32_t* par1) {
  unsigned got = 0u;
  for (int j = 0; j < wp && got != want; ++j) {
    const int32_t u = __ldg(nbr_t + (int64_t)j * stride + v);
    if (u < 0 || (int64_t)u >= id_space) break;
    const unsigned b = (unsigned)__ldg(front + u) & want & ~got;
    if (b & 1u) *par0 = u;
    if (b & 2u) *par1 = u;
    got |= b;
  }
  return got;
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

// Block-wide reduction of one value per thread; the result is valid in
// thread 0. Every thread of the block must call it (no early return before
// it), and the block size is a multiple of 32 and at most kBlock.
template <class T, class Op>
__device__ T block_reduce(T x, Op op, T identity) {
  __shared__ T partial[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_reduce(x, op);
  __syncthreads();  // a previous call's partials have been read
  if (lane == 0) partial[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? partial[lane] : identity;
    x = warp_reduce(x, op);
  }
  return x;
}

inline unsigned grid_for(int64_t n_rows) {
  return (unsigned)((n_rows + kBlock - 1) / kBlock);
}

}  // namespace bibfs

extern "C" const char* bibfs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
