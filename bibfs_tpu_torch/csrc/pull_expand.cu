// Pull expansion of one BFS level over the slot-major table.
//
// pull_dual_kernel replaces bibfs_tpu/ops/pallas_expand.py _pull_kernel_dual
// (both sides of a lock-step level) and pull_kernel replaces _pull_kernel
// (one side). For each side, nf[v] is 1 when row v is unvisited and one of
// its live slots holds a frontier vertex; the parent is that neighbour in
// the lowest hit slot (no slot * KS + nbr key), and -1 where nf[v] is 0.
//
// Bound on the H100: device-memory bytes. Each unvisited row reads its
// live slots of nbr_t (4 B each) until each wanted side has a hit; every
// row reads its visited bytes and writes 5 bytes per side; the frontier
// is read and the next one written as bitmaps (1/8 B per row per side).
// Integer work (a few operations per slot) is never the bound. The card
// moves 32-byte sectors, and a sector of the slot-major table is one slot
// of 8 consecutive rows, so the bytes moved exceed the slots needed.
//
// Design: a warp takes a tile of 32 consecutive rows, one thread a row,
// and claims each row with the chunked claim of level_common.cuh: the
// row's degree bounds it (no sentinel is read), a chunk's 8 slot loads
// are in flight together, then the chunk's 8 frontier loads, and the next
// chunk is read only while a wanted side has no hit. The frontier is a
// bitmap (kernel 4) or the pair row of both sides (kernel 3: one load per
// slot answers both), read through the read-only path; the warp writes
// the next frontier in the same form from __ballot_sync, so the caller
// hands it to the next round as it is. The grid covers every tile once:
// a persistent grid, and staging kernel 4's bitmap in shared memory
// (which caps it at 32 warps per SM where it runs 64), measured no faster.
#include "level_common.cuh"

using namespace bibfs;

namespace {

// What a launch reads and writes. `front` holds n_ids vertices (a bitmap,
// or the pair row); the next frontier goes to `out`, written for `tiles`
// warp tiles (rows past n_rows write zero bits).
struct PullArgs {
  const int32_t* nbr_t;
  int64_t stride;
  int wp;
  int64_t n_rows;
  const int32_t* deg;
  const uint32_t* front;
  uint32_t n_ids;
  const uint8_t* vis_s;
  const uint8_t* vis_t;
  uint8_t* nf_s;
  int32_t* pc_s;
  uint8_t* nf_t;
  int32_t* pc_t;
  uint32_t* out;
  int64_t tiles;
};

// Bits 0..15 of x spread to the even bits of a word (bit i to bit 2i).
__device__ __forceinline__ uint32_t spread_even(uint32_t x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// The warp's tile: claim its rows, write nf and the parent, then the next
// frontier's word(s) of the tile.
template <bool kDual, class Front>
__device__ __forceinline__ void pull_tile(const PullArgs& a, const Front& front) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = (int64_t)blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (tile >= a.tiles) return;  // the same answer for the whole warp
  const int64_t v = (tile << 5) + lane;
  unsigned got = 0u;
  if (v < a.n_rows) {
    // the visited bytes and the degree load together, not one after the
    // other
    const uint8_t vs = __ldg(a.vis_s + v);
    const uint8_t vt = kDual ? __ldg(a.vis_t + v) : 1;
    const int32_t dg = __ldg(a.deg + v);
    const unsigned want = (vs ? 0u : 1u) | (vt ? 0u : 2u);
    int32_t p0 = -1, p1 = -1;
    if (want) {
      got = claim_chunked(a.nbr_t, a.stride, min(dg, a.wp), v, front, want,
                          &p0, &p1);
    }
    a.nf_s[v] = (uint8_t)(got & 1u);
    a.pc_s[v] = p0;
    if (kDual) {
      a.nf_t[v] = (uint8_t)(got >> 1);
      a.pc_t[v] = p1;
    }
  }
  const unsigned ws = __ballot_sync(0xffffffffu, got & 1u);
  if constexpr (!kDual) {
    if (lane == 0) a.out[tile] = ws;
  } else {
    const unsigned wt = __ballot_sync(0xffffffffu, got & 2u);
    if (lane < 2) {  // rows 16 lane .. 16 lane + 15 of the tile
      const unsigned sh = lane << 4;
      a.out[2 * tile + lane] = spread_even(ws >> sh) | (spread_even(wt >> sh) << 1);
    }
  }
}

// Kernel 4: one side, from its bitmap.
__global__ void __launch_bounds__(kBlock) pull_kernel(PullArgs a) {
  pull_tile<false>(a, BitsFront{a.front, nullptr, a.n_ids});
}

// Kernel 3: both sides, from the pair row.
__global__ void __launch_bounds__(kBlock) pull_dual_kernel(PullArgs a) {
  pull_tile<true>(a, PairFront{a.front, a.n_ids});
}

int launch_pull(void (*kernel)(PullArgs), const PullArgs& a, void* stream) {
  if (a.n_rows > 0) {
    const unsigned grid = (unsigned)((a.tiles + kBlock / 32 - 1) / (kBlock / 32));
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 4. `bits` holds words_in words (32 vertices each); `out` takes
// `tiles` words.
extern "C" int bibfs_pull(const void* nbr_t, int64_t stride, int wp,
                          int64_t n_rows, const void* deg, const void* bits,
                          int64_t words_in, const void* vis, void* nf,
                          void* pc, void* out, int64_t tiles, void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)bits,
                   (uint32_t)(words_in * 32), (const uint8_t*)vis, nullptr,
                   (uint8_t*)nf, (int32_t*)pc, nullptr, nullptr,
                   (uint32_t*)out, tiles};
  return launch_pull(&pull_kernel, a, stream);
}

// Kernel 3. `pair` holds words_in words (16 vertices each); `out` takes
// 2 * tiles words.
extern "C" int bibfs_pull_dual(const void* nbr_t, int64_t stride, int wp,
                               int64_t n_rows, const void* deg,
                               const void* pair, int64_t words_in,
                               const void* vis_s, const void* vis_t,
                               void* nf_s, void* pc_s, void* nf_t, void* pc_t,
                               void* out, int64_t tiles, void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)pair,
                   (uint32_t)(words_in * 16), (const uint8_t*)vis_s,
                   (const uint8_t*)vis_t, (uint8_t*)nf_s, (int32_t*)pc_s,
                   (uint8_t*)nf_t, (int32_t*)pc_t, (uint32_t*)out, tiles};
  return launch_pull(&pull_dual_kernel, a, stream);
}
