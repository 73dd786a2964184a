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
//
// The batched forms (pull_dual_batch_kernel, pull_batch_kernel) give both
// kernels a query axis: what pallas_call's batching rule does to
// _pull_kernel_dual / _pull_kernel under the reference's vmapped search
// (bibfs_tpu/solvers/dense.py:1068-1093). B searches share the table and
// degree row. Their frontiers are one query-packed plane of n_rows rows of
// ceil(B / 16) words: bits 2 (q & 15) and 2 (q & 15) + 1 of word q >> 4 of
// row v hold vertex v in query q's source and target frontier (the order
// of ops/minor_level.py). A launch expands the listed queries (`slot[q]`
// is query q's row among them, or -1), kernel 3 both sides of each, kernel
// 4 the side `side[row]` of each; each listed query has visited rows and
// outputs of n_rows at row `slot[q]`, and gets exactly the single-query
// kernel's values there. The next plane holds the new frontier bits of
// every expanded (query, side) and every other bit copied from the input
// plane, so it always holds the whole batch's state.
// Bound: the listed queries' visited rows read and output rows written,
// their frontier bits read and written, and the table slots any of them
// needs, once.
// Design: a warp takes a tile of 32 rows (a lane a row) and one listed
// plane word, the group of 16 queries whose bits it holds. The row's slots
// are walked in ascending order as in the single kernels (a chunk's slot
// loads, then its gathers, in flight together), and each gather fetches
// the neighbour's word of the group: one 4-byte load answers both sides of
// 16 queries, and the table is walked once per group, not once per query.
// A slot's hits are the gathered bits the row still wants (expanded, not
// visited, not yet claimed), so a (query, side)'s first hit is its lowest
// slot with no atomics; a hit's neighbour goes to the lane's column of the
// warp's parent tile in shared memory, indexed by the bit. The row stops
// gathering when every wanted bit of the group is hit. Every store of the
// flush covers the 32 consecutive rows of one listed query (128 B of
// parents, 32 B of nf), and the next plane's word is written once per
// (row, word).
// The grid covers the listed words only (the caller lists them), so a
// word with no listed query costs no warp: where there is one, the next
// plane starts as a copy of the plane (one cudaMemcpyAsync), which the
// kernel overwrites at the listed words. A warp per (tile, word) over
// every word, copying the unlisted ones, cost 0.43 ms more a launch on the
// H100 with one listed query among 256 (block waves of trivial warps).
// A block's 8 warps take 8 consecutive (tile, listed word) items, 8 words
// of one tile where 8 or more are listed, so the groups' gathers fetch the
// same neighbour sectors together. A warp walking every word of its tile
// in turn measured 3.0x slower on the H100 at B = 256.
#include "level_common.cuh"

using namespace bibfs;

namespace {

// What a launch reads and writes. `front` holds the n_ids vertices of the
// id space (a bitmap, or the pair row): the table's rows are n_rows local
// rows whose live slots hold ids in [0, n_ids) (a shard of a
// vertex-sharded search gathers from the global frontier; a single device
// has n_ids = n_rows). The next frontier goes to `out`, written for
// `tiles` warp tiles of the local rows (rows past n_rows write zero
// bits).
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kBlock / 32;

// What a batched launch reads and writes (see the header). `listed`
// holds the n_listed plane words with a listed query, ascending. Kernel 3
// has side null and its two sides' outputs in nf / pc [0] and [1]; kernel
// 4 has one output, in both.
struct PlaneArgs {
  const int32_t* nbr_t;
  int64_t stride;
  int wp;
  int64_t n_rows;
  const int32_t* deg;
  const uint32_t* plane;
  uint32_t* plane_n;
  int64_t words;
  const int32_t* slot;
  const int32_t* listed;
  int64_t n_listed;
  const int32_t* side;
  const uint8_t* vis[2];
  uint8_t* nf[2];
  int32_t* pc[2];
};

// The warp's item: rows 32 tile .. 32 tile + 31 of plane word w. `par` is
// the warp's parent tile, par[bit][lane].
template <bool kDual>
__device__ __forceinline__ void plane_item(const PlaneArgs& a,
                                           int32_t (*par)[32], int64_t tile,
                                           int64_t w) {
  const int lane = threadIdx.x & 31;
  const int64_t v = (tile << 5) + lane;
  const bool in = v < a.n_rows;
  // lane k < 16 holds the row of query 16 w + k (-1: not listed)
  const int32_t mine = lane < 16 ? __ldg(a.slot + 16 * w + lane) : -1;
  const unsigned listed = __ballot_sync(kFull, mine >= 0);
  unsigned tgt = listed, src = listed;  // the queries expanding each side
  if constexpr (!kDual) {
    tgt = __ballot_sync(kFull, mine >= 0 && __ldg(a.side + mine) != 0);
    src = listed & ~tgt;
  }
  const unsigned expd = spread_even(src) | (spread_even(tgt) << 1);
  const uint32_t old = in ? __ldg(a.plane + v * a.words + w) : 0u;
  // the wanted bits: expanded and not visited (all the loads in flight)
  unsigned want = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!((listed >> k) & 1u)) continue;
    const int64_t r = (int64_t)__shfl_sync(kFull, mine, k) * a.n_rows + v;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = 2 * k + s;
      if (in && ((expd >> b) & 1u) && !__ldg(a.vis[s] + r)) want |= 1u << b;
    }
  }
  const int live = want ? min(__ldg(a.deg + v), a.wp) : 0;
  unsigned got = 0u;
  for (int c = 0; __any_sync(kFull, c < live && got != want); c += kChunk) {
    const bool going = got != want;
    int32_t u[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      u[k] = going && c + k < live
                 ? __ldg(a.nbr_t + (int64_t)(c + k) * a.stride + v) : -1;
    }
    uint32_t x[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      x[k] = u[k] >= 0 && u[k] < a.n_rows
                 ? __ldg(a.plane + (int64_t)u[k] * a.words + w) : 0u;
    }
    // ascending, so a bit's first hit is its lowest slot
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      unsigned h = x[k] & want & ~got;
      got |= h;
      while (h) {
        par[__ffs(h) - 1][lane] = u[k];
        h &= h - 1;
      }
    }
  }
  if (in) a.plane_n[v * a.words + w] = (old & ~expd) | got;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!((listed >> k) & 1u)) continue;
    const int64_t r = (int64_t)__shfl_sync(kFull, mine, k) * a.n_rows + v;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = 2 * k + s;
      if (!in || !((expd >> b) & 1u)) continue;
      const bool g = (got >> b) & 1u;
      a.nf[s][r] = (uint8_t)g;
      a.pc[s][r] = g ? par[b][lane] : -1;
    }
  }
}

// A block's warps take consecutive (tile, listed word) items, word-minor.
template <bool kDual>
__device__ __forceinline__ void plane_block(const PlaneArgs& a) {
  __shared__ int32_t s_par[kWarps][32][32];
  const int warp = threadIdx.x >> 5;
  // the launcher keeps the items below 2^32
  const uint32_t item = blockIdx.x * kWarps + warp;
  const uint32_t tile = item / (uint32_t)a.n_listed;
  if (tile >= (a.n_rows + 31) / 32) return;  // the same for the whole warp
  plane_item<kDual>(a, s_par[warp], tile,
                    __ldg(a.listed + (item - tile * (uint32_t)a.n_listed)));
}

// Kernel 4 with a query axis: each listed query's side.
__global__ void __launch_bounds__(kBlock) pull_batch_kernel(PlaneArgs a) {
  plane_block<false>(a);
}

// Kernel 3 with a query axis: both sides of each listed query.
__global__ void __launch_bounds__(kBlock) pull_dual_batch_kernel(PlaneArgs a) {
  plane_block<true>(a);
}

// The words with no listed query go to the next plane as one copy of the
// plane, which the kernel then overwrites at the listed words.
int launch_plane(void (*kernel)(PlaneArgs), const PlaneArgs& a, void* stream) {
  if (a.n_rows > 0 && a.n_listed < a.words) {
    const cudaError_t e = cudaMemcpyAsync(
        a.plane_n, a.plane, (size_t)(a.n_rows * a.words) * sizeof(uint32_t),
        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.n_rows > 0 && a.n_listed > 0) {
    const int64_t items = (a.n_rows + 31) / 32 * a.n_listed;
    if (items >= (int64_t)1 << 32) return (int)cudaErrorInvalidValue;
    const int64_t grid = (items + kWarps - 1) / kWarps;
    kernel<<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

int launch_pull(void (*kernel)(PullArgs), const PullArgs& a, void* stream) {
  if (a.n_rows > 0) {
    const unsigned grid = (unsigned)((a.tiles + kBlock / 32 - 1) / (kBlock / 32));
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 4. `bits` holds the n_ids vertices of the id space (32 a word);
// `out` takes `tiles` words.
extern "C" int bibfs_pull(const void* nbr_t, int64_t stride, int wp,
                          int64_t n_rows, int64_t n_ids, const void* deg,
                          const void* bits, const void* vis, void* nf,
                          void* pc, void* out, int64_t tiles, void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)bits,
                   (uint32_t)n_ids, (const uint8_t*)vis, nullptr,
                   (uint8_t*)nf, (int32_t*)pc, nullptr, nullptr,
                   (uint32_t*)out, tiles};
  return launch_pull(&pull_kernel, a, stream);
}

// Kernel 3. `pair` holds the n_ids vertices of the id space (16 a word);
// `out` takes 2 * tiles words.
extern "C" int bibfs_pull_dual(const void* nbr_t, int64_t stride, int wp,
                               int64_t n_rows, int64_t n_ids, const void* deg,
                               const void* pair, const void* vis_s,
                               const void* vis_t, void* nf_s, void* pc_s,
                               void* nf_t, void* pc_t, void* out,
                               int64_t tiles, void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)pair,
                   (uint32_t)n_ids, (const uint8_t*)vis_s,
                   (const uint8_t*)vis_t, (uint8_t*)nf_s, (int32_t*)pc_s,
                   (uint8_t*)nf_t, (int32_t*)pc_t, (uint32_t*)out, tiles};
  return launch_pull(&pull_dual_kernel, a, stream);
}

// Kernel 4 with a query axis. `plane` and `plane_n` hold n_rows rows of
// `words` words; `meta` the int32 slot map (16 * words entries), the
// n_listed listed words and one side per listed query (1: the target
// side); `vis_s`, `vis_t`, `nf` and `pc` one row of n_rows per listed
// query.
extern "C" int bibfs_pull_batch(const void* nbr_t, int64_t stride, int wp,
                                int64_t n_rows, const void* deg,
                                const void* plane, void* plane_n,
                                int64_t words, const void* meta,
                                int64_t n_listed, const void* vis_s,
                                const void* vis_t, void* nf, void* pc,
                                void* stream) {
  const int32_t* m = (const int32_t*)meta;
  const PlaneArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                    (const int32_t*)deg, (const uint32_t*)plane,
                    (uint32_t*)plane_n, words, m, m + 16 * words, n_listed,
                    m + 16 * words + n_listed,
                    {(const uint8_t*)vis_s, (const uint8_t*)vis_t},
                    {(uint8_t*)nf, (uint8_t*)nf}, {(int32_t*)pc, (int32_t*)pc}};
  return launch_plane(&pull_batch_kernel, a, stream);
}

// Kernel 3 with a query axis: as bibfs_pull_batch, both sides of each
// listed query (`meta` holds no sides), the source side's outputs in
// nf_s / pc_s.
extern "C" int bibfs_pull_dual_batch(const void* nbr_t, int64_t stride, int wp,
                                     int64_t n_rows, const void* deg,
                                     const void* plane, void* plane_n,
                                     int64_t words, const void* meta,
                                     int64_t n_listed, const void* vis_s,
                                     const void* vis_t, void* nf_s, void* pc_s,
                                     void* nf_t, void* pc_t, void* stream) {
  const int32_t* m = (const int32_t*)meta;
  const PlaneArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                    (const int32_t*)deg, (const uint32_t*)plane,
                    (uint32_t*)plane_n, words, m, m + 16 * words, n_listed,
                    nullptr, {(const uint8_t*)vis_s, (const uint8_t*)vis_t},
                    {(uint8_t*)nf_s, (uint8_t*)nf_t},
                    {(int32_t*)pc_s, (int32_t*)pc_t}};
  return launch_plane(&pull_dual_batch_kernel, a, stream);
}
