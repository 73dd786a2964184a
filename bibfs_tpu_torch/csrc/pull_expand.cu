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
// degree row; each has its own frontier row, visited rows and outputs, at
// a fixed stride per query. A per-query byte `want` says what a query
// does this round: 0 nothing (its rows are not written: a finished
// search stays frozen), else the sides it expands (kernel 3: both;
// kernel 4: 1 for the source side, 2 for the target side, read from that
// side's frontier and visited rows and written to the query's one output
// row). Each query's rows get exactly the single-query kernel's values.
// Bound: per active query the single kernel's bytes, less the table,
// which the queries could share. The grid is one dimension over (query,
// tile block), query-outer, with a loop past its size: each query walks
// the whole table as the single kernel does, and its random frontier
// lookups find its frontier row in L2. Queries-inner order (the blocks of
// one table tile issued for all queries together, the tile read once)
// measured 1.3-2.4x slower on the H100: 256 frontier rows (a pair row is
// 256 KB at 2^20 rows) overflow the 50 MB L2, and the frontier's L2 hits
// are worth more than the table's.
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

// The warp's tile in block `block` of the tiles: claim its rows, write nf
// and the parent, then the next frontier's word(s) of the tile.
template <bool kDual, class Front>
__device__ __forceinline__ void pull_tile(const PullArgs& a, const Front& front,
                                          int64_t block) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = block * (kBlock / 32) + (threadIdx.x >> 5);
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
  pull_tile<false>(a, BitsFront{a.front, nullptr, a.n_ids}, blockIdx.x);
}

// Kernel 3: both sides, from the pair row.
__global__ void __launch_bounds__(kBlock) pull_dual_kernel(PullArgs a) {
  pull_tile<true>(a, PairFront{a.front, a.n_ids}, blockIdx.x);
}

// A batched launch: B queries over one table. Query q's frontier row
// starts at word q * front_stride of front0 (and front1: kernel 4's target
// side), its visited and output rows at q * n_rows, its next frontier at
// q * out_stride.
struct PullBatchArgs {
  PullArgs a;  // the table, the geometry, and query 0's rows
  const uint32_t* front1;
  const uint8_t* want;
  int64_t front_stride;
  int64_t out_stride;
  int64_t tile_blocks;
  int64_t queries;
};

// Query q's rows as a single-query launch's arguments; `side` 1 reads
// the target side's frontier and visited rows (kernel 4).
__device__ __forceinline__ PullArgs query_args(const PullBatchArgs& b,
                                               int64_t q, bool side) {
  PullArgs a = b.a;
  const int64_t r = q * a.n_rows;
  a.front = (side ? b.front1 : a.front) + q * b.front_stride;
  a.vis_s = (side ? a.vis_t : a.vis_s) + r;
  a.vis_t += r;
  a.nf_s += r;
  a.pc_s += r;
  if (a.nf_t) {  // kernel 3's target-side outputs (kernel 4 has none)
    a.nf_t += r;
    a.pc_t += r;
  }
  a.out += q * b.out_stride;
  return a;
}

// Kernel 4 with a query axis: each active query's chosen side.
__global__ void __launch_bounds__(kBlock) pull_batch_kernel(PullBatchArgs b) {
  const int64_t total = b.queries * b.tile_blocks;
  for (int64_t lin = blockIdx.x; lin < total; lin += gridDim.x) {
    const int64_t q = lin / b.tile_blocks;
    const int64_t blk = lin - q * b.tile_blocks;
    const uint8_t w = __ldg(b.want + q);  // the same for the whole block
    if (!w) continue;
    const PullArgs a = query_args(b, q, w == 2);
    pull_tile<false>(a, BitsFront{a.front, nullptr, a.n_ids}, blk);
  }
}

// Kernel 3 with a query axis: both sides of each active query.
__global__ void __launch_bounds__(kBlock) pull_dual_batch_kernel(PullBatchArgs b) {
  const int64_t total = b.queries * b.tile_blocks;
  for (int64_t lin = blockIdx.x; lin < total; lin += gridDim.x) {
    const int64_t q = lin / b.tile_blocks;
    const int64_t blk = lin - q * b.tile_blocks;
    if (!__ldg(b.want + q)) continue;
    const PullArgs a = query_args(b, q, false);
    pull_tile<true>(a, PairFront{a.front, a.n_ids}, blk);
  }
}

int launch_pull_batch(void (*kernel)(PullBatchArgs), PullBatchArgs b,
                      void* stream) {
  if (b.a.n_rows > 0 && b.queries > 0) {
    b.tile_blocks = (b.a.tiles + kBlock / 32 - 1) / (kBlock / 32);
    const int64_t total = b.queries * b.tile_blocks;
    const unsigned grid = (unsigned)(total < 0x7fffffff ? total : 0x7fffffff);
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(b);
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

// Kernel 4 with a query axis. `bits_s` / `bits_t` hold `queries` rows of
// words_in words (32 vertices each), `vis_s` / `vis_t`, `nf` and `pc`
// `queries` rows of n_rows, `out` `queries` rows of `tiles` words; `want`
// one byte per query (0 inactive, 1 source side, 2 target side).
extern "C" int bibfs_pull_batch(const void* nbr_t, int64_t stride, int wp,
                                int64_t n_rows, const void* deg,
                                const void* bits_s, const void* bits_t,
                                int64_t words_in, const void* vis_s,
                                const void* vis_t, const void* want,
                                int64_t queries, void* nf,
                                void* pc, void* out, int64_t tiles,
                                void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)bits_s,
                   (uint32_t)(words_in * 32), (const uint8_t*)vis_s,
                   (const uint8_t*)vis_t, (uint8_t*)nf, (int32_t*)pc,
                   nullptr, nullptr, (uint32_t*)out, tiles};
  const PullBatchArgs b{a, (const uint32_t*)bits_t, (const uint8_t*)want,
                        words_in, tiles, 0, queries};
  return launch_pull_batch(&pull_batch_kernel, b, stream);
}

// Kernel 3 with a query axis. `pair` holds `queries` rows of words_in
// words (16 vertices each), `out` `queries` rows of 2 * tiles words;
// `want` one byte per query (0 inactive, else both sides).
extern "C" int bibfs_pull_dual_batch(const void* nbr_t, int64_t stride, int wp,
                                     int64_t n_rows, const void* deg,
                                     const void* pair, int64_t words_in,
                                     const void* vis_s, const void* vis_t,
                                     const void* want, int64_t queries,
                                     void* nf_s, void* pc_s, void* nf_t,
                                     void* pc_t, void* out, int64_t tiles,
                                     void* stream) {
  const PullArgs a{(const int32_t*)nbr_t, stride, wp, n_rows,
                   (const int32_t*)deg, (const uint32_t*)pair,
                   (uint32_t)(words_in * 16), (const uint8_t*)vis_s,
                   (const uint8_t*)vis_t, (uint8_t*)nf_s, (int32_t*)pc_s,
                   (uint8_t*)nf_t, (int32_t*)pc_t, (uint32_t*)out, tiles};
  const PullBatchArgs b{a, nullptr, (const uint8_t*)want, words_in,
                        2 * tiles, 0, queries};
  return launch_pull_batch(&pull_dual_batch_kernel, b, stream);
}
