// One round of the blocked search: the frontier expansion of every query
// of a batch as int8 tensor-core products over the tiled adjacency, with
// the level body's masked stamp, the new frontier's counts and degree
// sums, and the meet vote in the epilogue; then a one-block fold of the
// batch's [B] vectors.
//
// blocked_level_kernel replaces the XLA program of
// bibfs_tpu/ops/blocked_expand.py expand_blocked_plane (a dot_general, no
// Pallas kernel there) together with the body around it,
// bibfs_tpu/solvers/dense.py _make_blocked_body (dense.py:191-237): for
// plane rows c < C = 2B (source sides 0..B-1, target sides B..2B-1) and
// q = c mod B,
//
//   acc[u, c] = sum_k sum_v tab[bi, k, u, v] * F[c, bcol[bi, k] * 128 + v]
//   new       = acc > 0 && dist[c, u] >= INF && live[q]
//   dist[c, u] = lvl where new; F'[c, u] = new
//   cnt[c]  += #new in column c;  scan[c] += sum of deg[u] over new u
//   key[q]   = min over u new on either side with both sides reached of
//              (d_s + d_t) << 32 | u
//
// blocked_fold_kernel folds key, cnt and scan into the [B] state (best,
// meet, levels, edges, the next round's live mask and one any-live word
// for the host) and resets them: the body's [B] updates.
//
// Layout (ops/blocked_expand.py): the table is int8 [nblocks, bwidth, 128,
// 128], row-major per tile (u, then v), with bcol int32 [nblocks, bwidth]
// (sentinel nblocks for dead slots). The planes are query-major: the
// frontier F and F' int8 [C, n_pad], dist int32 [C, n_pad]. The occupancy
// flags occ int32 [ceil(B / 32), nblocks] say which block columns of a
// query group's sub-plane hold an entry.
//
// Bound on the H100: device-memory bytes at the search's batch sizes. A
// round must read the tiles its frontier needs (16 KB each) and the
// occupied sub-planes, write the next plane, and read dist where a column
// reaches a vertex (4 B), write it where a vertex is new, and read the
// other side's dist and deg where a vertex is new. The int8 products take
// a small share of the tensor cores' rate unless the tiles are dense.
//
// Design (what held the first design back, and what this one does):
// 1. Both sides of a query in one item. An item is 32 queries q0 .. q0 + 31
//    (a group) and one block row; its 64 columns are plane rows q0..
//    (source) and B + q0.. (target), so it sees both sides of each query
//    and casts its meet vote with no race: no other item writes those
//    dist entries. A persistent grid (as many blocks as fit on the card)
//    walks the items group-fastest, so the blocks in flight share tiles
//    through L2.
// 2. Occupancy skipping. A slot whose block column holds no frontier entry
//    of the group (occ) is never loaded or multiplied, nor a sentinel
//    slot; an item with no such slot, or no live query, writes its zero
//    sub-plane and flag and reads no dist. Finished queries have all-zero
//    rows, so a batch's tail skips most of the table.
// 3. A TMA ring into wgmma. One producer warp issues the copies of each
//    occupied slot (cp.async.bulk.tensor: the 128x128 tile, and the
//    group's two 32x128 sub-plane boxes as one 3-D box, zero-filled past
//    row B) into a ring of kStages stages, each completed by an mbarrier,
//    running ahead across items; two consumer warpgroups of 64 tile rows
//    each run wgmma m64n64k32 .s32.s8.s8 with both operands in shared
//    memory. The 8-bit wgmma takes only K-major operands, which both are
//    as they stand: a tile row holds its 128 v-entries consecutively and
//    so does a query-major plane row. TMA writes them with the 128-byte
//    swizzle that the descriptors name. Products of 0/1 in int32 are
//    exact (a count is at most bwidth * 128).
// 4. A fused epilogue in registers. A consumer thread's accumulators hold
//    both sides of its (tile row, query) pairs, so it reads dist only
//    where a count is positive and the query live, all such loads of a
//    pass issued together, then the other side's old dist where one side
//    is new, stamps, and votes and sums per query itself; the sums go
//    through shuffles and shared-memory atomics to one global atomic per
//    item and column (count, degree sum) and per item and query (the
//    64-bit meet key). "Reached" on the other side means new in this
//    item (value lvl) or an old dist entry. The new flags go through
//    shared memory to the next plane as 16-byte segments. (The first form
//    read dist entry by entry and voted in a second pass over shared
//    memory: its dependent loads ran one after another, and the epilogue
//    took longer than the products.)
// 5. The fold, a second launch of one block, turns the carried vectors into
//    the next round's state, so the host reads one word a round.
#include <cuda.h>
#include <dlfcn.h>

#include "level_common.cuh"

namespace {

constexpr int kTile = 128;                 // tile edge: M and K of a block's product
constexpr int kGroup = 32;                 // queries per item
constexpr int kCols = 2 * kGroup;          // plane rows per item: N
constexpr int kStages = 2;                 // ring depth
constexpr int kConsumers = 256;            // two warpgroups, 64 tile rows each
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = kTile * kTile;
constexpr int kSubBytes = kCols * kTile;
constexpr int kStageBytes = kTileBytes + kSubBytes;  // a multiple of 1024
constexpr int kLd = kTile + 16;            // row stride of the new-flag stage
constexpr int kNewOff = kStages * kStageBytes;
constexpr int kSumOff = kNewOff + kCols * kLd;  // counts, degree sums, keys
constexpr int kBarOff = kSumOff + kCols * 8 + kGroup * 8;
// (tile row, query) pairs a consumer thread loads at once: 4 keeps the
// kernel at 72 registers, 3 blocks an SM; 8 or 16 take more registers, so
// fewer blocks fit, and ran slower
constexpr int kPairs = 4;
// + 1024: the ring's base is aligned up to the 128-byte swizzle's period
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
constexpr unsigned long long kKeyEmpty = 0x7fffffffffffffffull;
constexpr int kFoldThreads = 1024;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// A K-major operand of 8-row groups of 128-byte rows under the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused by this layout),
// stride 1024 bytes between 8-row groups, layout type 1 (SWIZZLE_128B).
// A k step of 32 bytes adds 2 to the start field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The occupied slots of block row bi for group g, 32 slots from k0 on, as
// a bit mask (bit i: slot k0 + i), the same in every warp that asks.
__device__ __forceinline__ uint32_t occupied_slots(
    const int32_t* __restrict__ brow, const int32_t* __restrict__ gocc,
    int64_t nblocks, int bwidth, int k0, int lane) {
  const int k = k0 + lane;
  bool occ = false;
  if (k < bwidth) {
    const int64_t bj = brow[k];
    occ = bj < nblocks && gocc[bj] != 0;
  }
  return __ballot_sync(0xffffffffu, occ);
}

// Whether item (g, bi) multiplies anything: a live query in the group and
// an occupied slot in the row; asked by a whole warp.
__device__ __forceinline__ bool item_runs(
    const int32_t* __restrict__ brow, const int32_t* __restrict__ gocc,
    const int32_t* __restrict__ live, int64_t nblocks, int bwidth, int q0,
    int b, int lane) {
  if (!__any_sync(0xffffffffu, q0 + lane < b && live[q0 + lane] != 0)) {
    return false;
  }
  for (int k0 = 0; k0 < bwidth; k0 += 32) {
    if (occupied_slots(brow, gocc, nblocks, bwidth, k0, lane)) return true;
  }
  return false;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// consumer_sync that also returns whether any consumer's `pred` was set
__device__ __forceinline__ int consumer_sync_or(int pred) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, %2, p;\nselp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(pred), "n"(kConsumers)
      : "memory");
  return r;
}

__global__ void __launch_bounds__(kThreads)
blocked_level_kernel(const __grid_constant__ CUtensorMap tab_map,
                     const __grid_constant__ CUtensorMap plane_map,
                     const int32_t* __restrict__ bcol, int64_t nblocks,
                     int bwidth, const int32_t* __restrict__ deg,
                     int8_t* __restrict__ plane_n, int32_t* __restrict__ dist,
                     const int32_t* __restrict__ occ,
                     int32_t* __restrict__ occ_n, int64_t n_pad, int b,
                     const int32_t* __restrict__ live, int32_t lvl,
                     int32_t* __restrict__ cnt, int32_t* __restrict__ scan,
                     unsigned long long* __restrict__ key) {
  const int ng = (b + kGroup - 1) / kGroup;
  const int64_t items = (int64_t)ng * nblocks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  uint8_t* raw = reinterpret_cast<uint8_t*>(stage_bits);
  uint8_t* smem = raw + ((1024 - (saddr(raw) & 1023)) & 1023);
  int8_t* s_new = reinterpret_cast<int8_t*>(smem + kNewOff);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem + kSumOff);
  int32_t* s_scan = s_cnt + kCols;
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + kSumOff + kCols * 8);
  if (tid < kCols) {
    s_cnt[tid] = 0;
    s_scan[tid] = 0;
    if (tid < kGroup) s_key[tid] = kKeyEmpty;
  }
  const uint32_t full0 = saddr(smem + kBarOff);
  const uint32_t empty0 = full0 + kStages * 8;
  const uint32_t ring = saddr(smem);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + s * 8, 1);
      mbar_init(empty0 + s * 8, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // items (g, bi) = (i % ng, i / ng) from blockIdx.x in steps of the grid:
  // the blocks in flight take neighbouring items, so the groups sharing a
  // tile read it from L2
  if (warp == kWarps - 1) {
    // the producer warp keeps the ring full, running ahead across items
    int n = 0;
    for (int64_t i = blockIdx.x; i < items; i += gridDim.x) {
      const int g = (int)(i % ng);
      const int64_t bi = i / ng;
      const int32_t* brow = bcol + bi * bwidth;
      const int32_t* gocc = occ + g * nblocks;
      if (!item_runs(brow, gocc, live, nblocks, bwidth, g * kGroup, b, lane)) {
        continue;
      }
      for (int k0 = 0; k0 < bwidth; k0 += 32) {
        uint32_t bits = occupied_slots(brow, gocc, nblocks, bwidth, k0, lane);
        while (bits) {
          const int k = k0 + __ffs(bits) - 1;
          bits &= bits - 1;
          if (lane == 0) {
            const int s = n % kStages;
            const uint32_t st = ring + s * kStageBytes;
            mbar_wait(empty0 + s * 8, ((n / kStages) & 1) ^ 1);
            mbar_expect_tx(full0 + s * 8, kStageBytes);
            tma_2d(st, &tab_map, 0, (int)((bi * bwidth + k) * kTile),
                   full0 + s * 8);
            tma_3d(st + kTileBytes, &plane_map, (int)(brow[k] * kTile),
                   g * kGroup, 0, full0 + s * 8);
          }
          ++n;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies tile rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  // accumulator 4 j + e holds tile row urow (+8 for e >= 2) and column
  // 8 j + 2 (lane % 4) (+1 for odd e)
  const int urow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  int n = 0;
  for (int64_t i = blockIdx.x; i < items; i += gridDim.x) {
    const int g = (int)(i % ng);
    const int q0 = g * kGroup;
    const int64_t bi = i / ng;
    const int32_t* brow = bcol + bi * bwidth;
    const int32_t* gocc = occ + g * nblocks;
    // column c of the item: plane row q (c < 32) or B + q of q = q0 + c % 32
    auto row_of = [&](int c) {
      const int64_t q = q0 + (c & (kGroup - 1));
      return c < kGroup ? q : b + q;
    };
    if (!item_runs(brow, gocc, live, nblocks, bwidth, q0, b, lane)) {
      // no product: the zero sub-plane and flag, no dist
      for (int t = tid; t < kCols * kTile / 16; t += kConsumers) {
        const int c = t >> 3;
        if (q0 + (c & (kGroup - 1)) < b) {
          *reinterpret_cast<int4*>(plane_n + row_of(c) * n_pad +
                                   bi * kTile + (t & 7) * 16) =
              make_int4(0, 0, 0, 0);
        }
      }
      if (tid == 0) occ_n[g * nblocks + bi] = 0;
      continue;
    }
    const int32_t dg0 = deg[bi * kTile + urow];
    const int32_t dg1 = deg[bi * kTile + urow + 8];
    int acc[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) acc[t] = 0;
    for (int k0 = 0; k0 < bwidth; k0 += 32) {
      uint32_t bits = occupied_slots(brow, gocc, nblocks, bwidth, k0, lane);
      while (bits) {
        bits &= bits - 1;
        const int s = n % kStages;
        const uint32_t st = ring + s * kStageBytes;
        mbar_wait(full0 + s * 8, (n / kStages) & 1);
        const uint64_t da = desc_sw128(st + wg * 64 * kTile);
        const uint64_t db = desc_sw128(st + kTileBytes);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kTile / 32; ++ks) {
          wgmma_s8(acc, da + 2 * ks, db + 2 * ks);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty0 + s * 8);
        ++n;
      }
    }

    // epilogue 1, in registers: a thread holds both sides of each of its
    // (tile row, query) pairs, source accumulator 4 j + e beside target
    // accumulator 4 (j + 4) + e, tile row urow + 8 (e / 2), query
    // 8 j + 2 (lane % 4) + e % 2 (j < 4). Per pass of kPairs pairs: the
    // dist loads first, all independent; then the other side's old dist
    // where one side is new and the other was not read; then the stamps,
    // the new-flag stage, and per query the counts, degree sums and vote,
    // reduced over the 8 lanes of a query and into shared memory.
#pragma unroll
    for (int h = 0; h < 16 / kPairs; ++h) {
      int32_t ds[kPairs], dt[kPairs];
      bool hs[kPairs], ht[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int j = (h * kPairs + p) >> 2, e = p & 3;
        const int64_t qg = q0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int64_t v = bi * kTile + urow + 8 * (e >> 1);
        const bool ok = qg < b && live[qg] != 0;
        hs[p] = ok && acc[4 * j + e] > 0;
        ht[p] = ok && acc[4 * (j + 4) + e] > 0;
        ds[p] = hs[p] ? dist[qg * n_pad + v] : bibfs::kInf;
        dt[p] = ht[p] ? dist[(b + qg) * n_pad + v] : bibfs::kInf;
      }
      bool ns[kPairs], nt[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int j = (h * kPairs + p) >> 2, e = p & 3;
        const int64_t qg = q0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int64_t v = bi * kTile + urow + 8 * (e >> 1);
        ns[p] = hs[p] && ds[p] >= bibfs::kInf;
        nt[p] = ht[p] && dt[p] >= bibfs::kInf;
        if (ns[p] && !ht[p]) dt[p] = dist[(b + qg) * n_pad + v];
        if (nt[p] && !hs[p]) ds[p] = dist[qg * n_pad + v];
      }
      constexpr int kQ = kPairs / 2;  // queries of a pass
      int cs[kQ], ct[kQ], ss[kQ], st[kQ];
      unsigned long long kk[kQ];
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
        cs[t] = ct[t] = ss[t] = st[t] = 0;
        kk[t] = kKeyEmpty;
      }
      bool any = false;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int j = (h * kPairs + p) >> 2, e = p & 3;
        const int ql = 8 * j + 2 * (lane & 3) + (e & 1);
        const int64_t qg = q0 + ql;
        const int u = urow + 8 * (e >> 1);
        const int64_t v = bi * kTile + u;
        const int t = ((p >> 2) << 1) | (e & 1);
        if (ns[p]) dist[qg * n_pad + v] = lvl;
        if (nt[p]) dist[(b + qg) * n_pad + v] = lvl;
        s_new[ql * kLd + u] = ns[p];
        s_new[(kGroup + ql) * kLd + u] = nt[p];
        const int32_t dg = (e >> 1) ? dg1 : dg0;
        cs[t] += ns[p];
        ct[t] += nt[p];
        ss[t] += ns[p] ? dg : 0;
        st[t] += nt[p] ? dg : 0;
        any |= ns[p] | nt[p];
        const int32_t a = ns[p] ? lvl : ds[p];
        const int32_t c = nt[p] ? lvl : dt[p];
        if ((ns[p] | nt[p]) && a < bibfs::kInf && c < bibfs::kInf) {
          const unsigned long long k =
              ((unsigned long long)(a + c) << 32) | (unsigned long long)v;
          kk[t] = k < kk[t] ? k : kk[t];
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs[t] += __shfl_xor_sync(0xffffffffu, cs[t], o);
          ct[t] += __shfl_xor_sync(0xffffffffu, ct[t], o);
          ss[t] += __shfl_xor_sync(0xffffffffu, ss[t], o);
          st[t] += __shfl_xor_sync(0xffffffffu, st[t], o);
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, kk[t], o);
          kk[t] = y < kk[t] ? y : kk[t];
        }
        if (lane < 4) {  // the warp's sums of query ql, lanes 0-3
          const int ql = 8 * (h * kPairs / 4 + (t >> 1)) + 2 * lane + (t & 1);
          if (cs[t]) {
            atomicAdd(s_cnt + ql, cs[t]);
            atomicAdd(s_scan + ql, ss[t]);
          }
          if (ct[t]) {
            atomicAdd(s_cnt + kGroup + ql, ct[t]);
            atomicAdd(s_scan + kGroup + ql, st[t]);
          }
          if (kk[t] != kKeyEmpty) atomicMin(s_key + ql, kk[t]);
        }
      }
    }
    consumer_sync();

    // epilogue 2: the next plane, 16-byte segments of whole columns; one
    // atomic per column and query with anything new; the flag
    for (int t = tid; t < kCols * kTile / 16; t += kConsumers) {
      const int c = t >> 3;
      if (q0 + (c & (kGroup - 1)) < b) {
        *reinterpret_cast<int4*>(plane_n + row_of(c) * n_pad + bi * kTile +
                                 (t & 7) * 16) =
            *reinterpret_cast<const int4*>(s_new + c * kLd + (t & 7) * 16);
      }
    }
    int mine = 0;
    if (tid < kCols) {
      const int cn = s_cnt[tid];
      if (cn) {  // only real columns count: a ragged group's rest stays 0
        atomicAdd(cnt + row_of(tid), cn);
        atomicAdd(scan + row_of(tid), s_scan[tid]);
        s_cnt[tid] = 0;
        s_scan[tid] = 0;
        mine = 1;
      }
      if (tid < kGroup && s_key[tid] != kKeyEmpty) {
        atomicMin(key + q0 + tid, s_key[tid]);
        s_key[tid] = kKeyEmpty;
      }
    }
    // the stage is read and the sums reset; any column new sets the flag
    const int flag = consumer_sync_or(mine);
    if (tid == 0) occ_n[g * nblocks + bi] = flag;
  }
}

// The body's [B] updates after a round (dense.py:225-237), on one block:
// the carried vote lowers best (and moves meet) only when strictly lower,
// this round's live queries add their CURRENT frontiers' degree sums and 2
// levels, the new frontiers' sums become the current ones, the next live
// mask is the minor kernel's rule at level lvl, and the accumulators are
// reset for the next round.
__global__ void __launch_bounds__(kFoldThreads)
blocked_fold_kernel(int64_t b, int32_t lvl, int32_t* __restrict__ best,
                    int32_t* __restrict__ meet, int32_t* __restrict__ levels,
                    int32_t* __restrict__ edges,
                    int32_t* __restrict__ scan_cur,
                    int32_t* __restrict__ live, int32_t* __restrict__ any,
                    int32_t* __restrict__ cnt, int32_t* __restrict__ scan,
                    unsigned long long* __restrict__ key) {
  int mine = 0;
  for (int64_t q = threadIdx.x; q < b; q += blockDim.x) {
    const unsigned long long k = key[q];
    int32_t bq = best[q];
    if ((long long)(k >> 32) < (long long)bq) {
      bq = (int32_t)(k >> 32);
      best[q] = bq;
      meet[q] = (int32_t)(k & 0xffffffffull);
    }
    const int32_t lq = live[q];
    edges[q] += (scan_cur[q] + scan_cur[b + q]) * lq;
    levels[q] += 2 * lq;
    scan_cur[q] = scan[q];
    scan_cur[b + q] = scan[b + q];
    const int32_t nl = 2 * lvl < bq && cnt[q] > 0 && cnt[b + q] > 0;
    live[q] = nl;
    mine |= nl;
    cnt[q] = 0;
    cnt[b + q] = 0;
    scan[q] = 0;
    scan[b + q] = 0;
    key[q] = kKeyEmpty;
  }
  const int r = __syncthreads_or(mine);
  if (threadIdx.x == 0) *any = r;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's encoder, from the libcuda the CUDA runtime has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A uint8 tensor map of `rank` dims (innermost first) with a box whose
// rows are 128 bytes, under the 128-byte swizzle; out-of-bounds rows read
// as zeros.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One blocked round: `plane` and `plane_n` int8 [c, n_pad], `dist` int32
// [c, n_pad] (stamped in place), `occ` and `occ_n` int32 [ceil(c / 64),
// nblocks], `live` int32 [c / 2]; `cnt` and `scan` int32 [c] and `key`
// uint64 [c / 2] accumulate (atomics: zeros and the empty key on entry,
// as the fold leaves them); n_pad = nblocks * 128, and every pointer is
// 16-byte aligned (torch allocations are).
extern "C" int bibfs_blocked_level(const void* tab, const void* bcol,
                                   int64_t nblocks, int bwidth,
                                   const void* deg, const void* plane,
                                   void* plane_n, void* dist, const void* occ,
                                   void* occ_n, int64_t n_pad, int64_t c,
                                   const void* live, int lvl, void* cnt,
                                   void* scan, void* key, void* stream) {
  if (nblocks < 1 || nblocks > 65535 || bwidth < 1 || c < 2 || c % 2 ||
      c / 2 > (1 << 30) || n_pad != nblocks * kTile || !aligned16(tab) ||
      !aligned16(plane) || !aligned16(plane_n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t b = c / 2;
  CUtensorMap tab_map, plane_map;
  const cuuint64_t tdims[2] = {(cuuint64_t)kTile,
                               (cuuint64_t)(nblocks * bwidth * kTile)};
  const cuuint64_t tstrides[1] = {(cuuint64_t)kTile};
  const cuuint32_t tbox[2] = {kTile, kTile};
  // the plane as [2, B, n_pad]: one box is a group's rows of both sides
  const cuuint64_t pdims[3] = {(cuuint64_t)n_pad, (cuuint64_t)b, 2};
  const cuuint64_t pstrides[2] = {(cuuint64_t)n_pad, (cuuint64_t)(b * n_pad)};
  const cuuint32_t pbox[3] = {kTile, kGroup, 2};
  if (!encode(&tab_map, tab, 2, tdims, tstrides, tbox) ||
      !encode(&plane_map, plane, 3, pdims, pstrides, pbox)) {
    return (int)cudaErrorInvalidValue;
  }
  // a persistent grid: as many blocks as fit on the card at once
  static int fit = 0;
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(  // the ring needs more than 48 KB
        blocked_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blocked_level_kernel, kThreads, kSmemBytes);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fit = sms * per_sm;
  }
  const int64_t items = (b + kGroup - 1) / kGroup * nblocks;
  const dim3 grid((unsigned)(items < fit ? items : fit));
  blocked_level_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tab_map, plane_map, (const int32_t*)bcol, nblocks, bwidth,
      (const int32_t*)deg, (int8_t*)plane_n, (int32_t*)dist,
      (const int32_t*)occ, (int32_t*)occ_n, n_pad, (int)b,
      (const int32_t*)live, (int32_t)lvl, (int32_t*)cnt, (int32_t*)scan,
      (unsigned long long*)key);
  return (int)cudaGetLastError();
}

// The fold after a round: the [b] vectors best, meet, levels, edges, live
// (int32), key (uint64), the [2b] vectors scan_cur, cnt, scan (int32) and
// the one-word any, on one block.
extern "C" int bibfs_blocked_fold(int64_t b, int lvl, void* best, void* meet,
                                  void* levels, void* edges, void* scan_cur,
                                  void* live, void* any, void* cnt, void* scan,
                                  void* key, void* stream) {
  if (b < 1) return (int)cudaErrorInvalidValue;
  const int threads = b < kFoldThreads ? (int)((b + 31) / 32 * 32) : kFoldThreads;
  blocked_fold_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      b, (int32_t)lvl, (int32_t*)best, (int32_t*)meet, (int32_t*)levels,
      (int32_t*)edges, (int32_t*)scan_cur, (int32_t*)live, (int32_t*)any,
      (int32_t*)cnt, (int32_t*)scan, (unsigned long long*)key);
  return (int)cudaGetLastError();
}
