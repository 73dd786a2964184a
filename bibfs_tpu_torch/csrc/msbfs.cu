// One level of the bitmask-packed multi-source BFS: K searches advance
// together, each vertex carrying W = ceil(K / 32) uint32 reach words (bit
// k & 31 of word k >> 5 says "search k has reached this vertex").
//
// msbfs_level_kernel replaces the XLA while_loop body of
// bibfs_tpu/ops/msbfs_device.py _build_msbfs_kernel (msbfs_device.py:89-232;
// not a Pallas kernel). For every vertex v and word w:
//
//   acc              = OR over neighbours u of v of pending[u, w]
//   new              = acc & ~reach[v, w]
//   reach[v, w]     |= new;  pending_next[v, w] = new
//   dist[v, 32 w + b] = level for each set bit b of new
//   *flag            = 1 when any new bit exists
//
// and the host loop (ops/msbfs_device.py msbfs_plane_csr) runs it level
// after level, reading one flag word every few levels. The output is the
// reference's int16 [n, K] plane (-1 unreachable) bit for bit: a search
// reaches a vertex at its BFS level whatever order the ORs take.
//
// Bound on the H100: device-memory bytes. A level reads the CSR (row_ptr
// int64, col_ind int32), the pending words, and the reach words, writes the
// reach words it changes, the next pending words, and one int16 stamp per
// new (vertex, search) bit. It does a few integer operations per gathered
// word, far below the card's rate.
//
// Design. The reference pads every row to the graph's maximum degree
// (_ell_from_csr) and gathers over every slot; on a hub graph that table
// does not fit on the card. This kernel pulls over the CSR, one thread per
// (vertex, word), words of one vertex on neighbouring threads, so a row's
// neighbours are read once per word and consecutive threads read
// consecutive rows. The reference's SWAR counters (five carry-save bit
// planes decoded every 30 levels) exist to avoid K-wide work per level on
// the TPU; here a level stamps only the bits that are new, so the counters
// are not needed. A vertex whose word already holds every search skips its
// neighbours. A level whose predecessor found nothing (the host reads the
// flags only every few levels) reads its predecessor's flag, writes an
// empty next frontier and returns: overshoot levels cost a launch. Levels
// above the int16 range stamp nothing and only raise the flag, which the
// host turns into the reference's ValueError.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
msbfs_level_kernel(const int64_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ col_ind, int64_t n, int words,
                   int k, const uint32_t* __restrict__ pending,
                   uint32_t* __restrict__ reach,
                   uint32_t* __restrict__ pending_next,
                   int16_t* __restrict__ dist, int level,
                   int32_t* __restrict__ flag,
                   const int32_t* __restrict__ live) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * words) return;
  if (live != nullptr && *live == 0) {  // the previous level found nothing
    pending_next[idx] = 0u;
    return;
  }
  const int64_t v = idx / words;
  const int w = (int)(idx - v * words);
  const int tail = k & 31;
  const uint32_t full =
      (w == words - 1 && tail) ? ((1u << tail) - 1u) : 0xffffffffu;
  const uint32_t r = reach[idx];
  uint32_t fresh = 0u;
  if (r != full) {
    uint32_t acc = 0u;
    const int64_t end = row_ptr[v + 1];
    for (int64_t j = row_ptr[v]; j < end; ++j) {
      acc |= __ldg(pending + (int64_t)__ldg(col_ind + j) * words + w);
    }
    fresh = acc & ~r;
  }
  pending_next[idx] = fresh;
  if (fresh == 0u) return;
  reach[idx] = r | fresh;
  if (level <= 32767) {
    int16_t* row = dist + v * k + 32 * w;
    const int16_t lv = (int16_t)level;
    for (uint32_t bits = fresh; bits; bits &= bits - 1u) {
      row[__ffs(bits) - 1] = lv;
    }
  }
  *flag = 1;  // every writer stores the same value
}

}  // namespace

extern "C" int bibfs_msbfs_level(const void* row_ptr, const void* col_ind,
                                 int64_t n, int words, int k,
                                 const void* pending, void* reach,
                                 void* pending_next, void* dist, int level,
                                 void* flag, const void* live, void* stream) {
  const int64_t total = n * (int64_t)words;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  msbfs_level_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)row_ptr, (const int32_t*)col_ind, n, words, k,
      (const uint32_t*)pending, (uint32_t*)reach, (uint32_t*)pending_next,
      (int16_t*)dist, level, (int32_t*)flag, (const int32_t*)live);
  return (int)cudaGetLastError();
}
