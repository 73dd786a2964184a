// One lock-step level of the batch-minor search: B queries at once over
// planes laid out [n_rows, B] row-major, the queries on the minor axis.
//
// minor_level_kernel<T> replaces the XLA program of
// bibfs_tpu/solvers/batch_minor.py _level_scan (no Pallas kernel there):
// the reference scans the vertex axis in tc-row chunks, gathering a
// [Wp, tc, B] block of frontier rows per chunk. Here every vertex row is
// claimed once and nothing of that block is kept.
//
// Per row v and query q, for each side (bit 0 = source, bit 1 = target of
// the read-only `dual` plane): when q is active and dist[v, q] is unvisited
// (>= inf), the lowest live slot j of row v whose neighbour u has the side
// bit set in dual[u, q] claims v: dist[v, q] = lvl and par[v, q] = u
// (T = int32, mode "minor") or j (T = int8, mode "minor8", decoded by the
// host later). The next frontier dual_n[v, q] is written for every row.
// Per query the kernel adds up the new frontier of each side (cnt_s,
// cnt_t), the scanned edges (deg of this side's OLD frontier rows, times
// active) and takes the meet vote: a 64-bit atomicMin over
// (dist_s + dist_t) << 32 | v, in int32, on the updated planes where both
// sides are visited: the lowest v among the minimal sums.
//
// Bound on the H100: device-memory bytes. Every row reads its dual, dist_s
// and dist_t entries and writes its dual_n entry (4 B per (row, query) at
// int8, 16 B at int32), a claim writes its dist and parent entries, and a
// row with any wanting query reads its live table slots and, for each, one
// frontier row of B entries, which may come from L2 or from device memory.
//
// Design: a block is 8 warps over tiles of 8 consecutive rows (one row a
// warp) of one lane group of queries: 32 queries at int32 (one a thread),
// 128 at int8 (four a thread, one 32-bit load), so each gathered
// dual[u, group] is one coalesced 128-byte load. A warp first reads its
// row's own entries and decides whether any query wants a claim; only
// then does the block stage the tile's live slots in shared memory (one
// 32-byte sector per slot of the 8 rows), and a row with no wanting query
// reads no slot and gathers nothing. Slots are walked in chunks of 8
// independent frontier loads, until every wanting query of the warp has
// its hits. The per-query sums stay in registers across the tiles a
// block walks (a grid sized to the card, striding over the tiles), then
// are reduced across warps in shared memory, with one atomic per block,
// query and counter.
#include "level_common.cuh"

namespace {

constexpr int kWarps = 8;                // rows per tile, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 128;              // table slots staged per pass
constexpr int kLoads = 8;                // frontier loads in flight per warp

template <typename T> struct PlaneOf;
template <> struct PlaneOf<int32_t> {
  static constexpr int kPer = 1;          // queries per thread (per word)
  static constexpr int32_t kInf = 1 << 30;
  static constexpr bool kSlotPar = false;  // parent is the vertex id
};
template <> struct PlaneOf<int8_t> {
  static constexpr int kPer = 4;
  static constexpr int32_t kInf = 127;
  static constexpr bool kSlotPar = true;   // parent is the ELL slot
};

// What a launch reads and writes. Planes hold n_rows rows of b entries
// (b a multiple of 128); the table holds n_tab <= n_rows rows and rows
// past it have no slots and degree 0.
struct MinorArgs {
  const int32_t* nbr_t;
  int64_t stride;
  int width;
  int64_t n_tab;
  const int32_t* deg;
  int64_t n_rows;
  int64_t b;
  const void* dual;
  void* dual_n;
  void* ds;
  void* dt;
  void* ps;
  void* pt;
  int32_t lvl;
  const int32_t* active;
  int32_t* counts;              // [3, b]: cnt_s, cnt_t, scanned
  unsigned long long* key;      // [b]: the meet vote
  int64_t tiles;
};

// Entry i of a thread's word (its kPer consecutive queries).
template <typename T>
__device__ __forceinline__ int32_t entry(uint32_t w, int i) {
  if constexpr (PlaneOf<T>::kPer == 1) {
    return (int32_t)w;
  } else {
    return (int32_t)(int8_t)(w >> (8 * i));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t place(int32_t x, int i) {
  if constexpr (PlaneOf<T>::kPer == 1) {
    return (uint32_t)x;
  } else {
    return ((uint32_t)x & 0xffu) << (8 * i);
  }
}

template <typename T>
__device__ __forceinline__ const uint32_t* word_ptr(const void* plane, int64_t idx) {
  return reinterpret_cast<const uint32_t*>(static_cast<const T*>(plane) + idx);
}

template <typename T>
__device__ __forceinline__ uint32_t* word_ptr(void* plane, int64_t idx) {
  return reinterpret_cast<uint32_t*>(static_cast<T*>(plane) + idx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) minor_level_kernel(MinorArgs a) {
  constexpr int P = PlaneOf<T>::kPer;
  constexpr int kGroup = 32 * P;  // queries of a lane group
  constexpr int32_t kInf = PlaneOf<T>::kInf;
  __shared__ int32_t s_nbr[kStage][kWarps];
  __shared__ int32_t s_need[2][kWarps];  // by tile parity: no race on reuse
  __shared__ int32_t s_red[3][kWarps][kGroup];
  __shared__ unsigned long long s_key[kWarps][kGroup];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t q0 = (int64_t)blockIdx.y * kGroup + lane * P;
  bool act[P];
  int32_t c_s[P], c_t[P], scn[P];
  unsigned long long mk[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    act[i] = a.active[q0 + i] != 0;
    c_s[i] = c_t[i] = scn[i] = 0;
    mk[i] = bibfs::kNoMeet;
  }

  for (int64_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t v = tile * kWarps + warp;
    const bool row = v < a.n_rows;
    const int64_t at = v * a.b + q0;
    uint32_t w_old = 0, w_s = 0, w_t = 0;
    int dg = 0, live = 0;
    if (row) {
      w_old = __ldg(word_ptr<T>(a.dual, at));
      w_s = *word_ptr<T>(a.ds, at);
      w_t = *word_ptr<T>(a.dt, at);
      if (v < a.n_tab) {
        dg = __ldg(a.deg + v);
        live = min(dg, a.width);
      }
    }
    // the queries of this thread that want a claim, per side
    unsigned want = 0u;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (act[i] && entry<T>(w_s, i) >= kInf) want |= 1u << (2 * i);
      if (act[i] && entry<T>(w_t, i) >= kInf) want |= 2u << (2 * i);
    }
    const bool any = __any_sync(0xffffffffu, want != 0u) && live > 0;
    const int parity = (int)((tile / gridDim.x) & 1);
    if (lane == 0) s_need[parity][warp] = any ? live : 0;
    __syncthreads();
    int tile_live = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tile_live = max(tile_live, s_need[parity][k]);

    int32_t par_s[P], par_t[P];
#pragma unroll
    for (int i = 0; i < P; ++i) par_s[i] = par_t[i] = -1;
    unsigned got = 0u;
    bool done = !any;
    for (int p0 = 0; p0 < tile_live; p0 += kStage) {
      const int span = min(kStage, tile_live - p0);
      if (p0 > 0) __syncthreads();  // the previous pass's slots are read
      // slot j of the tile's 8 rows is one 32-byte sector of the table
      for (int idx = threadIdx.x; idx < span * kWarps; idx += kThreads) {
        const int j = idx / kWarps, r = idx % kWarps;
        const int64_t vr = tile * kWarps + r;
        s_nbr[j][r] = vr < a.n_tab ? __ldg(a.nbr_t + (int64_t)(p0 + j) * a.stride + vr) : -1;
      }
      __syncthreads();
      if (done) continue;
      const int end = min(live, p0 + span);
      for (int c = p0; c < end && !done; c += kLoads) {
        int32_t u[kLoads];
        uint32_t w[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          u[k] = c + k < end ? s_nbr[c + k - p0][warp] : -1;
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          w[k] = u[k] >= 0 ? __ldg(word_ptr<T>(a.dual, (int64_t)u[k] * a.b + q0)) : 0u;
        }
        // ascending: the first hit of a (query, side) keeps its slot
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int32_t pv = PlaneOf<T>::kSlotPar ? c + k : u[k];
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const uint32_t hv = (uint32_t)entry<T>(w[k], i);
            const unsigned h = ((hv & 1u) | (hv & 2u)) << (2 * i) & want & ~got;
            if (h & (1u << (2 * i))) par_s[i] = pv;
            if (h & (2u << (2 * i))) par_t[i] = pv;
            got |= h;
          }
        }
        done = __all_sync(0xffffffffu, got == want);
      }
    }
    if (!row) continue;

    uint32_t nd = 0u, ns = w_s, nt = w_t;
    bool claim_s = false, claim_t = false;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool nf_s = par_s[i] >= 0, nf_t = par_t[i] >= 0;
      int32_t d_s = entry<T>(w_s, i), d_t = entry<T>(w_t, i);
      if (nf_s) {
        d_s = a.lvl;
        ns = (ns & ~place<T>(-1, i)) | place<T>(a.lvl, i);
        claim_s = true;
      }
      if (nf_t) {
        d_t = a.lvl;
        nt = (nt & ~place<T>(-1, i)) | place<T>(a.lvl, i);
        claim_t = true;
      }
      nd |= place<T>((nf_s ? 1 : 0) | (nf_t ? 2 : 0), i);
      c_s[i] += nf_s;
      c_t[i] += nf_t;
      const int32_t o = entry<T>(w_old, i);
      if (act[i]) scn[i] += ((o & 1) + ((o >> 1) & 1)) * dg;
      if (d_s < kInf && d_t < kInf) {
        const unsigned long long k =
            ((unsigned long long)(uint32_t)(d_s + d_t) << 32) | (uint32_t)v;
        mk[i] = k < mk[i] ? k : mk[i];
      }
    }
    *word_ptr<T>(a.dual_n, at) = nd;
    if (claim_s) *word_ptr<T>(a.ds, at) = ns;
    if (claim_t) *word_ptr<T>(a.dt, at) = nt;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (par_s[i] >= 0) static_cast<T*>(a.ps)[at + i] = (T)par_s[i];
      if (par_t[i] >= 0) static_cast<T*>(a.pt)[at + i] = (T)par_t[i];
    }
  }

  // one sum per block, query and counter
#pragma unroll
  for (int i = 0; i < P; ++i) {
    s_red[0][warp][lane * P + i] = c_s[i];
    s_red[1][warp][lane * P + i] = c_t[i];
    s_red[2][warp][lane * P + i] = scn[i];
    s_key[warp][lane * P + i] = mk[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kGroup; t += kThreads) {
    const int64_t q = (int64_t)blockIdx.y * kGroup + t;
    int32_t sum[3] = {0, 0, 0};
    unsigned long long k = bibfs::kNoMeet;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c] += s_red[c][w][t];
      k = s_key[w][t] < k ? s_key[w][t] : k;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (sum[c]) atomicAdd(a.counts + c * a.b + q, sum[c]);
    }
    if (k != bibfs::kNoMeet) atomicMin(a.key + q, k);
  }
}

template <typename T>
int launch_minor(const MinorArgs& a, void* stream) {
  if (a.n_rows <= 0 || a.b <= 0) return (int)cudaGetLastError();
  static int grid_x = 0;  // blocks the card holds at once, per instantiation
  if (grid_x == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minor_level_kernel<T>,
                                                  kThreads, 0);
    grid_x = sms * (per_sm > 1 ? per_sm : 1);
    if (grid_x < 1) grid_x = 1;
  }
  const int64_t groups = a.b / (32 * PlaneOf<T>::kPer);
  int64_t per_group = (grid_x + groups - 1) / groups;
  if (per_group > a.tiles) per_group = a.tiles;
  const dim3 grid((unsigned)per_group, (unsigned)groups);
  minor_level_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One level over int32 (itemsize 4) or int8 (itemsize 1) planes. `counts`
// ([3, b] int32) and `key` ([b] uint64) are accumulated into: the caller
// zeroes the one and fills the other with the empty key.
extern "C" int bibfs_minor_level(int itemsize, const void* nbr_t, int64_t stride,
                                 int width, int64_t n_tab, const void* deg,
                                 int64_t n_rows, int64_t b, const void* dual,
                                 void* dual_n, void* ds, void* dt, void* ps,
                                 void* pt, int lvl, const void* active,
                                 void* counts, void* key, void* stream) {
  const MinorArgs a{(const int32_t*)nbr_t, stride, width, n_tab,
                    (const int32_t*)deg, n_rows, b, dual, dual_n, ds, dt, ps,
                    pt, (int32_t)lvl, (const int32_t*)active, (int32_t*)counts,
                    (unsigned long long*)key, (n_rows + kWarps - 1) / kWarps};
  if (itemsize == 4) return launch_minor<int32_t>(a, stream);
  if (itemsize == 1) return launch_minor<int8_t>(a, stream);
  return (int)cudaErrorInvalidValue;
}
