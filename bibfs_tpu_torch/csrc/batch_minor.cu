// One lock-step level of the batch-minor search: B queries at once, the
// queries on the minor axis, over a packed state.
//
// minor_level_kernel<T> replaces the XLA program of
// bibfs_tpu/solvers/batch_minor.py _level_scan (no Pallas kernel there):
// the reference scans the vertex axis in tc-row chunks, gathering a
// [Wp, tc, B] block of whole frontier rows per chunk and rereading the
// dist planes for the meet vote. Here every vertex row is claimed once
// and the frontier and visited sets are bits.
//
// State (ops/minor_level.py): front and vis are [n_rows, B / 16] pair
// rows of uint32 words (the pair-row order of ops/bitmap.py): bits
// 2 (q & 15) (source side) and 2 (q & 15) + 1 (target side) of word
// q >> 4 hold query q, so the 4 consecutive queries of a lane are one
// byte. The dist and parent planes are [n_rows, B] of T.
// Per row v and query q, for each side: when q is active and the side's
// vis bit is clear, the lowest live slot j of row v whose neighbour u has
// the side's front bit claims v: dist[v, q] = lvl, par[v, q] = u (T =
// int32, mode "minor") or j (T = int8, mode "minor8", decoded by the host
// later), and the side's front_n and vis bits are set. Per query the
// kernel adds up each side's new frontier (cnt_s, cnt_t) and the scanned
// edges (the row's degree times its OLD front bits, times active). The
// meet vote is min-folded into the caller's key, which holds the previous
// level's vote: a dist entry never changes once set, so only a claim can
// add a row that both sides have visited. At each claim the kernel votes
// (dist_s + dist_t) << 32 | v with a 64-bit atomicMin, reading the other
// side's dist entry only where that side's vis bit is set.
//
// Bound on the H100: device-memory bytes. Every row reads its front and
// vis pair rows (B / 4 bytes each: two bits per query) and writes front_n
// and the vis bytes that changed; a claim writes its dist and parent
// entries and may read one dist entry; a row with a wanting query reads
// its live table slots and, per slot, the neighbour's front bits of the
// query group (32 bytes per 128 queries: 64 B a slot at B = 256, where a
// whole plane row of T is B or 4 B bytes). The front plane (67 MB at 2^20
// rows and B = 256) stays largely in the 50 MB L2.
//
// Design: a warp owns one group of 128 queries (4 a lane; blockIdx.y is
// the group) and walks tiles of kRows consecutive rows, striding over a
// grid sized to the card. Lane l's 8 bits of a row (its 4 queries, both
// sides) are byte l of the group's 32-byte sector, so every front or vis
// access of a warp is one sector per row and every gather one byte a
// lane. No block-wide barrier runs in the walk (__syncwarp only):
// - a lane loads its byte of each of the tile's front and vis rows, all
//   the rows' loads in flight together (a cp.async copy of the next
//   tile's rows, asked for before this tile's claims, measured no
//   faster);
// - per row the warp decides whether any query wants a claim, and stages
//   the first kStage table slots of the tile (one 32-byte sector per slot
//   of 8 rows, all loads in flight together), -1 past a row's live slots;
// - the walk goes slot by slot over the tile's rows, kLoads independent
//   front gathers at a time; a row's slots come in ascending order, so
//   its first hit of a (query, side) is its lowest slot. The parent of a
//   hit goes to the warp's parent rows in shared memory, and a row whose
//   wanted bits are all hit in every lane gathers no more. Per lane a
//   row's state is one byte of wanted and one of claimed bits;
// - front_n and vis are written a byte a lane; then the claims are
//   flushed with lane l taking queries 32 k + l (k = 0..3), so every
//   dist or parent store and every vote's dist load of the warp covers 32
//   consecutive entries; the tile's vote loads all start before any is
//   used.
// Per-query sums leave through shared memory and one global atomic per
// block, query and counter.
//
// Knobs (compile-time, for cli/minor_probe.py): MINOR_ROWS (rows of a
// tile), MINOR_LOADS (gathers in flight per warp), and per instantiation
// MINOR_BLOCKS_INT8 / _INT32 (the register budget as resident blocks per
// SM asked of the compiler). The defaults are the fastest measured on the
// smoke's states (PERF.md).
#include <type_traits>

#include "level_common.cuh"

#ifndef MINOR_ROWS
#define MINOR_ROWS 4
#endif
#ifndef MINOR_LOADS
#define MINOR_LOADS 16
#endif
#ifndef MINOR_BLOCKS_INT8
#define MINOR_BLOCKS_INT8 4
#endif
#ifndef MINOR_BLOCKS_INT32
#define MINOR_BLOCKS_INT32 3
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = MINOR_ROWS;         // rows of a warp tile
constexpr int kLoads = MINOR_LOADS;       // front gathers in flight per warp
constexpr int kSlots = kLoads > kRows ? kLoads / kRows : 1;  // per chunk
constexpr int kStage = 32;                // table slots staged per tile
constexpr int kPer = 4;                   // queries per lane
constexpr int kGroup = 32 * kPer;         // queries per warp
constexpr int kSector = 32;               // bytes of a group's pair row
static_assert(kRows == 4 || kRows == 8, "a tile holds 4 or 8 rows");
// A tile's row bytes, a lane's bits of each row: one 32-bit word at 4
// rows, a 64-bit one at 8.
typedef std::conditional<kRows == 4, uint32_t, unsigned long long>::type TileBits;
// bit 0 of every row byte
constexpr TileBits kRowLsb = (TileBits)0x0101010101010101ull;

// Per instantiation: what a parent is, and the resident blocks per SM
// asked of the compiler (the register budget: 80 registers at 3 blocks,
// 64 at 4).
template <typename T> struct PlaneOf;
template <> struct PlaneOf<int32_t> {
  static constexpr bool kSlotPar = false;  // parent is the vertex id
  static constexpr int kMinBlocks = MINOR_BLOCKS_INT32;
};
template <> struct PlaneOf<int8_t> {
  static constexpr bool kSlotPar = true;   // parent is the ELL slot
  static constexpr int kMinBlocks = MINOR_BLOCKS_INT8;
};

// What a launch reads and writes. Planes hold n_rows rows of b entries
// (b a multiple of 128), front and vis n_rows pair rows of b / 4 bytes;
// the table holds n_tab <= n_rows rows and rows past it have no slots and
// degree 0.
struct MinorArgs {
  const int32_t* nbr_t;
  int64_t stride;
  int width;
  int64_t n_tab;
  const int32_t* deg;
  int64_t n_rows;
  int64_t b;
  int64_t row_bytes;            // b / 4
  const uint8_t* front;
  uint8_t* front_n;
  uint8_t* vis;                 // updated in place
  void* ds;
  void* dt;
  void* ps;
  void* pt;
  int32_t lvl;
  const int32_t* active;
  int32_t* counts;              // [3, b]: cnt_s, cnt_t, scanned
  unsigned long long* key;      // [b]: the meet vote, min-folded into
  int64_t tiles;
};

// Note the parents of the claims `h` (a lane's byte: bit 2 i side 0, bit
// 2 i + 1 side 1 of its query i) of one row in the warp's parent rows.
template <typename T>
__device__ __forceinline__ void note_claims(T (&par)[2][kGroup], int lane,
                                            unsigned h, int32_t pv) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((h >> (2 * i)) & 1u) par[0][lane * kPer + i] = (T)pv;
    if ((h >> (2 * i + 1)) & 1u) par[1][lane * kPer + i] = (T)pv;
  }
}

// Dynamic shared memory of an instantiation: its warps' parent rows.
template <typename T>
constexpr size_t kParBytes = sizeof(T) * kWarps * kRows * 2 * kGroup;

// Row r's byte of a tile word.
__device__ __forceinline__ unsigned row_byte(TileBits x, int r) {
  return (unsigned)(x >> (8 * r)) & 0xffu;
}

__device__ __forceinline__ int popc(TileBits x) {
  if constexpr (sizeof(TileBits) == 4) {
    return __popc(x);
  } else {
    return __popcll(x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, PlaneOf<T>::kMinBlocks)
minor_level_kernel(MinorArgs a) {
  __shared__ int32_t s_nbr[kWarps][kStage][kRows];
  // a warp's per-query sums (cnt_s, cnt_t, scanned) and meet key: lane l
  // owns the sums of queries 4 l .. 4 l + 3 and the keys of 32 k + l
  __shared__ __align__(16) int32_t s_acc[kWarps][3][kGroup];
  __shared__ unsigned long long s_key[kWarps][kGroup];
  // the parents of a tile's claims, per row and side, until the flush
  T(*s_par)[kRows][2][kGroup] = reinterpret_cast<T(*)[kRows][2][kGroup]>(stage_bits);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t gb = (int64_t)blockIdx.y * kSector + lane;  // lane's byte of a pair row
  const uint8_t* front_gb = a.front + gb;
  const uint32_t rb = (uint32_t)a.row_bytes;  // b / 4 bytes: fits 32 bits
  const int64_t q0 = (int64_t)blockIdx.y * kGroup + lane * kPer;
  unsigned act = 0u;  // both sides' bits of the active queries
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    act |= (a.active[q0 + i] != 0 ? 3u : 0u) << (2 * i);
    s_key[warp][32 * i + lane] = bibfs::kNoMeet;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    *reinterpret_cast<int4*>(&s_acc[warp][c][lane * kPer]) = make_int4(0, 0, 0, 0);
  }

  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int64_t tile = (int64_t)blockIdx.x * kWarps + warp; tile < a.tiles;
       tile += step) {
    const int64_t v0 = tile * kRows;
    // the tile's row bytes and (lanes below kRows) degrees, all loads in
    // flight together; rows past the planes read as all visited
    unsigned f_in[kRows], v_in[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool in = v0 + r < a.n_rows;
      f_in[r] = in ? __ldg(front_gb + (size_t)(v0 + r) * rb) : 0u;
      v_in[r] = in ? a.vis[(v0 + r) * a.row_bytes + gb] : 0xffu;
    }
    const int32_t dg = lane < kRows && v0 + lane < a.n_tab ? __ldg(a.deg + v0 + lane) : 0;
    // per row: the lane's vis and wanted bits (a byte a row), the scanned
    // edges, and (lane r) row r's live slots if any query wants a claim
    TileBits wants = 0, vos = 0;
    int scn[kPer] = {0, 0, 0, 0};
    int my_live = 0, most = 0;
    unsigned slotted = 0u;  // rows with slots to walk
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int32_t dr = __shfl_sync(kFull, dg, r);
      const unsigned fo = f_in[r] & act;
      const unsigned vo = v_in[r];
      const unsigned want = act & ~vo & 0xffu;
      wants |= (TileBits)want << (8 * r);
      vos |= (TileBits)vo << (8 * r);
#pragma unroll
      for (int i = 0; i < kPer; ++i) scn[i] += __popc((fo >> (2 * i)) & 3u) * dr;
      const int live = __any_sync(kFull, want != 0u) ? min(dr, a.width) : 0;
      if (live) slotted |= 1u << r;
      if (lane == r) my_live = live;
      most = max(most, live);
    }
    {
      int4* acc = reinterpret_cast<int4*>(&s_acc[warp][2][lane * kPer]);
      const int4 x = *acc;
      *acc = make_int4(x.x + scn[0], x.y + scn[1], x.z + scn[2], x.w + scn[3]);
    }
    // slot j of the tile's rows, -1 past a row's live slots
    const int staged = min(most, kStage);
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kStage * kRows / 32; ++p) {
      const int idx = lane + 32 * p;
      const int j = idx / kRows, r = idx % kRows;
      const int live = __shfl_sync(kFull, my_live, r);
      if (j < staged) {
        s_nbr[warp][j][r] = j < live ? __ldg(a.nbr_t + (int64_t)j * a.stride + v0 + r) : -1;
      }
    }
    __syncwarp();

    // the walk, kSlots slots of every row a chunk
    TileBits gots = 0;
    unsigned done = 0u;
    for (int j0 = 0; j0 < most && (done & slotted) != slotted; j0 += kSlots) {
      int32_t u[kSlots][kRows];
      unsigned w[kSlots][kRows];
      if (j0 + kSlots <= kStage) {  // all staged: one shared load a slot
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = j0 + sl;
            u[sl][r] = ((done >> r) & 1u) || j >= most ? -1 : s_nbr[warp][j][r];
          }
        }
      } else {
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = j0 + sl;
            const int live = __shfl_sync(kFull, my_live, r);
            const int32_t x = j < kStage ? (j < most ? s_nbr[warp][j][r] : -1)
                            : j < live ? __ldg(a.nbr_t + (int64_t)j * a.stride + v0 + r)
                                       : -1;
            u[sl][r] = (done >> r) & 1u ? -1 : x;
          }
        }
      }
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          w[sl][r] = u[sl][r] >= 0 ? __ldg(front_gb + (size_t)(uint32_t)u[sl][r] * rb) : 0u;
        }
      }
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned h = w[sl][r] & row_byte(wants, r) & ~row_byte(gots, r);
          if (h) {
            gots |= (TileBits)h << (8 * r);
            note_claims<T>(s_par[warp][r], lane, h,
                           PlaneOf<T>::kSlotPar ? j0 + sl : u[sl][r]);
          }
        }
      }
      unsigned mine = 0u;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row_byte(wants, r) == row_byte(gots, r)) mine |= 1u << r;
      }
      done = __reduce_and_sync(kFull, mine);
    }

    // the new frontier per query; front_n and the changed vis bytes
    {
      int4* acc_s = reinterpret_cast<int4*>(&s_acc[warp][0][lane * kPer]);
      int4* acc_t = reinterpret_cast<int4*>(&s_acc[warp][1][lane * kPer]);
      int4 x = *acc_s, y = *acc_t;
      x.x += popc(gots & kRowLsb);
      x.y += popc(gots & (kRowLsb << 2));
      x.z += popc(gots & (kRowLsb << 4));
      x.w += popc(gots & (kRowLsb << 6));
      y.x += popc(gots & (kRowLsb << 1));
      y.y += popc(gots & (kRowLsb << 3));
      y.z += popc(gots & (kRowLsb << 5));
      y.w += popc(gots & (kRowLsb << 7));
      *acc_s = x;
      *acc_t = y;
    }
    unsigned mine = 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t v = v0 + r;
      const unsigned got = row_byte(gots, r);
      if (got) mine |= 1u << r;
      if (v < a.n_rows) {
        a.front_n[v * a.row_bytes + gb] = (uint8_t)got;
        if (got) a.vis[v * a.row_bytes + gb] = (uint8_t)(got | row_byte(vos, r));
      }
    }
    const unsigned changed = __reduce_or_sync(kFull, mine);

    // flush the tile's claims: lane l takes query 32 k + l of the group
    // (k = 0..3); a query's claim and vis bits come from the lane that
    // owns them (lane q / 4, bits 2 (q % 4) and 2 (q % 4) + 1). A claim on
    // one side votes with the other side's dist where that side was
    // visited, a claim on both sides with 2 * lvl.
    if (changed) {
      __syncwarp();
      unsigned long long tk[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) tk[k] = bibfs::kNoMeet;
      const int64_t qg = (int64_t)blockIdx.y * kGroup + lane;
      // bit 0: claimed on side 0, 1: on side 1, 8: visited on side 0, 9:
      // visited on side 1, of query 32 k + l of row r
      auto bits_of = [&](int r, int k) {
        const unsigned own = row_byte(gots, r) | (row_byte(vos, r) << 8);
        return __shfl_sync(kFull, own, (lane >> 2) + 8 * k) >> (2 * (lane & 3));
      };
      // the other side's dist of every one-sided claim whose other side was
      // visited, the tile's loads all in flight together
      int32_t other[kRows][kPer];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          other[r][k] = 0;
          if ((changed >> r) & 1u) {
            const unsigned bits = bits_of(r, k);
            const int64_t e = (v0 + r) * a.b + qg + 32 * k;
            if ((bits & 0x201u) == 0x201u) {
              other[r][k] = (int32_t)static_cast<const T*>(a.dt)[e];
            } else if ((bits & 0x102u) == 0x102u) {
              other[r][k] = (int32_t)static_cast<const T*>(a.ds)[e];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!((changed >> r) & 1u)) continue;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const unsigned bits = bits_of(r, k);
          const int64_t e = (v0 + r) * a.b + qg + 32 * k;
          const bool cs = bits & 1u, ct = (bits >> 1) & 1u;
          if (cs) {
            static_cast<T*>(a.ds)[e] = (T)a.lvl;
            static_cast<T*>(a.ps)[e] = s_par[warp][r][0][32 * k + lane];
          }
          if (ct) {
            static_cast<T*>(a.dt)[e] = (T)a.lvl;
            static_cast<T*>(a.pt)[e] = s_par[warp][r][1][32 * k + lane];
          }
          int32_t sum = -1;
          if (cs && ct) {
            sum = 2 * a.lvl;
          } else if ((bits & 0x201u) == 0x201u || (bits & 0x102u) == 0x102u) {
            sum = a.lvl + other[r][k];
          }
          if (sum >= 0) {
            const unsigned long long key =
                ((unsigned long long)(uint32_t)sum << 32) | (uint32_t)(v0 + r);
            tk[k] = key < tk[k] ? key : tk[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        unsigned long long* key = &s_key[warp][32 * k + lane];
        if (tk[k] < *key) *key = tk[k];
      }
    }
  }

  // one sum per block, query and counter
  __syncthreads();
  for (int t = threadIdx.x; t < kGroup; t += kThreads) {
    const int64_t q = (int64_t)blockIdx.y * kGroup + t;
    int32_t sum[3] = {0, 0, 0};
    unsigned long long k = bibfs::kNoMeet;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c] += s_acc[w][c][t];
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
    cudaFuncSetAttribute(minor_level_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kParBytes<T>);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minor_level_kernel<T>,
                                                  kThreads, kParBytes<T>);
    grid_x = sms * (per_sm > 1 ? per_sm : 1);
    if (grid_x < 1) grid_x = 1;
  }
  const int64_t groups = a.b / kGroup;
  const int64_t block_tiles = (a.tiles + kWarps - 1) / kWarps;
  int64_t per_group = (grid_x + groups - 1) / groups;
  if (per_group > block_tiles) per_group = block_tiles;
  const dim3 grid((unsigned)per_group, (unsigned)groups);
  minor_level_kernel<T><<<grid, kThreads, kParBytes<T>, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One level over int32 (itemsize 4) or int8 (itemsize 1) planes. `front`,
// `front_n` and `vis` are [n_rows, b / 16] pair rows of int32 words;
// `counts` ([3, b] int32) is added into (the caller zeroes it) and `key`
// ([b] uint64, the previous level's vote) is min-folded into.
extern "C" int bibfs_minor_level(int itemsize, const void* nbr_t, int64_t stride,
                                 int width, int64_t n_tab, const void* deg,
                                 int64_t n_rows, int64_t b, const void* front,
                                 void* front_n, void* vis, void* ds, void* dt,
                                 void* ps, void* pt, int lvl, const void* active,
                                 void* counts, void* key, void* stream) {
  const MinorArgs a{(const int32_t*)nbr_t, stride, width, n_tab,
                    (const int32_t*)deg, n_rows, b, b / 4,
                    (const uint8_t*)front, (uint8_t*)front_n, (uint8_t*)vis, ds,
                    dt, ps, pt, (int32_t)lvl, (const int32_t*)active,
                    (int32_t*)counts, (unsigned long long*)key,
                    (n_rows + kRows - 1) / kRows};
  if (itemsize == 4) return launch_minor<int32_t>(a, stream);
  if (itemsize == 1) return launch_minor<int8_t>(a, stream);
  return (int)cudaErrorInvalidValue;
}
