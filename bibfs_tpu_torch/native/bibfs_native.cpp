// Native runtime for bibfs_tpu — C++17 shared library bound via ctypes.
//
// Role: the framework's host-side native layer, replacing what the
// reference implemented in C++ around its solvers — binary graph loading
// (v1/main-v1.cpp:21-34), CSR construction by degree-count + prefix-sum +
// scatter (v3/bibfs_cuda_only.cu:89-99, v4/mpi_bas.cpp:45-58), and the v1
// serial bidirectional-BFS baseline itself (v1/main-v1.cpp:50-97). The TPU
// compute path stays in JAX/Pallas; this .so exists so graph preprocessing
// at 10M-node scale and the wall-clock baseline don't pay Python overheads.
//
// API style: stateless extern "C" functions over caller-allocated buffers
// (NumPy arrays on the Python side). Return 0 on success, negative errno-
// style codes on failure. No globals, no exceptions across the boundary.
// The one stateful object is the OPAQUE solve scratch (bibfs_scratch_*):
// repeated solves over one graph reuse epoch-stamped distance/parent
// arrays, so per-solve setup is O(vertices touched), not O(n) — the O(n)
// re-initialization of four n-sized arrays otherwise dominates wall-clock
// for short searches on large graphs (measured: most of ~100us at n=100k).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- errors
enum {
  BIBFS_OK = 0,
  BIBFS_EOPEN = -1,     // cannot open file
  BIBFS_EFORMAT = -2,   // truncated / malformed file
  BIBFS_ERANGE = -3,    // endpoint out of range
  BIBFS_EARG = -4,      // bad argument (src/dst out of range, etc.)
  BIBFS_EBUF = -5,      // caller buffer too small
  BIBFS_ENOMEM = -6,    // allocation failure
};

// ------------------------------------------------------------- graph I/O
// Binary format: little-endian uint32 N, uint32 M, then M uint32 pairs
// (the reference on-disk contract, graphs/generate_graph.py:35-39).

int bibfs_read_header(const char* path, uint32_t* n, uint32_t* m) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return BIBFS_EOPEN;
  uint32_t hdr[2];
  size_t got = std::fread(hdr, sizeof(uint32_t), 2, f);
  std::fclose(f);
  if (got != 2) return BIBFS_EFORMAT;
  *n = hdr[0];
  *m = hdr[1];
  return BIBFS_OK;
}

// edges: caller-allocated uint32[2*m]; validates size and endpoint range.
int bibfs_read_edges(const char* path, uint32_t n, uint32_t m,
                     uint32_t* edges) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return BIBFS_EOPEN;
  if (std::fseek(f, 2 * sizeof(uint32_t), SEEK_SET) != 0) {
    std::fclose(f);
    return BIBFS_EFORMAT;
  }
  size_t want = size_t(2) * m;
  size_t got = std::fread(edges, sizeof(uint32_t), want, f);
  std::fclose(f);
  if (got != want) return BIBFS_EFORMAT;
  for (size_t i = 0; i < want; ++i)
    if (edges[i] >= n) return BIBFS_ERANGE;
  return BIBFS_OK;
}

// --------------------------------------------------------------- CSR build
// Mirror undirected edges, drop self-loops and duplicates, produce a
// sorted symmetric CSR. row_ptr: int64[n+1]; col_ind: int32[<=2m]
// (caller allocates the 2m upper bound; *out_nnz reports the used size).
int bibfs_build_csr(uint32_t n, uint64_t m, const uint32_t* edges,
                    int64_t* row_ptr, int32_t* col_ind, int64_t* out_nnz) {
  std::vector<uint64_t> keys;
  keys.reserve(2 * m);
  for (uint64_t e = 0; e < m; ++e) {
    uint32_t u = edges[2 * e], v = edges[2 * e + 1];
    if (u >= n || v >= n) return BIBFS_ERANGE;
    if (u == v) continue;
    keys.push_back((uint64_t(u) << 32) | v);
    keys.push_back((uint64_t(v) << 32) | u);
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());

  std::memset(row_ptr, 0, (n + 1) * sizeof(int64_t));
  for (uint64_t k : keys) row_ptr[(k >> 32) + 1]++;
  for (uint32_t v = 0; v < n; ++v) row_ptr[v + 1] += row_ptr[v];
  for (size_t i = 0; i < keys.size(); ++i)
    col_ind[i] = int32_t(keys[i] & 0xffffffffu);
  *out_nnz = int64_t(keys.size());
  return BIBFS_OK;
}

// ---------------------------------------------------- serial bidirectional BFS
// The v1-parity native baseline (v1/main-v1.cpp:50-97): level-synchronous,
// smaller-frontier-first, per-side parent arrays — but with the correct
// termination rule (track best meet, stop when level_s + level_t >= best)
// instead of v1's first-meet early exit (quirk Q2).

namespace {

constexpr int32_t INF = INT32_MAX / 4;

// Epoch-stamped per-side search state: dist/par entries are valid only
// where stamp[v] == epoch, so starting a new solve is one ++epoch instead
// of refilling four n-sized arrays.
struct Side {
  std::vector<int32_t> dist, par;
  std::vector<uint32_t> stamp;
  std::vector<uint32_t> fr, next;

  void init(uint32_t n) {
    dist.assign(n, INF);
    par.assign(n, -1);
    stamp.assign(n, 0);
  }
  int32_t d(uint32_t v, uint32_t ep) const {
    return stamp[v] == ep ? dist[v] : INF;
  }
  void claim(uint32_t v, uint32_t ep, int32_t lvl, int32_t parent) {
    stamp[v] = ep;
    dist[v] = lvl;
    par[v] = parent;
  }
};

struct Scratch {
  uint32_t n = 0;
  uint32_t epoch = 0;
  Side s, t;
};

}  // namespace

void* bibfs_scratch_create(uint32_t n) {
  // no exception may cross the extern "C"/ctypes boundary: vector growth
  // can throw bad_alloc, so the whole construction is fenced
  try {
    auto* sc = new Scratch;
    sc->n = n;
    sc->s.init(n);
    sc->t.init(n);
    return sc;
  } catch (...) {
    return nullptr;
  }
}

void bibfs_scratch_free(void* scratch) { delete static_cast<Scratch*>(scratch); }

namespace {

// May throw (frontier push_back / path vectors on OOM); the extern "C"
// wrapper below fences it so no exception crosses the ABI.
//
// Optional per-level telemetry (all-or-nothing, enabled when lvl_side is
// non-null): level i (< lvl_cap) writes the expanded side (0 = source,
// 1 = target), the post-expansion frontier size, and the edges scanned
// that level; *out_meet_level gets the 1-based level at which the final
// best meet candidate was found (-1 if never). Disabled (the existing
// exports) costs one pointer test per level.
int solve_impl(uint32_t n, const int64_t* row_ptr, const int32_t* col_ind,
               void* scratch, uint32_t src, uint32_t dst,
               int32_t* out_hops, int32_t* path_buf, int32_t path_cap,
               int32_t* out_path_len, double* out_time_s,
               int64_t* out_edges, int32_t* out_levels,
               int32_t lvl_cap = 0, uint8_t* lvl_side = nullptr,
               int32_t* lvl_frontier = nullptr, int64_t* lvl_edges = nullptr,
               int32_t* out_meet_level = nullptr) {
  if (src >= n || dst >= n || !scratch) return BIBFS_EARG;
  auto* sc = static_cast<Scratch*>(scratch);
  if (sc->n != n) return BIBFS_EARG;
  *out_hops = -1;
  *out_path_len = 0;
  *out_edges = 0;
  *out_levels = 0;
  if (out_meet_level) *out_meet_level = -1;

  auto t0 = std::chrono::steady_clock::now();
  auto finish = [&]() {
    *out_time_s =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();
  };

  if (src == dst) {
    *out_hops = 0;
    if (path_cap >= 1) {
      path_buf[0] = int32_t(src);
      *out_path_len = 1;
    }
    finish();
    return BIBFS_OK;
  }

  if (++sc->epoch == 0) {  // stamp wrap (once per 2^32 solves): hard reset
    sc->s.init(n);
    sc->t.init(n);
    sc->epoch = 1;
  }
  const uint32_t ep = sc->epoch;
  Side& S = sc->s;
  Side& T = sc->t;
  S.fr.assign(1, src);
  T.fr.assign(1, dst);
  S.claim(src, ep, 0, -1);
  T.claim(dst, ep, 0, -1);

  int32_t level_s = 0, level_t = 0, best = INF;
  int64_t scanned = 0;
  int32_t levels = 0;
  uint32_t meet = UINT32_MAX;

  while (!S.fr.empty() && !T.fr.empty() && level_s + level_t < best) {
    bool s_side = S.fr.size() <= T.fr.size();
    Side& A = s_side ? S : T;
    Side& B = s_side ? T : S;
    int32_t lvl = (s_side ? ++level_s : ++level_t);

    A.next.clear();
    int64_t scanned_before = scanned;
    for (uint32_t u : A.fr) {
      for (int64_t i = row_ptr[u]; i < row_ptr[u + 1]; ++i) {
        ++scanned;
        uint32_t v = uint32_t(col_ind[i]);
        if (A.stamp[v] == ep) continue;  // already visited this side
        A.claim(v, ep, lvl, int32_t(u));
        A.next.push_back(v);
        int32_t dv_other = B.d(v, ep);
        if (dv_other != INF) {
          int32_t cand = lvl + dv_other;
          if (cand < best) {
            best = cand;
            meet = v;
            if (out_meet_level) *out_meet_level = levels + 1;
          }
        }
      }
    }
    A.fr.swap(A.next);
    ++levels;
    if (lvl_side && levels <= lvl_cap) {
      lvl_side[levels - 1] = s_side ? 0 : 1;
      lvl_frontier[levels - 1] = int32_t(A.fr.size());
      lvl_edges[levels - 1] = scanned - scanned_before;
    }
  }
  finish();
  *out_edges = scanned;
  *out_levels = levels;

  if (best >= INF) return BIBFS_OK;  // unreachable: out_hops stays -1
  *out_hops = best;

  // path reconstruction: walk parents both ways from the meet vertex
  // (v1/main-v1.cpp:86-97). Every vertex on a parent chain was claim()ed
  // this epoch (claim stamps before writing par, and best < INF means the
  // meet is stamped on both sides), so the plain -1-terminated walk needs
  // no stamp guards.
  std::vector<int32_t> left;  // meet .. src
  for (int32_t v = int32_t(meet); v != -1; v = S.par[uint32_t(v)])
    left.push_back(v);
  std::vector<int32_t> right;  // after meet .. dst
  for (int32_t v = T.par[meet]; v != -1; v = T.par[uint32_t(v)])
    right.push_back(v);

  int64_t total = int64_t(left.size()) + int64_t(right.size());
  if (total > path_cap) return BIBFS_OK;  // hops valid, path omitted
  int32_t k = 0;
  for (auto it = left.rbegin(); it != left.rend(); ++it) path_buf[k++] = *it;
  for (int32_t v : right) path_buf[k++] = v;
  *out_path_len = k;
  return BIBFS_OK;
}

}  // namespace

// Scratch-reusing solve: per-solve setup cost is O(touched), not O(n).
// Outputs: *out_hops = -1 if unreachable, else hop count; path written to
// path_buf (path_cap entries; *out_path_len = 0 if it doesn't fit);
// *out_time_s = search-loop seconds (reference timing parity);
// *out_edges = directed edges scanned; *out_levels = expansions done.
int bibfs_solve_s(uint32_t n, const int64_t* row_ptr, const int32_t* col_ind,
                  void* scratch, uint32_t src, uint32_t dst,
                  int32_t* out_hops, int32_t* path_buf, int32_t path_cap,
                  int32_t* out_path_len, double* out_time_s,
                  int64_t* out_edges, int32_t* out_levels) {
  try {
    return solve_impl(n, row_ptr, col_ind, scratch, src, dst, out_hops,
                      path_buf, path_cap, out_path_len, out_time_s,
                      out_edges, out_levels);
  } catch (...) {  // bad_alloc etc. must not cross the C ABI
    return BIBFS_ENOMEM;
  }
}

// Scratch-reusing solve WITH per-level telemetry: identical search to
// bibfs_solve_s, plus per-level outputs (see solve_impl) for the first
// lvl_cap levels — side (0=s/1=t), post-expansion frontier size, edges
// scanned — and the 1-based level of the final best meet candidate.
// Levels past lvl_cap still run and count; only recording stops.
int bibfs_solve_levels(uint32_t n, const int64_t* row_ptr,
                       const int32_t* col_ind, void* scratch, uint32_t src,
                       uint32_t dst, int32_t* out_hops, int32_t* path_buf,
                       int32_t path_cap, int32_t* out_path_len,
                       double* out_time_s, int64_t* out_edges,
                       int32_t* out_levels, int32_t lvl_cap,
                       uint8_t* lvl_side, int32_t* lvl_frontier,
                       int64_t* lvl_edges, int32_t* out_meet_level) {
  if (!lvl_side || !lvl_frontier || !lvl_edges || !out_meet_level ||
      lvl_cap < 0)
    return BIBFS_EARG;
  try {
    return solve_impl(n, row_ptr, col_ind, scratch, src, dst, out_hops,
                      path_buf, path_cap, out_path_len, out_time_s,
                      out_edges, out_levels, lvl_cap, lvl_side,
                      lvl_frontier, lvl_edges, out_meet_level);
  } catch (...) {
    return BIBFS_ENOMEM;
  }
}

// Threaded batch solve: `batch` independent queries striped over
// `num_threads` worker threads, each with its own epoch-stamped scratch —
// the host analog of the device backends' vmapped batch (and the
// parallelism the reference's process-per-query harness could not
// express, benchmark_test.sh:44-59). The graph arrays are shared
// read-only; outputs are per-query slices, so no synchronization beyond
// thread join is needed. Per-query paths land in path_buf[q*path_cap ..];
// a path longer than path_cap leaves out_path_len[q] = 0 with hops still
// valid (same rule as the single solve). *out_time_s is the WHOLE batch
// wall-clock. Returns the first non-OK code any query hit (remaining
// queries still run; per-query outputs of failed queries are untouched).
int bibfs_solve_batch(uint32_t n, const int64_t* row_ptr,
                      const int32_t* col_ind, int32_t batch,
                      const uint32_t* srcs, const uint32_t* dsts,
                      int32_t num_threads, int32_t* out_hops,
                      int32_t* path_buf, int32_t path_cap,
                      int32_t* out_path_len, double* out_time_s,
                      int64_t* out_edges, int32_t* out_levels) {
  if (batch < 0 || num_threads < 1) return BIBFS_EARG;
  auto t0 = std::chrono::steady_clock::now();
  int nthreads = std::min<int32_t>(num_threads, batch > 0 ? batch : 1);
  std::atomic<int> err{BIBFS_OK};
  auto work = [&](int tid) {
    void* sc = bibfs_scratch_create(n);
    if (!sc) {
      int want = BIBFS_OK;
      err.compare_exchange_strong(want, BIBFS_ENOMEM);
      return;
    }
    for (int32_t q = tid; q < batch; q += nthreads) {
      double tq = 0.0;
      int rc = bibfs_solve_s(n, row_ptr, col_ind, sc, srcs[q], dsts[q],
                             &out_hops[q], path_buf + size_t(q) * path_cap,
                             path_cap, &out_path_len[q], &tq, &out_edges[q],
                             &out_levels[q]);
      if (rc != BIBFS_OK) {
        int want = BIBFS_OK;
        err.compare_exchange_strong(want, rc);
      }
    }
    bibfs_scratch_free(sc);
  };
  if (nthreads == 1) {
    work(0);
  } else {
    // thread construction can throw (resource exhaustion); nothing may
    // cross the extern "C" boundary — fall back to inline execution of
    // the un-started stripes
    std::vector<std::thread> threads;
    int started = 0;
    try {
      threads.reserve(nthreads);
      for (; started < nthreads; ++started) threads.emplace_back(work, started);
    } catch (...) {
      for (int t = started; t < nthreads; ++t) work(t);
    }
    for (auto& th : threads) th.join();
  }
  *out_time_s =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  return err.load();
}

// Stateless one-shot wrapper (original ABI, kept for compatibility):
// allocates a scratch for the single call.
int bibfs_solve(uint32_t n, const int64_t* row_ptr, const int32_t* col_ind,
                uint32_t src, uint32_t dst, int32_t* out_hops,
                int32_t* path_buf, int32_t path_cap, int32_t* out_path_len,
                double* out_time_s, int64_t* out_edges, int32_t* out_levels) {
  void* sc = bibfs_scratch_create(n);
  if (!sc) return BIBFS_ENOMEM;
  int rc = bibfs_solve_s(n, row_ptr, col_ind, sc, src, dst, out_hops,
                         path_buf, path_cap, out_path_len, out_time_s,
                         out_edges, out_levels);
  bibfs_scratch_free(sc);
  return rc;
}

}  // extern "C"
