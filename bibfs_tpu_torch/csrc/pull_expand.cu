// Pull expansion of one BFS level over the slot-major sentinel table.
//
// pull_dual_kernel replaces bibfs_tpu/ops/pallas_expand.py _pull_kernel_dual
// (both sides of a lock-step level from one dual-coded frontier row), and
// pull_kernel replaces _pull_kernel (one side).
//
// Bound on the H100: device-memory bytes. Each unvisited row reads its live
// slots of nbr_t (4 B each) plus one frontier byte per slot, and every row
// reads its visited bytes and writes 5 bytes per side. There is no matrix
// product and a handful of integer operations per slot.
//
// Design: one thread per vertex row; neighbouring threads read
// neighbouring addresses of each slot row of nbr_t. The frontier lookup
// frontier[nbr_t[j, v]] happens inside the kernel (the TPU kernel needed a
// separate XLA gather because Mosaic gathers only within one vreg). A row
// that is already visited on a side does not look for that side, and a row
// stops reading at its first sentinel or once every wanted side has a hit,
// so only live slots are read. The first hit slot gives the parent
// directly, with no slot*KS+nbr key and no key-overflow bound. The parent
// output is -1 wherever the new-frontier output is 0.
#include "level_common.cuh"

using namespace bibfs;

__global__ void __launch_bounds__(kBlock) pull_kernel(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t n_rows,
    const uint8_t* __restrict__ front, int64_t id_space,
    const uint8_t* __restrict__ vis, uint8_t* __restrict__ nf,
    int32_t* __restrict__ pc) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_rows) return;
  int32_t p = -1, unused = -1;
  unsigned got = 0u;
  if (!vis[v]) {
    got = claim_first_slot(nbr_t, stride, wp, v, front, id_space, 1u, &p, &unused);
  }
  nf[v] = (uint8_t)got;
  pc[v] = p;
}

__global__ void __launch_bounds__(kBlock) pull_dual_kernel(
    const int32_t* __restrict__ nbr_t, int64_t stride, int wp, int64_t n_rows,
    const uint8_t* __restrict__ dual, int64_t id_space,
    const uint8_t* __restrict__ vis_s, const uint8_t* __restrict__ vis_t,
    uint8_t* __restrict__ nf_s, int32_t* __restrict__ pc_s,
    uint8_t* __restrict__ nf_t, int32_t* __restrict__ pc_t) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_rows) return;
  const unsigned want = (vis_s[v] ? 0u : 1u) | (vis_t[v] ? 0u : 2u);
  int32_t p_s = -1, p_t = -1;
  unsigned got = 0u;
  if (want) {
    got = claim_first_slot(nbr_t, stride, wp, v, dual, id_space, want, &p_s, &p_t);
  }
  nf_s[v] = (uint8_t)(got & 1u);
  pc_s[v] = p_s;
  nf_t[v] = (uint8_t)((got >> 1) & 1u);
  pc_t[v] = p_t;
}

extern "C" int bibfs_pull(const void* nbr_t, int64_t stride, int wp,
                          int64_t n_rows, const void* front, int64_t id_space,
                          const void* vis, void* nf, void* pc, void* stream) {
  if (n_rows > 0) {
    pull_kernel<<<grid_for(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbr_t, stride, wp, n_rows, (const uint8_t*)front,
        id_space, (const uint8_t*)vis, (uint8_t*)nf, (int32_t*)pc);
  }
  return (int)cudaGetLastError();
}

extern "C" int bibfs_pull_dual(const void* nbr_t, int64_t stride, int wp,
                               int64_t n_rows, const void* dual,
                               int64_t id_space, const void* vis_s,
                               const void* vis_t, void* nf_s, void* pc_s,
                               void* nf_t, void* pc_t, void* stream) {
  if (n_rows > 0) {
    pull_dual_kernel<<<grid_for(n_rows), kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbr_t, stride, wp, n_rows, (const uint8_t*)dual,
        id_space, (const uint8_t*)vis_s, (const uint8_t*)vis_t,
        (uint8_t*)nf_s, (int32_t*)pc_s, (uint8_t*)nf_t, (int32_t*)pc_t);
  }
  return (int)cudaGetLastError();
}
