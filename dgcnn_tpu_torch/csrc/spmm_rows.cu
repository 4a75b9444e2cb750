// Row-parallel CSR SpMM — CUDA kernel for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/spmm_pallas.py:spmm_pallas (pallas_call at
// :102; backward _bwd :230). Contract:
//
//   out[i, :] = sum_{p in [row_ptr[i], row_ptr[i+1]), in order}
//               w[e] * h[colp[p], :],   e = perm[p] (or p when perm is null)
//   h [*, f] fp32 row-major, out [n_rows, f] fp32, f >= 1 (any width)
//
// colp is the column of each POSITION (colp[p] = col[perm[p]]), built once
// per batch beside the order (ops/spmm.py edge_order). Forward: the
// destination-sorted order, col = src. Backward (dh): the source-sorted
// order (perm = the stable by-source permutation, row_ptr over it),
// col = dst, h = the output gradient. Padded edges (mask 0) may be left out
// of both orders, since they carry weight 0.
//
// What bounds it on the H100: per call, with E real edges, R rows of h
// that some edge reads and n = n_rows (utils/profiling.py spmm_bound),
//   bytes      = E * 8 (column, weight) + (n + 1) * 4 + R * f * 4 + n * f * 4
//   operations = 2 * E * f
// DD's mean device-assembled batch (69,622 edges, n 20,736, f 32) is
// ~5 MB: 0.0015 ms at 3.35 TB/s, against 4.5 MFLOP: bound by bytes. What
// sets the time is L2, not device memory: each edge reads a whole row of
// h from L2 (8.9 MB at that batch), behind a short chain of dependent
// round trips (row pointers, then indices, then h rows); the card has to
// keep enough of them in flight to run the gather at L2 bandwidth.
//
// Design. A group of G lanes owns a row: G = 8 with a float4 per
// lane (32 columns per pass) where f % 4 == 0 and h is 16-byte aligned,
// else G = 32 lanes over columns; four rows per warp at G = 8. Per G
// positions of its run the group loads the (column, weight) pairs with one
// coalesced load per lane (the column read straight from colp, so the h
// gather waits on one index read, not on perm -> col), broadcasts them
// with __shfl_sync, and issues the h-row loads of K = 8 edges before the
// first multiply-add. At f = 1 eight lanes gather eight edges' h values at
// once and the sum walks them through shuffles. Each column is summed in
// position order, acc = fmaf(w, h, acc) from 0, so the result has the same
// bits as the earlier design (a lane or thread walking perm -> col -> h one
// edge at a time, kept as DESIGN_EARLIER for the in-run comparison). A row
// with no edge costs its group a coalesced store of zeros. Every row is
// written exactly once, with no atomics: the same bits on every run.
//
// Every entry returns cudaGetLastError() of its launch.

#include <stdint.h>

#include "spmm_seq.cuh"

namespace {

using namespace spmm;

// f >= 2: G lanes per row, V columns per lane (V = 4 needs f % 4 == 0 and a
// 16-byte aligned h, so a lane's four columns are all in range or all out).
template <int G, int V>
__global__ void __launch_bounds__(NT) rows_group(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ colp, const float* __restrict__ w,
    const float* __restrict__ h, float* __restrict__ out, int n_rows, int f) {
  const int row = blockIdx.x * (NT / G) + threadIdx.x / G;
  if (row >= n_rows) return;  // the whole group
  const unsigned mask = group_mask<G>();
  const int lane = threadIdx.x % G;
  const int p0 = row_ptr[row], p1 = row_ptr[row + 1];
  float* dst = out + (size_t)row * f;
  for (int c0 = 0; c0 < f; c0 += G * V) {
    const int c = c0 + lane * V;
    const bool on = c < f;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int pb = p0; pb < p1; pb += G) {
      const int m = min(G, p1 - pb);
      int src = 0;
      float ws = 0.f;
      if (lane < m) {
        src = colp[pb + lane];
        ws = w[perm ? perm[pb + lane] : pb + lane];
      }
      for (int k0 = 0; k0 < m; k0 += K) {
        float hv[K][V];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = __shfl_sync(mask, src, k0 + j, G);
          if (on && k0 + j < m) {
            load_h<V>(hv[j], h + (size_t)s * f + c);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) hv[j][v] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float wv = __shfl_sync(mask, ws, k0 + j, G);
          if (k0 + j < m) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = fmaf(wv, hv[j][v], acc[v]);
          }
        }
      }
    }
    if (on) store_v<V>(dst + c, acc);
  }
}

// f = 1: G lanes per row, one edge per lane per pass; every lane of the
// group takes the same sum in position order, lane 0 writes it.
template <int G>
__global__ void __launch_bounds__(NT) rows_f1(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ colp, const float* __restrict__ w,
    const float* __restrict__ h, float* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * (NT / G) + threadIdx.x / G;
  if (row >= n_rows) return;  // the whole group
  const unsigned mask = group_mask<G>();
  const int lane = threadIdx.x % G;
  const int p0 = row_ptr[row], p1 = row_ptr[row + 1];
  float acc = 0.f;
  for (int pb = p0; pb < p1; pb += G) {
    const int m = min(G, p1 - pb);
    float hv = 0.f, ws = 0.f;
    if (lane < m) {
      hv = __ldg(h + colp[pb + lane]);
      ws = w[perm ? perm[pb + lane] : pb + lane];
    }
    for (int k = 0; k < m; ++k)
      acc = fmaf(__shfl_sync(mask, ws, k, G), __shfl_sync(mask, hv, k, G), acc);
  }
  if (lane == 0) out[row] = acc;
}

// The earlier design: a warp (f >= 2, lanes over columns) or a
// thread (f = 1) per row, one edge at a time through perm -> col -> h.
template <int G>
__global__ void __launch_bounds__(NT) rows_earlier(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ col, const float* __restrict__ w,
    const float* __restrict__ h, float* __restrict__ out, int n_rows, int f) {
  const int row = blockIdx.x * (NT / G) + threadIdx.x / G;
  if (row >= n_rows) return;
  run_sum<G>(perm, col, w, h, row_ptr[row], row_ptr[row + 1], f,
             threadIdx.x % G, out + (size_t)row * f);
}

template <typename Kernel, typename... Args>
void launch_rows(Kernel kernel, int rows_per_block, int n_rows,
                 cudaStream_t s, Args... args) {
  kernel<<<(n_rows + rows_per_block - 1) / rows_per_block, NT, 0, s>>>(args...);
}

}  // namespace

// out [n_rows, f]; row_ptr [n_rows+1]; perm nullable; w and col by edge
// id, colp by position. design DESIGN_CURRENT reads colp (col may be
// null), DESIGN_EARLIER reads col through perm (colp may be null).
extern "C" int spmm_rows_f32(const int* row_ptr, const int* perm,
                             const int* col, const int* colp, const float* w,
                             const float* h, float* out, int n_rows, int f,
                             int design, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (f < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == DESIGN_EARLIER) {
    if (!col) return cudaErrorInvalidValue;
    if (f == 1)
      launch_rows(rows_earlier<1>, NT, n_rows, s, row_ptr, perm, col, w, h,
                  out, n_rows, f);
    else
      launch_rows(rows_earlier<32>, NT / 32, n_rows, s, row_ptr, perm, col, w,
                  h, out, n_rows, f);
    return cudaGetLastError();
  }
  if (design != DESIGN_CURRENT || !colp) return cudaErrorInvalidValue;
  if (f == 1) {
    launch_rows(rows_f1<8>, NT / 8, n_rows, s, row_ptr, perm, colp, w, h, out,
                n_rows);
  } else if (f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    launch_rows(rows_group<8, 4>, NT / 8, n_rows, s, row_ptr, perm, colp, w,
                h, out, n_rows, f);
  } else {
    launch_rows(rows_group<32, 1>, NT / 32, n_rows, s, row_ptr, perm, colp, w,
                h, out, n_rows, f);
  }
  return cudaGetLastError();
}

extern "C" const char* spmm_rows_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
