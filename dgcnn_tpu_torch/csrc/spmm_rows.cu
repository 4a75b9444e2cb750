// Row-parallel CSR SpMM — CUDA kernel for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/spmm_pallas.py:spmm_pallas (pallas_call at
// :102; backward _bwd :230). Contract:
//
//   out[i, :] = sum_{p in [row_ptr[i], row_ptr[i+1])} w[e] * h[col[e], :]
//   e = perm[p] (or p when perm is null),  i < n_rows
//   h [*, f] fp32 row-major, out [n_rows, f] fp32, f >= 1 (any width)
//
// Forward: the destination-sorted order, col = src. Backward (dh): the
// source-sorted order (perm = the stable by-source permutation,
// row_ptr over it), col = dst, h = the output gradient. The wrapper
// (kernels/spmm_pallas.py) builds both orders once per batch; padded edges
// (mask 0) may be left out of both, since they carry weight 0.
//
// Design. The TPU kernel walked one edge stream with a running row
// accumulator flushed into a VMEM-resident output, serially. Here each
// destination row is owned by one warp (f >= 2, lanes over columns, 32
// columns per pass) or one thread (f = 1), which walks the row's edges in
// order and writes the row once: every row, including rows with no edges
// (zeros), is written exactly once, with no atomics, and the same bits on
// every run. A warp's 32 lanes read one 128-byte row of h per edge at
// f = 32.
//
// What bounds it on the H100: per call, with E real edges,
//   bytes      = E * 12 (index, weight, permutation) + 2 * n_rows * f * 4
//   operations = 2 * E * f
// DD's mean COO batch (~72k edges, ~14k rows, f = 32) is ~4.5 MB: ~1.3 us
// at 3.35 TB/s, against 4.6 MFLOP: bound by bytes. The gathers of h rows
// are random 128-byte reads (h, 2 MB, stays in L2), and degree skew
// leaves some warps with long rows: that, not the bound, is expected to
// set the time.
//
// Every entry returns cudaGetLastError() of its launch.

#include "spmm_seq.cuh"

namespace {

using namespace spmm;

template <int G>
__global__ void __launch_bounds__(NT) rows_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ col, const float* __restrict__ w,
    const float* __restrict__ h, float* __restrict__ out, int n_rows, int f) {
  const int row = blockIdx.x * (NT / G) + threadIdx.x / G;
  if (row >= n_rows) return;
  run_sum<G>(perm, col, w, h, row_ptr[row], row_ptr[row + 1], f,
             threadIdx.x % G, out + (size_t)row * f);
}

}  // namespace

// out [n_rows, f]; row_ptr [n_rows+1]; perm nullable; col, w by edge id.
extern "C" int spmm_rows_f32(const int* row_ptr, const int* perm,
                             const int* col, const float* w, const float* h,
                             float* out, int n_rows, int f, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (f < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 1) {
    rows_kernel<1><<<(n_rows + NT - 1) / NT, NT, 0, s>>>(row_ptr, perm, col, w,
                                                         h, out, n_rows, f);
  } else {
    constexpr int per = NT / 32;
    rows_kernel<32><<<(n_rows + per - 1) / per, NT, 0, s>>>(
        row_ptr, perm, col, w, h, out, n_rows, f);
  }
  return cudaGetLastError();
}

extern "C" const char* spmm_rows_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
