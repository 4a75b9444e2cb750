// Edge-block SpMM — CUDA kernels for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/spmm_pallas.py:spmm_pallas_mxu (pallas_call
// at :170; backward _mxu_bwd :201). The same function as spmm_rows.cu:
//
//   out[i, :] = sum_{p in [row_ptr[i], row_ptr[i+1])} w[e] * h[col[e], :]
//   e = perm[p] (or p when perm is null); row[e] = i for every such p
//
// The TPU kernel took a fixed block of 256 edges per grid step and ran
// gather and scatter as one-hot selector matmuls on the MXU (4 * N * f
// operations per edge, a trade for a chip with no gather). The GPU form
// of "a fixed block of 256 edges per program" is an edge-parallel
// segmented reduction, in two passes:
//
//   pass 1: one block of 256 threads per 256 positions of the ordered
//     stream (positions past row_ptr[n_rows] are not read). The block
//     finds the runs of equal row among its positions (ballot + prefix
//     count), and a warp (f >= 2, lanes over columns) or a thread (f = 1)
//     sums each run in position order. A row whose positions all lie in
//     this block is written to out directly; a row that straddles a block
//     boundary writes its partial sum to a scratch: the tail slot of the
//     block holding the row's first position, the head slot of every
//     later block.
//   pass 2: one warp (or thread) per row: rows with no edges are written
//     as zeros; a straddling row adds the tail partial of its first block
//     and the head partials of the following blocks, in block order.
//
// Every row is written exactly once, with no float atomics, in an order
// fixed by the data: the same bits on every run. Unlike the row kernel,
// a block's work is 256 edges whatever the degrees, so a skewed degree
// distribution does not leave one warp with a long row.
//
// Bound: the same as spmm_rows.cu (bytes = E*12 + 2*n_rows*f*4,
// operations = 2*E*f), plus the scratch, 2 * blocks * f * 4 bytes.
//
// Every entry returns cudaGetLastError() of its last launch.

#include "spmm_seq.cuh"

namespace {

using namespace spmm;

constexpr int EB = 256;  // positions per block (== NT)
static_assert(EB == NT, "one position per thread");

template <int G>
__global__ void __launch_bounds__(NT) edge_block_pass1(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ row, const int* __restrict__ col,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, float* __restrict__ partial, int n_rows, int f) {
  __shared__ int srow[EB];
  __shared__ int sstart[EB + 1];
  __shared__ int wcount[NT / 32];
  __shared__ int nruns;
  const int b = blockIdx.x;
  const int base = b * EB;
  const int e_real = row_ptr[n_rows];
  if (base >= e_real) return;  // the same for the whole block
  const int cnt = min(EB, e_real - base);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  int r = -1;
  if (t < cnt) r = row[perm ? perm[base + t] : base + t];
  srow[t] = r;
  __syncthreads();
  const bool start = t < cnt && (t == 0 || srow[t - 1] != r);
  const unsigned bal = __ballot_sync(0xffffffffu, start);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int off = 0;
  for (int q = 0; q < warp; ++q) off += wcount[q];
  if (start) sstart[off + __popc(bal & ((1u << lane) - 1u))] = t;
  if (t == 0) {
    int tot = 0;
    for (int q = 0; q < NT / 32; ++q) tot += wcount[q];
    nruns = tot;
    sstart[tot] = cnt;
  }
  __syncthreads();

  for (int k = t / G; k < nruns; k += NT / G) {
    const int t0 = sstart[k], t1 = sstart[k + 1];
    const int i = srow[t0];
    const int b0 = row_ptr[i] / EB, b1 = (row_ptr[i + 1] - 1) / EB;
    float* dst = b0 == b1 ? out + (size_t)i * f
                          : partial + ((size_t)b * 2 + (b == b0 ? 1 : 0)) * f;
    run_sum<G>(perm, col, w, h, base + t0, base + t1, f, t % G, dst);
  }
}

template <int G>
__global__ void __launch_bounds__(NT) edge_block_pass2(
    const int* __restrict__ row_ptr, const float* __restrict__ partial,
    float* __restrict__ out, int n_rows, int f) {
  const int i = blockIdx.x * (NT / G) + threadIdx.x / G;
  if (i >= n_rows) return;
  const int lane = threadIdx.x % G;
  const int p0 = row_ptr[i], p1 = row_ptr[i + 1];
  float* dst = out + (size_t)i * f;
  if (p0 == p1) {
    for (int c = lane; c < f; c += G) dst[c] = 0.f;
    return;
  }
  const int b0 = p0 / EB, b1 = (p1 - 1) / EB;
  if (b0 == b1) return;  // pass 1 wrote it
  for (int c = lane; c < f; c += G) {
    float acc = partial[((size_t)b0 * 2 + 1) * f + c];
    for (int b = b0 + 1; b <= b1; ++b) acc += partial[(size_t)b * 2 * f + c];
    dst[c] = acc;
  }
}

template <int G>
cudaError_t launch(const int* row_ptr, const int* perm, const int* row,
                   const int* col, const float* w, const float* h, float* out,
                   float* partial, int n_rows, int n_pos, int f,
                   cudaStream_t s) {
  const int blocks = (n_pos + EB - 1) / EB;
  if (blocks > 0) {
    edge_block_pass1<G><<<blocks, NT, 0, s>>>(row_ptr, perm, row, col, w, h,
                                              out, partial, n_rows, f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  constexpr int per = NT / G;
  edge_block_pass2<G><<<(n_rows + per - 1) / per, NT, 0, s>>>(row_ptr, partial,
                                                              out, n_rows, f);
  return cudaGetLastError();
}

}  // namespace

// out [n_rows, f]; partial [2 * ceil(n_pos / 256), f] scratch; n_pos is the
// length of the ordered stream (row_ptr[n_rows] <= n_pos, read on the card).
extern "C" int spmm_edge_block_f32(const int* row_ptr, const int* perm,
                                   const int* row, const int* col,
                                   const float* w, const float* h, float* out,
                                   float* partial, int n_rows, int n_pos,
                                   int f, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (f < 1 || n_pos < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f == 1 ? launch<1>(row_ptr, perm, row, col, w, h, out, partial,
                            n_rows, n_pos, f, s)
                : launch<32>(row_ptr, perm, row, col, w, h, out, partial,
                             n_rows, n_pos, f, s);
}

extern "C" const char* spmm_edge_block_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
