// Block-sparse GCN propagation, CSR form — CUDA kernel for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/block_pallas.py:block_propagate_pallas
// (pallas_call at :152; backward _bwd :201). Contract, shared with
// block_resident.cu:
//
//   out[r, :, :] = sum_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]   r < nb
//   hb [nb, bs, F] fp32, pool [P+1, bs, bs] fp32 (row P = zeros), out [nb, bs, F] fp32
//   transpose=True:  out[c] = sum_{w in col-major order, item_colT = c} pool[ipT_w]^T @ g[rT_w]
//
// bs = 128, F = 1..128. item_row is non-decreasing and padded items carry
// segment id >= nb, so they fall outside every row; rows no item visits
// come out as exact zeros. The backward is this kernel with transpose=1
// over the build-time col-major traversal: ipT = item_pool[permT],
// rT = min(item_row[permT], nb-1), segments item_colT (the wrapper in
// kernels/block_csr.py prepares them). No cotangent is formed for pool.
//
// Design. One block of 256 threads per output block-row r walks its
// contiguous item run [row_ptr[r], row_ptr[r+1]) (row_ptr is a
// searchsorted over the segment ids, done by the wrapper). For each item
// the pool block (64 KB) and the source rows hb[item_col] are copied into
// shared memory with cp.async, double buffered (the next item loads while
// this one multiplies; one buffer at F > 64), and the 128 x F output tile
// accumulates in registers in fp32 and is written once. The transposed
// mode reads the staged block by columns; the shared row stride is padded
// to 132 floats so neither mode meets bank conflicts. F is not padded to
// 128 as on the TPU: widths 2..128 compile for 32/64/128 columns, and
// F = 1 (the last GCN layer) has its own path, a matrix-vector product
// per item read straight from global memory (no 32x waste). Items are
// summed in item order by each thread: no atomics, the same bits on
// every run.
//
// What bounds it on the H100. Per call, with n real items:
//   bytes      = n*(bs^2*4 + bs*F*4) + nb*bs*F*4   (+ indices)
//   operations = 2*n*bs^2*F
// At DD's mean step (590 items, F = 32) that is about 50 MB, 15 us at
// 3.35 TB/s, against 0.62 GFLOP, 9 us at 67 TFLOP/s fp32: bound by bytes
// (the pool blocks). One step's blocks (~39 MB) fit the 50 MB L2 and are
// read 8 times per train step, so a warm repeat can beat the HBM bound.
// The grid is the nb budget (216 on DD at batch 50) of which 135-166 rows
// have items: about one wave on 132 SMs at one 168 KB block per SM, so
// the card is underfilled and the longest item run (18 items, the rows of
// a 2,218-node graph) sets the time. Splitting long runs across blocks
// and tensor cores are later work.
//
// Every entry returns cudaGetLastError() of its launch; the wrapper
// checks shapes, types and contiguity before calling and raises on a
// non-zero return.

#include "block_tile.cuh"

namespace {

using namespace blk;

template <int FP, bool TRANS, int STAGES>
__global__ void __launch_bounds__(NT, 1) csr_tile(
    const float* __restrict__ pool, const float* __restrict__ hb,
    const int* __restrict__ row_ptr, const int* __restrict__ ip,
    const int* __restrict__ src, float* __restrict__ out, int f) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = TileShape<FP>::STAGE;
  const int r = blockIdx.x;
  const int start = row_ptr[r];
  const int n = row_ptr[r + 1] - start;
  const size_t hb_blk = (size_t)BS * f;

  float acc[4][FP / 8];
  tile_zero<FP>(acc);
  if (n > 0) {
    stage_load<FP>(smem, pool + (size_t)ip[start] * BS * BS,
                   hb + src[start] * hb_blk, f);
    cp_async_commit();
    for (int k = 0; k < n; ++k) {
      float* cur = smem + (STAGES == 2 ? (k & 1) * STAGE : 0);
      if (STAGES == 2) {
        if (k + 1 < n) {
          const int w = start + k + 1;
          stage_load<FP>(smem + ((k + 1) & 1) * STAGE,
                         pool + (size_t)ip[w] * BS * BS, hb + src[w] * hb_blk, f);
        }
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tile_mac<FP, TRANS>(cur, acc);
      __syncthreads();
      if (STAGES == 1 && k + 1 < n) {
        const int w = start + k + 1;
        stage_load<FP>(smem, pool + (size_t)ip[w] * BS * BS,
                       hb + src[w] * hb_blk, f);
        cp_async_commit();
      }
    }
  }
  tile_store<FP>(acc, out + (size_t)r * hb_blk, f);
}

template <bool TRANS>
__global__ void __launch_bounds__(NT) csr_f1(
    const float* __restrict__ pool, const float* __restrict__ hb,
    const int* __restrict__ row_ptr, const int* __restrict__ ip,
    const int* __restrict__ src, float* __restrict__ out) {
  __shared__ __align__(16) float red[NT / 32 * BS];
  const int r = blockIdx.x;
  const int start = row_ptr[r], end = row_ptr[r + 1];
  if (TRANS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = start; w < end; ++w)
      f1_trans_item(pool + (size_t)ip[w] * BS * BS, hb + src[w] * BS, acc);
    f1_trans_store(acc, red, out + (size_t)r * BS);
  } else {
    float acc[16];
#pragma unroll
    for (int mm = 0; mm < 16; ++mm) acc[mm] = 0.f;
    for (int w = start; w < end; ++w)
      f1_fwd_item(pool + (size_t)ip[w] * BS * BS, hb + src[w] * BS, acc);
    f1_fwd_store(acc, out + (size_t)r * BS);
  }
}

template <int FP, bool TRANS>
cudaError_t launch_tile(const float* pool, const float* hb, const int* row_ptr,
                        const int* ip, const int* src, float* out, int nb,
                        int f, cudaStream_t stream) {
  constexpr int STAGES = FP <= 64 ? 2 : 1;
  const size_t smem = (size_t)STAGES * TileShape<FP>::STAGE * sizeof(float);
  static cudaError_t attr = allow_smem(csr_tile<FP, TRANS, STAGES>, smem);
  if (attr != cudaSuccess) return attr;
  csr_tile<FP, TRANS, STAGES><<<nb, NT, smem, stream>>>(pool, hb, row_ptr, ip,
                                                        src, out, f);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t dispatch(const float* pool, const float* hb, const int* row_ptr,
                     const int* ip, const int* src, float* out, int nb, int f,
                     cudaStream_t stream) {
  if (f == 1) {
    csr_f1<TRANS><<<nb, NT, 0, stream>>>(pool, hb, row_ptr, ip, src, out);
    return cudaGetLastError();
  }
  if (f <= 32)
    return launch_tile<32, TRANS>(pool, hb, row_ptr, ip, src, out, nb, f, stream);
  if (f <= 64)
    return launch_tile<64, TRANS>(pool, hb, row_ptr, ip, src, out, nb, f, stream);
  return launch_tile<128, TRANS>(pool, hb, row_ptr, ip, src, out, nb, f, stream);
}

}  // namespace

// out [nb, 128, f] = CSR propagation of hb [.., 128, f] (see the header).
// row_ptr [nb+1] int32; ip, src int32 item lists in segment order.
extern "C" int block_csr_f32(const float* pool, const float* hb,
                             const int* row_ptr, const int* ip, const int* src,
                             float* out, int nb, int f, int transpose,
                             void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (f < 1 || f > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose ? dispatch<true>(pool, hb, row_ptr, ip, src, out, nb, f, s)
                   : dispatch<false>(pool, hb, row_ptr, ip, src, out, nb, f, s);
}

extern "C" const char* block_csr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
