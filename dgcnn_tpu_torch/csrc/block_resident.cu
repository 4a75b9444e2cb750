// Block-sparse GCN propagation, item-parallel form — CUDA kernels for
// Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/block_resident.py:block_propagate_resident
// (pallas_call at :130; backward _bwd :185). Contract, shared with
// block_csr.cu:
//
//   out[r, :, :] = sum_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]   r < nb
//   hb [nb, bs, F] fp32, pool [P+1, bs, bs] fp32 (row P = zeros), out [nb, bs, F] fp32
//   transpose=True:  out[c] = sum_{w in col-major order, item_colT = c} pool[ipT_w]^T @ g[rT_w]
//
// bs = 128, F = 1..128. item_row is non-decreasing and padded items carry
// segment id >= nb; rows no item visits come out as exact zeros. The
// backward is the same pair of kernels with transpose=1 over the
// build-time col-major traversal (ipT = item_pool[permT],
// rT = min(item_row[permT], nb-1), segments item_colT; prepared by
// kernels/block_resident.py). No cotangent is formed for pool.
//
// Design. The TPU kernel walked groups of G = 8 work items with hb and
// the output resident in VMEM, adding each product into its destination
// row. On Hopper the blocks run in parallel and in no order, so adding
// into a shared output would need float atomics, whose order changes
// from run to run. The port splits the sum in two deterministic passes:
//   1. items: a grid over groups of G = 8 items; each block computes its
//      items' products pool[ip] @ hb[col] (the same staged, double
//      buffered 128 x F tile as block_csr.cu, and the same F = 1 path)
//      and writes each to a per-item fp32 scratch parts [W, bs, F];
//   2. rows: one block per destination row sums its contiguous run of
//      parts in item order and writes the row once (zeros when empty).
// Blocks whose group starts at or past num_items return at once; the
// kernel reads num_items from device memory, so the host never waits
// for it (DD's mean step has ~590 real items against a budget of 1,280).
// hb is not resident in shared memory as it was in VMEM: at DD's size it
// is 2.2 MB at F = 32, far over 227 KB. It is read through the 50 MB L2.
//
// What bounds it on the H100. Per call, with n real items:
//   bytes      = n*(bs^2*4 + bs*F*4) + nb*bs*F*4   (+ indices)
//   operations = 2*n*bs^2*F
// (the scratch adds 2*n*bs*F*4 bytes of its own, 0.6 MB at F = 32): about
// 50 MB and 15 us at DD's mean step, bound by bytes. Pass 1 runs
// ceil(590 / 8) = 74 busy blocks on 132 SMs at one 168 KB block per SM:
// the card is underfilled at G = 8; a smaller group or a persistent grid
// is later work.
//
// Every entry returns cudaGetLastError() of its launches; the wrapper
// checks shapes, types and contiguity before calling.

#include "block_tile.cuh"

namespace {

using namespace blk;

constexpr int GROUP = 8;  // work items per pass-1 block (_GROUP on the TPU)

template <int FP, bool TRANS, int STAGES>
__global__ void __launch_bounds__(NT, 1) items_tile(
    const float* __restrict__ pool, const float* __restrict__ hb,
    const int* __restrict__ ip, const int* __restrict__ src,
    const int* __restrict__ num_items, float* __restrict__ parts, int w_total,
    int f) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = TileShape<FP>::STAGE;
  const int first = blockIdx.x * GROUP;
  const int last = min(min(first + GROUP, w_total), *num_items);
  const int n = last - first;
  if (n <= 0) return;
  const size_t hb_blk = (size_t)BS * f;

  float acc[4][FP / 8];
  stage_load<FP>(smem, pool + (size_t)ip[first] * BS * BS,
                 hb + src[first] * hb_blk, f);
  cp_async_commit();
  for (int k = 0; k < n; ++k) {
    float* cur = smem + (STAGES == 2 ? (k & 1) * STAGE : 0);
    if (STAGES == 2) {
      if (k + 1 < n) {
        const int w = first + k + 1;
        stage_load<FP>(smem + ((k + 1) & 1) * STAGE,
                       pool + (size_t)ip[w] * BS * BS, hb + src[w] * hb_blk, f);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_zero<FP>(acc);
    tile_mac<FP, TRANS>(cur, acc);
    __syncthreads();
    if (STAGES == 1 && k + 1 < n) {
      const int w = first + k + 1;
      stage_load<FP>(smem, pool + (size_t)ip[w] * BS * BS,
                     hb + src[w] * hb_blk, f);
      cp_async_commit();
    }
    tile_store<FP>(acc, parts + (size_t)(first + k) * hb_blk, f);
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(NT) items_f1(
    const float* __restrict__ pool, const float* __restrict__ hb,
    const int* __restrict__ ip, const int* __restrict__ src,
    const int* __restrict__ num_items, float* __restrict__ parts,
    int w_total) {
  __shared__ __align__(16) float red[NT / 32 * BS];
  const int first = blockIdx.x * GROUP;
  const int last = min(min(first + GROUP, w_total), *num_items);
  for (int w = first; w < last; ++w) {
    const float* a = pool + (size_t)ip[w] * BS * BS;
    const float* b = hb + (size_t)src[w] * BS;
    if (TRANS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      f1_trans_item(a, b, acc);
      f1_trans_store(acc, red, parts + (size_t)w * BS);
    } else {
      float acc[16];
#pragma unroll
      for (int mm = 0; mm < 16; ++mm) acc[mm] = 0.f;
      f1_fwd_item(a, b, acc);
      f1_fwd_store(acc, parts + (size_t)w * BS);
    }
  }
}

// Pass 2: out[r] = sum of parts[row_ptr[r] .. row_ptr[r+1]) in item order.
__global__ void __launch_bounds__(NT) rows_sum(
    const float* __restrict__ parts, const int* __restrict__ row_ptr,
    float* __restrict__ out, int f) {
  const int r = blockIdx.x;
  const int start = row_ptr[r], end = row_ptr[r + 1];
  const int len = BS * f;
  float* dst = out + (size_t)r * len;
  for (int e = threadIdx.x; e < len; e += NT) {
    float s = 0.f;
    for (int w = start; w < end; ++w) s += parts[(size_t)w * len + e];
    dst[e] = s;
  }
}

template <int FP, bool TRANS>
cudaError_t launch_items(const float* pool, const float* hb, const int* ip,
                         const int* src, const int* num_items, float* parts,
                         int w, int f, cudaStream_t stream) {
  constexpr int STAGES = FP <= 64 ? 2 : 1;
  const size_t smem = (size_t)STAGES * TileShape<FP>::STAGE * sizeof(float);
  static cudaError_t attr = allow_smem(items_tile<FP, TRANS, STAGES>, smem);
  if (attr != cudaSuccess) return attr;
  const int groups = (w + GROUP - 1) / GROUP;
  items_tile<FP, TRANS, STAGES><<<groups, NT, smem, stream>>>(
      pool, hb, ip, src, num_items, parts, w, f);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t dispatch(const float* pool, const float* hb, const int* ip,
                     const int* src, const int* num_items, float* parts, int w,
                     int f, cudaStream_t stream) {
  if (f == 1) {
    const int groups = (w + GROUP - 1) / GROUP;
    items_f1<TRANS><<<groups, NT, 0, stream>>>(pool, hb, ip, src, num_items,
                                               parts, w);
    return cudaGetLastError();
  }
  if (f <= 32)
    return launch_items<32, TRANS>(pool, hb, ip, src, num_items, parts, w, f, stream);
  if (f <= 64)
    return launch_items<64, TRANS>(pool, hb, ip, src, num_items, parts, w, f, stream);
  return launch_items<128, TRANS>(pool, hb, ip, src, num_items, parts, w, f, stream);
}

}  // namespace

// out [nb, 128, f] = item-parallel propagation (see the header). ip, src
// [w] int32 item lists in segment order; num_items a device int32 (the
// real item count); row_ptr [nb+1] int32 over the segment ids; parts a
// [w, 128, f] fp32 scratch.
extern "C" int block_resident_f32(const float* pool, const float* hb,
                                  const int* ip, const int* src,
                                  const int* num_items, const int* row_ptr,
                                  float* parts, float* out, int nb, int w,
                                  int f, int transpose, void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (f < 1 || f > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > 0) {
    const cudaError_t e =
        transpose ? dispatch<true>(pool, hb, ip, src, num_items, parts, w, f, s)
                  : dispatch<false>(pool, hb, ip, src, num_items, parts, w, f, s);
    if (e != cudaSuccess) return e;
  }
  rows_sum<<<nb, NT, 0, s>>>(parts, row_ptr, out, f);
  return cudaGetLastError();
}

extern "C" const char* block_resident_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
