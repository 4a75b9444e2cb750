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
// rT = min(item_row[permT], nb-1), segments item_colT). No cotangent is
// formed for pool.
//
// What bounds it on the H100: the same bytes and operations as
// block_csr.cu (50.5 MB and 15.1 us at DD's mean step, 575 items, F =
// 32: bound by bytes), plus 2*segments*bs*F*4 bytes of partials through
// L2 (~0.5 MB at F = 32 and G = 2).
//
// Design. The TPU kernel walked fixed groups of 8 consecutive work items
// with hb and the output resident in VMEM, adding each product into its
// destination row. On Hopper the blocks run in parallel and in no order,
// so adding into a shared output would need float atomics, whose order
// changes from run to run. The port keeps the item-parallel cut (fixed
// groups of G consecutive items, cut without regard to row boundaries)
// and sums in two deterministic passes:
//   1. items: one block per group of G = 2 items (kernels/
//      block_resident.py GROUP; 288 busy blocks at DD's mean batch, two
//      per SM). Consecutive items of the same row accumulate in the
//      block's registers, and the group writes one partial per (group,
//      row segment) into parts[w], w the segment's first item (a segment
//      begins at every group start and every row change);
//   2. rows: one block per destination row r sums its segments in group
//      order, parts[row_ptr[r]] and then parts[j*G] for each group start
//      row_ptr[r] < j*G < row_ptr[r+1], and writes the row once (zeros
//      when empty). row_ptr [nb+1] (kernels/block_prop.py plan_groups,
//      once per batch and direction) is the whole table.
// Groups whose first item is at or past num_items return at once; the
// kernel reads num_items from device memory, so the host never waits
// for it. Of the scratch's W slots only the segments' are written and
// read: at most ceil(W / G) + nb partials, where the earlier design wrote
// one per item. hb is not resident in shared memory as it was in VMEM:
// at DD's size it is 2.2 MB at F = 32, far over 227 KB. It is read
// through the 50 MB L2. The product, its copy pipeline and its shared
// memory are block_csr.cu's (block_tile.cuh: 3xTF32 mma, half-item
// chunks in two stages, 88 kB and two blocks per SM at F <= 32).
//
// Tried on the card and dropped (chip_smoke.py phase 5, the DD mean batch,
// F = 32, forward / backward ms warm; NVIDIA H100 80GB HBM3, 700 W; the
// kept design in the same run: 0.0348 / 0.0339):
//   - groups of 8, whole items double buffered (one block per SM), fp32
//     FMA tile: the earlier group size, stages and tile, 0.0489 / 0.0457;
//   - groups of 4: 0.0365 / 0.0356;
//   - whole items in one or two stages, quarter items in four: 0.0368 /
//     0.0369, 0.0410 / 0.0412 and 0.0371 / 0.0367;
//   - the fp32 FMA tile: 0.0408 / 0.0407;
//   - numbering the partials densely, by a per-item count of the
//     segments before it ([W+1], 17 torch ops per plan): the step ran 158
//     launches against 153 with the row pointers alone.
//
// The bf16 mode (block_resident_bf16, for a bf16 pool and bf16 hb; the
// partials and the output stay fp32) runs the same two passes over
// block_tile.cuh's bf16 ring and its one-mma product, as the TPU kernel
// stages blocks and hb at their storage dtype (block_resident.py:72-80,
// :193-198).
//
// Every entry returns cudaGetLastError() of its launches; the wrapper
// checks shapes, types and contiguity before calling.

#include "block_tile.cuh"

namespace {

using namespace blk;

struct Groups {
  const int* ip;
  const int* src;
  const int* seg;        // [W] destination row of each item (this direction)
  const int* num_items;  // device int32: the real item count
  int w;
  int g;                 // items per group
};

template <int FP, bool TRANS, typename T>
__global__ void __launch_bounds__(NT, ring_blocks<FP, T>())
    items_tile(const T* __restrict__ pool, const T* __restrict__ hb,
               Groups gr, float* __restrict__ parts, int f) {
  extern __shared__ __align__(16) float smem[];
  const int first = blockIdx.x * gr.g;
  const int last = min(min(first + gr.g, gr.w), *gr.num_items);
  const int n = last - first;
  if (n <= 0) return;
  const size_t len = (size_t)BS * f;
  int slot = first;  // a segment's partial goes to its first item's slot
  const int* seg = gr.seg + first;

  float acc[4][FP / 8];
  tile_zero<FP>(acc);
  walk_items<FP, TRANS>(
      reinterpret_cast<T*>(smem), pool, hb, gr.ip, gr.src, first, n, f, acc,
      [&](int k, float(&a)[4][FP / 8]) {
        if (k > 0 && seg[k] != seg[k - 1]) {  // the row changes: one segment ends
          mma3_store<FP>(a, parts + slot * len, f);
          slot = first + k;
          tile_zero<FP>(a);
        }
      });
  mma3_store<FP>(acc, parts + slot * len, f);
}

template <bool TRANS, typename T>
__global__ void __launch_bounds__(NT) items_f1(const T* __restrict__ pool,
                                               const T* __restrict__ hb,
                                               Groups gr,
                                               float* __restrict__ parts) {
  __shared__ __align__(16) float red[NT / 32 * BS];
  const int first = blockIdx.x * gr.g;
  const int last = min(min(first + gr.g, gr.w), *gr.num_items);
  if (last <= first) return;
  int slot = first;
  float4 tacc = make_float4(0.f, 0.f, 0.f, 0.f);
  float facc[16];
#pragma unroll
  for (int mm = 0; mm < 16; ++mm) facc[mm] = 0.f;
  for (int w = first; w < last; ++w) {
    const T* a = pool + (size_t)gr.ip[w] * BS * BS;
    const T* b = hb + (size_t)gr.src[w] * BS;
    if (TRANS) {
      f1_trans_item(a, b, tacc);
    } else {
      f1_fwd_item(a, b, facc);
    }
    if (w + 1 == last || gr.seg[w + 1] != gr.seg[w]) {  // the segment ends
      float* dst = parts + (size_t)slot * BS;
      if (TRANS) {
        f1_trans_store(tacc, red, dst);
        tacc = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        f1_fwd_store(facc, dst);
#pragma unroll
        for (int mm = 0; mm < 16; ++mm) facc[mm] = 0.f;
      }
      slot = w + 1;
    }
  }
}

// Pass 2: out[r] = parts[start] + parts[j*g] + ... over the group starts
// start < j*g < end of row r's items [start, end), in that order (zeros
// for a row with no item).
__global__ void __launch_bounds__(NT) rows_sum(const float* __restrict__ parts,
                                               const int* __restrict__ row_ptr,
                                               float* __restrict__ out, int g,
                                               int f) {
  const int r = blockIdx.x;
  const int start = row_ptr[r], end = row_ptr[r + 1];
  const int len4 = BS * f / 4;
  const float4* p = reinterpret_cast<const float4*>(parts);
  for (int e = threadIdx.x; e < len4; e += NT) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (start < end) {
      s = p[(size_t)start * len4 + e];
      for (int j = (start / g + 1) * g; j < end; j += g) {
        const float4 v = p[(size_t)j * len4 + e];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    }
    reinterpret_cast<float4*>(out + (size_t)r * BS * f)[e] = s;
  }
}

template <int FP, bool TRANS, typename T>
cudaError_t launch_items(const T* pool, const T* hb, const Groups& gr,
                         float* parts, int f, cudaStream_t stream) {
  constexpr size_t smem = ring_smem<FP, T>();
  static cudaError_t attr = allow_smem(items_tile<FP, TRANS, T>, smem);
  if (attr != cudaSuccess) return attr;
  const int groups = (gr.w + gr.g - 1) / gr.g;
  items_tile<FP, TRANS, T><<<groups, NT, smem, stream>>>(pool, hb, gr, parts, f);
  return cudaGetLastError();
}

template <bool TRANS, typename T>
cudaError_t dispatch(const T* pool, const T* hb, const Groups& gr,
                     float* parts, int f, cudaStream_t stream) {
  if (f == 1) {
    const int groups = (gr.w + gr.g - 1) / gr.g;
    items_f1<TRANS, T><<<groups, NT, 0, stream>>>(pool, hb, gr, parts);
    return cudaGetLastError();
  }
  if (f <= 32) return launch_items<32, TRANS>(pool, hb, gr, parts, f, stream);
  if (f <= 64) return launch_items<64, TRANS>(pool, hb, gr, parts, f, stream);
  return launch_items<128, TRANS>(pool, hb, gr, parts, f, stream);
}

template <typename T>
int run(const T* pool, const T* hb, const int* ip, const int* src,
        const int* seg, const int* row_ptr, const int* num_items, float* parts,
        float* out, int nb, int w, int group, int f, int transpose,
        void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (f < 1 || f > 128 || group < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > 0) {
    const Groups gr{ip, src, seg, num_items, w, group};
    const cudaError_t e = transpose
                              ? dispatch<true>(pool, hb, gr, parts, f, s)
                              : dispatch<false>(pool, hb, gr, parts, f, s);
    if (e != cudaSuccess) return e;
  }
  rows_sum<<<nb, NT, 0, s>>>(parts, row_ptr, out, group, f);
  return cudaGetLastError();
}

}  // namespace

// out [nb, 128, f] fp32 = item-parallel propagation (see the header). ip,
// src, seg [w] int32 item lists in segment order; row_ptr [nb+1] int32
// (the plan); num_items a device int32 (the real item count); parts a
// [w, 128, f] fp32 scratch. The `_f32` entry takes fp32 pool and hb, the
// `_bf16` entry bf16 ones.
extern "C" int block_resident_f32(const float* pool, const float* hb,
                                  const int* ip, const int* src, const int* seg,
                                  const int* row_ptr,
                                  const int* num_items, float* parts,
                                  float* out, int nb, int w, int group, int f,
                                  int transpose, void* stream) {
  return run(pool, hb, ip, src, seg, row_ptr, num_items, parts, out, nb, w,
             group, f, transpose, stream);
}

extern "C" int block_resident_bf16(const __nv_bfloat16* pool,
                                   const __nv_bfloat16* hb,
                                   const int* ip, const int* src,
                                   const int* seg, const int* row_ptr,
                                   const int* num_items, float* parts,
                                   float* out, int nb, int w, int group, int f,
                                   int transpose, void* stream) {
  return run(pool, hb, ip, src, seg, row_ptr, num_items, parts, out, nb, w,
             group, f, transpose, stream);
}

extern "C" const char* block_resident_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
