// Cost-split probe of the block-COO SpMM — CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernel variants of tools/probe_kernel_anatomy.py
// (pallas_call at :199). Each variant removes one cost from a design; a
// variant that computes a wrong result still runs the same instructions
// otherwise. dgcnn_tpu_torch/tools/probe_kernel_anatomy.py times them.
//
// The A-build design (the TPU kernel's, and the port's first version of
// spmm_block_coo.cu, moved here unchanged as mode AB_FULL). Contract:
//
//   for each output block-row r < nb, items j in [row_ptr[r], row_ptr[r+1]):
//     A_j[d, s] = sum_{slots q, in order} w[j, q] * 1[ld[j, q] = d] * 1[ls[j, q] = s]
//     out[r*128 : r*128+128, :] = sum_j A_j @ h[item_c[j]*128 : +128, :]
//   h [nb*128, f] fp32, out [nb*128, f] fp32, f = 1..128 (the wrapper splits
//   wider h into column chunks); ls, ld int32 and w fp32 [W, eb], eb slots
//   per item (256 on the path).
//
// One block of 256 threads per output block-row r walks its item run, as
// csr_tile in block_csr.cu does. Per item:
//   - h[c] (128 x f) is copied into shared memory with cp.async, while
//   - the item's slots (ls, ld, w) are loaded into shared memory, A
//     (128 x 132 floats, 66 KB) is zeroed, and thread d < 128 builds row d
//     of A by scanning the slots in slot order and adding w into
//     A[d, ls] where ld = d (duplicate pairs add in slot order, with no
//     shared-memory atomics);
//   - A @ h[c] accumulates in registers with block_tile.cuh's tile product
//     (widths 2..128 compiled for 32/64/128 columns), and the 128 x f tile
//     is written once. f = 1 has its own path: thread d adds the dot of
//     A's row d with h[c], in k order.
// Its work is 2 * 128 * 128 * f operations and a 256-slot scan per row of
// A for every item, against 2 * 256 * f that the item's slots need.
//
// Modes of the A-build design: AB_FULL computes the function; AB_NO_AH
// builds A and skips the product (A's first f columns are added into the
// accumulator instead, so the build is not dead code); AB_NO_ABUILD
// leaves A as zeroed once before the walk and keeps the staging of h and
// the product. The slot-walk design (spmm_slots.cuh, the kernel of
// spmm_block_coo.cu) has its modes FULL, NO_FMA and EMPTY there.
//
// Every entry returns cudaGetLastError() of its launch.

#include "block_tile.cuh"
#include "spmm_slots.cuh"

namespace {

using namespace blk;

enum AbMode { AB_FULL = 0, AB_NO_AH = 1, AB_NO_ABUILD = 2 };

// cp.async copies of the 128 x f rows at `b` into sB (row stride
// TileShape<FP>::LDB, the stride tile_mac reads).
template <int FP>
__device__ __forceinline__ void stage_h(float* sB, const float* __restrict__ b,
                                        int f) {
  if ((f & 3) == 0) {
    const int q = f >> 2;
    for (int e = threadIdx.x; e < BS * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      cp_async16(sB + r * TileShape<FP>::LDB + c4 * 4, b + r * f + c4 * 4);
    }
  } else {
    for (int e = threadIdx.x; e < BS * f; e += NT) {
      const int r = e / f, c = e - r * f;
      cp_async4(sB + r * TileShape<FP>::LDB + c, b + e);
    }
  }
}

// Load item j's slots, zero A, then (after the barrier inside) build A:
// thread d < 128 owns row d and scans the slots in slot order, adding w
// into A[d, ls] where ld = d. Eight slots' (ld, ls, w) are read as
// vectors before their eight updates, so the reads do not wait behind
// the updates' shared-memory stores.
__device__ __forceinline__ void build_a(float* sA, int* sls, int* sld,
                                        float* sw, const int* __restrict__ ls,
                                        const int* __restrict__ ld,
                                        const float* __restrict__ w, int j,
                                        int eb) {
  const size_t off = (size_t)j * eb;
  for (int q = threadIdx.x; q < eb; q += NT) {
    sls[q] = ls[off + q];
    sld[q] = ld[off + q];
    sw[q] = w[off + q];
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < BS * LDA / 4; e += NT)
    reinterpret_cast<float4*>(sA)[e] = zero;
  __syncthreads();
  if (threadIdx.x < BS) {
    const int d = threadIdx.x;
    float* row = sA + d * LDA;
    const int4* ld4 = reinterpret_cast<const int4*>(sld);
    const int4* ls4 = reinterpret_cast<const int4*>(sls);
    const float4* w4 = reinterpret_cast<const float4*>(sw);
    for (int q = 0; q < eb / 4; q += 2) {
      const int4 da = ld4[q], db = ld4[q + 1];
      const int4 sa = ls4[q], sb = ls4[q + 1];
      const float4 wa = w4[q], wb = w4[q + 1];
      if (da.x == d) row[sa.x] += wa.x;
      if (da.y == d) row[sa.y] += wa.y;
      if (da.z == d) row[sa.z] += wa.z;
      if (da.w == d) row[sa.w] += wa.w;
      if (db.x == d) row[sb.x] += wb.x;
      if (db.y == d) row[sb.y] += wb.y;
      if (db.z == d) row[sb.z] += wb.z;
      if (db.w == d) row[sb.w] += wb.w;
    }
  }
}

__device__ __forceinline__ void zero_a(float* sA) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < BS * LDA / 4; e += NT)
    reinterpret_cast<float4*>(sA)[e] = zero;
}

template <int FP, int MODE>
__global__ void __launch_bounds__(NT, 1) bcoo_tile(
    const int* __restrict__ row_ptr, const int* __restrict__ item_c,
    const int* __restrict__ ls, const int* __restrict__ ld,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int f, int eb) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem + TileShape<FP>::A_FLOATS;
  int* sls = reinterpret_cast<int*>(sB + TileShape<FP>::B_FLOATS);
  int* sld = sls + eb;
  float* sw = reinterpret_cast<float*>(sld + eb);
  const int r = blockIdx.x;
  const int start = row_ptr[r], n = row_ptr[r + 1] - start;
  const size_t hb_blk = (size_t)BS * f;

  float acc[4][FP / 8];
  tile_zero<FP>(acc);
  if (MODE == AB_NO_ABUILD) {
    zero_a(smem);
    __syncthreads();
  }
  for (int k = 0; k < n; ++k) {
    const int j = start + k;
    stage_h<FP>(sB, h + item_c[j] * hb_blk, f);
    cp_async_commit();
    if (MODE != AB_NO_ABUILD) build_a(smem, sls, sld, sw, ls, ld, w, j, eb);
    cp_async_wait<0>();
    __syncthreads();
    if (MODE == AB_NO_AH) {
      constexpr int CN = FP / 8;
      const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < CN; ++c)
          acc[m][c] += smem[(ty * 4 + m) * LDA + tx * CN + c];
    } else {
      tile_mac<FP, false>(smem, acc);
    }
    __syncthreads();
  }
  tile_store<FP>(acc, out + (size_t)r * hb_blk, f);
}

template <int MODE>
__global__ void __launch_bounds__(NT, 1) bcoo_f1(
    const int* __restrict__ row_ptr, const int* __restrict__ item_c,
    const int* __restrict__ ls, const int* __restrict__ ld,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int eb) {
  extern __shared__ __align__(16) float smem[];
  float* hc = smem + BS * LDA;
  int* sls = reinterpret_cast<int*>(hc + BS);
  int* sld = sls + eb;
  float* sw = reinterpret_cast<float*>(sld + eb);
  const int r = blockIdx.x;
  const int start = row_ptr[r], n = row_ptr[r + 1] - start;
  float acc = 0.f;
  if (MODE == AB_NO_ABUILD) {
    zero_a(smem);
    __syncthreads();
  }
  for (int k = 0; k < n; ++k) {
    const int j = start + k;
    if (threadIdx.x < BS) hc[threadIdx.x] = h[(size_t)item_c[j] * BS + threadIdx.x];
    if (MODE != AB_NO_ABUILD) build_a(smem, sls, sld, sw, ls, ld, w, j, eb);
    __syncthreads();
    if (threadIdx.x < BS) {
      const float* row = smem + threadIdx.x * LDA;
      if (MODE == AB_NO_AH)
        acc += row[0];
      else
        for (int q = 0; q < BS; ++q) acc = fmaf(row[q], hc[q], acc);
    }
    __syncthreads();
  }
  if (threadIdx.x < BS) out[(size_t)r * BS + threadIdx.x] = acc;
}

size_t slot_bytes(int eb) { return (size_t)eb * 3 * 4; }

// Raise a kernel's dynamic shared-memory limit when a launch needs more
// than it was last given (the slot count sets part of the size).
template <typename K>
cudaError_t ensure_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

template <int FP, int MODE>
cudaError_t launch_tile(const int* row_ptr, const int* item_c, const int* ls,
                        const int* ld, const float* w, const float* h,
                        float* out, int nb, int f, int eb, cudaStream_t s) {
  const size_t smem = TileShape<FP>::STAGE * sizeof(float) + slot_bytes(eb);
  static size_t granted = 48 * 1024;
  const cudaError_t attr = ensure_smem(bcoo_tile<FP, MODE>, smem, granted);
  if (attr != cudaSuccess) return attr;
  bcoo_tile<FP, MODE><<<nb, NT, smem, s>>>(row_ptr, item_c, ls, ld, w, h, out, f, eb);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_abuild(const int* row_ptr, const int* item_c, const int* ls,
                          const int* ld, const float* w, const float* h,
                          float* out, int nb, int f, int eb, cudaStream_t s) {
  if (f == 1) {
    const size_t smem = (size_t)(BS * LDA + BS) * sizeof(float) + slot_bytes(eb);
    static size_t granted = 48 * 1024;
    const cudaError_t attr = ensure_smem(bcoo_f1<MODE>, smem, granted);
    if (attr != cudaSuccess) return attr;
    bcoo_f1<MODE><<<nb, NT, smem, s>>>(row_ptr, item_c, ls, ld, w, h, out, eb);
    return cudaGetLastError();
  }
  if (f <= 32) return launch_tile<32, MODE>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
  if (f <= 64) return launch_tile<64, MODE>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
  return launch_tile<128, MODE>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
}

}  // namespace

// The A-build design, mode 0 (the function), 1 (no A @ h) or 2 (no A
// build): out [nb*128, f] (f <= 128).
extern "C" int probe_abuild_f32(int mode, const int* row_ptr, const int* item_c,
                                const int* ls, const int* ld, const float* w,
                                const float* h, float* out, int nb, int f,
                                int eb, void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (f < 1 || f > 128 || eb < 8 || (eb & 7)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case AB_FULL: return launch_abuild<AB_FULL>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
    case AB_NO_AH: return launch_abuild<AB_NO_AH>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
    case AB_NO_ABUILD:
      return launch_abuild<AB_NO_ABUILD>(row_ptr, item_c, ls, ld, w, h, out, nb, f, eb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The slot-walk design, mode 0 (the function, as spmm_block_coo.cu), 1 (no
// multiply-add) or 2 (row pointers and the output write only).
extern "C" int probe_direct_f32(int mode, const int* row_ptr, const int* perm,
                                const int* item_c, const int* ls, const float* w,
                                const float* h, float* out, int n_rows, int f,
                                int eb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case slots::FULL:
      return slots::launch_slots<slots::FULL>(row_ptr, perm, item_c, ls, w, h, out, n_rows, f, eb, s);
    case slots::NO_FMA:
      return slots::launch_slots<slots::NO_FMA>(row_ptr, perm, item_c, ls, w, h, out, n_rows, f, eb, s);
    case slots::EMPTY:
      return slots::launch_slots<slots::EMPTY>(row_ptr, perm, item_c, ls, w, h, out, n_rows, f, eb, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
