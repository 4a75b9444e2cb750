// Device building blocks shared by the two block-propagation kernels
// (block_csr.cu, block_resident.cu): staging one work item's operands in
// shared memory, the 128 x F product of one item, and the F = 1 forms.
//
// One work item is   part = A @ B        (forward)
//                    part = A^T @ B      (transpose)
// with A = pool[ip] a 128 x 128 fp32 adjacency block (row-major) and B a
// 128 x f block-row of node features (row-major, f <= 128).
//
// Thread layout of the tile path (256 threads, f in 2..128, compiled for
// a padded width FP in {32, 64, 128}): thread t owns output rows
// ty*4 .. ty*4+3 (ty = t / 8) and columns tx*CN .. tx*CN+CN-1 (tx = t % 8,
// CN = FP / 8), an fp32 accumulator of 4 x CN in registers. Columns
// f..FP-1 are computed from whatever shared memory holds there and never
// stored: column c of the product depends on column c of B alone.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace blk {

constexpr int BS = 128;       // block size (rows and columns of A)
constexpr int NT = 256;       // threads of one block
constexpr int LDA = BS + 4;   // shared row stride of A: 16-byte aligned rows,
                              // and rows 4 apart fall in distinct banks

template <int FP>
struct TileShape {
  static constexpr int CN = FP / 8;                  // columns per thread
  static constexpr int A_FLOATS = BS * LDA;          // staged A
  static constexpr int B_FLOATS = BS * FP;           // staged B
  static constexpr int STAGE = A_FLOATS + B_FLOATS;  // one buffer, floats
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the asynchronous copies of one item's A (128 x 128) and B
// (128 x f) into one stage buffer. The caller commits and waits.
template <int FP>
__device__ __forceinline__ void stage_load(float* stage,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int f) {
  float* sA = stage;
  float* sB = stage + TileShape<FP>::A_FLOATS;
  for (int e = threadIdx.x; e < BS * BS / 4; e += NT) {
    const int r = e >> 5, c4 = e & 31;  // 32 chunks of 16 bytes per row
    cp_async16(sA + r * LDA + c4 * 4, a + r * BS + c4 * 4);
  }
  if ((f & 3) == 0) {  // B rows are 16-byte aligned: b starts at a
                       // multiple of 128 * f floats
    const int q = f >> 2;
    for (int e = threadIdx.x; e < BS * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      cp_async16(sB + r * FP + c4 * 4, b + r * f + c4 * 4);
    }
  } else {
    for (int e = threadIdx.x; e < BS * f; e += NT) {
      const int r = e / f, c = e - r * f;
      cp_async4(sB + r * FP + c, b + e);
    }
  }
}

template <int FP>
__device__ __forceinline__ void tile_zero(float (&acc)[4][FP / 8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < FP / 8; ++c) acc[m][c] = 0.f;
}

// acc += A @ B (or A^T @ B) over the staged item. k runs 0..127 in
// order, so a thread's sums are taken in a fixed order.
template <int FP, bool TRANS>
__device__ __forceinline__ void tile_mac(const float* stage,
                                         float (&acc)[4][FP / 8]) {
  constexpr int CN = FP / 8;
  const float* sA = stage;
  const float* sB = stage + TileShape<FP>::A_FLOATS;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int row0 = ty * 4;
#pragma unroll 2
  for (int k0 = 0; k0 < BS; k0 += 4) {
    float a[4][4];  // [output row m][k0 + kk]
    if (TRANS) {
      // A^T[row0 + m][k] = A[k][row0 + m]: row k of A, 4 columns at once
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v =
            *reinterpret_cast<const float4*>(sA + (k0 + kk) * LDA + row0);
        a[0][kk] = v.x; a[1][kk] = v.y; a[2][kk] = v.z; a[3][kk] = v.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 v =
            *reinterpret_cast<const float4*>(sA + (row0 + m) * LDA + k0);
        a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[CN];
#pragma unroll
      for (int c = 0; c < CN; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            sB + (k0 + kk) * FP + tx * CN + c);
        b[c] = v.x; b[c + 1] = v.y; b[c + 2] = v.z; b[c + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[m][c] = fmaf(a[m][kk], b[c], acc[m][c]);
    }
  }
}

// Write the thread's 4 x CN accumulator into dst, a [128, f] row-major
// tile; columns >= f are dropped.
template <int FP>
__device__ __forceinline__ void tile_store(const float (&acc)[4][FP / 8],
                                           float* __restrict__ dst, int f) {
  constexpr int CN = FP / 8;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int c0 = tx * CN;
  if (f == FP) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < CN; c += 4)
        *reinterpret_cast<float4*>(dst + (size_t)(ty * 4 + m) * f + c0 + c) =
            make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        if (c0 + c < f) dst[(size_t)(ty * 4 + m) * f + c0 + c] = acc[m][c];
  }
}

// ---- F = 1: a matrix-vector product per item, no shared-memory staging
// (each element of A is used once). 8 warps; A is read straight from
// global memory, 16 bytes per lane, one 512-byte row per warp load.

// Sum over the warp by an xor butterfly: every lane ends with the same
// bits (each step adds the same two values in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward: warp w owns rows w*16 .. w*16+15; acc[mm] (the same in every
// lane) += A[w*16+mm, :] . b.
__device__ __forceinline__ void f1_fwd_item(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float (&acc)[16]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float4 bv = *reinterpret_cast<const float4*>(b + lane * 4);
  float4 av[16];
#pragma unroll
  for (int mm = 0; mm < 16; ++mm)
    av[mm] = *reinterpret_cast<const float4*>(a + (w * 16 + mm) * BS + lane * 4);
#pragma unroll
  for (int mm = 0; mm < 16; ++mm) {
    float v = av[mm].x * bv.x;
    v = fmaf(av[mm].y, bv.y, v);
    v = fmaf(av[mm].z, bv.z, v);
    v = fmaf(av[mm].w, bv.w, v);
    acc[mm] += warp_sum(v);
  }
}

__device__ __forceinline__ void f1_fwd_store(const float (&acc)[16],
                                             float* __restrict__ dst) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float v = 0.f;
#pragma unroll
  for (int mm = 0; mm < 16; ++mm)
    if (lane == mm) v = acc[mm];
  if (lane < 16) dst[w * 16 + lane] = v;
}

// Transpose: out[j] = sum_i A[i, j] g[i]. Warp w takes rows
// i = w*16 .. w*16+15, lane holds columns lane*4 .. lane*4+3.
__device__ __forceinline__ void f1_trans_item(const float* __restrict__ a,
                                              const float* __restrict__ g,
                                              float4& acc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float4 gv = *reinterpret_cast<const float4*>(g + lane * 4);
  float4 av[16];
#pragma unroll
  for (int mm = 0; mm < 16; ++mm)
    av[mm] = *reinterpret_cast<const float4*>(a + (w * 16 + mm) * BS + lane * 4);
#pragma unroll
  for (int mm = 0; mm < 16; ++mm) {
    // g[i] for i = w*16 + mm lives in lane i/4, component i%4 = mm%4
    const float comp = (mm & 3) == 0 ? gv.x : (mm & 3) == 1 ? gv.y
                     : (mm & 3) == 2 ? gv.z : gv.w;
    const float gi = __shfl_sync(0xffffffffu, comp, w * 4 + (mm >> 2));
    acc.x = fmaf(av[mm].x, gi, acc.x);
    acc.y = fmaf(av[mm].y, gi, acc.y);
    acc.z = fmaf(av[mm].z, gi, acc.z);
    acc.w = fmaf(av[mm].w, gi, acc.w);
  }
}

// Sum the 8 warps' partial columns in warp order (fixed, deterministic)
// through `red` (8 x 128 floats of shared memory) and write 128 values.
__device__ __forceinline__ void f1_trans_store(const float4& acc, float* red,
                                               float* __restrict__ dst) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  *reinterpret_cast<float4*>(red + w * BS + lane * 4) = acc;
  __syncthreads();
  if (threadIdx.x < BS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NT / 32; ++q) s += red[q * BS + threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// Dynamic shared memory above 48 KB needs the attribute set once per
// kernel instantiation.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace blk
