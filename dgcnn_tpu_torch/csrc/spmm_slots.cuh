// The block-COO SpMM walked slot by slot: the kernel of spmm_block_coo.cu,
// shared with the cost-split probe (spmm_block_coo_probe.cu), which also
// builds it with parts of the work removed.
//
// Inputs: one orientation of a block-pair structure, item_c [W] and
// ls [W, eb] (slot q = j * eb + s of item j holds source row
// item_c[j] * 128 + ls[q] and weight w[q]), and a slot order over it:
//
//   out[i, :] = sum_{p in [row_ptr[i], row_ptr[i+1]), in order}
//               w[q] * h[item_c[q / eb] * 128 + ls[q], :],   q = perm[p]
//
// for every row i < n_rows. kernels/spmm_block_coo.py builds the order
// once per batch (`block_coo_order`): the slots sorted stably by
// destination row (item row * 128 + ld), so a row's slots come in item
// order and, within an item, in slot order; null slots and items outside
// every row run fall past row_ptr[n_rows] and are never read.
//
// A warp owns a row (f >= 2; lane l holds columns c0 + l + 32k, k < KC),
// a thread owns a row at f = 1. Per 32 positions of its run the warp's
// lanes load one slot each (perm, then item_c, ls and w side by side),
// then broadcast them in position order; every h row is one coalesced
// read. The sum is taken in position order and the row written once:
// rows with no slot come out exactly 0, no atomics, the same bits on
// every run.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace slots {

constexpr int BS = 128;  // rows of a block
constexpr int NT = 256;  // threads of one block

// FULL computes the function. The probe's variants: NO_FMA does the walk
// and every load but folds the loaded bits with an xor instead of the
// multiply-add; EMPTY reads each row's range and writes zeros (launch,
// row pointers and the output write: the floor).
enum Mode { FULL = 0, NO_FMA = 1, EMPTY = 2 };

template <int KC, int MODE>
__global__ void __launch_bounds__(NT) slots_warp(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ item_c, const int* __restrict__ ls,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int n_rows, int f, int eb) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp: one row per warp
  const int lane = threadIdx.x & 31;
  const int p0 = row_ptr[row], p1 = row_ptr[row + 1];
  float* dst = out + (size_t)row * f;
  for (int c0 = 0; c0 < f; c0 += 32 * KC) {
    float acc[KC];
    unsigned bits[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      acc[k] = 0.f;
      bits[k] = 0u;
    }
    if (MODE == EMPTY) {
      if (p1 < p0) acc[0] = 1.f;  // never true: keeps the range's reads
    } else {
      for (int pb = p0; pb < p1; pb += 32) {
        int src = 0;
        float ws = 0.f;
        if (pb + lane < p1) {
          const int q = perm[pb + lane];
          src = item_c[q / eb] * BS + ls[q];
          ws = w[q];
        }
        const int m = min(32, p1 - pb);
#pragma unroll 4
        for (int s = 0; s < m; ++s) {
          const int sr = __shfl_sync(0xffffffffu, src, s);
          const float wv = __shfl_sync(0xffffffffu, ws, s);
          const float* hr = h + (size_t)sr * f + c0 + lane;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            if (c0 + lane + 32 * k < f) {
              const float hv = __ldg(hr + 32 * k);
              if (MODE == FULL)
                acc[k] = fmaf(wv, hv, acc[k]);
              else
                bits[k] ^= __float_as_uint(hv) ^ __float_as_uint(wv);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < f) dst[c] = MODE == NO_FMA ? __uint_as_float(bits[k]) : acc[k];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NT) slots_thread(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ item_c, const int* __restrict__ ls,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int n_rows, int eb) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= n_rows) return;
  float acc = 0.f;
  unsigned bits = 0u;
  const int p0 = row_ptr[row], p1 = row_ptr[row + 1];
  if (MODE == EMPTY) {
    if (p1 < p0) acc = 1.f;  // never true: keeps the range's reads
  } else {
    for (int p = p0; p < p1; ++p) {
      const int q = perm[p];
      const float hv = __ldg(h + item_c[q / eb] * BS + ls[q]);
      if (MODE == FULL)
        acc = fmaf(w[q], hv, acc);
      else
        bits ^= __float_as_uint(hv) ^ __float_as_uint(w[q]);
    }
  }
  out[row] = MODE == NO_FMA ? __uint_as_float(bits) : acc;
}

// One launch over n_rows rows of width f >= 1; returns cudaGetLastError().
template <int MODE>
cudaError_t launch_slots(const int* row_ptr, const int* perm,
                         const int* item_c, const int* ls, const float* w,
                         const float* h, float* out, int n_rows, int f, int eb,
                         cudaStream_t s) {
  if (n_rows <= 0) return cudaSuccess;
  if (f < 1 || eb < 1) return cudaErrorInvalidValue;
  constexpr int per = NT / 32;
  const int warp_blocks = (n_rows + per - 1) / per;
  if (f == 1)
    slots_thread<MODE><<<(n_rows + NT - 1) / NT, NT, 0, s>>>(
        row_ptr, perm, item_c, ls, w, h, out, n_rows, eb);
  else if (f <= 32)
    slots_warp<1, MODE><<<warp_blocks, NT, 0, s>>>(row_ptr, perm, item_c, ls,
                                                   w, h, out, n_rows, f, eb);
  else if (f <= 64)
    slots_warp<2, MODE><<<warp_blocks, NT, 0, s>>>(row_ptr, perm, item_c, ls,
                                                   w, h, out, n_rows, f, eb);
  else
    slots_warp<4, MODE><<<warp_blocks, NT, 0, s>>>(row_ptr, perm, item_c, ls,
                                                   w, h, out, n_rows, f, eb);
  return cudaGetLastError();
}

}  // namespace slots
