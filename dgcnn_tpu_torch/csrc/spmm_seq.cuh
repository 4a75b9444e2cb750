// Device pieces shared by the two edge-stream SpMM kernels (spmm_rows.cu,
// spmm_edge_block.cu): the sequential sum over one run of an ordered edge
// stream.
//
// The stream is an ordering of the edges: position p holds edge
// e = perm[p] (e = p when perm is null), and the positions of one output
// row are contiguous. One run's sum is
//
//   dst[c] = sum_{p in [p0, p1), in order} w[e] * h[col[e], c]    c < f
//
// taken by a group of G threads (G = 32: a warp, lanes over columns; G = 1:
// one thread over all columns). Every sum is taken in position order, so
// a result has the same bits on every run.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace spmm {

constexpr int NT = 256;  // threads of one block

template <int G>
__device__ __forceinline__ void run_sum(const int* __restrict__ perm,
                                        const int* __restrict__ col,
                                        const float* __restrict__ w,
                                        const float* __restrict__ h, int p0,
                                        int p1, int f, int lane,
                                        float* __restrict__ dst) {
  for (int c = lane; c < f; c += G) {
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      const int e = perm ? perm[p] : p;
      acc = fmaf(w[e], h[(size_t)col[e] * f + c], acc);
    }
    dst[c] = acc;
  }
}

}  // namespace spmm
