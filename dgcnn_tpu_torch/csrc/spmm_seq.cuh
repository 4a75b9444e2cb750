// Device pieces shared by the two edge-stream SpMM kernels (spmm_rows.cu,
// spmm_edge_block.cu): the design switch of their C entries; the lane
// groups, h-row loads and stores of their current designs; and the
// sequential sum over one run of an ordered edge stream that their earlier
// designs walk.
//
// The stream is an ordering of the edges: position p holds edge
// e = perm[p] (e = p when perm is null), and the positions of one output
// row are contiguous. One run's sum is
//
//   dst[c] = sum_{p in [p0, p1), in order} w[e] * h[col[e], c]    c < f
//
// taken by a group of G threads (G = 32: a warp, lanes over columns; G = 1:
// one thread over all columns). Every sum is taken in position order, so
// a result has the same bits on every run; the current designs keep that
// order, so they give these bits too.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace spmm {

constexpr int NT = 256;  // threads of one block

// `design` argument of the C entries: the design the package runs, or the
// earlier one, kept for chip_smoke.py's in-run comparison.
constexpr int DESIGN_CURRENT = 0;
constexpr int DESIGN_EARLIER = 1;

constexpr int K = 8;  // h-row loads a lane keeps in flight

// The lanes of the G-lane group (G divides 32) that holds this thread.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// V consecutive floats (V = 4: one 16-byte load from a 16-byte aligned p).
template <int V>
__device__ __forceinline__ void load_h(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

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
