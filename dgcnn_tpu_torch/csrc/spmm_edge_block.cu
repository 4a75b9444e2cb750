// Edge-block SpMM — CUDA kernels for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/spmm_pallas.py:spmm_pallas_mxu (pallas_call
// at :170; backward _mxu_bwd :201). The same function as spmm_rows.cu:
//
//   out[i, :] = sum_{p in [row_ptr[i], row_ptr[i+1]), in order}
//               w[e] * h[colp[p], :],   e = perm[p] (or p when perm is null)
//   row[e] = i for every such p;  colp[p] = col[e] (the column by position)
//
// The TPU kernel took a fixed block of 256 edges per grid step and ran
// gather and scatter as one-hot selector matmuls on the MXU (4 * N * f
// operations per edge, a trade for a chip with no gather). The GPU form
// of "a fixed block of 256 edges per program" is an edge-parallel
// segmented reduction: a block of 256 threads per 256 positions of the
// ordered stream, whatever the degrees, so that no row's sum in a block
// is longer than 256 edges.
//
// What bounds it on the H100: the bytes of spmm_rows.cu (utils/profiling.py
// spmm_bound: E * 8 + (n + 1) * 4 + R * f * 4 + n * f * 4), plus a scratch
// row per straddling row; DD's mean device-assembled batch is 0.0015 ms
// of bytes at f = 32. Latency sets the time: all blocks run at once, so
// the kernel takes about one block's chain of dependent steps. On an H100
// a form with a 256 x 32 shared tile of gathered h rows, a block-wide sum
// phase, block barriers around each arrival and empty rows found by search
// took 0.0141 ms at that batch, f = 32, its chain the cost (PERF.md, from
// tools/probe_spmm_anatomy.py). This design keeps the chain short:
//   1. each thread loads its position's (row, column, weight) into shared
//      memory (the column straight from colp, the row and weight through
//      perm), all issued before the stream's real length row_ptr[n_rows]
//      arrives; one barrier;
//   2. a run of equal row belongs to the warp that holds its first
//      position; the warp's runs go to its lane groups (G = 8 lanes with a
//      float4 each where f % 4 == 0 and h is 16-byte aligned, 32 lanes over
//      columns otherwise, one thread per run at f = 1), and a group walks
//      its run as the row kernel walks a row: K = 8 h-row loads in flight,
//      then acc = fmaf(w, h, acc) from 0 in position order;
//   3. the group writes the row, or, for a row that straddles a block
//      boundary, a partial: the tail slot of the block holding the row's
//      first position, the head slot of every later block. It then counts
//      its arrival on the row's int counter (its lanes fence their stores
//      first); the group that arrives last fences again, sums the partials
//      in block order (the first block's tail, then each later block's
//      head), writes the row and sets the counter back to 0 for the next
//      launch: the arrive_last order of block_tile.cuh, per lane group;
//   4. rows with no edge: each block zeroes those of its slice of the rows
//      (n_rows / grid rows each), so that padding rows are spread over the
//      grid, in coalesced stores that wait on nothing but the row pointers
//      (loaded beside the stream's own loads).
// Every row is written exactly once, with no float atomics, in an order
// fixed by the data: the same bits on every run, and the same bits as the
// earlier design (kept as DESIGN_EARLIER for the in-run comparison:
// a warp per run walking perm -> col -> h one edge at a time, and a second
// launch, a warp per row, for empty and straddling rows).
//
// Every entry returns cudaGetLastError() of its last launch.

#include <stdint.h>

#include "spmm_seq.cuh"

namespace {

using namespace spmm;

constexpr int EB = 256;  // positions per block (== NT)
static_assert(EB == NT, "one position per thread");

__device__ __forceinline__ int row_at(const int* perm, const int* row, int p) {
  return row[perm ? perm[p] : p];
}

// dst[0, f) = the sum over positions [q0, q1) of the block, in order, by
// the gl-th lane of a G-lane group (V columns a lane).
template <int G, int V>
__device__ __forceinline__ void walk_run(const int* scol, const float* sw,
                                         const float* __restrict__ h, int q0,
                                         int q1, int f, int gl, float* dst) {
  for (int c0 = 0; c0 < f; c0 += G * V) {
    const int c = c0 + gl * V;
    const bool on = c < f;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int qb = q0; qb < q1; qb += K) {
      float hv[K][V];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int q = qb + j;
        if (on && q < q1) {
          load_h<V>(hv[j], h + (size_t)scol[q] * f + c);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) hv[j][v] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (qb + j < q1) {
          const float wv = sw[qb + j];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(wv, hv[j][v], acc[v]);
        }
      }
    }
    if (on) store_v<V>(dst + c, acc);
  }
}

// A straddling row's arrival, after the group wrote its partial; the last
// of the row's blocks to arrive sums the partials in block order.
template <int G, int V>
__device__ __forceinline__ void arrive(const float* partial, float* out,
                                       int* counters, int rr, int span0,
                                       int span1, int f, int gl) {
  const unsigned mask = group_mask<G>();
  __threadfence();  // this lane's partial, before the arrival is counted
  __syncwarp(mask);
  int last = 0;
  if (gl == 0) {
    const int pieces = (span1 - 1) / EB - span0 / EB + 1;
    last = atomicAdd(counters + rr, 1) == pieces - 1;
    if (last) atomicExch(counters + rr, 0);
  }
  if (!__shfl_sync(mask, last, 0, G)) return;
  __threadfence();
  const int b0 = span0 / EB, b1 = (span1 - 1) / EB;
  for (int c = gl * V; c < f; c += G * V) {
    // __ldcg: other blocks wrote these partials; read them from L2
    float acc[V], x[V];
    const float* p = partial + (size_t)(2 * b0 + 1) * f + c;
    if constexpr (V == 4) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
      acc[0] = a.x, acc[1] = a.y, acc[2] = a.z, acc[3] = a.w;
    } else {
      acc[0] = __ldcg(p);
    }
    for (int bb = b0 + 1; bb <= b1; ++bb) {
      p = partial + (size_t)(2 * bb) * f + c;
      if constexpr (V == 4) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      } else {
        x[0] = __ldcg(p);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += x[v];
    }
    store_v<V>(out + (size_t)rr * f + c, acc);
  }
}

template <int G, int V>
__global__ void __launch_bounds__(NT) edge_block_runs(
    const int* __restrict__ row_ptr, const int* __restrict__ perm,
    const int* __restrict__ row, const int* __restrict__ colp,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, float* __restrict__ partial,
    int* __restrict__ counters, int n_rows, int n_pos, int f) {
  __shared__ int srow[EB], scol[EB];
  __shared__ float sw[EB];
  __shared__ int prev_row, next_row;
  const int b = blockIdx.x, t = threadIdx.x;
  const int base = b * EB;

  // 1. Every position below n_pos indexes valid memory: the stream's loads
  // go out with its real length.
  const int p = base + t;
  int r = -1, cp = 0;
  float wv = 0.f;
  if (p < n_pos) {
    const int e = perm ? perm[p] : p;
    r = row[e];
    wv = w[e];
    cp = colp[p];
  }
  int edge_row = -1;
  if (t == 0 && base > 0 && base - 1 < n_pos) edge_row = row_at(perm, row, base - 1);
  if (t == 1 && base + EB < n_pos) edge_row = row_at(perm, row, base + EB);
  const int e_real = row_ptr[n_rows];
  const int cnt = max(0, min(EB, e_real - base));

  // 4. the rows of this block's slice that have no edge: f / V coalesced
  // stores a row, two per thread per pass, both rows' pointers loaded first
  const int fq = f / V;
  const int slice = (n_rows + gridDim.x - 1) / gridDim.x;
  const int r0 = b * slice, items = (min(n_rows, r0 + slice) - r0) * fq;
  for (int i0 = 0; i0 < items; i0 += 2 * NT) {
    const int ia = i0 + t, ib = ia + NT;
    const int ra = r0 + min(ia, items - 1) / fq, rb = r0 + min(ib, items - 1) / fq;
    const int pa0 = row_ptr[ra], pa1 = row_ptr[ra + 1];
    const int pb0 = row_ptr[rb], pb1 = row_ptr[rb + 1];
    const float z[V] = {};
    if (ia < items && pa0 == pa1) store_v<V>(out + (size_t)ra * f + (ia % fq) * V, z);
    if (ib < items && pb0 == pb1) store_v<V>(out + (size_t)rb * f + (ib % fq) * V, z);
  }
  if (cnt == 0) return;  // the same for the whole block

  srow[t] = t < cnt ? r : -1;
  scol[t] = cp;
  sw[t] = wv;
  if (t == 0) prev_row = base > 0 ? edge_row : -1;
  if (t == 1) next_row = base + EB < e_real ? edge_row : -1;
  __syncthreads();

  // 2. the runs that start in this warp's positions, GROUPS at a time
  constexpr int GROUPS = 32 / G;
  const int warp = t >> 5, g = (t & 31) / G, gl = t % G;
  unsigned starts = __ballot_sync(
      0xffffffffu, t < cnt && (t == 0 || srow[t - 1] != srow[t]));
  while (starts) {  // the same for the whole warp
    unsigned mine = starts;
    for (int j = 0; j < g; ++j) mine &= mine - 1;
    for (int j = 0; j < GROUPS; ++j) starts &= starts - 1;
    if (!mine) continue;  // this round has fewer runs than groups
    const int q0 = warp * 32 + __ffs(mine) - 1;
    const int rr = srow[q0];
    int q1 = q0 + 1;
    while (q1 < cnt && srow[q1] == rr) ++q1;
    const bool head = q0 == 0 && prev_row == rr;   // began in an earlier block
    const bool tail = q1 == cnt && next_row == rr;  // goes on in a later block
    int span0 = 0, span1 = 0;
    if (head || tail) {  // read now, used after the walk
      span0 = row_ptr[rr];
      span1 = row_ptr[rr + 1];
    }
    // 3. the row, or this block's partial of it (head slot, else tail slot)
    walk_run<G, V>(scol, sw, h, q0, q1, f, gl,
                   head   ? partial + (size_t)(2 * b) * f
                   : tail ? partial + (size_t)(2 * b + 1) * f
                          : out + (size_t)rr * f);
    if (head || tail) arrive<G, V>(partial, out, counters, rr, span0, span1, f, gl);
  }
}

// ---- the earlier design: two launches -------------------------------

// pass 1: a warp (f >= 2) or a thread (f = 1) per run of a 256-position
// block, summing the run through perm -> col -> h one edge at a time.
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

// pass 2: a warp (or thread) per row: rows with no edges are written as
// zeros; a straddling row adds the tail partial of its first block and
// the head partials of the following blocks, in block order.
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
cudaError_t launch_earlier(const int* row_ptr, const int* perm, const int* row,
                           const int* col, const float* w, const float* h,
                           float* out, float* partial, int n_rows, int n_pos,
                           int f, cudaStream_t s) {
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

// out [n_rows, f]; partial [2 * max(1, ceil(n_pos / 256)), f] scratch;
// counters [n_rows] int32, all 0 (left at 0); n_pos is the length of the
// ordered stream (row_ptr[n_rows] <= n_pos, read on the card); row, col and
// w by edge id, colp by position. DESIGN_CURRENT reads colp and counters
// (col may be null); DESIGN_EARLIER reads col (colp and counters may be
// null).
extern "C" int spmm_edge_block_f32(const int* row_ptr, const int* perm,
                                   const int* row, const int* col,
                                   const int* colp, const float* w,
                                   const float* h, float* out, float* partial,
                                   int* counters, int n_rows, int n_pos, int f,
                                   int design, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (f < 1 || n_pos < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == DESIGN_EARLIER) {
    if (!col) return cudaErrorInvalidValue;
    return f == 1 ? launch_earlier<1>(row_ptr, perm, row, col, w, h, out,
                                      partial, n_rows, n_pos, f, s)
                  : launch_earlier<32>(row_ptr, perm, row, col, w, h, out,
                                       partial, n_rows, n_pos, f, s);
  }
  if (design != DESIGN_CURRENT || !colp || !counters) return cudaErrorInvalidValue;
  const int blocks = n_pos > 0 ? (n_pos + EB - 1) / EB : 1;
  if (f == 1) {
    edge_block_runs<1, 1><<<blocks, NT, 0, s>>>(row_ptr, perm, row, colp, w, h,
                                                out, partial, counters, n_rows,
                                                n_pos, f);
  } else if (f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    edge_block_runs<8, 4><<<blocks, NT, 0, s>>>(row_ptr, perm, row, colp, w, h,
                                                out, partial, counters, n_rows,
                                                n_pos, f);
  } else {
    edge_block_runs<32, 1><<<blocks, NT, 0, s>>>(row_ptr, perm, row, colp, w,
                                                 h, out, partial, counters,
                                                 n_rows, n_pos, f);
  }
  return cudaGetLastError();
}

extern "C" const char* spmm_edge_block_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
