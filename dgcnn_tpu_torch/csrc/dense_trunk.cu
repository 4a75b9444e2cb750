// Dense GCN trunk — forward and backward CUDA kernels for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/dense_trunk.py:gcn_trunk_fused (forward
// pallas_call at :232, backward at :310). For every graph slot s, with
// per-slot weight set k = wsel[s]:
//
//     h_1 = tanh(adj @ hw1 + b_1[k]) * mask
//     h_i = tanh(adj @ (h_{i-1} @ W_i[k]) + b_i[k]) * mask      i = 2..L
//     cat = [h_1 | ... | h_L]                                   [S, T, sum d]
//
// The backward walks the chain in reverse and uses adj^T == adj (the
// symmetric normalized adjacency of an undirected graph):
//
//     d_pre_i = (g_i + d_chain_i) * mask * (1 - h_i^2)
//     d_hw_i  = adj @ d_pre_i
//     dW_i[s] = h_{i-1}^T d_hw_i,  db_i[s] = sum_rows d_pre_i,
//     d_chain_{i-1} = d_hw_i @ W_i[k]^T,   d_hw1 = d_hw_1
//
// What bounds it on the H100. One slot's fp32 adjacency is T^2*4 bytes
// (50 KB at T=112, 1.5 MB at T=624, 16 MB at T=2048), far over what one
// block's shared memory holds at the larger tiles, so the TPU design
// (whole tile resident across all layers) does not carry over. The work
// per adjacency byte is 2*d/4 = 16 flop at d=32, under the fp32 ridge of
// the card (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the trunk is
// bound by adjacency bytes, read once per layer per direction here.
//
// Design (simple and correct first; keeping adj resident, wgmma and TMA
// are later work):
//   * one launch per layer on a grid of (row block of BM=32 rows, slot);
//   * the adjacency row tile [BM, BK] and the K-tile of the right-hand
//     side [BK, DP] stream through shared memory; 256 threads each hold a
//     4-row x DP/32-column accumulator in registers (fp32 FMA);
//   * the epilogue is row-local: bias -> tanh -> mask, write h_i into its
//     columns of cat, and compute the next layer's h_i @ W_{i+1} from the
//     rows staged in shared memory, so hw never makes an extra round trip;
//   * the backward's per-slot weight and bias gradients are reduced
//     across row blocks deterministically: each block writes its partial
//     sums (fixed in-block order) to a [S, nblk, P] scratch, and a second
//     pass sums the blocks in index order. No float atomics, so two runs
//     give the same bits.
//
// Every function returns cudaGetLastError() of its launch; the Python
// wrapper (kernels/dense_trunk.py) checks shapes, types and contiguity
// before calling, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 32;   // rows of one block
constexpr int BK = 32;   // depth of one adjacency K-tile
constexpr int NT = 256;  // threads of one block: 8 row groups x 32 lanes
constexpr int RPT = 4;   // rows per thread (8 x 4 = BM)

// Accumulate acc[j][c] = sum_q A[row0 + ty*RPT + j, q] * B[q, tx + 32c]
// over q < T for one slot. A is [T, T], B is [T, d] (row stride d).
template <int DP>
__device__ __forceinline__ void agg_rows(
    const float* __restrict__ A, const float* __restrict__ B, int T, int d,
    int row0, float* sA, float* sB, float (&acc)[RPT][DP / 32]) {
  constexpr int NC = DP / 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int r = e / BK, q = e % BK;
      const int gr = row0 + r, gq = k0 + q;
      sA[r * (BK + 1) + q] =
          (gr < T && gq < T) ? A[(size_t)gr * T + gq] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * DP; e += NT) {
      const int q = e / DP, c = e % DP;
      const int gq = k0 + q;
      sB[q * DP + c] = (gq < T && c < d) ? B[(size_t)gq * d + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < BK; ++q) {
      float a[RPT], b[NC];
#pragma unroll
      for (int j = 0; j < RPT; ++j) a[j] = sA[(ty * RPT + j) * (BK + 1) + q];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = sB[q * DP + tx + 32 * c];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[j][c] = fmaf(a[j], b[c], acc[j][c]);
    }
    __syncthreads();
  }
}

// Forward, one layer: cat[:, :, cat_off:cat_off+d] = h, and, unless
// w_next is null, hw_next = h @ w_next[k] ([S, T, dn]).
template <int DP>
__global__ void __launch_bounds__(NT) trunk_fwd_layer(
    const float* __restrict__ adj, const float* __restrict__ hw,
    const float* __restrict__ mask, const int* __restrict__ wsel,
    const float* __restrict__ bias, const float* __restrict__ w_next,
    float* __restrict__ cat, float* __restrict__ hw_next, int T, int d,
    int dn, int cat_stride, int cat_off, int K) {
  constexpr int NC = DP / 32;
  extern __shared__ float smem[];
  float* sA = smem;                 // [BM][BK+1]
  float* sB = sA + BM * (BK + 1);   // [BK][DP]
  float* sH = sB + BK * DP;         // [BM][DP+1]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int s = blockIdx.y, row0 = blockIdx.x * BM;
  const int k_raw = wsel[s];
  const bool bad = k_raw < 0 || k_raw >= K;  // poison the slot, never fault
  const int k = bad ? 0 : k_raw;

  float acc[RPT][NC];
  agg_rows<DP>(adj + (size_t)s * T * T, hw + (size_t)s * T * d, T, d, row0,
               sA, sB, acc);

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = ty * RPT + j, gr = row0 + r;
    const float m = gr < T ? mask[(size_t)s * T + gr] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 32 * c;
      float h = 0.f;
      if (col < d && gr < T) {
        h = bad ? NAN : tanhf(acc[j][c] + bias[(size_t)k * d + col]) * m;
        cat[((size_t)s * T + gr) * cat_stride + cat_off + col] = h;
      }
      sH[r * (DP + 1) + col] = h;
    }
  }
  if (w_next == nullptr) return;  // uniform across the block
  __syncthreads();
  const float* W = w_next + (size_t)k * d * dn;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = ty * RPT + j, gr = row0 + r;
    if (gr >= T) continue;
    for (int col = tx; col < dn; col += 32) {
      float sum = 0.f;
      for (int q = 0; q < d; ++q)
        sum = fmaf(sH[r * (DP + 1) + q], W[(size_t)q * dn + col], sum);
      hw_next[((size_t)s * T + gr) * dn + col] = bad ? NAN : sum;
    }
  }
}

// Backward, last layer's row-local start: d_pre = g * mask * (1 - h^2),
// plus this block's partial of db (columns db_off.. of part).
template <int DP>
__global__ void __launch_bounds__(NT) trunk_bwd_first(
    const float* __restrict__ cat, const float* __restrict__ g,
    const float* __restrict__ mask, float* __restrict__ dpre,
    float* __restrict__ part, int T, int d, int cat_stride, int off, int P,
    int db_off) {
  constexpr int NC = DP / 32;
  __shared__ float sZ[BM * (DP + 1)];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int s = blockIdx.y, blk = blockIdx.x, row0 = blk * BM;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = ty * RPT + j, gr = row0 + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 32 * c;
      float v = 0.f;
      if (col < d && gr < T) {
        const size_t ci = ((size_t)s * T + gr) * cat_stride + off + col;
        const float h = cat[ci];
        v = g[ci] * mask[(size_t)s * T + gr] * (1.f - h * h);
        dpre[((size_t)s * T + gr) * d + col] = v;
      }
      sZ[r * (DP + 1) + col] = v;
    }
  }
  __syncthreads();
  float* out = part + ((size_t)s * gridDim.x + blk) * P + db_off;
  for (int col = threadIdx.x; col < d; col += NT) {
    float sum = 0.f;
    for (int r = 0; r < BM; ++r) sum += sZ[r * (DP + 1) + col];
    out[col] = sum;
  }
}

// Backward, one layer i (width d, previous width dp; dp == 0 for the
// first layer): d_hw = adj @ dpre_in. For the first layer d_hw is the
// output d_hw1. Otherwise the block writes its partials of dW_i
// ([dp, d] at dw_off) and db_{i-1} ([dp] at db_off), and the previous
// layer's d_pre into out.
template <int DP>
__global__ void __launch_bounds__(NT) trunk_bwd_layer(
    const float* __restrict__ adj, const float* __restrict__ dpre_in,
    const float* __restrict__ cat, const float* __restrict__ g,
    const float* __restrict__ mask, const int* __restrict__ wsel,
    const float* __restrict__ w, float* __restrict__ out,
    float* __restrict__ part, int T, int d, int dp, int cat_stride,
    int off_prev, int K, int P, int dw_off, int db_off) {
  constexpr int NC = DP / 32;
  extern __shared__ float smem[];
  float* sA = smem;                 // [BM][BK+1]
  float* sB = sA + BM * (BK + 1);   // [BK][DP]
  float* sX = sB + BK * DP;         // d_hw rows   [BM][DP+1]
  float* sY = sX + BM * (DP + 1);   // h_{i-1} rows [BM][DP+1]
  float* sZ = sY + BM * (DP + 1);   // d_pre_{i-1} rows [BM][DP+1]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int s = blockIdx.y, blk = blockIdx.x, row0 = blk * BM;
  const int k_raw = wsel[s];
  const bool bad = k_raw < 0 || k_raw >= K;
  const int k = bad ? 0 : k_raw;

  float acc[RPT][NC];
  agg_rows<DP>(adj + (size_t)s * T * T, dpre_in + (size_t)s * T * d, T, d,
               row0, sA, sB, acc);

  if (dp == 0) {  // first layer: d_hw1 out, uniform across the block
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int gr = row0 + ty * RPT + j;
      if (gr >= T) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 32 * c;
        if (col < d)
          out[((size_t)s * T + gr) * d + col] = bad ? NAN : acc[j][c];
      }
    }
    return;
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = ty * RPT + j, gr = row0 + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 32 * c;
      sX[r * (DP + 1) + col] = (col < d && gr < T) ? acc[j][c] : 0.f;
      sY[r * (DP + 1) + col] =
          (col < dp && gr < T)
              ? cat[((size_t)s * T + gr) * cat_stride + off_prev + col]
              : 0.f;
    }
  }
  __syncthreads();

  float* pw = part + ((size_t)s * gridDim.x + blk) * P;
  for (int e = threadIdx.x; e < dp * d; e += NT) {
    const int a = e / d, b = e % d;
    float sum = 0.f;
    for (int r = 0; r < BM; ++r)
      sum = fmaf(sY[r * (DP + 1) + a], sX[r * (DP + 1) + b], sum);
    pw[dw_off + e] = bad ? NAN : sum;
  }

  const float* W = w + (size_t)k * dp * d;  // [dp, d]
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = ty * RPT + j, gr = row0 + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int a = tx + 32 * c;
      float v = 0.f;
      if (a < dp && gr < T) {
        float chain = 0.f;
        for (int b = 0; b < d; ++b)
          chain = fmaf(sX[r * (DP + 1) + b], W[(size_t)a * d + b], chain);
        const float h = sY[r * (DP + 1) + a];
        const size_t gi = ((size_t)s * T + gr) * cat_stride + off_prev + a;
        v = (g[gi] + chain) * mask[(size_t)s * T + gr] * (1.f - h * h);
        out[((size_t)s * T + gr) * dp + a] = bad ? NAN : v;
      }
      sZ[r * (DP + 1) + a] = v;
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < dp; a += NT) {
    float sum = 0.f;
    for (int r = 0; r < BM; ++r) sum += sZ[r * (DP + 1) + a];
    pw[db_off + a] = bad ? NAN : sum;
  }
}

// Second pass of the deterministic reduction: out[s, p] = sum over row
// blocks b, in index order, of part[s, b, p].
__global__ void __launch_bounds__(NT) trunk_reduce_blocks(
    const float* __restrict__ part, float* __restrict__ out, int S, int nblk,
    int P) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= (size_t)S * P) return;
  const size_t s = i / P, p = i % P;
  float sum = 0.f;
  for (int b = 0; b < nblk; ++b) sum += part[(s * nblk + b) * P + p];
  out[i] = sum;
}

size_t fwd_smem(int dp_) {
  return sizeof(float) *
         (size_t)(BM * (BK + 1) + BK * dp_ + BM * (dp_ + 1));
}

size_t bwd_smem(int dp_) {
  return sizeof(float) *
         (size_t)(BM * (BK + 1) + BK * dp_ + 3 * BM * (dp_ + 1));
}

template <int DP>
cudaError_t launch_fwd(const float* adj, const float* hw, const float* mask,
                       const int* wsel, const float* bias,
                       const float* w_next, float* cat, float* hw_next, int S,
                       int T, int d, int dn, int cat_stride, int cat_off,
                       int K, cudaStream_t st) {
  const size_t smem = fwd_smem(DP);
  cudaError_t e = cudaFuncSetAttribute(
      trunk_fwd_layer<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + BM - 1) / BM, S);
  trunk_fwd_layer<DP><<<grid, NT, smem, st>>>(adj, hw, mask, wsel, bias,
                                              w_next, cat, hw_next, T, d, dn,
                                              cat_stride, cat_off, K);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_first(const float* cat, const float* g,
                             const float* mask, float* dpre, float* part,
                             int S, int T, int d, int cat_stride, int off,
                             int P, int db_off, cudaStream_t st) {
  dim3 grid((T + BM - 1) / BM, S);
  trunk_bwd_first<DP><<<grid, NT, 0, st>>>(cat, g, mask, dpre, part, T, d,
                                           cat_stride, off, P, db_off);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_layer(const float* adj, const float* dpre_in,
                             const float* cat, const float* g,
                             const float* mask, const int* wsel,
                             const float* w, float* out, float* part, int S,
                             int T, int d, int dp, int cat_stride,
                             int off_prev, int K, int P, int dw_off,
                             int db_off, cudaStream_t st) {
  const size_t smem = bwd_smem(DP);
  cudaError_t e = cudaFuncSetAttribute(
      trunk_bwd_layer<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + BM - 1) / BM, S);
  trunk_bwd_layer<DP><<<grid, NT, smem, st>>>(
      adj, dpre_in, cat, g, mask, wsel, w, out, part, T, d, dp, cat_stride,
      off_prev, K, P, dw_off, db_off);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. `dp_bucket` is the register/shared
// tile width for the whole trunk: 32, 64 or 128 (the widest layer rounded
// up), chosen by the wrapper. Any other value returns cudaErrorInvalidValue.

extern "C" int trunk_fwd_layer_f32(const float* adj, const float* hw,
                                   const float* mask, const int* wsel,
                                   const float* bias, const float* w_next,
                                   float* cat, float* hw_next, int S, int T,
                                   int d, int dn, int cat_stride, int cat_off,
                                   int K, int dp_bucket, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dp_bucket) {
    case 32:
      return launch_fwd<32>(adj, hw, mask, wsel, bias, w_next, cat, hw_next,
                            S, T, d, dn, cat_stride, cat_off, K, st);
    case 64:
      return launch_fwd<64>(adj, hw, mask, wsel, bias, w_next, cat, hw_next,
                            S, T, d, dn, cat_stride, cat_off, K, st);
    case 128:
      return launch_fwd<128>(adj, hw, mask, wsel, bias, w_next, cat, hw_next,
                             S, T, d, dn, cat_stride, cat_off, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int trunk_bwd_first_f32(const float* cat, const float* g,
                                   const float* mask, float* dpre,
                                   float* part, int S, int T, int d,
                                   int cat_stride, int off, int P, int db_off,
                                   int dp_bucket, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dp_bucket) {
    case 32:
      return launch_bwd_first<32>(cat, g, mask, dpre, part, S, T, d,
                                  cat_stride, off, P, db_off, st);
    case 64:
      return launch_bwd_first<64>(cat, g, mask, dpre, part, S, T, d,
                                  cat_stride, off, P, db_off, st);
    case 128:
      return launch_bwd_first<128>(cat, g, mask, dpre, part, S, T, d,
                                   cat_stride, off, P, db_off, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int trunk_bwd_layer_f32(const float* adj, const float* dpre_in,
                                   const float* cat, const float* g,
                                   const float* mask, const int* wsel,
                                   const float* w, float* out, float* part,
                                   int S, int T, int d, int dp,
                                   int cat_stride, int off_prev, int K, int P,
                                   int dw_off, int db_off, int dp_bucket,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dp_bucket) {
    case 32:
      return launch_bwd_layer<32>(adj, dpre_in, cat, g, mask, wsel, w, out,
                                  part, S, T, d, dp, cat_stride, off_prev, K,
                                  P, dw_off, db_off, st);
    case 64:
      return launch_bwd_layer<64>(adj, dpre_in, cat, g, mask, wsel, w, out,
                                  part, S, T, d, dp, cat_stride, off_prev, K,
                                  P, dw_off, db_off, st);
    case 128:
      return launch_bwd_layer<128>(adj, dpre_in, cat, g, mask, wsel, w, out,
                                   part, S, T, d, dp, cat_stride, off_prev, K,
                                   P, dw_off, db_off, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* trunk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int trunk_reduce_blocks_f32(const float* part, float* out, int S,
                                       int nblk, int P, void* stream) {
  const size_t n = (size_t)S * P;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + NT - 1) / NT);
  trunk_reduce_blocks<<<blocks, NT, 0, (cudaStream_t)stream>>>(part, out, S,
                                                               nblk, P);
  return cudaGetLastError();
}
