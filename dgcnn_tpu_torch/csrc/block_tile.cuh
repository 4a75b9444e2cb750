// Device building blocks shared by the two block-propagation kernels
// (block_csr.cu, block_resident.cu): the copy ring that stages one work
// item's operands in shared memory half an item at a time, the walk over
// a run of items, the 3xTF32 tensor-core product of one staged chunk, the
// F = 1 forms, and the fixed-order sum of partial tiles with the "last
// block" handshake. spmm_block_coo_probe.cu also takes its fp32 FMA tile
// (tile_mac) and staging constants from here.
//
// One work item is   part = A @ B        (forward)
//                    part = A^T @ B      (transpose)
// with A = pool[ip] a 128 x 128 fp32 adjacency block (row-major) and B a
// 128 x f block-row of node features (row-major, f <= 128). Widths 2..128
// compile for a padded FP in {32, 64, 128}; columns f..FP-1 are computed
// from whatever shared memory holds there and never stored (column c of
// the product depends on column c of B alone).
//
// What bounds an item on the H100: 2 * 128 * 128 * F operations against
// 64 KB + 512 F bytes, 16 flop/byte at F = 32 (the card's fp32 balance is
// 20), so a stream of items is bound by its bytes, and the kernels must
// keep every SM's copies in flight while it multiplies.
//
// The product: warp w owns output rows w*16 .. +15 and every column, in
// m16n8k8 TF32 mma.sync fragments, each fp32 operand split in a TF32 high
// and low part (three products). It reads each fragment once with
// conflict-free 4-byte loads and splits by integer arithmetic. Error: a
// product's dropped low x low term and the tensor core's truncation of
// the low parts are each ~2^-20 of it, far inside the rtol 1e-4 the card
// checks hold the kernels to. (The fp32 FMA tile, thread t owning rows
// t/8*4 .. +3 and FP/8 columns, is bound by shared-memory wavefronts: a
// 16-byte load is four of them, ~8,200 wavefront cycles of one SM per
// item. The kernels' headers list it with the other designs tried.)
//
// The copy ring: half-item k-chunks (KC = 64 of the 128 k indices: the
// columns of A, or its rows in the transposed mode, and the rows of B) in
// two stages (RING_KC, RING_STAGES), the next chunk's copies in flight
// during this one's product. Shared memory in kB (1,000 bytes) at FP = 32 / 64 / 128:
// 88 / 104 / 137, so two blocks share an SM at FP <= 64 and one at 128.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace blk {

constexpr int BS = 128;       // block size (rows and columns of A)
constexpr int NT = 256;       // threads of one block

constexpr int LDA = BS + 4;   // shared row stride of a staged 128-wide
                              // block: 16-byte aligned rows

// A stage holds a k-chunk of one item: KC of the 128 k indices (the
// columns of A, or its rows in the transposed mode, and the rows of B;
// spmm_block_coo_probe.cu stages whole items, KC = 128). The staged A's
// stride by mode: the forward stages A[:, kc:kc+KC] as 128
// rows of KC + 4 floats, the transposed mode A[kc:kc+KC, :] as KC rows of
// 136. The tensor-core tile reads A's fragment at (row g, col t) for lane
// 4g + t: with a stride of 4 mod 32 the lanes fall in banks 4g + t, all
// distinct; the transposed mode reads A at (row t, col g), banks 4t + g
// with stride 132 (2-way conflicts) and 8t + g with stride 136 (none).
template <bool TRANS, int KC = BS>
__host__ __device__ constexpr int lda() { return TRANS ? BS + 8 : KC + 4; }

constexpr int RING_KC = BS / 2;  // k indices per chunk of the copy ring
constexpr int RING_STAGES = 2;   // chunks in the ring

template <int FP, int KC = BS>
struct TileShape {
  static constexpr int CN = FP / 8;                  // columns per thread (FMA)
  static constexpr int LDB = FP + 4;                 // B's stride: fragment
                                                     // lanes 4t + g distinct
  static constexpr int A_FLOATS =                    // staged A, either mode
      BS * (KC + 4) > KC * (BS + 8) ? BS * (KC + 4) : KC * (BS + 8);
  static constexpr int B_FLOATS = KC * LDB;          // staged B
  static constexpr int STAGE = A_FLOATS + B_FLOATS;  // one buffer, floats
};

// Dynamic shared memory of the ring, and the blocks of 256 threads it
// lets share an SM (227 KB a block, 228 KB an SM with 1 KB kept per block).
template <int FP>
__host__ __device__ constexpr size_t ring_smem() {
  return (size_t)RING_STAGES * TileShape<FP, RING_KC>::STAGE * sizeof(float);
}

template <int FP>
__host__ __device__ constexpr int ring_blocks() {
  return 2 * (ring_smem<FP>() + 1024) <= 233472 ? 2 : 1;
}

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

// Issue the asynchronous copies of one item's k-chunk kc .. kc+KC-1 of A
// (128 x 128) and B (128 x f) into one stage buffer. The caller commits
// and waits.
template <int FP, bool TRANS, int KC>
__device__ __forceinline__ void stage_load(float* stage,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, int kc,
                                           int f) {
  constexpr int LD = lda<TRANS, KC>(), LDB = TileShape<FP, KC>::LDB;
  float* sA = stage;
  float* sB = stage + TileShape<FP, KC>::A_FLOATS;
  if (TRANS) {  // rows kc .. kc+KC-1 of A, whole
    for (int e = threadIdx.x; e < KC * BS / 4; e += NT) {
      const int r = e >> 5, c4 = e & 31;  // 32 chunks of 16 bytes per row
      cp_async16(sA + r * LD + c4 * 4, a + (size_t)(kc + r) * BS + c4 * 4);
    }
  } else {  // columns kc .. kc+KC-1 of every row of A
    constexpr int Q = KC / 4;
    for (int e = threadIdx.x; e < BS * Q; e += NT) {
      const int r = e / Q, c4 = e % Q;
      cp_async16(sA + r * LD + c4 * 4, a + (size_t)r * BS + kc + c4 * 4);
    }
  }
  b += (size_t)kc * f;  // rows kc .. kc+KC-1 of B
  if ((f & 3) == 0) {  // B rows are 16-byte aligned: b starts at a
                       // multiple of 128 * f floats
    const int q = f >> 2;
    for (int e = threadIdx.x; e < KC * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      cp_async16(sB + r * LDB + c4 * 4, b + r * f + c4 * 4);
    }
  } else {
    for (int e = threadIdx.x; e < KC * f; e += NT) {
      const int r = e / f, c = e - r * f;
      cp_async4(sB + r * LDB + c, b + e);
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

// acc += A @ B (or A^T @ B) over the staged k-chunk. k runs in order, so
// a thread's sums are taken in a fixed order.
template <int FP, bool TRANS, int KC = BS>
__device__ __forceinline__ void tile_mac(const float* stage,
                                         float (&acc)[4][FP / 8]) {
  constexpr int CN = FP / 8;
  constexpr int LD = lda<TRANS, KC>(), LDB = TileShape<FP, KC>::LDB;
  const float* sA = stage;
  const float* sB = stage + TileShape<FP, KC>::A_FLOATS;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int row0 = ty * 4;
#pragma unroll 2
  for (int k0 = 0; k0 < KC; k0 += 4) {
    float a[4][4];  // [output row m][k0 + kk]
    if (TRANS) {
      // A^T[row0 + m][k] = A[k][row0 + m]: row k of A, 4 columns at once
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v =
            *reinterpret_cast<const float4*>(sA + (k0 + kk) * LD + row0);
        a[0][kk] = v.x; a[1][kk] = v.y; a[2][kk] = v.z; a[3][kk] = v.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 v =
            *reinterpret_cast<const float4*>(sA + (row0 + m) * LD + k0);
        a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[CN];
#pragma unroll
      for (int c = 0; c < CN; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            sB + (k0 + kk) * LDB + tx * CN + c);
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

// ---- The tensor-core form: 3xTF32 mma.sync.m16n8k8. Each fp32 operand x
// is split into a TF32 high part h (x rounded to 10 mantissa bits) and a
// low part l = x - h (exact in fp32; the tensor core reads its top 19
// bits); a product is l_a h_b + h_a l_b + h_a h_b (the small terms
// first; l_a l_b, below fp32's last bits of the product, is left out),
// accumulated in fp32 by the tensor core. The split is integer and fp32
// arithmetic (add half an ulp of TF32, clear the low 13 bits): the
// cvt.rna.tf32.f32 conversion runs at a quarter of the ALU rate, and with
// it the split, not the mma, set the tile's time. Warp w owns output rows
// w*16 .. w*16+15 and every column: n-tile nt (columns nt*8 .. nt*8+7)
// sits in acc[0..3][nt] as the mma's C fragment, (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1) for lane 4g + t. k runs 0..127 in steps of 8 in
// order, and the tensor core's own sum order is fixed, so a run's bits
// do not change from launch to launch.

__device__ __forceinline__ void tf32_split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2,
                                         float& c3, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int FP, bool TRANS, int KC>
__device__ __forceinline__ void mma3_mac(const float* stage,
                                         float (&acc)[4][FP / 8]) {
  constexpr int LD = lda<TRANS, KC>(), LDB = TileShape<FP, KC>::LDB;
  const float* sA = stage;
  const float* sB = stage + TileShape<FP, KC>::A_FLOATS;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
#pragma unroll 2
  for (int k0 = 0; k0 < KC; k0 += 8) {
    float a[4];  // A fragment: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
    if (TRANS) {  // A^T[m][k] = A[k][m]
      a[0] = sA[(k0 + t) * LD + m0 + g];
      a[1] = sA[(k0 + t) * LD + m0 + g + 8];
      a[2] = sA[(k0 + t + 4) * LD + m0 + g];
      a[3] = sA[(k0 + t + 4) * LD + m0 + g + 8];
    } else {
      a[0] = sA[(m0 + g) * LD + k0 + t];
      a[1] = sA[(m0 + g + 8) * LD + k0 + t];
      a[2] = sA[(m0 + g) * LD + k0 + t + 4];
      a[3] = sA[(m0 + g + 8) * LD + k0 + t + 4];
    }
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(a[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < FP / 8; ++nt) {
      unsigned bh0, bl0, bh1, bl1;  // B fragment: (k t, n g), (k t+4, n g)
      tf32_split(sB[(k0 + t) * LDB + nt * 8 + g], bh0, bl0);
      tf32_split(sB[(k0 + t + 4) * LDB + nt * 8 + g], bh1, bl1);
      float& c0 = acc[0][nt];
      float& c1 = acc[1][nt];
      float& c2 = acc[2][nt];
      float& c3 = acc[3][nt];
      mma_tf32(c0, c1, c2, c3, al, bh0, bh1);
      mma_tf32(c0, c1, c2, c3, ah, bl0, bl1);
      mma_tf32(c0, c1, c2, c3, ah, bh0, bh1);
    }
  }
}

// Write the mma layout's accumulator into dst, a [128, f] row-major tile;
// columns >= f are dropped.
template <int FP>
__device__ __forceinline__ void mma3_store(const float (&acc)[4][FP / 8],
                                           float* __restrict__ dst, int f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  float* r0 = dst + (size_t)(m0 + g) * f;
  float* r1 = dst + (size_t)(m0 + g + 8) * f;
  if ((f & 1) == 0) {  // column pairs (c, c+1) are 8-byte aligned
#pragma unroll
    for (int nt = 0; nt < FP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < f) {
        *reinterpret_cast<float2*>(r0 + c) = make_float2(acc[0][nt], acc[1][nt]);
        *reinterpret_cast<float2*>(r1 + c) = make_float2(acc[2][nt], acc[3][nt]);
      }
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < FP / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (c < f) { r0[c] = acc[0][nt]; r1[c] = acc[2][nt]; }
    if (c + 1 < f) { r0[c + 1] = acc[1][nt]; r1[c + 1] = acc[3][nt]; }
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

// Walk items first .. first+n-1 (n >= 1) through the copy ring, one
// k-chunk at a time in item order and k order: before(k, acc) runs once
// the k-th item's first chunk has landed and before its product is added
// into acc (block_resident.cu stores and restarts the accumulator there
// when the destination row changes). The next chunk is issued as soon as
// every thread has finished with the slot it goes to (the barrier of
// this step), so its copies run during this chunk's product.
template <int FP, bool TRANS, typename Before>
__device__ __forceinline__ void walk_items(
    float* smem, const float* __restrict__ pool, const float* __restrict__ hb,
    const int* __restrict__ ip, const int* __restrict__ src, int first, int n,
    int f, float (&acc)[4][FP / 8], Before before) {
  constexpr int KC = RING_KC, STAGES = RING_STAGES;
  constexpr int CH = BS / KC;  // chunks per item
  constexpr int STAGE = TileShape<FP, KC>::STAGE;
  const size_t hb_blk = (size_t)BS * f;
  const int steps = n * CH;
  auto load = [&](int s) {
    const int w = first + s / CH;
    stage_load<FP, TRANS, KC>(smem + (s % STAGES) * STAGE,
                              pool + (size_t)ip[w] * BS * BS,
                              hb + src[w] * hb_blk, (s % CH) * KC, f);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // chunk s has landed (this thread's copies)
    __syncthreads();              // ... every thread's; slot (s-1) is free
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    if (s % CH == 0) before(s / CH, acc);
    mma3_mac<FP, TRANS, KC>(smem + (s % STAGES) * STAGE, acc);
  }
}

// ---- partial tiles and their fixed-order sum

// dst[e] = parts[p0][e] + parts[p0+1][e] + ... + parts[p1-1][e], summed
// left to right, for the len floats of one output block-row (zeros when
// p0 == p1). len = 128 * f is a multiple of 4. Loads go through L2
// (__ldcg): in block_csr.cu the partials were written by other blocks of
// the same launch.
__device__ __forceinline__ void sum_parts(const float* parts, int p0, int p1,
                                          int len, float* __restrict__ dst) {
  const int len4 = len >> 2;
  const float4* p = reinterpret_cast<const float4*>(parts);
  for (int e = threadIdx.x; e < len4; e += NT) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 < p1) {
      s = __ldcg(p + (size_t)p0 * len4 + e);
      for (int j = p0 + 1; j < p1; ++j) {
        const float4 v = __ldcg(p + (size_t)j * len4 + e);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    }
    reinterpret_cast<float4*>(dst)[e] = s;
  }
}

// The "last block" handshake of a row split into `pieces` pieces. Every
// thread has stored its share of the piece's partial; the fence makes
// those stores visible device-wide before thread 0 counts the arrival on
// the row's integer counter. The block that brings the count to
// `pieces` returns true in every thread (after a second fence, so its
// reads of the other partials come after their stores) and sets the
// counter back to 0 for the next launch: no other block of this launch
// touches it after the last arrival.
__device__ __forceinline__ bool arrive_last(int* counter, int pieces) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == pieces - 1;
    if (last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
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
