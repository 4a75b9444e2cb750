// Block-sparse GCN propagation, CSR form — CUDA kernel for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/block_pallas.py:block_propagate_pallas
// (pallas_call at :152; backward _bwd :201). Contract, shared with
// block_resident.cu:
//
//   out[r, :, :] = sum_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]   r < nb
//   hb [nb, bs, F] fp32, pool [P+1, bs, bs] fp32 (row P = zeros), out [nb, bs, F] fp32
//   transpose=True:  out[c] = sum_{w in col-major order, item_colT = c} pool[ipT_w]^T @ g[rT_w]
//
// bs = 128, F = 1..128. item_row is non-decreasing and padded items carry
// segment id >= nb, so they fall outside every row and are never read;
// rows no item visits come out as exact zeros. The backward is this
// kernel with transpose=1 over the build-time col-major traversal
// (ipT = item_pool[permT], rT = min(item_row[permT], nb-1), segments
// item_colT). No cotangent is formed for pool.
//
// What bounds it on the H100. Per call, with n real items:
//   bytes      = n*(bs^2*4 + bs*F*4) + nb*bs*F*4   (+ indices)
//   operations = 2*n*bs^2*F
// At DD's mean step (575 items, F = 32) that is 50.5 MB, 15.1 us at
// 3.35 TB/s, against 0.60 GFLOP, 9.0 us at 67 TFLOP/s fp32: bound by
// bytes (the pool blocks). One step's blocks (~39 MB) fit the 50 MB L2
// and are read 8 times per train step, so a warm repeat can beat the
// HBM bound.
//
// The split. Every output block-row's item run is cut into pieces of at
// most P items (P = 2, kernels/block_csr.py PIECE), one 256-thread block
// per piece, so no long run keeps one SM busy while the others wait (the
// rows of DD's 2,218-node graph hold 18 items each). The plan is two
// [nb+1] tables per direction, built once per batch by
// kernels/block_prop.py plan_pieces (torch ops on the device, shapes
// from the budgets): row_ptr (each row's items) and piece_ptr (each
// row's pieces). Every row has at least one piece (an empty row's piece
// writes zeros), so there are at most ceil(W / P) + nb pieces, the grid
// size, and the host never reads a count. Block q finds its row by
// testing the rows' piece ranges side by side (find_piece); the k-th
// piece of row r covers items row_ptr[r] + k*P .. min(row_ptr[r] +
// (k+1)*P, row_ptr[r+1]). Blocks past the real pieces return at once.
//   - a row with one piece: its block writes out[r] directly;
//   - a row with several: each piece writes its 128 x F partial into
//     scratch[q], then counts its arrival on the row's int counter
//     (block_tile.cuh arrive_last); the block that arrives last sums the
//     row's partials in piece order and writes out[r]. One launch per
//     propagation and no float atomics: within a piece the items add in
//     item order, and the partials in piece order, so two runs give the
//     same bits whichever piece finishes last (the bits do change with
//     P). The counters ([>= nb] int32, owned by the wrapper, zero between
//     launches) are the only state across launches.
// The product is block_tile.cuh's 3xTF32 mma tile over half-item
// k-chunks in a two-stage ring: 88 kB of shared memory at F <= 32
// (104 kB at <= 64), two blocks per SM, each with its next chunk's
// copies in flight (137 kB and one block at F > 64). F = 1 is a
// matrix-vector product per item read straight from global memory.
//
// Tried on the card and dropped (chip_smoke.py phase 5, the DD mean batch,
// F = 32, forward / backward ms warm; NVIDIA H100 80GB HBM3, 700 W;
// the kept design in the same run: 0.0338 / 0.0350):
//   - one block per row walking its whole run, whole items double
//     buffered (168 kB, one block per SM), fp32 FMA tile: the earlier
//     design, 0.0491 / 0.0515;
//   - pieces of 4 or 6 items: 0.0362 / 0.0377 and 0.0460 / 0.0475;
//   - whole items, one stage (two blocks per SM, the next item loads after
//     this one's product) or two (one block per SM): 0.0355 / 0.0371 and
//     0.0366 / 0.0390; quarter items in four stages: 0.0334 / 0.0347, no
//     better than halves across the three batches;
//   - the fp32 FMA tile: 0.0390 / 0.0390. It is bound by shared-memory
//     wavefronts (see block_tile.cuh);
//   - the 3xTF32 split by cvt.rna.tf32.f32 (24 conversions per k-step
//     and warp): 0.0439 / 0.0459 at P = 4 and whole items in one stage,
//     against the FMA tile's 0.0465 / 0.0472; splitting by integer
//     rounding instead took the same design to 0.0363 / 0.0388;
//   - the piece table written out per piece ([3, np] row, first and end
//     item) by 26 torch ops: the step ran 154 launches, above the 151 of
//     the one-block-per-row design; the pointers alone take 13 ops
//     (148 launches per step);
//   - a persistent schedule: as many blocks as fit on the card, each
//     taking pieces from an int counter and copying its next piece's
//     chunks during this one's product: 0.0399 / 0.0419 against 0.0338 /
//     0.0352 for a block per piece in the same run (each take costs two
//     barriers and an atomic on the copy path, one chunk ahead of the
//     product).
// A second launch summing the split rows (as spmm_edge_block.cu does)
// was not tried: it costs a launch per propagation and a pass over every
// row, where the handshake reads only the split rows' partials, from L2.
//
// Every entry returns cudaGetLastError() of its launch; the wrapper
// checks shapes, types and contiguity before calling and raises on a
// non-zero return.

#include "block_tile.cuh"

namespace {

using namespace blk;

struct Pieces {
  const int* row_ptr;  // [nb+1]: row r's items are row_ptr[r] .. row_ptr[r+1]-1
  const int* ptr;      // [nb+1]: row r's pieces are ptr[r] .. ptr[r+1]-1
  int np;              // the grid: ceil(W / p) + nb >= ptr[nb]
  int nb;
  int p;               // items per piece at most
};

// Piece q's row, and its items [first, end); -1 for a q past the real
// pieces (the same in every thread). Every row has at least one piece,
// so ptr rises strictly and exactly one r has ptr[r] <= q < ptr[r+1]:
// the threads test the rows side by side, and the one that finds q's
// row hands it over through shared memory.
__device__ __forceinline__ int find_piece(const Pieces& pc, int q, int& first,
                                          int& end) {
  __shared__ int s_row;
  if (q >= pc.ptr[pc.nb]) return -1;
  for (int r = threadIdx.x; r < pc.nb; r += NT)
    if (pc.ptr[r] <= q && q < pc.ptr[r + 1]) s_row = r;
  __syncthreads();
  const int r = s_row;
  first = pc.row_ptr[r] + (q - pc.ptr[r]) * pc.p;
  end = min(first + pc.p, pc.row_ptr[r + 1]);
  return r;
}

template <int FP, bool TRANS>
__global__ void __launch_bounds__(NT, ring_blocks<FP>())
    csr_tile(const float* __restrict__ pool, const float* __restrict__ hb,
             Pieces pc, const int* __restrict__ ip, const int* __restrict__ src,
             float* __restrict__ out, float* __restrict__ scratch,
             int* __restrict__ counters, int f) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x;
  int first, end;
  const int r = find_piece(pc, q, first, end);
  if (r < 0) return;
  const int n = end - first;
  const int p0 = pc.ptr[r], pieces = pc.ptr[r + 1] - p0;
  const int len = BS * f;

  float acc[4][FP / 8];
  tile_zero<FP>(acc);
  if (n > 0)
    walk_items<FP, TRANS>(smem, pool, hb, ip, src, first, n, f, acc,
                          [](int, float(&)[4][FP / 8]) {});
  if (pieces == 1) {
    mma3_store<FP>(acc, out + (size_t)r * len, f);
    return;
  }
  mma3_store<FP>(acc, scratch + (size_t)q * len, f);
  if (arrive_last(counters + r, pieces))
    sum_parts(scratch, p0, p0 + pieces, len, out + (size_t)r * len);
}

template <bool TRANS>
__global__ void __launch_bounds__(NT) csr_f1(
    const float* __restrict__ pool, const float* __restrict__ hb, Pieces pc,
    const int* __restrict__ ip, const int* __restrict__ src,
    float* __restrict__ out, float* __restrict__ scratch,
    int* __restrict__ counters) {
  __shared__ __align__(16) float red[NT / 32 * BS];
  const int q = blockIdx.x;
  int start, end;
  const int r = find_piece(pc, q, start, end);
  if (r < 0) return;
  const int p0 = pc.ptr[r], pieces = pc.ptr[r + 1] - p0;
  float* dst = pieces == 1 ? out + (size_t)r * BS : scratch + (size_t)q * BS;
  if (TRANS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = start; w < end; ++w)
      f1_trans_item(pool + (size_t)ip[w] * BS * BS, hb + src[w] * BS, acc);
    f1_trans_store(acc, red, dst);
  } else {
    float acc[16];
#pragma unroll
    for (int mm = 0; mm < 16; ++mm) acc[mm] = 0.f;
    for (int w = start; w < end; ++w)
      f1_fwd_item(pool + (size_t)ip[w] * BS * BS, hb + src[w] * BS, acc);
    f1_fwd_store(acc, dst);
  }
  if (pieces > 1 && arrive_last(counters + r, pieces))
    sum_parts(scratch, p0, p0 + pieces, BS, out + (size_t)r * BS);
}

template <int FP, bool TRANS>
cudaError_t launch_tile(const float* pool, const float* hb, const Pieces& pc,
                        const int* ip, const int* src, float* out,
                        float* scratch, int* counters, int f,
                        cudaStream_t stream) {
  constexpr size_t smem = ring_smem<FP>();
  static cudaError_t attr = allow_smem(csr_tile<FP, TRANS>, smem);
  if (attr != cudaSuccess) return attr;
  csr_tile<FP, TRANS><<<pc.np, NT, smem, stream>>>(pool, hb, pc, ip, src, out,
                                                    scratch, counters, f);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t dispatch(const float* pool, const float* hb, const Pieces& pc,
                     const int* ip, const int* src, float* out, float* scratch,
                     int* counters, int f, cudaStream_t stream) {
  if (f == 1) {
    csr_f1<TRANS><<<pc.np, NT, 0, stream>>>(pool, hb, pc, ip, src, out,
                                            scratch, counters);
    return cudaGetLastError();
  }
  if (f <= 32)
    return launch_tile<32, TRANS>(pool, hb, pc, ip, src, out, scratch, counters,
                                  f, stream);
  if (f <= 64)
    return launch_tile<64, TRANS>(pool, hb, pc, ip, src, out, scratch, counters,
                                  f, stream);
  return launch_tile<128, TRANS>(pool, hb, pc, ip, src, out, scratch, counters,
                                 f, stream);
}

}  // namespace

// out [nb, 128, f] = CSR propagation of hb [.., 128, f] (see the header).
// row_ptr, piece_ptr [nb+1] int32 (the plan); np = ceil(W / p) + nb, p
// the items per piece; ip, src int32 item lists in segment order; scratch
// [np, 128, f] fp32; counters [>= nb] int32, all 0 (left 0).
extern "C" int block_csr_f32(const float* pool, const float* hb,
                             const int* row_ptr, const int* piece_ptr,
                             const int* ip, const int* src, float* out,
                             float* scratch, int* counters, int nb, int np,
                             int p, int f, int transpose, void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (f < 1 || f > 128 || np < nb || p < 1) return cudaErrorInvalidValue;
  const Pieces pc{row_ptr, piece_ptr, np, nb, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return transpose
             ? dispatch<true>(pool, hb, pc, ip, src, out, scratch, counters, f, s)
             : dispatch<false>(pool, hb, pc, ip, src, out, scratch, counters, f, s);
}

extern "C" const char* block_csr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
