// Block-pair COO SpMM — CUDA kernel for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/spmm_block_coo.py:spmm_block_coo (pallas_call
// at :399; kernel _kernel :317; backward _bwd :441). Contract:
//
//   for each output block-row r < nb, items j in [row_ptr[r], row_ptr[r+1]),
//   and every slot q of item j:
//     out[r*128 + ld[j, q], :] += w[j, q] * h[item_c[j]*128 + ls[j, q], :]
//   h [nb*128, f] fp32, out [nb*128, f] fp32, any f >= 1; ls, ld int32 and
//   w fp32 [W, eb].
//
// Items outside every row_ptr range (the padding's sentinel items) are
// never read; rows with no slot come out as exact zeros. Null slots hold
// w = 0 and add 0. The backward is this kernel over the structure's
// transpose orientation (row_ptrT, item_cT, lsT, ldT, w_padT) with h = the
// output gradient; kernels/spmm_block_coo.py prepares both.
//
// Design. The TPU kernel builds each item's 128 x 128 block A as a one-hot
// product on its matrix unit and multiplies it into h[c]: 2 * 128^2 * f
// operations for one item's 256 slots, 64x the 2 * 256 * f the slots need,
// the trade a chip whose only fast unit is the matrix unit makes. The
// port's first version of this kernel (kept as the probe's `abuild`
// variant in spmm_block_coo_probe.cu) carried that over: one block per output
// block-row, an A build in shared memory and a block_tile.cuh product per
// item, one item after another. It ran 53x its bound and 5.5x slower than
// cuSPARSE on the batches `--spmm pallas` trains on, and its time followed
// the longest item run. Here each slot's w * h[src] is added straight into
// its row (spmm_slots.cuh): the wrapper sorts the slots once per batch by
// destination row (`block_coo_order`), and a warp per row (a thread at
// f = 1) walks its slots in that order, the lanes loading 32 slots' indices
// and weights at once, then reading one coalesced h row per slot. The work
// is 2 * f operations per slot, the parallelism one warp per node row
// instead of one block per block-row, and no shared memory or barrier.
// The order gives each row its items in run order and, within an item,
// its slots in slot order: the sum the TPU kernel forms, taken in one fixed
// order, so two runs give the same bits.
//
// What bounds it on the H100. The function is spmm_rows.cu's: with E slots
// that carry an edge, over rows that read R rows of h,
//   bytes      = E * 8 + (n + 1) * 4 + R * f * 4 + n * f * 4
//   operations = 2 * E * f
// DD's mean batch (~70k edges, f = 32) is bound by bytes at ~1.5-3 us. The
// walk is a chain of dependent reads per row (row pointers, the order, the
// slot, then h), so the kernel is bound by the latency of that chain and
// the number of warps in flight, as the row kernel is; a row the padding
// makes long (the probe's 1,023 w = 0 slots into node n - 1) is walked by
// one warp. The probe's variants split the time (PERF.md).
//
// Every entry returns cudaGetLastError() of its launch.

#include "spmm_slots.cuh"

// out [n_rows, f] = the block-COO SpMM of h over one orientation and its
// slot order (perm [W*eb], row_ptr [n_rows+1]).
extern "C" int spmm_block_coo_f32(const int* row_ptr, const int* perm,
                                  const int* item_c, const int* ls,
                                  const float* w, const float* h, float* out,
                                  int n_rows, int f, int eb, void* stream) {
  return slots::launch_slots<slots::FULL>(row_ptr, perm, item_c, ls, w, h, out,
                                          n_rows, f, eb,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* spmm_block_coo_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
