// Row-indexed gradient histogram: separate bins and values, read through
// an optional row index.
//
// Replaces lightgbm_tpu/ops/pallas/hist_kernel2.py build_histogram_pallas2
// (_hist2_kernel, pallas_call at :339) and lightgbm_tpu/ops/pallas/
// hist_kernel.py build_histogram_pallas (_hist_kernel, pallas_call at
// :122), which compute one function: hist[f, b, c] = the sum of vals[r, c]
// over the rows r the range selects whose bins[r, f] == b, [F, B, 2] f32.
// The TPU kernels contract nibble one-hots on the MXU (v2 with bf16
// operands); here every (row, feature) adds its exact f32 values into a
// shared-memory histogram, in the order of hist_block.cuh.
//
// Inputs: bins [n, F] row-major, uint8 or uint16 (max_bin > 255); vals
// f32 [n, 2] (g*w, h*w) in original row order; an optional i32 index of
// positions -> rows (the row-order grower's row_order, every entry in
// [0, n)); range i32[2] (start, count) of positions, read from device
// memory so a child range the device computed needs no host read.
// Without an index the positions are the rows.  The JAX package gathers
// the rows (jnp.take) before its kernel; this kernel reads the bins and
// values through the index itself, so a split needs no [count, F] copy.
//
// Determinism: no float atomics.  The position range is cut into grid.x
// slices (histblock::slice, the same cut as hist_kernel2.block_ranges);
// a block stages kChunk positions' row ids, values and bins of its
// features in shared memory and accumulate() adds them in position order.
// The features are split over grid.y (kFeat per block, one per warp) so
// a block's shared histogram is [kFeat, B, 2]: at B = 1024 the whole
// [28, 1024, 2] would need 238,592 bytes, over the 232,448 a block may
// use.  Every cell is the sequential f32 sum of its rows in position
// order whatever the feature split, and a second pass adds the slices'
// partials in slice order, so the plain version
// (hist_kernel2.build_histogram_rows_ref) gives these bits on the CPU.
//
// Bound on this card: bytes.  A launch must read count * (F * bin bytes
// + 8) bytes of bins and values (+ 4 per position through the index) and
// write F * B * 8.  The partials add 2 * grid.x * F * B * 8 bytes; the
// wrapper scales the slice count down with B (rows_blocks) so that at
// B = 1024 the 1M-row root's partials stay near a fifth of its input.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

using histblock::kChunk;
using histblock::kThreads;

// Shared-memory bytes of one block of fc features: hist_block's
// histogram, values and bins, plus the staged row ids.
template <typename BinT>
int block_smem(int fc, int B) {
  return histblock::smem_bytes<BinT>(fc, B) + kChunk * 4;
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_rows_partial(const BinT* __restrict__ bins,
                  const float* __restrict__ vals,
                  const int* __restrict__ index,
                  const int* __restrict__ range, int n_pos, int F, int B,
                  int fc, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int f_lo = blockIdx.y * fc;
  const int fw = (F - f_lo) < fc ? (F - f_lo) : fc;
  const int cells = fw * B * 2;
  float* hist = smem;                                    // [fw, B, 2]
  float* sv = hist + fc * B * 2;                         // [kChunk, 2]
  int* srow = reinterpret_cast<int*>(sv + 2 * kChunk);   // [kChunk]
  BinT* sb = reinterpret_cast<BinT*>(srow + kChunk);     // [kChunk, fw]
  histblock::zero(hist, cells);

  long long lo = (long long)range[0];
  long long hi = lo + (long long)(range[1] > 0 ? range[1] : 0);
  if (lo < 0) lo = 0;
  if (hi > n_pos) hi = n_pos;
  if (hi < lo) hi = lo;
  histblock::slice(lo, hi, gridDim.x, blockIdx.x, &lo, &hi);

  for (long long p0 = lo; p0 < hi; p0 += kChunk) {
    const int rows = (int)((hi - p0) < kChunk ? (hi - p0) : kChunk);
    __syncthreads();   // previous step's readers are done with the staging
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int row = index != nullptr ? index[p0 + r] : (int)(p0 + r);
      srow[r] = row;
      sv[2 * r] = vals[2 * (size_t)row];
      sv[2 * r + 1] = vals[2 * (size_t)row + 1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * fw; i += kThreads) {
      const int r = i / fw;
      sb[i] = bins[(size_t)srow[r] * F + f_lo + (i - r * fw)];
    }
    __syncthreads();
    histblock::accumulate(hist, sb, sv, rows, fw, B);
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * F * B * 2 + (size_t)f_lo * B * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

template <typename BinT>
int launch(const BinT* bins, const float* vals, const int* index,
           const int* range, float* partials, float* out, int n_pos, int F,
           int B, int fc, int nslices, cudaStream_t s) {
  const int smem = block_smem<BinT>(fc, B);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_rows_partial<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(nslices, (F + fc - 1) / fc);
  hist_rows_partial<BinT><<<grid, kThreads, smem, s>>>(
      bins, vals, index, range, n_pos, F, B, fc, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nslices, cells, 1, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of fc features needs; bin_bytes 1 or 2.
int hist_rows_smem_bytes(int fc, int B, int bin_bytes) {
  return bin_bytes == 2 ? block_smem<uint16_t>(fc, B)
                        : block_smem<uint8_t>(fc, B);
}

// bins [n, F] of bin_bytes (1: u8, 2: u16); vals f32 [n, 2]; index i32
// [n_pos] or null (then n_pos = n); range i32[2] (start, count) on the
// device; partials f32 [nslices, F, B, 2] scratch; out f32 [F, B, 2].
// Returns the CUDA error code of the launches (0 on success).
int hist_rows(const void* bins, int bin_bytes, const float* vals,
              const int* index, const int* range, float* partials,
              float* out, int n_pos, int F, int B, int fc, int nslices,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 2)
    return launch(static_cast<const uint16_t*>(bins), vals, index, range,
                  partials, out, n_pos, F, B, fc, nslices, s);
  return launch(static_cast<const uint8_t*>(bins), vals, index, range,
                partials, out, n_pos, F, B, fc, nslices, s);
}

}  // extern "C"
