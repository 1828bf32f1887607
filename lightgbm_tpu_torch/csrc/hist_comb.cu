// Comb-direct gradient histogram over a contiguous range of the
// physically partitioned row matrix.
//
// Replaces lightgbm_tpu/ops/pallas/hist_kernel2.py build_histogram_comb /
// build_histogram_comb_dyn (_comb_hist_call, pallas_call at :225): the
// (sum g*w, sum h*w) histogram [F, B, 2] f32 of rows
// [start + off, start + off + count) of the row matrix, rows outside the
// range (and outside the matrix) contributing nothing.  The TPU kernel
// contracts nibble one-hots on the MXU; here every (row, feature) adds
// its values into a shared-memory histogram.
//
// Rows: bins u8 [n, F] row-major, vals f32 [n, 3] (g*w, h*w, w).  The
// range is read from device memory (int32[3]: start, off, count), so a
// child range computed on the device needs no host round trip; the grid
// is sized by the caller's upper bound on count.
//
// Determinism (the output is bitwise identical across launches on the
// same input): no float atomics.  Pass 1: each block takes a fixed slice
// of the range (a function of count and the grid size only), stages
// kChunk rows of bins and values in shared memory and adds them to its
// shared histogram in row order (hist_block.cuh, shared with the stream
// refresh and the fused split, which reproduce these bits).  Each block
// writes its partial out; pass 2 sums the partials of every cell in
// block order, starting from 0.
//
// hist_comb_p2 replaces the same pallas_call at pack=2
// (_hist2_comb2_kernel, hist_kernel2.py:144, which unpacks both halves of
// a 128-lane line): the same histogram of the same logical rows, read
// from the pack=2 records (partition_common.cuh RecPtr).  Only the
// staging differs: each block loads the 16-byte words of its chunk's
// records that hold bins and (g*w, h*w) (bytes [0, Fb + 8), 48 of 64 at
// F = 28) with uint4 loads, consecutive threads on consecutive words,
// and stage_record_word writes them to the same shared rows; slices,
// accumulation and the reduction are the pack=1 kernel's, so the two
// histograms are bitwise equal.
//
// Feature chunks: the features are cut into chunks of fc (the wrapper's
// hist_kernel2.comb_feature_chunk, sized so that five blocks share an
// SM) and the grid is (nblocks, ceil(F / fc)).
// Block (x, y) stages and sums features [y fc, min(F, (y + 1) fc)) of
// slice x and writes them into partials[x, y fc : ...], as
// hist_rows_partial does.  Every cell is still the f32 sum of its rows
// in row order within its slice, so the bits do not depend on fc; at
// F <= fc the grid, the shared layout and the staging are those of one
// chunk, the kernel before the chunking.
//
// Bound on this card: bytes.  Each launch must read count * (F + 8)
// bytes of rows (bins and the two value columns used) and write
// F * B * 8 bytes; the partials add 2 * grid * F * B * 8 bytes of
// traffic, the price of determinism, and every chunk reads the value
// columns again.  Shared memory per block is fc*B*8 + kChunk*(fc + 8)
// bytes (34,304 at F = 28, B = 256, two chunks of 14; 41,216 at
// F = 136, eight chunks of 17), which may pass the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

using histblock::kChunk;
using histblock::kThreads;

// The launch only reads the rows, so every global load takes the
// read-only data path (__ldg): a pointer inside a struct argument is not
// restrict-qualified, and nvcc does not choose that path for it itself
// (hist_comb took 4 % longer without it on the H100).

// Each source stages rows [r0, r0 + rows): the bins of features
// [f_lo, f_lo + fw) into sb [rows, fw] and (g*w, h*w) into sv [rows, 2].
// A chunk may start at any byte: staging reads single bytes.

// pack=1: bins u8 [n, F] and vals f32 [n, 3]
struct CombRows {
  const uint8_t* bins;
  const float* vals;
  __device__ __forceinline__ void stage(long long r0, int rows, int F,
                                        int f_lo, int fw, uint8_t* sb,
                                        float* sv) const {
    const uint8_t* src = bins + r0 * F;
    if (fw == F) {
      for (int i = threadIdx.x; i < rows * F; i += kThreads)
        sb[i] = __ldg(src + i);
    } else {
      for (int i = threadIdx.x; i < rows * fw; i += kThreads) {
        const int r = i / fw;
        sb[i] = __ldg(src + (long long)r * F + f_lo + (i - r * fw));
      }
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      sv[2 * r] = __ldg(vals + (r0 + r) * 3);
      sv[2 * r + 1] = __ldg(vals + (r0 + r) * 3 + 1);
    }
  }
};

// pack=2: records of S bytes, vals at byte Fb
struct CombRecords {
  const uint8_t* base;
  int S, Fb;
  __device__ __forceinline__ void stage(long long r0, int rows, int F,
                                        int f_lo, int fw, uint8_t* sb,
                                        float* sv) const {
    if (fw == F) {
      const int W = S / 16, Wh = histblock::record_hist_words(Fb);
      const uint4* src = reinterpret_cast<const uint4*>(base + r0 * S);
      for (int i = threadIdx.x; i < rows * Wh; i += kThreads) {
        const int r = i / Wh, w = i - r * Wh;
        histblock::stage_record_word(__ldg(src + r * W + w), w, F, Fb,
                                     sb + r * F, sv + 2 * r);
      }
      return;
    }
    // one chunk of the features (every record layout above the one-chunk
    // width, F = 28 included): single bytes of each record
    const uint8_t* src = base + r0 * S;
    for (int i = threadIdx.x; i < rows * fw; i += kThreads) {
      const int r = i / fw;
      sb[i] = __ldg(src + (long long)r * S + f_lo + (i - r * fw));
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float* v = reinterpret_cast<const float*>(src + (long long)r * S
                                                      + Fb);
      sv[2 * r] = __ldg(v);
      sv[2 * r + 1] = __ldg(v + 1);
    }
  }
};

template <class Src>
__global__ void __launch_bounds__(kThreads)
hist_comb_partial(Src rows_src, const int* __restrict__ range, int n_rows,
                  int F, int B, int fc, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int f_lo = blockIdx.y * fc;
  const int fw = (F - f_lo) < fc ? (F - f_lo) : fc;
  const int cells = fw * B * 2;
  float* hist = smem;                         // [fw, B, 2]
  float* sv = hist + fc * B * 2;              // [kChunk, 2] (g, h)
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + 2 * kChunk);  // [kChunk, fw]
  histblock::zero(hist, cells);

  long long lo = (long long)range[0] + (long long)range[1];
  long long hi = lo + (long long)(range[2] > 0 ? range[2] : 0);
  if (lo < 0) lo = 0;
  if (hi > n_rows) hi = n_rows;
  if (hi < lo) hi = lo;
  histblock::slice(lo, hi, gridDim.x, blockIdx.x, &lo, &hi);

  for (long long r0 = lo; r0 < hi; r0 += kChunk) {
    const int rows = (int)((hi - r0) < kChunk ? (hi - r0) : kChunk);
    __syncthreads();   // previous step's readers are done with sb / sv
    rows_src.stage(r0, rows, F, f_lo, fw, sb, sv);
    __syncthreads();
    histblock::accumulate(hist, sb, sv, rows, fw, B);
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * F * B * 2
               + (size_t)f_lo * B * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

// the two passes over range of rows_src; 0 or the CUDA error code
template <class Src>
int launch(Src rows_src, const int* range, float* partials, float* out,
           int n_rows, int F, int B, int fc, int nblocks, cudaStream_t s) {
  if (fc < 1 || fc > F) return (int)cudaErrorInvalidValue;
  const int smem = histblock::smem_bytes(fc, B);
  static int smem_set = 0;   // one per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_comb_partial<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(nblocks, (F + fc - 1) / fc);
  hist_comb_partial<Src><<<grid, kThreads, smem, s>>>(
      rows_src, range, n_rows, F, B, fc, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nblocks, cells, 1, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the first pass needs for a chunk of
// fc features (either pack).
int hist_comb_smem_bytes(int fc, int B) {
  return histblock::smem_bytes(fc, B);
}

// bins u8 [n_rows, F]; vals f32 [n_rows, 3]; range i32[3] on the device;
// fc features per block (hist_kernel2.comb_feature_chunk); partials f32
// [nblocks, F, B, 2] scratch; out f32 [F, B, 2].
// Returns the CUDA error code of the launches (0 on success).
int hist_comb(const uint8_t* bins, const float* vals, const int* range,
              float* partials, float* out, int n_rows, int F, int B, int fc,
              int nblocks, void* stream) {
  return launch(CombRows{bins, vals}, range, partials, out, n_rows, F, B,
                fc, nblocks, static_cast<cudaStream_t>(stream));
}

// The same over records: base u8 [n_rows, S] (16-byte aligned), F bins
// per record, vals at byte Fb.
int hist_comb_p2(const uint8_t* base, int S, int Fb, const int* range,
                 float* partials, float* out, int n_rows, int F, int B,
                 int fc, int nblocks, void* stream) {
  return launch(CombRecords{base, S, Fb}, range, partials, out, n_rows, F,
                B, fc, nblocks, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
