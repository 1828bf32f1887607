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
// kChunk rows of bins and values in shared memory, and each warp OWNS a
// fixed set of features, so every (feature, bin) cell of the block's
// shared histogram is written by one warp only.  Inside a 32-row tile
// the lanes holding the same bin form a group (__match_any_sync), and the
// group's lowest lane adds the group's values into the cell one by one in
// lane order.  So each cell of a block's partial histogram is the
// sequential f32 sum of its rows in row order, an order the plain
// version (hist_kernel2.build_histogram_comb_ref) reproduces exactly.
// Each block writes its partial out; pass 2 sums the partials of every
// cell in block order, starting from 0.
//
// Bound on this card: bytes.  Each launch must read count * (F + 8)
// bytes of rows (bins and the two value columns used) and write
// F * B * 8 bytes; the partials add 2 * grid * F * B * 8 bytes of
// traffic, the price of determinism.  Shared memory per block is
// F*B*8 + kChunk*(F + 8) bytes (66,560 at F=28, B=256), above the 48 KB
// default, so the launch opts in with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;     // rows staged in shared memory per step

__device__ __forceinline__ void block_range(const int* range, int n_rows,
                                            long long* lo_out,
                                            long long* hi_out) {
  long long lo = (long long)range[0] + (long long)range[1];
  long long hi = lo + (long long)(range[2] > 0 ? range[2] : 0);
  if (lo < 0) lo = 0;
  if (hi > n_rows) hi = n_rows;
  if (hi < lo) hi = lo;
  long long total = hi - lo;
  long long per = (total + gridDim.x - 1) / gridDim.x;
  per = (per + 31) / 32 * 32;
  long long b_lo = lo + per * blockIdx.x;
  long long b_hi = b_lo + per;
  if (b_lo > hi) b_lo = hi;
  if (b_hi > hi) b_hi = hi;
  *lo_out = b_lo;
  *hi_out = b_hi;
}

__global__ void __launch_bounds__(kThreads)
hist_comb_partial(const uint8_t* __restrict__ bins,
                  const float* __restrict__ vals,
                  const int* __restrict__ range, int n_rows, int F, int B,
                  float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int cells = F * B * 2;
  float* hist = smem;                         // [F, B, 2]
  float* sv = hist + cells;                   // [kChunk, 2] (g, h)
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + 2 * kChunk);  // [kChunk, F]
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0.f;

  long long lo, hi;
  block_range(range, n_rows, &lo, &hi);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (long long r0 = lo; r0 < hi; r0 += kChunk) {
    const int rows = (int)((hi - r0) < kChunk ? (hi - r0) : kChunk);
    __syncthreads();   // previous step's readers are done with sb / sv
    const uint8_t* src = bins + r0 * F;
    for (int i = threadIdx.x; i < rows * F; i += kThreads) sb[i] = src[i];
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      sv[2 * r] = vals[(r0 + r) * 3];
      sv[2 * r + 1] = vals[(r0 + r) * 3 + 1];
    }
    __syncthreads();
    for (int f = warp; f < F; f += kWarps) {
      float* hf = hist + f * B * 2;
      for (int t = 0; t < rows; t += 32) {
        const int r = t + lane;
        const int bin = r < rows ? (int)sb[r * F + f] : 0;
        const bool live = r < rows && bin < B;
        // dead lanes get keys no live lane can hold, so each is alone
        const unsigned peers = __match_any_sync(0xffffffffu,
                                                live ? bin : 0x10000 + lane);
        if (live && (__ffs(peers) - 1) == lane) {
          // the cell takes the group's values one by one in lane (= row)
          // order, so every cell of the block is a sequential f32 sum of
          // its rows in row order
          float g = hf[2 * bin], h = hf[2 * bin + 1];
          unsigned m = peers;
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            g += sv[2 * (t + j)];
            h += sv[2 * (t + j) + 1];
          }
          hf[2 * bin] = g;
          hf[2 * bin + 1] = h;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

__global__ void hist_comb_reduce(const float* __restrict__ partials,
                                 int nblocks, int cells,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * cells + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the first pass needs.
int hist_comb_smem_bytes(int F, int B) {
  return F * B * 2 * 4 + kChunk * 2 * 4 + kChunk * F;
}

// bins u8 [n_rows, F]; vals f32 [n_rows, 3]; range i32[3] on the device;
// partials f32 [nblocks, F, B, 2] scratch; out f32 [F, B, 2].
// Returns the CUDA error code of the launches (0 on success).
int hist_comb(const uint8_t* bins, const float* vals, const int* range,
              float* partials, float* out, int n_rows, int F, int B,
              int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = hist_comb_smem_bytes(F, B);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_comb_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  hist_comb_partial<<<nblocks, kThreads, smem, s>>>(bins, vals, range,
                                                    n_rows, F, B, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  hist_comb_reduce<<<(cells + 255) / 256, 256, 0, s>>>(partials, nblocks,
                                                       cells, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
