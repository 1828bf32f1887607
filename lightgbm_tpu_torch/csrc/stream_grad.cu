// Score-resident gradients: the row matrix's stream init and the per-tree
// refresh, with or without the next tree's root histogram.
//
// stream_init replaces lightgbm_tpu/ops/pallas/stream_grad.py make_init
// (_init_kernel, pallas_call at :784, pack=1): it builds the row matrix
// in original row order from the u8 bins and the per-row aux values --
// bins copied, rid = position, score (boost-from-average included),
// w = validity, the objective's two constants, and the first g*w, h*w.
//
// stream_refresh replaces make_refresh's root-histogram variant
// (_refresh_hist_kernel, pallas_call at :515): per position p,
// s = score[p] + lv[p] is written back, g*w and h*w are recomputed in
// place from s and the row's constants, and the NEXT tree's root
// histogram is accumulated from the rows just written.  Its blocks take
// the slices of hist_comb over [0, n) with a grid of hist_blocks(n) and
// add in hist_comb's order (hist_block.cuh), so the histogram is bitwise
// hist_comb's over the refreshed rows.
//
// stream_refresh_plain replaces make_refresh's plain variant
// (_refresh_kernel, pallas_call at :557), which the JAX package runs when
// the stream route is on and the fused split is off (grow.py:782; the 3ph
// route and LGBM_TPU_FUSED=0): the same per-position update, no
// histogram (the next tree's root comes from hist_comb over [0, n)).
//
// Rows: bins u8 [n, F], vals f32 [n, 3] (g*w, h*w, w), rid i32 [n],
// score f32 [n], consts f32 [n, 2]: binary (sign, label_weight), l2
// (target, weight).  The TPU's bf16x3 split of score and constants is a
// matmul-layout choice and is not copied: both are stored f32.
//
// Arithmetic: the port's objectives' operation order (objective/binary.py
// binary_gradients, objective/regression.py l2_gradients), one f32
// rounding per operation, exp in f64 rounded once.  This source builds
// with -fmad=false (ops/_build.py), so nvcc contracts no a*b + c into an
// fma and every product is rounded as PyTorch rounds it.
//
// Bound on this card: bytes.  init reads n * (F + 16) bytes (bins, score,
// validity, two constants) and writes n * (F + 28); the refresh reads
// n * (F + 20) bytes (bins, score, w, constants, lv) and writes n * 12
// (score, g*w, h*w) plus the histogram; the partials add
// 2 * grid * F * B * 8 bytes, as in hist_comb.  The plain refresh reads
// n * 20 bytes (score, w, constants, lv) and writes n * 12; it does not
// read the bins.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

using histblock::kChunk;
using histblock::kThreads;

constexpr int kBinary = 0;
constexpr int kL2 = 1;

// g*w, h*w of one row (objective/binary.py, objective/regression.py)
__device__ __forceinline__ void gradients(int kind, float sig, float s,
                                          float c0, float c1, float w,
                                          float* g, float* h) {
  if (kind == kBinary) {
    // c0 = sign (+-1), c1 = label weight
    const float z = (c0 * sig) * s;
    const float e = (float)exp((double)z);
    const float abs_r = (1.0f / (e + 1.0f)) * sig;
    *g = ((-c0) * abs_r) * c1;
    *h = (abs_r * (sig - abs_r)) * c1;
  } else {
    // c0 = target, c1 = weight
    *g = (s - c0) * c1;
    *h = c1;
  }
  *g = *g * w;
  *h = *h * w;
}

__global__ void stream_init_kernel(const uint8_t* __restrict__ src_bins,
                                   const float* __restrict__ score,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ consts, int n,
                                   int F, int kind, float sig,
                                   uint8_t* __restrict__ bins,
                                   float* __restrict__ vals,
                                   int* __restrict__ rid,
                                   float* __restrict__ rscore,
                                   float* __restrict__ rconsts) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((F & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src_bins);
    uint32_t* d = reinterpret_cast<uint32_t*>(bins);
    for (size_t i = t0; i < (size_t)n * (F / 4); i += stride) d[i] = s[i];
  } else {
    for (size_t i = t0; i < (size_t)n * F; i += stride) bins[i] = src_bins[i];
  }
  for (size_t p = t0; p < (size_t)n; p += stride) {
    const float s = score[p], w = valid[p];
    const float c0 = consts[2 * p], c1 = consts[2 * p + 1];
    float g, h;
    gradients(kind, sig, s, c0, c1, w, &g, &h);
    vals[3 * p] = g;
    vals[3 * p + 1] = h;
    vals[3 * p + 2] = w;
    rid[p] = (int)p;
    rscore[p] = s;
    rconsts[2 * p] = c0;
    rconsts[2 * p + 1] = c1;
  }
}

__global__ void __launch_bounds__(kThreads)
stream_refresh_partial(const uint8_t* __restrict__ bins,
                       float* __restrict__ vals, float* __restrict__ score,
                       const float* __restrict__ consts,
                       const float* __restrict__ lv, int n, int F, int B,
                       int kind, float sig, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int cells = F * B * 2;
  float* hist = smem;                         // [F, B, 2]
  float* sv = hist + cells;                   // [kChunk, 2] (g*w, h*w)
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + 2 * kChunk);  // [kChunk, F]
  histblock::zero(hist, cells);
  long long lo, hi;
  histblock::slice(0, n, gridDim.x, blockIdx.x, &lo, &hi);
  for (long long r0 = lo; r0 < hi; r0 += kChunk) {
    const int rows = (int)((hi - r0) < kChunk ? (hi - r0) : kChunk);
    __syncthreads();   // previous step's readers are done with sb / sv
    const uint8_t* src = bins + r0 * F;
    for (int i = threadIdx.x; i < rows * F; i += kThreads) sb[i] = src[i];
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const long long p = r0 + r;
      const float s = score[p] + lv[p];
      float g, h;
      gradients(kind, sig, s, consts[2 * p], consts[2 * p + 1],
                vals[3 * p + 2], &g, &h);
      score[p] = s;
      vals[3 * p] = g;
      vals[3 * p + 1] = h;
      sv[2 * r] = g;
      sv[2 * r + 1] = h;
    }
    __syncthreads();
    histblock::accumulate(hist, sb, sv, rows, F, B);
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

__global__ void stream_refresh_plain_kernel(float* __restrict__ vals,
                                            float* __restrict__ score,
                                            const float* __restrict__ consts,
                                            const float* __restrict__ lv,
                                            int n, int kind, float sig) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < (size_t)n; p += stride) {
    const float s = score[p] + lv[p];
    float g, h;
    gradients(kind, sig, s, consts[2 * p], consts[2 * p + 1], vals[3 * p + 2],
              &g, &h);
    score[p] = s;
    vals[3 * p] = g;
    vals[3 * p + 1] = h;
  }
}

}  // namespace

extern "C" {

int stream_refresh_smem_bytes(int F, int B) {
  return histblock::smem_bytes(F, B);
}

// The row matrix (bins, vals, rid, score, rconsts) from src_bins [n, F]
// and the aux values score, valid [n] and consts [n, 2].  kind 0 binary,
// 1 l2.  Returns the CUDA error code (0 on success).
int stream_init(const uint8_t* src_bins, const float* score,
                const float* valid, const float* consts, int n, int F,
                int kind, float sig, uint8_t* bins, float* vals, int* rid,
                float* rscore, float* rconsts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long work = (long long)n * (F > 4 ? F / 4 : 1);
  int blocks = (int)((work + 255) / 256);
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  stream_init_kernel<<<blocks, 256, 0, s>>>(src_bins, score, valid, consts,
                                            n, F, kind, sig, bins, vals, rid,
                                            rscore, rconsts);
  return (int)cudaGetLastError();
}

// Refresh rows [0, n) in place with the per-position score delta lv [n]
// and write the next tree's root histogram [F, B, 2] to out; partials f32
// [nblocks, F, B, 2] scratch, nblocks = hist_blocks(n).
int stream_refresh(const uint8_t* bins, float* vals, float* score,
                   const float* consts, const float* lv, int n, int F, int B,
                   int kind, float sig, float* partials, float* out,
                   int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = histblock::smem_bytes(F, B);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_refresh_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  stream_refresh_partial<<<nblocks, kThreads, smem, s>>>(
      bins, vals, score, consts, lv, n, F, B, kind, sig, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nblocks, cells, 1, out);
  return (int)cudaGetLastError();
}

// Refresh rows [0, n) in place with the per-position score delta lv [n]:
// score, g*w and h*w; no histogram.
int stream_refresh_plain(float* vals, float* score, const float* consts,
                         const float* lv, int n, int kind, float sig,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = (int)(((long long)n + 255) / 256);
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  stream_refresh_plain_kernel<<<blocks, 256, 0, s>>>(vals, score, consts, lv,
                                                     n, kind, sig);
  return (int)cudaGetLastError();
}

}  // extern "C"
