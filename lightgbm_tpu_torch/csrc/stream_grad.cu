// Score-resident gradients: the row matrix's stream init and the per-tree
// refresh.
//
// stream_init replaces lightgbm_tpu/ops/pallas/stream_grad.py make_init
// (_init_kernel, pallas_call at :784, pack=1): it builds the row matrix
// in original row order from the u8 bins and the per-row aux values --
// bins copied, rid = position, score (boost-from-average included),
// w = validity, the objective's two constants, and the first g*w, h*w.
//
// stream_refresh_plain replaces make_refresh's plain variant
// (_refresh_kernel, pallas_call at :557): per position p, s = score[p] +
// lv[p] is written back and g*w and h*w are recomputed in place from s
// and the row's constants.  The JAX package runs it when the stream
// route is on and the fused split is off (grow.py:782; the 3ph route and
// LGBM_TPU_FUSED=0).  The root-histogram variant (_refresh_hist_kernel,
// pallas_call at :515; at pack=2 :610) is this kernel followed by
// hist_comb's root over [0, n) (ops/stream_grad.stream_refresh): in a
// graph on the H100 the two launches took less time than one kernel
// that refreshed the rows and summed the histogram as it staged them,
// whether its blocks summed features in warps of a shared histogram
// (hist_block.cuh) or through hist_comb's staged walk (hist_walk.cuh)
// with one block owning every feature of its slice (PERF.md).
//
// stream_init_p2 replaces _init_kernel_p2 (pallas_call at :754) over one
// record per row (partition_common.cuh RecPtr) instead of five arrays: it
// builds each block's records in shared memory and writes them as
// 16-byte words.
//
// stream_refresh_plain_p2 replaces _make_refresh_p2's plain variant
// (_refresh_kernel_p2, pallas_call at :652), the refresh of the unfused
// route at pack=2: per record position the plain refresh's update, read
// and written as the record's 4-byte fields in place (score at Fb + 16,
// w at Fb + 8, the constants at Fb + 20; g*w and h*w at Fb).  A 16-byte
// word holding g*w may also hold bin bytes (Fb = 28 at F = 28), so the
// kernel writes only the three fields and never a whole word.  Same
// gradients(), same operation order: the pack=1 plain refresh's bits.
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
// validity, two constants) and writes n * (F + 28).  The plain refresh
// reads n * 20 bytes (score, w, constants, lv) and writes n * 12; it does
// not read the bins.  At pack=2 the init writes n * S bytes of records
// (S = 64 at F = 28).  The plain refresh at pack=2 needs the same 20
// bytes read and 12 written a row, but reaches them as the 32-byte
// sectors that bytes [Fb, Fb + 28) of each record touch (two at F = 28).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of a stream_init_p2 block and the records it builds at a time
// (ops/hist_kernel2.HIST_CHUNK)
constexpr int kThreads = 256;
constexpr int kChunk = 256;

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

// 32-bit words of a staged record: S / 4 + 1, odd, so the rows' threads
// reading the same field hit distinct banks
__host__ __device__ inline int staged_words(int S) { return S / 4 + 1; }

// pack=2 init: each block builds kChunk records at a time in shared
// memory (all bytes zeroed first, so the pads are zero), then writes
// them out as 16-byte words
__global__ void __launch_bounds__(kThreads)
stream_init_p2_kernel(const uint8_t* __restrict__ src_bins,
                      const float* __restrict__ score,
                      const float* __restrict__ valid,
                      const float* __restrict__ consts, int n, int F, int S,
                      int Fb, int kind, float sig,
                      uint8_t* __restrict__ base) {
  extern __shared__ uint32_t recw[];          // [kChunk, SP]
  const int SP = staged_words(S), W = S / 16;
  uint8_t* rb = reinterpret_cast<uint8_t*>(recw);
  for (long long r0 = (long long)blockIdx.x * kChunk; r0 < n;
       r0 += (long long)gridDim.x * kChunk) {
    const int rows = (int)((n - r0) < kChunk ? (n - r0) : kChunk);
    __syncthreads();   // the previous chunk is written out
    for (int i = threadIdx.x; i < rows * SP; i += kThreads) recw[i] = 0u;
    __syncthreads();
    if ((F & 3) == 0) {
      // r0 * F is a multiple of 4: the bins as 32-bit words
      const int fw = F / 4;
      const uint32_t* s32 =
          reinterpret_cast<const uint32_t*>(src_bins + r0 * F);
      for (int i = threadIdx.x; i < rows * fw; i += kThreads) {
        const int r = i / fw;
        recw[r * SP + (i - r * fw)] = s32[i];
      }
    } else {
      const uint8_t* s8 = src_bins + r0 * F;
      for (int i = threadIdx.x; i < rows * F; i += kThreads) {
        const int r = i / F;
        rb[r * SP * 4 + (i - r * F)] = s8[i];
      }
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const long long p = r0 + r;
      const float s = score[p], w = valid[p];
      const float c0 = consts[2 * p], c1 = consts[2 * p + 1];
      float g, h;
      gradients(kind, sig, s, c0, c1, w, &g, &h);
      uint32_t* f = recw + r * SP + Fb / 4;
      f[0] = __float_as_uint(g);
      f[1] = __float_as_uint(h);
      f[2] = __float_as_uint(w);
      f[3] = (uint32_t)(int)p;
      f[4] = __float_as_uint(s);
      f[5] = __float_as_uint(c0);
      f[6] = __float_as_uint(c1);
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(base) + r0 * W;
    for (int i = threadIdx.x; i < rows * W; i += kThreads) {
      const int r = i / W;
      const uint32_t* q = recw + r * SP + 4 * (i - r * W);
      dst[i] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
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

// pack=2 plain refresh: one thread per record, its fields in place
__global__ void stream_refresh_plain_p2_kernel(uint8_t* __restrict__ base,
                                               int S, int Fb,
                                               const float* __restrict__ lv,
                                               int n, int kind, float sig) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < (size_t)n; p += stride) {
    // vals (g*w, h*w, w), rid, score, consts
    float* f = reinterpret_cast<float*>(base + p * S + Fb);
    const float s = f[4] + lv[p];
    float g, h;
    gradients(kind, sig, s, f[5], f[6], f[2], &g, &h);
    f[4] = s;
    f[0] = g;
    f[1] = h;
  }
}

// grid of the plain refreshes: one thread a row, at most 16 blocks an SM
int plain_blocks(int n) {
  long long blocks = ((long long)n + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return (int)blocks;
}

}  // namespace

extern "C" {

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

// The same rows as records: base u8 [n, S] (16-byte aligned), vals at
// byte Fb.
int stream_init_p2(const uint8_t* src_bins, const float* score,
                   const float* valid, const float* consts, int n, int F,
                   int S, int Fb, int kind, float sig, uint8_t* base,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = kChunk * staged_words(S) * 4;
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_init_p2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  long long blocks = ((long long)n + kChunk - 1) / kChunk;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  stream_init_p2_kernel<<<(int)blocks, kThreads, smem, s>>>(
      src_bins, score, valid, consts, n, F, S, Fb, kind, sig, base);
  return (int)cudaGetLastError();
}

// Refresh rows [0, n) in place with the per-position score delta lv [n]:
// score, g*w and h*w; no histogram.
int stream_refresh_plain(float* vals, float* score, const float* consts,
                         const float* lv, int n, int kind, float sig,
                         void* stream) {
  stream_refresh_plain_kernel<<<plain_blocks(n), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      vals, score, consts, lv, n, kind, sig);
  return (int)cudaGetLastError();
}

// The same over records: base u8 [n, S] (16-byte aligned), vals at byte
// Fb.
int stream_refresh_plain_p2(uint8_t* base, int S, int Fb, const float* lv,
                            int n, int kind, float sig, void* stream) {
  stream_refresh_plain_p2_kernel<<<plain_blocks(n), 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      base, S, Fb, lv, n, kind, sig);
  return (int)cudaGetLastError();
}

}  // extern "C"
