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
// stream_init_p2 and stream_refresh_p2 are the same functions at pack=2
// (_init_kernel_p2, pallas_call at :754; _refresh_hist_kernel_p2,
// pallas_call at :610), over one record per row (partition_common.cuh
// RecPtr) instead of five arrays: the init builds each block's records
// in shared memory and writes them as 16-byte words; the refresh loads
// its chunk's records as 16-byte words (consecutive threads on
// consecutive words) into shared memory, at a stride of S + 4 bytes so
// the thread of each row reads its fields without bank conflicts,
// updates score, g*w and h*w there and writes back the 16-byte words
// that hold them (bytes [Fb, Fb + 20), 32 of 64 at F = 28).  The
// arithmetic, the slices and the histogram's order of additions are the
// pack=1 kernels': the same rows get the same bits.
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
// validity, two constants) and writes n * (F + 28); the refresh reads
// n * (F + 20) bytes (bins, score, w, constants, lv) and writes n * 12
// (score, g*w, h*w) plus the histogram; the partials add
// 2 * grid * F * B * 8 bytes, as in hist_comb.  The plain refresh reads
// n * 20 bytes (score, w, constants, lv) and writes n * 12; it does not
// read the bins.  At pack=2 the init writes n * S bytes of records
// (S = 64 at F = 28) and the refresh reads n * (Fb + 28) and writes the
// 16-byte words holding score, g*w and h*w.  The plain refresh at pack=2
// needs the same 20 bytes read and 12 written a row, but reaches them as
// the 32-byte sectors that bytes [Fb, Fb + 28) of each record touch (two
// at F = 28).
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

// The read-only inputs of a refresh (bins, consts, lv) are loaded
// through the read-only data path (__ldg): pointers inside a struct
// argument are not restrict-qualified, and nvcc does not choose that
// path for them itself.

// pack=1 refresh of rows [r0, r0 + rows): bins into sb, then per row
// the update, in place, and (g*w, h*w) into sv
struct RefreshRows {
  const uint8_t* bins;
  float* vals;
  float* score;
  const float* consts;
  __device__ __forceinline__ void refresh(long long r0, int rows, int F,
                                          const float* lv, int kind,
                                          float sig, uint8_t* sb, float* sv,
                                          uint32_t*) const {
    const uint8_t* src = bins + r0 * F;
    for (int i = threadIdx.x; i < rows * F; i += kThreads)
      sb[i] = __ldg(src + i);
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const long long p = r0 + r;
      const float s = score[p] + __ldg(lv + p);
      float g, h;
      gradients(kind, sig, s, __ldg(consts + 2 * p),
                __ldg(consts + 2 * p + 1), vals[3 * p + 2], &g, &h);
      score[p] = s;
      vals[3 * p] = g;
      vals[3 * p + 1] = h;
      sv[2 * r] = g;
      sv[2 * r + 1] = h;
    }
  }
};

// 32-bit words of a staged record: S / 4 + 1, odd, so the rows' threads
// reading the same field hit distinct banks
__host__ __device__ inline int staged_words(int S) { return S / 4 + 1; }

// pack=2 refresh of records [r0, r0 + rows) through rec [rows, SP] u32
struct RefreshRecords {
  uint8_t* base;
  int S, Fb;
  __device__ __forceinline__ void refresh(long long r0, int rows, int F,
                                          const float* lv, int kind,
                                          float sig, uint8_t* sb, float* sv,
                                          uint32_t* rec) const {
    const int W = S / 16, SP = staged_words(S);
    const int Wh = histblock::record_hist_words(Fb);
    uint4* src = reinterpret_cast<uint4*>(base) + r0 * W;
    for (int i = threadIdx.x; i < rows * W; i += kThreads) {
      const int r = i / W, w = i - r * W;
      const uint4 v = src[i];
      uint32_t* q = rec + r * SP + 4 * w;
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
      if (w < Wh) histblock::stage_record_word(v, w, F, Fb, sb + r * F,
                                               sv + 2 * r);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      uint32_t* f = rec + r * SP + Fb / 4;   // vals, rid, score, consts
      const float s = __uint_as_float(f[4]) + __ldg(lv + r0 + r);
      float g, h;
      gradients(kind, sig, s, __uint_as_float(f[5]), __uint_as_float(f[6]),
                __uint_as_float(f[2]), &g, &h);
      f[4] = __float_as_uint(s);
      f[0] = __float_as_uint(g);
      f[1] = __float_as_uint(h);
      sv[2 * r] = g;
      sv[2 * r + 1] = h;
    }
    __syncthreads();
    // the words holding g*w, h*w and score: bytes [Fb, Fb + 20)
    const int w_lo = Fb / 16, nw = (Fb + 20 + 15) / 16 - w_lo;
    for (int i = threadIdx.x; i < rows * nw; i += kThreads) {
      const int r = i / nw, w = w_lo + (i - r * nw);
      const uint32_t* q = rec + r * SP + 4 * w;
      src[r * W + w] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
};

template <class Src>
__global__ void __launch_bounds__(kThreads)
stream_refresh_partial(Src rows_src, const float* __restrict__ lv, int n,
                       int F, int B, int kind, float sig,
                       float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int cells = F * B * 2;
  float* hist = smem;                         // [F, B, 2]
  float* sv = hist + cells;                   // [kChunk, 2] (g*w, h*w)
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + 2 * kChunk);  // [kChunk, F]
  // pack=2 staging [kChunk, staged_words(S)] after sb (kChunk * F is a
  // multiple of 4)
  uint32_t* rec = reinterpret_cast<uint32_t*>(sb + kChunk * F);
  histblock::zero(hist, cells);
  long long lo, hi;
  histblock::slice(0, n, gridDim.x, blockIdx.x, &lo, &hi);
  for (long long r0 = lo; r0 < hi; r0 += kChunk) {
    const int rows = (int)((hi - r0) < kChunk ? (hi - r0) : kChunk);
    __syncthreads();   // previous step's readers are done with sb / sv
    rows_src.refresh(r0, rows, F, lv, kind, sig, sb, sv, rec);
    __syncthreads();
    histblock::accumulate(hist, sb, sv, rows, F, B);
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

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

// shared-memory bytes of a refresh block; S = 0 at pack=1
int refresh_smem(int F, int B, int S) {
  return histblock::smem_bytes(F, B) + (S ? kChunk * staged_words(S) * 4 : 0);
}

// the refresh's two passes; 0 or the CUDA error code
template <class Src>
int refresh_launch(Src rows_src, const float* lv, int n, int F, int B,
                   int S, int kind, float sig, float* partials, float* out,
                   int nblocks, cudaStream_t s) {
  const int smem = refresh_smem(F, B, S);
  static int smem_set = 0;   // one per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_refresh_partial<Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  stream_refresh_partial<Src><<<nblocks, kThreads, smem, s>>>(
      rows_src, lv, n, F, B, kind, sig, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nblocks, cells, 1, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of a refresh block: S = 0 at pack=1, the record
// stride at pack=2.
int stream_refresh_smem_bytes(int F, int B, int S) {
  return refresh_smem(F, B, S);
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

// Refresh rows [0, n) in place with the per-position score delta lv [n]
// and write the next tree's root histogram [F, B, 2] to out; partials f32
// [nblocks, F, B, 2] scratch, nblocks = hist_blocks(n).
int stream_refresh(const uint8_t* bins, float* vals, float* score,
                   const float* consts, const float* lv, int n, int F, int B,
                   int kind, float sig, float* partials, float* out,
                   int nblocks, void* stream) {
  return refresh_launch(RefreshRows{bins, vals, score, consts}, lv, n, F, B,
                        0, kind, sig, partials, out, nblocks,
                        static_cast<cudaStream_t>(stream));
}

// The same over records: base u8 [n, S] (16-byte aligned), vals at byte
// Fb.
int stream_refresh_p2(uint8_t* base, int S, int Fb, const float* lv, int n,
                      int F, int B, int kind, float sig, float* partials,
                      float* out, int nblocks, void* stream) {
  return refresh_launch(RefreshRecords{base, S, Fb}, lv, n, F, B, S, kind,
                        sig, partials, out, nblocks,
                        static_cast<cudaStream_t>(stream));
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
