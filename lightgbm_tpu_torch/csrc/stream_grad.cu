// Score-resident gradients: the row matrix's stream init and the per-tree
// refresh.
//
// stream_init replaces lightgbm_tpu/ops/pallas/stream_grad.py make_init
// (_init_kernel, pallas_call at :784, pack=1): it builds the row matrix
// in original row order from the u8 bins and the per-row aux values --
// bins copied, rid = position, score (boost-from-average included),
// w = validity, the objective's two constants, and the first g*w, h*w.
// It runs once a training and once a checkpoint save (the re-anchor of
// the carried row order).
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
// Design of the pack=1 init: it is memory-bound, and the card reaches
// its bound only with enough bytes in flight.  It copies the bins as
// 16-byte words of the flat n * F array over the whole grid (a byte tail
// past the last word), then builds the fields 4 rows a thread: score and
// validity one 16-byte load each, the constants two, all issued before
// the f64 exp chain, and vals (three), rid, score and the constants
// stored as 16-byte words.  Its grid is two waves (the occupancy API
// times the SMs).  The rows past the last whole group, and every row
// when a pointer is not 16-byte aligned, take 4-byte loads and stores.
// On the H100 this took less time than a warp a tile of 128 rows doing
// both, and than the 4-byte copy it replaced.  The plain refresh keeps
// a row a thread on plain_blocks' grid: the same design at 2 and 4 rows
// a thread took longer, and a row a thread in whole waves gained nothing
// (PERF.md).  The arithmetic is gradients() in the same order, so the
// bits are the plain versions'.
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

// threads of a block, and the records a stream_init_p2 block builds at
// a time (ops/hist_kernel2.HIST_CHUNK)
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

// waves of the init's grid (one wave fills every SM once)
constexpr int kInitWaves = 2;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// one row of the init, 4-byte fields (the tail rows and the unaligned
// path)
__device__ __forceinline__ void init_row(size_t p, const float* score,
                                         const float* valid,
                                         const float* consts, int kind,
                                         float sig, float* vals, int* rid,
                                         float* rscore, float* rconsts) {
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

// the init's fields of the 4 rows from p (p a multiple of 4, every
// pointer 16-byte aligned), as 16-byte words
__device__ __forceinline__ void init_group(long long p,
                                           const float* __restrict__ score,
                                           const float* __restrict__ valid,
                                           const float* __restrict__ consts,
                                           int kind, float sig,
                                           float* __restrict__ vals,
                                           int* __restrict__ rid,
                                           float* __restrict__ rscore,
                                           float* __restrict__ rconsts) {
  const float4 s4 = reinterpret_cast<const float4*>(score)[p / 4];
  const float4 v4 = reinterpret_cast<const float4*>(valid)[p / 4];
  const float4 ca = reinterpret_cast<const float4*>(consts)[p / 2];
  const float4 cb = reinterpret_cast<const float4*>(consts)[p / 2 + 1];
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  const float w[4] = {v4.x, v4.y, v4.z, v4.w};
  const float c0[4] = {ca.x, ca.z, cb.x, cb.z};
  const float c1[4] = {ca.y, ca.w, cb.y, cb.w};
  float g[4], h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    gradients(kind, sig, s[k], c0[k], c1[k], w[k], &g[k], &h[k]);
  float4* vw = reinterpret_cast<float4*>(vals) + 3 * (p / 4);
  vw[0] = make_float4(g[0], h[0], w[0], g[1]);
  vw[1] = make_float4(h[1], w[1], g[2], h[2]);
  vw[2] = make_float4(w[2], g[3], h[3], w[3]);
  reinterpret_cast<int4*>(rid)[p / 4] =
      make_int4((int)p, (int)p + 1, (int)p + 2, (int)p + 3);
  reinterpret_cast<float4*>(rscore)[p / 4] = s4;
  reinterpret_cast<float4*>(rconsts)[p / 2] = ca;
  reinterpret_cast<float4*>(rconsts)[p / 2 + 1] = cb;
}

// The init: the bins as 16-byte words of the flat array over the grid,
// then the fields a group of 4 rows a thread (init_group); !vec (a
// pointer not 16-byte aligned): every row and byte 4 and 1 bytes at a
// time.  The bound of kThreads threads a block lets ptxas give a thread
// the registers to keep a group's four exps in flight (84, 3 blocks an
// SM); without it ptxas held it to 61, and on the H100 the init took
// 0.0381 ms at 1M x 28 against this build's 0.0357, L2 flushed by a read
// (PERF.md).
__global__ void __launch_bounds__(kThreads, 1)
stream_init_kernel(const uint8_t* __restrict__ src_bins,
                   const float* __restrict__ score,
                   const float* __restrict__ valid,
                   const float* __restrict__ consts, int n, int F, int kind,
                   float sig, int vec, uint8_t* __restrict__ bins,
                   float* __restrict__ vals, int* __restrict__ rid,
                   float* __restrict__ rscore, float* __restrict__ rconsts) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nb = (long long)n * F, words = vec ? nb / 16 : 0;
  for (long long i = tid; i < words; i += stride)
    reinterpret_cast<uint4*>(bins)[i] =
        reinterpret_cast<const uint4*>(src_bins)[i];
  for (long long i = words * 16 + tid; i < nb; i += stride)
    bins[i] = src_bins[i];
  const long long groups = vec ? n / 4 : 0;
  for (long long q = tid; q < groups; q += stride)
    init_group(4 * q, score, valid, consts, kind, sig, vals, rid, rscore,
               rconsts);
  for (long long p = groups * 4 + tid; p < n; p += stride)
    init_row((size_t)p, score, valid, consts, kind, sig, vals, rid, rscore,
             rconsts);
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

// blocks of the init: kInitWaves times the blocks that fill every SM of
// the current device once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, cached by device); at most `need` and at least 1.  0 with the
// error in *err.
int init_blocks(long long need, cudaError_t* err) {
  constexpr int kDevices = 64;
  static int wave[kDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  int w = dev < kDevices ? wave[dev] : 0;
  if (w == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_init_kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    w = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) wave[dev] = w;
  }
  const long long most = (long long)w * kInitWaves;
  if (need < 1) need = 1;
  return (int)(need < most ? need : most);
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
  const int vec = aligned16(src_bins) && aligned16(score) &&
                  aligned16(valid) && aligned16(consts) && aligned16(bins) &&
                  aligned16(vals) && aligned16(rid) && aligned16(rscore) &&
                  aligned16(rconsts);
  // a thread a 16-byte word of bins, then a group of 4 rows
  const long long items = ((long long)n * F + 15) / 16;
  const long long need = (items + kThreads - 1) / kThreads;
  cudaError_t e;
  const int blocks = init_blocks(need, &e);
  if (blocks == 0) return (int)e;
  stream_init_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src_bins, score, valid, consts, n, F, kind, sig, vec, bins, vals, rid,
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
