// Launch-cost probes: the port's counterparts of the TPU microbenchmark
// kernels under tools/.  Each computes a small, exactly checkable
// function; what they measure is the cost of a launch, a block, a
// shared-memory access, an asynchronous copy and a barrier wait on this
// card.
//
// select_update replaces tools/profile_pallas_ov.py _select_kernel
// (pallas_call at :40), 254 of which run inside a fori_loop there: one
// block, in place on leafs f32 [255, 20] (the TPU kernel aliases input
// 0 to output 0), and sel f32 [8]:
//   leaf = argmax(leafs[:, 0])    first index of the maximum, a NaN
//                                 counting as the maximum (jnp.argmax)
//   row  = sum_r leafs[r] * onehot[r]    (the TPU kernel's masked sum:
//          leafs[leaf] + 0 where every other row of a column is finite,
//          NaN where another row holds an inf or a NaN; -0 becomes +0)
//   leafs = leafs + onehot * ((row + 1) - row) * onehot   in this f32
//          order (not row + 1: the two differ at large magnitudes, and
//          an inf or a NaN in the chosen row reaches every row)
//   sel  = [leaf, row[0], 0, 0, 0, 0, 0, 0]
// Each of these sums has one term that is not a signed zero, so its
// value does not depend on the order of the additions.  The arithmetic
// uses the _rn intrinsics, which nvcc never contracts into an fma.
// Bound on this card: the launch.  A launch reads and writes 20,400
// bytes (about 0.012 us at 3.35 TB/s) and does ~15,000 operations.  The
// block stages the array in static shared memory once and reads it
// there.  select_update_loop launches the kernel k times from C, so a
// probe can tell the Python wrapper's cost from the launch's.
//
// step_cost_kernel<V> replaces tools/profile_step_cost.py kern
// (pallas_call at :86), a grid of nb = n / 512 steps over rows f32
// [n, 128] with sel i32 [2] = (0, n) in SMEM and one i32 output.  The
// TPU runs the steps in order and carries the output in SMEM; here one
// block stands for one step, the blocks run in parallel, and each adds
// its share to the output with an integer atomicAdd (unsigned, so it
// wraps: the result has the sequential sum's bits).  The variants:
//   kEmpty   the output is sel[0], written once;
//   kSmemrw  sel[0] + sum_blk (blk + floor(sel[1] / (blk + 1))), each
//            step's three scalar reads and writes through volatile
//            shared memory, so nvcc keeps them (static shared memory);
//   kDmaNw   each block copies its 512 x 128 f32 tile (256 KiB, more
//            than one block's 227 KB) into shared memory in four 64 KiB
//            pieces, issuing one and waiting for it before the next;
//            the output is sel[0] + nb;
//   kWaits   one mbarrier arrive and a wait on that phase per block,
//            standing in for the semaphore signal and wait; sel[0] + nb.
// stream_tiles replaces the same file's variant dma_bs (pallas_call at
// :52), where BlockSpec streams each (512, 128) block into VMEM with the
// auto-pipeline: each block streams its tile through two 64 KiB shared
// buffers with two pieces in flight; the output is sum_blk
// int32(rows[blk * 512, 0]).
// The copies are the 1D bulk copy (cp.async.bulk into shared memory,
// completed on an mbarrier with the byte count), Hopper's counterpart
// of pltpu.make_async_copy; it needs no tensor map.  Addresses and sizes
// are 16-byte aligned.  Bound: kDmaNw and stream_tiles must read 512 MiB
// at n = 2^20, 0.1603 ms at 3.35 TB/s; kEmpty, kSmemrw and kWaits move
// a few bytes and are bound by the launch and the blocks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 255;                // leaves
constexpr int kC = 20;                 // columns of the leaf state
constexpr int kSelThreads = 256;

constexpr int kEmpty = 0, kSmemrw = 1, kDmaNw = 2, kWaits = 3;
constexpr int kTileRows = 512, kTileCols = 128;
constexpr int kPieceBytes = 64 * 1024;
constexpr int kPieces = kTileRows * kTileCols * 4 / kPieceBytes;   // 4
constexpr int kProbeThreads = 32;

// (value, index) a beats (value, index) b under jnp.argmax's order: a
// NaN above every number, a larger value above a smaller, the smaller
// index on a tie
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  if (av != bv) return av > bv;
  return ai < bi;
}

__global__ void __launch_bounds__(kSelThreads)
select_update_kernel(float* __restrict__ leafs, float* __restrict__ sel) {
  __shared__ float s[kL * kC];
  __shared__ float wv[kSelThreads / 32];
  __shared__ int wi[kSelThreads / 32];
  __shared__ int bad[kC];
  __shared__ float d[kC];
  __shared__ int leaf_s;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (int i = t; i < kL * kC; i += kSelThreads) s[i] = leafs[i];
  if (t < kC) bad[t] = 0;
  __syncthreads();

  float v = t < kL ? s[t * kC] : -INFINITY;
  int vi = t < kL ? t : 1 << 30;
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, vi, off);
    if (beats(ov, oi, v, vi)) {
      v = ov;
      vi = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = vi;
  }
  __syncthreads();
  if (t == 0) {
    float bv = wv[0];
    int bi = wi[0];
    for (int w = 1; w < kSelThreads / 32; ++w)
      if (beats(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    leaf_s = bi;
  }
  __syncthreads();
  const int leaf = leaf_s;
  // the masked sum's other terms: x * 0 is NaN for an inf or NaN x
  for (int i = t; i < kL * kC; i += kSelThreads)
    if (i / kC != leaf && !isfinite(s[i])) bad[i % kC] = 1;
  __syncthreads();
  if (t < kC) {
    const float row = bad[t] ? __fmul_rn(INFINITY, 0.f)
                             : __fadd_rn(0.f, s[leaf * kC + t]);
    d[t] = __fsub_rn(__fadd_rn(row, 1.f), row);
    if (t == 0) {
      sel[0] = (float)leaf;
      sel[1] = row;
    }
  }
  if (t >= 2 && t < 8) sel[t] = 0.f;
  __syncthreads();
  for (int i = t; i < kL * kC; i += kSelThreads) {
    const float oh = i / kC == leaf ? 1.f : 0.f;
    leafs[i] = __fadd_rn(s[i], __fmul_rn(__fmul_rn(oh, d[i % kC]), oh));
  }
}

// floor(a / b) for b > 0, as jnp's // on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__global__ void __launch_bounds__(kProbeThreads)
step_cost_kernel(const int* __restrict__ sel, const float* __restrict__ rows,
                 int* __restrict__ out, int nb) {
  extern __shared__ __align__(128) unsigned char tile[];   // kDmaNw
  __shared__ __align__(8) uint64_t bar;
  const int blk = blockIdx.x;
  if (threadIdx.x != 0) return;
  unsigned int share = blk == 0 ? (unsigned int)sel[0] : 0u;
  if constexpr (V == kEmpty) {
    if (blk == nb - 1) out[0] = sel[0];
    return;
  } else if constexpr (V == kSmemrw) {
    __shared__ volatile unsigned int acc[4];
    acc[0] = share;
    acc[1] = acc[0] + (unsigned int)blk;
    acc[2] = acc[1] * 2u;
    acc[0] = acc[2] - acc[1] + (unsigned int)floor_div(sel[1], blk + 1);
    share = acc[0];
  } else if constexpr (V == kDmaNw) {
    const uint32_t b = smem_addr(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const char* src = reinterpret_cast<const char*>(rows)
                      + (size_t)blk * kTileRows * kTileCols * 4;
    for (int p = 0; p < kPieces; ++p) {
      uint64_t state;
      uint32_t done = 0;
      asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                   ::"r"(b), "r"(kPieceBytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(tile)), "l"(src + (size_t)p * kPieceBytes),
          "r"(kPieceBytes), "r"(b) : "memory");
      asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                   : "=l"(state) : "r"(b) : "memory");
      while (!done)
        asm volatile(
            "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, "
            "[%1], %2; selp.u32 %0, 1, 0, P1; }"
            : "=r"(done) : "r"(b), "r"(p & 1) : "memory");
    }
    share += 1u;
  } else {
    static_assert(V == kWaits, "unknown step_cost variant");
    const uint32_t b = smem_addr(&bar);
    uint64_t state;
    uint32_t done = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                 : "=l"(state) : "r"(b) : "memory");
    while (!done)
      asm volatile(
          "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, "
          "[%1], 0; selp.u32 %0, 1, 0, P1; }"
          : "=r"(done) : "r"(b) : "memory");
    share += 1u;
  }
  atomicAdd(reinterpret_cast<unsigned int*>(out), share);
}

__global__ void __launch_bounds__(kProbeThreads)
stream_tiles_kernel(const float* __restrict__ rows, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char tile[];   // 2 x 64 KiB
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x != 0) return;
  const char* src = reinterpret_cast<const char*>(rows)
                    + (size_t)blockIdx.x * kTileRows * kTileCols * 4;
  const uint32_t b0 = smem_addr(&bars[0]), b1 = smem_addr(&bars[1]);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b0)
               : "memory");
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint64_t state;
  for (int p = 0; p < 2; ++p) {
    const uint32_t b = p ? b1 : b0;
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                 ::"r"(b), "r"(kPieceBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(tile + p * kPieceBytes)),
        "l"(src + (size_t)p * kPieceBytes), "r"(kPieceBytes), "r"(b)
        : "memory");
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                 : "=l"(state) : "r"(b) : "memory");
  }
  int first = 0;
  for (int p = 0; p < kPieces; ++p) {
    const uint32_t b = (p & 1) ? b1 : b0;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, "
          "[%1], %2; selp.u32 %0, 1, 0, P1; }"
          : "=r"(done) : "r"(b), "r"((p >> 1) & 1) : "memory");
    if (p == 0) first = __float2int_rz(reinterpret_cast<float*>(tile)[0]);
    if (p + 2 < kPieces) {
      // the buffer was read by this thread: order that read before the
      // bulk copy (the async proxy) writes it again
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                   ::"r"(b), "r"(kPieceBytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(tile + (p & 1) * kPieceBytes)),
          "l"(src + (size_t)(p + 2) * kPieceBytes), "r"(kPieceBytes),
          "r"(b) : "memory");
      asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                   : "=l"(state) : "r"(b) : "memory");
    }
  }
  atomicAdd(reinterpret_cast<unsigned int*>(out), (unsigned int)first);
}

template <int V>
int launch_step_cost(const int* sel, const float* rows, int* out, int nb,
                     cudaStream_t s) {
  const int smem = V == kDmaNw ? kPieceBytes : 0;
  static bool smem_set = false;   // one per instantiation
  if (smem > 0 && !smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        step_cost_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (V != kEmpty) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  step_cost_kernel<V><<<nb, kProbeThreads, smem, s>>>(sel, rows, out, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of one step's tile and the bytes each block stages at a time.
int probes_tile_rows() { return kTileRows; }
int probes_piece_bytes() { return kPieceBytes; }

// Dynamic shared memory of a launch: step_cost variant 0-3, or 4 for
// stream_tiles.
int probes_smem_bytes(int variant) {
  return variant == kDmaNw ? kPieceBytes : variant == 4 ? 2 * kPieceBytes
                                                        : 0;
}

// leafs f32 [255, 20] updated in place; sel f32 [8].  Returns the CUDA
// error code of the launch (0 on success).
int select_update(float* leafs, float* sel, void* stream) {
  select_update_kernel<<<1, kSelThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(leafs, sel);
  return (int)cudaGetLastError();
}

// The same launch k times in a row from C; sel holds the last one's.
int select_update_loop(float* leafs, float* sel, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < k; ++i) {
    select_update_kernel<<<1, kSelThreads, 0, s>>>(leafs, sel);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// sel i32 [2] on the device; rows f32 [nb * 512, 128] (16-byte aligned);
// out i32 [1].  variant: 0 empty, 1 smemrw, 2 dma_nw, 3 waits.
int step_cost(int variant, const int* sel, const float* rows, int* out,
              int nb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kEmpty: return launch_step_cost<kEmpty>(sel, rows, out, nb, s);
    case kSmemrw: return launch_step_cost<kSmemrw>(sel, rows, out, nb, s);
    case kDmaNw: return launch_step_cost<kDmaNw>(sel, rows, out, nb, s);
    case kWaits: return launch_step_cost<kWaits>(sel, rows, out, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows f32 [nb * 512, 128] (16-byte aligned); out i32 [1].
int stream_tiles(const float* rows, int* out, int nb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 2 * kPieceBytes;
  static bool smem_set = false;
  cudaError_t e;
  if (!smem_set) {
    e = cudaFuncSetAttribute(stream_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  e = cudaMemsetAsync(out, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  stream_tiles_kernel<<<nb, kProbeThreads, smem, s>>>(rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
