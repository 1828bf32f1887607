// async-copy red-team fixture: four kernels, each breaking one rule of
// the asynchronous copy discipline.  The analyzer's async-copy pass
// PARSES this file (--fixture bad_async); it is never built.  The
// first three use cp.async through <cuda_pipeline.h> into a shared
// staging tile; the fourth, fused_hist's idiom (csrc/fused_split.cu):
// a ring of stages filled by cp.async through __device__ helpers.
#include <cuda_pipeline.h>

// Seeded: commits a copy and never waits for it (ASYNC_UNPAIRED_COMMIT).
__global__ void unpaired_commit_kernel(const float4* src, float4* out) {
  __shared__ float4 tile[128];
  __pipeline_memcpy_async(&tile[threadIdx.x], &src[threadIdx.x],
                          sizeof(float4));
  __pipeline_commit();
  out[threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Seeded: reads the copy's destination before the wait
// (ASYNC_READ_BEFORE_WAIT).
__global__ void read_before_wait_kernel(const float4* src, float4* out) {
  __shared__ float4 stage[128];
  __pipeline_memcpy_async(&stage[threadIdx.x], &src[threadIdx.x],
                          sizeof(float4));
  __pipeline_commit();
  const float4 v = stage[threadIdx.x];   // races the copy into stage
  __pipeline_wait_prior(0);
  out[threadIdx.x] = v;
}

// Seeded: starts a copy after the last commit, so no wait covers it
// (ASYNC_NEVER_COMMITTED).
__global__ void never_committed_kernel(const float4* src, float4* out) {
  __shared__ float4 buf[128];
  __shared__ float4 late[128];
  __pipeline_memcpy_async(&buf[threadIdx.x], &src[threadIdx.x],
                          sizeof(float4));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  out[threadIdx.x] = buf[threadIdx.x];
  __pipeline_memcpy_async(&late[threadIdx.x], &src[threadIdx.x],
                          sizeof(float4));
}

// The ring's helpers: a 16-byte cp.async into shared memory, a commit and
// a wait, as csrc/fused_split.cu writes them.
__device__ __forceinline__ void ring_copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ring_fill(float4* stage, const float4* src) {
  ring_copy16(stage + threadIdx.x, src + threadIdx.x);
}

// Seeded: refills the next stage of a two-stage ring through the helpers
// and reads it before the wait that covers that refill
// (ASYNC_READ_BEFORE_WAIT).
__global__ void refill_before_wait_kernel(const float4* src, float4* out,
                                          int steps) {
  __shared__ float4 ring[2 * 128];
  ring_fill(ring, src);
  ring_commit();
  for (int k = 0; k < steps; ++k) {
    ring_wait<0>();
    __syncthreads();
    ring_fill(ring + ((k + 1) % 2) * 128, src + (k + 1) * 128);
    ring_commit();
    out[k * 128 + threadIdx.x] = ring[((k + 1) % 2) * 128 + threadIdx.x];
  }
  ring_wait<0>();
}
