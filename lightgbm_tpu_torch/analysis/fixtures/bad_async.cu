// async-copy red-team fixture: three kernels, each breaking one rule of
// the asynchronous copy discipline.  The analyzer's async-copy pass
// PARSES this file (--fixture bad_async); it is never built.  The
// bodies use the idiom a Hopper redesign would: cp.async through
// <cuda_pipeline.h> into a shared staging tile.
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
