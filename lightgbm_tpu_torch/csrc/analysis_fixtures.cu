// The static analyzer's fixture kernels, CUDA C++ for sm_90a.
//
// Replaces the red-team Pallas kernels of lightgbm_tpu/analysis/fixtures:
//   fixture_stage_copy<T>  _bad_lane (__init__.py:77, f32),
//                          _bad_cat (:280, i32 bitset side table),
//                          _bad_serve_kernel (:326, i32 node lines) and
//                          _bad_mc_batch (:393, f32, a grid over K
//                          classes): rows [0, rows) of each class slice
//                          copied device -> shared -> device;
//   fixture_smem_acc       _bad_vmem (:107): a grid of 4 copies
//                          (8, 128) f32 blocks x -> o beside a zeroed
//                          dynamic shared accumulator;
//   fixture_scale_bias     bad_host_ast.py:21 (build): o = x * scale +
//                          bias, scale and bias read on the device.
//
// Each TPU kernel was written to break one rule of the TPU's layout or
// budget and be flagged by one pass of the JAX package's analyzer.
// These kernels are right at their legal geometry; the analyzer of the
// port (lightgbm_tpu_torch/analysis) registers each a second time at a
// seeded geometry that breaks the port's own rule in the same way, and
// that geometry is never launched: a misaligned 16-byte access is a
// sticky error that ends the context.  The rules are
//   fixture_stage_copy: every row of the copied tensors is whole 16-byte
//     words (row bytes % 16 == 0, base 16-byte aligned), because the
//     copy moves uint4 words at dynamic row offsets (the RecPtr rule of
//     partition_common.cuh);
//   fixture_smem_acc: the accumulator is dynamic shared memory, opted in
//     above 48 KB, and at most 232,448 bytes a block.
//
// Bound on this card: bytes.  Each kernel reads its input once and writes
// its output once; the copies stage through shared memory to exercise
// the path the analyzer checks, not to be fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// rows [0, rows) of class blockIdx.x of src [K, R, C] to dst, row_words
// 16-byte words a row, through shared memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
fixture_stage_copy(const T* __restrict__ src, T* __restrict__ dst,
                   int rows, int row_words, long long class_words) {
  extern __shared__ uint4 stage[];            // [rows, row_words]
  const uint4* s = reinterpret_cast<const uint4*>(src) +
                   (long long)blockIdx.x * class_words;
  uint4* d = reinterpret_cast<uint4*>(dst) +
             (long long)blockIdx.x * class_words;
  const int words = rows * row_words;
  for (int i = threadIdx.x; i < words; i += kThreads) stage[i] = s[i];
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += kThreads) d[i] = stage[i];
}

// block blockIdx.x of x [nblk * block_elems] to o, beside an accumulator
// of acc_floats f32 in dynamic shared memory, zeroed first
__global__ void __launch_bounds__(kThreads)
fixture_smem_acc(const float* __restrict__ x, float* __restrict__ o,
                 int block_elems, int acc_floats) {
  extern __shared__ float acc[];
  for (int i = threadIdx.x; i < acc_floats; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const long long b0 = (long long)blockIdx.x * block_elems;
  for (int i = threadIdx.x; i < block_elems; i += kThreads)
    o[b0 + i] = x[b0 + i];
}

// o = x * scale + bias, two roundings (no contraction to fma), as the
// plain version computes it
__global__ void fixture_scale_bias(const float* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   float* __restrict__ o, long long n) {
  const float s = __ldg(scale), b = __ldg(bias);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = __fadd_rn(__fmul_rn(x[i], s), b);
}

template <typename T>
int stage_copy(const void* src, void* dst, int classes, int rows,
               int row_words, long long class_words, cudaStream_t s) {
  const int smem = rows * row_words * 16;
  static int smem_set = 0;   // one per instantiation
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fixture_stage_copy<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  fixture_stage_copy<T><<<classes, kThreads, smem, s>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), rows, row_words,
      class_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one fixture_stage_copy block.
int analysis_stage_copy_smem_bytes(int rows, int row_bytes) {
  return rows * row_bytes;
}

// Rows [0, rows) of each of `classes` slices of src to dst, f32 (is_int
// 0) or i32 (is_int 1): row_words 16-byte words a row, class_words a
// class slice; both tensors 16-byte aligned.  Returns the CUDA error code
// of the launch (0 on success).
int analysis_stage_copy(const void* src, void* dst, int is_int, int classes,
                        int rows, int row_words, long long class_words,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return stage_copy<int>(src, dst, classes, rows, row_words, class_words,
                           s);
  return stage_copy<float>(src, dst, classes, rows, row_words, class_words,
                           s);
}

// x and o f32 [nblk * block_elems]; acc_bytes of dynamic shared memory.
int analysis_smem_acc(const float* x, float* o, int nblk, int block_elems,
                      int acc_bytes, void* stream) {
  static int smem_set = 0;
  if (acc_bytes > 48 * 1024 && acc_bytes > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fixture_smem_acc, cudaFuncAttributeMaxDynamicSharedMemorySize,
        acc_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = acc_bytes;
  }
  fixture_smem_acc<<<nblk, kThreads, acc_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      x, o, block_elems, acc_bytes / 4);
  return (int)cudaGetLastError();
}

// o = x * scale + bias over n f32; scale and bias f32 device scalars.
int analysis_scale_bias(const float* x, const float* scale,
                        const float* bias, float* o, long long n,
                        void* stream) {
  long long blocks = (n + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  fixture_scale_bias<<<(int)blocks, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, scale, bias,
                                                            o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
