// Per-leaf moments of the linear-leaf fit (linear_tree): for every leaf l,
// over its rows r with weight wf_r (the in-bag weight, 0 where a path
// feature of the leaf is NaN) and design vector xa_r = (x_r1 .. x_rk, 1)
// (x_rk the raw value of the leaf's k-th path feature, 0 where padded or
// NaN):
//
//   XtHX[l, i, j] = sum_r ((wf_r * h_r) * xa_ri) * xa_rj   (i <= j)
//   XtG[l, i]     = sum_r  (wf_r * g_r) * xa_ri
//   count[l]      = sum_r   wf_r
//
// in f64, written as out [L, E] f64, E = P + k1 + 1, k1 = kmax + 1: the
// P = k1 (k1 + 1) / 2 upper-triangle entries row by row (i <= j), then the
// k1 XtG entries, then the count.
//
// Replaces no TPU kernel: the JAX package accumulates these moments with
// an XLA einsum over one-hot leaf masks in f32 (lightgbm_tpu/models/
// linear.py:101-114, no pallas_call).  The port accumulates in f64, as
// LightGBM does (linear_tree_learner.cpp), and needs a fixed order: the
// fitted leaves feed the scores, so the card's trees equal the CPU run's
// only if every moment has the same bits on both.
//
// Inputs: raw [n, F] f32 (used-feature order), order i32 [n] (the rows
// sorted by leaf, stably: a leaf's rows in ascending row order), seg i32
// [L, 2] (start, count) of each leaf's rows in order, g, h, w f32 [n] by
// row, feat_idx i32 [L, kmax] (the leaf's path features, -1 padded).
//
// Determinism: no float atomics.  Each leaf's rows are cut into chunks of
// `chunk` rows from its start (the wrapper's CHUNK); every entry of a
// chunk is the sequential f64 sum of its rows' products in row order from
// +0, and the chunk sums are added in chunk order from +0.  Built with
// -fmad=false (ops/_build.py SOURCE_FLAGS): each product and sum rounds
// on its own, so the plain version (ops/linear_kernel.linear_moments_ref)
// gives these bits on the CPU.
//
// Design: grid (L, ceil(E / 256)); block (l, y) owns entries [256 y,
// 256 y + 256) of leaf l, one a thread, in registers.  Per chunk the
// block stages the chunk's rows (their path features' raw values f32,
// the row's wf * h, wf * g, wf in f64) in shared memory, one barrier, and
// every thread adds its entry's products over the chunk's rows.  The
// (i, j) pairs are spread over the grid, so no block keeps a leaf's
// k1 x k1 block (137^2 x 8 bytes at 136 features would not fit).  Bound
// on this card: the f64 products (3 flops an entry and row) where the
// leaves are large, the staging reads (the path features' values,
// gathered by row) where they are small; a leaf's blocks walk all its
// rows, so the largest leaf sets the time.  Simple and right first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Shared bytes of one block: the leaf's path features, the chunk's staged
// values (f32 [chunk, k1]) and its f64 row factors (wf * h, wf * g, wf).
__host__ __device__ inline int smem_bytes(int kmax, int chunk) {
  const int k1 = kmax + 1;
  const int fi = (kmax * 4 + 7) / 8 * 8;
  const int xs = (chunk * k1 * 4 + 7) / 8 * 8;
  return fi + xs + chunk * 3 * 8;
}

__global__ void __launch_bounds__(kThreads)
linear_moments_kernel(const float* __restrict__ raw, int F,
                      const int* __restrict__ order,
                      const int* __restrict__ seg,
                      const float* __restrict__ g,
                      const float* __restrict__ h,
                      const float* __restrict__ w,
                      const int* __restrict__ feat_idx, int kmax, int chunk,
                      int E, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k1 = kmax + 1;
  const int l = blockIdx.x;
  int* s_fi = reinterpret_cast<int*>(smem);
  float* s_x = reinterpret_cast<float*>(smem + (kmax * 4 + 7) / 8 * 8);
  double* s_a = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(s_x) + (chunk * k1 * 4 + 7) / 8 * 8);
  double* s_b = s_a + chunk;
  double* s_w = s_b + chunk;
  for (int k = threadIdx.x; k < kmax; k += kThreads)
    s_fi[k] = feat_idx[(size_t)l * kmax + k];
  // this thread's entry: kind 0 a pair (i, j), 1 an XtG entry i, 2 the
  // count, -1 none
  const int P = k1 * (k1 + 1) / 2;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  int kind = -1, ei = 0, ej = 0;
  if (e < P) {
    kind = 0;
    int rem = e, i = 0;
    while (rem >= k1 - i) {
      rem -= k1 - i;
      ++i;
    }
    ei = i;
    ej = i + rem;
  } else if (e < P + k1) {
    kind = 1;
    ei = e - P;
  } else if (e < E) {
    kind = 2;
  }
  const int start = seg[2 * l], cnt = seg[2 * l + 1];
  double total = 0.0;
  __syncthreads();
  for (int c0 = 0; c0 < cnt; c0 += chunk) {
    const int rows = cnt - c0 < chunk ? cnt - c0 : chunk;
    // stage the chunk's path-feature values (NaN kept for now)
    for (int idx = threadIdx.x; idx < rows * k1; idx += kThreads) {
      const int r = idx / k1, k = idx % k1;
      float v = 1.0f;   // the intercept column
      if (k < kmax) {
        const int f = s_fi[k];
        v = f >= 0 ? raw[(size_t)order[start + c0 + r] * F + f] : 0.0f;
      }
      s_x[idx] = v;
    }
    __syncthreads();
    // each row's NaN test over its path features, its factors, and its
    // NaN values zeroed
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      bool nan_row = false;
      for (int k = 0; k < kmax; ++k) {
        const float v = s_x[r * k1 + k];
        if (isnan(v)) {
          nan_row = true;
          s_x[r * k1 + k] = 0.0f;
        }
      }
      const int row = order[start + c0 + r];
      const double wf = nan_row ? 0.0 : (double)w[row];
      s_a[r] = wf * (double)h[row];
      s_b[r] = wf * (double)g[row];
      s_w[r] = wf;
    }
    __syncthreads();
    double acc = 0.0;
    if (kind == 0) {
      for (int r = 0; r < rows; ++r)
        acc = acc + (s_a[r] * (double)s_x[r * k1 + ei])
                        * (double)s_x[r * k1 + ej];
    } else if (kind == 1) {
      for (int r = 0; r < rows; ++r)
        acc = acc + s_b[r] * (double)s_x[r * k1 + ei];
    } else if (kind == 2) {
      for (int r = 0; r < rows; ++r) acc = acc + s_w[r];
    }
    total = total + acc;
    __syncthreads();   // the stage is rewritten by the next chunk
  }
  if (kind >= 0) out[(size_t)l * E + e] = total;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at kmax path features and `chunk`
// rows a chunk.
int linear_moments_smem_bytes(int kmax, int chunk) {
  return smem_bytes(kmax, chunk);
}

// out [L, E] f64 with E = k1 (k1 + 1) / 2 + k1 + 1, k1 = kmax + 1 (see the
// file's head).  Returns the CUDA error code of the launch (0 on success).
int linear_moments(const float* raw, int F, const int* order,
                   const int* seg, const float* g, const float* h,
                   const float* w, const int* feat_idx, int L, int kmax,
                   int chunk, double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k1 = kmax + 1;
  const int E = k1 * (k1 + 1) / 2 + k1 + 1;
  if (L <= 0 || kmax <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(kmax, chunk);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        linear_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(L, (E + kThreads - 1) / kThreads);
  linear_moments_kernel<<<grid, kThreads, smem, s>>>(
      raw, F, order, seg, g, h, w, feat_idx, kmax, chunk, E, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
