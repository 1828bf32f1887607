// Forest traversal for compiled serving, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/pallas/serve_kernel.py
// make_serve_traverse (_serve_kernel, _traverse_block): both of its forms,
//   scores: out[n, K] f32 = per-class sum of leaf values over trees
//           t = it * K + kk, written in place into the caller's buffer;
//   leaves: out[n, T] i32 = leaf index per (row, tree).
// Rows >= n_real are bucket padding and are written as 0.
//
// Inputs follow the JAX kernel's contract exactly (forest_kernel_args
// order): bins [n, F] i32 (quantized bins on numerical columns,
// int-truncated raw values on categorical ones), node arrays
// sf/tb/lc/rc/nm [T, NI] i32, cat_words [T, NI * W] i32 and cat_nbits
// [T, NI] i32 when W > 0, leaf table [T, NL] f32 or bf16.  A leaf is
// ~node; node_meta is (nan_bin << 3) | (is_cat << 2) | (has_nan << 1)
// | default_left.
//
// What bounds it on this card: each level of each (row, tree) walk is a
// chain of dependent loads (node fields -> the row's bin -> the child
// pointer), so the walk is bound by load latency, far above both the
// byte bound (rows once + forest once + out once) and the integer-op
// bound.  The forest is small (100 trees x 256 nodes x 6 words plus the
// leaf table is about 0.7 MB) and stays in the 50 MB L2.
//
// What the design does about it: it keeps many independent walks in
// flight.  The scores form gives each row one warp whose 32 lanes walk
// disjoint iterations of the forest and then sum by warp shuffles, so a
// 64-row batch still runs 2048 threads; the leaves form runs one thread
// per (row, tree).  Node fields are read through the read-only data
// path (__ldg); the TPU's VMEM landing of the whole forest has no
// counterpart here.  Staging the forest in shared memory, tiling tree
// chunks by rows and fusing the quantizer are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Forest {
  const int* sf;
  const int* tb;
  const int* lc;
  const int* rc;
  const int* nm;
  const int* cw;  // null when W == 0
  const int* nb;  // null when W == 0
  int ni;         // padded nodes per tree
  int w;          // bitset words per node
  int n_steps;    // max depth of the forest
};

// Walk tree t for one row; returns the leaf index (~min(node, -1)).
__device__ __forceinline__ int walk_tree(const Forest& f,
                                         const int* __restrict__ row,
                                         int t) {
  const long long base = static_cast<long long>(t) * f.ni;
  int node = 0;
  for (int s = 0; s < f.n_steps && node >= 0; ++s) {
    const long long g = base + node;
    const int b = row[__ldg(f.sf + g)];
    const int meta = __ldg(f.nm + g);
    bool go_left;
    if (f.w > 0 && (meta & 4)) {
      // raw-value bitset membership; the word is shifted as uint32
      // because bit 31 makes the i32 word negative
      const bool ok = b >= 0 && b < __ldg(f.nb + g);
      const int ivc = min(max(b, 0), 32 * f.w - 1);
      const unsigned word =
          static_cast<unsigned>(__ldg(f.cw + g * f.w + (ivc >> 5)));
      go_left = ok && ((word >> (ivc & 31)) & 1u);
    } else {
      // meta >> 3 is an arithmetic shift of the i32 word
      const bool at_nan = (meta & 2) && b == (meta >> 3);
      go_left = at_nan ? (meta & 1) != 0 : b <= __ldg(f.tb + g);
    }
    node = go_left ? __ldg(f.lc + g) : __ldg(f.rc + g);
  }
  return ~min(node, -1);
}

template <bool kBf16>
__device__ __forceinline__ float leaf_at(const void* lv, long long i) {
  if (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(lv)[i]);
  } else {
    return __ldg(static_cast<const float*>(lv) + i);
  }
}

constexpr int kWarpsPerBlock = 4;

// One warp per row: lane j sums iterations j, j + 32, ... of class kk,
// then the warp reduces by shuffles and lane 0 writes out[row, kk].
template <bool kBf16>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
scores_kernel(Forest f, const void* __restrict__ lv,
              const int* __restrict__ bins, float* __restrict__ out,
              int n, int n_real, int n_feat, int trees, int nl, int k) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  float* orow = out + static_cast<long long>(r) * k;
  if (r >= n_real) {
    for (int kk = lane; kk < k; kk += 32) orow[kk] = 0.0f;
    return;
  }
  const int* row = bins + static_cast<long long>(r) * n_feat;
  const int iters = trees / k;
  for (int kk = 0; kk < k; ++kk) {
    float acc = 0.0f;
    for (int it = lane; it < iters; it += 32) {
      const int t = it * k + kk;
      const int leaf = walk_tree(f, row, t);
      // upcast right after the read: the leaf table may be bf16
      acc += leaf_at<kBf16>(lv, static_cast<long long>(t) * nl + leaf);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) orow[kk] = acc;
  }
}

// One thread per (row, tree): out[row, t] = leaf index.
__global__ void leaves_kernel(Forest f, const int* __restrict__ bins,
                              int* __restrict__ out, int n, int n_real,
                              int n_feat, int trees) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n) * trees) return;
  const int r = static_cast<int>(i / trees);
  const int t = static_cast<int>(i % trees);
  out[i] = r < n_real
               ? walk_tree(f, bins + static_cast<long long>(r) * n_feat, t)
               : 0;
}

Forest make_forest(const void* sf, const void* tb, const void* lc,
                   const void* rc, const void* nm, const void* cw,
                   const void* nb, int ni, int w, int n_steps) {
  Forest f;
  f.sf = static_cast<const int*>(sf);
  f.tb = static_cast<const int*>(tb);
  f.lc = static_cast<const int*>(lc);
  f.rc = static_cast<const int*>(rc);
  f.nm = static_cast<const int*>(nm);
  f.cw = static_cast<const int*>(cw);
  f.nb = static_cast<const int*>(nb);
  f.ni = ni;
  f.w = w;
  f.n_steps = n_steps;
  return f;
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, allocate
// nothing, and return cudaGetLastError() of the launch.
extern "C" int serve_traverse_scores(
    const void* sf, const void* tb, const void* lc, const void* rc,
    const void* nm, const void* cw, const void* nb, const void* lv,
    int leaf_bf16, const void* bins, void* out, int n, int n_real,
    int n_feat, int trees, int ni_pad, int nl_pad, int cat_words_w,
    int num_class, int n_steps, void* stream) {
  const Forest f = make_forest(sf, tb, lc, rc, nm, cw, nb, ni_pad,
                               cat_words_w, n_steps);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leaf_bf16) {
    scores_kernel<true><<<grid, block, 0, s>>>(
        f, lv, static_cast<const int*>(bins), static_cast<float*>(out), n,
        n_real, n_feat, trees, nl_pad, num_class);
  } else {
    scores_kernel<false><<<grid, block, 0, s>>>(
        f, lv, static_cast<const int*>(bins), static_cast<float*>(out), n,
        n_real, n_feat, trees, nl_pad, num_class);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int serve_traverse_leaves(
    const void* sf, const void* tb, const void* lc, const void* rc,
    const void* nm, const void* cw, const void* nb, const void* bins,
    void* out, int n, int n_real, int n_feat, int trees, int ni_pad,
    int cat_words_w, int n_steps, void* stream) {
  const Forest f = make_forest(sf, tb, lc, rc, nm, cw, nb, ni_pad,
                               cat_words_w, n_steps);
  const long long total = static_cast<long long>(n) * trees;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((total + threads - 1) / threads));
  leaves_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const int*>(bins), static_cast<int*>(out), n, n_real,
      n_feat, trees);
  return static_cast<int>(cudaGetLastError());
}
