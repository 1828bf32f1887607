// The split predicate, the per-tile left counts and the row copy shared by
// partition.cu (scan + copyback) and fused_split.cu.
//
// Rows: bins u8 [n, F], vals f32 [n, 3] (g*w, h*w, w), rid i32 [n]
// (original row ids), score f32 [n], consts f32 [n, 2] (the objective's
// per-row constants); a scratch matrix has the same five arrays.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace part {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;   // rows per count tile

struct Split {
  int s0, cnt, feat, sbin, dl, cat, nanb;
};

// partition_kernel._go_left: one-hot categorical bin == sbin; numerical
// bin <= sbin with the NaN bin routed by default_left
__device__ __forceinline__ bool go_left(int col, const Split& sp) {
  if (sp.cat) return col == sp.sbin;
  const bool at_nan = sp.nanb >= 0 && col == sp.nanb;
  return at_nan ? sp.dl != 0 : col <= sp.sbin;
}

struct RowPtrs {
  uint8_t* bins;
  float* vals;
  int* rid;
  float* score;
  float* consts;
};

// the thread's kPer rows of tile `tile`: left bits, and how many of them
// are rows of the segment
__device__ __forceinline__ int thread_bits(const uint8_t* bins, int F,
                                           const Split& sp, int tile,
                                           unsigned* bits) {
  const int first = tile * kTile + threadIdx.x * kPer;
  int live = 0;
  unsigned b = 0;
  for (int k = 0; k < kPer; ++k) {
    const int p = first + k;
    if (p < sp.cnt) {
      ++live;
      const int col = bins[(size_t)(sp.s0 + p) * F + sp.feat];
      if (go_left(col, sp)) b |= 1u << k;
    }
  }
  *bits = b;
  return live;
}

// exclusive block scan of v (int) over kThreads threads; returns the
// prefix, *total the sum
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// left rows of each kTile-row tile of the segment
__global__ void __launch_bounds__(kThreads)
count_tiles(const uint8_t* __restrict__ bins, int F, Split sp,
            int* __restrict__ tile_left) {
  unsigned bits;
  thread_bits(bins, F, sp, blockIdx.x, &bits);
  int total;
  block_exclusive_scan(__popc(bits), &total);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
}

// every column of the row but its bins
__device__ __forceinline__ void copy_values(const RowPtrs& s,
                                            const RowPtrs& d, long long src,
                                            long long dst) {
  d.vals[dst * 3] = s.vals[src * 3];
  d.vals[dst * 3 + 1] = s.vals[src * 3 + 1];
  d.vals[dst * 3 + 2] = s.vals[src * 3 + 2];
  d.rid[dst] = s.rid[src];
  d.score[dst] = s.score[src];
  d.consts[dst * 2] = s.consts[src * 2];
  d.consts[dst * 2 + 1] = s.consts[src * 2 + 1];
}

// every column of row src into row dst of another matrix
__device__ __forceinline__ void copy_row(const RowPtrs& s, const RowPtrs& d,
                                         int F, long long src,
                                         long long dst) {
  if ((F & 3) == 0) {
    const uint32_t* a = reinterpret_cast<const uint32_t*>(s.bins + src * F);
    uint32_t* b = reinterpret_cast<uint32_t*>(d.bins + dst * F);
    for (int w = 0; w < F / 4; ++w) b[w] = a[w];
  } else {
    for (int f = 0; f < F; ++f) d.bins[dst * F + f] = s.bins[src * F + f];
  }
  copy_values(s, d, src, dst);
}

}  // namespace part
