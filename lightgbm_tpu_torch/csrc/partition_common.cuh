// The split predicate (with the optional membership words), the row
// layouts, the per-tile left counts and the span copyback shared by partition.cu (scan + copyback, both packs),
// partition_3ph.cu (through partition_scan.cuh) and fused_split.cu.
//
// Two row-access policies.  pack=1, RowPtrs: bins u8 [n, F], vals f32
// [n, 3] (g*w, h*w, w), rid i32 [n] (original row ids), score f32 [n],
// consts f32 [n, 2] (the objective's per-row constants); a scratch matrix
// has the same five arrays.  pack=2, RecPtr: one record of S bytes per
// row (ops/device_data.RecordLayout): the bins at byte 0, the same
// fields from byte Fb = 4 * ceil(F / 4), S = 16 * ceil((Fb + 28) / 16);
// the base is 16-byte aligned, so every record is whole 16-byte words.
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

// membership words a descriptor may carry (layout.CAT_BITSET_WORDS)
constexpr int kMaxWords = 8;

// The split: the descriptor and, for categorical splits, optional
// membership words (partition_kernel._member_bit, the sorted-subset
// routes' descriptor); nwords 0 is the one-hot test.  Every kernel that
// decides a row's side takes the whole Pred and calls pred_left, so the
// passes of one split (the fused split's count and scatter) can never
// test different predicates.
struct Pred {
  Split sp;
  unsigned words[kMaxWords];
  int nwords;
};

// _go_left with the optional membership words: the words replace bin ==
// sbin for categorical splits only; a bin past the last word goes right
__device__ __forceinline__ bool pred_left(int col, const Pred& p) {
  if (p.sp.cat && p.nwords > 0) {
    // word col / 32 by selection (an indexed parameter would be copied
    // to the stack)
    const int w = col >> 5;
    unsigned word = 0u;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k)
      if (k == w && k < p.nwords) word = p.words[k];
    return ((word >> (col & 31)) & 1u) != 0u;
  }
  return go_left(col, p.sp);
}

// The Pred of a descriptor and nwords (0 to kMaxWords) host words; false
// for a word count out of range.
inline bool make_pred(const Split& sp, int nwords, const unsigned* words,
                      Pred* p) {
  if (nwords < 0 || nwords > kMaxWords || (nwords > 0 && words == nullptr))
    return false;
  *p = Pred{};
  p->sp = sp;
  p->nwords = nwords;
  for (int k = 0; k < nwords; ++k) p->words[k] = words[k];
  return true;
}

struct RowPtrs {
  uint8_t* bins;
  float* vals;
  int* rid;
  float* score;
  float* consts;
};

struct RecPtr {
  uint8_t* base;
  int S;    // record stride in bytes, a multiple of 16
  int Fb;   // byte offset of vals
};

// bin of feature f of row r
__device__ __forceinline__ int bin_at(const RowPtrs& rows, int F,
                                      long long r, int f) {
  return rows.bins[r * F + f];
}
__device__ __forceinline__ int bin_at(const RecPtr& rows, int F,
                                      long long r, int f) {
  return rows.base[r * rows.S + f];
}

// the bins and the row stride the count pass reads: a record's bins are
// the first bytes of an S-byte row
__device__ __host__ inline const uint8_t* bins_of(const RowPtrs& r) {
  return r.bins;
}
__device__ __host__ inline const uint8_t* bins_of(const RecPtr& r) {
  return r.base;
}
__device__ __host__ inline int bin_stride(const RowPtrs&, int F) { return F; }
__device__ __host__ inline int bin_stride(const RecPtr& r, int) { return r.S; }

// the thread's kPer rows of tile `tile`: their left bits, and how many
// of them are rows of the segment
__device__ __forceinline__ int thread_bits(const uint8_t* bins, int F,
                                           const Pred& pr, int tile,
                                           unsigned* bits) {
  const Split& sp = pr.sp;
  const int first = tile * kTile + threadIdx.x * kPer;
  int live = 0;
  unsigned b = 0;
  for (int k = 0; k < kPer; ++k) {
    const int p = first + k;
    if (p < sp.cnt) {
      ++live;
      const int col = bins[(size_t)(sp.s0 + p) * F + sp.feat];
      if (pred_left(col, pr)) b |= 1u << k;
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
count_tiles(const uint8_t* __restrict__ bins, int F, Pred p,
            int* __restrict__ tile_left) {
  unsigned bits;
  thread_bits(bins, F, p, blockIdx.x, &bits);
  int total;
  block_exclusive_scan(__popc(bits), &total);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
}

// rows [s0, s0 + cnt) of every column from scr into rows, grid-stride;
// no row outside the span is touched
__global__ void copy_span(RowPtrs rows, RowPtrs scr, int F, int s0,
                          int cnt) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((F & 3) == 0) {
    // row offsets are multiples of 4 bytes: move 32-bit words
    const size_t w0 = (size_t)s0 * (F / 4), nw = (size_t)cnt * (F / 4);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(scr.bins) + w0;
    uint32_t* d = reinterpret_cast<uint32_t*>(rows.bins) + w0;
    for (size_t i = t0; i < nw; i += stride) d[i] = s[i];
  } else {
    const size_t b0 = (size_t)s0 * F, nb = (size_t)cnt * F;
    for (size_t i = t0; i < nb; i += stride)
      rows.bins[b0 + i] = scr.bins[b0 + i];
  }
  const size_t v0 = (size_t)s0 * 3, nv = (size_t)cnt * 3;
  for (size_t i = t0; i < nv; i += stride) rows.vals[v0 + i] = scr.vals[v0 + i];
  const size_t c0 = (size_t)s0 * 2, nc = (size_t)cnt * 2;
  for (size_t i = t0; i < nc; i += stride)
    rows.consts[c0 + i] = scr.consts[c0 + i];
  for (size_t i = t0; i < (size_t)cnt; i += stride) {
    rows.rid[s0 + i] = scr.rid[s0 + i];
    rows.score[s0 + i] = scr.score[s0 + i];
  }
}

// copy_span's grid for a span of cnt rows of F bins
inline int copy_span_blocks(int cnt, int F) {
  const long long work = (long long)cnt * (F > 3 ? F : 3);
  long long blocks = (work / 4 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return (int)blocks;
}

}  // namespace part
