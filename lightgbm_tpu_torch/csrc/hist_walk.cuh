// The staged walk over a row range shared by the histogram kernels of
// hist_rows.cu and hist_comb.cu, and the range-mode histogram built on it.
//
// walk() moves positions [lo, hi) through a double-buffered shared stage
// in steps of kThreads * SR positions: a step stores the registers the
// step before loaded, meets one barrier, issues the next step's loads
// into registers and then hands its stage to the caller's accumulation
// while those loads are in flight.  What a position is, and how its bins
// and values reach the registers, is the row source's:
//
// - IndexedRows: hist_rows' bins [n, F] (u8 or u16) and (g*w, h*w)
//   float2 [n], read through an optional i32 row index whose entries are
//   loaded a step ahead of the rows they name; it stages the bins of
//   up to kMaxFeat features a row, one element at a time.
// - WordRows: hist_comb's rows, the u8 bins of a row at byte r * bstride
//   (pack=1: F; pack=2: the record stride S) and its (g*w, h*w) at float
//   r * vstride of vals (pack=1: 3; pack=2: S / 4, from byte Fb).  It
//   loads the aligned 32-bit words that cover a row's staged bins (a
//   division-free address computation, 4-byte loads at any row stride)
//   and shifts them into place with a funnel shift, so the stage holds
//   features [f_lo, f_lo + nf) of row r at bytes [r * stride, ...),
//   stride = 4 * ceil(nf / 4), whatever the row's alignment.
//
// range_hist() is the range mode of both kernels: warp w of block x owns
// unit u = 8 x + w below F * R, the 32 cells of bins [(u % R) * 32, ...
// + 32) of feature u / R, in warp-private shared memory.  Each step it
// lists the stage's rows whose bin falls in its range
// (histblock::compact_range) and adds them 32 at a time
// (histblock::add_listed).  The range is cut into nslices slices
// (histblock::slice's cut); where a slice ends (any number of times in
// one step) the warp adds its cells to its running totals and restarts
// them at +0, so every cell is the sequential f32 sum of each slice's
// rows in row order, and the slice sums are added in slice order from
// 0: the bits of the per-slice partials and their reduction.  The cells
// and running totals are of the accumulator's type (float, or double in
// hist_rows' gpu_use_dp mode, rounded to f32 once when written).  Every
// position of the range passes through every warp, so a launch costs
// the walk over the range, not the slice count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace histwalk {

using histblock::kThreads;
using histblock::kWarps;
constexpr int kRange = 32;   // bins a range-mode warp owns

// Shared bytes of the double-buffered stage of SR positions a thread
// with `bin_bytes` bytes of staged bins a position.
__host__ __device__ inline int stage_bytes(int sr, int bin_bytes) {
  return 2 * kThreads * sr * (8 + bin_bytes);
}

// Shared bytes of range mode's per-warp state: 32 cells (pairs of
// acc_bytes each) and the list of a step's rows in the warp's range.
__host__ __device__ inline int range_state_bytes(int sr, int acc_bytes = 4) {
  return kWarps * kRange * 2 * acc_bytes + kWarps * kThreads * sr * 4;
}

// -- row sources ------------------------------------------------------------

// hist_rows: positions through an optional index (null: the positions
// are the rows); bins of features [f_lo, f_lo + nf), nf <= kMaxFeat.
template <typename BinT, int SR, int kMaxFeat>
struct IndexedRows {
  using Bin = BinT;
  const BinT* bins;
  const float2* vals;
  const int* index;
  int F, f_lo, nf;
  struct Regs {
    int next[SR];          // the rows of the step after the loaded one
    float2 v[SR];
    BinT b[SR][kMaxFeat];
  };

  // the rows of this thread's positions of the step at p0, -1 at or
  // past hi
  __device__ __forceinline__ void load_rows(long long p0, long long hi,
                                            int (&row)[SR]) const {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const long long p = p0 + threadIdx.x + kThreads * k;
      row[k] = p < hi ? (index != nullptr ? __ldg(index + p) : (int)p) : -1;
    }
  }
  __device__ __forceinline__ void load_data(const int (&row)[SR],
                                            Regs& r) const {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      if (row[k] < 0) continue;
      r.v[k] = __ldg(vals + row[k]);
      const BinT* br = bins + (size_t)row[k] * F + f_lo;
#pragma unroll
      for (int j = 0; j < kMaxFeat; ++j)
        if (j < nf) r.b[k][j] = __ldg(br + j);
    }
  }
  __device__ __forceinline__ void first(long long lo, long long hi,
                                        Regs& r) const {
    int row[SR];
    load_rows(lo, hi, row);
    load_data(row, r);
    load_rows(lo + kThreads * SR, hi, r.next);
  }
  __device__ __forceinline__ void next(long long p, long long hi,
                                       Regs& r) const {
    load_data(r.next, r);
    load_rows(p + kThreads * SR, hi, r.next);
  }
  // elements from one staged row's bins to the next's
  __device__ __forceinline__ int stride() const { return nf; }
  __device__ __forceinline__ void store(const Regs& r, float2* sv,
                                        BinT* sb) const {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int p = threadIdx.x + kThreads * k;
      sv[p] = r.v[k];
#pragma unroll
      for (int j = 0; j < kMaxFeat; ++j)
        if (j < nf) sb[p * nf + j] = r.b[k][j];
    }
  }
};

// hist_comb: contiguous rows (the positions are the rows); bins of
// features [f_lo, f_lo + nf), nf <= 4 * kWords.
template <int SR, int kWords>
struct WordRows {
  using Bin = uint8_t;
  const uint8_t* bins;   // bin 0 of row 0
  const float* vals;     // g*w of row 0; h*w follows it
  long long bstride;     // bytes from a row's bins to the next row's
  long long vstride;     // floats from a row's values to the next row's
  int f_lo, nf;
  struct Regs {
    uint32_t w[SR][kWords + 1];   // the words covering the staged bins
    int off[SR];                  // bin f_lo's byte within w[k][0]
    float2 v[SR];
  };

  __device__ __forceinline__ void load(long long p0, long long hi,
                                       Regs& r) const {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const long long p = p0 + threadIdx.x + kThreads * k;
      if (p >= hi) continue;
      const uintptr_t a = reinterpret_cast<uintptr_t>(bins + p * bstride
                                                      + f_lo);
      const int off = (int)(a & 3u);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(a - off);
      // the words holding a byte of the span: a word read whole never
      // leaves the allocation's granule
      const int n_in = (off + nf + 3) >> 2;
      r.off[k] = off;
#pragma unroll
      for (int j = 0; j <= kWords; ++j)
        r.w[k][j] = j < n_in ? __ldg(wp + j) : 0u;
      const float* v = vals + p * vstride;
      r.v[k] = make_float2(__ldg(v), __ldg(v + 1));
    }
  }
  __device__ __forceinline__ void first(long long lo, long long hi,
                                        Regs& r) const {
    load(lo, hi, r);
  }
  __device__ __forceinline__ void next(long long p, long long hi,
                                       Regs& r) const {
    load(p, hi, r);
  }
  // bytes from one staged row's bins to the next's
  __device__ __forceinline__ int stride() const { return 4 * ((nf + 3) >> 2); }
  __device__ __forceinline__ void store(const Regs& r, float2* sv,
                                        uint8_t* sb) const {
    const int sw = (nf + 3) >> 2;
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int p = threadIdx.x + kThreads * k;
      sv[p] = r.v[k];
      uint32_t* d = reinterpret_cast<uint32_t*>(sb + p * 4 * sw);
      const unsigned sh = 8u * (unsigned)r.off[k];
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        if (j < sw) d[j] = __funnelshift_r(r.w[k][j], r.w[k][j + 1], sh);
    }
  }
};

// -- the walk ---------------------------------------------------------------

// Walk positions [lo, hi) of src in steps of kStage = kThreads * SR
// through the double-buffered stage sv [2][kStage], sb [2][kStage *
// src.stride()], calling acc(sv, sb, rows, p0) on each step's rows (from
// position p0) in position order.  Every thread of the block calls it;
// one barrier a step.
template <int SR, class Src, class Acc>
__device__ __forceinline__ void walk(const Src& src, long long lo,
                                     long long hi, float2* sv,
                                     typename Src::Bin* sb, Acc&& acc) {
  constexpr int kStage = kThreads * SR;
  const int stride = src.stride();
  typename Src::Regs regs;
  src.first(lo, hi, regs);
  int buf = 0;
  for (long long p0 = lo; p0 < hi; p0 += kStage, buf ^= 1) {
    float2* sv_b = sv + buf * kStage;
    typename Src::Bin* sb_b = sb + buf * kStage * stride;
    src.store(regs, sv_b, sb_b);
    // the stage is written; the other buffer's readers (the step before)
    // are done, so the next step may write it
    __syncthreads();
    if (p0 + kStage < hi) src.next(p0 + kStage, hi, regs);
    acc(sv_b, sb_b, (int)(hi - p0 < kStage ? hi - p0 : kStage), p0);
  }
}

// Range mode over positions [lo, hi) cut into nslices slices: warp w of
// this block owns unit blockIdx.x * kWarps + w of F * R (feature, 32-bin
// range) units and writes its cells of out [F, B, 2]; the block stages
// features [f_lo, ...) (src.f_lo) with src's stride.  cells_all [kWarps,
// 32, 2] (of the accumulator's type) and lst_all [kWarps, kThreads * SR]
// are the warps' shared state.  Every thread of the block calls it.
template <int SR, class Src, typename Acc = float>
__device__ __forceinline__ void range_hist(const Src& src, long long lo,
                                           long long hi, int nslices, int F,
                                           int B, int R, float2* sv,
                                           typename Src::Bin* sb,
                                           Acc* cells_all,
                                           unsigned* lst_all, float* out) {
  using Bin = typename Src::Bin;
  constexpr int kStage = kThreads * SR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kWarps + warp;
  const int f = u / R;                    // this warp's feature
  const int b_lo = (u % R) * kRange;      // and the first bin of its range
  const bool owner = u < F * R;
  const int stride = src.stride();
  const int col = f - src.f_lo;           // its staged column
  Acc* cells = cells_all + warp * 2 * kRange;
  unsigned* lst = lst_all + warp * kStage;
  cells[2 * lane] = Acc(0);   // compact_range's __syncwarp orders these
  cells[2 * lane + 1] = Acc(0);
  // the slices' cuts: slice s starts at lo + per * s (histblock::slice),
  // a multiple of 32 positions from lo
  long long per = (hi - lo + nslices - 1) / nslices;
  per = (per + 31) / 32 * 32;
  long long cut = lo + per;
  int cuts = nslices - 1;
  Acc tg = Acc(0), th = Acc(0);   // the finished slices' sums
  walk<SR>(src, lo, hi, sv, sb,
           [&](const float2* s_v, const Bin* s_b, int rows, long long p0) {
    if (!owner) return;
    const int n = histblock::compact_range<kStage / 32>(s_b + col, stride,
                                                        rows, b_lo, lst);
    int done = 0;
    while (cuts > 0 && cut < p0 + rows) {
      // the listed rows before the cut end the slice: its sums move to
      // tg, th and the cells restart at +0
      const unsigned at = (unsigned)(cut - p0);
      int split = 0;
      for (int i = lane; i < n; i += 32) split += (lst[i] >> 8) < at;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        split += __shfl_xor_sync(0xffffffffu, split, o);
      histblock::add_listed(s_v, lst, done, split, cells);
      tg = tg + cells[2 * lane];
      th = th + cells[2 * lane + 1];
      cells[2 * lane] = Acc(0);
      cells[2 * lane + 1] = Acc(0);
      __syncwarp();
      done = split;
      cut += per;
      --cuts;
    }
    histblock::add_listed(s_v, lst, done, n, cells);
  });
  __syncwarp();
  if (owner && b_lo + lane < B)
    reinterpret_cast<float2*>(out)[(size_t)f * B + b_lo + lane] =
        make_float2((float)(tg + cells[2 * lane]),
                    (float)(th + cells[2 * lane + 1]));
}

// The features [*f_lo, *f_lo + *nf) block x's units span (R units a
// feature).
__host__ __device__ inline void range_features(int x, int F, int R,
                                               int* f_lo, int* nf) {
  const int units = F * R;
  const int u0 = x * kWarps;
  const int u_last = u0 + kWarps - 1 < units ? u0 + kWarps - 1 : units - 1;
  *f_lo = u0 / R;
  *nf = u_last / R - *f_lo + 1;
}

}  // namespace histwalk
