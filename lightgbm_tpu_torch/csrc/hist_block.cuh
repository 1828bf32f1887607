// The deterministic block histogram shared by hist_comb.cu, stream_grad.cu,
// fused_split.cu and hist_rows.cu.
//
// A launch sums the (g*w, h*w) values of a row range into an [F, B, 2]
// f32 histogram without float atomics.  The range is cut into one slice
// per block (slice(): equal slices rounded up to 32 rows).  A block
// stages up to kChunk rows of bins and values in shared memory and
// accumulate() adds them to its shared histogram: each warp OWNS a fixed
// set of features, so every (feature, bin) cell has one writer; inside a
// 32-row tile the lanes holding the same bin form a group
// (__match_any_sync) whose lowest lane adds the group's values one by one
// in lane order.  Every cell of a block's histogram is therefore the
// sequential f32 sum of its rows in row order, whatever the chunking.
// Each block writes its partial histogram out and reduce_partials() adds
// the partials of every cell in block order, starting from 0.
// compact_range() and add_listed() are the same sum for a warp that owns
// a 32-bin range of one feature (hist_rows.cu in one launch).  Three
// kernels that stage the same rows of the same slices in the same order
// give the same bits; the plain version
// (hist_kernel2.build_histogram_comb_ref) adds in this order too.
// smem_bytes and accumulate take the staged bins' type: uint8_t (the
// default, every kernel of the physical path) or uint16_t (hist_rows.cu
// at max_bin > 255).  accumulate, add_listed and zero also take the
// accumulator's type: float (the default, every kernel but one mode) or
// double (hist_rows.cu's gpu_use_dp mode, which adds the f32 values in
// f64 in the same order).  stage_record_word stages the bins and (g*w, h*w)
// of a pack=2 record (partition_common.cuh RecPtr) from its 16-byte
// words, into the same sb / sv rows accumulate() reads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace histblock {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;     // rows staged in shared memory per step

// This block's slice [*b_lo, *b_hi) of rows [lo, hi) cut into nblocks
// slices (hist_kernel2.block_ranges is the same cut).
__device__ __forceinline__ void slice(long long lo, long long hi,
                                      int nblocks, int blk,
                                      long long* b_lo, long long* b_hi) {
  long long per = (hi - lo + nblocks - 1) / nblocks;
  per = (per + 31) / 32 * 32;
  long long a = lo + per * blk;
  long long b = a + per;
  if (a > hi) a = hi;
  if (b > hi) b = hi;
  *b_lo = a;
  *b_hi = b;
}

// Shared-memory bytes of one block: histogram, staged values and bins.
template <typename BinT = uint8_t>
__host__ __device__ inline int smem_bytes(int F, int B) {
  return F * B * 2 * 4 + kChunk * 2 * 4 + kChunk * F * (int)sizeof(BinT);
}

template <typename Acc = float>
__device__ __forceinline__ void zero(Acc* hist, int cells) {
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = Acc(0);
}

// Add `rows` staged rows (bins sb [rows, F], values sv [rows, 2] f32,
// in row order) into the cells of features [f_lo, f_hi) of hist
// [F, B, 2].  blockDim.x must be kThreads; the caller synchronises
// before (staging done) and after (staging reused).  Blocks that share
// a slice may split its features between them: each cell still sums
// its rows in row order.
template <typename BinT, typename Acc = float>
__device__ __forceinline__ void accumulate(Acc* hist, const BinT* sb,
                                           const float* sv, int rows, int F,
                                           int B, int f_lo = 0,
                                           int f_hi = 1 << 30) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (f_hi > F) f_hi = F;
  for (int f = f_lo + warp; f < f_hi; f += kWarps) {
    Acc* hf = hist + f * B * 2;
    for (int t = 0; t < rows; t += 32) {
      const int r = t + lane;
      const int bin = r < rows ? (int)sb[r * F + f] : 0;
      const bool live = r < rows && bin < B;
      // dead lanes get keys no live lane can hold, so each is alone
      const unsigned peers = __match_any_sync(0xffffffffu,
                                              live ? bin : 0x10000 + lane);
      if (live && (__ffs(peers) - 1) == lane) {
        // the cell takes the group's values one by one in lane (= row)
        // order
        Acc g = hf[2 * bin], h = hf[2 * bin + 1];
        unsigned m = peers;
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          g += (Acc)sv[2 * (t + j)];
          h += (Acc)sv[2 * (t + j) + 1];
        }
        hf[2 * bin] = g;
        hf[2 * bin + 1] = h;
      }
      __syncwarp();
    }
  }
}

// The bin-range variant of accumulate(), for one warp: the warp owns the
// 32 cells of bins [b_lo, b_lo + 32) of one feature, in a warp-private
// shared array cells [32, 2] (cell c: bin b_lo + c).  compact_range()
// lists the staged rows whose bin falls in the range, in row order, as
// (row << 8 | bin - b_lo) in the warp-private lst, and returns how many;
// sb_f points at the feature's bin of staged row 0 (rows nf apart), rows
// is at most 32 * kTiles.  Each lane reads its row of every 32-row tile
// first, so those reads overlap.  add_listed() adds the listed rows
// [a, b), 32 at a time, with sv the staged (g*w, h*w): the lanes holding
// one cell form a group (__match_any_sync) whose lowest lane adds the
// group's values one by one in lane (= row) order.  Every cell is the
// sequential f32 sum of its rows in row order, the bits accumulate()
// gives; rows whose bin lies outside the range are skipped.  Both are
// called by all 32 lanes of the warp.
template <int kTiles, typename BinT>
__device__ __forceinline__ int compact_range(const BinT* sb_f, int nf,
                                             int rows, int b_lo,
                                             unsigned* lst) {
  const unsigned lane = threadIdx.x % 32;
  unsigned rel[kTiles];
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int r = 32 * k + (int)lane;
    rel[k] = r < rows ? (unsigned)((int)sb_f[r * nf] - b_lo) : 32u;
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const bool live = rel[k] < 32u;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (live)
      lst[n + __popc(m & ((1u << lane) - 1u))] =
          ((unsigned)(32 * k + lane) << 8) | rel[k];
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

template <typename Acc = float>
__device__ __forceinline__ void add_listed(const float2* sv,
                                           const unsigned* lst, int a, int b,
                                           Acc* cells) {
  const int lane = threadIdx.x % 32;
  for (int c0 = a; c0 < b; c0 += 32) {
    const bool valid = c0 + lane < b;
    // dead lanes get keys no live lane can hold, so each is alone
    const unsigned cell = valid ? (lst[c0 + lane] & 255u) : 0x100u + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    if (valid && (__ffs(peers) - 1) == lane) {
      Acc g = cells[2 * cell], h = cells[2 * cell + 1];
      unsigned m = peers;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float2 v = sv[lst[c0 + j] >> 8];
        g += (Acc)v.x;
        h += (Acc)v.y;
      }
      cells[2 * cell] = g;
      cells[2 * cell + 1] = h;
    }
    __syncwarp();
  }
}

// The 16-byte words of a record holding its bins and (g*w, h*w): bytes
// [0, Fb + 8).
__host__ __device__ inline int record_hist_words(int Fb) {
  return (Fb + 8 + 15) / 16;
}

// Stage the part of word w (bytes [16 w, 16 w + 16)) of a record that a
// histogram reads: its bins (bytes < F) into sb_row [F] and g*w, h*w
// (bytes Fb and Fb + 4) into sv_row [2].  Little-endian: byte j of a
// 32-bit lane is bits [8 j, 8 j + 8).
__device__ __forceinline__ void stage_record_word(uint4 v, int w, int F,
                                                  int Fb, uint8_t* sb_row,
                                                  float* sv_row) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int off = w * 16 + k * 4;
    if (off < F) {
      if ((F & 3) == 0) {
        *reinterpret_cast<uint32_t*>(sb_row + off) = u[k];
      } else {
        for (int j = 0; j < 4 && off + j < F; ++j)
          sb_row[off + j] = (uint8_t)(u[k] >> (8 * j));
      }
    } else if (off == Fb) {
      sv_row[0] = __uint_as_float(u[k]);
    } else if (off == Fb + 4) {
      sv_row[1] = __uint_as_float(u[k]);
    }
  }
}

// out[s, i] = sum over b of partials[s, b, i], in block order from 0, for
// `sets` independent sets of nblocks partials of `cells` cells each.
__global__ void reduce_partials(const float* __restrict__ partials,
                                int nblocks, int cells, int sets,
                                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)cells * sets) return;
  const int s = (int)(i / cells);
  const int c = (int)(i % cells);
  const float* p = partials + (size_t)s * nblocks * cells + c;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc += p[(size_t)b * cells];
  out[i] = acc;
}

inline int reduce_grid(int cells, int sets) {
  return (int)(((long long)cells * sets + 255) / 256);
}

}  // namespace histblock
