// Fused split: the partition of one leaf segment and BOTH children's
// (sum g*w, sum h*w) histograms from one read of its rows.
//
// Replaces lightgbm_tpu/ops/pallas/fused_split.py make_fused_split
// (_fused_scan_kernel :181 with _hist_accumulate2 :84, pallas_call at
// :346): the rows of the segment [s0, s0 + cnt) are written to scratch in
// partition_scan's layout -- left rows in their original order, then
// right rows in REVERSED original order (csrc/partition.cu) -- nleft goes
// to a device scalar, and out[0] / out[1] receive the left / right
// child's histogram [F, B, 2].  The copyback (partition.cu) follows as a
// separate launch, as copyback_call follows the TPU scan.
//
// Each side's histogram is bitwise build_histogram_comb of that child's
// final range with max_rows = cnt / 2 + 1 (the grid slice 2's grower
// gives the smaller child): the grid is 2 sides x hist_blocks(cnt/2 + 1)
// blocks, each block owning the hist_comb slice of its side's
// DESTINATION range.  A left slice is a contiguous run of left rows in
// source order, walked forward; a right slice is a contiguous run of
// right rows walked BACKWARD (the right side is reversed).  The block
// finds where its run starts from the per-tile left counts (a binary
// search over their prefix), then walks one 1,024-row count tile per
// step: a tile holding none of its rows is skipped from the counts
// alone (so a sparse side costs its blocks the tiles that hold its
// rows, not the whole span), the others are marked (block scan), their
// selected rows staged in destination order in shared memory, written
// every column to scratch at their destination and added to the block's
// shared histogram in hist_comb's order (hist_block.cuh).  Each slice is
// walked by ceil(F / 8) blocks (blockIdx.z), each histogramming 8 of the
// features, one per warp (every cell is still the sequential sum of its
// rows in row order); the first of them moves the rows.  A last pass
// adds each side's partials in block order.  Every source row is moved
// once; the split column is read by the count pass and by the blocks
// whose runs cover its tile.
//
// fused_split_p2 replaces the pack=2 variant (_make_fused_p2,
// _fused_scan_kernel_p2 :126, pallas_call at :417): the same partition,
// nleft and histograms over one record per row (partition_common.cuh
// RecPtr).  The kernels are the same templates over the row-access
// policy; only the staging of a tile's selected rows differs: each
// record moves from source to scratch as its S / 16 16-byte words through
// registers (consecutive threads on consecutive words), and the words
// holding bins and (g*w, h*w) are staged to the same shared rows
// (hist_block.cuh stage_record_word).  Shared memory is therefore the
// pack=1 kernel's, F*B*8 + 1024*(F + 12) bytes.  A record is whole
// 16-byte words at any row index, so an odd s0 or cnt needs none of the
// TPU kernel's head-parity carry (partition_kernel3.py:283-330).
//
// Kernels per launch: the tile counts (partition_common.cuh), one block
// for their exclusive prefix and nleft, the scatter + histogram blocks,
// the partial reduction.  Positions depend on the data only, so every
// launch writes the same bytes.
//
// Bound on this card: bytes.  The rows are read and written once
// (cnt * (F + 28) bytes each way, cnt * S at pack=2) plus the split
// column and the 2 x F x B x 8-byte outputs; the partials add
// 4 * grid * F * B * 8 bytes, as in hist_comb.  Shared memory per block: F*B*8 + 1024*(F + 12) bytes
// (98,304 at F=28, B=256), opted in above 48 KB.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"
#include "partition_common.cuh"

namespace {

using part::kTile;
using part::RowPtrs;
using part::Split;
constexpr int kThreads = part::kThreads;
static_assert(kThreads == histblock::kThreads, "one block size");
// features one block histograms: one per warp
constexpr int kFeatPerBlock = kThreads / 32;

// exclusive prefix of the tile counts: lprefix[t] = left rows before
// tile t, lprefix[tiles] = nleft.  One block.
__global__ void __launch_bounds__(kThreads)
left_prefix(const int* __restrict__ tile_left, int tiles,
            int* __restrict__ lprefix, int* __restrict__ nleft) {
  int carry = 0;
  for (int base = 0; base < tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    int total;
    const int ex = part::block_exclusive_scan(
        i < tiles ? tile_left[i] : 0, &total);
    if (i < tiles) lprefix[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    lprefix[tiles] = carry;
    *nleft = carry;
  }
}

// this side's rows in tile t (the count pass's tiles)
__device__ __forceinline__ long long side_rows(const int* lprefix, int t,
                                               int side, long long cnt) {
  const long long left = lprefix[t + 1] - lprefix[t];
  if (side == 0) return left;
  const long long hi = min((long long)(t + 1) * kTile, cnt);
  return hi - (long long)t * kTile - left;
}

// A tile's m selected rows, source row src_idx[slot], to shared memory
// (bins sb [m, F], (g*w, h*w) sv [m, 2]) and, from the mover, every
// column to scratch row dst0 + slot.  pack=1: bins as 32-bit words (or
// bytes), the values one field at a time.
__device__ __forceinline__ void stage_slots(const RowPtrs& rows,
                                            const RowPtrs& scr, bool mover,
                                            const int* src_idx,
                                            long long dst0, int m, int F,
                                            uint8_t* sb, float* sv) {
  if ((F & 3) == 0) {
    const int W = F / 4;
    for (int i = threadIdx.x; i < m * W; i += kThreads) {
      const int slot = i / W, w = i - slot * W;
      const uint32_t v = reinterpret_cast<const uint32_t*>(
          rows.bins + (size_t)src_idx[slot] * F)[w];
      reinterpret_cast<uint32_t*>(sb + slot * F)[w] = v;
      if (mover)
        reinterpret_cast<uint32_t*>(
            scr.bins + (size_t)(dst0 + slot) * F)[w] = v;
    }
  } else {
    for (int i = threadIdx.x; i < m * F; i += kThreads) {
      const int slot = i / F, f = i - slot * F;
      const uint8_t v = rows.bins[(size_t)src_idx[slot] * F + f];
      sb[slot * F + f] = v;
      if (mover) scr.bins[(size_t)(dst0 + slot) * F + f] = v;
    }
  }
  for (int slot = threadIdx.x; slot < m; slot += kThreads) {
    const long long src = src_idx[slot];
    if (mover) part::copy_values(rows, scr, src, dst0 + slot);
    sv[2 * slot] = rows.vals[src * 3];
    sv[2 * slot + 1] = rows.vals[src * 3 + 1];
  }
}

// pack=2: each record's 16-byte words (all S / 16 from the mover, the
// ones holding bins and (g*w, h*w) from the other blocks), through the
// read-only data path: the launch writes scratch, never the rows
__device__ __forceinline__ void stage_slots(const part::RecPtr& rows,
                                            const part::RecPtr& scr,
                                            bool mover, const int* src_idx,
                                            long long dst0, int m, int F,
                                            uint8_t* sb, float* sv) {
  const int W = rows.S / 16;
  const int Wh = histblock::record_hist_words(rows.Fb);
  const int Wn = mover ? W : Wh;
  for (int i = threadIdx.x; i < m * Wn; i += kThreads) {
    const int slot = i / Wn, w = i - slot * Wn;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        rows.base + (size_t)src_idx[slot] * rows.S) + w);
    if (mover)
      reinterpret_cast<uint4*>(scr.base +
                               (size_t)(dst0 + slot) * rows.S)[w] = v;
    if (w < Wh)
      histblock::stage_record_word(v, w, F, rows.Fb, sb + slot * F,
                                   sv + 2 * slot);
  }
}

template <class Rows>
__global__ void __launch_bounds__(kThreads)
fused_scatter_hist(Rows rows, Rows scr, int F, int B, Split sp,
                   const int* __restrict__ lprefix, int tiles,
                   float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int cells = F * B * 2;
  float* hist = smem;                                  // [F, B, 2]
  float* sv = hist + cells;                            // [kTile, 2]
  int* src_idx = reinterpret_cast<int*>(sv + 2 * kTile);       // [kTile]
  uint8_t* sb = reinterpret_cast<uint8_t*>(src_idx + kTile);   // [kTile, F]
  histblock::zero(hist, cells);

  const int side = blockIdx.y;             // 0 left, 1 right
  // the features this block histograms (blockIdx.z); block z == 0 also
  // writes the rows to scratch
  const int f_lo = blockIdx.z * kFeatPerBlock;
  const int f_hi = min(F, f_lo + kFeatPerBlock);
  const bool mover = blockIdx.z == 0;
  const long long nl = lprefix[tiles];
  const long long side_cnt = side == 0 ? nl : sp.cnt - nl;
  // this block's slice [k_lo, k_hi) of the side's destination ranks
  long long k_lo, k_hi;
  histblock::slice(0, side_cnt, gridDim.x, blockIdx.x, &k_lo, &k_hi);
  const long long base = side == 0 ? sp.s0 : sp.s0 + nl;

  if (k_lo < k_hi) {
    // The tile holding the slice's first row.  Left: largest t with
    // lprefix[t] <= k_lo.  Right: destination rank j is right row
    // side_cnt - 1 - j in source order; largest t whose right rows before
    // it number <= that.
    const long long target = side == 0 ? k_lo : side_cnt - 1 - k_lo;
    int t_lo = 0, t_hi = tiles - 1;
    while (t_lo < t_hi) {
      const int mid = (t_lo + t_hi + 1) / 2;
      const long long p_mid = min((long long)mid * kTile, (long long)sp.cnt);
      const long long key = side == 0 ? lprefix[mid] : p_mid - lprefix[mid];
      if (key <= target) t_lo = mid; else t_hi = mid - 1;
    }
    // the destination rank of the first side row the walk meets: the
    // left walk goes forward from the tile's first row, the right walk
    // backward from its last
    int t = t_lo;
    long long run;
    if (side == 0) {
      run = lprefix[t];
    } else {
      const long long p_end = min((long long)(t + 1) * kTile,
                                  (long long)sp.cnt);
      run = side_cnt - (p_end - lprefix[t + 1]);
    }
    const int dir = side == 0 ? 1 : -1;
    // one count tile per step; a tile with no row of the slice is
    // skipped from the counts alone
    for (; run < k_hi && t >= 0 && t < tiles; t += dir) {
      const long long in_tile = side_rows(lprefix, t, side, sp.cnt);
      if (in_tile == 0 || run + in_tile <= k_lo) {
        run += in_tile;
        continue;
      }
      // this thread's kPer rows of the tile, in the walk's order
      const long long t0 = (long long)t * kTile;
      const int t_rows = (int)min((long long)kTile, sp.cnt - t0);
      unsigned bits = 0;
      for (int k = 0; k < part::kPer; ++k) {
        const int i = threadIdx.x * part::kPer + k;
        if (i < t_rows) {
          const long long p = side == 0 ? t0 + i : t0 + t_rows - 1 - i;
          const bool gl = part::go_left(
              part::bin_at(rows, F, sp.s0 + p, sp.feat), sp);
          if (gl == (side == 0)) bits |= 1u << k;
        }
      }
      int tot;
      const int off = part::block_exclusive_scan(__popc(bits), &tot);
      const long long first = run > k_lo ? run : k_lo;   // slot 0's rank
      const long long last = run + tot < k_hi ? run + tot : k_hi;
      const int m = last > first ? (int)(last - first) : 0;
      long long r = run + off;
      for (int k = 0; k < part::kPer; ++k) {
        if (!(bits & (1u << k))) continue;
        if (r >= k_lo && r < k_hi) {
          const int i = threadIdx.x * part::kPer + k;
          const long long p = side == 0 ? t0 + i : t0 + t_rows - 1 - i;
          src_idx[r - first] = (int)(sp.s0 + p);
        }
        ++r;
      }
      __syncthreads();
      // staged rows: bins and (g*w, h*w) to shared memory, every column
      // to scratch at the destination
      stage_slots(rows, scr, mover, src_idx, base + first, m, F, sb, sv);
      __syncthreads();
      histblock::accumulate(hist, sb, sv, m, F, B, f_lo, f_hi);
      run += tot;
    }
  }
  __syncthreads();
  float* out = partials + ((size_t)side * gridDim.x + blockIdx.x) * cells;
  for (int i = f_lo * B * 2 + threadIdx.x; i < f_hi * B * 2; i += kThreads)
    out[i] = hist[i];
}

// shared-memory bytes of a scatter block, either pack: the histogram, then
// per tile slot (g*w, h*w), the source index and the bins
int smem_bytes(int F, int B) {
  return F * B * 2 * 4 + kTile * (2 * 4 + 4 + F);
}

// The four launches of one fused split; 0 or the CUDA error code.
template <class Rows>
int launch(Rows rows, Rows scr, int* tile_left, int* lprefix, int* nleft,
           float* partials, float* out, int F, int B, const Split& sp,
           int nblocks, cudaStream_t s) {
  const int tiles = (sp.cnt + kTile - 1) / kTile;
  part::count_tiles<<<tiles, kThreads, 0, s>>>(
      part::bins_of(rows), part::bin_stride(rows, F), sp, tile_left);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  left_prefix<<<1, kThreads, 0, s>>>(tile_left, tiles, lprefix, nleft);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = smem_bytes(F, B);
  static int smem_set = 0;   // one per instantiation
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(fused_scatter_hist<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int fgroups = (F + kFeatPerBlock - 1) / kFeatPerBlock;
  fused_scatter_hist<Rows><<<dim3(nblocks, 2, fgroups), kThreads, smem, s>>>(
      rows, scr, F, B, sp, lprefix, tiles, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 2), 256, 0,
                               s>>>(partials, nblocks, cells, 2, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of a scatter block, either pack.
int fused_split_smem_bytes(int F, int B) { return smem_bytes(F, B); }

// Partition [s0, s0 + cnt) of the rows into scratch and write both
// children's histograms to out [2, F, B, 2].  Scratch buffers: tile_left
// i32 [ceil(cnt / 1024)], lprefix i32 [ceil(cnt / 1024) + 1], partials
// f32 [2, nblocks, F, B, 2]; nleft an i32 device scalar.  cnt must be
// > 0.  Returns the CUDA error code (0 on success).
int fused_split(uint8_t* bins, float* vals, int* rid, float* score,
                float* consts, uint8_t* sbins, float* svals, int* srid,
                float* sscore, float* sconsts, int* tile_left, int* lprefix,
                int* nleft, float* partials, float* out, int F, int B,
                int s0, int cnt, int feat, int sbin, int dl, int cat,
                int nanb, int nblocks, void* stream) {
  return launch(RowPtrs{bins, vals, rid, score, consts},
                RowPtrs{sbins, svals, srid, sscore, sconsts}, tile_left,
                lprefix, nleft, partials, out, F, B,
                Split{s0, cnt, feat, sbin, dl, cat, nanb}, nblocks,
                static_cast<cudaStream_t>(stream));
}

// The same over records: base and sbase u8 [n, S] (16-byte aligned), F
// bins per record, vals at byte Fb.
int fused_split_p2(uint8_t* base, uint8_t* sbase, int S, int Fb,
                   int* tile_left, int* lprefix, int* nleft, float* partials,
                   float* out, int F, int B, int s0, int cnt, int feat,
                   int sbin, int dl, int cat, int nanb, int nblocks,
                   void* stream) {
  return launch(part::RecPtr{base, S, Fb}, part::RecPtr{sbase, S, Fb},
                tile_left, lprefix, nleft, partials, out, F, B,
                Split{s0, cnt, feat, sbin, dl, cat, nanb}, nblocks,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
