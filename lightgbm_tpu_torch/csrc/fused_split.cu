// Fused split: the partition of one leaf segment and BOTH children's
// (sum g*w, sum h*w) histograms.
//
// Replaces lightgbm_tpu/ops/pallas/fused_split.py make_fused_split
// (_fused_scan_kernel :181 with _hist_accumulate2 :84, pallas_call at
// :346) and its pack=2 variant _make_fused_p2 (_fused_scan_kernel_p2
// :126, pallas_call at :417): the rows of the segment [s0, s0 + cnt) are
// written to scratch in partition_scan's layout -- left rows in their
// original order, then right rows in REVERSED original order
// (csrc/partition.cu) -- nleft goes to a device scalar, and out[0] /
// out[1] receive the left / right child's histogram [F, B, 2].  The
// copyback (partition.cu) follows as a separate launch, as copyback_call
// follows the TPU scan.  pack=1 reads the five row arrays (RowPtrs),
// pack=2 one record per row (partition_common.cuh RecPtr).
//
// Each side's histogram is bitwise build_histogram_comb of that child's
// final range with max_rows = cnt / 2 + 1: nblocks = hist_blocks(cnt / 2
// + 1) slices of the side's destination range (histblock::slice), every
// cell the sequential f32 sum of its slice's rows in row order from +0,
// the slices' sums added in slice order from 0.
//
// Bound on this card: bytes.  A split must read every row once and write
// it once (cnt * (F + 28) bytes each way, cnt * S at pack=2) and write
// 2 x F x B x 8 bytes of histograms: about 0.034 ms at the 1M-row
// segment (0.038 at pack=2).  Most splits are small (13,128 rows at the
// default route's median segment), where the bound is half a microsecond
// and the time is the chain of dependent steps.  The parent kernel (one
// fused pass) lost time four ways; what this design does about each:
//
// 1. Its per-tile loop was latency-bound (read the split column, scan,
//    gather the selected rows, add them: one phase after another, on
//    1,024-row count tiles).  Here the partition and the histograms are
//    two passes.  The partition pass (count_tiles, then fused_scatter,
//    one thread a row) moves each row to scratch with all its loads in
//    flight before its stores, and writes a feature-major copy of the
//    partitioned segment: a byte column a feature (cols [F, cnt]) and
//    the rows' (g*w, h*w) (gv [cnt, 2]).  The histogram pass (fused_hist)
//    reads that copy through a ring of kStages stages of kStageRows rows
//    in shared memory filled by cp.async, so the loads of the next stages
//    overlap the adds of this one.
// 2. Small segments got a handful of blocks.  The histogram grid is
//    (nblocks slices, 2 sides, groups), from the wrapper's geometry
//    (ops/fused_split.fused_geometry).  Up to 7 slices (range mode) each
//    warp owns a 32-bin range of one feature, one cell a lane: it lists
//    a stage's rows in its range with their values (list_cells: a ballot
//    a 32-row step) and every lane walks the list in row order, adding
//    the rows of its own cell (walk_listed); 112 blocks at F = 28 and
//    B = 256 on the median segment.  Above (feature mode) a block owns a
//    group of whole features, a warp a feature: the lanes holding one bin
//    form a group (found from one ballot a bit of the bin) whose lowest
//    lane adds its values in lane (= row) order; as many groups as bring
//    the launch to two blocks an SM (two at the 1M-row root).  Range
//    mode was the faster of the two from 2 to 7 slices, feature mode
//    from 8 (PERF.md).
// 3. Rows were read four times (each feature group re-scanned and
//    re-gathered every row).  Each row is read once by the partition
//    pass; a histogram block reads only its features' columns and the
//    values of its slice, one byte a row a feature and 8 bytes a row.
// 4. Four dependent launches a split (count_tiles, left_prefix, the
//    fused pass, reduce_partials).  Three where nblocks is 1
//    (count_tiles, fused_scatter, fused_hist writing out); above, a
//    fourth, histblock::reduce_partials, adds the slices' partials in
//    slice order from 0.  The left prefix is summed by each scatter
//    block itself.  Folding the partials into the last histogram block
//    of each (side, group), taken by an atomic ticket, was timed against
//    the fourth launch and gained nothing at 2, 8, 9 or 16 slices
//    (PERF.md), so the reduction is the one path.
//
// Every cell of a slice has one writer and sums its rows in row order
// from +0 in either mode, so the bits are those of the plain version
// (fused_split_ref); positions depend on the data only, so every launch
// writes the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"
#include "partition_common.cuh"

namespace {

using part::kTile;
using part::Pred;
using part::RecPtr;
using part::RowPtrs;
using part::Split;
constexpr int kThreads = part::kThreads;
static_assert(kThreads == histblock::kThreads, "one block size");
constexpr int kWarps = kThreads / 32;
// rows a ring stage holds, and the ring's stages
constexpr int kStageRows = 512;
constexpr int kStages = 4;
// bins a range-mode warp owns
constexpr int kRange = 32;

// -- the partition pass -----------------------------------------------------
// One thread a row: a block moves one 1,024-row count tile.
constexpr int kScatterThreads = kTile;
// bin words (pack=1) or record words (pack=2) a thread holds at once
constexpr int kRowWords = 8;

// Where a row goes: its scratch row d, and its segment position p in the
// feature-major copy (bin f at cols[f * cnt + p], (g*w, h*w) at gv[p]).
struct Dest {
  int s0, cnt;
  uint8_t* cols;
  float2* gv;
};

// Element i (0..3) of a 16-byte word.
__device__ __forceinline__ uint32_t word_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// pack=1: every column of row src to scratch row d, its bins and (g*w,
// h*w) to the copy.  All loads are issued before the first store: the
// bins as 32-bit words where F % 4 == 0 (up to kRowWords of them), else
// byte by byte.
__device__ __forceinline__ void move_row(const RowPtrs& s, const RowPtrs& d,
                                         int F, long long src, long long dst,
                                         const Dest& to) {
  const long long p = dst - to.s0;
  const float g = __ldg(s.vals + src * 3), h = __ldg(s.vals + src * 3 + 1);
  const float w = __ldg(s.vals + src * 3 + 2);
  const int rid = __ldg(s.rid + src);
  const float score = __ldg(s.score + src);
  const float c0 = __ldg(s.consts + src * 2), c1 = __ldg(s.consts + src * 2 + 1);
  if ((F & 3) == 0 && F <= 4 * kRowWords) {
    const uint32_t* sb = reinterpret_cast<const uint32_t*>(s.bins + src * F);
    uint32_t* db = reinterpret_cast<uint32_t*>(d.bins + dst * F);
    uint32_t b[kRowWords];
#pragma unroll
    for (int j = 0; j < kRowWords; ++j)
      if (4 * j < F) b[j] = __ldg(sb + j);
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) {
      if (4 * j >= F) continue;
      db[j] = b[j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        to.cols[(size_t)(4 * j + k) * to.cnt + p] = (uint8_t)(b[j] >> (8 * k));
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const uint8_t v = __ldg(s.bins + src * F + f);
      d.bins[dst * F + f] = v;
      to.cols[(size_t)f * to.cnt + p] = v;
    }
  }
  d.vals[dst * 3] = g;
  d.vals[dst * 3 + 1] = h;
  d.vals[dst * 3 + 2] = w;
  d.rid[dst] = rid;
  d.score[dst] = score;
  d.consts[dst * 2] = c0;
  d.consts[dst * 2 + 1] = c1;
  to.gv[p] = make_float2(g, h);
}

// pack=2: the record's S / 16 16-byte words (up to kRowWords at once),
// the bins (bytes below F) and (g*w, h*w) (bytes Fb, Fb + 4) also to the
// copy.
__device__ __forceinline__ void record_word_to_copy(const uint4& v, int w,
                                                    int F, int Fb,
                                                    long long p,
                                                    const Dest& to,
                                                    float* g, float* h) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int off = 16 * w + 4 * k;
    const uint32_t q = word_at(v, k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (off + j < F)
        to.cols[(size_t)(off + j) * to.cnt + p] = (uint8_t)(q >> (8 * j));
    if (off == Fb) *g = __uint_as_float(q);
    if (off == Fb + 4) *h = __uint_as_float(q);
  }
}

__device__ __forceinline__ void move_row(const RecPtr& s, const RecPtr& d,
                                         int F, long long src, long long dst,
                                         const Dest& to) {
  const long long p = dst - to.s0;
  const int W = s.S / 16;
  const uint4* a = reinterpret_cast<const uint4*>(s.base) + src * W;
  uint4* b = reinterpret_cast<uint4*>(d.base) + dst * W;
  float g = 0.f, h = 0.f;
  for (int w0 = 0; w0 < W; w0 += kRowWords) {
    uint4 v[kRowWords];
#pragma unroll
    for (int j = 0; j < kRowWords; ++j)
      if (w0 + j < W) v[j] = __ldg(a + w0 + j);
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) {
      if (w0 + j >= W) continue;
      b[w0 + j] = v[j];
      if (16 * (w0 + j) < s.Fb + 8)
        record_word_to_copy(v[j], w0 + j, F, s.Fb, p, to, &g, &h);
    }
  }
  to.gv[p] = make_float2(g, h);
}

// One block a 1,024-row count tile, one thread a row: the left rows of
// the tiles before it (their counts summed), the row's predicate (the
// count pass's, part::pred_left on the same Pred) and the tile's ballot
// scan give every row its destination (left rows in order, right rows
// reversed: partition_scan's layout), then each thread moves its row.
// The last block writes nleft.
template <class Rows>
__global__ void __launch_bounds__(kScatterThreads)
fused_scatter(Rows rows, Rows scr, int F, Pred pr,
              const int* __restrict__ tile_left, int* __restrict__ nleft,
              uint8_t* __restrict__ cols, float2* __restrict__ gv) {
  const Split& sp = pr.sp;
  constexpr int kW = kScatterThreads / 32;
  __shared__ int part_sum[kW];
  __shared__ int warp_left[kW];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // left rows of the tiles before this one
  int acc = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kScatterThreads)
    acc += tile_left[b];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  // this row's side, and the left rows of the warps before this one
  const int i = (int)blockIdx.x * kTile + (int)threadIdx.x;
  const bool live = i < sp.cnt;
  const long long src = (long long)sp.s0 + i;
  const bool left =
      live && part::pred_left(part::bin_at(rows, F, src, sp.feat), pr);
  const unsigned lm = __ballot_sync(0xffffffffu, left);
  if (lane == 0) {
    part_sum[warp] = acc;
    warp_left[warp] = __popc(lm);
  }
  __syncthreads();
  int left_before = 0, warps_before = 0, tile_left_rows = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    left_before += part_sum[w];
    warps_before += w < warp ? warp_left[w] : 0;
    tile_left_rows += warp_left[w];
  }
  if (live) {
    const int l_in = warps_before + __popc(lm & ((1u << lane) - 1u));
    const int r_in = (int)threadIdx.x - l_in;
    const int right_before = (int)blockIdx.x * kTile - left_before;
    const long long dst = left ? (long long)sp.s0 + left_before + l_in
                               : (long long)sp.s0 + sp.cnt - 1
                                     - (right_before + r_in);
    move_row(rows, scr, F, src, dst, Dest{sp.s0, sp.cnt, cols, gv});
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    *nleft = left_before + tile_left_rows;
}

// -- the histogram pass -----------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Bytes [a, a + n) of global memory into shared memory as 16-byte
// chunks from the 16-byte boundary at or below a (the chunk past the end
// reads only up to a + n); byte a lands at s + (a % 16).  Every thread
// of the block issues.
__device__ __forceinline__ void copy_bytes(const uint8_t* a, long long n,
                                           uint8_t* s) {
  const int head = (int)(reinterpret_cast<uintptr_t>(a) & 15);
  const uint8_t* a0 = a - head;
  const long long total = n + head;
  for (long long c = threadIdx.x; 16 * c < total; c += kThreads) {
    const long long left = total - 16 * c;
    cp_async16(s + 16 * c, a0 + 16 * c, left < 16 ? (int)left : 16);
  }
}

// Shared bytes of one staged feature's column and of the (g*w, h*w) of a
// stage, each with 16 bytes for the head
constexpr int kColBytes = (kStageRows + 16 + 15) / 16 * 16;
constexpr int kGvBytes = (kStageRows * 8 + 16 + 15) / 16 * 16;

// Features a histogram block stages: feature mode its fg; range mode
// the most its 8 units can span (a bound).
__host__ __device__ inline int staged_features(int fg, int parts) {
  return parts == 1 ? fg : (kWarps - 1) / parts + 2;
}

// Shared bytes of a histogram block: feature mode (parts == 1) the [fg,
// B, 2] histogram, range mode each warp's list of a stage's rows (16
// bytes a row); then kStages stages of the staged features' columns and
// the (g*w, h*w).
__host__ __device__ inline int hist_smem(int fg, int parts, int B) {
  const int own = parts == 1 ? round16(fg * B * 8) : kWarps * kStageRows * 16;
  return own
         + kStages * (staged_features(fg, parts) * kColBytes + kGvBytes);
}

// The group's lowest lane adds the group's values one by one in lane (=
// row) order to cell b of hf [B, 2]; row of lane j: row t + j of the
// stage.
__device__ __forceinline__ void add_group(float* hf, const float2* gv,
                                          int b, bool live, unsigned peers,
                                          int t) {
  const int lane = threadIdx.x % 32;
  if (live && (__ffs(peers) - 1) == lane) {
    float g = hf[2 * b], h = hf[2 * b + 1];
    unsigned m = peers;
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const float2 v = gv[t + j];
      g += v.x;
      h += v.y;
    }
    hf[2 * b] = g;
    hf[2 * b + 1] = h;
  }
}

// Feature mode: add the stage's m rows, in row order, to one feature's
// cells hf [B, 2] from its staged column col, 32 rows a step: the lanes
// holding one bin form a group whose lowest lane adds its values in lane
// (= row) order.  The bins and groups of kBatch steps are found before
// their adds, so those reads overlap; bins are below 2^nbits.
constexpr int kBatch = 4;
__device__ __forceinline__ void accumulate(float* hf, const uint8_t* col,
                                           const float2* gv, int m, int B,
                                           int nbits) {
  const int lane = threadIdx.x % 32;
  for (int t = 0; t < m; t += 32 * kBatch) {
    int b[kBatch];
    unsigned peers[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = t + 32 * k + lane;
      b[k] = r < m ? (int)col[r] : B;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) peers[k] = __ballot_sync(~0u, b[k] < B);
    // the live lanes holding each lane's bin: one ballot a bit of the
    // bin, the steps' ballots interleaved
    for (int bit = 0; bit < nbits; ++bit) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool on = (b[k] >> bit) & 1;
        const unsigned m = __ballot_sync(~0u, on);
        peers[k] &= on ? m : ~m;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      add_group(hf, gv, b[k], b[k] < B, peers[k], t + 32 * k);
      __syncwarp();
    }
  }
}

// Range mode: the stage's m rows whose bin (in the warp's feature's
// column col) lies in [b_lo, b_lo + 32), in row order, listed with their
// (g*w, h*w): (cell, g*w, h*w) at lst[i] (x holds the cell's bits).
// Returns how many.  Each lane reads its row of kSteps 32-row steps
// before their ballots, so those reads overlap.
__device__ __forceinline__ int list_cells(const uint8_t* col,
                                          const float2* gv, int m, int b_lo,
                                          float4* lst) {
  const unsigned lane = threadIdx.x % 32;
  constexpr int kSteps = 8;   // 32-row steps read at once
  int n = 0;
  for (int t = 0; t < m; t += 32 * kSteps) {
    unsigned rel[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int r = t + 32 * k + (int)lane;
      rel[k] = r < m ? (unsigned)((int)col[r] - b_lo) : 32u;
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const bool live = rel[k] < 32u;
      const unsigned msk = __ballot_sync(0xffffffffu, live);
      if (live) {
        const float2 v = gv[t + 32 * k + lane];
        lst[n + __popc(msk & ((1u << lane) - 1u))] =
            make_float4(__uint_as_float(rel[k]), v.x, v.y, 0.f);
      }
      n += __popc(msk);
    }
  }
  __syncwarp();
  return n;
}

// Range mode: lane c of the warp owns cell c of its 32-bin range, its
// sums in g, h.  Every lane reads every listed row, kWalk at a time
// (broadcasts: one address a warp), in list (= row) order, and adds the
// rows of its own cell: g + v where the cell is its own, else g as it
// was.
constexpr int kWalk = 4;
__device__ __forceinline__ void walk_listed(const float4* lst, int n,
                                            float& g, float& h) {
  const unsigned lane = threadIdx.x % 32;
  for (int i = 0; i < n; i += kWalk) {
    float4 e[kWalk];
#pragma unroll
    for (int k = 0; k < kWalk; ++k)
      // past the list: cell 255, no lane's
      e[k] = i + k < n ? lst[i + k]
                       : make_float4(__uint_as_float(255u), 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      const bool mine = __float_as_uint(e[k].x) == lane;
      const float ng = g + e[k].y, nh = h + e[k].z;
      g = mine ? ng : g;
      h = mine ? nh : h;
    }
  }
}

// Stage copies: each of the nfs staged features' columns (features fa,
// fa + 1, ...) and the (g*w, h*w) of segment positions [p0, p0 + m),
// into the stage at s (the columns kColBytes apart, the values after sf
// of them).
__device__ __forceinline__ void issue_stage(const uint8_t* cols,
                                            const float2* gvs, int cnt,
                                            int fa, int nfs, int sf,
                                            long long p0, int m, uint8_t* s) {
  for (int i = 0; i < nfs; ++i)
    copy_bytes(cols + (size_t)(fa + i) * cnt + p0, m, s + i * kColBytes);
  copy_bytes(reinterpret_cast<const uint8_t*>(gvs + p0), 8LL * m,
             s + sf * kColBytes);
}

// Where issue_stage put position p0 of staged column i (feature f).
__device__ __forceinline__ const uint8_t* staged_col(const uint8_t* s,
                                                     const uint8_t* cols,
                                                     int cnt, int i, int f,
                                                     long long p0) {
  return s + i * kColBytes
         + (int)(reinterpret_cast<uintptr_t>(cols + (size_t)f * cnt + p0)
                 & 15);
}

// Block (x, side, z) sums slice x of the side's positions of the
// feature-major copy.  Feature mode (parts == 1): features [z * fg, z *
// fg + fg), warp w owning features z * fg + w + 8 k, every bin.  Range
// mode (parts = ceil(B / 32) > 1): warp w owns unit u = z * 8 + w (below
// F * parts): feature u / parts, bins [(u % parts) * 32, ... + 32), one
// cell a lane.
__global__ void __launch_bounds__(kThreads, 1)
fused_hist(const uint8_t* __restrict__ cols, const float2* __restrict__ gvs,
           int F, int B, int cnt, const int* __restrict__ nleft, int fg,
           int parts, float* __restrict__ partials,
           float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nb = gridDim.x, side = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool ranged = parts > 1;
  // range mode: the warp's unit
  const int u = z * kWarps + warp;
  const bool owner = ranged && u < F * parts;
  const int uf = ranged ? u / parts : 0;
  const int b_lo = ranged ? (u % parts) * kRange : 0;
  // the features the block stages: [fa, fa + nfs)
  const int fa = ranged ? z * kWarps / parts : z * fg;
  const int f_end = ranged ? min(F, (min(z * kWarps + kWarps, F * parts) - 1)
                                        / parts + 1)
                           : min(F, z * fg + fg);
  const int nfs = f_end - fa;
  float* hist = reinterpret_cast<float*>(smem);      // [nfs, B, 2]
  float4* lst = reinterpret_cast<float4*>(smem) + warp * kStageRows;
  uint8_t* ring = smem + (ranged ? kWarps * kStageRows * 16
                                 : round16(fg * B * 8));
  const int sb = staged_features(fg, parts) * kColBytes + kGvBytes;
  float g = 0.f, h = 0.f;    // range mode: this lane's cell
  const int nbits = B > 1 ? 32 - __clz(B - 1) : 0;
  if (!ranged) histblock::zero(hist, nfs * B * 2);

  const long long nl = *nleft;
  const long long side_cnt = side == 0 ? nl : cnt - nl;
  const long long base = side == 0 ? 0 : nl;   // segment position
  long long k_lo, k_hi;
  histblock::slice(0, side_cnt, nb, blockIdx.x, &k_lo, &k_hi);
  const long long p_lo = base + k_lo;
  const long long rows = k_hi - k_lo;
  const int steps = (int)((rows + kStageRows - 1) / kStageRows);
  const int sf = staged_features(fg, parts);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < steps)
      issue_stage(cols, gvs, cnt, fa, nfs, sf, p_lo + (long long)k * kStageRows,
                  (int)min((long long)kStageRows, rows - (long long)k * kStageRows),
                  ring + k * sb);
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // this step's stage, taken before another stage is refilled
    const long long p0 = p_lo + (long long)k * kStageRows;
    const int m = (int)min((long long)kStageRows, rows - (long long)k * kStageRows);
    const uint8_t* s = ring + (k % kStages) * sb;
    const float2* gv = reinterpret_cast<const float2*>(
        s + sf * kColBytes
        + (int)(reinterpret_cast<uintptr_t>(gvs + p0) & 15));
    // refill the stage the step before consumed
    const int kn = k + kStages - 1;
    if (kn < steps)
      issue_stage(cols, gvs, cnt, fa, nfs, sf,
                  p_lo + (long long)kn * kStageRows,
                  (int)min((long long)kStageRows,
                           rows - (long long)kn * kStageRows),
                  ring + (kn % kStages) * sb);
    cp_async_commit();
    if (ranged) {
      if (owner) {
        const int n = list_cells(staged_col(s, cols, cnt, uf - fa, uf, p0),
                                 gv, m, b_lo, lst);
        walk_listed(lst, n, g, h);
      }
    } else {
      for (int f = warp; f < nfs; f += kWarps)
        accumulate(hist + f * B * 2,
                   staged_col(s, cols, cnt, f, fa + f, p0), gv, m, B, nbits);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's cells: feature mode [fa, fa + nfs) x every bin, range
  // mode each owner warp's 32 (one a lane, those below B); one slice
  // writes out (its sums from +0 are the reduction's bits), more write
  // their partials
  const size_t all = (size_t)F * B * 2;
  const size_t off = ranged ? ((size_t)uf * B + b_lo + lane) * 2
                            : (size_t)fa * B * 2;
  const bool live_cell = owner && b_lo + lane < B;
  const int mine = ranged ? 0 : nfs * B * 2;
  float* dst = nb == 1 ? out + side * all
                       : partials + ((size_t)side * nb + blockIdx.x) * all;
  if (live_cell) {
    dst[off] = g;
    dst[off + 1] = h;
  }
  for (int i = threadIdx.x; i < mine; i += kThreads) dst[off + i] = hist[i];
}

int set_smem(int smem) {
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  return 0;
}

// The launches of one fused split on the wrapper's geometry: tiles count
// tiles; the histogram on (nblocks, 2, groups) blocks, in feature mode
// (parts == 1) of fg features, in range mode (parts > 1) of 8 (feature,
// 32-bin range) units; the reduction where nblocks > 1.  0 or the CUDA
// error code, cudaErrorInvalidValue for a geometry that misses a row or
// a cell.
template <class Rows>
int launch(Rows rows, Rows scr, int F, int B, const Pred& pr, int tiles,
           int nblocks, int groups, int fg, int parts, int* tile_left,
           int* nleft, uint8_t* cols, float* gv, float* partials, float* out,
           cudaStream_t s) {
  const Split& sp = pr.sp;
  const bool cells_ok =
      parts == 1 ? (fg >= 1 && (long long)groups * fg >= F
                    && (long long)(groups - 1) * fg < F)
                 : (parts >= 2 && (long long)parts * kRange >= B
                    && (long long)(parts - 1) * kRange < B
                    && (long long)groups * kWarps >= (long long)F * parts
                    && (long long)(groups - 1) * kWarps < (long long)F * parts);
  if (sp.cnt < 1 || tiles < 1 || (long long)tiles * kTile < sp.cnt
      || (long long)(tiles - 1) * kTile >= sp.cnt || nblocks < 1
      || groups < 1 || !cells_ok || (nblocks > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  part::count_tiles<<<tiles, kThreads, 0, s>>>(
      part::bins_of(rows), part::bin_stride(rows, F), pr, tile_left);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_scatter<Rows><<<tiles, kScatterThreads, 0, s>>>(
      rows, scr, F, pr, tile_left, nleft, cols,
      reinterpret_cast<float2*>(gv));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = hist_smem(fg, parts, B);
  const int rc = set_smem(smem);
  if (rc != 0) return rc;
  fused_hist<<<dim3(nblocks, 2, groups), kThreads, smem, s>>>(
      cols, reinterpret_cast<const float2*>(gv), F, B, sp.cnt, nleft, fg,
      parts, partials, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || nblocks == 1) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 2), 256, 0,
                               s>>>(partials, nblocks, cells, 2, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one histogram block (feature mode, parts == 1:
// fg features; range mode: 8 units).
int fused_hist_smem_bytes(int fg, int parts, int B) {
  return hist_smem(fg, parts, B);
}

// Partition [s0, s0 + cnt) of the rows into scratch and write both
// children's histograms to out [2, F, B, 2], on the wrapper's geometry
// (ops/fused_split.fused_geometry): tiles = ceil(cnt / 1024) count
// tiles; nblocks slices a side; groups histogram blocks a slice and
// side, of fg features (parts == 1) or 8 (feature, 32-bin range) units
// (parts = ceil(B / 32)); above one slice the reduction adds the
// partials.  Scratch buffers: tile_left i32 [tiles]; cols u8 [F, cnt]
// and gv f32 [cnt, 2] (8-byte aligned), the feature-major copy of the
// partitioned segment; partials f32 [2, nblocks, F, B, 2] where
// nblocks > 1 (else may be null); nleft an i32 device scalar; words
// nwords (<= 8) host membership words (read by categorical splits; may
// be null when nwords is 0).  cnt must be > 0.  Returns the CUDA error
// code (0 on success; cudaErrorInvalidValue for a geometry that misses a
// row or a cell, or for nwords > 8).
int fused_split(uint8_t* bins, float* vals, int* rid, float* score,
                float* consts, uint8_t* sbins, float* svals, int* srid,
                float* sscore, float* sconsts, int* tile_left, int* nleft,
                uint8_t* cols, float* gv, float* partials, float* out, int F,
                int B, int s0, int cnt, int feat, int sbin, int dl, int cat,
                int nanb, int nwords, const unsigned* words, int tiles,
                int nblocks, int groups, int fg, int parts, void* stream) {
  Pred pr;
  if (!part::make_pred(Split{s0, cnt, feat, sbin, dl, cat, nanb}, nwords,
                       words, &pr))
    return (int)cudaErrorInvalidValue;
  return launch(RowPtrs{bins, vals, rid, score, consts},
                RowPtrs{sbins, svals, srid, sscore, sconsts}, F, B, pr,
                tiles, nblocks, groups, fg, parts, tile_left, nleft, cols,
                gv, partials, out, static_cast<cudaStream_t>(stream));
}

// The same over records: base and sbase u8 [n, S] (16-byte aligned), F
// bins per record, vals at byte Fb.
int fused_split_p2(uint8_t* base, uint8_t* sbase, int S, int Fb,
                   int* tile_left, int* nleft, uint8_t* cols, float* gv,
                   float* partials, float* out, int F, int B, int s0,
                   int cnt, int feat, int sbin, int dl, int cat, int nanb,
                   int nwords, const unsigned* words, int tiles,
                   int nblocks, int groups, int fg, int parts,
                   void* stream) {
  Pred pr;
  if (!part::make_pred(Split{s0, cnt, feat, sbin, dl, cat, nanb}, nwords,
                       words, &pr))
    return (int)cudaErrorInvalidValue;
  return launch(RecPtr{base, S, Fb}, RecPtr{sbase, S, Fb}, F, B, pr, tiles,
                nblocks, groups, fg, parts, tile_left, nleft, cols, gv,
                partials, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
