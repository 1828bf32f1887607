// Row-indexed gradient histogram: separate bins and values, read through
// an optional row index.
//
// Replaces lightgbm_tpu/ops/pallas/hist_kernel2.py build_histogram_pallas2
// (_hist2_kernel, pallas_call at :339) and lightgbm_tpu/ops/pallas/
// hist_kernel.py build_histogram_pallas (_hist_kernel, pallas_call at
// :122), which compute one function: hist[f, b, c] = the sum of vals[r, c]
// over the rows r the range selects whose bins[r, f] == b, [F, B, 2] f32.
// The TPU kernels contract nibble one-hots on the MXU (v2 with bf16
// operands); here every (row, feature) adds its exact f32 values, in the
// order of hist_block.cuh.
//
// Inputs: bins [n, F] row-major, uint8 or uint16 (max_bin > 255); vals
// f32 [n, 2] (g*w, h*w) in original row order, 8-byte aligned; an
// optional i32 index of positions -> rows (the row-order grower's
// row_order, every entry in [0, n)); range i32[2] (start, count) of
// positions, read from device memory so a child range the device
// computed needs no host read.  Without an index the positions are the
// rows.  The JAX package gathers the rows (jnp.take) before its kernel;
// this kernel reads the bins and values through the index itself, so a
// split needs no [count, F] copy.
//
// Determinism: no float atomics.  The position range is cut into
// `nslices` slices (histblock::slice, the same cut as
// hist_kernel2.block_ranges, chosen by the wrapper from the caller's
// bound on count: hist_kernel2.rows_blocks).  Every cell is the
// sequential f32 sum of its slice's rows in position order, from +0, and
// the slices' sums are added in slice order from 0, so the plain version
// (hist_kernel2.build_histogram_rows_ref) gives these bits on the CPU.
// Two kernels keep that order; the wrapper picks one and its grid
// (hist_kernel2.rows_geometry) and passes them in:
//
// - One or two slices (a bound on count up to 32,768 positions at
//   B = 1024, 8,192 at B = 256: every child of a parent of up to 65,534
//   rows): hist_rows_direct, one launch that writes out.  A warp owns one
//   feature's 32-bin range, its 32 cells in warp-private shared memory,
//   and walks all the range's rows (histblock::compact_range lists a
//   step's rows in its range, histblock::add_listed adds them, 32 at a
//   time), adding the first slice's sums to +0 where the second begins
//   and the second's to that at the end, the reduction's order; a
//   block's eight warps are eight consecutive (feature, range) units, so
//   the grid is ceil(F * ceil(B / 32) / 8) blocks (112 at F = 28,
//   B = 1024) and each cell has one writer.
// - More slices (the root, large children): hist_rows_partial, grid
//   (slices, ceil(F / fc)), each warp owning one of the block's fc
//   features in a shared [fc, B, 2] histogram (histblock::accumulate;
//   the whole [28, 1024, 2] would need 229,376 bytes), then
//   histblock::reduce_partials adds the partials in slice order.
//
// The gpu_use_dp mode (hist_rows_f64; no TPU kernel: it replaces the XLA
// scatter-add of lightgbm_tpu/ops/histogram.py:178-190 under x64) is the
// same two kernels instantiated with a double accumulator (Acc): every
// cell is the sequential f64 sum of its slice's f32 values in position
// order from +0, the slices' f64 sums are added in slice order from 0
// (the partials, [nslices, F, B, 2] f64, by reduce_partials_f64), and the
// total is rounded to f32 once; the output stays [F, B, 2] f32, so the
// sibling subtraction and the split tail are unchanged.  Its shared
// histogram and per-warp cells are twice the bytes (the wrapper's
// rows_feature_chunk halves the features a partial block takes where
// they would not fit).
//
// Bound on this card: bytes at the root, latency at small children.  A
// launch must read count * (F * bin bytes + 8) bytes of bins and values
// (+ 4 per position through the index) and write F * B * 8; at the 1M-row
// root that is 64 MB and the partials add 2 * slices * F * B * 8 (the
// wrapper scales the slice count down with B so that they stay near a
// fifth of the input).  A 3,000-row child moves ~200 KB, so its time is
// the chain of dependent reads (index, then the row's values and bins)
// and the per-warp walk over the rows.  Both kernels stage a step of
// positions (512 in hist_rows_partial, 1,024 in hist_rows_direct)
// through registers into a double-buffered shared stage: a step stores
// the previous step's registers, meets one barrier, issues the next
// step's value and bin loads (through row ids loaded a step earlier) and
// the row ids of the step after, and then accumulates while those loads
// are in flight.  In the direct kernel 112 blocks (rather than 4 at a
// 3,000-row child) put more loads in flight; each warp's walk over every
// row of the child bounds it (a one-row-at-a-time shuffle to the owning
// lane took 1.5 times as long as listing a step's rows and adding them
// 32 at a time).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"
#include "hist_walk.cuh"

namespace {

using histblock::kThreads;
using histblock::kWarps;
using histwalk::kRange;

// positions a thread stages a step: two in hist_rows_partial, four in
// hist_rows_direct, whose warps walk every row of the range
constexpr int kPartialRows = 2;
constexpr int kDirectRows = 4;
constexpr int kMaxFeat = kWarps;                 // features a block stages
constexpr int kDirectSlices = 2;                 // slices a direct launch sums

template <typename BinT, int SR>
using Source = histwalk::IndexedRows<BinT, SR, kMaxFeat>;

template <typename BinT, typename Acc>
int partial_smem(int fc, int B) {
  return fc * B * 2 * (int)sizeof(Acc)
         + histwalk::stage_bytes(kPartialRows, fc * (int)sizeof(BinT));
}

// hist_rows_direct's shared bytes at nf features: the stage, and for each
// warp its 32 cells and its list of the step's rows in its range.
template <typename BinT, typename Acc>
int direct_smem(int nf) {
  return histwalk::stage_bytes(kDirectRows, nf * (int)sizeof(BinT))
         + histwalk::range_state_bytes(kDirectRows, (int)sizeof(Acc));
}

// Positions [lo, hi) of range (start, count), clamped to [0, n_pos).
__device__ __forceinline__ void clamp_range(const int* range, int n_pos,
                                            long long* lo, long long* hi) {
  long long a = (long long)range[0];
  long long b = a + (long long)(range[1] > 0 ? range[1] : 0);
  if (a < 0) a = 0;
  if (b > n_pos) b = n_pos;
  if (b < a) b = a;
  *lo = a;
  *hi = b;
}

// The minimum of one block an SM changes no limit (at most 255 registers
// a thread either way) but steers ptxas (CUDA 12.9) off an 8-byte spill
// it makes in the u16 / f64 instantiation without it.
template <typename BinT, typename Acc>
__global__ void __launch_bounds__(kThreads, 1)
hist_rows_partial(const BinT* __restrict__ bins,
                  const float* __restrict__ vals,
                  const int* __restrict__ index,
                  const int* __restrict__ range, int n_pos, int F, int B,
                  int fc, Acc* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int f_lo = blockIdx.y * fc;
  const int fw = (F - f_lo) < fc ? (F - f_lo) : fc;
  const int cells = fw * B * 2;
  Acc* hist = reinterpret_cast<Acc*>(smem);                     // [fw, B, 2]
  constexpr int kStage = kThreads * kPartialRows;
  float2* sv = reinterpret_cast<float2*>(hist + fc * B * 2);    // [2][kStage]
  BinT* sb = reinterpret_cast<BinT*>(sv + 2 * kStage);   // [2][kStage, fw]
  histblock::zero(hist, cells);   // the first step's barrier orders it
  long long lo, hi;
  clamp_range(range, n_pos, &lo, &hi);
  histblock::slice(lo, hi, gridDim.x, blockIdx.x, &lo, &hi);
  const Source<BinT, kPartialRows> src{
      bins, reinterpret_cast<const float2*>(vals), index, F, f_lo, fw};
  histwalk::walk<kPartialRows>(
      src, lo, hi, sv, sb,
      [&](const float2* s_v, const BinT* s_b, int rows, long long) {
        histblock::accumulate(hist, s_b, reinterpret_cast<const float*>(s_v),
                              rows, fw, B);
      });
  __syncthreads();
  Acc* out =
      partials + (size_t)blockIdx.x * F * B * 2 + (size_t)f_lo * B * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

// One launch: histwalk::range_hist over the position range, its warps
// owning (feature, 32-bin range) units.
template <typename BinT, typename Acc>
__global__ void __launch_bounds__(kThreads)
hist_rows_direct(const BinT* __restrict__ bins,
                 const float* __restrict__ vals,
                 const int* __restrict__ index,
                 const int* __restrict__ range, int n_pos, int F, int B,
                 int R, int nslices, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kThreads * kDirectRows;
  float2* sv = reinterpret_cast<float2*>(smem);             // [2][kStage]
  Acc* cells_all = reinterpret_cast<Acc*>(sv + 2 * kStage);  // [8][32][2]
  unsigned* lst_all =
      reinterpret_cast<unsigned*>(cells_all + kWarps * 2 * kRange);
  BinT* sb = reinterpret_cast<BinT*>(lst_all + kWarps * kStage);
  int f_lo, nf;   // the wrapper's smem holds nf
  histwalk::range_features(blockIdx.x, F, R, &f_lo, &nf);
  long long lo, hi;
  clamp_range(range, n_pos, &lo, &hi);
  const Source<BinT, kDirectRows> src{
      bins, reinterpret_cast<const float2*>(vals), index, F, f_lo, nf};
  histwalk::range_hist<kDirectRows>(src, lo, hi, nslices, F, B, R, sv, sb,
                                    cells_all, lst_all, out);
}

// out[i] = the f64 sum of partials[b, i] over b in block order from 0,
// rounded to f32 once (the gpu_use_dp mode's reduction).
__global__ void reduce_partials_f64(const double* __restrict__ partials,
                                    int nblocks, int cells,
                                    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const double* p = partials + i;
  double acc = 0.0;
  for (int b = 0; b < nblocks; ++b) acc += p[(size_t)b * cells];
  out[i] = (float)acc;
}

inline void reduce(const float* partials, int nslices, int cells, float* out,
                   cudaStream_t s) {
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nslices, cells, 1, out);
}

inline void reduce(const double* partials, int nslices, int cells,
                   float* out, cudaStream_t s) {
  reduce_partials_f64<<<histblock::reduce_grid(cells, 1), 256, 0, s>>>(
      partials, nslices, cells, out);
}

template <typename BinT, typename Acc>
int launch(const BinT* bins, const float* vals, const int* index,
           const int* range, Acc* partials, float* out, int n_pos, int F,
           int B, int nslices, int direct, int grid_x, int grid_y, int feats,
           int parts, cudaStream_t s) {
  cudaError_t e;
  if (direct) {
    // the wrapper's geometry must cover every cell in at most
    // kDirectSlices slices
    if (nslices < 1 || nslices > kDirectSlices || parts * kRange < B
        || grid_x * kWarps < F * parts)
      return (int)cudaErrorInvalidValue;
    static int direct_set = 0;
    const int smem = direct_smem<BinT, Acc>(feats);
    if (smem > direct_set) {
      e = cudaFuncSetAttribute(hist_rows_direct<BinT, Acc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      direct_set = smem;
    }
    hist_rows_direct<BinT, Acc><<<grid_x, kThreads, smem, s>>>(
        bins, vals, index, range, n_pos, F, B, parts, nslices, out);
    return (int)cudaGetLastError();
  }
  // a block (x, y) sums slice x of features [y * feats, ...)
  if (partials == nullptr || grid_x != nslices || grid_y * feats < F)
    return (int)cudaErrorInvalidValue;
  static int partial_set = 0;
  const int smem = partial_smem<BinT, Acc>(feats, B);
  if (smem > partial_set) {
    e = cudaFuncSetAttribute(hist_rows_partial<BinT, Acc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    partial_set = smem;
  }
  hist_rows_partial<BinT, Acc><<<dim3(grid_x, grid_y), kThreads, smem, s>>>(
      bins, vals, index, range, n_pos, F, B, feats, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce(partials, nslices, F * B * 2, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one hist_rows_partial block of fc features;
// bin_bytes 1 or 2, acc_bytes 4 (f32) or 8 (the gpu_use_dp mode).
int hist_rows_smem_bytes(int fc, int B, int bin_bytes, int acc_bytes) {
  if (acc_bytes == 8)
    return bin_bytes == 2 ? partial_smem<uint16_t, double>(fc, B)
                          : partial_smem<uint8_t, double>(fc, B);
  return bin_bytes == 2 ? partial_smem<uint16_t, float>(fc, B)
                        : partial_smem<uint8_t, float>(fc, B);
}

// Shared-memory bytes of one hist_rows_direct block staging nf features.
int hist_rows_direct_smem_bytes(int nf, int bin_bytes, int acc_bytes) {
  if (acc_bytes == 8)
    return bin_bytes == 2 ? direct_smem<uint16_t, double>(nf)
                          : direct_smem<uint8_t, double>(nf);
  return bin_bytes == 2 ? direct_smem<uint16_t, float>(nf)
                        : direct_smem<uint8_t, float>(nf);
}

// bins [n, F] of bin_bytes (1: u8, 2: u16); vals f32 [n, 2]; index i32
// [n_pos] or null (then n_pos = n); range i32[2] (start, count) on the
// device; out f32 [F, B, 2].  The geometry is the wrapper's
// (hist_kernel2.rows_geometry); this entry only refuses one that does
// not cover every cell.  direct: one launch of hist_rows_direct on
// grid_x blocks, warp w of block x owning unit x * 8 + w of F * parts
// (feature, 32-bin range) units, nslices (1 or 2) slices, feats the most
// features one block stages, partials unused (may be null).  Otherwise
// hist_rows_partial on (grid_x = nslices, grid_y) blocks of feats
// features into partials f32 [nslices, F, B, 2], then the reduction into
// out.  Returns the CUDA error code of the launches (0 on success).
int hist_rows(const void* bins, int bin_bytes, const float* vals,
              const int* index, const int* range, float* partials,
              float* out, int n_pos, int F, int B, int nslices, int direct,
              int grid_x, int grid_y, int feats, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 2)
    return launch(static_cast<const uint16_t*>(bins), vals, index, range,
                  partials, out, n_pos, F, B, nslices, direct, grid_x, grid_y,
                  feats, parts, s);
  return launch(static_cast<const uint8_t*>(bins), vals, index, range,
                partials, out, n_pos, F, B, nslices, direct, grid_x, grid_y,
                feats, parts, s);
}

// The gpu_use_dp mode: hist_rows with f64 accumulation, partials f64
// [nslices, F, B, 2] (unused, may be null, in one direct launch); the
// geometry is the wrapper's at acc_bytes 8; out stays f32 [F, B, 2].
int hist_rows_f64(const void* bins, int bin_bytes, const float* vals,
                  const int* index, const int* range, double* partials,
                  float* out, int n_pos, int F, int B, int nslices, int direct,
                  int grid_x, int grid_y, int feats, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 2)
    return launch(static_cast<const uint16_t*>(bins), vals, index, range,
                  partials, out, n_pos, F, B, nslices, direct, grid_x, grid_y,
                  feats, parts, s);
  return launch(static_cast<const uint8_t*>(bins), vals, index, range,
                partials, out, n_pos, F, B, nslices, direct, grid_x, grid_y,
                feats, parts, s);
}

}  // extern "C"
