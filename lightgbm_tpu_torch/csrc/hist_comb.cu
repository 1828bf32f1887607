// Comb-direct gradient histogram over a contiguous range of the
// physically partitioned row matrix.
//
// Replaces lightgbm_tpu/ops/pallas/hist_kernel2.py build_histogram_comb /
// build_histogram_comb_dyn (_comb_hist_call, pallas_call at :225): the
// (sum g*w, sum h*w) histogram [F, B, 2] f32 of rows
// [start + off, start + off + count) of the row matrix, rows outside the
// range (and outside the matrix) contributing nothing.  The TPU kernel
// contracts nibble one-hots on the MXU; here every (row, feature) adds
// its exact f32 values in a fixed order.
//
// Rows: bins u8 [n, F] row-major, vals f32 [n, 3] (g*w, h*w, w).  The
// range is read from device memory (int32[3]: start, off, count), so a
// child range computed on the device needs no host round trip; the grid
// is sized by the caller's upper bound on count.  hist_comb_p2 replaces
// the same pallas_call at pack=2 (_hist2_comb2_kernel, hist_kernel2.py:144)
// and reads the same logical rows from the records (partition_common.cuh
// RecPtr: bins at byte 0, (g*w, h*w) at byte Fb of each S-byte record);
// both packs run the same kernel bodies over a row layout (CombRows,
// CombRecords), so their histograms are bitwise equal.
//
// The bits (no float atomics): the range is cut into nslices slices
// (histblock::slice, nslices = hist_kernel2.hist_blocks of the caller's
// bound), every cell is the sequential f32 sum of each slice's rows in
// row order from +0, and the slice sums are added in slice order from 0.
// The plain version (hist_kernel2.build_histogram_comb_ref) adds in that
// order, and stream_refresh's root histogram and the fused split's
// histograms reproduce it.  Two modes keep the order; the wrapper picks
// one and its grid (hist_kernel2.comb_geometry) and this library refuses
// only a geometry that misses a cell:
//
// - Range mode (up to a few slices: the smaller children that make most
//   launches): hist_comb_range, one launch that writes out.  A warp owns
//   one feature's 32-bin range (224 warps at F = 28, B = 256) and walks
//   the whole range through the block's stage (histwalk::range_hist,
//   shared with hist_rows_direct), adding each slice's sums to its
//   running totals where the slice ends.  No partials, no reduction.
// - Feature mode (the roots and the first splits' children):
//   hist_comb_partial on (slices, feature chunks) blocks, each warp
//   owning whole features of the chunk in a shared [fc, B, 2] histogram
//   (histblock::accumulate), then histblock::reduce_partials adds the
//   partials in slice order.
//
// Both stage rows through histwalk::walk with the WordRows source: a
// thread loads the aligned 32-bit words that cover its rows' staged bins
// (no division, 4-byte loads at any row stride, the values once a row a
// block) into registers a step ahead, so the next step's loads overlap
// this step's adds, and funnel-shifts them into the stage.
//
// Bound on this card: bytes at the root, the walk at small children.  A
// launch must read count * (F + 8) bytes (bins and the two value columns
// used) and write F * B * 8; at the 1M-row root that is 36 MB (0.011 ms)
// and feature mode's partials add 2 * slices * F * B * 8 bytes, the price
// of the fixed order.  A 6,000-row child moves ~0.2 MB: its time is the
// chain of a warp's walk over the range (the order makes every warp of a
// feature read every row), and the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"
#include "hist_walk.cuh"

namespace {

using histblock::kThreads;
using histblock::kWarps;
using histwalk::kRange;

// rows a thread stages a step: one in feature mode (256-row steps, so
// that five blocks share an SM), four in range mode
constexpr int kFeatureRows = 1;
constexpr int kRangeRows = 4;
// words of staged bins a row: feature mode up to 32 features a block,
// range mode up to 8 (a block's 8 units span at most 5 features at two
// or more 32-bin ranges a feature)
constexpr int kFeatureWords = 8;
constexpr int kRangeWords = 2;

__host__ __device__ inline int staged_bytes(int nf) {
  return 4 * ((nf + 3) / 4);
}

// Shared bytes of a feature-mode block of fc features: the [fc, B, 2]
// histogram and the stage.
__host__ __device__ inline int feature_smem(int fc, int B) {
  return fc * B * 2 * 4 + histwalk::stage_bytes(kFeatureRows,
                                                staged_bytes(fc));
}

// Shared bytes of a range-mode block staging nf features: the stage and
// the warps' cells and lists.
__host__ __device__ inline int range_smem(int nf) {
  return histwalk::stage_bytes(kRangeRows, staged_bytes(nf))
         + histwalk::range_state_bytes(kRangeRows);
}

// The row layouts: where a row's bins and (g*w, h*w) lie.  The launch
// only reads the rows, so every global load takes the read-only path
// (__ldg in the source).
// pack=1: bins u8 [n, F] and vals f32 [n, 3]
struct CombRows {
  const uint8_t* bins;
  const float* vals;
  int F;
  template <int SR, int W>
  __device__ __forceinline__ histwalk::WordRows<SR, W> source(int f_lo,
                                                              int nf) const {
    return {bins, vals, F, 3, f_lo, nf};
  }
};

// pack=2: records of S bytes, vals at byte Fb
struct CombRecords {
  const uint8_t* base;
  int S, Fb;
  template <int SR, int W>
  __device__ __forceinline__ histwalk::WordRows<SR, W> source(int f_lo,
                                                              int nf) const {
    return {base, reinterpret_cast<const float*>(base + Fb), S, S / 4, f_lo,
            nf};
  }
};

// Rows [lo, hi) of range (start, off, count), clamped to [0, n_rows).
__device__ __forceinline__ void comb_window(const int* range, int n_rows,
                                            long long* lo, long long* hi) {
  long long a = (long long)range[0] + (long long)range[1];
  long long b = a + (long long)(range[2] > 0 ? range[2] : 0);
  if (a < 0) a = 0;
  if (b > n_rows) b = n_rows;
  if (b < a) b = a;
  *lo = a;
  *hi = b;
}

// Block (x, y) sums slice x of features [y fc, min(F, (y + 1) fc)) into
// partials[x, y fc : ...].
template <class Layout>
__global__ void __launch_bounds__(kThreads)
hist_comb_partial(Layout rows, const int* __restrict__ range, int n_rows,
                  int F, int B, int fc, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kThreads * kFeatureRows;
  const int f_lo = blockIdx.y * fc;
  const int fw = (F - f_lo) < fc ? (F - f_lo) : fc;
  const int cells = fw * B * 2;
  float* hist = smem;                                          // [fw, B, 2]
  float2* sv = reinterpret_cast<float2*>(hist + fc * B * 2);   // [2][kStage]
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + 2 * kStage);   // [2][kStage, .]
  histblock::zero(hist, cells);   // the first step's barrier orders it
  long long lo, hi;
  comb_window(range, n_rows, &lo, &hi);
  histblock::slice(lo, hi, gridDim.x, blockIdx.x, &lo, &hi);
  const auto src = rows.template source<kFeatureRows, kFeatureWords>(f_lo,
                                                                     fw);
  const int stride = src.stride();
  histwalk::walk<kFeatureRows>(
      src, lo, hi, sv, sb,
      [&](const float2* s_v, const uint8_t* s_b, int n, long long) {
        histblock::accumulate(hist, s_b, reinterpret_cast<const float*>(s_v),
                              n, stride, B, 0, fw);
      });
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * F * B * 2
               + (size_t)f_lo * B * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = hist[i];
}

// One launch over every slice: warp w of block x owns unit 8 x + w of
// F * R (feature, 32-bin range) units and writes its cells of out.
template <class Layout>
__global__ void __launch_bounds__(kThreads)
hist_comb_range(Layout rows, const int* __restrict__ range, int n_rows,
                int F, int B, int R, int nslices, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kThreads * kRangeRows;
  float2* sv = reinterpret_cast<float2*>(smem);             // [2][kStage]
  float* cells_all = reinterpret_cast<float*>(sv + 2 * kStage);  // [8][32][2]
  unsigned* lst_all =
      reinterpret_cast<unsigned*>(cells_all + kWarps * 2 * kRange);
  uint8_t* sb = reinterpret_cast<uint8_t*>(lst_all + kWarps * kStage);
  int f_lo, nf;   // the wrapper's smem holds nf
  histwalk::range_features(blockIdx.x, F, R, &f_lo, &nf);
  long long lo, hi;
  comb_window(range, n_rows, &lo, &hi);
  histwalk::range_hist<kRangeRows>(
      rows.template source<kRangeRows, kRangeWords>(f_lo, nf), lo, hi,
      nslices, F, B, R, sv, sb, cells_all, lst_all, out);
}

// The launches of one histogram on the wrapper's geometry; 0 or the CUDA
// error code, cudaErrorInvalidValue for a geometry that misses a cell or
// that the kernels cannot stage.
template <class Layout>
int launch(Layout rows, const int* range, float* partials, float* out,
           int n_rows, int F, int B, int nslices, int ranged, int grid_x,
           int grid_y, int feats, int parts, cudaStream_t s) {
  if (nslices < 1 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (ranged) {
    const long long units = (long long)F * parts;
    if (parts < 2 || (long long)parts * kRange < B
        || (long long)(parts - 1) * kRange >= B || grid_y != 1
        || (long long)grid_x * kWarps < units
        || (long long)(grid_x - 1) * kWarps >= units
        || feats > 4 * kRangeWords)
      return (int)cudaErrorInvalidValue;
    // every block's features fit the stage the shared memory holds
    for (int x = 0; x < grid_x; ++x) {
      int f_lo, nf;
      histwalk::range_features(x, F, parts, &f_lo, &nf);
      if (nf > feats) return (int)cudaErrorInvalidValue;
    }
    static int range_set = 0;   // one per instantiation
    const int smem = range_smem(feats);
    if (smem > range_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          hist_comb_range<Layout>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      range_set = smem;
    }
    hist_comb_range<Layout><<<grid_x, kThreads, smem, s>>>(
        rows, range, n_rows, F, B, parts, nslices, out);
    return (int)cudaGetLastError();
  }
  // block (x, y) sums slice x of features [y * feats, ...)
  if (partials == nullptr || parts != 1 || grid_x != nslices || feats < 1
      || feats > 4 * kFeatureWords || (long long)grid_y * feats < F
      || (long long)(grid_y - 1) * feats >= F)
    return (int)cudaErrorInvalidValue;
  static int partial_set = 0;
  const int smem = feature_smem(feats, B);
  if (smem > partial_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_comb_partial<Layout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    partial_set = smem;
  }
  hist_comb_partial<Layout><<<dim3(grid_x, grid_y), kThreads, smem, s>>>(
      rows, range, n_rows, F, B, feats, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells = F * B * 2;
  histblock::reduce_partials<<<histblock::reduce_grid(cells, 1), 256, 0,
                               s>>>(partials, nslices, cells, 1, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block (either pack): feature mode (ranged
// 0) of feats features at B bins; range mode staging feats features.
int hist_comb_smem_bytes(int feats, int B, int ranged) {
  return ranged ? range_smem(feats) : feature_smem(feats, B);
}

// bins u8 [n_rows, F]; vals f32 [n_rows, 3]; range i32[3] on the device;
// out f32 [F, B, 2].  The geometry is the wrapper's
// (hist_kernel2.comb_geometry): nslices slices; ranged: one launch of
// hist_comb_range on grid_x blocks, warp w of block x owning unit
// x * 8 + w of F * parts (feature, 32-bin range) units, feats the most
// features a block stages (at most 8), partials unused (may be null);
// otherwise hist_comb_partial on (grid_x = nslices, grid_y) blocks of
// feats features (at most 32) into partials f32 [nslices, F, B, 2], then
// the reduction into out.  Returns the CUDA error code of the launches
// (0 on success).
int hist_comb(const uint8_t* bins, const float* vals, const int* range,
              float* partials, float* out, int n_rows, int F, int B,
              int nslices, int ranged, int grid_x, int grid_y, int feats,
              int parts, void* stream) {
  return launch(CombRows{bins, vals, F}, range, partials, out, n_rows, F, B,
                nslices, ranged, grid_x, grid_y, feats, parts,
                static_cast<cudaStream_t>(stream));
}

// The same over records: base u8 [n_rows, S] (S a multiple of 4), F bins
// per record at byte 0, vals at byte Fb (a multiple of 4).
int hist_comb_p2(const uint8_t* base, int S, int Fb, const int* range,
                 float* partials, float* out, int n_rows, int F, int B,
                 int nslices, int ranged, int grid_x, int grid_y, int feats,
                 int parts, void* stream) {
  if (S % 4 || Fb % 4 || Fb < F || Fb + 8 > S)
    return (int)cudaErrorInvalidValue;
  return launch(CombRecords{base, S, Fb}, range, partials, out, n_rows, F,
                B, nslices, ranged, grid_x, grid_y, feats, parts,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
