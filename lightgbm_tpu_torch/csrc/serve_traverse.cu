// Forest traversal for compiled serving, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/pallas/serve_kernel.py
// make_serve_traverse (_serve_kernel, _traverse_block): both of its forms,
//   scores: out[n, K] f32 = per-class sum of leaf values over trees
//           t = it * K + kk, written in place into the caller's buffer;
//   leaves: out[n, T] i32 = leaf index per (row, tree).
// Rows >= n_real are bucket padding and are written as 0.  Two entries
// of one kernel: the bins entry reads the JAX kernel's input, bins
// [n, F] i32 (ops.predict.quantize_rows_kernel: bins on numerical
// columns, int-truncated raw values on categorical ones); the raw entry
// reads the padded raw rows [n, Forig] f32 and quantizes each row's used
// features itself, exactly as quantize_rows_kernel does (the first ub
// entry >= x, the NaN bin or the bin of 0.0 for NaN, |x| <= 1e-35 to the
// bin of 0.0 under missing ZERO, +inf to 1 << 24, categorical columns
// truncated toward zero with NaN/+-inf -> -1 and saturation at the int32
// range), optionally writing those bins out.
//
// The forest is ops/serve_kernel.pack_forest's layout: one 16-byte
// record a node (x, meta, feature, children) -- x the threshold bin, or
// the valid bit count of a categorical node; meta (nan_bin << 3) |
// (is_cat << 2) | (has_nan << 1) | default_left; children an i16 pair
// -- or, in a wide forest (a child past the i16 range), two units with
// the children as i32 in the second.  A tree's leaf values (f32) follow
// its nodes, so a finished walk reads its value from the same staged
// bytes.  A level of a walk is one 16-byte load and the row's bin.
//
// What bounds it on this card: each level of each (row, tree) walk is a
// chain of dependent loads (node record -> the row's bin -> the child),
// far above the byte bound (rows once + forest once + out once) and the
// integer-op bound; from shared memory, a warp's 32 walks at 32 nodes
// cost several shared-memory wavefronts a level.
//
// What the design does about it:
// - the trees are cut into tiles of pack_forest's tile_trees (48 KB of
//   padded trees) that a block stages in shared memory with cp.async;
//   its rows are staged there too (the raw entry quantizes them into
//   shared memory once, the quantizer tables staged beside them, in the
//   second tile buffer when it has one); every (row, tree) pair of a
//   tile is walked from shared memory, a warp one tree for 32 rows, one
//   walk a thread;
// - the wrapper's geometry (serve_kernel.serve_geometry), by bucket:
//   many rows (65,536) are resident, a block of 1,024 threads holds 512
//   rows and walks every tile in turn through two staged buffers (the
//   next tile's copies run during this tile's walk), keeping the rows'
//   running sums, so one launch writes the scores; few rows (the
//   queue's 64) are split, a block a (row tile, tree tile) with row
//   tiles as small as 8 rows so that the blocks fill the card, and
//   sum_tiles adds the tile sums.  A tile larger than its buffer (a tree
//   past 48 KB) is walked from global memory; rows too wide to stage
//   are read from global memory.
//
// One order of additions at every batch size (scores form): the tile's
// trees of class kk are added in tree order into a sum from +0 (a row's
// leaf values pass through shared memory for that), and the tile sums
// are added in tile order into a total from +0 -- a resident block's
// running totals, or sum_tiles over the split geometry's partials.  The
// tiles are the forest's, so a row's scores do not depend on n, the
// bucket or the geometry; the plain version
// (serve_kernel.ordered_class_sums) adds in the same order, and the two
// agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 32 warps an SM, one walk at a time a thread: more threads hid the
// walk's latency better than more walks in flight a thread (512 threads
// with 1, 2, 4 or 8 walks, 1,024 with 1 or 2; PERF.md)
constexpr int kThreads = 1024;
constexpr int kBigBin = 1 << 24;

struct Params {
  const int4* blob;
  const int* tree_rec;    // [T] first record unit of each tree
  const int* tree_leaf;   // [T] first leaf word of each tree
  const int* tile_unit;   // [n_tiles + 1]
  const int* cw;          // [T, ni_pad * w] or null
  int w, ni_pad, trees, per_tile, n_tiles, stage_units, n_steps, k;
  const int* bins;        // bins entry: [n, f]
  const float* raw;       // raw entry: [n, forig]
  int forig;
  const int4* qmeta;      // [f] (used column, bin of 0, NaN bin, flags)
  const float* ub;        // [f, bq]
  int bq, quant_staged;
  int* bins_out;          // [n, f] or null
  int n, n_real, f, row_stride, rows, tiles_per_block, nbuf;
  void* out;
  float* partials;        // [n_tiles, n, k] (scores, several tiles)
  float kzero;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// all but the most recent group complete
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Whether quantize_rows_kernel settles value x of feature qm without
// the thresholds (categorical, NaN, +inf, the zero bin), and that bin.
__device__ __forceinline__ bool is_special(float x, int4 qm, float kzero) {
  return (qm.w & 4) || x != x || x == __int_as_float(0x7f800000)
         || ((qm.w & 2) && fabsf(x) <= kzero);
}
__device__ __forceinline__ int special_bin(float x, int4 qm) {
  if (qm.w & 4) {
    // categorical: NaN and +-inf -> -1, toward zero, saturating
    float v = isfinite(x) ? x : -1.0f;
    if (v >= 2147483648.0f) return 2147483647;
    v = fminf(fmaxf(v, -2147483648.0f), 2147483520.0f);
    return __float2int_rz(v);
  }
  if (x != x) return (qm.w & 1) ? qm.z : qm.y;
  if (x == __int_as_float(0x7f800000)) return kBigBin;
  return qm.y;   // |x| <= 1e-35 under missing ZERO
}

// The bins of two values (x0 of feature m0 with thresholds u0, x1 of m1
// with u1, bq each), as quantize_rows_kernel gives them: outside the
// special cases the number of thresholds < x (torch.searchsorted, side
// left), by a branchless search of the same steps for every value, the
// two chains interleaved.
__device__ __forceinline__ void quantize_pair(float x0, int4 m0,
                                              const float* u0, float x1,
                                              int4 m1, const float* u1,
                                              int bq, float kzero, int* b0,
                                              int* b1) {
  int base0 = 0, base1 = 0;
  for (int len = bq; len > 1;) {
    const int half = len >> 1;
    base0 += u0[base0 + half] < x0 ? half : 0;
    base1 += u1[base1 + half] < x1 ? half : 0;
    len -= half;
  }
  *b0 = is_special(x0, m0, kzero) ? special_bin(x0, m0)
                                  : base0 + (u0[base0] < x0);
  *b1 = is_special(x1, m1, kzero) ? special_bin(x1, m1)
                                  : base1 + (u1[base1] < x1);
}

// one level of one walk: the child of `node` for the row's bins
template <bool kWide>
__device__ __forceinline__ int step(const int4* recs, const int* row,
                                    int node, const int* cwt, int w) {
  int x, meta, feat, left, right;
  if (kWide) {
    const int4 a = recs[2 * node];
    const int4 b = recs[2 * node + 1];
    x = a.x; meta = a.y; feat = a.z; left = b.x; right = b.y;
  } else {
    const int4 a = recs[node];
    x = a.x; meta = a.y; feat = a.z;
    left = (a.w << 16) >> 16;
    right = a.w >> 16;
  }
  const int b = row[feat];
  bool go_left;
  if (w > 0 && (meta & 4)) {
    // raw-value bitset membership; the word is shifted as uint32
    // because bit 31 makes the i32 word negative
    const bool ok = b >= 0 && b < x;
    const int ivc = min(max(b, 0), 32 * w - 1);
    const unsigned word = static_cast<unsigned>(
        __ldg(cwt + static_cast<long long>(node) * w + (ivc >> 5)));
    go_left = ok && ((word >> (ivc & 31)) & 1u);
  } else {
    // meta >> 3 is an arithmetic shift of the i32 word
    const bool at_nan = (meta & 2) && b == (meta >> 3);
    go_left = at_nan ? (meta & 1) != 0 : b <= x;
  }
  return go_left ? left : right;
}

// Every (row, tree) pair of rows [0, live) of the row tile and trees
// [t0, t0 + nt) of the tile at `tile` (unit u0 of the blob, staged or
// not): the leaf index into out (leaves) or the leaf value into
// vals [live, nt] (scores).  Pair q is row q % live of tree q / live, so
// a warp walks one tree for 32 rows; a walk ends at a leaf or after
// n_steps levels (leaf 0 if still on a node), as the plain version's
// lock-step walk does.
template <bool kWide, bool kLeaves>
__device__ __forceinline__ void walk_tile(const Params& p, const int4* tile,
                                          int u0, const int* rows,
                                          int stride, long long r0,
                                          int live, int t0, int nt,
                                          float* vals) {
  const int pairs = live * nt;
  const float* words = reinterpret_cast<const float*>(tile);
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    const int tl = q / live;
    const int r = q - tl * live;
    const int t = t0 + tl;
    const int4* recs = tile + (p.tree_rec[t] - u0);
    const int* row = rows + r * stride;
    const int* cwt =
        p.w > 0 ? p.cw + static_cast<long long>(t) * p.ni_pad * p.w : p.cw;
    int node = 0;
    for (int s = 0; s < p.n_steps && node >= 0; ++s)
      node = step<kWide>(recs, row, node, cwt, p.w);
    const int leaf = ~min(node, -1);
    if (kLeaves) {
      static_cast<int*>(p.out)[(r0 + r) * p.trees + t] = leaf;
    } else {
      vals[r * nt + tl] = words[p.tree_leaf[t] - 4 * u0 + leaf];
    }
  }
}

// Start the copies of tile j into dst when it fits the staged region
// (a larger tile is walked from global memory).
__device__ __forceinline__ void issue_tile(const Params& p, int4* dst,
                                           int j) {
  const int u0 = p.tile_unit[j];
  const int units = p.tile_unit[j + 1] - u0;
  if (units > p.stage_units) return;
  for (int i = threadIdx.x; i < units; i += kThreads)
    cp_async16(dst + i, p.blob + u0 + i);
}

// The rows of the block, [r0, r0 + rows), staged in s_rows [rows,
// row_stride] i32 (the raw entry quantizes them; with row_stride 0 it
// writes them to bins_out and the walk reads them there); bins_out gets
// every row's bins from the blocks of the first tile column.  Returns
// where the walk reads the rows and their stride.
template <bool kRaw>
__device__ __forceinline__ const int* stage_rows(const Params& p,
                                                 int* s_rows,
                                                 const int4* qm,
                                                 const float* ub,
                                                 long long r0, int rows,
                                                 int live, int* stride) {
  if (!kRaw) {
    if (p.row_stride == 0) {
      *stride = p.f;
      return p.bins + r0 * p.f;
    }
    for (int i = threadIdx.x; i < live * p.f; i += kThreads) {
      const int r = i / p.f;
      s_rows[r * p.row_stride + i - r * p.f] = p.bins[r0 * p.f + i];
    }
    *stride = p.row_stride;
    return s_rows;
  }
  const bool global_rows = p.row_stride == 0;
  const bool write_out = p.bins_out != nullptr && blockIdx.y == 0;
  // the padding rows' bins only for the bins output; unstaged rows are
  // written by every block of the row tile (the same bits)
  const int total = ((write_out || global_rows) ? rows : live) * p.f;
  int* dst = global_rows ? p.bins_out + r0 * p.f : s_rows;
  const int dstride = global_rows ? p.f : p.row_stride;
  for (int i = threadIdx.x; i < total; i += 2 * kThreads) {
    const int i1 = i + kThreads < total ? i + kThreads : i;
    const int ra = i / p.f, ca = i - ra * p.f;
    const int rb = i1 / p.f, cb = i1 - rb * p.f;
    const int4 ma = qm[ca], mb = qm[cb];
    int ba, bb;
    quantize_pair(p.raw[(r0 + ra) * p.forig + ma.x], ma,
                  ub + static_cast<long long>(ca) * p.bq,
                  p.raw[(r0 + rb) * p.forig + mb.x], mb,
                  ub + static_cast<long long>(cb) * p.bq, p.bq, p.kzero,
                  &ba, &bb);
    dst[ra * dstride + ca] = ba;
    dst[rb * dstride + cb] = bb;
    if (write_out && !global_rows) {
      p.bins_out[(r0 + ra) * p.f + ca] = ba;
      p.bins_out[(r0 + rb) * p.f + cb] = bb;
    }
  }
  *stride = dstride;
  return dst;
}

// Whether the raw entry's quantizer tables lie in the second staged
// buffer (two buffers, the tables no larger than one).
__host__ __device__ __forceinline__ bool quant_in_buffer(const Params& p) {
  return p.nbuf == 2 && 16LL * p.f + 4LL * p.f * p.bq <= 16LL * p.stage_units;
}

// Block (x, y): rows [x * rows, ...) over tree tiles [y * tiles_per_block,
// ...), in tile order: the rows are staged once, each tile is staged in
// its turn (two buffers: the next tile's copies run during this tile's
// walk), walked, and its class sums added -- into the block's running
// totals when one block sees every tile (gridDim.y == 1), else into
// partials[tile] for sum_tiles.  Dynamic shared memory: nbuf staged
// tiles [stage_units] int4, the quantizer tables (raw entry, when staged:
// qmeta [f] int4 and ub [f, bq] f32; in the second staged tile while the
// rows are quantized when they fit it), the rows [rows, row_stride] i32,
// the leaf values [rows, per_tile] f32 and the totals [rows, k] f32
// (scores).
template <bool kWide, bool kLeaves, bool kRaw>
__global__ void __launch_bounds__(kThreads) traverse_kernel(Params p) {
  extern __shared__ __align__(16) int4 smem[];
  const int j0 = blockIdx.y * p.tiles_per_block;
  const int j1 = min(j0 + p.tiles_per_block, p.n_tiles);
  const long long r0 = static_cast<long long>(blockIdx.x) * p.rows;
  const int rows = static_cast<int>(
      p.n - r0 < p.rows ? p.n - r0 : static_cast<long long>(p.rows));
  const long long lv = p.n_real - r0;
  const int live = static_cast<int>(lv < 0 ? 0 : (lv < rows ? lv : rows));
  const bool q_staged = kRaw && p.quant_staged;
  const bool totals = gridDim.y == 1 && p.n_tiles > 1;
  // with two buffers the quantizer tables lie in the second, which the
  // second tile's copies take only after the rows are quantized
  const bool q_in_buf = q_staged && quant_in_buffer(p);
  int4* s_stage = smem;
  int4* s_tail = smem + p.nbuf * p.stage_units;
  int4* s_qm = q_in_buf ? smem + p.stage_units : s_tail;
  float* s_ub = reinterpret_cast<float*>(s_qm + p.f);
  int* s_rows = q_staged && !q_in_buf
                    ? reinterpret_cast<int*>(s_ub + p.f * p.bq)
                    : reinterpret_cast<int*>(s_tail);
  float* s_vals = reinterpret_cast<float*>(s_rows + p.rows * p.row_stride);
  float* s_tot = s_vals + p.rows * p.per_tile;
  issue_tile(p, s_stage, j0);
  cp_async_commit();
  const int4* qm = p.qmeta;
  const float* ub = p.ub;
  if (q_staged) {
    for (int i = threadIdx.x; i < p.f; i += kThreads) s_qm[i] = p.qmeta[i];
    for (int i = threadIdx.x; i < p.f * p.bq; i += kThreads)
      s_ub[i] = p.ub[i];
    qm = s_qm;
    ub = s_ub;
    __syncthreads();
  }
  if (!kLeaves && totals)
    for (int i = threadIdx.x; i < rows * p.k; i += kThreads) s_tot[i] = 0.f;
  int stride;
  const int* rows_at =
      stage_rows<kRaw>(p, s_rows, qm, ub, r0, rows, live, &stride);
  if (q_in_buf) __syncthreads();   // the tables are read: free the buffer
  // t0 + first is a multiple of k for t0 = 0
  for (int j = j0; j < j1; ++j) {
    const int b = p.nbuf > 1 ? (j - j0) & 1 : 0;
    if (p.nbuf > 1 && j + 1 < j1) {
      // the other buffer's readers (tile j - 1) are past the barrier
      // that ended their tile
      issue_tile(p, s_stage + (b ^ 1) * p.stage_units, j + 1);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int t0 = j * p.per_tile;
    const int nt = min(p.per_tile, p.trees - t0);
    const int u0 = p.tile_unit[j];
    const bool staged = p.tile_unit[j + 1] - u0 <= p.stage_units;
    const int4* tile = s_stage + b * p.stage_units;
    if (staged && p.row_stride > 0)
      walk_tile<kWide, kLeaves>(p, tile, u0, s_rows, p.row_stride, r0, live,
                                t0, nt, s_vals);
    else if (staged)
      walk_tile<kWide, kLeaves>(p, tile, u0, rows_at, stride, r0, live, t0,
                                nt, s_vals);
    else
      walk_tile<kWide, kLeaves>(p, p.blob + u0, u0, rows_at, stride, r0,
                                live, t0, nt, s_vals);
    if (kLeaves) {
      int* out = static_cast<int*>(p.out);
      for (int i = threadIdx.x; i < (rows - live) * nt; i += kThreads) {
        const int r = live + i / nt;
        out[(r0 + r) * p.trees + t0 + i % nt] = 0;
      }
    } else {
      __syncthreads();
      // the tile's sum of class kk for each row, in tree order from +0
      const int first = ((-t0) % p.k + p.k) % p.k;   // (t0 + first) % k == 0
      for (int i = threadIdx.x; i < rows * p.k; i += kThreads) {
        const int r = i / p.k;
        const int kk = i - r * p.k;
        float acc = 0.0f;
        if (r < live) {
          for (int tl = (first + kk) % p.k; tl < nt; tl += p.k)
            acc += s_vals[r * nt + tl];
        }
        const long long o = (r0 + r) * p.k + kk;
        if (totals)
          s_tot[i] = s_tot[i] + acc;
        else if (p.n_tiles == 1)
          static_cast<float*>(p.out)[o] = acc;
        else
          p.partials[static_cast<long long>(j) * p.n * p.k + o] = acc;
      }
    }
    __syncthreads();   // this tile's readers are done with its buffer
  }
  if (!kLeaves && totals)
    for (int i = threadIdx.x; i < rows * p.k; i += kThreads)
      static_cast<float*>(p.out)[r0 * p.k + i] = s_tot[i];
}

// out[i] = the tile sums of element i in tile order, from +0
__global__ void sum_tiles(const float* __restrict__ partials, int n_tiles,
                          long long nk, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < nk; i += stride) {
    float total = 0.0f;
    for (int j = 0; j < n_tiles; ++j) total += partials[j * nk + i];
    out[i] = total;
  }
}

template <bool kWide, bool kLeaves, bool kRaw>
int launch_walk(const Params& p, dim3 grid, int smem, cudaStream_t s) {
  static int smem_set = 0;   // one per instantiation
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_kernel<kWide, kLeaves, kRaw>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  traverse_kernel<kWide, kLeaves, kRaw><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide, bool kLeaves>
int launch_entry(const Params& p, dim3 grid, int smem, cudaStream_t s) {
  return p.raw != nullptr ? launch_walk<kWide, kLeaves, true>(p, grid, smem, s)
                          : launch_walk<kWide, kLeaves, false>(p, grid, smem,
                                                               s);
}

// the dynamic shared memory the kernel carves for these parameters
long long smem_of(const Params& p, int raw, int leaves, int totals) {
  long long b = 16LL * p.nbuf * p.stage_units;
  if (raw && p.quant_staged && !quant_in_buffer(p))
    b += 16LL * p.f + 4LL * p.f * p.bq;
  b += 4LL * p.rows * p.row_stride;
  if (!leaves) b += 4LL * p.rows * p.per_tile;
  if (!leaves && totals) b += 4LL * p.rows * p.k;
  return b;
}

}  // namespace

extern "C" {

// The traversal on the wrapper's geometry (serve_kernel.serve_geometry):
// grid (grid_x, grid_y) blocks of 256 threads, block (x, y) walking rows
// [x * rows, ...) over tree tiles [y * tiles_per_block, ...) with nbuf
// (1 or 2) staged tile buffers; then, in the scores form with several
// tiles and several tile columns, sum_tiles over partials [n_tiles, n,
// k].  Exactly one of bins (bins entry) and raw (raw entry) is given.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the CUDA error code, cudaErrorInvalidValue for a geometry that misses
// a row or a tile, or whose shared memory is not `smem`.
int serve_traverse_run(
    const void* blob, const void* tree_rec, const void* tree_leaf,
    const void* tile_unit, const void* cw, int w, int ni_pad, int wide,
    int trees, int per_tile, int n_tiles, int stage_units, int n_steps,
    int k, const void* bins, const void* raw, int forig, const void* qmeta,
    const void* ub, int bq, int quant_staged, void* bins_out, int n,
    int n_real, int f, int row_stride, int rows, int tiles_per_block,
    int nbuf, int grid_x, int grid_y, int leaves, int smem, void* out,
    void* partials, float kzero, void* stream) {
  Params p;
  p.blob = static_cast<const int4*>(blob);
  p.tree_rec = static_cast<const int*>(tree_rec);
  p.tree_leaf = static_cast<const int*>(tree_leaf);
  p.tile_unit = static_cast<const int*>(tile_unit);
  p.cw = static_cast<const int*>(cw);
  p.w = w;
  p.ni_pad = ni_pad;
  p.trees = trees;
  p.per_tile = per_tile;
  p.n_tiles = n_tiles;
  p.stage_units = stage_units;
  p.n_steps = n_steps;
  p.k = k;
  p.bins = static_cast<const int*>(bins);
  p.raw = static_cast<const float*>(raw);
  p.forig = forig;
  p.qmeta = static_cast<const int4*>(qmeta);
  p.ub = static_cast<const float*>(ub);
  p.bq = bq;
  p.quant_staged = quant_staged;
  p.bins_out = static_cast<int*>(bins_out);
  p.n = n;
  p.n_real = n_real;
  p.f = f;
  p.row_stride = row_stride;
  p.rows = rows;
  p.tiles_per_block = tiles_per_block;
  p.nbuf = nbuf;
  p.out = out;
  p.partials = static_cast<float*>(partials);
  p.kzero = kzero;
  const bool is_raw = raw != nullptr;
  const bool totals = grid_y == 1 && n_tiles > 1;
  if (n < 1 || rows < 1 || k < 1 || trees < 1 || per_tile < 1
      || tiles_per_block < 1 || nbuf < 1 || nbuf > 2 || bq < 1
      || (bins != nullptr) == is_raw
      || static_cast<long long>(rows) * grid_x < n
      || static_cast<long long>(rows) * (grid_x - 1) >= n
      || static_cast<long long>(n_tiles) * per_tile < trees
      || static_cast<long long>(n_tiles - 1) * per_tile >= trees
      || static_cast<long long>(tiles_per_block) * grid_y < n_tiles
      || static_cast<long long>(tiles_per_block) * (grid_y - 1) >= n_tiles
      || (w > 0 && cw == nullptr)
      || (row_stride != 0 && row_stride < f)
      || (is_raw && row_stride == 0 && bins_out == nullptr)
      || (!leaves && n_tiles > 1 && grid_y > 1 && partials == nullptr)
      || smem_of(p, is_raw, leaves, totals) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (wide)
    rc = leaves ? launch_entry<true, true>(p, grid, smem, s)
                : launch_entry<true, false>(p, grid, smem, s);
  else
    rc = leaves ? launch_entry<false, true>(p, grid, smem, s)
                : launch_entry<false, false>(p, grid, smem, s);
  if (rc != 0 || leaves || n_tiles == 1 || grid_y == 1) return rc;
  const long long nk = static_cast<long long>(n) * k;
  long long blocks = (nk + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sum_tiles<<<static_cast<int>(blocks), 256, 0, s>>>(
      p.partials, n_tiles, nk, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
