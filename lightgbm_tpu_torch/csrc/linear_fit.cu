// Per-leaf moments of the linear-leaf fit (linear_tree): for every leaf l,
// over its rows r with weight wf_r (the in-bag weight, 0 where a path
// feature of the leaf is NaN) and design vector xa_r = (x_r1 .. x_rk, 1)
// (x_rk the raw value of the leaf's k-th path feature, 0 where padded or
// NaN):
//
//   XtHX[l, i, j] = sum_r ((wf_r * h_r) * xa_ri) * xa_rj   (i <= j)
//   XtG[l, i]     = sum_r  (wf_r * g_r) * xa_ri
//   count[l]      = sum_r   wf_r
//
// in f64, written as out [L, E] f64, E = P + k1 + 1, k1 = kmax + 1: the
// P = k1 (k1 + 1) / 2 upper-triangle entries row by row (i <= j), then the
// k1 XtG entries, then the count.
//
// Replaces no TPU kernel: the JAX package accumulates these moments with
// an XLA einsum over one-hot leaf masks in f32 (lightgbm_tpu/models/
// linear.py:101-114, no pallas_call).  The port accumulates in f64, as
// LightGBM does (linear_tree_learner.cpp), and needs a fixed order: the
// fitted leaves feed the scores, so the card's trees equal the CPU run's
// only if every moment has the same bits on both.
//
// Inputs: raw [n, F] f32 (used-feature order), order i32 [n] (the rows
// sorted by leaf, stably: a leaf's rows in ascending row order), seg i32
// [L, 2] (start, count) of each leaf's rows in order, cfirst i32 [L + 1]
// (each leaf's first chunk, the chunks of all leaves numbered in leaf
// order; cfirst[L] the number of chunks), g, h, w f32 [n] by row,
// feat_idx i32 [L, kmax] (the leaf's path features, -1 padded).
//
// Determinism: no float atomics.  Each leaf's rows are cut into chunks of
// `chunk` rows from its start (the wrapper's CHUNK); every entry of a
// chunk is the sequential f64 sum of its rows' products in row order from
// +0, and the chunk sums are added in chunk order from +0.  Built with
// -fmad=false (ops/_build.py SOURCE_FLAGS): each product and sum rounds
// on its own, so the plain version (ops/linear_kernel.linear_moments_ref)
// gives these bits on the CPU.  The XtG entry i is computed as
// ((wf * g) * xa_i) * 1 and the count as (wf * 1) * 1: a product by 1 is
// exact, so every entry takes one formula.
//
// Design: out is zeroed, then the chunk sums go to a scratch of chunks
// x entries and chunk_chain adds each leaf's onto out in chunk order.
// Which kernel sums the chunks follows from E:
//
// - E <= 512 (kmax <= 29; the linear main path's kmax 9): chunk_sums_warp,
//   a warp a chunk, the chunks of every leaf dealt to the warps of the
//   grid in turn (chunk c to warp c mod warps), so every SM has work
//   whatever the leaf sizes are.  Lane t owns entries t, t + 32, ... (NS
//   a lane), so a small E idles no block.  A chunk is staged 16 rows at a
//   time: the rows' path-feature values (gathered through order) and
//   their g, h, w go to shared memory by cp.async, two stages a warp, so
//   the next stage's loads (of this chunk or of the warp's next) are in
//   flight while this one's products are summed.  A landed stage is
//   converted to f64 once (NaN to 0, the row's flag set), the row
//   factors wf * h, wf * g, wf formed, and each lane adds its entries'
//   products row by row.  Warps sync alone; 16-row stages beat 32 and 64
//   (tools/profile_linear.py's shapes): the gathers' latency bounds it.
// - E > 512: chunk_sums, the entries in passes of kWarps tiles of 512 and
//   the chunks of a pass in batches whose scratch [batch, pass] f64 stays
//   within the wrapper's budget.  A block stages one chunk for its eight
//   warps, each summing another tile of it, so a row is gathered once a
//   pass and not once a tile; the first pass keeps the rows' g, h and
//   NaN-zeroed w by position for the later ones, which stage only the
//   columns their entries read.  The shared-memory reads of the products
//   (three an entry and row) bound it.
// - chunk_chain: a block a (leaf, 32 entries), the leaf's chunk sums of
//   the batch read by every thread of the block 256 chunks a round (the
//   next round's loads in flight while a warp adds this round's), one
//   lane an entry adding them in chunk order onto out.  The chain of a
//   large leaf's chunk additions (one f64 add latency a chunk) is the
//   floor of a skewed tree.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // chunk_sums: warps (tiles) a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockBudget = 100 * 1024;   // chunk_sums' stages, bytes
constexpr int kWarpsW = 4;         // chunk_sums_warp: warps a block
constexpr int kWarpRows = 16;      // chunk_sums_warp: rows a stage
constexpr int kMaxSlots = 16;      // entries a lane: a tile <= 512
constexpr int kChainThreads = 256;
constexpr int kRound = 256;        // chunk_chain: chunks a round
constexpr int kChainLeaves = 64;   // chunk_chain's blocks a row, batched

__host__ __device__ inline int align8(int x) { return (x + 7) / 8 * 8; }

// Shared bytes of a chunk_sums block staging `rows` rows (G chunks of R
// rows) of kw columns: two buffers of f32 values [rows, kw], g, h, w
// [3, rows], row ids [rows], NaN flags [rows] and the chunks' places
// [G, 3]; the f64 values [rows, kw] and the f64 row factors [3, rows].
__host__ __device__ inline int stage_bytes(int kw, int rows, int G) {
  return align8(8 * rows * kw + 40 * rows + 24 * G) + 8 * rows * kw
         + 24 * rows;
}

// The step's geometry: G chunks and TW tiles a step (units G TW, one a
// warp), T tiles in the pass, R rows of a chunk a stage (a power of two,
// lg_rows its log), the staged columns [klo, klo + kw).
struct Geo {
  int G, TW, T, R, lg_rows, klo, kw;
};

// Units of a pass of T tiles: G chunks a step where a chunk has fewer
// tiles than warps, else one chunk and kWarps tiles.
__host__ __device__ inline void step_units(int T, int* G, int* TW) {
  *TW = T < kWarps ? T : kWarps;
  *G = T < kWarps ? kWarps / T : 1;
}

// Rows of a chunk a stage at kw staged columns and G chunks a step: the
// most (a power of two, at most chunk) whose stage fits the budget.
__host__ __device__ inline int stage_rows(int kw, int G, int chunk) {
  int rows = 64;
  while (rows > chunk) rows /= 2;
  while (rows > 1 && stage_bytes(kw, G * rows, G) > kBlockBudget)
    rows /= 2;
  return rows;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The leaf of chunk c: the last l with cfirst[l] <= c.
__device__ __forceinline__ int leaf_of(const int* cfirst, int L, int c) {
  int lo = 0, hi = L;          // cfirst[lo] <= c < cfirst[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (cfirst[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// The triangle row of pair entry e (e < P, rows of k1 - i entries).
__device__ __forceinline__ int pair_row(int e, int k1) {
  const double b = 2.0 * k1 + 1.0;
  int i = (int)((b - sqrt(b * b - 8.0 * e)) * 0.5);
  i = max(0, min(i, k1 - 1));
  while (i + 1 < k1 && (i + 1) * k1 - (i + 1) * i / 2 <= e) ++i;
  while (i > 0 && i * k1 - i * (i - 1) / 2 > e) --i;
  return i;
}

// A block's place in its work: step k (chunk group k / tgN, tile group
// k % tgN) and its stage s.
struct Cursor {
  int k, s;
};

// Stage s of step k into one buffer: each of the step's G chunks' place
// (info: start in order, rows, leaf; rows 0 past the batch), its rows
// [s R, s R + R) (ridx, -1 past the chunk) with their NaN flags cleared,
// the values of columns [klo, klo + kw) into xs [G R, kw] (cp.async; 0
// where padded, 1 the intercept, by plain stores) and g, h, w into gs
// [3, G R] (by row, or by position under by_pos).  Every thread of the
// block issues.
__device__ __forceinline__ void issue_stage(
    const float* __restrict__ raw, int F, const int* __restrict__ order,
    const int* __restrict__ seg, const int* __restrict__ cfirst, int L,
    int chunk, int c0, int cend, const float* __restrict__ g,
    const float* __restrict__ h, const float* __restrict__ w, int by_pos,
    const int* __restrict__ feat_idx, int kmax, Geo geo, int tgN,
    Cursor u, int* info, int* ridx, int* nanr, float* xs, float* gs) {
  const int tid = threadIdx.x;
  const int R = geo.R, GR = geo.G * geo.R, kw = geo.kw;
  if (tid < geo.G) {
    const int c = c0 + (u.k / tgN) * geo.G + tid;
    int pos = 0, len = 0, l = 0;
    if (c < cend) {
      l = leaf_of(cfirst, L, c);
      const int ci = c - cfirst[l];
      pos = seg[2 * l] + ci * chunk;
      len = min(chunk, seg[2 * l + 1] - ci * chunk);
    }
    info[3 * tid] = pos;
    info[3 * tid + 1] = len;
    info[3 * tid + 2] = l;
  }
  __syncthreads();
  for (int i = tid; i < GR; i += kThreads) {
    const int gi = i >> geo.lg_rows, rr = u.s * R + (i & (R - 1));
    ridx[i] = rr < info[3 * gi + 1] ? order[info[3 * gi] + rr] : -1;
    nanr[i] = 0;
  }
  __syncthreads();
  for (int i = tid; i < GR; i += kThreads) {
    if (ridx[i] < 0) continue;
    const int gi = i >> geo.lg_rows;
    const int src = by_pos ? info[3 * gi] + u.s * R + (i & (R - 1))
                           : ridx[i];
    cp_async4(gs + i, g + src);
    cp_async4(gs + GR + i, h + src);
    cp_async4(gs + 2 * GR + i, w + src);
  }
  const int q = kThreads / kw, rem = kThreads - q * kw;
  int r = tid / kw, k = tid - r * kw;
  for (int idx = tid; idx < GR * kw; idx += kThreads) {
    const int row = ridx[r];
    if (row >= 0) {
      const int kk = geo.klo + k;
      const int f = kk < kmax
          ? __ldg(feat_idx + (size_t)info[3 * (r >> geo.lg_rows) + 2] * kmax
                  + kk)
          : -1;
      if (f >= 0)
        cp_async4(xs + idx, raw + (size_t)row * F + f);
      else
        xs[idx] = kk == kmax ? 1.0f : 0.0f;
    }
    k += rem;
    r += q;
    if (k >= kw) {
      k -= kw;
      ++r;
    }
  }
}

// One landed stage, converted: the values to f64 (NaN to 0, the row's
// flag set), then the row factors (and, under ghw_out, the row's g, h
// and w with NaN rows' w zeroed, by position).
__device__ __forceinline__ void convert_stage(
    const float* xs, const float* gs, const int* info, const int* ridx,
    int* nanr, double* xd, double* fac, Geo geo, int s, int n,
    float* __restrict__ ghw_out) {
  const int tid = threadIdx.x;
  const int R = geo.R, GR = geo.G * geo.R, kw = geo.kw;
  const int q = kThreads / kw, rem = kThreads - q * kw;
  int r = tid / kw, k = tid - r * kw;
  for (int idx = tid; idx < GR * kw; idx += kThreads) {
    if (ridx[r] >= 0) {
      float v = xs[idx];
      if (isnan(v)) {
        nanr[r] = 1;
        v = 0.0f;
      }
      xd[idx] = (double)v;
    }
    k += rem;
    r += q;
    if (k >= kw) {
      k -= kw;
      ++r;
    }
  }
  __syncthreads();
  for (int i = tid; i < GR; i += kThreads) {
    if (ridx[i] < 0) continue;
    const float wr = nanr[i] ? 0.0f : gs[2 * GR + i];
    const double wf = (double)wr;
    fac[i] = wf * (double)gs[GR + i];
    fac[GR + i] = wf * (double)gs[i];
    fac[2 * GR + i] = wf;
    if (ghw_out) {
      const size_t p = info[3 * (i >> geo.lg_rows)] + s * R + (i & (R - 1));
      ghw_out[p] = gs[i];
      ghw_out[(size_t)n + p] = gs[GR + i];
      ghw_out[2 * (size_t)n + p] = wr;
    }
  }
}

// The sums where E > 512: scratch [c - c0, e - e0] = chunk c's sum of
// entry e, for the entries [e0, e0 + ep) and the chunks c0 <= c < c1
// (and below cfirst[L]), from the columns [klo, k1) (every column in the
// first pass, which also writes ghw_out when later passes read g, h and
// w by position from it).
__global__ void __launch_bounds__(kThreads)
chunk_sums(const float* __restrict__ raw, int F,
           const int* __restrict__ order, const int* __restrict__ seg,
           const int* __restrict__ cfirst, const float* __restrict__ g,
           const float* __restrict__ h, const float* __restrict__ w,
           int by_pos, const int* __restrict__ feat_idx, int L, int kmax,
           int chunk, Geo geo, int c0, int c1, int e0, int ep, int n,
           float* __restrict__ ghw_out, double* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NS = kMaxSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1 = kmax + 1, P = k1 * (k1 + 1) / 2;
  const int R = geo.R, GR = geo.G * geo.R, kw = geo.kw;
  float* xs = reinterpret_cast<float*>(smem);       // [2][GR * kw]
  float* gs = xs + 2 * GR * kw;                     // [2][3 * GR]
  int* ridx = reinterpret_cast<int*>(gs + 6 * GR);  // [2][GR]
  int* nanr = ridx + 2 * GR;                        // [2][GR]
  int* info = nanr + 2 * GR;                        // [2][3 * G]
  double* xd = reinterpret_cast<double*>(
      smem + align8(8 * GR * kw + 40 * GR + 24 * geo.G));
  double* fac = xd + GR * kw;                       // [3 * GR]
  const int cend = min(c1, cfirst[L]);
  if (c0 >= cend) return;
  // steps: chunk groups of G x tile groups of TW
  const int tgN = (geo.T + geo.TW - 1) / geo.TW;
  const int steps = ((cend - c0 + geo.G - 1) / geo.G) * tgN;
  const int nst = (chunk + R - 1) / R;
  // this warp's unit in a step: chunk ug of the group, tile ut of the
  // tile group
  const int ug = warp / geo.TW, ut = warp - ug * geo.TW;
  int fo[NS], ia[NS], ja[NS];
  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;

  Cursor cur{(int)blockIdx.x, 0};
  int b = 0;
  if (cur.k < steps)
    issue_stage(raw, F, order, seg, cfirst, L, chunk, c0, cend, g, h, w,
                by_pos, feat_idx, kmax, geo, tgN, cur, info, ridx, nanr, xs,
                gs);
  cp_async_commit();
  int unit_t = -1;    // the tile this warp's entries were decoded for
  while (cur.k < steps) {
    // the next stage: this step's, else the block's next step's first
    Cursor nxt = cur;
    if (++nxt.s == nst) nxt = Cursor{cur.k + (int)gridDim.x, 0};
    const int nb = b ^ 1;
    if (nxt.k < steps)
      issue_stage(raw, F, order, seg, cfirst, L, chunk, c0, cend, g, h, w,
                  by_pos, feat_idx, kmax, geo, tgN, nxt, info + nb * 3 * geo.G,
                  ridx + nb * GR, nanr + nb * GR, xs + nb * GR * kw,
                  gs + nb * 3 * GR);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int* inf = info + b * 3 * geo.G;
    convert_stage(xs + b * GR * kw, gs + b * 3 * GR, inf, ridx + b * GR,
                  nanr + b * GR, xd, fac, geo, cur.s,
                  n, by_pos ? nullptr : ghw_out);
    __syncthreads();
    const int t = (cur.k % tgN) * geo.TW + ut;
    const int m = ug < geo.G ? min(R, inf[3 * ug + 1] - cur.s * R) : 0;
    if (t < geo.T && m > 0) {
      if (t != unit_t) {
        // entries t * 32 NS + lane + 32 s of the pass: the factor's
        // offset in fac (0 wf * h, GR wf * g, 2 GR wf) and the two
        // design columns (from klo); past the pass, the count's (summed,
        // not written)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int tt = t * 32 * NS + lane + 32 * s;
          const int e = e0 + tt;
          int f = 2, i = kmax, j = kmax;
          if (tt < ep && e < P) {
            i = pair_row(e, k1);
            f = 0;
            j = i + (e - (i * k1 - i * (i - 1) / 2));
          } else if (tt < ep && e < P + k1) {
            f = 1;
            i = e - P;
          }
          fo[s] = f * GR + ug * R;
          ia[s] = i - geo.klo;
          ja[s] = j - geo.klo;
        }
        unit_t = t;
      }
      const double* x = xd + (size_t)ug * R * kw;
      for (int rr = 0; rr < m; ++rr) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          acc[s] = acc[s] + (fac[fo[s] + rr] * x[rr * kw + ia[s]])
                                * x[rr * kw + ja[s]];
      }
      if (cur.s * R + m == inf[3 * ug + 1]) {
        // the chunk's last rows: its sums to scratch
        const int c = c0 + (cur.k / tgN) * geo.G + ug;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int tt = t * 32 * NS + lane + 32 * s;
          if (tt < ep) scratch[(size_t)(c - c0) * ep + tt] = acc[s];
          acc[s] = 0.0;
        }
      }
    }
    __syncthreads();   // the stage just read is the next one's destination
    cur = nxt;
    b = nb;
  }
  cp_async_wait<0>();
}

// -- the sums where E <= 512: a warp a chunk ---------------------------------
// Shared bytes of one chunk_sums_warp warp at R rows of k1 columns: two
// f32 value stages [R, k1], two g, h, w stages [3, R], two stages' row
// ids and NaN flags [R], the f64 values [R, k1] and the f64 row factors
// [3, R].
__host__ __device__ inline int warp_bytes(int k1, int rows) {
  return align8(8 * rows * k1 + 40 * rows) + 8 * rows * k1 + 24 * rows;
}

// A warp's place in its work: chunk c (of leaf l, rows [pos, pos + len)
// of order) and its stage s of nst.
struct WarpCursor {
  int c, l, pos, len, s, nst;
};

__device__ __forceinline__ WarpCursor warp_locate(const int* seg,
                                                  const int* cfirst, int L,
                                                  int c, int cend, int chunk,
                                                  int rows) {
  WarpCursor u{c, 0, 0, 0, 0, 0};
  if (c >= cend) return u;
  u.l = leaf_of(cfirst, L, c);
  const int ci = c - cfirst[u.l];
  u.pos = seg[2 * u.l] + ci * chunk;
  u.len = min(chunk, seg[2 * u.l + 1] - ci * chunk);
  u.nst = (u.len + rows - 1) / rows;
  return u;
}

// Stage s of the cursor's chunk into one buffer: its m rows (ridx) with
// their NaN flags cleared, the values of its k1 columns into xs [m, k1]
// (cp.async; 0 where padded, 1 the intercept, by plain stores) and g, h,
// w into gs [3, R].  Every lane of the warp issues.
__device__ __forceinline__ void warp_issue(
    const float* __restrict__ raw, int F, const int* __restrict__ order,
    const float* __restrict__ g, const float* __restrict__ h,
    const float* __restrict__ w, const int* __restrict__ fi, int kmax,
    WarpCursor u, int rows, int lane, int* ridx, int* nanr,
    float* xs, float* gs) {
  const int k1 = kmax + 1;
  const int p0 = u.pos + u.s * rows;
  const int m = min(rows, u.len - u.s * rows);
  for (int r = lane; r < m; r += 32) {
    ridx[r] = order[p0 + r];
    nanr[r] = 0;
  }
  __syncwarp();
  for (int r = lane; r < m; r += 32) {
    const int row = ridx[r];
    cp_async4(gs + r, g + row);
    cp_async4(gs + rows + r, h + row);
    cp_async4(gs + 2 * rows + r, w + row);
  }
  const int q = 32 / k1, rem = 32 - q * k1;
  int r = lane / k1, k = lane - r * k1;
  for (int idx = lane; idx < m * k1; idx += 32) {
    const int f = k < kmax ? __ldg(fi + k) : -1;
    if (f >= 0)
      cp_async4(xs + idx, raw + (size_t)ridx[r] * F + f);
    else
      xs[idx] = k == kmax ? 1.0f : 0.0f;
    k += rem;
    r += q;
    if (k >= k1) {
      k -= k1;
      ++r;
    }
  }
}

// One landed stage of m rows: the values to f64 (NaN to 0, the row's
// flag set), the row factors, then each lane's entries summed over the
// rows in order.
template <int NS>
__device__ __forceinline__ void warp_sum(
    const float* xs, const float* gs, int* nanr, double* xd, double* fac,
    int k1, int rows, int m, int lane, const int (&fo)[NS],
    const int (&ia)[NS], const int (&ja)[NS], double (&acc)[NS]) {
  const int q = 32 / k1, rem = 32 - q * k1;
  int r = lane / k1, k = lane - r * k1;
  for (int idx = lane; idx < m * k1; idx += 32) {
    float v = xs[idx];
    if (isnan(v)) {
      nanr[r] = 1;
      v = 0.0f;
    }
    xd[idx] = (double)v;
    k += rem;
    r += q;
    if (k >= k1) {
      k -= k1;
      ++r;
    }
  }
  __syncwarp();
  for (int rr = lane; rr < m; rr += 32) {
    const double wf = nanr[rr] ? 0.0 : (double)gs[2 * rows + rr];
    fac[rr] = wf * (double)gs[rows + rr];
    fac[rows + rr] = wf * (double)gs[rr];
    fac[2 * rows + rr] = wf;
  }
  __syncwarp();
  for (int rr = 0; rr < m; ++rr) {
    const double* x = xd + rr * k1;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      acc[s] = acc[s] + (fac[fo[s] + rr] * x[ia[s]]) * x[ja[s]];
  }
}

// scratch [c - c0, e] = chunk c's sum of entry e, for every entry (E <=
// 32 NS) and the chunks c0 <= c < c1 (and below cfirst[L]): chunk c0 + c'
// to warp c' mod (the grid's warps).
template <int NS>
__global__ void __launch_bounds__(kWarpsW * 32)
chunk_sums_warp(const float* __restrict__ raw, int F,
                const int* __restrict__ order, const int* __restrict__ seg,
                const int* __restrict__ cfirst, const float* __restrict__ g,
                const float* __restrict__ h, const float* __restrict__ w,
                const int* __restrict__ feat_idx, int L, int kmax,
                int chunk, int c0, int c1, double* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1 = kmax + 1, P = k1 * (k1 + 1) / 2, E = P + k1 + 1;
  const int R = min(kWarpRows, chunk);
  unsigned char* mine = smem + warp * warp_bytes(k1, R);
  float* xs = reinterpret_cast<float*>(mine);       // [2][R * k1]
  float* gs = xs + 2 * R * k1;                      // [2][3 * R]
  int* ridx = reinterpret_cast<int*>(gs + 6 * R);   // [2][R]
  int* nanr = ridx + 2 * R;                         // [2][R]
  double* xd = reinterpret_cast<double*>(mine + align8(8 * R * k1 + 40 * R));
  double* fac = xd + R * k1;                        // [3 * R]
  // this lane's entries: the factor's offset in fac (0 wf * h, R wf * g,
  // 2R wf) and the two design columns; past E, the count's (summed, not
  // written)
  int fo[NS], ia[NS], ja[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int e = lane + 32 * s;
    int f = 2, i = kmax, j = kmax;
    if (e < P) {
      i = pair_row(e, k1);
      f = 0;
      j = i + (e - (i * k1 - i * (i - 1) / 2));
    } else if (e < P + k1) {
      f = 1;
      i = e - P;
    }
    fo[s] = f * R;
    ia[s] = i;
    ja[s] = j;
  }
  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;

  const int cend = min(c1, cfirst[L]);
  const int step = gridDim.x * kWarpsW;
  WarpCursor cur = warp_locate(seg, cfirst, L,
                               c0 + blockIdx.x * kWarpsW + warp, cend,
                               chunk, R);
  int b = 0;
  if (cur.c < cend)
    warp_issue(raw, F, order, g, h, w, feat_idx + (size_t)cur.l * kmax,
               kmax, cur, R, lane, ridx, nanr, xs, gs);
  cp_async_commit();
  while (cur.c < cend) {
    // the next stage: this chunk's, else the warp's next chunk's first
    WarpCursor nxt = cur;
    if (++nxt.s == nxt.nst)
      nxt = warp_locate(seg, cfirst, L, cur.c + step, cend, chunk, R);
    const int nb = b ^ 1;
    if (nxt.c < cend)
      warp_issue(raw, F, order, g, h, w, feat_idx + (size_t)nxt.l * kmax,
                 kmax, nxt, R, lane, ridx + nb * R, nanr + nb * R,
                 xs + nb * R * k1, gs + nb * 3 * R);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    warp_sum<NS>(xs + b * R * k1, gs + b * 3 * R, nanr + b * R, xd, fac,
                 k1, R, min(R, cur.len - cur.s * R), lane, fo, ia, ja, acc);
    if (cur.s == cur.nst - 1) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int e = lane + 32 * s;
        if (e < E) scratch[(size_t)(cur.c - c0) * E + e] = acc[s];
        acc[s] = 0.0;
      }
    }
    __syncwarp();   // the stage just read is the next one's destination
    cur = nxt;
    b = nb;
  }
  cp_async_wait<0>();
}

constexpr int kGroups = kChainThreads / 32;
constexpr int kPer = kRound / kGroups;       // a thread's loads a round

// Round k's loads of a chunk_chain thread: scratch rows a + k kRound +
// grp + kGroups q (below a + nc) of entry t (below ep), 0 elsewhere.
__device__ __forceinline__ void chain_load(const double* __restrict__ scratch,
                                           int a, int nc, int ep, int t,
                                           int grp, int k,
                                           double (&v)[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int cc = k * kRound + grp + kGroups * q;
    v[q] = (cc < nc && t < ep) ? scratch[(size_t)(a + cc) * ep + t] : 0.0;
  }
}

__device__ __forceinline__ void chain_store(double* buf, int grp, int lane,
                                            const double (&v)[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) buf[(grp + kGroups * q) * 32 + lane] = v[q];
}

// Pass 2: out [l, e0 + t] += the chunk sums of leaf l in [c0, c1) for
// entry e0 + t, added in chunk order, for t in [32 y, 32 y + 32) of the
// pass; block x takes the leaves from the batch's first chunk's leaf on,
// gridDim.x apart.  Every thread loads a round of kRound chunks (the next
// round's loads in flight while warp 0 adds this round's in order).
__global__ void __launch_bounds__(kChainThreads)
chunk_chain(const int* __restrict__ cfirst, int L, int c0, int c1,
            const double* __restrict__ scratch, int ep, int e0, int E,
            double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* buf = reinterpret_cast<double*>(smem);    // [kRound][32]
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int t = blockIdx.y * 32 + lane;
  const int cend = min(c1, cfirst[L]);
  if (c0 >= cend) return;
  double v[kPer];
  for (int l = leaf_of(cfirst, L, c0) + blockIdx.x;
       l < L && cfirst[l] < cend; l += gridDim.x) {
    const int a = max(cfirst[l], c0) - c0;
    const int nc = min(cfirst[l + 1], cend) - c0 - a;
    if (nc <= 0) continue;
    const int rounds = (nc + kRound - 1) / kRound;
    double total = (grp == 0 && t < ep) ? out[(size_t)l * E + e0 + t] : 0.0;
    chain_load(scratch, a, nc, ep, t, grp, 0, v);
    chain_store(buf, grp, lane, v);
    __syncthreads();
    for (int k = 0; k < rounds; ++k) {
      if (k + 1 < rounds) chain_load(scratch, a, nc, ep, t, grp, k + 1, v);
      if (grp == 0) {
        const int m = min(kRound, nc - k * kRound);
        for (int q = 0; q < m; ++q) total = total + buf[q * 32 + lane];
      }
      __syncthreads();
      if (k + 1 < rounds) chain_store(buf, grp, lane, v);
      __syncthreads();
    }
    if (grp == 0 && t < ep) out[(size_t)l * E + e0 + t] = total;
  }
}

// The grid of a kernel launch: at most the blocks the card holds at
// once, at least 1.
template <typename K>
cudaError_t grid_of(K kernel, int threads, int smem, int sms, int nmax,
                    dim3* grid) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = dim3(max(1, min(nmax, sms * per_sm)));
  return cudaSuccess;
}

// The first column an entry of [e0, e1) reads: the triangle row of e0
// (rows rise with e), the first XtG entry's column, or the intercept's.
int first_column(int e0, int e1, int kmax) {
  const int k1 = kmax + 1, P = k1 * (k1 + 1) / 2;
  int lo = kmax;
  if (e0 < P) {
    int rem = e0, i = 0;
    while (rem >= k1 - i) {
      rem -= k1 - i;
      ++i;
    }
    lo = i;
  }
  if (e1 > P) lo = min(lo, max(e0, P) - P);
  return lo;
}

// Entries a lane (NS) of chunk_sums_warp: the least of 3, 4, 8 and 16
// whose 32 NS cover E (1 and 2 spill registers under ptxas); chunk_sums'
// 16 above 512.
int lane_slots(int E) {
  const int opts[] = {3, 4, 8};
  for (int ns : opts)
    if (32 * ns >= E) return ns;
  return kMaxSlots;
}

// The first pass's geometry of chunk_sums at kmax (every column staged).
Geo first_geo(int kmax, int ep, int chunk) {
  Geo geo{};
  geo.T = (ep + 32 * kMaxSlots - 1) / (32 * kMaxSlots);
  step_units(geo.T, &geo.G, &geo.TW);
  geo.klo = 0;
  geo.kw = kmax + 1;
  geo.R = stage_rows(geo.kw, geo.G, chunk);
  return geo;
}

}  // namespace

extern "C" {

// Entries a pass at kmax path features: every entry up to 512 (and for
// chunk_sums where kWarps tiles hold them), else kWarps tiles of 512.
int linear_moments_pass_entries(int kmax) {
  const int k1 = kmax + 1, E = k1 * (k1 + 1) / 2 + k1 + 1;
  return min(E, kWarps * 32 * kMaxSlots);
}

// Shared-memory bytes of a block of the kernel that sums the chunks at
// kmax path features and `chunk` rows a chunk: chunk_sums_warp's warps,
// or chunk_sums' first pass (every column staged: the most any pass
// takes).
int linear_moments_smem_bytes(int kmax, int chunk) {
  const int k1 = kmax + 1, E = k1 * (k1 + 1) / 2 + k1 + 1;
  if (E <= 32 * kMaxSlots)
    return kWarpsW * warp_bytes(k1, min(kWarpRows, chunk));
  const Geo geo = first_geo(kmax, min(E, kWarps * 32 * kMaxSlots), chunk);
  return stage_bytes(geo.kw, geo.G * geo.R, geo.G);
}

// Shared-memory bytes of a chunk_chain block.
int linear_moments_chain_smem_bytes(void) { return kRound * 32 * 8; }

// out [L, E] f64 with E = k1 (k1 + 1) / 2 + k1 + 1, k1 = kmax + 1 (see the
// file's head): out zeroed, then for each pass of ep entries and each
// batch of cb chunks, the sums into scratch [cb, ep] f64 (chunk_sums_warp
// where E <= 512, one pass; chunk_sums above) and chunk_chain onto out.
// With more than one pass, ghw f32 [3, n] holds the rows' g, h and
// NaN-zeroed w by position after the first, and the later passes stage
// only their own columns.  cmax bounds the chunks (cfirst[L]).  Returns
// the CUDA error code of the first failed call (0 on success).
int linear_moments(const float* raw, int F, const int* order,
                   const int* seg, const int* cfirst, const float* g,
                   const float* h, const float* w, const int* feat_idx,
                   int L, int kmax, int chunk, int n, int cmax,
                   double* scratch, int cb, float* ghw, double* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k1 = kmax + 1;
  const int E = k1 * (k1 + 1) / 2 + k1 + 1;
  const bool by_warp = E <= 32 * kMaxSlots;
  const int epass = min(E, kWarps * 32 * kMaxSlots);
  if (L <= 0 || kmax <= 0 || chunk <= 0 || cmax <= 0 || cb <= 0
      || (epass < E && !ghw))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int chain_smem = kRound * 32 * 8;
  static bool chain_set = false;
  if (!chain_set) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
        chain_smem);
    if (e != cudaSuccess) return (int)e;
    chain_set = true;
  }
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)L * E * sizeof(double), s);
  if (e != cudaSuccess) return (int)e;
  for (int e0 = 0; e0 < E; e0 += epass) {
    const int ep = min(epass, E - e0);
    Geo geo{};
    int smem = 0, tgN = 1;
    if (by_warp) {
      smem = kWarpsW * warp_bytes(k1, min(kWarpRows, chunk));
    } else {
      geo = first_geo(kmax, ep, chunk);
      geo.klo = first_column(e0, e0 + ep, kmax);
      geo.kw = k1 - geo.klo;
      geo.R = stage_rows(geo.kw, geo.G, chunk);
      while ((1 << geo.lg_rows) < geo.R) ++geo.lg_rows;
      smem = stage_bytes(geo.kw, geo.G * geo.R, geo.G);
      tgN = (geo.T + geo.TW - 1) / geo.TW;
    }
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    // the first pass reads g, h, w by row (and keeps them by position for
    // the later passes, which read them so)
    const bool first = e0 == 0;
    for (int c0 = 0; c0 < cmax; c0 += cb) {
      const int c1 = min(cmax, c0 + cb);
      dim3 grid;
      if (by_warp) {
        const int ns = lane_slots(E);
#define LM_WARP(N)                                                        \
  static int set##N = 0;                                                  \
  if (smem > 48 * 1024 && smem > set##N) {                                \
    e = cudaFuncSetAttribute(chunk_sums_warp<N>,                          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             smem);                                       \
    if (e != cudaSuccess) return (int)e;                                  \
    set##N = smem;                                                        \
  }                                                                       \
  e = grid_of(chunk_sums_warp<N>, kWarpsW * 32, smem, sms,                \
              (c1 - c0 + kWarpsW - 1) / kWarpsW, &grid);                  \
  if (e != cudaSuccess) return (int)e;                                    \
  chunk_sums_warp<N><<<grid, kWarpsW * 32, smem, s>>>(                    \
      raw, F, order, seg, cfirst, g, h, w, feat_idx, L, kmax, chunk, c0,  \
      c1, scratch)
        if (ns <= 3) { LM_WARP(3); }
        else if (ns <= 4) { LM_WARP(4); }
        else if (ns <= 8) { LM_WARP(8); }
        else { LM_WARP(16); }
#undef LM_WARP
      } else {
        static int set = 0;
        if (smem > 48 * 1024 && smem > set) {
          e = cudaFuncSetAttribute(
              chunk_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
              smem);
          if (e != cudaSuccess) return (int)e;
          set = smem;
        }
        e = grid_of(chunk_sums, kThreads, smem, sms,
                    (c1 - c0 + geo.G - 1) / geo.G * tgN, &grid);
        if (e != cudaSuccess) return (int)e;
        chunk_sums<<<grid, kThreads, smem, s>>>(
            raw, F, order, seg, cfirst, first ? g : ghw,
            first ? h : ghw + n, first ? w : ghw + 2 * (size_t)n,
            first ? 0 : 1, feat_idx, L, kmax, chunk, geo, c0, c1, e0, ep,
            n, first && ep < E ? ghw : nullptr, scratch);
      }
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      // one batch: a block a leaf; several: kChainLeaves blocks walk the
      // batch's leaves
      const int lx = c1 - c0 >= cmax ? L : min(L, kChainLeaves);
      chunk_chain<<<dim3(lx, (ep + 31) / 32), kChainThreads, chain_smem,
                    s>>>(cfirst, L, c0, c1, scratch, ep, e0, E, out);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // extern "C"
