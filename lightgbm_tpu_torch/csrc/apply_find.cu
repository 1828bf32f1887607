// The split tail in one kernel: the children's histograms, their best
// splits and every state-row write of one split.
//
// apply_find_pool replaces lightgbm_tpu/ops/pallas/apply_find.py
// make_apply_find_pool (_apply_find_pool_kernel :256, pallas_call at
// :571); apply_find replaces make_apply_find (:529), the same body with
// both children's histograms given and no pool.  With the pool:
//   1. the smaller child is the left one when nleft * 2 <= cnt (nleft is
//      read from device memory); its histogram is ha or hb accordingly
//      (the fused split passes its left / right pair, the unfused route
//      its one smaller-child histogram twice); h_left = small_left ?
//      h_small : parent - h_small, h_right = parent - h_left, and both
//      pool rows are written (the subtraction trick);
//   2. for both children, every (direction, feature, bin) candidate of
//      ops/split.py _candidate_tensors: L1/L2, max_delta_step, the
//      min-data / min-hessian gates on counts derived from hessians,
//      max_depth, the feature mask and path smoothing;
//   3. the winner by selection_key, feature-major (split.py
//      find_best_split): the largest key, ties to the smallest
//      (feature, direction, bin);
//   4. the best and lstate rows of `leaf` and `right`, the node row and
//      the seg rows -- none of them, and no pool row, when done != 0.
// The tree's child pointers stay on the host.
//
// Arithmetic: split.py's operation order, one f32 rounding per operation
// (this source builds with -fmad=false, ops/_build.py, so no product is
// fused into an add).  Bin prefix sums: one thread per (child, feature,
// channel) adds the B bins sequentially in f64 and rounds each prefix
// once to f32, as torch.cumsum in f64 does on the CPU.  The zero-hessian
// guard 1e-38 is subnormal; nothing here flushes it (no -ftz).
//
// One block of 1024 threads; both children's histograms sit in shared
// memory (2 * F * B * 8 bytes, 114,688 at F=28, B=256, opted in above
// 48 KB).  Bound on this card: bytes for the pool rows (read the parent
// and the smaller child, write two rows: 4 * F * B * 8 bytes); the
// candidate arithmetic (2 * 2 * F * B candidates, a few dozen operations
// each) is far below the f32 rate.  A single block leaves the card
// mostly idle: the tail is latency, not throughput.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// state row layouts (ops/grow.py)
constexpr int BG = 0, BLG = 5, BLH = 6, BLC = 7, BLO = 8, BRO = 9;
constexpr int SG = 0, SH = 1, SC = 2, SDEP = 3, SMN = 5, SMX = 6;

struct HP {
  float l1, l2, min_data, min_hess, min_gain, mds, ps;
  int smooth, max_depth;
};

struct Args {
  float* pool;          // [L, F, B, 2] or null (histograms given)
  const float* ha;      // pool: the smaller child's histogram if the left
  const float* hb;      //   one is smaller / if not; else h_left, h_right
  const int* nleft;
  float* best;          // [L, 10]
  float* lstate;        // [L, 8]
  float* nodes;         // [L - 1, 4]
  int* seg;             // [L, 2]
  const float* consts;  // [4, F, B]: valid0, valid1, nan one-hot, is_cat
  const float* fmask;   // [F]
  int F, B, leaf, right, node, s0, cnt, done;
  HP hp;
};

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// split.threshold_l1
__device__ __forceinline__ float tl1(float s, const HP& hp) {
  if (hp.l1 <= 0.f) return s;
  const float sgn = (float)((0.f < s) - (s < 0.f));
  float a = fabsf(s) - hp.l1;
  a = a < 0.f ? 0.f : a;
  return sgn * a;
}

// split.calculate_leaf_output without count (no smoothing)
__device__ __forceinline__ float leaf_out(float g, float h, const HP& hp) {
  float out = (-tl1(g, hp)) / ((h + hp.l2) + 1e-38f);
  if (hp.mds > 0.f) out = clamp_nan(out, -hp.mds, hp.mds);
  return out;
}

// ... with count and parent output (path smoothing)
__device__ __forceinline__ float leaf_out_s(float g, float h, float c,
                                            float po, const HP& hp) {
  const float out = leaf_out(g, h, hp);
  const float w = c / hp.ps;
  return (out * w) / (w + 1.0f) + po / (w + 1.0f);
}

// split.leaf_gain_given_output
__device__ __forceinline__ float gain_given(float g, float h, float out,
                                            const HP& hp) {
  const float sg = tl1(g, hp);
  return -((2.0f * sg) * out + ((h + hp.l2) * out) * out);
}

// split.leaf_split_gain
__device__ __forceinline__ float split_gain(float g, float h, const HP& hp) {
  const float sg = tl1(g, hp);
  if (hp.mds > 0.f) {
    const float out = leaf_out(g, h, hp);
    return -((2.0f * sg) * out + ((h + hp.l2) * out) * out);
  }
  return (sg * sg) / ((h + hp.l2) + 1e-38f);
}

// split.selection_key
__device__ __forceinline__ float sel_key(float g) {
  return __int_as_float(__float_as_int(g) & ~((1 << 10) - 1));
}

struct Child {
  float sg, sh, cc, po, factor, pgain;
  bool allow;
};

struct Cand {
  float gain, lg, lh, lc, lo, ro;
};

// candidate rank r = f * 2B + d * B + b of one child; A holds the prefix
// sums of numerical features and the raw bins of categorical ones, nanv
// the NaN bin's raw (g, h) per feature
__device__ __forceinline__ Cand candidate(const Args& a, const Child& c,
                                          const float* A, const float* nanv,
                                          int r) {
  const HP& hp = a.hp;
  const int B = a.B;
  const int f = r / (2 * B);
  const int d = (r - f * 2 * B) / B;
  const int b = r - f * 2 * B - d * B;
  const int cell = f * B + b;
  Cand o;
  o.lg = A[2 * cell];
  o.lh = A[2 * cell + 1];
  if (d == 1) {
    o.lg = o.lg + nanv[2 * f];
    o.lh = o.lh + nanv[2 * f + 1];
  }
  o.lc = floorf(o.lh * c.factor + 0.5f);
  const float rg = c.sg - o.lg, rh = c.sh - o.lh, rc = c.cc - o.lc;
  const bool ok = a.consts[d * a.F * B + cell] > 0.5f
                  && o.lc >= hp.min_data && rc >= hp.min_data
                  && o.lh >= hp.min_hess && rh >= hp.min_hess
                  && a.fmask[f] > 0.f && c.allow;
  float gain;
  if (hp.smooth) {
    o.lo = leaf_out_s(o.lg, o.lh, o.lc, c.po, hp);
    o.ro = leaf_out_s(rg, rh, rc, c.po, hp);
    gain = ((gain_given(o.lg, o.lh, o.lo, hp) + gain_given(rg, rh, o.ro, hp))
            - c.pgain) - hp.min_gain;
  } else {
    o.lo = o.ro = 0.f;   // the winner's outputs are computed from its sums
    gain = ((split_gain(o.lg, o.lh, hp) + split_gain(rg, rh, hp)) - c.pgain)
           - hp.min_gain;
  }
  o.gain = ok ? gain : -INFINITY;
  return o;
}

__device__ __forceinline__ bool better(float q, int r, float bq, int br) {
  return q > bq || (q == bq && r < br);
}

template <bool kPool>
__global__ void __launch_bounds__(kThreads) apply_find_kernel(Args a) {
  if (a.done) return;
  extern __shared__ float smem[];
  const int F = a.F, B = a.B;
  const int cells = F * B * 2;
  float* H = smem;                       // [2, F, B, 2] children
  float* nanv = smem + 2 * cells;        // [2, F, 2]
  __shared__ float wq[2][kWarps];
  __shared__ int wr[2][kWarps];
  __shared__ int win[2];

  // the parent's rows, read before any write
  const float* brow = a.best + (size_t)a.leaf * 10;
  const float* lrow = a.lstate + (size_t)a.leaf * 8;
  const float pg = lrow[SG], ph = lrow[SH], pc = lrow[SC];
  const float dep = lrow[SDEP], mn = lrow[SMN], mx = lrow[SMX];
  const float gain_rec = brow[BG];
  const float lg = brow[BLG], lh = brow[BLH], lc = brow[BLC];
  const float lo = brow[BLO], ro = brow[BRO];
  const int nl = *a.nleft;

  // 1. the children's histograms (and, with the pool, its two rows)
  if (kPool) {
    const bool small_left = 2LL * nl <= (long long)a.cnt;
    const float* hs = small_left ? a.ha : a.hb;
    float* prow = a.pool + (size_t)a.leaf * cells;
    float* rrow = a.pool + (size_t)a.right * cells;
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const float p = prow[i], s = hs[i];
      const float hl = small_left ? s : p - s;
      const float hr = p - hl;
      prow[i] = hl;
      rrow[i] = hr;
      H[i] = hl;
      H[cells + i] = hr;
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      H[i] = a.ha[i];
      H[cells + i] = a.hb[i];
    }
  }
  for (int i = threadIdx.x; i < 4 * F; i += kThreads) nanv[i] = 0.f;
  __syncthreads();

  // 2. bin prefix sums in f64, one thread per (child, feature, channel);
  // categorical features keep their raw bins
  const float* nan_oh = a.consts + 2 * F * B;
  const float* catv = a.consts + 3 * F * B;
  for (int j = threadIdx.x; j < 4 * F; j += kThreads) {
    const int c = j / (2 * F);
    const int f = (j / 2) % F;
    const int ch = j % 2;
    const bool cat = catv[f * B] > 0.5f;
    float* A = H + c * cells + f * B * 2 + ch;
    double acc = 0.0;
    for (int b = 0; b < B; ++b) {
      const float v = A[2 * b];
      acc += (double)v;
      if (nan_oh[f * B + b] > 0.5f) nanv[(c * F + f) * 2 + ch] = v;
      if (!cat) A[2 * b] = (float)acc;
    }
  }
  __syncthreads();

  // 3. every candidate of both children; the winner per child
  const float rg = pg - lg, rh = ph - lh, rc = pc - lc;
  const float d_child = dep + 1.0f;
  const bool allow = a.hp.max_depth <= 0 || d_child < (float)a.hp.max_depth;
  Child ch[2];
  ch[0] = Child{lg, lh, lc, lo, 0.f, 0.f, allow};
  ch[1] = Child{rg, rh, rc, ro, 0.f, 0.f, allow};
  for (int c = 0; c < 2; ++c) {
    const float shc = ch[c].sh < 1e-38f ? 1e-38f : ch[c].sh;
    ch[c].factor = ch[c].cc / shc;
    ch[c].pgain = a.hp.smooth ? gain_given(ch[c].sg, ch[c].sh, ch[c].po, a.hp)
                              : split_gain(ch[c].sg, ch[c].sh, a.hp);
  }
  const int ncand = 2 * F * B;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int c = 0; c < 2; ++c) {
    float bq = -INFINITY;
    int br = 0x7fffffff;
    for (int r = threadIdx.x; r < ncand; r += kThreads) {
      const float q = sel_key(
          candidate(a, ch[c], H + c * cells, nanv + c * F * 2, r).gain);
      if (better(q, r, bq, br)) {
        bq = q;
        br = r;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float q = __shfl_down_sync(0xffffffffu, bq, o);
      const int r = __shfl_down_sync(0xffffffffu, br, o);
      if (better(q, r, bq, br)) {
        bq = q;
        br = r;
      }
    }
    if (lane == 0) {
      wq[c][warp] = bq;
      wr[c][warp] = br;
    }
  }
  __syncthreads();
  if (warp < 2) {
    const int c = warp;
    float bq = wq[c][lane];
    int br = wr[c][lane];
    for (int o = 16; o > 0; o >>= 1) {
      const float q = __shfl_down_sync(0xffffffffu, bq, o);
      const int r = __shfl_down_sync(0xffffffffu, br, o);
      if (better(q, r, bq, br)) {
        bq = q;
        br = r;
      }
    }
    if (lane == 0) win[c] = br;
  }
  __syncthreads();

  // 4. the state rows
  if (threadIdx.x < 2) {
    const int c = threadIdx.x;
    const int r = win[c];
    const Cand w = candidate(a, ch[c], H + c * cells, nanv + c * F * 2, r);
    const int f = r / (2 * B);
    const int d = (r - f * 2 * B) / B;
    const int b = r - f * 2 * B - d * B;
    float b_lo = w.lo, b_ro = w.ro;
    if (!a.hp.smooth) {
      b_lo = leaf_out(w.lg, w.lh, a.hp);
      b_ro = leaf_out(ch[c].sg - w.lg, ch[c].sh - w.lh, a.hp);
    }
    const int tgt = c == 0 ? a.leaf : a.right;
    float* bo = a.best + (size_t)tgt * 10;
    bo[0] = w.gain;
    bo[1] = (float)f;
    bo[2] = (float)b;
    bo[3] = d == 1 ? 1.f : 0.f;
    bo[4] = catv[f * B] > 0.5f ? 1.f : 0.f;
    bo[5] = w.lg;
    bo[6] = w.lh;
    bo[7] = w.lc;
    bo[8] = b_lo;
    bo[9] = b_ro;
    float* so = a.lstate + (size_t)tgt * 8;
    so[0] = ch[c].sg;
    so[1] = ch[c].sh;
    so[2] = ch[c].cc;
    so[3] = d_child;
    so[4] = (float)a.node;
    so[5] = mn;
    so[6] = mx;
    so[7] = ch[c].po;
  } else if (threadIdx.x == 32) {
    float* no = a.nodes + (size_t)a.node * 4;
    no[0] = gain_rec;
    no[1] = leaf_out(pg, ph, a.hp);
    no[2] = ph;
    no[3] = pc;
    a.seg[2 * a.leaf + 1] = nl;
    a.seg[2 * a.right] = a.s0 + nl;
    a.seg[2 * a.right + 1] = a.cnt - nl;
  }
}

// both children's histograms and their NaN-bin values
// (apply_find.apply_find_supported gates on the same size)
inline int smem_bytes(int F, int B) {
  return F * B * 2 * 4 * 2 + F * 2 * 4 * 2;
}

template <bool kPool>
int launch(const Args& a, void* stream) {
  const int smem = smem_bytes(a.F, a.B);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        apply_find_kernel<kPool>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  apply_find_kernel<kPool><<<1, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(float* pool, const float* ha, const float* hb,
               const int* nleft, float* best, float* lstate, float* nodes,
               int* seg, const float* consts, const float* fmask, int F,
               int B, int leaf, int right, int node, int s0, int cnt,
               int done, int max_depth, float l1, float l2, float min_data,
               float min_hess, float min_gain, float mds, float ps,
               int smooth) {
  return Args{pool, ha, hb, nleft, best, lstate, nodes, seg, consts, fmask,
              F, B, leaf, right, node, s0, cnt, done,
              HP{l1, l2, min_data, min_hess, min_gain, mds, ps, smooth,
                 max_depth}};
}

}  // namespace

extern "C" {

// The pool entry: ha / hb the smaller child's histogram candidates
// (left-smaller / right-smaller), pool [L, F, B, 2] updated in place.
int apply_find_pool(float* pool, const float* ha, const float* hb,
                    const int* nleft, float* best, float* lstate,
                    float* nodes, int* seg, const float* consts,
                    const float* fmask, int F, int B, int leaf, int right,
                    int node, int s0, int cnt, int done, int max_depth,
                    float l1, float l2, float min_data, float min_hess,
                    float min_gain, float mds, float ps, int smooth,
                    void* stream) {
  return launch<true>(
      make_args(pool, ha, hb, nleft, best, lstate, nodes, seg, consts, fmask,
                F, B, leaf, right, node, s0, cnt, done, max_depth, l1, l2,
                min_data, min_hess, min_gain, mds, ps, smooth),
      stream);
}

// The plain-pool entry: h_left and h_right given, no pool.
int apply_find(const float* h_left, const float* h_right, const int* nleft,
               float* best, float* lstate, float* nodes, int* seg,
               const float* consts, const float* fmask, int F, int B,
               int leaf, int right, int node, int s0, int cnt, int done,
               int max_depth, float l1, float l2, float min_data,
               float min_hess, float min_gain, float mds, float ps,
               int smooth, void* stream) {
  return launch<false>(
      make_args(nullptr, h_left, h_right, nleft, best, lstate, nodes, seg,
                consts, fmask, F, B, leaf, right, node, s0, cnt, done,
                max_depth, l1, l2, min_data, min_hess, min_gain, mds, ps,
                smooth),
      stream);
}

}  // extern "C"
