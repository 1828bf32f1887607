// The split tail in one kernel: the children's histograms, their best
// splits and every state-row write of one split.
//
// apply_find_pool replaces lightgbm_tpu/ops/pallas/apply_find.py
// make_apply_find_pool (_apply_find_pool_kernel :256, pallas_call at
// :571); apply_find replaces make_apply_find (:529), the same body with
// both children's histograms given and no pool.  With the pool:
//   1. the smaller child is the left one when nleft * 2 <= cnt (nleft is
//      read from device memory), or, given the split's global side
//      (side = (nl_g, cnt_g), the counts summed over the ranks of a
//      parallel learner, ops/apply_find.py), when nl_g * 2 <= cnt_g; the
//      segments move by the local nleft and cnt either way; its
//      histogram is ha or hb accordingly
//      (the fused split passes its left / right pair, the unfused route
//      its one smaller-child histogram twice); h_left = small_left ?
//      h_small : parent - h_small, h_right = parent - h_left, and both
//      pool rows are written (the subtraction trick);
//   2. for both children, every (direction, feature, bin) candidate of
//      ops/split.py _candidate_tensors: L1/L2, max_delta_step, the
//      min-data / min-hessian gates on counts derived from hessians,
//      max_depth, the feature mask and path smoothing;
//   3. the winner by selection_key, feature-major (split.py
//      find_best_split): the largest key, ties to the smallest rank
//      r = f * 2B + d * B + b;
//   4. the best and lstate rows of `leaf` and `right`, the node row and
//      the seg rows -- none of them, and no pool row, when done != 0.
// The tree's child pointers stay on the host.
//
// Monotone constraints, the basic method (make_apply_find's mono_s mode,
// apply_find.py:377-416), are a second instantiation of the same body,
// apply_find_mono_kernel, chosen by the host; apply_find_kernel is the
// unconstrained code.  In it every block derives both children's output
// bounds from the parent's (lstate SMN / SMX) and the midpoint of its
// winner's outputs when the winning feature is monotone and the split
// numerical (BasicLeafConstraints::Update); each candidate's outputs are
// clipped to its child's bounds (the larger of the output and mn, then
// the smaller of that and mx, as jnp.clip), a candidate whose outputs
// break its feature's sign is invalid, the gains are given-output gains,
// those of monotone features times the depth penalty read from the host's
// table at the children's depth, the parent gain is the given-output gain
// at the child's output, the winners keep their clipped outputs and the
// children's lstate rows their bounds.  Each feature's sign rides in its
// flag word beside the categorical bit, so the shared memory is the same.
//
// Arithmetic: split.py's operation order, one f32 rounding per operation
// (this source builds with -fmad=false, ops/_build.py, so no product is
// fused into an add).  Bin prefix sums: one thread per (child, feature,
// channel) adds the B bins sequentially in f64 and rounds each prefix
// once to f32, as torch.cumsum in f64 does on the CPU; a parallel scan
// would add in another order and change bits.  The zero-hessian guard
// 1e-38 is subnormal; nothing here flushes it (no -ftz).
//
// Design: one thread-block cluster over the features (the geometry is the
// wrapper's, ops/apply_find.tail_geometry).  Block k owns features
// [k * fpb, min(F, (k + 1) * fpb)): it moves only their slice of the pool
// rows, stages only their two children's histograms, one validity byte a
// (feature, bin) with the feature mask folded in, the NaN bin's index and
// the categorical flag in shared memory (fpb * (17 B + 24) bytes), runs
// their f64 prefix chains out of shared memory (the NaN bin read once, not
// tested at each link) and searches their candidates, keeping its best
// (key, rank) and that candidate's fields per child.  After cluster.sync()
// block 0 reads every block's best through distributed shared memory,
// merges them with the same better() (associative over disjoint rank
// ranges, so the winner is the one-block search's bit for bit) and writes
// the state rows; a second cluster.sync() keeps every block resident
// until block 0 has read it.  Bound on this card: bytes for the pool rows
// (read the parent and the smaller child, write two rows: 4 * F * B * 8
// bytes); the candidate arithmetic is far below the f32 rate.  The tail
// is latency: the B-link f64 chain, a global load and two cluster
// barriers; more blocks shorten only the candidate search.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;       // non-portable above 8
constexpr int kPortableCluster = 8;
constexpr int kMaxSmem = 232448;      // one block's shared memory
constexpr int kStaticReserve = 1024;  // the kernel's static shared memory
constexpr int kNone = 0x7fffffff;     // the rank of no candidate

// state row layouts (ops/grow.py)
constexpr int BG = 0, BF = 1, BCAT = 4, BLG = 5, BLH = 6, BLC = 7, BLO = 8,
              BRO = 9;
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
  const int* side;      // pool: (nl_g, cnt_g) or null (the local test)
  float* best;          // [L, 10]
  float* lstate;        // [L, 8]
  float* nodes;         // [L - 1, 4]
  int* seg;             // [L, 2]
  const float* consts;  // [4, F, B]: valid0, valid1, nan one-hot, is_cat
  const float* fmask;   // [F]
  const int* mono;      // [F] monotone sign (monotone instantiation)
  const float* pen;     // [pen_len] the depth penalty factor by depth
  int F, B, leaf, right, node, s0, cnt, done;
  int blocks, fpb;      // the cluster: blocks of fpb features
  int pen_len;
  HP hp;
};

// one block's best candidate of one child, read by block 0
struct Best {
  float key;
  int rank;
  float gain, lg, lh, lc, lo, ro;
  int cat;
};

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// a feature's flag word: bit 0 categorical, bit 1 sign +1, bit 2 sign -1
constexpr int kCat = 1, kInc = 2, kDec = 4;

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

// the candidate (lf, d, b) -- local rank lf * 2B + d * B + b -- of one
// child in this block; A holds its features' prefix sums (the raw bins
// of categorical ones), nanv the NaN bin's raw (g, h) per feature, vb
// one byte a (feature, bin): bit d = valid in direction d and feature on,
// flag the feature's flag word; the monotone instantiation clips to
// [mn, mx] and scales monotone features' gains by pen
template <bool kMono>
__device__ __forceinline__ Cand candidate(const HP& hp, const Child& c,
                                          float mn, float mx, float pen,
                                          const float* A, const float* nanv,
                                          const uint8_t* vb, int flag, int B,
                                          int lf, int d, int b) {
  const int cell = lf * B + b;
  Cand o;
  o.lg = A[2 * cell];
  o.lh = A[2 * cell + 1];
  if (d == 1) {
    o.lg = o.lg + nanv[2 * lf];
    o.lh = o.lh + nanv[2 * lf + 1];
  }
  o.lc = floorf(o.lh * c.factor + 0.5f);
  const float rg = c.sg - o.lg, rh = c.sh - o.lh, rc = c.cc - o.lc;
  bool ok = ((vb[cell] >> d) & 1) != 0
            && o.lc >= hp.min_data && rc >= hp.min_data
            && o.lh >= hp.min_hess && rh >= hp.min_hess && c.allow;
  float gain;
  if (kMono) {
    // split.py _candidate_tensors' constrained branch
    float lo = hp.smooth ? leaf_out_s(o.lg, o.lh, o.lc, c.po, hp)
                         : leaf_out(o.lg, o.lh, hp);
    float ro = hp.smooth ? leaf_out_s(rg, rh, rc, c.po, hp)
                         : leaf_out(rg, rh, hp);
    lo = min_nan(max_nan(lo, mn), mx);
    ro = min_nan(max_nan(ro, mn), mx);
    o.lo = lo;
    o.ro = ro;
    if (((flag & kInc) && lo > ro) || ((flag & kDec) && lo < ro)) ok = false;
    gain = ((gain_given(o.lg, o.lh, lo, hp) + gain_given(rg, rh, ro, hp))
            - c.pgain) - hp.min_gain;
    if (flag & (kInc | kDec)) gain = gain * pen;
  } else if (hp.smooth) {
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

__device__ __forceinline__ void warp_best(float& bq, int& br) {
  for (int o = 16; o > 0; o >>= 1) {
    const float q = __shfl_down_sync(0xffffffffu, bq, o);
    const int r = __shfl_down_sync(0xffffffffu, br, o);
    if (better(q, r, bq, br)) {
      bq = q;
      br = r;
    }
  }
}

// in-place inclusive prefix sums of A[0], A[2], ..., A[2 (B - 1)] in f64,
// each rounded once to f32, in bin order; loads run eight bins ahead of
// the chain (B % 8 == 0)
__device__ __forceinline__ void prefix_f64(float* A, int B) {
  double acc = 0.0;
  float cur[8], nxt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cur[k] = A[2 * k];
  for (int b = 0; b < B; b += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) nxt[k] = b + 8 < B ? A[2 * (b + 8 + k)] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += (double)cur[k];
      A[2 * (b + k)] = (float)acc;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) cur[k] = nxt[k];
  }
}

// shared bytes of a block of fpb features: both children's histograms
// [2, fpb, B, 2] f32, the NaN bins' values [2, fpb, 2] f32, the NaN bin
// and the categorical flag [fpb] i32 each, the validity bytes [fpb, B]
__host__ __device__ inline int smem_bytes(int fpb, int B) {
  return fpb * (17 * B + 24);
}

template <bool kPool, bool kMono>
__device__ __forceinline__ void tail(const Args& a) {
  if (a.done) return;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int F = a.F, B = a.B, fpb = a.fpb;
  const int blk = blockIdx.x;              // the grid is one cluster
  const int f0 = blk * fpb;
  const int nf = min(fpb, F - f0);
  const int cs = fpb * B * 2;              // floats of one child's slice
  float* H = reinterpret_cast<float*>(smem4);   // [2, fpb, B, 2]
  float* nanv = H + 2 * cs;                     // [2, fpb, 2]
  int* nanb = reinterpret_cast<int*>(nanv + 4 * fpb);   // [fpb]
  int* flags = nanb + fpb;                               // [fpb]
  uint8_t* vbits = reinterpret_cast<uint8_t*>(flags + fpb);  // [fpb, B]
  __shared__ float parent[18];             // the leaf's best, lstate rows
  __shared__ float wq[2][kWarps];
  __shared__ int wr[2][kWarps];
  __shared__ Best res[2];

  for (int i = threadIdx.x; i < nf; i += kThreads) nanb[i] = -1;
  __syncthreads();

  // 1. this block's slice of the children's histograms (with the pool,
  // of its two rows), the masks and the parent's rows, read before any
  // block writes them (block 0 writes after the first cluster barrier)
  if (threadIdx.x < 10) {
    parent[threadIdx.x] = a.best[(size_t)a.leaf * 10 + threadIdx.x];
  } else if (threadIdx.x < 18) {
    parent[threadIdx.x] = a.lstate[(size_t)a.leaf * 8 + threadIdx.x - 10];
  }
  const int nl = *a.nleft;
  const bool small_left = a.side != nullptr
                              ? 2LL * a.side[0] <= (long long)a.side[1]
                              : 2LL * nl <= (long long)a.cnt;
  const size_t g0 = (size_t)f0 * B;        // this block's first cell
  const size_t FB = (size_t)F * B;
  const float2* ha = reinterpret_cast<const float2*>(a.ha) + g0;
  const float2* hb = reinterpret_cast<const float2*>(a.hb) + g0;
  float2* prow = kPool ? reinterpret_cast<float2*>(a.pool) + a.leaf * FB + g0
                      : nullptr;
  float2* rrow = kPool ? reinterpret_cast<float2*>(a.pool) + a.right * FB + g0
                      : nullptr;
  float2* H2 = reinterpret_cast<float2*>(H);
  const int ncell = nf * B;
  for (int i = threadIdx.x; i < ncell; i += kThreads) {
    float2 hl, hr;
    if (kPool) {
      const float2 p = prow[i], sa = ha[i], sb = hb[i];
      const float2 s = small_left ? sa : sb;
      hl = small_left ? s : make_float2(p.x - s.x, p.y - s.y);
      hr = make_float2(p.x - hl.x, p.y - hl.y);
      prow[i] = hl;
      rrow[i] = hr;
    } else {
      hl = ha[i];
      hr = hb[i];
    }
    H2[i] = hl;
    H2[cs / 2 + i] = hr;
    const int lf = i / B, b = i - lf * B;
    const size_t gc = g0 + i;
    const int v = (a.consts[gc] > 0.5f ? 1 : 0)
                  | (a.consts[FB + gc] > 0.5f ? 2 : 0);
    vbits[i] = a.fmask[f0 + lf] > 0.f ? (uint8_t)v : (uint8_t)0;
    if (a.consts[2 * FB + gc] > 0.5f) nanb[lf] = b;   // one-hot: one bin
    if (b == 0) {
      int fl = a.consts[3 * FB + gc] > 0.5f ? kCat : 0;
      if (kMono) {
        const int sg = a.mono[f0 + lf];
        fl |= sg > 0 ? kInc : (sg < 0 ? kDec : 0);
      }
      flags[lf] = fl;
    }
  }
  __syncthreads();

  // 2. bin prefix sums in f64, one thread per (child, feature, channel);
  // categorical features keep their raw bins
  for (int j = threadIdx.x; j < 4 * nf; j += kThreads) {
    const int c = j / (2 * nf);
    const int lf = (j / 2) % nf;
    const int ch = j % 2;
    float* A = H + c * cs + lf * B * 2 + ch;
    const int nb = nanb[lf];
    nanv[(c * fpb + lf) * 2 + ch] = nb >= 0 ? A[2 * nb] : 0.f;
    if (!(flags[lf] & kCat)) prefix_f64(A, B);
  }
  __syncthreads();

  // 3. this block's candidates of both children; its winner per child
  const float pg = parent[10 + SG], ph = parent[10 + SH];
  const float pc = parent[10 + SC], dep = parent[10 + SDEP];
  const float lg = parent[BLG], lh = parent[BLH], lc = parent[BLC];
  const float lo = parent[BLO], ro = parent[BRO];
  const float rg = pg - lg, rh = ph - lh, rc = pc - lc;
  const float d_child = dep + 1.0f;
  const bool allow = a.hp.max_depth <= 0 || d_child < (float)a.hp.max_depth;
  // the children's output bounds: the parent's, or under the basic method
  // pinned to either side of the winner's midpoint (apply_find.py:384-389)
  const float mn_p = parent[10 + SMN], mx_p = parent[10 + SMX];
  float l_mn = mn_p, l_mx = mx_p, r_mn = mn_p, r_mx = mx_p, pen = 1.f;
  if (kMono) {  // the unconstrained instantiation never reads these
    int fw = (int)parent[BF];
    fw = fw < 0 ? 0 : (fw >= F ? F - 1 : fw);
    const int sg = parent[BCAT] > 0.5f ? 0 : a.mono[fw];
    const float mid = (lo + ro) * 0.5f;
    if (sg < 0) l_mn = max_nan(mn_p, mid);
    if (sg > 0) l_mx = min_nan(mx_p, mid);
    if (sg > 0) r_mn = max_nan(mn_p, mid);
    if (sg < 0) r_mx = min_nan(mx_p, mid);
    int di = (int)d_child;
    di = di < 0 ? 0 : (di >= a.pen_len ? a.pen_len - 1 : di);
    pen = a.pen[di];
  }
  Child ch[2];
  ch[0] = Child{lg, lh, lc, lo, 0.f, 0.f, allow};
  ch[1] = Child{rg, rh, rc, ro, 0.f, 0.f, allow};
  for (int c = 0; c < 2; ++c) {
    const float shc = ch[c].sh < 1e-38f ? 1e-38f : ch[c].sh;
    ch[c].factor = ch[c].cc / shc;
    ch[c].pgain = (kMono || a.hp.smooth)
                      ? gain_given(ch[c].sg, ch[c].sh, ch[c].po, a.hp)
                      : split_gain(ch[c].sg, ch[c].sh, a.hp);
  }
  const int ncand = nf * 2 * B;
  const int r0 = f0 * 2 * B;               // the global rank of rl = 0
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // a thread's ranks step by kThreads: (lf, d * B + b) advanced without
  // a division
  const int step_f = kThreads / (2 * B), step_r = kThreads % (2 * B);
  const int lf0 = threadIdx.x / (2 * B), rem0 = threadIdx.x % (2 * B);
  for (int c = 0; c < 2; ++c) {
    float bq = -INFINITY;
    int br = kNone;
    int lf = lf0, rem = rem0;
    for (int rl = threadIdx.x; rl < ncand; rl += kThreads) {
      const int d = rem >= B ? 1 : 0;
      const float q = sel_key(candidate<kMono>(
          a.hp, ch[c], c ? r_mn : l_mn, c ? r_mx : l_mx, pen, H + c * cs,
          nanv + c * fpb * 2, vbits, flags[lf], B, lf, d, rem - d * B).gain);
      if (better(q, r0 + rl, bq, br)) {
        bq = q;
        br = r0 + rl;
      }
      lf += step_f;
      rem += step_r;
      if (rem >= 2 * B) {
        rem -= 2 * B;
        ++lf;
      }
    }
    warp_best(bq, br);
    if (lane == 0) {
      wq[c][warp] = bq;
      wr[c][warp] = br;
    }
  }
  __syncthreads();
  if (warp < 2) {
    const int c = warp;
    float bq = lane < kWarps ? wq[c][lane] : -INFINITY;
    int br = lane < kWarps ? wr[c][lane] : kNone;
    warp_best(bq, br);
    if (lane == 0) {
      Best w{bq, br, -INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
      if (br != kNone) {
        const int rl = br - r0;
        const int lf = rl / (2 * B), d = (rl - lf * 2 * B) / B;
        const Cand o = candidate<kMono>(
            a.hp, ch[c], c ? r_mn : l_mn, c ? r_mx : l_mx, pen, H + c * cs,
            nanv + c * fpb * 2, vbits, flags[lf], B, lf, d,
            rl - lf * 2 * B - d * B);
        w.gain = o.gain;
        w.lg = o.lg;
        w.lh = o.lh;
        w.lc = o.lc;
        w.lo = o.lo;
        w.ro = o.ro;
        if (!kMono && !a.hp.smooth) {
          w.lo = leaf_out(o.lg, o.lh, a.hp);
          w.ro = leaf_out(ch[c].sg - o.lg, ch[c].sh - o.lh, a.hp);
        }
        w.cat = flags[lf] & kCat;
      }
      res[c] = w;
    }
  }

  // 4. the winner across the cluster, read by block 0 through
  // distributed shared memory, then the state rows
  cluster.sync();
  Best w{};
  if (blk == 0 && warp < 2) {
    const int c = warp;
    float bq = -INFINITY;
    int br = kNone;
    if (lane < a.blocks) {
      const Best* rb = cluster.map_shared_rank(&res[c], lane);
      bq = rb->key;
      br = rb->rank;
    }
    warp_best(bq, br);
    br = __shfl_sync(0xffffffffu, br, 0);
    if (lane == 0) {
      const int kw = br == kNone ? 0 : br / (2 * B) / fpb;
      w = *cluster.map_shared_rank(&res[c], kw);
    }
  }
  cluster.sync();   // no block leaves while block 0 may read it
  if (blk != 0) return;
  if (warp < 2 && lane == 0) {
    const int c = warp;
    const int r = w.rank;
    const int f = r / (2 * B);
    const int d = (r - f * 2 * B) / B;
    const int b = r - f * 2 * B - d * B;
    const int tgt = c == 0 ? a.leaf : a.right;
    float* bo = a.best + (size_t)tgt * 10;
    bo[0] = w.gain;
    bo[1] = (float)f;
    bo[2] = (float)b;
    bo[3] = d == 1 ? 1.f : 0.f;
    bo[4] = w.cat ? 1.f : 0.f;
    bo[5] = w.lg;
    bo[6] = w.lh;
    bo[7] = w.lc;
    bo[8] = w.lo;
    bo[9] = w.ro;
    float* so = a.lstate + (size_t)tgt * 8;
    so[0] = ch[c].sg;
    so[1] = ch[c].sh;
    so[2] = ch[c].cc;
    so[3] = d_child;
    so[4] = (float)a.node;
    so[5] = kMono ? (c ? r_mn : l_mn) : parent[10 + SMN];
    so[6] = kMono ? (c ? r_mx : l_mx) : parent[10 + SMX];
    so[7] = ch[c].po;
  } else if (threadIdx.x == 64) {
    float* no = a.nodes + (size_t)a.node * 4;
    no[0] = parent[BG];
    no[1] = leaf_out(pg, ph, a.hp);
    no[2] = ph;
    no[3] = pc;
    a.seg[2 * a.leaf + 1] = nl;
    a.seg[2 * a.right] = a.s0 + nl;
    a.seg[2 * a.right + 1] = a.cnt - nl;
  }
}

template <bool kPool>
__global__ void __launch_bounds__(kThreads) apply_find_kernel(Args a) {
  tail<kPool, false>(a);
}

template <bool kPool>
__global__ void __launch_bounds__(kThreads) apply_find_mono_kernel(Args a) {
  tail<kPool, true>(a);
}

template <bool kPool, bool kMono>
void (*kernel())(Args) {
  return kMono ? apply_find_mono_kernel<kPool> : apply_find_kernel<kPool>;
}

// the wrapper's geometry (ops/apply_find.tail_geometry), refused where it
// misses a feature or does not fit
bool geometry_ok(int F, int B, int blocks, int fpb) {
  return F >= 1 && B >= 8 && B % 8 == 0 && blocks >= 1
         && blocks <= kMaxCluster && fpb >= 1
         && (long long)blocks * fpb >= F && (long long)(blocks - 1) * fpb < F
         && (long long)fpb * (17LL * B + 24) <= kMaxSmem - kStaticReserve;
}

// each call names its kernel: the analyzer's smem pass reads the
// non-portable cluster opt-in of each kernel from this source
template <bool kPool, bool kMono>
cudaError_t set_attributes(int smem, int blocks) {
  static int smem_set = 0;
  static bool nonportable = false;
  if (smem > smem_set) {
    const cudaError_t e =
        kMono ? cudaFuncSetAttribute(
                    apply_find_mono_kernel<kPool>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
              : cudaFuncSetAttribute(
                    apply_find_kernel<kPool>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (blocks > kPortableCluster && !nonportable) {
    const cudaError_t e =
        kMono ? cudaFuncSetAttribute(
                    apply_find_mono_kernel<kPool>,
                    cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
              : cudaFuncSetAttribute(
                    apply_find_kernel<kPool>,
                    cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable = true;
  }
  return cudaSuccess;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void configure(Launch& l, int blocks, int smem, cudaStream_t s) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(blocks);
  l.cfg.blockDim = dim3(kThreads);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = s;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = blocks;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
}

template <bool kPool, bool kMono>
int launch_as(const Args& a, void* stream) {
  const int smem = smem_bytes(a.fpb, a.B);
  cudaError_t e = set_attributes<kPool, kMono>(smem, a.blocks);
  if (e != cudaSuccess) return (int)e;
  Launch l;
  configure(l, a.blocks, smem, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&l.cfg, kernel<kPool, kMono>(), a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool kPool>
int launch(const Args& a, int mono, void* stream) {
  if (!geometry_ok(a.F, a.B, a.blocks, a.fpb)
      || (mono && (a.mono == nullptr || a.pen == nullptr || a.pen_len < 1)))
    return (int)cudaErrorInvalidValue;
  return mono ? launch_as<kPool, true>(a, stream)
              : launch_as<kPool, false>(a, stream);
}

template <bool kPool, bool kMono>
int occupancy(int smem, int blocks) {
  cudaError_t e = set_attributes<kPool, kMono>(smem, blocks);
  if (e != cudaSuccess) return -(int)e;
  Launch l;
  configure(l, blocks, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel<kPool, kMono>(), &l.cfg);
  return e != cudaSuccess ? -(int)e : n;
}

Args make_args(float* pool, const float* ha, const float* hb,
               const int* nleft, const int* side, float* best,
               float* lstate, float* nodes, int* seg, const float* consts,
               const float* fmask,
               const int* mono, const float* pen, int F, int B, int leaf,
               int right, int node, int s0, int cnt, int done, int blocks,
               int fpb, int max_depth, int pen_len, float l1, float l2,
               float min_data, float min_hess, float min_gain, float mds,
               float ps, int smooth) {
  return Args{pool, ha, hb, nleft, side, best, lstate, nodes, seg, consts,
              fmask, mono, pen, F, B, leaf, right, node, s0, cnt, done,
              blocks, fpb, pen_len,
              HP{l1, l2, min_data, min_hess, min_gain, mds, ps, smooth,
                 max_depth}};
}

}  // namespace

extern "C" {

// Dynamic shared bytes of one block of fpb features at B bins
// (ops/apply_find.tail_smem_bytes gives the same).
int apply_find_smem_bytes(int fpb, int B) { return smem_bytes(fpb, B); }

// Clusters of this geometry the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: the launch cannot run) of the
// unconstrained or, with mono, the monotone instantiation, or minus the
// CUDA error code.
int apply_find_max_clusters(int pool, int F, int B, int blocks, int fpb,
                            int mono) {
  if (!geometry_ok(F, B, blocks, fpb)) return -(int)cudaErrorInvalidValue;
  const int smem = smem_bytes(fpb, B);
  if (pool)
    return mono ? occupancy<true, true>(smem, blocks)
                : occupancy<true, false>(smem, blocks);
  return mono ? occupancy<false, true>(smem, blocks)
              : occupancy<false, false>(smem, blocks);
}

// The pool entry: ha / hb the smaller child's histogram candidates
// (left-smaller / right-smaller), side the split's global (nl_g, cnt_g)
// or null (the local nleft * 2 <= cnt), pool [L, F, B, 2] updated in place;
// one cluster of `blocks` blocks of `fpb` features.  mono != 0 launches
// the monotone instantiation with the signs `mono_s` [F] and the depth
// penalty table `pen` [pen_len] (all 1.0 without a penalty).  Every pointer
// 8-byte aligned.  Returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for a geometry that misses a feature or does not
// fit, or a monotone launch without its constants).
int apply_find_pool(float* pool, const float* ha, const float* hb,
                    const int* nleft, const int* side, float* best,
                    float* lstate, float* nodes, int* seg, const float* consts,
                    const float* fmask, const int* mono_s, const float* pen,
                    int F, int B, int leaf, int right, int node, int s0,
                    int cnt, int done, int blocks, int fpb, int max_depth,
                    int pen_len, float l1, float l2, float min_data,
                    float min_hess, float min_gain, float mds, float ps,
                    int smooth, int mono, void* stream) {
  return launch<true>(
      make_args(pool, ha, hb, nleft, side, best, lstate, nodes, seg, consts,
                fmask, mono_s, pen, F, B, leaf, right, node, s0, cnt, done,
                blocks, fpb, max_depth, pen_len, l1, l2, min_data, min_hess,
                min_gain, mds, ps, smooth),
      mono, stream);
}

// The plain-pool entry: h_left and h_right given, no pool.
int apply_find(const float* h_left, const float* h_right, const int* nleft,
               float* best, float* lstate, float* nodes, int* seg,
               const float* consts, const float* fmask, const int* mono_s,
               const float* pen, int F, int B, int leaf, int right, int node,
               int s0, int cnt, int done, int blocks, int fpb, int max_depth,
               int pen_len, float l1, float l2, float min_data,
               float min_hess, float min_gain, float mds, float ps,
               int smooth, int mono, void* stream) {
  return launch<false>(
      make_args(nullptr, h_left, h_right, nleft, nullptr, best, lstate, nodes,
                seg, consts, fmask, mono_s, pen, F, B, leaf, right, node, s0,
                cnt, done, blocks, fpb, max_depth, pen_len, l1, l2, min_data,
                min_hess, min_gain, mds, ps, smooth),
      mono, stream);
}

}  // extern "C"
