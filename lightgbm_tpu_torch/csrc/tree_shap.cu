// TreeSHAP contributions (pred_contrib) of a forest, one thread a row.
//
// Replaces no TPU kernel: the JAX package computes TreeSHAP on the host,
// one row at a time in a Python recursion (lightgbm_tpu/models/shap.py:97,
// _tree_shap), which cannot run at the main path's width (65,536 rows x
// 10 trees x 255 leaves).  The function is LightGBM's Tree::TreeSHAP over
// the trees' data counts (src/io/tree.cpp), the port's
// models/shap.tree_shap_ref operation for operation: built with
// -fmad=false, the card's contributions equal the plain version's bit for
// bit.
//
// Each thread walks every tree of the forest in order (iteration, then
// class) for its row.  The recursion is an explicit depth-first stack that
// visits left before right, as the plain version does, so the leaves'
// terms reach the tree's phi in the same order; each frame holds the node,
// its depth, the unique depth it enters with, the parent's split feature
// and the incoming zero and one fractions.  The path of a node at depth d
// lives in its own segment of the row's scratch (offset d (d + 1) / 2,
// d + 1 elements), copied from its parent's segment, which no node of the
// left subtree overwrites: LightGBM's (D + 1)(D + 2) / 2 elements a row
// for a forest of depth D.  The scratch is in global memory, one array per
// field with the rows of the launch side by side (element e of row r at
// e * R + r), so a warp, whose rows walk the same nodes, reads and writes
// consecutive words.  A tree's phi is kept apart (nf + 1 f64 a row) and
// added into the row's output after the tree; no atomics.
//
// Bound: f64 operations, about the sum over the leaves of the unique depth
// squared, per row and tree (the unwound sums of each leaf), against the
// bytes of the rows, the nodes and the output; the path scratch (28 bytes
// an element) comes from L2 and device memory.  The control flow is the
// same for every row but for the one_fraction != 0 branches of the unwind
// and the unwound sums, so a warp stays mostly converged.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr double kZeroThreshold = 1e-35;
// per-tree metadata: node offset, leaf offset, cat_boundaries offset,
// cat_threshold offset, leaves, class
constexpr int kMeta = 6;

struct Forest {
  const int* split_feature;
  const double* threshold;
  const int* decision_type;
  const int* left;
  const int* right;
  const double* internal_count;
  const double* leaf_value;
  const double* leaf_count;
  const int* cat_boundaries;
  const unsigned* cat_threshold;
  const int* meta;
  const double* ev;
  int trees;
  int k;
  int nf;
};

// the row's scratch: arrays of R (the launch's rows) entries an element
struct Scratch {
  double* pweight;   // [P, R]
  double* one;       // [P, R]
  double* zero;      // [P, R]
  double* phi;       // [nf + 1, R]
  double* fzero;     // [S, R] the frames' incoming fractions
  double* fone;      // [S, R]
  int* feature;      // [P, R]
  int* fnode;        // [S, R] the frames' node, depth, unique depth, feature
  int* fdepth;
  int* fud;
  int* ffeat;
};

__host__ __device__ inline long long path_elements(int max_depth) {
  return (long long)(max_depth + 1) * (max_depth + 2) / 2;
}

__host__ __device__ inline int stack_frames(int max_depth) {
  return max_depth + 2;
}

// Tree::_decide of the host walk (models/tree.py) for one row's value
__device__ bool goes_left(double fv, int dt, double thr,
                          const int* cat_boundaries,
                          const unsigned* cat_threshold) {
  if (dt & 1) {
    const int cat = (int)thr;
    const int lo = cat_boundaries[cat];
    const int nw = cat_boundaries[cat + 1] - lo;
    if (!(isfinite(fv) && fv > -1.0 && fv < (double)nw * 32.0)) return false;
    const int iv = (int)fv;
    return (cat_threshold[lo + iv / 32] >> (iv % 32)) & 1u;
  }
  const int missing_type = (dt >> 2) & 3;
  const bool default_left = (dt & 2) != 0;
  const bool isnan_ = isnan(fv);
  const double v = (isnan_ && missing_type != 2) ? 0.0 : fv;
  bool is_default = false;
  if (missing_type == 1) is_default = fabs(v) <= kZeroThreshold;
  else if (missing_type == 2) is_default = isnan_;
  return is_default ? default_left : (v <= thr);
}

__global__ void __launch_bounds__(kThreads)
tree_shap_kernel(const double* __restrict__ x, int n, int ld, Forest f,
                 Scratch s, int R, double* __restrict__ out, double denom,
                 int average) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
#define EL(arr, e) (arr)[(size_t)(e) * R + r]
  const double* xr = x + (size_t)r * ld;
  const int width = f.k * (f.nf + 1);
  double* orow = out + (size_t)r * width;
  for (int j = 0; j < width; ++j) orow[j] = 0.0;
  for (int t = 0; t < f.trees; ++t) {
    const int* m = f.meta + (size_t)t * kMeta;
    const int node_off = m[0], leaf_off = m[1];
    const int* catb = f.cat_boundaries + m[2];
    const unsigned* catt = f.cat_threshold + m[3];
    double* oc = orow + (size_t)m[5] * (f.nf + 1);
    oc[f.nf] += f.ev[t];
    if (m[4] <= 1) continue;
    for (int q = 0; q <= f.nf; ++q) EL(s.phi, q) = 0.0;
    int sp = 0;
    EL(s.fnode, 0) = 0;
    EL(s.fdepth, 0) = 0;
    EL(s.fud, 0) = 0;
    EL(s.ffeat, 0) = -1;
    EL(s.fzero, 0) = 1.0;
    EL(s.fone, 0) = 1.0;
    sp = 1;
    while (sp > 0) {
      --sp;
      const int node = EL(s.fnode, sp);
      const int d = EL(s.fdepth, sp);
      int ud = EL(s.fud, sp);
      const int pf = EL(s.ffeat, sp);
      const double pz = EL(s.fzero, sp);
      const double po = EL(s.fone, sp);
      const long long seg = (long long)d * (d + 1) / 2;
      if (d > 0) {
        const long long par = (long long)(d - 1) * d / 2;
        for (int i = 0; i < ud; ++i) {
          EL(s.pweight, seg + i) = EL(s.pweight, par + i);
          EL(s.one, seg + i) = EL(s.one, par + i);
          EL(s.zero, seg + i) = EL(s.zero, par + i);
          EL(s.feature, seg + i) = EL(s.feature, par + i);
        }
      }
      // extend the path (the JAX _extend_path)
      EL(s.feature, seg + ud) = pf;
      EL(s.zero, seg + ud) = pz;
      EL(s.one, seg + ud) = po;
      EL(s.pweight, seg + ud) = ud == 0 ? 1.0 : 0.0;
      for (int i = ud - 1; i >= 0; --i) {
        const double w = EL(s.pweight, seg + i);
        EL(s.pweight, seg + i + 1) = EL(s.pweight, seg + i + 1)
            + ((po * w) * (double)(i + 1)) / (double)(ud + 1);
        EL(s.pweight, seg + i) = ((pz * w) * (double)(ud - i))
            / (double)(ud + 1);
      }
      if (node < 0) {
        // a leaf: every path element's unwound sum (_unwound_path_sum)
        const double lv = f.leaf_value[leaf_off + ~node];
        const double top = EL(s.pweight, seg + ud);
        for (int p = 1; p <= ud; ++p) {
          const double o = EL(s.one, seg + p);
          const double z = EL(s.zero, seg + p);
          double nop = top;
          double total = 0.0;
          for (int i = ud - 1; i >= 0; --i) {
            const double w = EL(s.pweight, seg + i);
            const double frac = (double)(ud - i) / (double)(ud + 1);
            if (o != 0.0) {
              const double tmp = (nop * (double)(ud + 1))
                  / ((double)(i + 1) * o);
              total = total + tmp;
              nop = w - ((tmp * z) * frac);
            } else {
              total = total + ((w / z) / frac);
            }
          }
          const int fi = EL(s.feature, seg + p);
          EL(s.phi, fi) = EL(s.phi, fi) + (total * (o - z)) * lv;
        }
        continue;
      }
      const int g = node_off + node;
      const int feat = f.split_feature[g];
      const int lc = f.left[g], rc = f.right[g];
      const bool left = goes_left(xr[feat], f.decision_type[g],
                                  f.threshold[g], catb, catt);
      const double w = f.internal_count[g];
      const double cl = lc >= 0 ? f.internal_count[node_off + lc]
                                : f.leaf_count[leaf_off + ~lc];
      const double cr = rc >= 0 ? f.internal_count[node_off + rc]
                                : f.leaf_count[leaf_off + ~rc];
      const double zl = w > 0 ? cl / w : 0.0;
      const double zr = w > 0 ? cr / w : 0.0;
      double inc_z = 1.0, inc_o = 1.0;
      int pi = 0;
      while (pi <= ud && EL(s.feature, seg + pi) != feat) ++pi;
      if (pi != ud + 1) {
        // undo the feature's earlier split (the JAX _unwind_path)
        inc_z = EL(s.zero, seg + pi);
        inc_o = EL(s.one, seg + pi);
        double nop = EL(s.pweight, seg + ud);
        for (int i = ud - 1; i >= 0; --i) {
          if (inc_o != 0.0) {
            const double tmp = EL(s.pweight, seg + i);
            const double nw = (nop * (double)(ud + 1))
                / ((double)(i + 1) * inc_o);
            EL(s.pweight, seg + i) = nw;
            nop = tmp - (((nw * inc_z) * (double)(ud - i))
                         / (double)(ud + 1));
          } else {
            EL(s.pweight, seg + i) = (EL(s.pweight, seg + i)
                                      * (double)(ud + 1))
                / (inc_z * (double)(ud - i));
          }
        }
        for (int i = pi; i < ud; ++i) {
          EL(s.feature, seg + i) = EL(s.feature, seg + i + 1);
          EL(s.zero, seg + i) = EL(s.zero, seg + i + 1);
          EL(s.one, seg + i) = EL(s.one, seg + i + 1);
        }
        --ud;
      }
      // right first: the left child is walked first
      EL(s.fnode, sp) = rc;
      EL(s.fdepth, sp) = d + 1;
      EL(s.fud, sp) = ud + 1;
      EL(s.ffeat, sp) = feat;
      EL(s.fzero, sp) = zr * inc_z;
      EL(s.fone, sp) = left ? 0.0 : inc_o;
      ++sp;
      EL(s.fnode, sp) = lc;
      EL(s.fdepth, sp) = d + 1;
      EL(s.fud, sp) = ud + 1;
      EL(s.ffeat, sp) = feat;
      EL(s.fzero, sp) = zl * inc_z;
      EL(s.fone, sp) = left ? inc_o : 0.0;
      ++sp;
    }
    for (int q = 0; q < f.nf; ++q) oc[q] = oc[q] + EL(s.phi, q);
  }
  if (average) {
    for (int j = 0; j < width; ++j) orow[j] = orow[j] / denom;
  }
#undef EL
}

}  // namespace

extern "C" {

// bytes of scratch a row: the path elements (three f64 and an i32), the
// stack's frames (two f64, four i32) and the tree's phi
long long tree_shap_row_bytes(int max_depth, int nf) {
  return path_elements(max_depth) * 28 + (long long)stack_frames(max_depth)
      * 32 + (long long)(nf + 1) * 8;
}

int tree_shap_threads() { return kThreads; }

// rows [0, n) of x (f64, row stride ld) against the forest; scratch holds
// tree_shap_row_bytes(max_depth, nf) bytes for each of R >= n rows
int tree_shap(const double* x, int n, int ld, const int* split_feature,
              const double* threshold, const int* decision_type,
              const int* left, const int* right,
              const double* internal_count, const double* leaf_value,
              const double* leaf_count, const int* cat_boundaries,
              const unsigned* cat_threshold, const int* meta,
              const double* ev, int trees, int k, int nf, void* scratch,
              int R, int max_depth, double* out, double denom, int average,
              void* stream) {
  if (n <= 0) return 0;
  if (R < n || max_depth < 0 || k < 1 || nf < 0) return cudaErrorInvalidValue;
  Forest f{split_feature, threshold,  decision_type, left, right,
           internal_count, leaf_value, leaf_count, cat_boundaries,
           cat_threshold, meta, ev, trees, k, nf};
  const long long P = path_elements(max_depth);
  const long long S = stack_frames(max_depth);
  Scratch s;
  double* d = static_cast<double*>(scratch);
  s.pweight = d;
  s.one = s.pweight + P * R;
  s.zero = s.one + P * R;
  s.phi = s.zero + P * R;
  s.fzero = s.phi + (long long)(nf + 1) * R;
  s.fone = s.fzero + S * R;
  int* i = reinterpret_cast<int*>(s.fone + S * R);
  s.feature = i;
  s.fnode = s.feature + P * R;
  s.fdepth = s.fnode + S * R;
  s.fud = s.fdepth + S * R;
  s.ffeat = s.fud + S * R;
  const int blocks = (n + kThreads - 1) / kThreads;
  tree_shap_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, n, ld, f, s, R, out, denom, average);
  return (int)cudaGetLastError();
}

}  // extern "C"
