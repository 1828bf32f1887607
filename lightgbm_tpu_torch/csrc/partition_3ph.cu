// The 3-phase partition of one leaf segment of the row matrix, in place.
//
// partition_3ph replaces lightgbm_tpu/ops/pallas/partition_kernel.py
// make_partition (_partition_kernel, _go_left, _member_bit; pallas_call at
// partition_kernel.py:329), the kernel behind LGBM_TPU_PART=3ph, and
// with membership words its sorted-subset mode partition_3ph_cat
// (partition_kernel.py:372).  The
// rows of the segment [s0, s0 + cnt) are split by the go-left predicate
// of _go_left -- numerical bin <= sbin with the NaN bin routed by
// default_left; a categorical split one-hot (bin == sbin) or, when the
// descriptor carries W <= 8 membership words, bit (bin % 32) of word
// (bin / 32) -- and the segment is left holding the left rows in their
// original order followed by the right rows in their ASCENDING original
// order (the TPU kernel's phase 0 and phase 1 both write upward,
// partition_kernel.py:35-37), every column moving with its row.  nleft
// goes to a device scalar.  No row outside the segment is touched.
//
// Exactness: the compiled TPU kernel compacts rows with bf16 one-hot
// matmuls on its MXU and so rounds the f32 value columns to bf16 on every
// move (partition_kernel.py:17-25); that is a TPU artifact.  The JAX
// package's interpret emulation (:289-326), which the port is held
// against, moves rows exactly, and so does this kernel: bytes are copied.
//
// Rows: bins u8 [n, F], vals f32 [n, 3] (g*w, h*w, w), rid i32 [n], score
// f32 [n], consts f32 [n, 2]; scratch has the same five arrays.
//
// Design: two launches on one stream, after the scan's memset.  (1) The
// scan of partition_scan.cuh (scan_tiles, partition_scan's kernel) with
// the membership words in its predicate writes the segment to scratch as
// the left rows in order, then the right rows reversed, and nleft.  (2)
// copyback_3ph reads nleft on the device and moves the span back: the
// left rows as they are, the right rows reversed into ascending order.
// Both write the same bytes on every launch.  The design it replaces
// took three launches (count, scatter re-summing every tile's count,
// copy) and moved each row in a chain of word loads (PERF.md).
//
// Bound on this card: bytes.  An in-place stable partition reads each
// row (F + 28 bytes) once and writes it once; this design's trip through
// scratch and back moves each twice each way.
#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_scan.cuh"

namespace {

using part::RowPtrs;

constexpr int kBackThreads = 256;
constexpr int kBackRows = 128;    // rows a copyback block moves
constexpr int kBackWords = 4;     // loads in flight a thread

// Rows [p0, p0 + rows) of the span, wpr words a row: dst row s0 + q
// takes src row s0 + q for q < nl (the left run), else s0 + cnt - 1 - q
// + nl (the right run reversed).  Consecutive threads take consecutive
// words; each thread issues kBackWords loads before its stores.
template <class W>
__device__ __forceinline__ void move_back(const W* __restrict__ src,
                                          W* __restrict__ dst, int wpr,
                                          long long s0, int p0, int rows,
                                          int cnt, int nl) {
  const int total = rows * wpr;
  int p = (int)threadIdx.x / wpr;
  int k = (int)threadIdx.x - p * wpr;
  const int dq = kBackThreads / wpr, dr = kBackThreads - dq * wpr;
  for (int i = threadIdx.x; i < total; i += kBackWords * kBackThreads) {
    W v[kBackWords];
    long long d[kBackWords];
#pragma unroll
    for (int u = 0; u < kBackWords; ++u) {
      if (i + u * kBackThreads < total) {
        const int q = p0 + p;
        const int from = q < nl ? q : cnt - 1 - q + nl;
        v[u] = src[(s0 + from) * wpr + k];
        d[u] = (s0 + q) * wpr + k;
      }
      k += dr;
      p += dq;
      if (k >= wpr) {
        k -= wpr;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kBackWords; ++u)
      if (i + u * kBackThreads < total) dst[d[u]] = v[u];
  }
}

__global__ void __launch_bounds__(kBackThreads)
copyback_3ph(RowPtrs rows, RowPtrs scr, int F, int s0, int cnt,
             const int* __restrict__ nleft) {
  const int nl = *nleft;
  const int p0 = blockIdx.x * kBackRows;
  const int m = min(kBackRows, cnt - p0);
  if ((F & 3) == 0)
    move_back(reinterpret_cast<const uint32_t*>(scr.bins),
              reinterpret_cast<uint32_t*>(rows.bins), F / 4, s0, p0, m, cnt,
              nl);
  else
    move_back<uint8_t>(scr.bins, rows.bins, F, s0, p0, m, cnt, nl);
  move_back(reinterpret_cast<const uint32_t*>(scr.vals),
            reinterpret_cast<uint32_t*>(rows.vals), 3, s0, p0, m, cnt, nl);
  move_back(reinterpret_cast<const uint32_t*>(scr.rid),
            reinterpret_cast<uint32_t*>(rows.rid), 1, s0, p0, m, cnt, nl);
  move_back(reinterpret_cast<const uint32_t*>(scr.score),
            reinterpret_cast<uint32_t*>(rows.score), 1, s0, p0, m, cnt, nl);
  move_back(reinterpret_cast<const uint32_t*>(scr.consts),
            reinterpret_cast<uint32_t*>(rows.consts), 2, s0, p0, m, cnt, nl);
}

}  // namespace

extern "C" {

// Shared-memory bytes of a scan block of T rows of F features, staged
// or not.
int partition_3ph_smem_bytes(int T, int F, int staged) {
  return part::scan_smem(T, F, staged != 0);
}

// The 3-phase partition of [s0, s0 + cnt) in place, through scratch, in
// tiles of T rows, the bins staged or not.  state is the look-back state
// (1 + ceil(cnt / T) 64-bit words, zeroed here on the stream), nleft an
// int32 device scalar, words nwords (<= 8) host membership words (may be
// null when nwords is 0).  cnt must be > 0.  Returns the CUDA error code
// (0 on success), or cudaErrorInvalidValue for nwords > 8.
int partition_3ph(uint8_t* bins, float* vals, int* rid, float* score,
                  float* consts, uint8_t* sbins, float* svals, int* srid,
                  float* sscore, float* sconsts, unsigned long long* state,
                  int* nleft, int F, int s0, int cnt, int feat, int sbin,
                  int dl, int cat, int nanb, int nwords,
                  const unsigned* words, int T, int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  part::Pred p;
  if (!part::make_pred(part::Split{s0, cnt, feat, sbin, dl, cat, nanb},
                       nwords, words, &p))
    return (int)cudaErrorInvalidValue;
  const RowPtrs rows{bins, vals, rid, score, consts};
  const RowPtrs scr{sbins, svals, srid, sscore, sconsts};
  const int e = part::scan_launch(rows, scr, F, p, T, staged, state, nleft,
                                  s);
  if (e != 0) return e;
  copyback_3ph<<<(cnt + kBackRows - 1) / kBackRows, kBackThreads, 0, s>>>(
      rows, scr, F, s0, cnt, nleft);
  return (int)cudaGetLastError();
}

}  // extern "C"
