// The 3-phase partition of one leaf segment of the row matrix, in place.
//
// partition_3ph replaces lightgbm_tpu/ops/pallas/partition_kernel.py
// make_partition (_partition_kernel, _go_left, _member_bit; pallas_call at
// partition_kernel.py:329), the kernel behind LGBM_TPU_PART=3ph.  The
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
// Design: the TPU kernel's three sequential grid phases (left rows, right
// rows, copyback, with a carry window and full-R flushes for its DMA
// granularity) become three launches on one stream, each parallel over
// tiles of kTile consecutive rows.  (1) Each block counts its tile's left
// rows.  (2) Each block sums the counts of the tiles before its own and
// of the whole segment (nleft), scans the per-thread counts inside the
// block and writes every row to scratch: a left row at s0 + (lefts before
// it), a right row at s0 + nleft + (rights before it); block 0 writes
// nleft.  (3) The span moves back from scratch.  Positions are a function
// of the data only (no atomics), so every launch writes the same bytes.
//
// Bound on this card: bytes.  The split column is read once (cnt bytes,
// strided), each row (F + 28 bytes) is written to scratch and moved back:
// about 2 * 2 * cnt * (F + 28) bytes of traffic for the three launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_common.cuh"

namespace {

using part::kPer;
using part::kThreads;
using part::kTile;
using part::RowPtrs;
using part::Split;

constexpr int kMaxWords = 8;   // layout.CAT_BITSET_WORDS

struct Pred {
  Split sp;
  unsigned words[kMaxWords];
  int nwords;                  // 0: one-hot categorical splits
};

// _go_left with the optional membership words: the words replace
// bin == sbin for categorical splits only
__device__ __forceinline__ bool go_left3(int col, const Pred& p) {
  if (p.sp.cat && p.nwords > 0) {
    const int w = col >> 5;
    return w < p.nwords && ((p.words[w] >> (col & 31)) & 1u) != 0u;
  }
  return part::go_left(col, p.sp);
}

__device__ __forceinline__ int bits3(const uint8_t* bins, int F,
                                     const Pred& p, int tile,
                                     unsigned* bits) {
  return part::thread_bits_by(bins, F, p.sp, tile, bits,
                              [&](int col) { return go_left3(col, p); });
}

__global__ void __launch_bounds__(kThreads)
partition3ph_count(const uint8_t* __restrict__ bins, int F, Pred p,
                   int* __restrict__ tile_left) {
  unsigned bits;
  bits3(bins, F, p, blockIdx.x, &bits);
  int total;
  part::block_exclusive_scan(__popc(bits), &total);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
partition3ph_scatter(RowPtrs rows, RowPtrs scr, int F, Pred p,
                     const int* __restrict__ tile_left,
                     int* __restrict__ nleft) {
  __shared__ int red_before[kThreads];
  __shared__ int red_all[kThreads];
  // left rows of the tiles before this one, and of the whole segment
  int before = 0, all = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const int v = tile_left[b];
    all += v;
    if (b < (int)blockIdx.x) before += v;
  }
  red_before[threadIdx.x] = before;
  red_all[threadIdx.x] = all;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red_before[threadIdx.x] += red_before[threadIdx.x + s];
      red_all[threadIdx.x] += red_all[threadIdx.x + s];
    }
    __syncthreads();
  }
  const int left_before = red_before[0];
  const int total_left = red_all[0];
  const int right_before = blockIdx.x * kTile - left_before;

  const Split& sp = p.sp;
  unsigned bits;
  const int live = bits3(rows.bins, F, p, blockIdx.x, &bits);
  int tile_total;
  const int l_off = part::block_exclusive_scan(__popc(bits), &tile_total);
  // rows of this tile before this thread's first row
  int first_in_tile = threadIdx.x * kPer;
  const int tile_rows = min(kTile, sp.cnt - (int)blockIdx.x * kTile);
  if (first_in_tile > tile_rows) first_in_tile = tile_rows;
  int l_rank = left_before + l_off;
  int r_rank = right_before + (first_in_tile - l_off);
  const int first = blockIdx.x * kTile + threadIdx.x * kPer;
  for (int k = 0; k < live; ++k) {
    const int src = sp.s0 + first + k;
    const int dst = (bits & (1u << k)) ? sp.s0 + l_rank++
                                       : sp.s0 + total_left + r_rank++;
    part::copy_row(rows, scr, F, src, dst);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *nleft = total_left;
}

}  // namespace

extern "C" {

// The 3-phase partition of [s0, s0 + cnt) in place, through scratch.
// tile_left is int32 scratch of at least ceil(cnt / 1024) entries, nleft
// an int32 device scalar, words nwords (<= 8) host membership words (may
// be null when nwords is 0).  cnt must be > 0.  Returns the CUDA error
// code (0 on success), or cudaErrorInvalidValue for nwords > 8.
int partition_3ph(uint8_t* bins, float* vals, int* rid, float* score,
                  float* consts, uint8_t* sbins, float* svals, int* srid,
                  float* sscore, float* sconsts, int* tile_left, int* nleft,
                  int F, int s0, int cnt, int feat, int sbin, int dl,
                  int cat, int nanb, int nwords, const unsigned* words,
                  void* stream) {
  if (nwords < 0 || nwords > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Pred p{};
  p.sp = Split{s0, cnt, feat, sbin, dl, cat, nanb};
  p.nwords = nwords;
  for (int k = 0; k < nwords; ++k) p.words[k] = words[k];
  const RowPtrs rows{bins, vals, rid, score, consts};
  const RowPtrs scr{sbins, svals, srid, sscore, sconsts};
  const int tiles = (cnt + kTile - 1) / kTile;
  partition3ph_count<<<tiles, kThreads, 0, s>>>(bins, F, p, tile_left);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  partition3ph_scatter<<<tiles, kThreads, 0, s>>>(rows, scr, F, p,
                                                  tile_left, nleft);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part::copy_span<<<part::copy_span_blocks(cnt, F), 256, 0, s>>>(
      rows, scr, F, s0, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
