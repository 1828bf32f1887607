// Two-sided partition of one leaf segment of the row matrix, and the
// copyback of the partitioned span.
//
// partition_scan replaces lightgbm_tpu/ops/pallas/partition_kernel2.py
// make_partition_ss (with partition_kernel3.make_partition_perm's
// packing; pallas_call at partition_kernel2.py:377), and with membership
// words its sorted-subset modes partition_ss_permute_cat /
// partition_ss_matmul_cat (partition_kernel3.py:689,
// partition_kernel2.py:429): the rows of the segment [s0, s0 + cnt) are
// split by the go-left predicate of partition_kernel._go_left (numerical
// bin <= sbin, the NaN bin routed by default_left, categorical bin ==
// sbin, or the bin's bit of the descriptor's membership words where it
// carries them: part::pred_left), and written to scratch
// as the left rows in their original order followed by the right rows in
// REVERSED original order -- the layout the compiled TPU kernel leaves
// (its per-block right packing is reversed and written downward).  nleft
// goes to a device scalar.
//
// partition_copyback replaces partition_kernel2.copyback_call
// (pallas_call at :325): it moves the span [s0, s0 + cnt) of every
// column from scratch back into the row matrix and touches no row
// outside it.
//
// partition_scan_p2 replaces partition_kernel3.make_partition_p2
// (_scan_kernel_p2, pallas_call at :633; with words partition_p2_cat,
// :710), the scan at pack=2: the same
// kernel over records (partition_common.cuh RecPtr), instantiated from
// the same template, so the left rows, the reversed right rows and nleft
// are partition_scan's.  The TPU kernel's parity carries (two rows share
// a 128-lane line, partition_kernel3.py:340-500) have no counterpart: a
// record is whole 16-byte words at any row index.
//
// partition_copyback_p2 replaces partition_kernel3.copyback_call_p2
// (_copyback_kernel_p2, pallas_call at :562), the copyback at pack=2:
// records [s0, s0 + cnt) (partition_common.cuh RecPtr), cnt * S
// contiguous bytes.  Every record is whole 16-byte words at any row
// index, so an odd s0 or cnt needs no parity handling, and the span is
// one contiguous range of words: copy_records moves it with four words
// in flight a thread (the grid-stride loop it replaces had one load ->
// store dependency a thread at a time).  A ring of TMA bulk copies
// through shared memory was timed against it on the card: about as fast
// at 1M records and slower on the small segments most splits move
// (PERF.md), so it was not kept.
//
// Rows: bins u8 [n, F], vals f32 [n, 3] (g*w, h*w, w), rid i32 [n]
// (original row ids), score f32 [n] and consts f32 [n, 2] (the stream
// route's per-row score and objective constants, which move with their
// row on every route).  Scratch has the same five arrays.
//
// Design of the scan (partition_scan.cuh scan_tiles): one launch after
// a memset of its look-back state, a block a tile of rows staged in
// shared memory by cp.async (the bins or records read from global memory
// where the rows are too wide to stage), the tiles' left counts chained
// by a decoupled look-back, and each tile's left and right runs written
// as consecutive words.  The design it replaces
// counted the tiles in one launch, then re-summed every earlier tile's
// count in each block of a second launch and moved each thread's four
// rows one after another, a word at a time (PERF.md).
//
// Bound on this card: bytes.  The scan reads each row of the segment
// once and moves it (F + 28 bytes, at pack=2 S) once into scratch; the
// copyback moves cnt * (F + 28) bytes back, at pack=2 cnt * S.
#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_scan.cuh"

namespace {

using part::RowPtrs;

// copyback_p2: words [0, nw) of src to dst (uint4, both 16-byte
// aligned), grid-stride; a thread loads four words a block-width apart,
// then stores them, so four loads are in flight a thread and a block
// moves 16 KiB a step (256 threads x 4 x 16 bytes).
constexpr int kCopyThreads = 256;
constexpr int kCopyWords = 4;
constexpr int kCopyBlocks = 132 * 8;   // eight blocks an SM of the H100

__global__ void __launch_bounds__(kCopyThreads)
copy_records(const uint4* __restrict__ src, uint4* __restrict__ dst,
             long long nw) {
  const long long step = (long long)gridDim.x * kCopyThreads;
  for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
       i < nw; i += kCopyWords * step) {
    uint4 w[kCopyWords];
#pragma unroll
    for (int k = 0; k < kCopyWords; ++k)
      if (i + k * step < nw) w[k] = src[i + k * step];
#pragma unroll
    for (int k = 0; k < kCopyWords; ++k)
      if (i + k * step < nw) dst[i + k * step] = w[k];
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of a scan block of T rows of F features (pack=1)
// or of T records of S bytes (pack=2), staged or not.
int partition_scan_smem_bytes(int T, int F, int staged) {
  return part::scan_smem(T, F, staged != 0);
}
int partition_scan_p2_smem_bytes(int T, int S, int staged) {
  return part::scan_smem_rec(T, S, staged != 0);
}

// Partition scan of [s0, s0 + cnt) into scratch in tiles of T rows,
// the bins staged in shared memory or not; state is the look-back state
// (1 + ceil(cnt / T) 64-bit words, zeroed here on the stream), nleft an
// int32 device scalar, words nwords (<= 8) host membership words (read
// by categorical splits; may be null when nwords is 0).  cnt must be >
// 0.  Returns the CUDA error code (0 on success), cudaErrorInvalidValue
// for nwords > 8.
int partition_scan(uint8_t* bins, float* vals, int* rid, float* score,
                   float* consts, uint8_t* sbins, float* svals, int* srid,
                   float* sscore, float* sconsts, unsigned long long* state,
                   int* nleft, int F, int s0, int cnt, int feat, int sbin,
                   int dl, int cat, int nanb, int nwords,
                   const unsigned* words, int T, int staged, void* stream) {
  part::Pred p;
  if (!part::make_pred(part::Split{s0, cnt, feat, sbin, dl, cat, nanb},
                       nwords, words, &p))
    return (int)cudaErrorInvalidValue;
  return part::scan_launch(RowPtrs{bins, vals, rid, score, consts},
                           RowPtrs{sbins, svals, srid, sscore, sconsts}, F,
                           p, T, staged, state, nleft,
                           static_cast<cudaStream_t>(stream));
}

// The same over records: base and sbase u8 [n, S] (16-byte aligned),
// vals at byte Fb.  cnt must be > 0.
int partition_scan_p2(uint8_t* base, uint8_t* sbase, int S, int Fb,
                      unsigned long long* state, int* nleft, int s0, int cnt,
                      int feat, int sbin, int dl, int cat, int nanb,
                      int nwords, const unsigned* words, int T, int staged,
                      void* stream) {
  part::Pred p;
  if (S % 16
      || !part::make_pred(part::Split{s0, cnt, feat, sbin, dl, cat, nanb},
                          nwords, words, &p))
    return (int)cudaErrorInvalidValue;
  // a record's bin stride and copy are its own: F is not read
  return part::scan_launch(part::RecPtr{base, S, Fb},
                           part::RecPtr{sbase, S, Fb}, 0, p, T, staged, state,
                           nleft, static_cast<cudaStream_t>(stream));
}

// Copy rows [s0, s0 + cnt) of every column from scratch back.
int partition_copyback(uint8_t* bins, float* vals, int* rid, float* score,
                       float* consts, uint8_t* sbins, float* svals,
                       int* srid, float* sscore, float* sconsts, int F,
                       int s0, int cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowPtrs rows{bins, vals, rid, score, consts};
  const RowPtrs scr{sbins, svals, srid, sscore, sconsts};
  part::copy_span<<<part::copy_span_blocks(cnt, F), 256, 0, s>>>(
      rows, scr, F, s0, cnt);
  return (int)cudaGetLastError();
}

// Copy records [s0, s0 + cnt) from sbase back to base (both u8 [n, S],
// 16-byte aligned): cnt * S / 16 words, eight blocks an SM at most.
int partition_copyback_p2(uint8_t* base, uint8_t* sbase, int S, int s0,
                          int cnt, void* stream) {
  const long long w0 = (long long)s0 * S / 16, nw = (long long)cnt * S / 16;
  long long blocks = (nw + kCopyThreads * kCopyWords - 1)
                     / (kCopyThreads * kCopyWords);
  if (blocks > kCopyBlocks) blocks = kCopyBlocks;
  copy_records<<<(int)blocks, kCopyThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(sbase) + w0,
      reinterpret_cast<uint4*>(base) + w0, nw);
  return (int)cudaGetLastError();
}

}  // extern "C"
