// The partition scan of one leaf segment in one launch, shared by
// partition.cu (partition_scan, both packs) and partition_3ph.cu.
//
// The rows of the segment [s0, s0 + cnt) go to scratch as the left rows
// in their original order, then the right rows in REVERSED original
// order (partition_scan's layout), and nleft to a device scalar.  Each
// block owns a tile of T consecutive rows (T a multiple of 32, at most
// 1,024; the wrapper's ops/partition_kernel.scan_geometry picks it):
//
// 1. It takes its tile's index from an atomic ticket, so every tile
//    before its own belongs to a block that has started.
// 2. It starts cp.async copies of its tile's rows into shared memory: in
//    each of the five arrays (pack=1) or in the record buffer (pack=2)
//    a tile is one contiguous byte range, copied as 16-byte chunks from
//    the 16-byte boundary at or below its first byte.  Where no tile of
//    32 rows or more with its bins staged fits the wrapper's budget (the
//    wide rows of many features), the kernel is instantiated unstaged
//    (kStaged false): the bins (pack=1, the values still staged) or the
//    whole records (pack=2) are read from global memory in step 5, four
//    words in flight a thread, so any feature count fits a block.
// 3. While they fly, it ranks the tile's rows: one ballot a 32-row group
//    of the split column, the groups' left counts scanned by one warp.
// 4. Decoupled look-back: it publishes its tile's left count (flag
//    kAgg), then warp 0 reads the status words of the 32 tiles before
//    it at once, adding counts back to the nearest inclusive prefix
//    (flag kPrefix), and publishes its own inclusive prefix.  The left
//    rows before the tile follow; the last tile writes nleft.
// 5. It waits for its copies and writes the tile's left run (ascending
//    from s0 + left_before) and right run (the rows whose destinations
//    descend from s0 + cnt - 1 - right_before, written as one ascending
//    range) from shared memory: consecutive threads store consecutive
//    4-byte words (16-byte words at pack=2; bytes for bins of F % 4 !=
//    0 features), so each warp's stores are coalesced.
//
// The ticket and the status words are a state the wrapper allocates for
// each call on the caller's stream; scan_launch zeroes it there with a
// cudaMemsetAsync before the kernel, so calls on different streams
// never share it and a CUDA graph captures the memset with the kernel.
// The counts depend on the data only, so every launch writes the same
// bytes, whatever the order the blocks run in.
//
// Bound on this card: bytes.  The scan reads each row of the segment
// once and writes it once (cnt * (F + 28) bytes each way at pack=1,
// cnt * S at pack=2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_common.cuh"

namespace part {
// Internal linkage: partition.cu and partition_3ph.cu build into
// libraries loaded in one process, and a template's static local
// (scan_launch's opt-in record) would otherwise be one object shared by
// both (a unique symbol), leaving the second library's kernel without
// its shared-memory opt-in.
namespace {

constexpr int kScanThreads = 256;
constexpr int kScanMaxTile = 1024;    // 32 ballot groups at most
constexpr int kDirectWords = 4;       // global loads in flight (unstaged)
// status word flags (the count is the low 32 bits)
constexpr unsigned long long kAgg = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// Shared bytes staging n bytes from any 4-byte-aligned address: a head
// of up to 15 bytes, whole 16-byte chunks.
__host__ __device__ inline int stage_bytes(long long n) {
  return (int)((n + 16 + 15) / 16 * 16);
}
// A block's dynamic shared memory: a tile of T rows (pack=1: the bins
// of F features when staged, then the four value arrays), or of T
// records of S bytes (none unstaged).
__host__ __device__ inline int bins_bytes(int T, int F, bool staged) {
  return staged ? stage_bytes((long long)T * F) : 0;
}
__host__ __device__ inline int scan_smem(int T, int F, bool staged) {
  return bins_bytes(T, F, staged) + stage_bytes(12LL * T)
         + 2 * stage_bytes(4LL * T) + stage_bytes(8LL * T);
}
__host__ __device__ inline int scan_smem_rec(int T, int S, bool staged) {
  return staged ? stage_bytes((long long)T * S) : 0;
}
__host__ __device__ inline int smem_of(const RowPtrs&, int T, int F,
                                       bool staged) {
  return scan_smem(T, F, staged);
}
__host__ __device__ inline int smem_of(const RecPtr& r, int T, int,
                                       bool staged) {
  return scan_smem_rec(T, r.S, staged);
}

__device__ __forceinline__ void scan_cp_async16(void* smem, const void* gmem,
                                                int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void scan_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void scan_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Bytes [a, a + n) into shared memory s as 16-byte chunks from the
// 16-byte boundary at or below a (the last chunk reads only up to a +
// n); byte a lands at s + (a % 16).  Every thread of the block issues.
__device__ __forceinline__ void stage_span(const uint8_t* a, long long n,
                                           uint8_t* s) {
  const int head = (int)(reinterpret_cast<uintptr_t>(a) & 15);
  const uint8_t* a0 = a - head;
  const long long total = n + head;
  for (long long c = threadIdx.x; 16 * c < total; c += kScanThreads) {
    const long long left = total - 16 * c;
    scan_cp_async16(s + 16 * c, a0 + 16 * c, left < 16 ? (int)left : 16);
  }
}

// The staged tile: where each array's first row lies in shared memory.
struct TileRows {
  const uint8_t* bins;
  const uint32_t* vals;
  const uint32_t* rid;
  const uint32_t* score;
  const uint32_t* consts;
};
struct TileRecs {
  const uint4* rec;
};

__device__ __forceinline__ const uint8_t* head_of(const uint8_t* s,
                                                  const void* a) {
  return s + (reinterpret_cast<uintptr_t>(a) & 15);
}

// Start the copies of rows [r, r + m) of every array into stage, laid
// out as scan_smem(T, F, staged) says (unstaged: the bins are left in
// global memory).
__device__ __forceinline__ void stage_tile(const RowPtrs& rows, int F,
                                           bool staged, long long r, int m,
                                           int T, uint8_t* stage) {
  const int o_vals = bins_bytes(T, F, staged);
  const int o_rid = o_vals + stage_bytes(12LL * T);
  const int o_score = o_rid + stage_bytes(4LL * T);
  const int o_consts = o_score + stage_bytes(4LL * T);
  if (staged) stage_span(rows.bins + r * F, (long long)m * F, stage);
  stage_span(reinterpret_cast<const uint8_t*>(rows.vals + r * 3), 12LL * m,
             stage + o_vals);
  stage_span(reinterpret_cast<const uint8_t*>(rows.rid + r), 4LL * m,
             stage + o_rid);
  stage_span(reinterpret_cast<const uint8_t*>(rows.score + r), 4LL * m,
             stage + o_score);
  stage_span(reinterpret_cast<const uint8_t*>(rows.consts + r * 2), 8LL * m,
             stage + o_consts);
}
__device__ __forceinline__ void stage_tile(const RecPtr& rows, int,
                                           bool staged, long long r, int m,
                                           int, uint8_t* stage) {
  if (staged) stage_span(rows.base + r * rows.S, (long long)m * rows.S,
                         stage);
}

// Where stage_tile put rows [r, ...) (shared addresses of each array's
// first row; unstaged, the bins' or records' global address).
__device__ __forceinline__ TileRows staged_at(const RowPtrs& rows, int F,
                                              bool staged, long long r,
                                              int T, const uint8_t* s) {
  const int o_vals = bins_bytes(T, F, staged);
  const int o_rid = o_vals + stage_bytes(12LL * T);
  const int o_score = o_rid + stage_bytes(4LL * T);
  const int o_consts = o_score + stage_bytes(4LL * T);
  return TileRows{
      staged ? head_of(s, rows.bins + r * F) : rows.bins + r * F,
      reinterpret_cast<const uint32_t*>(head_of(s + o_vals,
                                                rows.vals + r * 3)),
      reinterpret_cast<const uint32_t*>(head_of(s + o_rid, rows.rid + r)),
      reinterpret_cast<const uint32_t*>(head_of(s + o_score,
                                                rows.score + r)),
      reinterpret_cast<const uint32_t*>(head_of(s + o_consts,
                                                rows.consts + r * 2))};
}
__device__ __forceinline__ TileRecs staged_at(const RecPtr& rows, int,
                                              bool staged, long long r, int,
                                              const uint8_t* s) {
  return TileRecs{reinterpret_cast<const uint4*>(
      staged ? s : rows.base + r * rows.S)};
}

// Rows [0, m) of the tile's output, wpr words a row: row p < nl (the
// left run) to dst row L0 + p, row p >= nl (the right run) to R0 + p -
// nl; its words come from source row perm[p].  Consecutive threads
// take consecutive words; each thread issues U loads before their
// stores (U > 1 where the source is global memory).
template <int U, class W>
__device__ __forceinline__ void write_runs(const W* src, W* __restrict__ dst,
                                           int wpr, int m, int nl,
                                           long long L0, long long R0,
                                           const uint16_t* perm) {
  const int total = m * wpr;
  int p = (int)threadIdx.x / wpr;
  int k = (int)threadIdx.x - p * wpr;
  const int dq = kScanThreads / wpr, dr = kScanThreads - dq * wpr;
  for (int i = threadIdx.x; i < total; i += U * kScanThreads) {
    W v[U];
    long long d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * kScanThreads < total) {
        d[u] = (p < nl ? L0 + p : R0 + (p - nl)) * wpr + k;
        v[u] = src[(long long)perm[p] * wpr + k];
      }
      k += dr;
      p += dq;
      if (k >= wpr) {
        k -= wpr;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * kScanThreads < total) dst[d[u]] = v[u];
  }
}

template <bool kStaged>
__device__ __forceinline__ void write_tile(const TileRows& t,
                                           const RowPtrs& scr, int F, int m,
                                           int nl, long long L0,
                                           long long R0,
                                           const uint16_t* perm) {
  constexpr int U = kStaged ? 1 : kDirectWords;
  if ((F & 3) == 0)
    write_runs<U>(reinterpret_cast<const uint32_t*>(t.bins),
                  reinterpret_cast<uint32_t*>(scr.bins), F / 4, m, nl, L0,
                  R0, perm);
  else
    write_runs<U>(t.bins, scr.bins, F, m, nl, L0, R0, perm);
  write_runs<1>(t.vals, reinterpret_cast<uint32_t*>(scr.vals), 3, m, nl, L0,
                R0, perm);
  write_runs<1>(t.rid, reinterpret_cast<uint32_t*>(scr.rid), 1, m, nl, L0,
                R0, perm);
  write_runs<1>(t.score, reinterpret_cast<uint32_t*>(scr.score), 1, m, nl,
                L0, R0, perm);
  write_runs<1>(t.consts, reinterpret_cast<uint32_t*>(scr.consts), 2, m, nl,
                L0, R0, perm);
}
template <bool kStaged>
__device__ __forceinline__ void write_tile(const TileRecs& t,
                                           const RecPtr& scr, int, int m,
                                           int nl, long long L0,
                                           long long R0,
                                           const uint16_t* perm) {
  write_runs<kStaged ? 1 : kDirectWords>(
      t.rec, reinterpret_cast<uint4*>(scr.base), scr.S / 16, m, nl, L0, R0,
      perm);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Left bits of the tile's 32-row group g (rows [r0 + 32 g, ...), m rows
// in the tile), one lane a row.
template <class Rows>
__device__ __forceinline__ unsigned group_bits(const Rows& rows, int F,
                                               const Pred& p, long long r0,
                                               int m, int g) {
  const int i = 32 * g + (int)(threadIdx.x & 31);
  const bool left =
      i < m && pred_left(bin_at(rows, F, r0 + i, p.sp.feat), p);
  return __ballot_sync(0xffffffffu, left);
}

// The state: word 0 holds the ticket (low half), then one status word a
// tile.  Zero on entry.
template <class Rows, bool kStaged>
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(Rows rows, Rows scr, int F, Pred p, int T, int tiles,
           unsigned long long* __restrict__ state, int* __restrict__ nleft) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ uint16_t perm[kScanMaxTile];
  __shared__ unsigned mask[32];
  __shared__ int gpre[32];
  __shared__ int s_tile, s_before, s_nl;
  unsigned long long* status = state + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0)
    s_tile = (int)atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const int t = s_tile;
  const int first = t * T;                      // in the segment
  const int m = min(T, p.sp.cnt - first);
  const long long r0 = (long long)p.sp.s0 + first;
  stage_tile(rows, F, kStaged, r0, m, T, stage);
  scan_cp_commit();

  const int groups = (m + 31) / 32;
  for (int g = warp; g < groups; g += kScanThreads / 32) {
    const unsigned b = group_bits(rows, F, p, r0, m, g);
    if (lane == 0) mask[g] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < groups ? __popc(mask[lane]) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    gpre[lane] = x - c;
    const int nl = __shfl_sync(0xffffffffu, x, 31);
    if (lane == 0)
      atomicExch(status + t, (t == 0 ? kPrefix : kAgg) | (unsigned)nl);
    int before = 0;
    for (int j = t - 1; j >= 0; j -= 32) {
      const int at = j - lane;
      unsigned long long v = kPrefix;
      if (at >= 0) {
        do {
          v = load_status(status + at);
        } while ((v >> 32) == 0);
      }
      const unsigned done = __ballot_sync(0xffffffffu,
                                          (v & kPrefix) != 0);
      const int stop = done ? __ffs(done) - 1 : 31;
      int add = lane <= stop ? (int)(unsigned)v : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        add += __shfl_xor_sync(0xffffffffu, add, o);
      before += add;
      if (done) break;
    }
    if (lane == 0) {
      if (t > 0) atomicExch(status + t, kPrefix | (unsigned)(before + nl));
      if (t == tiles - 1) *nleft = before + nl;
      s_before = before;
      s_nl = nl;
    }
  }
  __syncthreads();
  const int before = s_before, nl = s_nl, nr = m - nl;
  // output position of each row: left rows by rank, right rows reversed
  for (int i = threadIdx.x; i < m; i += kScanThreads) {
    const unsigned b = mask[i / 32], below = b & ((1u << (i % 32)) - 1u);
    const int lr = gpre[i / 32] + __popc(below);
    const int pos = (b >> (i % 32)) & 1u ? lr : nl + nr - 1 - (i - lr);
    perm[pos] = (uint16_t)i;
  }
  scan_cp_wait();
  __syncthreads();
  const long long L0 = (long long)p.sp.s0 + before;
  const long long R0 =
      (long long)p.sp.s0 + p.sp.cnt - (first - before) - nr;
  write_tile<kStaged>(staged_at(rows, F, kStaged, r0, T, stage), scr, F, m,
                      nl, L0, R0, perm);
}

// One instantiation's launch, with its shared-memory opt-in (made once a
// size, per kernel).
template <class Rows, bool kStaged>
int launch_tiles(Rows rows, Rows scr, int F, const Pred& p, int T,
                 int tiles, int smem, unsigned long long* state, int* nleft,
                 cudaStream_t s) {
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_tiles<Rows, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  scan_tiles<Rows, kStaged><<<tiles, kScanThreads, smem, s>>>(
      rows, scr, F, p, T, tiles, state, nleft);
  return (int)cudaGetLastError();
}

// The scan: the state zeroed on s (1 + ceil(cnt / T) 64-bit words, the
// wrapper's), then one launch of T-row tiles (T a multiple of 32, at
// most kScanMaxTile), staged or not.  0 or the CUDA error code; a
// block's shared memory past the card's limit is the opt-in's error.
template <class Rows>
int scan_launch(Rows rows, Rows scr, int F, const Pred& p, int T, int staged,
                unsigned long long* state, int* nleft, cudaStream_t s) {
  if (T < 32 || T > kScanMaxTile || T % 32) return (int)cudaErrorInvalidValue;
  const int tiles = (p.sp.cnt + T - 1) / T;
  const cudaError_t e = cudaMemsetAsync(
      state, 0, sizeof(unsigned long long) * (1 + (size_t)tiles), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = smem_of(rows, T, F, staged != 0);
  return staged ? launch_tiles<Rows, true>(rows, scr, F, p, T, tiles, smem,
                                           state, nleft, s)
                : launch_tiles<Rows, false>(rows, scr, F, p, T, tiles, smem,
                                            state, nleft, s);
}

}  // namespace
}  // namespace part
