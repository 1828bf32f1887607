// The partition-bisection probes: the port's counterparts of the eight
// Pallas kernels of tools/profile_legacy.py.  All but T8 work on rows f32
// [n_alloc, 128] holding integers in [0, 256) (profile_legacy._rows), with
// the TPU's block of R = 512 rows and the split descriptor sel i32 [8] =
// [s0, cnt, feat, sbin, dl, cat, nanb, 0].  Every row is 512 bytes, 32
// 16-byte words; a warp moves one row, a lane one word.
//
// block_copy<P> replaces _build_part3's copy / copy3 (pallas_call at
// profile_legacy.py:150): scratch[b * 512, (b + 1) * 512) = rows[...] for
// b < nb.  One thread of each block bulk-copies its 256 KiB tile global ->
// shared -> global in four 64 KiB pieces (cp.async.bulk on an mbarrier
// in, a bulk-group store out, waited before the buffer is reused).  P = 3
// (copy3) launches a (nb, 3) grid whose blocks with blockIdx.y != 0 exit
// at once: the TPU's idle grid steps.  Bound: 2 x 512 B a row.
//
// dense_scatter<P> (with dense_left_count, tile_scan and dense_copy_span)
// replaces _build_part3's scan / scan2 (the production _partition_kernel
// with its phases capped at 1 or 2, pallas_call at :172), and with P = 3
// make_partition's three phases (part2, part3 full, part8 real).  The
// go-left predicate reads the f32 column as partition_kernel._go_left
// does (col <= float(sbin), the NaN bin float(nanb) routed by dl > 0, a
// categorical split col == float(sbin)), on rows [s0, s0 + cnt).  As the
// TPU's carry window leaves them: P = 1 writes the left rows to
// scratch[s0, s0 + nleft) and zeros the rest of their last 512-row flush,
// nsplit 0; P = 2 also the right rows to scratch[s0 + nleft, s0 + cnt),
// zeros past s0 + cnt to the end of the later flush, nsplit = nleft; the
// third phase (P = 2, then dense_copy_span) copies scratch[s0, s0 + cnt)
// back into rows.  The passes: each
// 128-row tile counts its left rows, one block scans the counts, each
// tile scatters its rows to their ranks, (P = 3) a grid-stride copy back.
// Bound: the column read once is 4 B a row (one 32-byte sector in
// practice); each row read once and written once (P = 1: the left rows).
//
// compact_carry<V> replaces the carry-window compaction of part4 (:369),
// part5 (:467), part6 (:562, :577), part7 (:686) and part8: the kept rows
// of the region [s0, s0 + nblk * 512), in order, written from out[s0] on,
// WHOLE 512-row groups only (the TPU writes only full blocks; the last
// partial group stays as it was), except nsplit, which also flushes the
// partial group zero-filled past T and returns T, the kept count.  Pass 0
// counts each 128-row tile's kept rows, tile_scan gives their prefix and
// T, pass 1 moves them.  In place, a kept row moves down (its destination
// is at or before its source), into a tile another block may not have
// read yet: on the TPU the grid runs in order, here blocks take tiles in
// the order they start (a ticket, atomicAdd), stage their written rows in
// shared memory, publish "tile loaded", and write only once every tile
// their destinations overlap has published.  Tiles before a block's own
// started before it and wait only on tiles before them, so the waits end.
// Whether a row is written depends on T, known before pass 1 from the
// scan.  The mechanisms V (the JAX builder's flags; kernel header below):
//   kNosmem    part4 base, part6/7 nosmem: s0 = 0, col 3 <= 127,
//              compile-time constants, every block of the grid
//   kGrid2     part4 grid2: the same on a (1, tiles) grid
//   kSmemFull  part4 smem: sel read from global memory by each block;
//              s0 and cnt from sel, blocks < ceil(cnt / 512), the full
//              go-left predicate with the valid-row mask; (1, tiles) grid
//   kAlias2    part4 alias2: kSmemFull into scratch (rows unchanged)
//   kNsplit    part4 nsplit: kAlias2 plus the zero-filled flush and T
//   kSelRead   part5 uncond, part6 smem: sel read, the result unused
//   kWhen      part5 when: blocks < ceil(cnt / 512), s0 = 0, no mask
//   kDynoff    part5 dynoff: kWhen with s0 from sel
//   kPred      part5 pred: kSmemFull on a one-dimensional grid
//   kSmemuse   part6 smemuse: sel[1] read into a branch never taken
//   kPrefetch  part6 prefetch: sel passed by value (__grid_constant__)
//   kDeadsel   part7 deadsel: a sel pointer passed and never read
//   kScratchthr part7 scratchthr: 127 written to shared memory by one
//              thread, then a barrier, then read as the threshold
//   kSmemThr   part7 smem: the threshold sel[3] read from global memory
//   kNoalias   part7 noalias: kSmemThr into a separate output tensor
//   kHbmsel    part7 hbmsel: sel brought into shared memory by an
//              asynchronous bulk copy, the threshold sel[3] read there
// Bound: the column read (4 B a row), each written row read and written
// once (512 B each way).
//
// hbm_alias_step replaces hbm_alias's _kernel (pallas_call at :898):
// comb f32 [65536, 128], rows [dst, dst + 1024) = rows [src, src + 1024)
// + 1, every read before any write, so overlapping windows (dst > src, as
// in the while-loop steps, or dst < src) read the old rows.  512 KiB do
// not fit one SM: a cluster of 8 blocks holds 128 rows each in registers
// (512 threads x 8 float4), meets at barrier.cluster, then writes.
// Bound: 512 KiB each way; in practice the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 128;                  // columns of a row
constexpr int kW = kC * 4 / 16;          // 16-byte words a row: 32
constexpr int kR = 512;                  // the TPU's block of rows
constexpr int kTile = 128;               // rows a block of the passes
constexpr int kThreads = kTile;          // one thread a row
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = kTile * kC * 4;        // 64 KiB
constexpr int kPieceBytes = 64 * 1024;
constexpr int kPieces = kR * kC * 4 / kPieceBytes;  // 4
constexpr int kAliasRows = 1024, kAliasCtas = 8, kAliasThreads = 512;
constexpr int kAliasVec = kAliasRows / kAliasCtas * kC / 4 / kAliasThreads;
constexpr int kScanThreads = 1024;

enum Mech {
  kNosmem, kGrid2, kSmemFull, kAlias2, kNsplit, kSelRead, kWhen, kDynoff,
  kPred, kSmemuse, kPrefetch, kDeadsel, kScratchthr, kSmemThr, kNoalias,
  kHbmsel, kMechs
};

__host__ __device__ constexpr bool grid2(int v) {
  return v >= kGrid2 && v <= kNsplit;
}
__host__ __device__ constexpr bool s0_from_sel(int v) {
  return v == kSmemFull || v == kAlias2 || v == kNsplit || v == kDynoff ||
         v == kPred;
}
__host__ __device__ constexpr bool full_pred(int v) {
  return v == kSmemFull || v == kAlias2 || v == kNsplit || v == kPred;
}
__host__ __device__ constexpr bool bound_live(int v) {
  return full_pred(v) || v == kWhen || v == kDynoff;
}
__host__ __device__ constexpr bool in_place(int v) {
  return v != kAlias2 && v != kNsplit && v != kNoalias;
}

struct Sel {
  int s0, cnt, feat, sbin, dl, cat, nanb;
  float thr;
};

struct CParams {
  const float* rows;
  float* out;
  const int* sel;          // device sel i32 [8], or null
  int selv[8];             // kPrefetch: sel by value
  int n_alloc, tiles;      // rows of the matrix, 128-row tiles of the grid
  int pass;                // 0: count, 1: move
  int* tile_cnt;
  int* tile_pre;
  int* total;
  int* ticket;
  int* loaded;
  int* nsplit;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// partition_kernel._go_left on the f32 column
__device__ __forceinline__ bool go_left_f32(float col, const Sel& s) {
  const float sbin = (float)s.sbin;
  const bool at_nan = s.nanb >= 0 && col == (float)s.nanb;
  const bool num = (col <= sbin && !at_nan) || (at_nan && s.dl > 0);
  return s.cat > 0 ? col == sbin : num;
}

// the split column of a row: the TPU's one-hot matvec gives 0 for a
// feature outside [0, 128)
__device__ __forceinline__ float column(const float* rows, long long r,
                                        int feat) {
  return (feat >= 0 && feat < kC) ? rows[r * kC + feat] : 0.f;
}

// exclusive rank of `keep` among the block's threads; *count the total
__device__ __forceinline__ int block_rank(bool keep, int* warp_tot,
                                          int* count) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  int off = 0, tot = 0;
  for (int k = 0; k < kWarps; ++k) {
    off += k < warp ? warp_tot[k] : 0;
    tot += warp_tot[k];
  }
  *count = tot;
  __syncthreads();
  return off + __popc(m & ((1u << lane) - 1u));
}

// rows [lo, hi) of a matrix set to zero by the block
__device__ __forceinline__ void zero_rows(float* m, long long lo,
                                          long long hi) {
  uint4* d = reinterpret_cast<uint4*>(m);
  for (long long i = lo * kW + threadIdx.x; i < hi * kW; i += blockDim.x)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// -- T1 ----------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(32)
block_copy(const float* __restrict__ rows, float* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  if (P == 3 && blockIdx.y != 0) return;
  if (threadIdx.x != 0) return;
  const size_t tile = (size_t)blockIdx.x * kR * kC * 4;
  const char* src = reinterpret_cast<const char*>(rows) + tile;
  char* dst = reinterpret_cast<char*>(scratch) + tile;
  const uint32_t b = smem_addr(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int p = 0; p < kPieces; ++p) {
    uint64_t state;
    uint32_t done = 0;
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                 ::"r"(b), "r"(kPieceBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf)), "l"(src + (size_t)p * kPieceBytes),
        "r"(kPieceBytes), "r"(b) : "memory");
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                 : "=l"(state) : "r"(b) : "memory");
    while (!done)
      asm volatile(
          "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, "
          "[%1], %2; selp.u32 %0, 1, 0, P1; }"
          : "=r"(done) : "r"(b), "r"(p & 1) : "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + (size_t)p * kPieceBytes), "r"(smem_addr(buf)),
                 "r"(kPieceBytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the buffer is read by the store before the next piece lands in it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// -- the passes shared by T2 and T3-T7 ---------------------------------------
// exclusive prefix of cnt[0, tiles) into pre, the sum into *total
__global__ void __launch_bounds__(kScanThreads)
tile_scan(const int* __restrict__ cnt, int* __restrict__ pre,
          int* __restrict__ total, int tiles) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? cnt[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (i < tiles) pre[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// -- T2 ----------------------------------------------------------------------
__device__ __forceinline__ bool dense_left(const float* rows, const Sel& s,
                                           int n_alloc, int p) {
  const long long r = (long long)s.s0 + p;
  return p < s.cnt && r < n_alloc &&
         go_left_f32(column(rows, r, s.feat), s);
}

__global__ void __launch_bounds__(kThreads)
dense_left_count(const float* __restrict__ rows, Sel s, int n_alloc,
                 int* __restrict__ tile_cnt) {
  const int n = __syncthreads_count(
      dense_left(rows, s, n_alloc, blockIdx.x * kTile + threadIdx.x));
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = n;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
dense_scatter(const float* __restrict__ rows, float* __restrict__ scr,
              Sel s, int n_alloc, const int* __restrict__ tile_pre,
              const int* __restrict__ total, int* __restrict__ nsplit) {
  __shared__ int warp_tot[kWarps];
  __shared__ int idx_l[kTile], idx_r[kTile];
  const int t = blockIdx.x, p = t * kTile + threadIdx.x;
  const int nvalid = min(kTile, s.cnt - t * kTile);
  const bool left = dense_left(rows, s, n_alloc, p);
  int nl_tile;
  const int lr = block_rank(left, warp_tot, &nl_tile);
  if (left) idx_l[lr] = threadIdx.x;
  else if (threadIdx.x < nvalid) idx_r[threadIdx.x - lr] = threadIdx.x;
  __syncthreads();
  const int nl = *total, pre = tile_pre[t];
  const long long row0 = (long long)s.s0 + (long long)t * kTile;
  const uint4* src = reinterpret_cast<const uint4*>(rows);
  uint4* dst = reinterpret_cast<uint4*>(scr);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = warp; k < nl_tile; k += kWarps)
    dst[((long long)s.s0 + pre + k) * kW + lane] =
        src[(row0 + idx_l[k]) * kW + lane];
  if (P >= 2) {
    const long long r0 = (long long)s.s0 + nl + (long long)t * kTile - pre;
    for (int k = warp; k < nvalid - nl_tile; k += kWarps)
      dst[(r0 + k) * kW + lane] = src[(row0 + idx_r[k]) * kW + lane];
  }
  if (t != 0) return;
  // the carry window's last flushes: full 512-row writes, zero past the
  // rows they carry
  long long lo, hi;
  if (P == 1) {
    lo = (long long)s.s0 + nl;
    hi = nl % kR ? (long long)s.s0 + (nl / kR + 1) * kR : lo;
  } else {
    const int nr = s.cnt - nl;
    lo = hi = (long long)s.s0 + s.cnt;
    if (nl % kR) hi = max(hi, (long long)s.s0 + (nl / kR + 1) * kR);
    if (nr % kR) hi = max(hi, (long long)s.s0 + nl + (nr / kR + 1) * kR);
  }
  zero_rows(scr, lo, min(hi, (long long)n_alloc));
  if (threadIdx.x == 0) *nsplit = P >= 2 ? nl : 0;
}

// rows [s0, s0 + cnt) of scr back into rows, grid-stride
__global__ void __launch_bounds__(256)
dense_copy_span(float* __restrict__ rows, const float* __restrict__ scr,
                int s0, int cnt) {
  const uint4* s = reinterpret_cast<const uint4*>(scr) + (size_t)s0 * kW;
  uint4* d = reinterpret_cast<uint4*>(rows) + (size_t)s0 * kW;
  const size_t n = (size_t)cnt * kW;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    d[i] = s[i];
}

// -- T3-T7 -------------------------------------------------------------------
// One template for both passes (p.pass): the same scalar delivery, tile
// order and predicate in the count and in the move.
template <int V>
__global__ void __launch_bounds__(kThreads)
compact_carry(const __grid_constant__ CParams p) {
  extern __shared__ __align__(16) uint4 stage[];
  __shared__ int warp_tot[kWarps];
  __shared__ int idx[kTile];
  __shared__ int tile_s;
  __shared__ __align__(16) int sel_s[8];
  __shared__ __align__(8) uint64_t bar;
  __shared__ volatile int sink;
  __shared__ int thr_s;
  Sel s{0, p.tiles * kTile, 3, 127, 0, 0, -1, 127.f};
  int t = grid2(V) ? blockIdx.y : blockIdx.x;
  if constexpr (V == kSelRead) {
    sink = *(volatile const int*)(p.sel + 1);
  } else if constexpr (V == kSmemuse) {
    const int cnt = *(volatile const int*)(p.sel + 1);
    if (t / (kR / kTile) >= (cnt + kR - 1) / kR) sink = sink + 1;
  } else if constexpr (V == kScratchthr) {
    if (threadIdx.x == 0) thr_s = 127;
    __syncthreads();
    s.thr = (float)thr_s;
  } else if constexpr (V == kHbmsel) {
    if (threadIdx.x == 0) {
      const uint32_t b = smem_addr(&bar);
      uint64_t state;
      uint32_t done = 0;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                   ::"r"(b), "r"(32) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(sel_s)), "l"(p.sel), "r"(32), "r"(b) : "memory");
      asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                   : "=l"(state) : "r"(b) : "memory");
      while (!done)
        asm volatile(
            "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, "
            "[%1], 0; selp.u32 %0, 1, 0, P1; }"
            : "=r"(done) : "r"(b) : "memory");
    }
    __syncthreads();
    s.thr = (float)sel_s[3];
  }
  if constexpr (s0_from_sel(V)) s.s0 = p.sel[0];
  if constexpr (bound_live(V)) s.cnt = p.sel[1];
  if constexpr (full_pred(V)) {
    s.feat = p.sel[2];
    s.sbin = p.sel[3];
    s.dl = p.sel[4];
    s.cat = p.sel[5];
    s.nanb = p.sel[6];
  }
  if constexpr (V == kSmemThr || V == kNoalias) s.thr = (float)p.sel[3];
  if (p.pass == 1 && in_place(V)) {
    if (threadIdx.x == 0) tile_s = atomicAdd(p.ticket, 1);
    __syncthreads();
    t = tile_s;
  }
  const int live_tiles = bound_live(V) ? (s.cnt + kR - 1) / kR * (kR / kTile)
                                       : p.tiles;
  const int rel = t * kTile + threadIdx.x;
  const long long r = (long long)s.s0 + rel;
  bool keep = false;
  if (t < live_tiles && r < p.n_alloc) {
    const float col = column(p.rows, r, s.feat);
    keep = full_pred(V) ? go_left_f32(col, s) && rel < s.cnt : col <= s.thr;
  }
  if (p.pass == 0) {
    const int n = __syncthreads_count(keep);
    if (threadIdx.x == 0) p.tile_cnt[t] = n;
    return;
  }
  int c;
  const int rank = block_rank(keep, warp_tot, &c);
  if (keep) idx[rank] = threadIdx.x;
  const int T = *p.total;
  const int written = V == kNsplit ? T : T / kR * kR;
  const int j0 = p.tile_pre[t];
  const int nw = max(0, min(c, written - j0));
  __syncthreads();
  const long long row0 = (long long)s.s0 + (long long)t * kTile;
  const uint4* src = reinterpret_cast<const uint4*>(p.rows);
  uint4* dst = reinterpret_cast<uint4*>(p.out);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if constexpr (in_place(V)) {
    for (int k = warp; k < nw; k += kWarps)
      stage[k * kW + lane] = src[(row0 + idx[k]) * kW + lane];
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(p.loaded + t, 1);
      // every tile the destinations [j0, j0 + nw) overlap has read its rows
      if (nw > 0)
        for (int u = j0 / kTile; u <= (j0 + nw - 1) / kTile; ++u)
          while (atomicAdd(p.loaded + u, 0) == 0) {
          }
      __threadfence();
    }
    __syncthreads();
    for (int k = warp; k < nw; k += kWarps)
      dst[((long long)s.s0 + j0 + k) * kW + lane] = stage[k * kW + lane];
  } else {
    for (int k = warp; k < nw; k += kWarps)
      dst[((long long)s.s0 + j0 + k) * kW + lane] =
          src[(row0 + idx[k]) * kW + lane];
  }
  if (V == kNsplit && t == 0) {
    const long long lo = (long long)s.s0 + T;
    const long long hi = T % kR ? (long long)s.s0 + (T / kR + 1) * kR : lo;
    zero_rows(p.out, lo, min(hi, (long long)p.n_alloc));
    if (threadIdx.x == 0) *p.nsplit = T;
  }
}

// -- T8 ----------------------------------------------------------------------
// launched as one cluster of kAliasCtas blocks (legacy_hbm_alias_step)
__global__ void __launch_bounds__(kAliasThreads)
hbm_alias_step(float* __restrict__ comb, int src, int dst) {
  const size_t part = (size_t)blockIdx.x * (kAliasRows / kAliasCtas) * kC / 4;
  const float4* in = reinterpret_cast<const float4*>(comb)
                     + (size_t)src * kC / 4 + part;
  float4* out = reinterpret_cast<float4*>(comb) + (size_t)dst * kC / 4 + part;
  float4 v[kAliasVec];
  for (int k = 0; k < kAliasVec; ++k) {
    v[k] = in[k * kAliasThreads + threadIdx.x];
    v[k].x += 1.f;
    v[k].y += 1.f;
    v[k].z += 1.f;
    v[k].w += 1.f;
  }
  // every block of the cluster has read its rows before any writes
  cg::this_cluster().sync();
  for (int k = 0; k < kAliasVec; ++k)
    out[k * kAliasThreads + threadIdx.x] = v[k];
}

template <int V>
int launch_compact(CParams p, cudaStream_t s) {
  static bool smem_set = false;   // one per instantiation
  if (!smem_set) {
    const int e = (int)cudaFuncSetAttribute(
        compact_carry<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (e != 0) return e;
    smem_set = true;
  }
  const dim3 grid = grid2(V) ? dim3(1, p.tiles) : dim3(p.tiles);
  p.pass = 0;
  compact_carry<V><<<grid, kThreads, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<<<1, kScanThreads, 0, s>>>(p.tile_cnt, p.tile_pre, p.total,
                                        p.tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (in_place(V)) {
    e = cudaMemsetAsync(p.ticket, 0, sizeof(int) * (1 + p.tiles), s);
    if (e != cudaSuccess) return (int)e;
  }
  p.pass = 1;
  compact_carry<V><<<grid, kThreads, in_place(V) ? kStageBytes : 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <int V>
int dispatch(int mech, CParams p, cudaStream_t s) {
  if constexpr (V < kMechs) {
    return mech == V ? launch_compact<V>(p, s) : dispatch<V + 1>(mech, p, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch: block_copy, compact_carry's move in
// place (kind 1), none otherwise.
int legacy_smem_bytes(int kind) {
  return kind == 0 ? kPieceBytes : kind == 1 ? kStageBytes : 0;
}

// scratch[0, nb * 512) = rows[...]; phases 1 (copy) or 3 (copy3).
int legacy_block_copy(int phases, const float* rows, float* scratch, int nb,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool set1 = false, set3 = false;
  if (phases != 1 && phases != 3) return (int)cudaErrorInvalidValue;
  bool& set = phases == 1 ? set1 : set3;
  if (!set) {
    const cudaError_t e =
        phases == 1
            ? cudaFuncSetAttribute(block_copy<1>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kPieceBytes)
            : cudaFuncSetAttribute(block_copy<3>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kPieceBytes);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  if (phases == 1)
    block_copy<1><<<nb, 32, kPieceBytes, s>>>(rows, scratch);
  else
    block_copy<3><<<dim3(nb, 3), 32, kPieceBytes, s>>>(rows, scratch);
  return (int)cudaGetLastError();
}

// The dense partition of [s0, s0 + cnt) (cnt > 0) through scratch, with
// phases 1-3; work i32 [2 * tiles + 1] (tiles = ceil(cnt / 128)), nsplit
// i32 [1].
int legacy_partition_dense(int phases, float* rows, float* scratch,
                           int* work, int* nsplit, int n_alloc, int s0,
                           int cnt, int feat, int sbin, int dl, int cat,
                           int nanb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phases < 1 || phases > 3 || cnt <= 0) return (int)cudaErrorInvalidValue;
  const Sel sp{s0, cnt, feat, sbin, dl, cat, nanb, 0.f};
  const int tiles = (cnt + kTile - 1) / kTile;
  int* cnts = work;
  int* pre = work + tiles;
  int* total = work + 2 * tiles;
  dense_left_count<<<tiles, kThreads, 0, s>>>(rows, sp, n_alloc, cnts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<<<1, kScanThreads, 0, s>>>(cnts, pre, total, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (phases == 1)
    dense_scatter<1><<<tiles, kThreads, 0, s>>>(rows, scratch, sp, n_alloc,
                                                pre, total, nsplit);
  else
    dense_scatter<2><<<tiles, kThreads, 0, s>>>(rows, scratch, sp, n_alloc,
                                                pre, total, nsplit);
  e = cudaGetLastError();
  if (e != cudaSuccess || phases < 3) return (int)e;
  long long blocks = ((long long)cnt * kW + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  dense_copy_span<<<(int)blocks, 256, 0, s>>>(rows, scratch, s0, cnt);
  return (int)cudaGetLastError();
}

// The carry-window compaction, mechanism mech (0-15, the Mech order), over
// tiles = nb * 4 tiles of rows [n_alloc, 128]; out is rows (in place),
// scratch (kAlias2, kNsplit) or a separate tensor (kNoalias); sel a device
// i32 [8] (16-byte aligned) or null, selv 8 host ints (kPrefetch) or null;
// work i32 [3 * tiles + 2]; nsplit i32 [1] (kNsplit) or null.
int legacy_compact(int mech, const int* sel, const int* selv,
                   const float* rows, float* out, int* work, int* nsplit,
                   int n_alloc, int nb, void* stream) {
  CParams p{};
  p.rows = rows;
  p.out = out;
  p.sel = sel;
  if (selv)
    for (int k = 0; k < 8; ++k) p.selv[k] = selv[k];
  p.n_alloc = n_alloc;
  p.tiles = nb * (kR / kTile);
  p.tile_cnt = work;
  p.tile_pre = work + p.tiles;
  p.total = work + 2 * p.tiles;
  p.ticket = work + 2 * p.tiles + 1;
  p.loaded = work + 2 * p.tiles + 2;
  p.nsplit = nsplit;
  if (p.tiles <= 0 || (grid2(mech) && p.tiles > 65535))
    return (int)cudaErrorInvalidValue;
  return dispatch<0>(mech, p, static_cast<cudaStream_t>(stream));
}

// comb f32 [65536, 128] (16-byte aligned): rows [dst, dst + 1024) = rows
// [src, src + 1024) + 1, every read before any write.
int legacy_hbm_alias_step(float* comb, int src, int dst, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kAliasCtas);
  cfg.blockDim = dim3(kAliasThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kAliasCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hbm_alias_step, comb, src,
                                           dst);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
