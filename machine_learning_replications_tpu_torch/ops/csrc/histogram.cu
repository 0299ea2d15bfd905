// Per-(statistic, feature, cell) histograms for GBDT split search on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   machine_learning_replications_tpu/ops/pallas_histogram.py,
//   _stats_histograms (the pl.pallas_call) with body _histogram_kernel,
//   reached by stump_histograms_pallas on the fused depth-1 fit and by
//   node_histograms_pallas on the level-wise tree grower.
//
// Contract (_stats_histograms', with an optional fold axis k):
//   out[k, s, f, seg[k, r] + bins[k, r, f]] += vals[k, r, s]
// A cell outside [0, KB) contributes nothing, as in the TPU kernel's one-hot
// contraction. The caller zeroes `out`; the kernel adds into it. Three entry
// modes share one body and differ only in how a row's statistics are formed:
//   stats  vals [n, S] and seg [n] (or none: all rows 0) as given;
//   stump  g [n] and h [n] read as two columns, S = 2, seg = 0;
//   node   node [n] (int32, -1 = inactive), g [n], h [n]: the kernel
//          forms a = [0 <= node < K], the statistics (g*a, h*a, g*g*a, a) and
//          seg = node*B in registers, skips inactive rows before touching
//          their bins, and writes out[k, s, node, f, b] ([K, F, B] per
//          statistic, the grower's layout).
// Every per-row input is [folds, n, ...] with its own fold stride (0 = one
// array shared by every fold, as the bins of a fold fit are); the fold is
// blockIdx.z.
//
// Bound. One pass over the inputs: n*F bin ids plus the per-row inputs, and
// the output written once. At the fused fit's shape (n = 1M, F = 17, u8
// bins, float32 g and h) that is 25 MB, 7.5 us at 3.35 TB/s; at depth 3's
// last level (plus int32 nodes and a [4, 4, 17, 256] output) 29 MB. The
// n*F*S additions are far below the card's float rate: the kernel is bound
// by bytes. What held the element-major kernel this design replaced 130-230x
// over that bound, and what each step of the design does about it:
//
// 1. Same-address shared atomics. The element-major walk made one shared
//    atomicAdd per (row, feature, statistic). On the cohort 14 of the 17
//    features hold exactly two bin ids, so ~82% of all atomics fell on two
//    addresses per feature (2K at level K), from every warp; and a shared
//    float atomicAdd is a compare-and-swap loop on this card (SASS
//    ATOMS.CAST.SPIN), which retries under contention. Now the walk is
//    feature-major and warp-aggregated: a warp takes 32 rows and steps over
//    the tile's features; at each step the lanes whose cell is equal form a
//    peer group (__match_any_sync), sum their statistics with a segmented
//    shuffle reduction (log2 of the group's size rounds), and the group's
//    leader adds the sums, one atomicAdd per statistic. In node mode the
//    count is __popc(peers), added with a native integer shared atomic into
//    a 32-bit count plane (converted at the merge), exact, no shuffle. A
//    two-valued feature costs at most 2K atomics per statistic per warp step
//    instead of 32; a 256-bin feature costs one match and leaves its
//    (barely contended) atomics. Each warp starts its walk over the tile's
//    features at a different feature, so the warps do not meet on one
//    feature's hot cells at once.
// 2. One-byte loads and values reloaded per feature. Each CTA walks blocks
//    of R rows (R a multiple of 32). Thread 0 copies a block's bin bytes
//    (R*F, contiguous in row-major [n, F]) and its per-row inputs into a
//    two-stage ring in shared memory with cp.async.bulk, completing on an
//    mbarrier, so the next block loads while this one is summed. A lane
//    loads its row's statistics once per block into registers and reads
//    the bin of each feature from shared memory. With one-byte bins, lane l
//    takes row 4l + q of a 128-row group, so the 32 lanes read words F apart
//    (distinct banks for odd F) instead of F/4 apart (four-way conflicts).
//    The bulk copy needs 16-byte aligned addresses and sizes; a ragged last
//    block or a fold stride that breaks the alignment is copied with
//    ordinary loads by all threads instead: the same kernel, a second load
//    path, never the plain version.
// 3. Work outside the kernel. The node and stump wrappers used to build a
//    [n, S] value matrix and the segment ids with six elementwise passes and
//    a stack per call. The kernel now reads node, g and h itself (mode
//    above), so a wrapper only allocates the zeroed output.
// 4. Shared memory and occupancy. The whole S*F*KB histogram fits one CTA
//    only at small depths (the fused fit: 34.8 KB; depth 3's last level:
//    278.5 KB, over the 227 KB a CTA may opt in to). The [F, KB] cells are cut
//    into tiles of tile_features x tile_cells (blockIdx.y; whole features
//    first, cell ranges where one feature alone is too large), each CTA
//    walking every row of its fold but only its tile's features. The caller
//    (ops/cuda_histogram.tile_plan) picks the tiles and R together, with the
//    staging ring's bytes reserved, for the fewest tiles and then the
//    largest R. CTAs have 1024 threads: at depth 3 only one fits an SM.
//
// At the end each CTA adds its nonzero cells into `out` with one global
// atomicAdd each. Float atomics and the shuffle sums regroup additions, so
// the last bits vary from run to run: results are held to the plain version
// at a tolerance, never bit for bit. Counts (sums of 1.0 below 2^24 per
// cell) are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kBarrierBytes = 16;  // one 8-byte mbarrier per stage
constexpr int kStreams = 4;        // staged per-row inputs: bins, key, a, b
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrSharedMemory = 1000001;  // the plan does not fit the opt-in budget
constexpr int kErrBadArgument = 1000002;
constexpr int kMaxGridYZ = 65535;

enum Mode { kStats = 0, kStump = 1, kNode = 2 };

// One per-row input, copied block by block into each stage of the ring.
// row_bytes == 0: absent.
struct Stream {
  const unsigned char* base;  // row 0 of fold 0
  long long fold_stride;      // bytes from one fold to the next (0: shared)
  int row_bytes;
  int smem_off;               // offset inside a stage, a multiple of 16
};

struct Params {
  Stream stream[kStreams];  // 0 bins, 1 key (seg or node), 2 a (vals or g), 3 b (h)
  void* out;
  long long out_fold_stride;  // elements
  long long n;
  int F, S, KB, B, K;         // node mode: KB = K*B
  bool has_key;               // stream 1 holds int32 seg or node ids
  int tile_features, tile_cells, block_rows, stage_bytes;
};

// A row's cell, seg + bin: int where it cannot pass 2^31 (one-byte bins and
// node*B < KB), else 64-bit.
template <bool Narrow>
struct CellType { using type = long long; };
template <>
struct CellType<true> { using type = int; };

// ---- mbarrier and bulk copy (PTX) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (bulk copy) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- staging ----

// Copies rows [blk*R, blk*R + rows) of every stream of fold `fold` into
// `stage`. Thread 0 starts one bulk copy per aligned stream and arrives on
// `bar` with their byte count; the other streams are copied with ordinary
// loads by every thread (visible to the consumer through the __syncthreads
// that separate this call from that stage's next use). Every thread
// evaluates the same alignment predicates, so the branches are uniform.
__device__ __forceinline__ void stage_block(const Params& p, unsigned char* stage,
                                            uint64_t* bar, long long fold, long long blk) {
  const long long r0 = blk * p.block_rows;
  const long long rows = min((long long)p.block_rows, p.n - r0);
  unsigned bulk_bytes = 0;
  bool plain = false;
#pragma unroll
  for (int i = 0; i < kStreams; ++i) {
    const Stream& s = p.stream[i];
    if (s.row_bytes == 0) continue;
    const uintptr_t src = (uintptr_t)(s.base + fold * s.fold_stride + r0 * s.row_bytes);
    const unsigned bytes = (unsigned)(rows * s.row_bytes);
    if ((src & 15u) == 0 && (bytes & 15u) == 0)
      bulk_bytes += bytes;
    else
      plain = true;
  }
  if (threadIdx.x == 0) {
    if (bulk_bytes > 0)
      mbar_arrive_expect_tx(bar, bulk_bytes);
    else
      mbar_arrive(bar);
#pragma unroll
    for (int i = 0; i < kStreams; ++i) {
      const Stream& s = p.stream[i];
      if (s.row_bytes == 0) continue;
      const unsigned char* src = s.base + fold * s.fold_stride + r0 * s.row_bytes;
      const unsigned bytes = (unsigned)(rows * s.row_bytes);
      if ((((uintptr_t)src) & 15u) == 0 && (bytes & 15u) == 0)
        bulk_copy(stage + s.smem_off, src, bytes, bar);
    }
  }
  if (!plain) return;
#pragma unroll
  for (int i = 0; i < kStreams; ++i) {
    const Stream& s = p.stream[i];
    if (s.row_bytes == 0) continue;
    const unsigned char* src = s.base + fold * s.fold_stride + r0 * s.row_bytes;
    const unsigned bytes = (unsigned)(rows * s.row_bytes);
    if ((((uintptr_t)src) & 15u) == 0 && (bytes & 15u) == 0) continue;
    unsigned char* dst = stage + s.smem_off;
    if ((((uintptr_t)src) & 3u) == 0 && (bytes & 3u) == 0) {
      const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
      uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
      for (unsigned w = threadIdx.x; w < bytes / 4; w += kThreads) d4[w] = s4[w];
    } else {
      for (unsigned b = threadIdx.x; b < bytes; b += kThreads) dst[b] = src[b];
    }
  }
  fence_proxy_async();
}

// ---- warp-aggregated accumulation ----

// Lanes holding the same valid `cell` sum their NV statistics and the
// group's lowest lane adds the sums (and, with COUNT, the group's size as an
// unsigned integer) into the tile histogram at h + q*plane. `nv` <= NV
// statistics are live.
template <int NV, bool COUNT, typename ValT>
__device__ __forceinline__ void add_peers(ValT* h, int plane, bool ok, unsigned cell,
                                          const ValT (&v)[NV], int nv, int lane) {
  const unsigned peers = __match_any_sync(kFull, ok ? cell : kFull);
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned higher = ok ? (peers & ~below & ~(1u << lane)) : 0u;
  unsigned rank = __popc(below);
  ValT x[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) x[q] = v[q];
  // Segmented tree sum: in round t each remaining lane adds the partial sum
  // of the next remaining peer above it; lanes whose rank has bit t set are
  // then done. The group's lowest lane ends with the group's sum.
  while (__any_sync(kFull, higher != 0u)) {
    const int next = __ffs(higher) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const ValT t = __shfl_sync(kFull, x[q], src);
      if (next >= 0) x[q] += t;
    }
    higher &= __ballot_sync(kFull, (rank & 1u) == 0u);
    rank >>= 1;
  }
  if (ok && below == 0u) {
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (q < nv && x[q] != ValT(0)) atomicAdd(h + q * plane, x[q]);
    // The count plane holds 32-bit integers: an integer shared atomic is
    // native, a float one is a compare-and-swap loop.
    if (COUNT)
      atomicAdd(reinterpret_cast<unsigned*>(h + NV * plane), (unsigned)__popc(peers));
  }
}

// The rows of one staged block, summed into this CTA's tile histogram.
// Warps take 32-row chunks (and, where a block has fewer chunks than warps,
// share a chunk's features); a lane forms its row's statistics once and
// steps over the tile's features.
template <int MODE, typename BinT, typename ValT>
__device__ __forceinline__ void accumulate(const Params& p, const unsigned char* stage, int rows,
                                           ValT* hist, int f_lo, int c_lo, int tfw, int tcw,
                                           int plane) {
  using CellT = typename CellType<sizeof(BinT) == 1 && MODE != kStats>::type;
  constexpr int NV = MODE == kStump ? 2 : (MODE == kNode ? 3 : 4);
  constexpr int L = sizeof(BinT) == 1 ? 4 : 1;  // lane stride in rows (see note 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const BinT* sbins = reinterpret_cast<const BinT*>(stage + p.stream[0].smem_off);
  const int32_t* skey = reinterpret_cast<const int32_t*>(stage + p.stream[1].smem_off);
  const ValT* sa = reinterpret_cast<const ValT*>(stage + p.stream[2].smem_off);
  const ValT* sb = reinterpret_cast<const ValT*>(stage + p.stream[3].smem_off);
  const int chunks = p.block_rows >> 5;
  const bool permuted = L > 1 && (p.block_rows % (32 * L)) == 0;
  const int wpc = chunks >= kWarps ? 1 : kWarps / chunks;  // warps per chunk
  const int cstep = kWarps / wpc;
  for (int c = warp / wpc; c < chunks; c += cstep) {
    const int r = permuted ? (c / L) * (32 * L) + lane * L + (c % L) : (c << 5) + lane;
    bool live = r < rows;
    CellT seg = 0;
    for (int s0 = 0; s0 < (MODE == kStats ? p.S : 1); s0 += NV) {
      ValT v[NV];
      int nv = NV;
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = ValT(0);
      if (MODE == kStats) {
        nv = min(NV, p.S - s0);
        if (live) {
          if (p.has_key) seg = skey[r];
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (q < nv) v[q] = sa[(long long)r * p.S + s0 + q];
        }
      } else if (MODE == kStump) {
        if (live) {
          v[0] = sa[r];
          v[1] = sb[r];
        }
      } else {
        if (live) {
          const int node = skey[r];
          live = node >= 0 && node < p.K;
          if (live) {
            seg = (CellT)node * p.B;
            const ValT g = sa[r];
            v[0] = g;
            v[1] = sb[r];
            v[2] = g * g;
          }
        }
      }
      if (!__any_sync(kFull, live)) break;  // the whole chunk is inactive
      const BinT* brow = sbins + (long long)(live ? r : 0) * p.F + f_lo;
      ValT* hs = hist + (MODE == kStats ? s0 * plane : 0);
      // This warp's features j0, j0 + wpc, ...: walked from a different
      // starting feature in each warp, so the warps' atomics on a two-valued
      // feature's hot cells do not all come at once.
      const int j0 = warp % wpc;
      const int cnt = (tfw - j0 + wpc - 1) / wpc;
      int t = cnt > 0 ? (warp / wpc) % cnt : 0;
      for (int step = 0; step < cnt; ++step, t = t + 1 == cnt ? 0 : t + 1) {
        const int j = j0 + t * wpc;
        const CellT cell = seg + (CellT)brow[j] - c_lo;
        const bool ok = live && cell >= 0 && cell < tcw;
        add_peers<NV, MODE == kNode, ValT>(hs + j * tcw + (ok ? (int)cell : 0), plane, ok,
                                           (unsigned)cell, v, nv, lane);
      }
    }
  }
}

template <int MODE, typename BinT, typename ValT>
__global__ void __launch_bounds__(kThreads, 1) histogram_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarrierBytes;
  ValT* hist = reinterpret_cast<ValT*>(ring + kStages * p.stage_bytes);

  // This CTA's fold and tile: features [f_lo, f_lo + tfw), cells [c_lo, c_lo + tcw).
  const long long fold = blockIdx.z;
  const int cell_tiles = (p.KB + p.tile_cells - 1) / p.tile_cells;
  const int f_lo = (blockIdx.y / cell_tiles) * p.tile_features;
  const int c_lo = (blockIdx.y % cell_tiles) * p.tile_cells;
  const int tfw = min(p.tile_features, p.F - f_lo);
  const int tcw = min(p.tile_cells, p.KB - c_lo);
  const int plane = tfw * tcw;  // one statistic's cells in this tile
  const int cells = p.S * plane;
  const long long n_blocks = (p.n + p.block_rows - 1) / p.block_rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kStages; ++s) {
    const long long blk = blockIdx.x + (long long)s * gridDim.x;
    if (blk < n_blocks) stage_block(p, ring + s * p.stage_bytes, &bars[s], fold, blk);
  }
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = ValT(0);
  __syncthreads();

  for (long long it = 0;; ++it) {
    const long long blk = blockIdx.x + it * gridDim.x;
    if (blk >= n_blocks) break;
    const int s = (int)(it % kStages);
    mbar_wait(&bars[s], (unsigned)((it / kStages) & 1));
    const int rows = (int)min((long long)p.block_rows, p.n - blk * p.block_rows);
    accumulate<MODE, BinT, ValT>(p, ring + s * p.stage_bytes, rows, hist, f_lo, c_lo, tfw, tcw,
                                 plane);
    __syncthreads();  // every warp is done with stage s
    const long long next = blk + (long long)kStages * gridDim.x;
    if (next < n_blocks) stage_block(p, ring + s * p.stage_bytes, &bars[s], fold, next);
  }
  __syncthreads();

  // Local cell i = (s*tfw + j)*tcw + c → out[s, f_lo + j, c_lo + c], or in
  // node mode out[s, node, f_lo + j, b] with c_lo + c = node*B + b.
  ValT* out = static_cast<ValT*>(p.out) + fold * p.out_fold_stride;
  const int count_lo = MODE == kNode ? 3 * plane : cells;  // the integer count plane
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const ValT x = i < count_lo ? hist[i] : ValT(reinterpret_cast<const unsigned*>(hist + i)[0]);
    if (x == ValT(0)) continue;
    const int sj = i / tcw;
    const int c = i - sj * tcw + c_lo;
    const int s = sj / tfw;
    const int f = sj - s * tfw + f_lo;
    long long o;
    if (MODE == kNode) {
      const int node = c / p.B;
      o = (((long long)s * p.K + node) * p.F + f) * p.B + (c - node * p.B);
    } else {
      o = ((long long)s * p.F + f) * p.KB + c;
    }
    atomicAdd(out + o, x);
  }
}

template <int MODE, typename BinT, typename ValT>
int launch(Params p, int folds, int device, cudaStream_t stream) {
  if (p.n <= 0 || folds <= 0) return 0;
  const long long tiles = (long long)((p.F + p.tile_features - 1) / p.tile_features) *
                          ((p.KB + p.tile_cells - 1) / p.tile_cells);
  if (tiles > kMaxGridYZ || folds > kMaxGridYZ) return kErrBadArgument;
  const size_t smem = (size_t)kBarrierBytes + (size_t)kStages * p.stage_bytes +
                      (size_t)p.S * p.tile_features * p.tile_cells * sizeof(ValT);
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return kErrSharedMemory;

  auto kernel = histogram_kernel<MODE, BinT, ValT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;

  // Enough CTAs to fill every SM once, shared among the (tile, fold) pairs,
  // and no more than there are row blocks.
  const long long groups = tiles * folds;
  const long long n_blocks = (p.n + p.block_rows - 1) / p.block_rows;
  long long grid = (long long)per_sm * sms / groups;
  if (grid < 1) grid = 1;
  if (n_blocks < grid) grid = n_blocks;
  const dim3 blocks((unsigned)grid, (unsigned)tiles, (unsigned)folds);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const Params& p, int bin_dtype, int val_dtype, int folds, int device,
             cudaStream_t st) {
  if (bin_dtype == 0 && val_dtype == 0) return launch<MODE, uint8_t, float>(p, folds, device, st);
  if (bin_dtype == 0 && val_dtype == 1) return launch<MODE, uint8_t, double>(p, folds, device, st);
  if (bin_dtype == 1 && val_dtype == 0) return launch<MODE, int32_t, float>(p, folds, device, st);
  if (bin_dtype == 1 && val_dtype == 1) return launch<MODE, int32_t, double>(p, folds, device, st);
  return kErrBadArgument;
}

}  // namespace

extern "C" {

// mode: 0 stats (a = vals [n, S], key = seg or none, b none),
//       1 stump (a = g, b = h, S = 2, no key),
//       2 node (key = node ids, a = g, b = h, S = 4, KB = K*B).
// The key is int32; bin_dtype: 0 uint8, 1 int32;
// val_dtype: 0 float32, 1 float64 (a and b alike). Every input is
// [folds, n, ...] with the inner dimensions contiguous and the given fold
// stride in elements (0: shared by every fold). tile_features x tile_cells
// is one CTA's share of the [F, KB] cells and block_rows (a multiple of 32)
// the rows of one staged block (ops/cuda_histogram.tile_plan picks them to
// fit the shared-memory budget). Launches on `stream` of CUDA device
// `device` and does not synchronise. Returns 0 on success, a cudaError_t,
// or one of the kErr* codes above.
int histogram_launch(int mode, const void* bins, int bin_dtype, long long bins_fold_stride,
                     const void* key, long long key_fold_stride, const void* a,
                     const void* b, int val_dtype, long long a_fold_stride,
                     long long b_fold_stride, void* out, long long n, int F, int S, int KB,
                     int B, int folds, int tile_features, int tile_cells, int block_rows,
                     int device, void* stream) {
  if (F <= 0 || S <= 0 || KB <= 0 || B <= 0 || tile_features <= 0 || tile_cells <= 0 ||
      block_rows <= 0 || block_rows % 32 != 0 || bins == nullptr || a == nullptr ||
      out == nullptr || bin_dtype < 0 || bin_dtype > 1 || val_dtype < 0 || val_dtype > 1)
    return kErrBadArgument;
  if (mode == kStats && b != nullptr) return kErrBadArgument;
  if (mode == kStump && (S != 2 || key != nullptr || b == nullptr)) return kErrBadArgument;
  if (mode == kNode && (S != 4 || key == nullptr || b == nullptr || KB % B != 0))
    return kErrBadArgument;
  if (mode < kStats || mode > kNode) return kErrBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tile_features > F) tile_features = F;
  if (tile_cells > KB) tile_cells = KB;

  const int bin_size = bin_dtype == 0 ? 1 : 4;
  const int val_size = val_dtype == 0 ? 4 : 8;
  const int key_size = key == nullptr ? 0 : 4;
  Params p = {};
  const void* ptrs[kStreams] = {bins, key, a, b};
  const long long strides[kStreams] = {bins_fold_stride, key_fold_stride, a_fold_stride,
                                       b_fold_stride};
  const int sizes[kStreams] = {bin_size, key_size, val_size, val_size};
  const int per_row[kStreams] = {F, 1, mode == kStats ? S : 1, 1};
  int off = 0;
  for (int i = 0; i < kStreams; ++i) {
    Stream& s = p.stream[i];
    s.base = static_cast<const unsigned char*>(ptrs[i]);
    s.row_bytes = ptrs[i] ? sizes[i] * per_row[i] : 0;
    s.fold_stride = strides[i] * sizes[i];
    s.smem_off = off;
    off += (block_rows * s.row_bytes + 15) / 16 * 16;
  }
  p.stage_bytes = off;
  p.out = out;
  p.out_fold_stride = (long long)S * F * KB;
  p.n = n;
  p.F = F;
  p.S = S;
  p.KB = KB;
  p.B = B;
  p.K = KB / B;
  p.has_key = key != nullptr;
  p.tile_features = tile_features;
  p.tile_cells = tile_cells;
  p.block_rows = block_rows;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kStats) return dispatch<kStats>(p, bin_dtype, val_dtype, folds, device, st);
  if (mode == kStump) return dispatch<kStump>(p, bin_dtype, val_dtype, folds, device, st);
  return dispatch<kNode>(p, bin_dtype, val_dtype, folds, device, st);
}

// Shared memory one CTA may opt in to on `device` (bytes), or -1.
int histogram_smem_budget(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return optin;
}

const char* histogram_error_string(int code) {
  if (code == kErrSharedMemory)
    return "histogram tile and staging ring do not fit in shared memory";
  if (code == kErrBadArgument) return "bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
