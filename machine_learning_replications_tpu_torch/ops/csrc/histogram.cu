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
//          statistic, the grower's layout). Where it pays (note 5) the node
//          mode runs as a partitioned walk: the same contract, summed over a
//          copy of the rows sorted by node.
// Every per-row input is [folds, n, ...] with its own fold stride (0 = one
// array shared by every fold, as the bins of a fold fit are); the fold is
// blockIdx.z.
//
// Bound. One pass over the inputs: n*F bin ids plus the per-row inputs, and
// the output written once. At the fused fit's shape (n = 1M, F = 17, u8
// bins, float32 g and h) that is 25 MB, 7.5 us at 3.35 TB/s; at depth 3's
// last level (plus int32 nodes and a [4, 4, 17, 256] output) 29 MB; at
// depth 8's last level on HIGGS's widths (n = 10.5M, F = 28, K = 128) 435
// MB, 0.13 ms (the partition's own traffic, note 5, is over this bound and
// counts against it). The n*F*S additions are far below the card's float
// rate: the kernel is bound by bytes. What held the element-major kernel
// this design replaced 130-230x over that bound, and what each step of the
// design does about it:
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
// 4. Shared memory and occupancy: the tiled walk. The whole S*F*KB
//    histogram fits one CTA only at small depths (the fused fit: 34.8 KB;
//    depth 3's last level: 278.5 KB, over the 227 KB a CTA may opt in to).
//    The tiled walk cuts the [F, KB] cells into tiles of tile_features x
//    tile_cells (blockIdx.y; whole features first, cell ranges where one
//    feature alone is too large), and each CTA walks every row of its fold
//    but sums only its tile's cells. One node's cells of one feature take
//    S*B*4 = 4 KB in float32, so at K nodes a level a feature takes 4*K KB:
//    from K = 32 a CTA holds at most one feature, at K = 64 and 128 a part of
//    one. Every tile re-reads every row (all F bin bytes and the per-row
//    inputs of each staged block) and uses one byte of bins of the rows
//    whose node falls in its range: at HIGGS's widths (F = 28) the levels of
//    a depth-8 tree take 1, 1, 2, 4, 10, 28, 56 and 84 passes over the rows,
//    186 where 8 are work, and at level 7 the 84 tiles fill 84 of the card's
//    132 SMs with one CTA each. Where the tiles fit, the cells' room leaves
//    little for the ring: depth 8's levels 1-3 stage 32-row blocks. The
//    caller (ops/cuda_histogram.tile_plan) picks the tiles and R together,
//    with the ring's bytes reserved, for the fewest tiles and then the
//    largest R. CTAs have 1024 threads: at depth 3 only one fits an SM.
// 5. The partitioned walk (node mode, one fit, K >= 2, where the tiled plan
//    takes more than two passes or smaller blocks; ops/cuda_histogram.
//    node_plan). One launch first sorts the level's rows by node on the
//    card, then walks each node's rows once with all of a node's features'
//    cells held together, so the cells a CTA holds no longer grow with K:
//    a. count (histogram_kernel_partition_count): per block of 16,384 rows,
//       the rows of each node (warp-aggregated shared atomics); parked rows
//       (node -1, or outside [0, K)) are dropped;
//    b. scan (histogram_kernel_partition_scan, a CTA per fold): the
//       node-major [K, blocks] counts become each block's first position per
//       node, and their node-major order the fold's [K + 1] node offsets;
//    c. scatter (histogram_kernel_partition_scatter): each block puts its
//       active rows' bins, g and h in node order and within a node in row
//       order (a stable counting sort) into a scratch copy of the same
//       layout, so the walk stages contiguous rows with its bulk-copy ring
//       as the tiled walk does. It stages 2,048 rows at a time in shared
//       memory in that order and writes each node's run out whole: a row
//       written where it lands took 2.3 ms at K = 128 (against 0.65 ms at
//       K = 2), its stores spread over as many places as nodes;
//    d. walk (histogram_kernel_sorted): a grid fixed from n (the host never
//       reads a count back) where each CTA takes an equal range of the
//       fold's sorted rows, cut at multiples of 32 rows so that its blocks
//       stay 16-byte aligned, and one feature tile (blockIdx.y) of the node
//       at hand. It learns where each node ends from the offsets, sums with
//       add_peers as above (one segment: cell = bin), and when the node ends,
//       or after 8,192 of its rows, adds its nonzero cells to `out` with one
//       global atomic each and clears them. The second bound keeps a float32
//       cell's run of additions as short as a 1M-row fit's: summing up to
//       80,000 rows a CTA put 1.3e-5 of a cell's mass in its error at 10.5M
//       rows, 8,192 at a time 1-3e-6, for 0.1 ms more a level. A node's
//       cells for all 28 features are 114.7 KB in float32, beside a ring of
//       1024-row blocks: one pass at HIGGS's widths whatever K is, as the
//       root level's.
//    The partition reads each row's bins, g, h and node id and writes all
//    but the node id: about 80 bytes a row, 0.25 ms at 10.5M x 28 by the
//    bytes, 0.8-1.1 ms measured on an H100 at every K; the walk then takes
//    what the root level does (3.0 ms). The scratch copy (about 36 bytes a
//    row: 0.4 GB at 10.5M rows) is the caller's. Every other launch takes
//    the tiled walk: a level of one node, fold launches (at 5 x 50,000 rows
//    the partition alone takes twice the tiled walk), the stump and stats
//    entries, and node levels whose tiled plan is at most two passes of
//    full blocks (depth 3's last level at 10M x 17: 1.87 ms tiled against
//    2.5 ms partitioned).
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
constexpr int kFlushRows = 8192;  // the sorted walk's rows summed in a cell before it is added out

// kSorted: node mode's statistics over rows sorted by node (note 5d).
enum Mode { kStats = 0, kStump = 1, kNode = 2, kSorted = 3 };

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
  const int* offsets;         // kSorted: [folds, K + 1] node offsets of the sorted rows
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

// Copies rows [r0, r0 + rows) of every stream of fold `fold` into `stage`.
// Thread 0 starts one bulk copy per aligned stream and arrives on `bar`
// with their byte count; the other streams are copied with ordinary loads
// by every thread (visible to the consumer through the __syncthreads that
// separate this call from that stage's next use). Every thread evaluates
// the same alignment predicates, so the branches are uniform.
__device__ __forceinline__ void stage_rows(const Params& p, unsigned char* stage, uint64_t* bar,
                                           long long fold, long long r0, long long rows) {
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

// Block `blk` of the tiled walk: rows [blk*R, min((blk + 1)*R, n)).
__device__ __forceinline__ void stage_block(const Params& p, unsigned char* stage, uint64_t* bar,
                                            long long fold, long long blk) {
  const long long r0 = blk * p.block_rows;
  stage_rows(p, stage, bar, fold, r0, min((long long)p.block_rows, p.n - r0));
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

// Rows [lo, hi) of one staged block, summed into this CTA's tile histogram.
// Warps take 32-row chunks (and, where a block has fewer chunks than warps,
// share a chunk's features); a lane forms its row's statistics once and
// steps over the tile's features.
template <int MODE, typename BinT, typename ValT>
__device__ __forceinline__ void accumulate(const Params& p, const unsigned char* stage, int lo,
                                           int hi, ValT* hist, int f_lo, int c_lo, int tfw,
                                           int tcw, int plane) {
  using CellT = typename CellType<sizeof(BinT) == 1 && MODE != kStats>::type;
  constexpr int NV = MODE == kStump ? 2 : (MODE == kStats ? 4 : 3);
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
    bool live = (MODE != kSorted || r >= lo) && r < hi;  // the tiled walk's lo is 0
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
      } else if (MODE == kSorted) {
        if (live) {  // every row of the window is the node's: seg = 0
          const ValT g = sa[r];
          v[0] = g;
          v[1] = sb[r];
          v[2] = g * g;
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
        add_peers<NV, MODE == kNode || MODE == kSorted, ValT>(
            hs + j * tcw + (ok ? (int)cell : 0), plane, ok, (unsigned)cell, v, nv, lane);
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
    accumulate<MODE, BinT, ValT>(p, ring + s * p.stage_bytes, 0, rows, hist, f_lo, c_lo, tfw,
                                 tcw, plane);
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

// The partitioned walk (note 5d): this CTA's share of fold blockIdx.z's
// rows, sorted by node, for features [f_lo, f_lo + tfw) of one node at a
// time. p.KB is B here (one node's cells of a feature).
template <typename BinT, typename ValT>
__global__ void __launch_bounds__(kThreads, 1)
    histogram_kernel_sorted(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarrierBytes;
  ValT* hist = reinterpret_cast<ValT*>(ring + kStages * p.stage_bytes);

  const long long fold = blockIdx.z;
  const int f_lo = blockIdx.y * p.tile_features;
  const int tfw = min(p.tile_features, p.F - f_lo);
  const int plane = tfw * p.B;
  const int cells = 4 * plane;
  const int* offs = p.offsets + fold * (p.K + 1);
  // Rows [a, b) of the fold's `total` sorted rows, cut at multiples of 32.
  const long long total = offs[p.K];
  const long long a = (total * blockIdx.x / gridDim.x) & ~31LL;
  const long long b =
      blockIdx.x + 1 == gridDim.x ? total : (total * (blockIdx.x + 1) / gridDim.x) & ~31LL;
  const long long n_blocks = b > a ? (b - a + p.block_rows - 1) / p.block_rows : 0;
  if (n_blocks == 0) return;  // the whole CTA: nothing to stage or add

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kStages && s < n_blocks; ++s) {
    const long long r0 = a + (long long)s * p.block_rows;
    stage_rows(p, ring + s * p.stage_bytes, &bars[s], fold, r0,
               min((long long)p.block_rows, b - r0));
  }
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = ValT(0);
  __syncthreads();

  // Adds the held node's nonzero cells to out[s, node, f_lo + j, bin] and
  // clears them (the count plane's integers share their slots' low bytes).
  ValT* out = static_cast<ValT*>(p.out) + fold * p.out_fold_stride;
  auto flush = [&](int node) {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const ValT x =
          i < 3 * plane ? hist[i] : ValT(reinterpret_cast<const unsigned*>(hist + i)[0]);
      if (x == ValT(0)) continue;
      hist[i] = ValT(0);
      const int s = i / plane;
      const int j = (i - s * plane) / p.B;
      const int bin = i - s * plane - j * p.B;
      atomicAdd(out + (((long long)s * p.K + node) * p.F + f_lo + j) * p.B + bin, x);
    }
  };

  // The node holding row a: the last k with offs[k] <= a (offs[0] = 0 <= a <
  // offs[K]). Every thread reads the same offsets, so the walk's branches
  // and barriers stay uniform.
  int lo_k = 0, hi_k = p.K;
  while (hi_k - lo_k > 1) {
    const int mid = (lo_k + hi_k) >> 1;
    if (offs[mid] <= a)
      lo_k = mid;
    else
      hi_k = mid;
  }
  int node = lo_k;
  long long end = offs[node + 1];
  int held = 0;  // rows summed since the last flush
  for (long long it = 0; it < n_blocks; ++it) {
    const int s = (int)(it % kStages);
    mbar_wait(&bars[s], (unsigned)((it / kStages) & 1));
    const long long r0 = a + it * p.block_rows;
    const int rows = (int)min((long long)p.block_rows, b - r0);
    for (int lo = 0; lo < rows;) {
      const int hi = (int)min((long long)rows, end - r0);
      accumulate<kSorted, BinT, ValT>(p, ring + s * p.stage_bytes, lo, hi, hist, f_lo, 0, tfw,
                                      p.B, plane);
      held += hi - lo;
      if (r0 + hi < end && held < kFlushRows) break;  // the node goes on past this block
      __syncthreads();
      flush(node);
      __syncthreads();
      held = 0;
      if (r0 + hi < end) break;
      do ++node;  // the next node with rows
      while (node < p.K && offs[node + 1] <= end);
      if (node < p.K) end = offs[node + 1];
      lo = hi;
    }
    __syncthreads();  // every warp is done with stage s
    const long long next = it + kStages;
    if (next < n_blocks) {
      const long long q0 = a + next * p.block_rows;
      stage_rows(p, ring + s * p.stage_bytes, &bars[s], fold, q0,
                 min((long long)p.block_rows, b - q0));
    }
  }
  if (held > 0) {
    __syncthreads();
    flush(node);
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

  decltype(&histogram_kernel<kNode, BinT, ValT>) kernel;
  if constexpr (MODE == kSorted)
    kernel = histogram_kernel_sorted<BinT, ValT>;
  else
    kernel = histogram_kernel<MODE, BinT, ValT>;
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

// ---- the partition (note 5a-c) ----

constexpr int kPartThreads = 1024;
constexpr int kPartWarps = kPartThreads / 32;  // 32: one scan step over a warp's lanes
constexpr int kPartRows = 16384;              // rows of a count or scatter block
constexpr int kMaxStageChunks = 2;            // a scatter sub-block: at most 2 x 1024 rows
constexpr int kScatterStaticBytes = 4 * kPartWarps;  // the scatter's static shared memory
constexpr int kPartMaxNodes = 1024;  // nodes a scatter block scans, one thread each
constexpr int kScanItems = 8;        // consecutive counts a scan thread takes

struct PartParams {
  const unsigned char* bins;  // [folds, n, F] (fold stride 0: shared by every fold)
  const int32_t* node;        // [folds, n]
  const unsigned char* g;     // [folds, n], float32 or float64
  const unsigned char* h;
  long long bins_fold_stride, node_fold_stride, g_fold_stride, h_fold_stride;  // bytes
  unsigned char* sorted_bins;  // [folds, n_pad, F]: the active rows in node order
  unsigned char* sorted_g;     // [folds, n_pad]
  unsigned char* sorted_h;
  int* counts;   // [folds, K, blocks]: counts, then each block's first position per node
  int* offsets;  // [folds, K + 1]: node k's sorted rows are [offsets[k], offsets[k + 1])
  long long n, n_pad;
  int K, blocks, bin_row_bytes, val_bytes, stage_rows;
};

__device__ __forceinline__ const int32_t* fold_nodes(const PartParams& p, long long fold) {
  return reinterpret_cast<const int32_t*>(reinterpret_cast<const unsigned char*>(p.node) +
                                          fold * p.node_fold_stride);
}

// Per block of kPartRows rows and fold blockIdx.z, the active rows of each
// node → counts[fold, node, blockIdx.x].
__global__ void __launch_bounds__(kPartThreads)
    histogram_kernel_partition_count(const __grid_constant__ PartParams p) {
  extern __shared__ int part_smem[];
  int* cnt = part_smem;  // [K]
  const long long fold = blockIdx.z;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < p.K; k += kPartThreads) cnt[k] = 0;
  __syncthreads();
  const int32_t* node = fold_nodes(p, fold);
  const long long r0 = (long long)blockIdx.x * kPartRows;
  const long long r1 = min(p.n, r0 + kPartRows);
  for (long long c0 = r0; c0 < r1; c0 += kPartThreads) {
    const long long r = c0 + threadIdx.x;
    const int nd = r < r1 ? node[r] : -1;
    const bool ok = nd >= 0 && nd < p.K;
    const unsigned peers = __match_any_sync(kFull, ok ? (unsigned)nd : kFull);
    if (ok && (peers & ((1u << lane) - 1u)) == 0u) atomicAdd(&cnt[nd], __popc(peers));
  }
  __syncthreads();
  int* out = p.counts + fold * p.K * p.blocks;
  for (int k = threadIdx.x; k < p.K; k += kPartThreads)
    out[(long long)k * p.blocks + blockIdx.x] = cnt[k];
}

// One CTA per fold: the exclusive scan of the fold's node-major [K, blocks]
// counts, in place, in tiles of kPartThreads * kScanItems; then the node
// offsets (node k's first position, and the active rows' count at K).
__global__ void __launch_bounds__(kPartThreads)
    histogram_kernel_partition_scan(const __grid_constant__ PartParams p) {
  __shared__ int warp_total[kPartWarps];
  const long long fold = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* c = p.counts + fold * p.K * p.blocks;
  const long long len = (long long)p.K * p.blocks;
  int carry = 0;  // the counts of the tiles before this one
  for (long long t0 = 0; t0 < len; t0 += (long long)kPartThreads * kScanItems) {
    const long long i0 = t0 + (long long)threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = i0 + j < len ? c[i0 + j] : 0;
      sum += v[j];
    }
    int x = sum;  // inclusive over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_total[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_total[lane] = w;
    }
    __syncthreads();
    int pos = carry + (warp > 0 ? warp_total[warp - 1] : 0) + x - sum;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < len) c[i0 + j] = pos;
      pos += v[j];
    }
    carry += warp_total[kPartWarps - 1];
    __syncthreads();  // warp_total is read above; the positions are written
  }
  int* offs = p.offsets + fold * (p.K + 1);
  for (int k = threadIdx.x; k < p.K; k += kPartThreads) offs[k] = c[(long long)k * p.blocks];
  if (threadIdx.x == 0) offs[p.K] = carry;
}

// `bytes` from src to dst, as 4-byte words where both and the size allow.
__device__ __forceinline__ void copy_bytes(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes) &
       3u) == 0) {
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
    for (int w = 0; w < bytes / 4; ++w) d4[w] = s4[w];
  } else {
    for (int i = 0; i < bytes; ++i) dst[i] = src[i];
  }
}

// Per block of kPartRows rows: each active row's bins, g and h to its place
// in the sorted copy, a sub-block of stage_rows rows at a time. Warp w takes
// the sub-block's rows [w*m*32, (w + 1)*m*32) (m = stage_rows / 1024) and
// counts them by node; per node a scan over the warps gives each warp its
// first rank, and a scan over the nodes each node's first slot; each warp
// then copies its rows into shared memory at slot = the node's first slot +
// its warp's rank + its rank among its lanes of that node, so the sub-block
// lies in node order and, within a node, in row order; last the block writes
// each node's run of slots to that node's next places, contiguous, so whole
// rows go out in full sectors however many nodes there are. Where a row's
// bins are whole 4-byte words (at most 32), a warp moves a row's words on
// neighbouring lanes.
__global__ void __launch_bounds__(kPartThreads)
    histogram_kernel_partition_scatter(const __grid_constant__ PartParams p) {
  extern __shared__ __align__(16) int scatter_smem[];
  __shared__ int warp_total[kScatterStaticBytes / 4];
  const int K = p.K, m = p.stage_rows / kPartThreads;
  int* wrank = scatter_smem;            // [kPartWarps, K]: counts, then first ranks
  int* first = wrank + kPartWarps * K;  // [K + 1]: each node's first slot, the count at K
  int* next = first + K + 1;            // [K]: each node's next place in the sorted copy
  int* base = next + K;                 // [K]: the sub-block's first place of each node
  int* slot_node = base + K;            // [stage_rows]
  unsigned char* stage_bins = reinterpret_cast<unsigned char*>(slot_node + p.stage_rows);
  unsigned char* stage_g = stage_bins + (p.stage_rows * p.bin_row_bytes + 15) / 16 * 16;
  unsigned char* stage_h = stage_g + p.stage_rows * p.val_bytes;
  const long long fold = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* starts = p.counts + fold * K * p.blocks;
  for (int k = threadIdx.x; k < K; k += kPartThreads)
    next[k] = starts[(long long)k * p.blocks + blockIdx.x];
  const int32_t* node = fold_nodes(p, fold);
  const unsigned char* bins = p.bins + fold * p.bins_fold_stride;
  const unsigned char* g = p.g + fold * p.g_fold_stride;
  const unsigned char* h = p.h + fold * p.h_fold_stride;
  unsigned char* sbins = p.sorted_bins + fold * p.n_pad * p.bin_row_bytes;
  unsigned char* sg = p.sorted_g + fold * p.n_pad * p.val_bytes;
  unsigned char* sh = p.sorted_h + fold * p.n_pad * p.val_bytes;
  const int words = p.bin_row_bytes / 4;
  const bool together = p.bin_row_bytes % 4 == 0 && words <= 32 &&
                        ((reinterpret_cast<uintptr_t>(bins) | reinterpret_cast<uintptr_t>(sbins)) &
                         3u) == 0;
  const int per_step = together ? 32 / words : 0;  // rows a warp moves in one step
  const int sub = together ? lane / words : 0, word = lane - sub * words;
  const long long b1 = min(p.n, ((long long)blockIdx.x + 1) * kPartRows);
  for (long long s0 = (long long)blockIdx.x * kPartRows; s0 < b1; s0 += p.stage_rows) {
    for (int i = threadIdx.x; i < kPartWarps * K; i += kPartThreads) wrank[i] = 0;
    __syncthreads();  // also: `next` is filled, the last sub-block is written out
    int nd[kMaxStageChunks];
    unsigned peers[kMaxStageChunks];
    for (int j = 0; j < m; ++j) {
      const long long r = s0 + (warp * m + j) * 32 + lane;
      nd[j] = r < b1 ? node[r] : -1;
      const bool ok = nd[j] >= 0 && nd[j] < K;
      if (!ok) nd[j] = -1;
      peers[j] = __match_any_sync(kFull, ok ? (unsigned)nd[j] : kFull);
      if (ok && (peers[j] & ((1u << lane) - 1u)) == 0u) wrank[warp * K + nd[j]] += __popc(peers[j]);
      __syncwarp();
    }
    __syncthreads();
    int total = 0;  // this thread's node's rows in the sub-block
    if ((int)threadIdx.x < K) {
      for (int w = 0; w < kPartWarps; ++w) {
        const int c = wrank[w * K + threadIdx.x];
        wrank[w * K + threadIdx.x] = total;
        total += c;
      }
    }
    int x = total;  // inclusive over the nodes, a warp's lanes first
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = warp_total[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, t, off);
        if (lane >= off) t += y;
      }
      warp_total[lane] = t;
    }
    __syncthreads();
    x += warp > 0 ? warp_total[warp - 1] : 0;
    if ((int)threadIdx.x < K) {
      first[threadIdx.x] = x - total;
      base[threadIdx.x] = next[threadIdx.x];
      next[threadIdx.x] += total;
    }
    if ((int)threadIdx.x == K - 1) first[K] = x;
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const long long r = s0 + (warp * m + j) * 32 + lane;
      const unsigned below = peers[j] & ((1u << lane) - 1u);
      const int slot = nd[j] >= 0 ? first[nd[j]] + wrank[warp * K + nd[j]] + __popc(below) : -1;
      if (slot >= 0) {
        slot_node[slot] = nd[j];
        if (!together)
          copy_bytes(stage_bins + slot * p.bin_row_bytes, bins + r * p.bin_row_bytes,
                     p.bin_row_bytes);
        copy_bytes(stage_g + slot * p.val_bytes, g + r * p.val_bytes, p.val_bytes);
        copy_bytes(stage_h + slot * p.val_bytes, h + r * p.val_bytes, p.val_bytes);
      }
      for (int i0 = 0; i0 < 32 && together; i0 += per_step) {
        const int at = __shfl_sync(kFull, slot, min(i0 + sub, 31));
        if (sub < per_step && i0 + sub < 32 && at >= 0)
          reinterpret_cast<uint32_t*>(stage_bins + at * p.bin_row_bytes)[word] =
              reinterpret_cast<const uint32_t*>(bins + (r - lane + i0 + sub) *
                                                           p.bin_row_bytes)[word];
      }
      __syncwarp();  // every lane has read its node's rank
      if (nd[j] >= 0 && below == 0u) wrank[warp * K + nd[j]] += __popc(peers[j]);
      __syncwarp();
    }
    __syncthreads();
    const int staged = first[K];
    if (together) {
      for (int i = threadIdx.x; i < staged * words; i += kPartThreads) {
        const int slot = i / words, w = i - slot * words, k = slot_node[slot];
        const long long dst = base[k] + slot - first[k];
        reinterpret_cast<uint32_t*>(sbins + dst * p.bin_row_bytes)[w] =
            reinterpret_cast<const uint32_t*>(stage_bins + slot * p.bin_row_bytes)[w];
      }
    }
    for (int slot = threadIdx.x; slot < staged; slot += kPartThreads) {
      const int k = slot_node[slot];
      const long long dst = base[k] + slot - first[k];
      if (!together)
        copy_bytes(sbins + dst * p.bin_row_bytes, stage_bins + slot * p.bin_row_bytes,
                   p.bin_row_bytes);
      copy_bytes(sg + dst * p.val_bytes, stage_g + slot * p.val_bytes, p.val_bytes);
      copy_bytes(sh + dst * p.val_bytes, stage_h + slot * p.val_bytes, p.val_bytes);
    }
  }
}

// Shared memory of a scatter block staging `stage_rows` rows at K nodes.
size_t scatter_smem_bytes(int K, int stage_rows, int bin_row_bytes, int val_bytes) {
  return (size_t)4 * (kPartWarps * K + 3 * K + 1 + stage_rows) +
         (size_t)(stage_rows * bin_row_bytes + 15) / 16 * 16 + (size_t)2 * stage_rows * val_bytes;
}

// Count, scan and scatter of one launch: the node offsets and sorted copies.
int partition_launch(const PartParams& p, int folds, cudaStream_t stream) {
  const dim3 grid((unsigned)p.blocks, 1, (unsigned)folds);
  histogram_kernel_partition_count<<<grid, kPartThreads, p.K * sizeof(int), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  histogram_kernel_partition_scan<<<(unsigned)folds, kPartThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)scatter_smem_bytes(p.K, p.stage_rows, p.bin_row_bytes, p.val_bytes);
  err = cudaFuncSetAttribute(histogram_kernel_partition_scatter,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  histogram_kernel_partition_scatter<<<grid, kPartThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- leaf sums ----
//
// The level-wise grower's Newton leaves need, per fit k and final node s,
// the float64 sums of g and h over the rows that end there:
//   out[0, k, s] = sum of g[k, r] over the rows r with node[k, r] == s,
//   out[1, k, s] the same of h,  s in [0, segs)  (segs = NN + 1).
// A parked row (node -1) adds nothing. This replaces no TPU kernel: the
// JAX package's grower sums with a segment sum that XLA lowers. It replaces
// the port's plain version (ops/histogram.leaf_sums), two float64
// index_add_ calls that on this card make one global float64 atomic per row
// on one of at most 16 addresses, about 250x the bound below.
//
// Bound. One read of node (int32) and g, h (float32 or float64): at 10M rows
// in float32, 120 MB, 36 us at 3.35 TB/s. Two float64 adds a row are far
// below the card's float64 rate.
//
// Design. No atomic of any kind, so a call's sums are the same bits on
// every call (the grid depends only on the shape, the dtype and the card):
// 1. Each thread owns one float64 (g, h) pair per segment in shared memory,
//    laid out [segment][thread], and adds its rows into its own pairs with
//    a plain load and store: no contention however the rows fall, and a
//    warp's 32 pairs are 512 consecutive bytes whichever segments its rows
//    hit, so there are no bank conflicts.
// 2. A grid-stride loop over about one wave of resident blocks reads rows
//    as 16-byte vectors of 4 where node, g and h are 16-byte aligned (row by
//    row otherwise), the next vector's loads issued before this one's adds.
// 3. A block sums its threads' pairs per segment in a fixed order (one
//    warp a segment: a lane's threads in turn, then a butterfly over the
//    lanes) into one [2, tile] partial; leaf_sums_merge sums the blocks'
//    partials the same way, one warp per output.
// 4. A block holds tile = min(segs, 16) segments (64 KB of pairs at 256
//    threads, three blocks an SM). Deeper trees tile the segments over
//    blockIdx.z, each tile reading the rows again.

constexpr int kLeafThreads = 256;
constexpr int kLeafTile = 16;
constexpr int kLeafRowsPerThread = 4;  // one 16-byte vector of node ids

struct LeafParams {
  const int32_t* node;  // [folds, n]
  const void* g;        // [folds, n], float32 or float64
  const void* h;
  double* partial;      // [folds, tiles, blocks, 2, tile]
  double* out;          // [2, folds, segs]
  long long n;
  int folds, segs, tile, tiles, blocks;
};

// Four rows of g or h, loaded as 16-byte vectors and read as float64.
template <typename ValT>
struct Rows4;
template <>
struct Rows4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ double operator[](int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Rows4<double> {
  double2 a, b;
  __device__ __forceinline__ void load(const double* p) {
    a = reinterpret_cast<const double2*>(p)[0];
    b = reinterpret_cast<const double2*>(p)[1];
  }
  __device__ __forceinline__ double operator[](int i) const {
    return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? b.x : b.y;
  }
};

// A warp's sum of x over its lanes, the same bits in every lane.
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename ValT>
__global__ void __launch_bounds__(kLeafThreads) leaf_sums_partial(
    const __grid_constant__ LeafParams p) {
  extern __shared__ __align__(16) unsigned char leaf_smem[];
  double2* acc = reinterpret_cast<double2*>(leaf_smem);  // [tile][kLeafThreads]
  const int t = threadIdx.x;
  const long long fold = blockIdx.y;
  const int lo = blockIdx.z * p.tile;
  const int width = min(p.tile, p.segs - lo);
  double2* mine = acc + t;
  for (int s = 0; s < width; ++s) mine[s * kLeafThreads] = make_double2(0.0, 0.0);

  const int32_t* node = p.node + fold * p.n;
  const ValT* g = static_cast<const ValT*>(p.g) + fold * p.n;
  const ValT* h = static_cast<const ValT*>(p.h) + fold * p.n;
  auto add = [&](int nd, double gv, double hv) {
    const unsigned s = (unsigned)(nd - lo);  // parked (-1) or another tile: nothing
    if (s < (unsigned)width) {
      double2 a = mine[s * kLeafThreads];
      a.x += gv;
      a.y += hv;
      mine[s * kLeafThreads] = a;
    }
  };
  const long long first = (long long)blockIdx.x * kLeafThreads + t;
  const long long stride = (long long)gridDim.x * kLeafThreads;
  long long r0 = 0;
  if (((reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(h)) & 15u) == 0) {
    // Each step loads the thread's next 4 rows before it adds these, so two
    // steps' loads are in flight.
    const long long vecs = p.n / kLeafRowsPerThread;
    int4 nd = make_int4(-1, -1, -1, -1);
    Rows4<ValT> gv = {}, hv = {};
    auto load = [&](long long v, int4& n4, Rows4<ValT>& g4, Rows4<ValT>& h4) {
      n4 = reinterpret_cast<const int4*>(node)[v];
      g4.load(g + v * kLeafRowsPerThread);
      h4.load(h + v * kLeafRowsPerThread);
    };
    if (first < vecs) load(first, nd, gv, hv);
    for (long long v = first; v < vecs; v += stride) {
      int4 nd_next = nd;
      Rows4<ValT> gv_next = gv, hv_next = hv;
      if (v + stride < vecs) load(v + stride, nd_next, gv_next, hv_next);
      add(nd.x, gv[0], hv[0]);
      add(nd.y, gv[1], hv[1]);
      add(nd.z, gv[2], hv[2]);
      add(nd.w, gv[3], hv[3]);
      nd = nd_next;
      gv = gv_next;
      hv = hv_next;
    }
    r0 = vecs * kLeafRowsPerThread;
  }
  for (long long r = r0 + first; r < p.n; r += stride) add(node[r], (double)g[r], (double)h[r]);
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  double* part =
      p.partial + ((fold * p.tiles + blockIdx.z) * p.blocks + blockIdx.x) * 2LL * p.tile;
  for (int s = warp; s < width; s += kLeafThreads / 32) {
    double x = 0.0, y = 0.0;
    for (int i = lane; i < kLeafThreads; i += 32) {
      const double2 a = acc[s * kLeafThreads + i];
      x += a.x;
      y += a.y;
    }
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      part[s] = x;
      part[p.tile + s] = y;
    }
  }
}

// out[o], o = (q*folds + fold)*segs + s: the blocks' partials of (fold, s)
// and statistic q, summed by one warp in a fixed order.
__global__ void __launch_bounds__(kLeafThreads) leaf_sums_merge(
    const __grid_constant__ LeafParams p) {
  const long long o = ((long long)blockIdx.x * kLeafThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_q = (long long)p.folds * p.segs;
  if (o >= 2 * per_q) return;  // the whole warp
  const int q = (int)(o / per_q);
  const long long fold = (o - q * per_q) / p.segs;
  const int s = (int)(o - q * per_q - fold * p.segs);
  const int tile = s / p.tile;
  const double* part = p.partial + (fold * p.tiles + tile) * p.blocks * 2LL * p.tile +
                       q * p.tile + (s - tile * p.tile);
  double x = 0.0;
  for (int b = lane; b < p.blocks; b += 32) x += part[(long long)b * 2 * p.tile];
  x = warp_sum(x);
  if (lane == 0) p.out[o] = x;
}

// One call: the partial kernel's grid, a block per SM slot of one wave
// shared among the (fold, tile) pairs and no more than the rows fill, then
// the partial and merge kernels. The grid's blocks and the (fold, tile)
// pairs together never pass max(SM slots, pairs), so `partial_elems` of
// max(SMs * (threads an SM holds / kLeafThreads), folds * tiles) * 2 * tile
// always suffice; fewer is refused.
template <typename ValT>
int leaf_launch(LeafParams p, long long partial_elems, int device, cudaStream_t stream) {
  if (p.n < 0 || p.folds <= 0 || p.segs <= 0) return kErrBadArgument;
  p.tile = p.segs < kLeafTile ? p.segs : kLeafTile;
  p.tiles = (p.segs + p.tile - 1) / p.tile;
  if (p.tiles > kMaxGridYZ || p.folds > kMaxGridYZ) return kErrBadArgument;
  const size_t smem = (size_t)p.tile * kLeafThreads * sizeof(double2);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = leaf_sums_partial<ValT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLeafThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kLeafThreads * kLeafRowsPerThread;
  const long long groups = (long long)p.folds * p.tiles;
  const long long wave = (long long)(per_sm > 1 ? per_sm : 1) * sms / groups;
  const long long fill = (p.n + rows_per_block - 1) / rows_per_block;
  const long long blocks = wave < fill ? wave : fill;
  p.blocks = blocks > 1 ? (int)blocks : 1;
  if (partial_elems < groups * p.blocks * 2 * p.tile) return kErrBadArgument;

  const dim3 grid((unsigned)p.blocks, (unsigned)p.folds, (unsigned)p.tiles);
  kernel<<<grid, kLeafThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = 2LL * p.folds * p.segs;
  const long long merge_blocks = (warps + kLeafThreads / 32 - 1) / (kLeafThreads / 32);
  leaf_sums_merge<<<(unsigned)merge_blocks, kLeafThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
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

// Node mode's partitioned walk (note 5): the same inputs and output as
// histogram_launch's node mode (bins [folds, n, F] or shared, int32 node ids,
// g and h, strides in elements; out [folds, 4, K, F, B], zeroed by the
// caller), through the caller's scratch: sorted_bins [folds, n_pad, F] of
// the bins' dtype, sorted_g and sorted_h [folds, n_pad] of the values',
// counts [folds, K, ceil(n / 16384)] and offsets [folds, K + 1] int32, with
// n_pad >= n a multiple of 32. stage_rows (1024 or 2048) is a scatter
// block's sub-block; tile_features x B is a walk CTA's share of one node's
// cells, block_rows its staged block (ops/cuda_histogram.node_plan).
// out == nullptr: the partition alone (offsets and sorted copies). Four
// kernels on `stream` of CUDA device `device`, no synchronisation. Returns
// 0, a cudaError_t or a kErr* code.
int node_sorted_launch(const void* bins, int bin_dtype, long long bins_fold_stride,
                       const void* node, long long node_fold_stride, const void* g,
                       const void* h, int val_dtype, long long g_fold_stride,
                       long long h_fold_stride, void* sorted_bins, void* sorted_g,
                       void* sorted_h, long long n_pad, void* counts, void* offsets, void* out,
                       long long n, int F, int K, int B, int folds, int stage_rows,
                       int tile_features, int block_rows, int device, void* stream) {
  if (bins == nullptr || node == nullptr || g == nullptr || h == nullptr ||
      sorted_bins == nullptr || sorted_g == nullptr || sorted_h == nullptr ||
      counts == nullptr || offsets == nullptr || F <= 0 || B <= 0 || K < 1 ||
      K > kPartMaxNodes || folds <= 0 || folds > kMaxGridYZ || n < 0 || n >= (1LL << 31) ||
      n_pad < n || n_pad % 32 != 0 || tile_features <= 0 || block_rows <= 0 ||
      block_rows % 32 != 0 || bin_dtype < 0 || bin_dtype > 1 || val_dtype < 0 || val_dtype > 1 ||
      stage_rows % kPartThreads != 0 || stage_rows < kPartThreads ||
      stage_rows > kMaxStageChunks * kPartThreads)
    return kErrBadArgument;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tile_features > F) tile_features = F;
  const int bin_size = bin_dtype == 0 ? 1 : 4;
  const int val_size = val_dtype == 0 ? 4 : 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  PartParams q = {};
  q.bins = static_cast<const unsigned char*>(bins);
  q.node = static_cast<const int32_t*>(node);
  q.g = static_cast<const unsigned char*>(g);
  q.h = static_cast<const unsigned char*>(h);
  q.bins_fold_stride = bins_fold_stride * bin_size;
  q.node_fold_stride = node_fold_stride * 4;
  q.g_fold_stride = g_fold_stride * val_size;
  q.h_fold_stride = h_fold_stride * val_size;
  q.sorted_bins = static_cast<unsigned char*>(sorted_bins);
  q.sorted_g = static_cast<unsigned char*>(sorted_g);
  q.sorted_h = static_cast<unsigned char*>(sorted_h);
  q.counts = static_cast<int*>(counts);
  q.offsets = static_cast<int*>(offsets);
  q.n = n;
  q.n_pad = n_pad;
  q.K = K;
  q.blocks = (int)((n + kPartRows - 1) / kPartRows);
  q.bin_row_bytes = F * bin_size;
  q.val_bytes = val_size;
  q.stage_rows = stage_rows;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (scatter_smem_bytes(K, stage_rows, q.bin_row_bytes, val_size) + kScatterStaticBytes >
      (size_t)optin)
    return kErrSharedMemory;
  int code = partition_launch(q, folds, st);
  if (code != 0 || out == nullptr) return code;

  // The walk reads the sorted copies: bins, no key, g, h.
  Params p = {};
  const void* ptrs[kStreams] = {sorted_bins, nullptr, sorted_g, sorted_h};
  const int row_bytes[kStreams] = {F * bin_size, 0, val_size, val_size};
  int off = 0;
  for (int i = 0; i < kStreams; ++i) {
    Stream& s = p.stream[i];
    s.base = static_cast<const unsigned char*>(ptrs[i]);
    s.row_bytes = row_bytes[i];
    s.fold_stride = n_pad * row_bytes[i];
    s.smem_off = off;
    off += (block_rows * s.row_bytes + 15) / 16 * 16;
  }
  p.stage_bytes = off;
  p.out = out;
  p.out_fold_stride = 4LL * K * F * B;
  p.n = n;
  p.F = F;
  p.S = 4;
  p.KB = B;  // a CTA's cells are one node's
  p.B = B;
  p.K = K;
  p.tile_features = tile_features;
  p.tile_cells = B;
  p.block_rows = block_rows;
  p.offsets = q.offsets;
  return dispatch<kSorted>(p, bin_dtype, val_dtype, folds, device, st);
}

// out[0, k, s] and out[1, k, s]: the float64 sums of g[k, r] and h[k, r]
// over the rows with node[k, r] == s, s in [0, segs); node -1 adds nothing.
// node (int32), g and h (val_dtype 0 float32, 1 float64) are contiguous
// [folds, n]; `partial` holds `partial_elems` float64 elements of scratch
// (leaf_launch says how many suffice) and `out` 2*folds*segs. Two kernels on `stream` of CUDA device `device`, no
// synchronisation. Returns 0, a cudaError_t or a kErr* code.
int leaf_sums_launch(const void* node, const void* g, const void* h, int val_dtype,
                     void* partial, long long partial_elems, void* out, long long n, int folds,
                     int segs, int device, void* stream) {
  if (node == nullptr || g == nullptr || h == nullptr || partial == nullptr || out == nullptr)
    return kErrBadArgument;
  LeafParams p = {};
  p.node = static_cast<const int32_t*>(node);
  p.g = g;
  p.h = h;
  p.partial = static_cast<double*>(partial);
  p.out = static_cast<double*>(out);
  p.n = n;
  p.folds = folds;
  p.segs = segs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_dtype == 0) return leaf_launch<float>(p, partial_elems, device, st);
  if (val_dtype == 1) return leaf_launch<double>(p, partial_elems, device, st);
  return kErrBadArgument;
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
