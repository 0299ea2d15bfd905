// Per-(statistic, feature, cell) histograms for GBDT split search on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   machine_learning_replications_tpu/ops/pallas_histogram.py,
//   _stats_histograms (the pl.pallas_call) with body _histogram_kernel,
//   reached by stump_histograms_pallas on the fused depth-1 fit and by
//   node_histograms_pallas on the level-wise tree grower.
//
// Contract (the same as _stats_histograms, with an optional fold axis):
//   out[k, s, f, seg[k, r] + bins[k, r, f]] += vals[k, r, s]   out: [folds, S, F, KB]
// bins [n, F] (shared by every fold: bins_fold_stride = 0) or [folds, n, F]
// (bins_fold_stride = n*F), uint8 or int32; seg [folds, n] int32 (nullptr =
// all rows 0); vals [folds, n, S] float or double; all row-major and
// contiguous. A cell outside [0, KB) contributes nothing, as in the TPU
// kernel's one-hot contraction. The caller zeroes `out`; the kernel adds
// into it.
//
// Design. The TPU kernel turns the scatter into one-hot x values matmuls on
// the MXU because TPU scatters serialise. Hopper has fast shared-memory
// atomics instead, so each CTA keeps a private histogram in shared memory,
// walks the flattened (row, feature) elements with a grid-stride loop
// (neighbouring threads read neighbouring bin bytes, so the loads coalesce,
// and a warp's 32 elements span only a few rows, so few of its lanes add
// into the same cell), adds each element's S statistics with shared
// atomicAdd, and finally merges its nonzero cells into `out` with one global
// atomicAdd each. Zero statistics are skipped, so rows parked at an ancestor
// leaf (their vals are zero) cost a load and no atomic.
//
// Tiling. The whole S*F*KB histogram fits one CTA's shared memory only at
// small depths (the fused fit's S=2, F=17, KB=256 float32 is 34.8 KB; the
// depth-3 grower's last level, S=4, KB=4*256, is 278.5 KB, over the 227 KB a
// CTA may opt in to). So the [F, KB] cell space is cut into tiles of
// tile_features features x tile_cells cells, chosen by the caller to fit the
// budget (features first; cell ranges only where one feature alone is too
// large). blockIdx.y is the tile, blockIdx.z the fold; each CTA walks every
// row of its fold but only its tile's features, and skips cells outside its
// range. With one tile and one fold this is exactly the untiled kernel.
//
// Bound. One pass over the inputs: n*F bin ids plus n*S statistics (and n
// segment ids), about 25 MB at the fused fit's n = 1M, F = 17, u8 bins,
// S = 2 float32, i.e. some 7.5 us at 3.35 TB/s; the n*F*S additions are far
// below the card's float rate, so the kernel is bound by bytes. In practice
// shared-atomic contention is the limit: 14 of the fit's 17 features are
// binary, so their rows pile onto two addresses per feature and node. Cell
// tiles re-read the rows once per tile. Float atomics also make the
// summation order (and so the last bits) vary from run to run; results are
// held to the plain version at a tolerance, never bit for bit. Counts (sums
// of 1.0 below 2^24 per cell) are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kErrSharedMemory = 1000001;  // S*tile_features*tile_cells*itemsize over the budget
constexpr int kErrBadArgument = 1000002;
constexpr int kMaxGridYZ = 65535;

template <typename BinT, typename ValT>
__global__ void __launch_bounds__(kThreads)
stats_histograms_kernel(const BinT* __restrict__ bins,
                        const int32_t* __restrict__ seg,
                        const ValT* __restrict__ vals,
                        ValT* __restrict__ out,
                        long long n, int F, int S, int KB,
                        long long bins_fold_stride, int tile_features, int tile_cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ValT* hist = reinterpret_cast<ValT*>(smem_raw);

  // This CTA's fold and tile: features [f_lo, f_lo + tfw), cells [c_lo, c_lo + tcw).
  const long long fold = blockIdx.z;
  bins += fold * bins_fold_stride;
  if (seg) seg += fold * n;
  vals += fold * n * S;
  out += fold * (long long)S * F * KB;
  const int cell_tiles = (KB + tile_cells - 1) / tile_cells;
  const int f_lo = (blockIdx.y / cell_tiles) * tile_features;
  const int c_lo = (blockIdx.y % cell_tiles) * tile_cells;
  const int tfw = min(tile_features, F - f_lo);
  const int tcw = min(tile_cells, KB - c_lo);
  const int plane = tfw * tcw;  // one statistic's cells in this tile
  const int cells = S * plane;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = ValT(0);
  __syncthreads();

  // Element e = r*tfw + j (feature f_lo + j). The stride is split once into
  // whole rows (dr) and leftover features (dj), so the loop carries (r, j)
  // without a division.
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long dr = stride / tfw;
  const int dj = (int)(stride - dr * tfw);
  const long long e0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long r = e0 / tfw;
  int j = (int)(e0 - r * tfw);
  while (r < n) {
    const int cell = (seg ? seg[r] : 0) + (int)bins[r * F + f_lo + j] - c_lo;
    if ((unsigned)cell < (unsigned)tcw) {
      const ValT* v = vals + r * S;
      ValT* h = hist + j * tcw + cell;
      for (int s = 0; s < S; ++s) {
        const ValT x = v[s];
        if (x != ValT(0)) atomicAdd(h + s * plane, x);
      }
    }
    r += dr;
    j += dj;
    if (j >= tfw) {
      j -= tfw;
      ++r;
    }
  }
  __syncthreads();

  // Local cell i = (s*tfw + j)*tcw + c → out[s, f_lo + j, c_lo + c]; with a
  // single tile this is out[i].
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const ValT x = hist[i];
    if (x != ValT(0)) {
      const int sj = i / tcw;
      const int c = i - sj * tcw;
      const int s = sj / tfw;
      const int jj = sj - s * tfw;
      atomicAdd(out + ((long long)s * F + f_lo + jj) * KB + c_lo + c, x);
    }
  }
}

template <typename BinT, typename ValT>
int launch(const void* bins, const int32_t* seg, const void* vals, void* out,
           long long n, int F, int S, int KB, int folds, long long bins_fold_stride,
           int tile_features, int tile_cells, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || folds <= 0) return 0;
  if (tile_features > F) tile_features = F;
  if (tile_cells > KB) tile_cells = KB;
  const long long tiles = (long long)((F + tile_features - 1) / tile_features) *
                          ((KB + tile_cells - 1) / tile_cells);
  if (tiles > kMaxGridYZ || folds > kMaxGridYZ) return kErrBadArgument;
  const size_t smem = (size_t)S * tile_features * tile_cells * sizeof(ValT);
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return kErrSharedMemory;

  err = cudaFuncSetAttribute(stats_histograms_kernel<BinT, ValT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stats_histograms_kernel<BinT, ValT>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;

  // Enough CTAs to fill every SM once, shared among the (tile, fold) pairs;
  // more would only add merge atomics.
  const long long groups = tiles * folds;
  const long long need = (n * (long long)tile_features + kThreads - 1) / kThreads;
  long long grid = (long long)per_sm * sms / groups;
  if (grid < 1) grid = 1;
  if (need < grid) grid = need;
  const dim3 blocks((unsigned)grid, (unsigned)tiles, (unsigned)folds);
  stats_histograms_kernel<BinT, ValT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), seg, static_cast<const ValT*>(vals),
      static_cast<ValT*>(out), n, F, S, KB, bins_fold_stride, tile_features, tile_cells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_dtype: 0 = uint8, 1 = int32; val_dtype: 0 = float32, 1 = float64.
// tile_features x tile_cells is one CTA's share of the [F, KB] cell space
// (ops/cuda_histogram.tile_plan picks it to fit the shared-memory budget).
// Launches on `stream` of CUDA device `device` and does not synchronise.
// Returns 0 on success, a cudaError_t, or one of the kErr* codes above.
int stats_histograms_launch(const void* bins, int bin_dtype, const int32_t* seg,
                            const void* vals, int val_dtype, void* out,
                            long long n, int F, int S, int KB, int folds,
                            long long bins_fold_stride, int tile_features, int tile_cells,
                            int device, void* stream) {
  if (F <= 0 || S <= 0 || KB <= 0 || tile_features <= 0 || tile_cells <= 0)
    return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_dtype == 0 && val_dtype == 0)
    return launch<uint8_t, float>(bins, seg, vals, out, n, F, S, KB, folds, bins_fold_stride,
                                  tile_features, tile_cells, device, st);
  if (bin_dtype == 0 && val_dtype == 1)
    return launch<uint8_t, double>(bins, seg, vals, out, n, F, S, KB, folds, bins_fold_stride,
                                   tile_features, tile_cells, device, st);
  if (bin_dtype == 1 && val_dtype == 0)
    return launch<int32_t, float>(bins, seg, vals, out, n, F, S, KB, folds, bins_fold_stride,
                                  tile_features, tile_cells, device, st);
  if (bin_dtype == 1 && val_dtype == 1)
    return launch<int32_t, double>(bins, seg, vals, out, n, F, S, KB, folds, bins_fold_stride,
                                   tile_features, tile_cells, device, st);
  return kErrBadArgument;
}

// Shared memory one CTA may opt in to on `device` (bytes), or -1.
int stats_histograms_smem_budget(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return optin;
}

const char* stats_histograms_error_string(int code) {
  if (code == kErrSharedMemory) return "histogram tile does not fit in shared memory";
  if (code == kErrBadArgument) return "bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
