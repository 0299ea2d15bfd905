// Per-(statistic, feature, cell) histograms for GBDT split search on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   machine_learning_replications_tpu/ops/pallas_histogram.py,
//   _stats_histograms (the pl.pallas_call) with body _histogram_kernel,
//   reached by stump_histograms_pallas on the fused depth-1 fit.
//
// Contract (the same as _stats_histograms):
//   out[s, f, seg[r] + bins[r, f]] += vals[r, s]        out: [S, F, KB]
// bins [n, F] uint8 or int32, seg [n] int32 (nullptr = all rows 0),
// vals [n, S] float or double, all row-major and contiguous. A cell outside
// [0, KB) contributes nothing, as in the TPU kernel's one-hot contraction.
// The caller zeroes `out`; the kernel adds into it.
//
// Design. The TPU kernel turns the scatter into one-hot x values matmuls on
// the MXU because TPU scatters serialise. Hopper has fast shared-memory
// atomics instead, so each CTA keeps a private S*F*KB histogram in shared
// memory (34.8 KB at the fused fit's S=2, F=17, KB=256 in float32), walks
// the flattened n*F (row, feature) elements with a grid-stride loop
// (neighbouring threads read neighbouring bin bytes, so the loads
// coalesce, and a warp's 32 elements span only two or three rows, so few
// of its lanes add into the same cell), adds each element's S statistics
// with shared atomicAdd, and finally merges its nonzero cells into `out`
// with one global atomicAdd each.
//
// Bound. One pass over the inputs: n*F bin ids plus n*S statistics, about
// 25 MB at n = 1M, F = 17, u8 bins, S = 2 float32, i.e. some 7.5 us at
// 3.35 TB/s; the n*F*S additions are far below the card's float rate, so
// the kernel is bound by bytes. In practice shared-atomic contention is the
// limit: 14 of the fit's 17 features are binary, so their rows pile onto
// two addresses per feature. Float atomics also make the summation order
// (and so the last bits) vary from run to run; results are held to the
// plain version at a tolerance, never bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kErrSharedMemory = 1000001;  // S*F*KB*itemsize over the budget
constexpr int kErrBadArgument = 1000002;

template <typename BinT, typename ValT>
__global__ void __launch_bounds__(kThreads)
stats_histograms_kernel(const BinT* __restrict__ bins,
                        const int32_t* __restrict__ seg,
                        const ValT* __restrict__ vals,
                        ValT* __restrict__ out,
                        long long n, int F, int S, int KB) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ValT* hist = reinterpret_cast<ValT*>(smem_raw);
  const int cells = S * F * KB;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = ValT(0);
  __syncthreads();

  // Element e = r*F + f. The stride is split once into whole rows (dr) and
  // leftover features (df), so the loop carries (r, f) without a division.
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long dr = stride / F;
  const int df = (int)(stride - dr * F);
  const long long e0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long r = e0 / F;
  int f = (int)(e0 - r * F);
  while (r < n) {
    const int cell = (seg ? seg[r] : 0) + (int)bins[r * F + f];
    if (cell >= 0 && cell < KB) {
      const ValT* v = vals + r * S;
      ValT* h = hist + f * KB + cell;
      for (int s = 0; s < S; ++s) {
        const ValT x = v[s];
        if (x != ValT(0)) atomicAdd(h + s * F * KB, x);
      }
    }
    r += dr;
    f += df;
    if (f >= F) {
      f -= F;
      ++r;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const ValT x = hist[i];
    if (x != ValT(0)) atomicAdd(out + i, x);
  }
}

template <typename BinT, typename ValT>
int launch(const void* bins, const int32_t* seg, const void* vals, void* out,
           long long n, int F, int S, int KB, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const size_t smem = (size_t)S * F * KB * sizeof(ValT);
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

  // Enough CTAs to fill every SM once; more would only add merge atomics.
  const long long need = (n * (long long)F + kThreads - 1) / kThreads;
  long long grid = (long long)per_sm * sms;
  if (need < grid) grid = need;
  stats_histograms_kernel<BinT, ValT><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), seg, static_cast<const ValT*>(vals),
      static_cast<ValT*>(out), n, F, S, KB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_dtype: 0 = uint8, 1 = int32; val_dtype: 0 = float32, 1 = float64.
// Launches on `stream` of CUDA device `device` and does not synchronise.
// Returns 0 on success, a cudaError_t, or one of the kErr* codes above.
int stats_histograms_launch(const void* bins, int bin_dtype, const int32_t* seg,
                            const void* vals, int val_dtype, void* out,
                            long long n, int F, int S, int KB, int device,
                            void* stream) {
  if (F <= 0 || S <= 0 || KB <= 0) return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_dtype == 0 && val_dtype == 0)
    return launch<uint8_t, float>(bins, seg, vals, out, n, F, S, KB, device, st);
  if (bin_dtype == 0 && val_dtype == 1)
    return launch<uint8_t, double>(bins, seg, vals, out, n, F, S, KB, device, st);
  if (bin_dtype == 1 && val_dtype == 0)
    return launch<int32_t, float>(bins, seg, vals, out, n, F, S, KB, device, st);
  if (bin_dtype == 1 && val_dtype == 1)
    return launch<int32_t, double>(bins, seg, vals, out, n, F, S, KB, device, st);
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
  if (code == kErrSharedMemory) return "histogram does not fit in shared memory";
  if (code == kErrBadArgument) return "bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
