// K-NTT and K-POLYMUL: batched negacyclic NTT, inverse NTT and polynomial
// product mod one prime q < 2^31, one thread block per row.
//
// Replaces the Pallas kernels of bench/pallas_ntt14_experiment.py:
//   forward NTT   <- make_kernels.call_fwd      (pl.pallas_call at :166)
//   polymul       <- make_kernels.call_polymul  (pl.pallas_call at :183),
//                    whose inverse half is the inverse NTT here.
// The Pallas kernels load a batch tile into VMEM once and run every layer
// there, with dense per-position twiddle rows. Here a block loads its row
// (8 KB at N=2048) into shared memory once, runs all log N layers there with
// one __syncthreads() per layer, and reads each layer's twiddles from the
// plan's bit-reversed table (L1/L2-resident, 16 KB per prime with duals).
//
// What bounds it on an H100: a transform moves 2 x 4 B per coefficient
// through device memory and does log N Shoup butterflies per pair, so at
// N=2048 it is about 22 integer multiplies per byte; with one row per block
// the layers' barriers and the narrow block (256 threads for 1024
// butterflies) leave the SM mostly waiting. Warp-shuffle layers, several
// rows per block and vectorised loads are later work; this version is the
// simple, exact one.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt32.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ntt32_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_s,
                     int log_n, uint32_t q) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) sh[j] = x[base + j];
  __syncthreads();
  lft::ntt_fwd_rows(sh, 1, log_n, psi, psi_s, q);
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[base + j] = sh[j];
}

__global__ void __launch_bounds__(kThreads)
    ntt32_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi_inv, const uint32_t* __restrict__ psi_inv_s,
                     int log_n, uint32_t q, uint32_t n_inv, uint32_t n_inv_s) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) sh[j] = x[base + j];
  __syncthreads();
  lft::ntt_inv_rows(sh, 1, log_n, psi_inv, psi_inv_s, q, n_inv, n_inv_s);
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[base + j] = sh[j];
}

// y = INTT(NTT(a) * NTT(b)) for one row per block; both operands stay in
// shared memory (2 x 8 KB at N=2048) from load to store.
__global__ void __launch_bounds__(kThreads)
    negacyclic_mul32_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ y, const uint32_t* __restrict__ psi,
                            const uint32_t* __restrict__ psi_s,
                            const uint32_t* __restrict__ psi_inv,
                            const uint32_t* __restrict__ psi_inv_s, int log_n, uint32_t q,
                            uint32_t n_inv, uint32_t n_inv_s) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sh[j] = a[base + j];
    sh[n + j] = b[base + j];
  }
  __syncthreads();
  lft::ntt_fwd_rows(sh, 2, log_n, psi, psi_s, q);
  for (int j = threadIdx.x; j < n; j += blockDim.x) sh[j] = lft::mul_mod(sh[j], sh[n + j], q);
  __syncthreads();
  lft::ntt_inv_rows(sh, 1, log_n, psi_inv, psi_inv_s, q, n_inv, n_inv_s);
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[base + j] = sh[j];
}

}  // namespace

extern "C" {

const char* lft_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int lft_ntt32_fwd(const void* x, void* y, const void* psi, const void* psi_s, int rows, int log_n,
                  unsigned int q, void* stream) {
  const size_t smem = sizeof(uint32_t) << log_n;
  ntt32_fwd_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s), log_n, q);
  return static_cast<int>(cudaGetLastError());
}

int lft_ntt32_inv(const void* x, void* y, const void* psi_inv, const void* psi_inv_s, int rows,
                  int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                  void* stream) {
  const size_t smem = sizeof(uint32_t) << log_n;
  ntt32_inv_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_s), log_n, q,
      n_inv, n_inv_s);
  return static_cast<int>(cudaGetLastError());
}

int lft_negacyclic_mul32(const void* a, const void* b, void* y, const void* psi,
                         const void* psi_s, const void* psi_inv, const void* psi_inv_s, int rows,
                         int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                         void* stream) {
  const size_t smem = (2 * sizeof(uint32_t)) << log_n;
  negacyclic_mul32_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(y), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_s), static_cast<const uint32_t*>(psi_inv),
      static_cast<const uint32_t*>(psi_inv_s), log_n, q, n_inv, n_inv_s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
