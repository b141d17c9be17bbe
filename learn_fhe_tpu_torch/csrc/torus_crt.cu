// K-GARNER: CRT residues (K, count) -> wrapping u64 values, one thread per
// coefficient (device code in torus_crt.cuh).
//
// There is no Pallas kernel of its own: the same computation is the tail of
// the Pallas step kernel (bench/pallas_step_experiment.py:158-188, launched
// at :202) and of every torus product in the JAX package. Standalone it
// serves key generation's torus products (after the polymul kernel).
//
// What bounds it on an H100: it reads 4 B per prime and writes 8 B per
// coefficient, and does about k^2/2 Shoup products, so it is memory-bound;
// consecutive threads touch consecutive coefficients, so every access is
// coalesced. That is all this kernel needs.
#include <cuda_runtime.h>

#include <cstdint>

#include "torus_crt.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    garner_kernel(const uint32_t* __restrict__ res, uint64_t* __restrict__ out, long long count,
                  lft::CrtConsts g) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < count;
       e += stride) {
    uint32_t c[lft::kMaxPrimes];
#pragma unroll
    for (int i = 0; i < lft::kMaxPrimes; ++i) c[i] = i < g.k ? res[i * count + e] : 0u;
    out[e] = lft::garner(c, g);
  }
}

}  // namespace

extern "C" int lft_garner_to_u64(const void* residues, void* out, long long count,
                                 const unsigned long long* consts, void* stream) {
  const lft::CrtConsts g = lft::load_crt_consts(consts);
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  garner_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(residues), static_cast<uint64_t*>(out), count, g);
  return static_cast<int>(cudaGetLastError());
}
