// K-GARNER: CRT residues (K, count) -> wrapping u64 values, one thread per
// coefficient (device code in torus_crt.cuh).
//
// There is no Pallas kernel of its own: the same computation is the tail of
// the Pallas step kernel (bench/pallas_step_experiment.py:158-188, launched
// at :202) and of every torus product in the JAX package. Standalone it
// serves key generation's torus products (after the polymul kernel) and the
// exact ring products of ops/ring_mul.py, which need up to 5 primes.
//
// What bounds it on an H100: it reads 4 B per prime and writes 8 B per
// coefficient, and does about k^2/2 Shoup products, so it is memory-bound;
// consecutive threads touch consecutive coefficients, so every access is
// coalesced. One instance per prime count K = 1..5, so that a thread holds
// exactly K residues and the walk is unrolled for K; K-STEP keeps its own
// 4-prime constants (lft::CrtConsts).
#include <cuda_runtime.h>

#include <cstdint>

#include "torus_crt.cuh"

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
    garner_kernel(const uint32_t* __restrict__ res, uint64_t* __restrict__ out, long long count,
                  lft::CrtConstsOf<K> g) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < count;
       e += stride) {
    uint32_t c[K];
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = res[i * count + e];
    out[e] = lft::garner(c, g);
  }
}

template <int K>
int launch_garner(const void* residues, void* out, long long count, const unsigned long long* consts,
                  cudaStream_t stream) {
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  garner_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(residues), static_cast<uint64_t*>(out), count,
      lft::load_crt_consts<K>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lft_garner_to_u64(const void* residues, void* out, long long count,
                                 const unsigned long long* consts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (consts[0]) {
    case 1: return launch_garner<1>(residues, out, count, consts, s);
    case 2: return launch_garner<2>(residues, out, count, consts, s);
    case 3: return launch_garner<3>(residues, out, count, consts, s);
    case 4: return launch_garner<4>(residues, out, count, consts, s);
    case 5: return launch_garner<5>(residues, out, count, consts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
