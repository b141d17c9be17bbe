// K-STEP: one whole TFHE blind-rotation step (tggsw.cmux_rotate for k=1,
// d=1), in place on the accumulator, one thread block per ciphertext:
//
//   acc += (X^s - 1) (*) ExtProd(brk_i, acc),   s = a2n[b, i] mod 2N
//
// Replaces the Pallas step kernel bench/pallas_step_experiment.py:118-198
// (step_kernel, pl.pallas_call at :202), which never compiled on the TPU:
// it kept the whole batch's (N, B) planes of every stage live in VMEM at
// once. On Hopper a block owns one ciphertext instead, so the working
// set is per ciphertext and lives in shared memory:
//   dig  (2, N) u32             the gadget digits of a and b       16 KB
//   work (K, 2, N) u32          per prime: the digit residues, their NTTs,
//                               the contracted and rotated products, and
//                               after the INTT the coefficient residues
//                               that Garner reads                   64 KB
// i.e. 80 KB at N=2048, K=4, which needs the opt-in above 48 KB.
//
// Stages per block: the digit of each coefficient's high word (the u32 form
// of decompose_t64, rounding_bits >= 33); then per prime: sign-fold, forward
// NTT of both rows, the Shoup contraction with the step's key rows summed
// mod q, the monomial as mv*e - e with row s of the (K, 2N, N) table read
// straight from device memory (no gathered copy), the inverse NTT of both
// rows; then Garner across the primes and acc.a += da, acc.b += db.
//
// What bounds it on an H100: the 128 blocks of a batch fill 128 of the 132
// SMs once, and each runs 16 transforms of 2048 points with a barrier per
// layer, so the step is latency- and issue-bound inside each SM rather than
// bound by memory: per step the device reads the key (256 KB with duals,
// shared by all blocks through L2), 64 KB of monomial rows and 32 KB of
// accumulator per ciphertext, and writes the accumulator back. Keeping the
// accumulator in shared memory across steps (a persistent kernel),
// warp-shuffle layers and CUDA graphs for the host loop are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt32.cuh"
#include "torus_crt.cuh"

namespace {

constexpr int kThreads = 512;

// First (and, with d=1, only) signed digit of a torus value from its high
// word: decompose_t64_u32 of learn_fhe_tpu/ops/gadget.py:175-197, returned
// as a two's-complement u32.
__device__ __forceinline__ uint32_t gadget_digit(int64_t x, int log_b, int rounding_bits) {
  const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
  uint32_t v = (hi + (1u << (rounding_bits - 33))) >> (rounding_bits - 32);
  const uint32_t limb = v & ((1u << log_b) - 1u);
  v >>= log_b;
  const uint32_t carry = (((limb - 1u) | v) & limb) >> (log_b - 1);
  return limb - (carry << log_b);
}

__global__ void __launch_bounds__(kThreads)
    tfhe_step_kernel(int64_t* __restrict__ acc_a, int64_t* __restrict__ acc_b,
                     const int64_t* __restrict__ exps, const uint32_t* __restrict__ av,
                     const uint32_t* __restrict__ ad, const uint32_t* __restrict__ bv,
                     const uint32_t* __restrict__ bd, const uint32_t* __restrict__ mon_v,
                     const uint32_t* __restrict__ mon_d, const uint32_t* __restrict__ psi,
                     const uint32_t* __restrict__ psi_s, const uint32_t* __restrict__ psi_inv,
                     const uint32_t* __restrict__ psi_inv_s, int log_n, int log_b,
                     int rounding_bits, lft::CrtConsts g) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << log_n;
  const int n2 = 2 * n;
  uint32_t* dig = sh;
  uint32_t* work = sh + n2;
  int64_t* pa = acc_a + (static_cast<size_t>(blockIdx.x) << log_n);
  int64_t* pb = acc_b + (static_cast<size_t>(blockIdx.x) << log_n);
  const int s = static_cast<int>(exps[blockIdx.x] % n2);  // exps in [0, 2N]

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    dig[j] = gadget_digit(pa[j], log_b, rounding_bits);
    dig[n + j] = gadget_digit(pb[j], log_b, rounding_bits);
  }
  __syncthreads();

  for (int p = 0; p < g.k; ++p) {
    const uint32_t q = g.q[p];
    uint32_t* w = work + p * n2;
    for (int j = threadIdx.x; j < n2; j += blockDim.x) w[j] = lft::sign_fold(dig[j], q);
    __syncthreads();
    lft::ntt_fwd_rows(w, 2, log_n, psi + p * n, psi_s + p * n, q);

    // this step's key rows under prime p: (R=2, N) each for a and b
    const uint32_t* kav = av + static_cast<size_t>(p) * n2;
    const uint32_t* kad = ad + static_cast<size_t>(p) * n2;
    const uint32_t* kbv = bv + static_cast<size_t>(p) * n2;
    const uint32_t* kbd = bd + static_cast<size_t>(p) * n2;
    // row s of prime p's (2N, N) monomial table
    const size_t mon = (static_cast<size_t>(p) * n2 + s) << log_n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const uint32_t e0 = w[j];
      const uint32_t e1 = w[n + j];
      const uint32_t ea = lft::add_mod(lft::mul_shoup(e0, kav[j], kad[j], q),
                                       lft::mul_shoup(e1, kav[n + j], kad[n + j], q), q);
      const uint32_t eb = lft::add_mod(lft::mul_shoup(e0, kbv[j], kbd[j], q),
                                       lft::mul_shoup(e1, kbv[n + j], kbd[n + j], q), q);
      const uint32_t mv = mon_v[mon + j];
      const uint32_t md = mon_d[mon + j];
      w[j] = lft::sub_mod(lft::mul_shoup(ea, mv, md, q), ea, q);
      w[n + j] = lft::sub_mod(lft::mul_shoup(eb, mv, md, q), eb, q);
    }
    __syncthreads();
    lft::ntt_inv_rows(w, 2, log_n, psi_inv + p * n, psi_inv_s + p * n, q, g.n_inv[p],
                      g.n_inv_s[p]);
  }

  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    uint32_t c[lft::kMaxPrimes];
#pragma unroll
    for (int i = 0; i < lft::kMaxPrimes; ++i) c[i] = i < g.k ? work[i * n2 + j] : 0u;
    const uint64_t delta = lft::garner(c, g);
    int64_t* dst = j < n ? pa + j : pb + (j - n);
    *dst = static_cast<int64_t>(static_cast<uint64_t>(*dst) + delta);
  }
}

}  // namespace

extern "C" int lft_tfhe_step(void* acc_a, void* acc_b, const void* exps, int batch,
                             const void* av, const void* ad, const void* bv, const void* bd,
                             const void* mon_v, const void* mon_d, const void* psi,
                             const void* psi_s, const void* psi_inv, const void* psi_inv_s,
                             int log_n, int log_b, int rounding_bits,
                             const unsigned long long* consts, void* stream) {
  const lft::CrtConsts g = lft::load_crt_consts(consts);
  const size_t smem = (sizeof(uint32_t) * (2 + 2 * static_cast<size_t>(g.k))) << log_n;
  static size_t smem_configured = 0;
  if (smem > smem_configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tfhe_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured = smem;
  }
  tfhe_step_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(acc_a), static_cast<int64_t*>(acc_b),
      static_cast<const int64_t*>(exps), static_cast<const uint32_t*>(av),
      static_cast<const uint32_t*>(ad), static_cast<const uint32_t*>(bv),
      static_cast<const uint32_t*>(bd), static_cast<const uint32_t*>(mon_v),
      static_cast<const uint32_t*>(mon_d), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_s), static_cast<const uint32_t*>(psi_inv),
      static_cast<const uint32_t*>(psi_inv_s), log_n, log_b, rounding_bits, g);
  return static_cast<int>(cudaGetLastError());
}
