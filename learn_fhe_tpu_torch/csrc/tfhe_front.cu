// K-TFHE-PRE: the front of a TFHE PBS chunk, one launch before the blind
// rotation's steps (models/tfhe/bootstrapping.py::blind_rotate_front).
//
// Replaces the JAX package's XLA stages learn_fhe_tpu/parallel/batch.py:64 ->
// learn_fhe_tpu/models/tfhe/bootstrapping.py:90 `mod_switch_2n` and the front
// of the jitted `blind_rotate` (:100), :121-141: the zero accumulator and
// `jax.vmap(tglwe.rotate)` by -b (tglwe.py:88, ops/poly.py:82
// `monomial_mul_t64`). It writes the three tensors the step kernel starts
// from:
//   exps (n, B) int64: the exponents, transposed, row i holding step i's;
//   acc.a (B, k, N) int64: zeros;
//   acc.b (B, N) int64: v_enc * X^((-b2n) mod 2N), the negacyclic rotation
//     with wrapping negation: out[j] = v[(j - r) mod N], negated where
//     (s < N) ? j < r : j >= r, with s = (-b2n) mod 2N and r = s mod N;
//     v_enc = v << v_shift, so the LUT's encode (tglwe.encode, << log_delta)
//     rides in the same launch (v_shift 0: v is encoded already).
// SWITCH = true reads the torus ciphertext's u64 words and rounds them as
// mod_switch_2n does, (x + 2^(bits-1)) >> bits as a logical u64 shift with
// a wrapping add, bits = 64 - log2(2N) (the wrap keeps the result below 2N).
// SWITCH = false reads exponents that are already switched, any int64:
// exps keeps them as they are (2N unreduced), b's rotation takes b mod 2N.
//
// What bounds it on an H100: bytes, and in practice the launch. At the
// reference fixture (B = 128, n = 1024, N = 2048, k = 1) it reads 1.05 MB
// of a and writes 1.05 MB of exps and 4.19 MB of acc: 1.9 us at 3.35 TB/s,
// of the order of an empty kernel's launch from a CUDA graph.
//
// Design: a grid of 32 x 32 tiles of (B, n). A block loads its tile of a
// row by row (coalesced), rounds it into shared memory (33-word rows, so
// the transposed reads fall in distinct banks), and writes the tile
// transposed, again row by row. Then every block writes an equal slice of
// acc.b and of acc.a's zeros, so the 4.19 MB of acc spread over all the
// blocks and no block column carries them alone. acc.b's values are read
// from v (N,) as they are rotated: consecutive threads read consecutive
// words of v, so the (B, N) broadcast of v is never made.
//
// Why a launch of its own and not a prologue of K-STEP: the step kernel
// was redesigned for its own loop (a cluster of 4 blocks a ciphertext, one
// launch a step) and reads acc from device memory in every step; folding
// this front into its first step is a question for a later redesign.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kPass = 8;  // rows of the tile a pass: blocks of 32 x 8 threads
constexpr int kThreads = kTile * kPass;

struct Front {
  int batch, n, log_n, k, bits, v_shift;
};

template <bool SWITCH>
__device__ __forceinline__ long long exponent(uint64_t x, int bits) {
  if (SWITCH) return static_cast<long long>((x + ((1ull << bits) >> 1)) >> bits);
  return static_cast<long long>(x);
}

template <bool SWITCH>
__global__ void __launch_bounds__(kThreads)
    tfhe_front_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                      const uint64_t* __restrict__ v, long long* __restrict__ exps,
                      long long* __restrict__ acc_a, long long* __restrict__ acc_b, Front p) {
  __shared__ long long tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
#pragma unroll
  for (int j = ty; j < kTile; j += kPass) {
    const int r = row0 + j, c = col0 + tx;
    if (r < p.batch && c < p.n) tile[j][tx] = exponent<SWITCH>(__ldg(a + static_cast<size_t>(r) * p.n + c), p.bits);
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < kTile; j += kPass) {
    const int c = col0 + j, r = row0 + tx;
    if (r < p.batch && c < p.n) exps[static_cast<size_t>(c) * p.batch + r] = tile[tx][j];
  }

  // this block's slice of acc.b and of acc.a
  const long long blocks = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long block = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int tid = ty * kTile + tx;
  const int big_n = 1 << p.log_n, two_n = 2 * big_n;
  const long long total_b = static_cast<long long>(p.batch) << p.log_n;
  const long long b1 = total_b * (block + 1) / blocks;
  for (long long idx = total_b * block / blocks + tid; idx < b1; idx += kThreads) {
    const int r = static_cast<int>(idx >> p.log_n), j = static_cast<int>(idx & (big_n - 1));
    long long s = -exponent<SWITCH>(__ldg(b + r), p.bits) % two_n;
    s += s < 0 ? two_n : 0;
    const int rot = static_cast<int>(s) & (big_n - 1);
    const bool neg = s < big_n ? j < rot : j >= rot;
    const uint64_t x = __ldg(v + ((j - rot) & (big_n - 1))) << p.v_shift;
    acc_b[idx] = static_cast<long long>(neg ? 0ull - x : x);
  }
  const long long total_a = total_b * p.k;
  const long long a1 = total_a * (block + 1) / blocks;
  for (long long idx = total_a * block / blocks + tid; idx < a1; idx += kThreads) acc_a[idx] = 0;
}

}  // namespace

extern "C" {

// a (batch, n) and b (batch,): torus words (do_switch) or exponents; v
// (2^log_n,) the LUT, encoded when v_shift is 0; exps (n, batch), acc_a (batch, k, 2^log_n),
// acc_b (batch, 2^log_n), all int64. bits = 64 - log2(2N), read when
// do_switch; v_shift: the LUT's encode, 0 for a v encoded already.
int lft_tfhe_front(const void* a, const void* b, const void* v, void* exps, void* acc_a, void* acc_b, int batch,
                   int n, int log_n, int k, int bits, int do_switch, int v_shift, void* stream) {
  if (batch < 1 || n < 1 || log_n < 0 || log_n > 24 || k < 1 || (do_switch && (bits < 1 || bits > 63)) ||
      v_shift < 0 || v_shift > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  const Front p{batch, n, log_n, k, bits, v_shift};
  const dim3 grid((n + kTile - 1) / kTile, (batch + kTile - 1) / kTile), block(kTile, kPass);
  const auto kernel = do_switch ? tfhe_front_kernel<true> : tfhe_front_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b), static_cast<const uint64_t*>(v),
      static_cast<long long*>(exps), static_cast<long long*>(acc_a), static_cast<long long*>(acc_b), p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
