// K-NTT64 and K-POLYMUL64: batched negacyclic NTT, inverse NTT and
// polynomial product mod one odd prime q < 2^63, on u64 residues.
//
// Replaces the XLA fusions of learn_fhe_tpu/ops/ntt.py (no Pallas call):
//   forward NTT   <- ntt            (ntt.py:135)
//   inverse NTT   <- intt           (ntt.py:189)
//   polymul       <- negacyclic_mul (ntt.py:261): both forward transforms,
//                    the pointwise Montgomery product and the inverse.
// On the multi-key FHEW path they make the keys: every RLWE encryption's
// products with the secret or the public key, and the evaluation-basis
// copies of the bootstrap key (to_eval, make_ksk).
//
// What bounds them on an H100: a transform moves 2 x 8 B per coefficient
// through device memory and does log N u64 Shoup butterflies per pair, each
// some twenty 32-bit instructions (a 64 x 64 product is several IMADs), so
// at (6000, 2048) the instructions' issue, not the bytes, sets the floor.
//
// K-NTT64 and intt64 (redesigned, u64_rows.cuh): a 256-thread block owns
// 2048 values (max(1, 2048 / N) rows; a ragged last block reads zeros for
// its missing rows and does not store them). The forward runs the head
// passes of 3 layers, the first reading device memory, then the last pass
// of 2 layers, whose item of 4 consecutive values goes out to device memory
// from registers in 16-byte stores; the inverse runs the same passes the
// other way, its first pass reading 4 consecutive values in 16-byte loads
// and its last head pass writing device memory scaled by 1/N. Three
// barriers at N = 2048, where every pass's shape is a constant. The
// forward's Montgomery instance (K-NTT64's call sites on the multi-key
// path, rgsw.to_eval and rlwe._to_eval_mont: the JAX package's jitted
// to_montgomery(ntt(x)), rgsw.py:116-131 and rlwe.py:148-150) writes x 2^64
// mod q as one Shoup product by 2^64 mod q in that last pass, so the path's
// evaluation-basis keys take one launch and no eager conversion. N = 2 and
// 4 run one pass from device memory to device memory.
//
// K-POLYMUL64 (redesigned, u64_rows.cuh): a 256-thread block owns the same
// rows of both operands. At N = 2048 (the multi-key sets' ring) a block per
// row pair brings its two rows into shared memory by two bulk copies (TMA)
// and runs every pass with its shape a constant; at other N it reads them
// in its first pass. Its last forward pass, the product and its first
// inverse pass run on one item in registers, its last inverse pass writes
// device memory: 6 barriers, not 10. The multi-key path launches it at
// 6000 rows (an RGSW encryption of a brk; three blocks an SM, 80
// registers) and at 1-8 rows (a key share's public-key products: one
// block's chain). Measured and left out (PERF.md): 512-thread blocks for
// the small launches, and a persistent grid that brought the next row pair
// in under the current one's passes.
//
// Each kernel has an eager and a lazy instance (u64.cuh); the lazy one runs
// for q < 2^62 (lft64::lazy_ok).
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"
#include "u64_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kValues = 2048;  // a block's values per operand

// The block's rows: `per` rows of 2^log_n from row `first`, `have` of them real.
struct Span {
  long long first;
  int per, have;
};

__device__ __forceinline__ Span span(int rows, int log_n) {
  const int per = kValues >> log_n;
  const long long first = static_cast<long long>(blockIdx.x) * per;
  const long long left = rows - first;
  return Span{first, per, static_cast<int>(left < per ? left : per)};
}

// kLogN: 11 (N = 2048, a block per row), 2 or 1 (N = 4 or 2, no head pass),
// 0 (any N >= 8); kMont: the output in the Montgomery domain, r1 = 2^64 mod
// q with its Shoup dual r1_s.
template <bool kLazy, int kLogN, bool kMont>
__global__ void __launch_bounds__(kThreads)
    ntt64_fwd_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, lft64::Tables t, int rows, int log_n,
                     uint64_t r1, uint64_t r1_s) {
  __shared__ uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kValues];
  const Span s = span(rows, kLogN ? kLogN : log_n);
  lft64::rows::forward<kThreads, kLazy, kLogN, kMont>(x, y, t, s.first, s.per, s.have, log_n, r1, r1_s, buf);
}

template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kThreads)
    ntt64_inv_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, lft64::Tables t, int rows, int log_n) {
  __shared__ uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kValues];
  const Span s = span(rows, kLogN ? kLogN : log_n);
  lft64::rows::DeviceRows src{x, s.first, s.have, kLogN ? kLogN : log_n};
  lft64::rows::inverse<kThreads, kLazy, kLogN>(src, y, t, s.first, s.per, s.have, log_n, buf);
}

// y = INTT(NTT(a) * NTT(b)), the product by two REDCs (lft64::mul_mod), at
// any N: a block owns max(1, 2048 / N) rows of each operand.
template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
    negacyclic_mul64_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                            uint64_t* __restrict__ y, lft64::Tables t, int rows, int log_n, uint64_t r2) {
  __shared__ uint64_t buf[2 * kValues];
  const Span s = span(rows, log_n);
  lft64::rows::OperandRows src{a, b, s.first, s.per, s.have, log_n};
  lft64::rows::polymul<kThreads, kLazy, 0>(src, y, t, s.first, s.per, s.have, log_n, r2, buf);
}

// The same at N = 2048, a block per row pair, the rows brought in by bulk
// copies (lft64::rows::polymul_bulk).
template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
    negacyclic_mul64_bulk_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                                 uint64_t* __restrict__ y, lft64::Tables t, uint64_t r2) {
  __shared__ __align__(16) uint64_t buf[2 * kValues];
  __shared__ uint64_t bar;
  lft64::rows::polymul_bulk<kThreads, kLazy>(a, b, y, t, r2, &bar, buf);
}

bool bad_args(int rows, int log_n, uint64_t q) {
  return rows < 1 || log_n < 1 || log_n > lft64::kMaxLogN || q < 3 || q % 2 == 0 || q >= (1ull << 63);
}

unsigned grid(int rows, int log_n) {
  const int per = kValues >> log_n;
  return static_cast<unsigned>((rows + per - 1) / per);
}

lft64::Tables tables(const void* psi, const void* psi_s, const void* psi_inv, const void* psi_inv_s, uint64_t q,
                     uint64_t neg_q_inv, uint64_t n_inv, uint64_t n_inv_s) {
  return lft64::Tables{static_cast<const uint64_t*>(psi), static_cast<const uint64_t*>(psi_s),
                       static_cast<const uint64_t*>(psi_inv), static_cast<const uint64_t*>(psi_inv_s),
                       q, neg_q_inv, n_inv, n_inv_s};
}

// The instance for the ring: N = 2048, 4, 2 or any other.
template <bool kLazy, bool kMont>
auto forward_kernel(int log_n) {
  return log_n == 11 ? ntt64_fwd_kernel<kLazy, 11, kMont>
         : log_n == 2 ? ntt64_fwd_kernel<kLazy, 2, kMont>
         : log_n == 1 ? ntt64_fwd_kernel<kLazy, 1, kMont>
                      : ntt64_fwd_kernel<kLazy, 0, kMont>;
}

template <bool kLazy>
auto inverse_kernel(int log_n) {
  return log_n == 11 ? ntt64_inv_kernel<kLazy, 11>
         : log_n == 2 ? ntt64_inv_kernel<kLazy, 2>
         : log_n == 1 ? ntt64_inv_kernel<kLazy, 1>
                      : ntt64_inv_kernel<kLazy, 0>;
}

int launch_forward(const void* x, void* y, const lft64::Tables& t, int rows, int log_n, bool mont, uint64_t r1,
                   uint64_t r1_s, void* stream) {
  if (bad_args(rows, log_n, t.q)) return static_cast<int>(cudaErrorInvalidValue);
  const bool lazy = lft64::lazy_ok(t.q);
  const auto kernel = mont ? (lazy ? forward_kernel<true, true>(log_n) : forward_kernel<false, true>(log_n))
                           : (lazy ? forward_kernel<true, false>(log_n) : forward_kernel<false, false>(log_n));
  kernel<<<grid(rows, log_n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y), t, rows, log_n, r1, r1_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (rows, 2^log_n) residues, 16-byte aligned (the wrappers check x;
// y is a fresh allocation); the plan's four tables (2^log_n each); q,
// -q^-1 mod 2^64, 1/N and its Shoup dual.
int lft_ntt64_fwd(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                  const void* psi_inv_s, int rows, int log_n, unsigned long long q, unsigned long long neg_q_inv,
                  unsigned long long n_inv, unsigned long long n_inv_s, void* stream) {
  return launch_forward(x, y, tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), rows, log_n,
                        false, 0, 0, stream);
}

// As lft_ntt64_fwd, y in the Montgomery domain (y 2^64 mod q); r1 = 2^64 mod
// q and its Shoup dual.
int lft_ntt64_fwd_mont(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                       const void* psi_inv_s, int rows, int log_n, unsigned long long q, unsigned long long neg_q_inv,
                       unsigned long long n_inv, unsigned long long n_inv_s, unsigned long long r1,
                       unsigned long long r1_s, void* stream) {
  return launch_forward(x, y, tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), rows, log_n,
                        true, r1, r1_s, stream);
}

int lft_ntt64_inv(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                  const void* psi_inv_s, int rows, int log_n, unsigned long long q, unsigned long long neg_q_inv,
                  unsigned long long n_inv, unsigned long long n_inv_s, void* stream) {
  if (bad_args(rows, log_n, q)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lft64::lazy_ok(q) ? inverse_kernel<true>(log_n) : inverse_kernel<false>(log_n);
  kernel<<<grid(rows, log_n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), rows, log_n);
  return static_cast<int>(cudaGetLastError());
}

// As above, with a and b in, y = a * b out, and r2 = 2^128 mod q.
int lft_negacyclic_mul64(const void* a, const void* b, void* y, const void* psi, const void* psi_s,
                         const void* psi_inv, const void* psi_inv_s, int rows, int log_n, unsigned long long q,
                         unsigned long long neg_q_inv, unsigned long long n_inv, unsigned long long n_inv_s,
                         unsigned long long r2, void* stream) {
  if (bad_args(rows, log_n, q)) return static_cast<int>(cudaErrorInvalidValue);
  const lft64::Tables t = tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint64_t*>(a);
  const auto* pb = static_cast<const uint64_t*>(b);
  auto* py = static_cast<uint64_t*>(y);
  const bool lazy = lft64::lazy_ok(q);
  if (log_n != lft64::rows::kBulkLogN) {
    const auto kernel = lazy ? negacyclic_mul64_kernel<true> : negacyclic_mul64_kernel<false>;
    kernel<<<grid(rows, log_n), kThreads, 0, s>>>(pa, pb, py, t, rows, log_n, r2);
  } else {
    const auto kernel = lazy ? negacyclic_mul64_bulk_kernel<true> : negacyclic_mul64_bulk_kernel<false>;
    kernel<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(pa, pb, py, t, r2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
