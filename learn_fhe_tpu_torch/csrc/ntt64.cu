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
// K-NTT64, simple first: a 256-thread block owns 2048 values (max(1, 2048
// / N) rows; a ragged last block reads zeros for its missing rows and does
// not store them), loads them into shared memory, runs the layers in passes
// of up to 3 on values held in registers with a barrier after each pass
// (lft64::ntt_rows / intt_rows), and stores them. Twiddles come through the
// read-only cache.
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

__device__ __forceinline__ void load(uint64_t* buf, const uint64_t* __restrict__ x, const Span& s, int log_n) {
  const int values = s.have << log_n;
  const uint64_t* src = x + (s.first << log_n);
  for (int i = threadIdx.x; i < kValues; i += kThreads) buf[i] = i < values ? __ldg(src + i) : 0;
}

__device__ __forceinline__ void store(const uint64_t* buf, uint64_t* __restrict__ y, const Span& s, int log_n) {
  const int values = s.have << log_n;
  uint64_t* dst = y + (s.first << log_n);
  for (int i = threadIdx.x; i < values; i += kThreads) dst[i] = buf[i];
}

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
    ntt64_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, lft64::Tables t, int rows, int log_n,
                 int inverse) {
  __shared__ uint64_t buf[kValues];
  const Span s = span(rows, log_n);
  load(buf, x, s, log_n);
  __syncthreads();
  if (inverse) {
    lft64::intt_rows<kLazy>(buf, s.per, log_n, t, nullptr);
  } else {
    lft64::ntt_rows<kLazy>(buf, s.per, log_n, t);
  }
  store(buf, y, s, log_n);
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

int launch_ntt(const void* x, void* y, const lft64::Tables& t, int rows, int log_n, int inverse, void* stream) {
  if (bad_args(rows, log_n, t.q)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lft64::lazy_ok(t.q) ? ntt64_kernel<true> : ntt64_kernel<false>;
  kernel<<<grid(rows, log_n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y), t, rows, log_n, inverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (rows, 2^log_n) residues; the plan's four tables (2^log_n each);
// q, -q^-1 mod 2^64, 1/N and its Shoup dual.
int lft_ntt64_fwd(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                  const void* psi_inv_s, int rows, int log_n, unsigned long long q, unsigned long long neg_q_inv,
                  unsigned long long n_inv, unsigned long long n_inv_s, void* stream) {
  return launch_ntt(x, y, tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), rows, log_n, 0,
                    stream);
}

int lft_ntt64_inv(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                  const void* psi_inv_s, int rows, int log_n, unsigned long long q, unsigned long long neg_q_inv,
                  unsigned long long n_inv, unsigned long long n_inv_s, void* stream) {
  return launch_ntt(x, y, tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), rows, log_n, 1,
                    stream);
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
