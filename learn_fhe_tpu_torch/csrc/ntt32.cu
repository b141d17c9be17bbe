// K-NTT and K-POLYMUL: batched negacyclic NTT, inverse NTT and polynomial
// product mod one prime q < 2^31.
//
// Replaces the Pallas kernels of bench/pallas_ntt14_experiment.py:
//   forward NTT   <- make_kernels.call_fwd      (pl.pallas_call at :166)
//   polymul       <- make_kernels.call_polymul  (pl.pallas_call at :183),
//                    whose inverse half is the inverse NTT here.
// The Pallas kernels load a batch tile into VMEM once and run every layer
// there, with dense per-position twiddle rows, and form the pointwise
// product as mulhi / lo with 2^32 mod q folded in, never dividing.
//
// What bounds them on an H100: a transform moves 2 x 4 B per coefficient
// through device memory and does log N Shoup butterflies per pair; at
// (2048, 2048) the bytes take 10.0 us and the instructions' issue 9.0 us,
// so loads have to overlap arithmetic. The design:
//   - up to N = 2048 a 256-thread block owns max(1, 2048 / N) rows (2048
//     values, 8 per thread at every N); the grid is ceil(rows / rows per
//     block), and the ragged last block masks its missing rows;
//   - past 2048 (N = 2^12 .. 2^14, the Pallas kernels' own N = 2^14) a
//     block owns one row, N / 8 threads of up to 1024 (8 or 16 values a
//     thread), the row waiting between passes in dynamic shared memory (16
//     to 64 KB per operand; K-POLYMUL's 128 KB at 2^14 opted in); the
//     launch bounds keep every instance at 64 registers a thread, as at
//     2048. 14 layers run as [3, 3, 3, 3, 2];
//   - the layers run in passes of up to 3 on values held in registers
//     (lft::fwd_radix / inv_radix, shared with the step kernel), [3, 3, 3, 2]
//     at N=2048, with one barrier between passes and the values waiting in
//     a swizzled shared buffer (8 KB per operand) in between;
//   - the first forward pass reads device memory straight into registers,
//     neighbouring threads on neighbouring values; the last (log_h = 0)
//     holds runs of contiguous outputs and writes them with 16-byte stores.
//     The inverse mirrors it: 16-byte loads into its first pass, the 1/N
//     scale in its last, a coalesced store;
//   - twiddles come per pass through the read-only cache: the 16 KB table
//     of a prime is shared by all blocks on an SM, and a block holds no
//     wait to hide staging behind;
//   - K-POLYMUL holds a and b in one block: at the last forward pass a
//     thread has the same coefficients of both, multiplies them without a
//     division (lft::mul_fold) and runs the first inverse pass before its
//     values leave registers;
//   - one instance per ring size 2^LOG_N, so every pass's index arithmetic
//     is constant; up to 2048, 8 or 16 KB of shared memory and at most 64
//     registers a thread let 4 blocks share an SM.
// On an H100 neither more resident blocks nor a persistent grid that brings
// the next rows in with bulk copies ran faster (PERF.md): the SMs' issue of
// the compiled integer instructions sets the time, and most of the ALU's
// share is the compare and select of the conditional subtracts.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "ntt32.cuh"

namespace {

constexpr int kMaxLogN = 14;
constexpr int kRowsLogN = 11;  // up to 2^11 a block holds 2048 values; past it, one row

// Values of a block's rows per operand, its threads, and the blocks an SM
// must hold at once (launch bounds: 64 registers a thread at every ring).
__host__ __device__ constexpr int block_values(int log_n) {
  return log_n > kRowsLogN ? 1 << log_n : 1 << kRowsLogN;
}
__host__ __device__ constexpr int block_threads(int log_n) {
  return block_values(log_n) / 8 < 1024 ? block_values(log_n) / 8 : 1024;
}
__host__ __device__ constexpr int min_blocks(int log_n) { return 1024 / block_threads(log_n); }
// Dynamic shared memory of a block with K operands: none up to 2^11, where
// the buffer is static.
__host__ __device__ constexpr int dynamic_smem(int log_n, int k) {
  return log_n > kRowsLogN ? k * 4 * block_values(log_n) : 0;
}

// What a block works on: its shared buffer, the prime's tables and constants,
// and how many values of its rows exist.
struct Rows {
  uint32_t* buf;  // block_values per operand, at lft::swizzle(i) for value i of the rows
  const uint32_t* __restrict__ psi;
  const uint32_t* __restrict__ psi_s;
  const uint32_t* __restrict__ psi_inv;
  const uint32_t* __restrict__ psi_inv_s;
  uint32_t q, n_inv, n_inv_s, r32, r32_s;
  int limit;  // block_values, or fewer in the ragged last block
};

// Item t of a block's pass over layers L0 .. L0+W-1: its rows hold
// block_values >> W items, and item t's value m is value at + (m << kLogH) of
// the block's rows, with at = row * N + (hi << (LOG_N - L0)) + lo.
template <int LOG_N, int L0, int W>
struct Item {
  static constexpr int kLogH = LOG_N - L0 - W;
  static constexpr int kThreads = block_threads(LOG_N);
  static constexpr int kValues = block_values(LOG_N);
  static constexpr int kPerThread = (kValues >> W) / kThreads;
  int hi, at;
  __device__ __forceinline__ explicit Item(int t)
      : hi((t & ((1 << (LOG_N - W)) - 1)) >> kLogH),
        at(((t >> (LOG_N - W)) << LOG_N) + (hi << (LOG_N - L0)) + (t & ((1 << kLogH) - 1))) {}
};

// An item's values from device memory; zeros past the rows that exist.
template <int W, int LOG_H>
__device__ __forceinline__ void load_item(uint32_t (&x)[1 << W], const uint32_t* __restrict__ p,
                                          int at, int limit) {
  if (at >= limit) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = 0;
  } else if constexpr (LOG_H == 0) {
    lft::load_global<1 << W>(x, p + at);
  } else {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = __ldg(p + at + (m << LOG_H));
  }
}

// An item's values to device memory, if its row exists.
template <int W, int LOG_H>
__device__ __forceinline__ void store_item(const uint32_t (&x)[1 << W], uint32_t* __restrict__ p,
                                           int at, int limit) {
  if (at >= limit) return;
  if constexpr ((1 << W) >= 4 && LOG_H == 0) {
#pragma unroll
    for (int c = 0; c < (1 << W); c += 4) {
      *reinterpret_cast<uint4*>(p + at + c) = make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) p[at + (m << LOG_H)] = x[m];
  }
}

// The inverse of the layers L0 .. L0+W-1 on one item, with the 1/N scale
// when they end at layer 0.
template <int W, int L0>
__device__ __forceinline__ void inverse_layers(const Rows& k, uint32_t (&x)[1 << W], int hi) {
  uint32_t w[(1 << W) - 1], ws[(1 << W) - 1];
  lft::pass_twiddles<W, true>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
  lft::inv_radix<W>(x, w, ws, k.q);
  if constexpr (L0 == 0) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = lft::mul_shoup(x[m], k.n_inv, k.n_inv_s, k.q);
  }
}

// Forward pass P, then the ones after it, on the block's K operands (K-NTT:
// the row; K-POLYMUL: a and b, operand o in buffer slice o). Pass 0 reads
// `in` (device memory, at the block's first value), the others the buffer.
// The last pass (log_h = 0) holds runs of 2^W outputs: with K = 1 it writes
// them to `out`; with K = 2 it multiplies a's by b's and runs the inverse of
// its own layers on the product, which then goes to `out` if that was layer
// 0 and to the buffer otherwise.
template <int LOG_N, int P, int K>
__device__ __forceinline__ void forward_pass(const Rows& k, const uint32_t* const (&in)[K],
                                             uint32_t* __restrict__ out) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  constexpr bool kLast = P == lft::pass_count(LOG_N) - 1;
  using It = Item<LOG_N, L0, W>;
#pragma unroll
  for (int i = 0; i < It::kPerThread; ++i) {
    const It it(threadIdx.x + i * It::kThreads);
    uint32_t x[K][R];
#pragma unroll
    for (int o = 0; o < K; ++o) {
      if constexpr (P == 0) {
        load_item<W, It::kLogH>(x[o], in[o], it.at, k.limit);
      } else {
        lft::load_row<W, It::kLogH>(x[o], k.buf + o * It::kValues, it.at);
      }
    }
    {
      uint32_t w[R - 1], ws[R - 1];
      lft::pass_twiddles<W, true>(w, ws, k.psi, k.psi_s, L0, it.hi);
#pragma unroll
      for (int o = 0; o < K; ++o) lft::fwd_radix<W>(x[o], w, ws, k.q);
    }
    if constexpr (!kLast) {
#pragma unroll
      for (int o = 0; o < K; ++o) lft::store_row<W, It::kLogH>(x[o], k.buf + o * It::kValues, it.at);
    } else if constexpr (K == 1) {
      store_item<W, 0>(x[0], out, it.at, k.limit);
    } else {
#pragma unroll
      for (int m = 0; m < R; ++m) x[0][m] = lft::mul_fold(x[0][m], x[1][m], k.r32, k.r32_s, k.q);
      inverse_layers<W, L0>(k, x[0], it.hi);
      if constexpr (L0 == 0) {
        store_item<W, 0>(x[0], out, it.at, k.limit);
      } else {
        lft::store_row<W, 0>(x[0], k.buf, it.at);
      }
    }
  }
  if constexpr (!kLast) {
    __syncthreads();
    forward_pass<LOG_N, P + 1, K>(k, in, out);
  }
}

// The inverse of forward pass P, then of P-1 .. 0, on the row in buffer
// slice 0. kFromGlobal: P is the last forward pass (log_h = 0), and its
// input runs are read from `in` (device memory) instead of the buffer.
// Pass 0 scales by 1/N and writes `out`.
template <int LOG_N, int P, bool kFromGlobal>
__device__ __forceinline__ void inverse_pass(const Rows& k, const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  using It = Item<LOG_N, L0, W>;
#pragma unroll
  for (int i = 0; i < It::kPerThread; ++i) {
    const It it(threadIdx.x + i * It::kThreads);
    uint32_t x[R];
    if constexpr (kFromGlobal) {
      load_item<W, It::kLogH>(x, in, it.at, k.limit);
    } else {
      lft::load_row<W, It::kLogH>(x, k.buf, it.at);
    }
    inverse_layers<W, L0>(k, x, it.hi);
    if constexpr (P == 0) {
      store_item<W, It::kLogH>(x, out, it.at, k.limit);
    } else {
      lft::store_row<W, It::kLogH>(x, k.buf, it.at);
    }
  }
  if constexpr (P > 0) {
    __syncthreads();
    inverse_pass<LOG_N, P - 1, false>(k, in, out);
  }
}

// Values of the block's rows that exist, of `values` in all.
template <int LOG_N>
__device__ __forceinline__ int block_limit(long long values) {
  constexpr int kValues = block_values(LOG_N);
  const long long left = values - static_cast<long long>(blockIdx.x) * kValues;
  return left < kValues ? static_cast<int>(left) : kValues;
}

// The block's buffer for K operands, 16-byte aligned for the vector
// accesses: static up to 2^11, dynamic (dynamic_smem bytes) past it.
template <int LOG_N, int K>
__device__ __forceinline__ uint32_t* block_buffer() {
  if constexpr (LOG_N > kRowsLogN) {
    extern __shared__ uint4 dyn4[];
    return reinterpret_cast<uint32_t*>(dyn4);
  } else {
    __shared__ uint4 sh4[K * block_values(LOG_N) / 4];
    return reinterpret_cast<uint32_t*>(sh4);
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    ntt32_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_s,
                     long long values, uint32_t q) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 1>(), psi, psi_s, nullptr, nullptr, q, 0, 0, 0, 0,
               block_limit<LOG_N>(values)};
  const uint32_t* const in[1] = {x + first};
  forward_pass<LOG_N, 0, 1>(k, in, y + first);
}

template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    ntt32_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi_inv, const uint32_t* __restrict__ psi_inv_s,
                     long long values, uint32_t q, uint32_t n_inv, uint32_t n_inv_s) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 1>(), nullptr, nullptr, psi_inv, psi_inv_s, q, n_inv,
               n_inv_s, 0, 0, block_limit<LOG_N>(values)};
  inverse_pass<LOG_N, lft::pass_count(LOG_N) - 1, true>(k, x + first, y + first);
}

// y = INTT(NTT(a) * NTT(b)) on the block's rows of a and b.
template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    negacyclic_mul32_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ y, const uint32_t* __restrict__ psi,
                            const uint32_t* __restrict__ psi_s,
                            const uint32_t* __restrict__ psi_inv,
                            const uint32_t* __restrict__ psi_inv_s, long long values, uint32_t q,
                            uint32_t n_inv, uint32_t n_inv_s, uint32_t r32, uint32_t r32_s) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 2>(), psi, psi_s, psi_inv, psi_inv_s, q, n_inv, n_inv_s,
               r32, r32_s, block_limit<LOG_N>(values)};
  const uint32_t* const in[2] = {a + first, b + first};
  forward_pass<LOG_N, 0, 2>(k, in, y + first);
  constexpr int kLast = lft::pass_count(LOG_N) - 1;
  if constexpr (kLast > 0) {
    __syncthreads();
    inverse_pass<LOG_N, kLast - 1, false>(k, nullptr, y + first);
  }
}

// Each kernel's instance for ring 2^log_n, 1 <= log_n <= kMaxLogN.
template <int... L>
auto fwd_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&ntt32_fwd_kernel<1>) table[] = {ntt32_fwd_kernel<L + 1>...};
  return table[log_n - 1];
}

template <int... L>
auto inv_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&ntt32_inv_kernel<1>) table[] = {ntt32_inv_kernel<L + 1>...};
  return table[log_n - 1];
}

template <int... L>
auto mul_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&negacyclic_mul32_kernel<1>) table[] = {negacyclic_mul32_kernel<L + 1>...};
  return table[log_n - 1];
}

constexpr auto kLogNs = std::make_integer_sequence<int, kMaxLogN>{};

// Blocks for `rows` rows of 2^log_n, or 0 for a shape the kernels do not take.
unsigned blocks(int rows, int log_n) {
  if (rows < 1 || log_n < 1 || log_n > kMaxLogN) return 0;
  const int per_block = block_values(log_n) >> log_n;
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

// Launches `kernel` for ring 2^log_n on `grid` blocks with K operands'
// buffer, opting it in to dynamic shared memory past 48 KB.
template <int K, class Kernel, class... Args>
int launch(Kernel kernel, unsigned grid, int log_n, void* stream, Args... args) {
  const int smem = dynamic_smem(log_n, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block_threads(log_n), smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lft_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int lft_ntt32_fwd(const void* x, void* y, const void* psi, const void* psi_s, int rows, int log_n,
                  unsigned int q, void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(fwd_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(y), static_cast<const uint32_t*>(psi),
                   static_cast<const uint32_t*>(psi_s), static_cast<long long>(rows) << log_n, q);
}

int lft_ntt32_inv(const void* x, void* y, const void* psi_inv, const void* psi_inv_s, int rows,
                  int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                  void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(inv_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(y), static_cast<const uint32_t*>(psi_inv),
                   static_cast<const uint32_t*>(psi_inv_s), static_cast<long long>(rows) << log_n, q,
                   n_inv, n_inv_s);
}

int lft_negacyclic_mul32(const void* a, const void* b, void* y, const void* psi,
                         const void* psi_s, const void* psi_inv, const void* psi_inv_s, int rows,
                         int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                         unsigned int r32, unsigned int r32_s, void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<2>(mul_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(a),
                   static_cast<const uint32_t*>(b), static_cast<uint32_t*>(y),
                   static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s),
                   static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_s),
                   static_cast<long long>(rows) << log_n, q, n_inv, n_inv_s, r32, r32_s);
}

}  // extern "C"
