// K-COEF-CROSS: one cross-shard layer of the coefficient-sharded negacyclic
// NTT (parallel/coef.py, parallel/coef32.py).
//
// The coefficient axis of an (..., L, N) tensor is split contiguously over
// D ranks; the first log2(D) layers of the merged-twist transform pair each
// value with the one at the same local offset on rank r XOR (D >> (l+1)),
// under a twiddle that is one scalar per rank and limb. After the exchange
// (torch.distributed), a rank holds its block x and its partner's block v,
// and its `upper` bit says which half of the pair it keeps:
//   forward (Cooley-Tukey):   upper ? v - t x : x + t v
//   inverse (Gentleman-Sande): upper ? (v - x) t : x + v
// the JAX package's layer bodies (learn_fhe_tpu/parallel/coef.py:157-167,
// :180-190; coef32.py:148-158, :171-181), where u is the lower value of the
// pair and v the upper one. t comes with its Shoup dual; u64 rows use the
// Shoup product of u64.cuh (q < 2^63), u32 rows that of modular32.cuh
// (q < 2^31). Every result is canonical, as the JAX package's.
//
// What bounds it on an H100: two blocks read and one written, a Shoup
// product and two modular adds per value; the bytes dominate. A thread takes
// one 16-byte word of each operand (2 u64 or 4 u32 values) of one row; the
// grid's y axis walks the rows (limb = row mod L), its x axis the row's
// words.
#include <cuda_runtime.h>

#include <cstdint>

#include "modular32.cuh"
#include "u64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

template <bool kInv>
__device__ __forceinline__ uint64_t cross64(uint64_t x, uint64_t v, uint64_t t, uint64_t ts,
                                            uint64_t q, bool upper) {
  if constexpr (kInv) {
    return upper ? lft64::shoup_q(lft64::sub_q(v, x, q), t, ts, q) : lft64::add_q(x, v, q);
  } else {
    return lft64::cross_fwd(x, v, t, ts, q, upper);
  }
}

template <bool kInv>
__device__ __forceinline__ uint32_t cross32(uint32_t x, uint32_t v, uint32_t t, uint32_t ts,
                                            uint32_t q, bool upper) {
  if constexpr (kInv) {
    return upper ? lft::mul_shoup(lft::sub_mod(v, x, q), t, ts, q) : lft::add_mod(x, v, q);
  } else {
    return lft::cross_fwd(x, v, t, ts, q, upper);
  }
}

// u64 rows of `words` 16-byte words each; row r under limb r mod limbs.
template <bool kInv>
__global__ void __launch_bounds__(kThreads)
    coef_cross64_kernel(const ulonglong2* __restrict__ x, const ulonglong2* __restrict__ v,
                        ulonglong2* __restrict__ y, const uint64_t* __restrict__ t,
                        const uint64_t* __restrict__ ts, const uint64_t* __restrict__ q,
                        int rows, int words, int limbs, int upper) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int limb = row % limbs;
    const uint64_t tl = __ldg(t + limb), tsl = __ldg(ts + limb), ql = __ldg(q + limb);
    const size_t at = static_cast<size_t>(row) * words + w;
    const ulonglong2 a = __ldg(x + at), b = __ldg(v + at);
    y[at] = make_ulonglong2(cross64<kInv>(a.x, b.x, tl, tsl, ql, upper),
                            cross64<kInv>(a.y, b.y, tl, tsl, ql, upper));
  }
}

// u32 rows of `words` 16-byte words each, one prime.
template <bool kInv>
__global__ void __launch_bounds__(kThreads)
    coef_cross32_kernel(const uint4* __restrict__ x, const uint4* __restrict__ v,
                        uint4* __restrict__ y, uint32_t t, uint32_t ts, uint32_t q, int rows,
                        int words, int upper) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * words + w;
    const uint4 a = __ldg(x + at), b = __ldg(v + at);
    y[at] = make_uint4(cross32<kInv>(a.x, b.x, t, ts, q, upper), cross32<kInv>(a.y, b.y, t, ts, q, upper),
                       cross32<kInv>(a.z, b.z, t, ts, q, upper), cross32<kInv>(a.w, b.w, t, ts, q, upper));
  }
}

// Nothing: what a launch costs with no work in it (the launch floor a
// kernel's time from a CUDA graph is read against).
__global__ void empty_kernel() {}

dim3 grid_of(int rows, int words) {
  return dim3((words + kThreads - 1) / kThreads, rows < static_cast<int>(kMaxGridY) ? rows : kMaxGridY);
}

}  // namespace

extern "C" {

// x, v, y: rows of `words` 16-byte words (2 values each); t, ts, q: (limbs,)
// device arrays; inv: the inverse layer.
int lft_coef_cross64(const void* x, const void* v, void* y, const void* t, const void* ts,
                     const void* q, int rows, int words, int limbs, int upper, int inv,
                     void* stream) {
  if (rows < 1 || words < 1 || limbs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = inv ? coef_cross64_kernel<true> : coef_cross64_kernel<false>;
  kernel<<<grid_of(rows, words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(x), static_cast<const ulonglong2*>(v),
      static_cast<ulonglong2*>(y), static_cast<const uint64_t*>(t),
      static_cast<const uint64_t*>(ts), static_cast<const uint64_t*>(q), rows, words, limbs,
      upper);
  return static_cast<int>(cudaGetLastError());
}

// The same for u32 rows (4 values a word) under one prime q < 2^31.
int lft_coef_cross32(const void* x, const void* v, void* y, unsigned int t, unsigned int ts,
                     unsigned int q, int rows, int words, int upper, int inv, void* stream) {
  if (rows < 1 || words < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = inv ? coef_cross32_kernel<true> : coef_cross32_kernel<false>;
  kernel<<<grid_of(rows, words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(v), static_cast<uint4*>(y), t, ts,
      q, rows, words, upper);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on `blocks` blocks of 32 threads.
int lft_empty(int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
