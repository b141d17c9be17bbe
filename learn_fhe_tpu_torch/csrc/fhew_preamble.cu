// K-FHEW-PRE: the FHEW gate bootstrap's preamble, one exact integer launch a
// gate batch (models/fhew/bootstrapping.py::preamble).
//
// Replaces the JAX package's jitted fusion learn_fhe_tpu/parallel/batch.py:115
// `_fhew_preamble`, on both engines: for each ciphertext (a (N,) and b mod Q)
//   1. ct_mod_switch Q -> q_ks (learn_fhe_tpu/ops/modular.py:191-196): the
//      value converted to f64, one IEEE multiply by (double) q_ks, one IEEE
//      divide by (double) Q, rounded half away from zero as
//      floor(x + 0.5) / ceil(x - 0.5) (:213-219), then mod q_ks;
//   2. the LWE key switch (learn_fhe_tpu/models/fhew/lwe.py:157):
//      decompose_zq's d signed digits of each coefficient as residues mod
//      q_ks, dotted with ksk_a (d * N, n) and ksk_b. q_ks is a power of two
//      no larger than 2^32, so the sums wrap in uint32 and are masked to
//      q_ks: q_ks divides 2^32, so that equals modular_dot's wrapping u64
//      sums masked (modular.py:256);
//   3. ct_mod_switch_odd q_ks -> 2N (modular.py:199-210): the floor forced
//      odd, rounded instead where the floor is 0;
//   4. the rotated LUT f' = (f o sigma_{-g}) * X^{g b mod 2N} of prepare_acc
//      (the port's models/fhew/bootstrapping.py:583): f'[p] = F(((p - s)
//      t^-1) mod 2N) with s = g b mod 2N, t = -g and F(e) = f[e] for e < N,
//      -f[e - N] mod Q for e >= N; both index maps and their signs are
//      applied as f is read, so f o sigma is never stored.
// It returns the Z_2N mask (B, n) and f' (B, N) (int32 on the u32 engine,
// int64 on the u64). Built without --use_fast_math: the f64 steps are
// __dmul_rn / __ddiv_rn / __dadd_rn, as the reference rounds them.
//
// What bounds it on an H100: at the 28-bit fixture (N = 512, n = 100, batch
// 128) a few MB, so the launch; at the multi-key full set (N = 2048, n = 600,
// d = 4) the 39 MB int64 key (12 us at 3.35 TB/s) against 630 M multiply-adds
// of the key switch (38 us of the FMA pipe). Design: a grid over (column
// tiles of 16 of n, batch tiles of 32); every block makes its 32 rows'
// digits of a chunk of coefficients into shared memory (a warp a
// coefficient, a lane a row) and stages the chunk's key rows for its
// columns there, then each warp sums a share of the chunk's key rows, a lane
// holding 16 rows of one column and a key word read once for those rows.
// A chunk's device reads are all issued at once, the next chunk's while
// this chunk's sums run. Every block also sums its rows' b column (K multiply-adds a
// row), so it can make b's odd switch and write its share of f's N
// coefficients for its rows: one launch, no wait across blocks.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;     // batch rows a block
constexpr int kCols = 16;     // LWE columns a block
constexpr int kChunkK = 128;  // key rows a chunk at most
constexpr int kMaxCoefs = 32;  // coefficients a chunk at most: a lane loads 4
constexpr int kKeyLoads = kChunkK * kCols / kThreads;  // key words a thread stages a chunk

struct Pre {
  int batch, big_n, n, d, log_b, rbits, log_q_ks, f_rows, wide;
  unsigned long long big_q;
  double big_q_f, q_ks_f, two_n_f;
  int two_n, g, t_inv, cc, cc_log;  // cc: coefficients a chunk, a power of two
};

__device__ __forceinline__ double round_half_away(double x) {
  return x >= 0.0 ? floor(__dadd_rn(x, 0.5)) : ceil(__dsub_rn(x, 0.5));
}

// round(x q_ks / Q) mod q_ks, q_ks a power of two
__device__ __forceinline__ uint64_t mod_switch(uint64_t x, const Pre& p) {
  const double scaled = __ddiv_rn(__dmul_rn(__ull2double_rn(x), p.q_ks_f), p.big_q_f);
  const long long r = static_cast<long long>(round_half_away(scaled));
  return static_cast<uint64_t>(r) & ((1ull << p.log_q_ks) - 1);
}

// the odd switch q_ks -> 2N of a value below q_ks
__device__ __forceinline__ int mod_switch_odd(uint64_t x, const Pre& p) {
  const double scaled = __ddiv_rn(__dmul_rn(__ull2double_rn(x), p.two_n_f), p.q_ks_f);
  const double fl = floor(scaled);
  const long long v = fl == 0.0 ? static_cast<long long>(round_half_away(scaled)) : (static_cast<long long>(fl) | 1);
  return static_cast<int>(static_cast<uint64_t>(v) % static_cast<uint64_t>(p.two_n));
}

// decompose_zq's d digits of x (< q_ks) as residues mod q_ks, into out[i * stride]
__device__ __forceinline__ void digits(uint64_t x, const Pre& p, uint32_t* out, int stride) {
  const uint64_t q = 1ull << p.log_q_ks, mask = (1ull << p.log_b) - 1, b_by_2 = 1ull << (p.log_b - 1);
  const uint64_t neg_b = q - (1ull << p.log_b);
  uint64_t v = x;
  if (p.rbits) {
    uint64_t s = x + (((1ull << p.rbits) >> 1) % q);
    s = s >= q ? s - q : s;
    v = s >> p.rbits;
  }
  v = v < (q >> 1) ? v : v - q;  // the centered lift, two's complement
#pragma unroll 1
  for (int i = 0; i < p.d; ++i) {
    const uint64_t limb = v & mask;
    const uint64_t carry = (limb + (v & 1)) > b_by_2 ? 1 : 0;
    v = (v >> p.log_b) + carry;
    out[i * stride] = static_cast<uint32_t>(limb + carry * neg_b);
  }
}

// A chunk's loads, issued together before any is used: a lane's row of
// the warp's coefficients cl = warp + 8 i, and a share of the chunk's key
// rows for the block's columns and the b column (low words: the values are
// below q_ks <= 2^32).
struct Loads {
  uint64_t a[kMaxCoefs / kWarps];
  uint32_t key[kKeyLoads];
  uint32_t kb;
};

__device__ __forceinline__ void load_chunk(Loads& l, const uint64_t* __restrict__ a, const uint64_t* __restrict__ ksk_a,
                                           const uint64_t* __restrict__ ksk_b, int c0, int row0, int rows, int n0,
                                           const Pre& p) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < kMaxCoefs / kWarps; ++i) {
    const int cl = warp + kWarps * i, c = c0 + cl;
    l.a[i] = (cl < p.cc && lane < rows && c < p.big_n) ? __ldg(a + static_cast<size_t>(row0 + lane) * p.big_n + c) : 0ull;
  }
  const int kc = p.d * p.cc;
#pragma unroll
  for (int i = 0; i < kKeyLoads; ++i) {
    const int k = i * (kThreads / kCols) + tid / kCols, col = n0 + tid % kCols;
    const int di = k >> p.cc_log, c = c0 + (k & (p.cc - 1));
    l.key[i] = (k < kc && c < p.big_n && col < p.n)
                   ? __ldg(reinterpret_cast<const uint32_t*>(ksk_a + (static_cast<size_t>(di) * p.big_n + c) * p.n + col))
                   : 0u;
  }
  const int di = tid >> p.cc_log, c = c0 + (tid & (p.cc - 1));
  l.kb = (tid < kc && c < p.big_n) ? __ldg(reinterpret_cast<const uint32_t*>(ksk_b + static_cast<size_t>(di) * p.big_n + c)) : 0u;
}

__global__ void __launch_bounds__(kThreads, 2)
    fhew_preamble_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                         const uint64_t* __restrict__ ksk_a, const uint64_t* __restrict__ ksk_b,
                         const uint64_t* __restrict__ f, long long* __restrict__ mask_out, void* __restrict__ f_out,
                         Pre p) {
  __shared__ __align__(16) uint32_t dig[kChunkK * kRows];  // digit of chunk key row k for each row; then the partial sums
  __shared__ uint32_t key_s[kChunkK * kCols];             // the chunk's key rows for the block's columns
  __shared__ uint32_t key_b[kChunkK];
  __shared__ uint32_t red_b[kWarps][kRows];
  __shared__ int shift[kRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kRows, rows = min(kRows, p.batch - row0);
  const int n0 = blockIdx.x * kCols, col = lane & 15, half = lane >> 4;
  const uint32_t qmask = static_cast<uint32_t>((1ull << p.log_q_ks) - 1);
  const int kc = p.d * p.cc;  // key rows a chunk

  uint32_t acc[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] = 0;
  uint32_t acc_b = 0;

  Loads l;
  load_chunk(l, a, ksk_a, ksk_b, 0, row0, rows, n0, p);
  for (int c0 = 0; c0 < p.big_n; c0 += p.cc) {
    __syncthreads();  // the previous chunk's sums have read the buffers
#pragma unroll
    for (int i = 0; i < kKeyLoads; ++i) key_s[i * kThreads + tid] = l.key[i];
    if (tid < kChunkK) key_b[tid] = l.kb;
    // digits: a warp a coefficient, a lane a row
#pragma unroll
    for (int i = 0; i < kMaxCoefs / kWarps; ++i) {
      const int cl = warp + kWarps * i;
      if (cl < p.cc) digits(mod_switch(l.a[i], p), p, dig + cl * kRows + lane, p.cc * kRows);
    }
    __syncthreads();
    if (c0 + p.cc < p.big_n) load_chunk(l, a, ksk_a, ksk_b, c0 + p.cc, row0, rows, n0, p);  // in flight during the sums
    for (int k = warp; k < kc; k += kWarps) {
      const uint32_t key = key_s[k * kCols + col];
      const uint4* dv = reinterpret_cast<const uint4*>(dig + k * kRows + half * 16);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const uint4 v = dv[q4];
        acc[4 * q4] += v.x * key;
        acc[4 * q4 + 1] += v.y * key;
        acc[4 * q4 + 2] += v.z * key;
        acc[4 * q4 + 3] += v.w * key;
      }
      acc_b += dig[k * kRows + lane] * key_b[k];
    }
  }
  __syncthreads();
  // the warps' partial sums: red[w][row][col]
  uint32_t* red = dig;
#pragma unroll
  for (int r = 0; r < 16; ++r) red[(warp * kRows + half * 16 + r) * kCols + col] = acc[r];
  red_b[warp][lane] = acc_b;
  __syncthreads();
  for (int idx = tid; idx < kRows * kCols; idx += kThreads) {
    const int r = idx / kCols, cc = n0 + idx % kCols;
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + r) * kCols + idx % kCols];
    if (r < rows && cc < p.n) mask_out[static_cast<size_t>(row0 + r) * p.n + cc] = mod_switch_odd(sum & qmask, p);
  }
  if (tid < kRows) {
    uint32_t sum = 0;
    if (tid < rows) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_b[w][tid];
      sum += static_cast<uint32_t>(mod_switch(__ldg(b + row0 + tid), p));
    }
    const long long b2n = mod_switch_odd(sum & qmask, p);
    shift[tid] = static_cast<int>((b2n * p.g) % p.two_n);
  }
  __syncthreads();
  // this block's share of f' for its rows
  const int p0 = static_cast<int>(static_cast<long long>(p.big_n) * blockIdx.x / gridDim.x);
  const int p1 = static_cast<int>(static_cast<long long>(p.big_n) * (blockIdx.x + 1) / gridDim.x);
  const int width = p1 - p0;
  for (int idx = tid; idx < rows * width; idx += kThreads) {
    const int r = idx / width, pos = p0 + idx % width;
    const uint64_t* fr = f + (p.f_rows == 1 ? 0 : static_cast<size_t>(row0 + r) * p.big_n);
    const long long e = (static_cast<long long>((pos - shift[r] + p.two_n) % p.two_n) * p.t_inv) % p.two_n;
    uint64_t v;
    if (e < p.big_n) {
      v = __ldg(fr + e);
    } else {
      const uint64_t x = __ldg(fr + (e - p.big_n));
      v = x == 0 ? 0 : p.big_q - x;
    }
    const size_t at = static_cast<size_t>(row0 + r) * p.big_n + pos;
    if (p.wide) {
      static_cast<uint64_t*>(f_out)[at] = v;
    } else {
      static_cast<uint32_t*>(f_out)[at] = static_cast<uint32_t>(v);
    }
  }
}

}  // namespace

extern "C" {

// a (batch, N) and b (batch,) mod Q; ksk_a (d, N, n), ksk_b (d, N) mod q_ks;
// f (f_rows, N) mod Q, f_rows 1 (one LUT) or batch; mask_out (batch, n)
// int64; f_out (batch, N), int64 if wide else int32. q_ks = 2^log_q_ks
// (<= 2^32); t_inv = (-g)^-1 mod 2N.
int lft_fhew_preamble(const void* a, const void* b, const void* ksk_a, const void* ksk_b, const void* f, int f_rows,
                      void* mask_out, void* f_out, int wide, int batch, int big_n, int n, int d, int log_b,
                      int rounding_bits, int log_q_ks, unsigned long long big_q, double big_q_f, double q_ks_f,
                      int g, int t_inv, void* stream) {
  if (batch < 1 || big_n < 1 || n < 1 || d < 1 || d > kChunkK || log_b < 1 || log_q_ks < 1 || log_q_ks > 32 ||
      log_b > log_q_ks || (f_rows != 1 && f_rows != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  Pre p{batch, big_n, n, d, log_b, rounding_bits, log_q_ks, f_rows, wide, big_q, big_q_f, q_ks_f,
        static_cast<double>(2 * big_n), 2 * big_n, g, t_inv, 1, 0};
  while (2 * p.cc <= std::min(kMaxCoefs, kChunkK / d)) p.cc *= 2, ++p.cc_log;
  const dim3 grid((n + kCols - 1) / kCols, (batch + kRows - 1) / kRows);
  fhew_preamble_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b), static_cast<const uint64_t*>(ksk_a),
      static_cast<const uint64_t*>(ksk_b), static_cast<const uint64_t*>(f), static_cast<long long*>(mask_out),
      f_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
