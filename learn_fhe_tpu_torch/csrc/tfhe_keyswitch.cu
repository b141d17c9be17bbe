// K6: the TFHE key switch with its sample extract, one int8 tensor-core
// launch (models/tfhe/tlwe.py::extract_key_switch and, without the extract,
// key_switch on the card).
//
// Replaces the JAX package's XLA stages learn_fhe_tpu/models/tfhe/tglwe.py:93
// `sample_extract` and learn_fhe_tpu/models/tfhe/tlwe.py:89 `key_switch` with
// its :113 `_mxu_wrapping_dot`: for each row, the mask of coefficient 0 of
// the accumulator (j = 0: a[0]; j > 0: -a[N - j], per ring component), its
// balanced gadget digits (ops/gadget.py `decompose_t64`: round to log_b * d
// bits, d digits in (-B/2, B/2]), and their dot with the key mod 2^64, the
// key's b column riding as column n_to and the accumulator's b[0] added to
// it. K index k = digit * n_from + coefficient, as key_switch flattens it.
//
// The contraction runs as the JAX package's does on the MXU: each u64 key
// word is split into 8 balanced base-256 int8 limbs (exact mod 2^64), each
// limb plane is contracted with the int8 digits by mma.sync m16n8k32
// s8.s8.s32 (exact int32 sums: the caller gates K * 2^(log_b - 1) < 2^23,
// so every sum is below 2^31), and the 8 sums recombine as
// sum_j s_j * 2^(8 j) mod 2^64.
//
// What bounds it on an H100: the key, d * n_from * (n_to + 1) u64 words read
// once (84 MB at the reference fixture: 26 us at 3.35 TB/s); the 8 limb
// products are 2 * 8 * B * K * (n_to + 1) int8 operations (21.5 G at batch
// 128, 11 us of the tensor cores). The design reads every key word from
// device memory once: a block holds all rows of the launch (up to 128; a
// grid z index per further 128 rows) against a tile of 32 columns, and the
// K axis is split over blocks so that the column tiles times the splits fill
// the SMs (33 x 4 = 132 at the fixture). Each block adds its recombined u64
// partial into the output with a 64-bit atomicAdd: wrapping addition is
// associative and commutative, so the sum is exact in any order. A stage's
// device reads (its key words and the accumulator's mask values) are issued
// by cp.async into shared memory while the previous stage's products run;
// the key words are then split into the limb planes (an add, a xor and a
// byte transpose a word), and the digits made from the staged mask values
// with the extract's negation. No second copy of the key is made in device
// memory.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;  // 16 warps: 4 row pairs of 32 rows x 4 column fragments of 8
constexpr int kRows = 128;
constexpr int kCols = 32;
constexpr int kStageTarget = 160;  // key rows a stage aims at: d * coefficients
constexpr int kStageK = 256;       // key rows a stage holds at most (a multiple of 32): 4 coefficients at d = 64
constexpr int kMaxCoefs = 32;      // coefficients a stage at most
constexpr int kStride = kStageK + 16;  // bytes a row of the digit and limb buffers
constexpr int kRawStride = kCols + 2;  // u64 words a row of the staged key: 4-row groups 16 banks apart

struct Shape {
  int batch, n_from, n_to, big_n, log_b, d, rbits, u32_digits;
  int sc, sc_log;  // coefficients a stage, a power of two >= 4
  int ks;          // key rows a stage, d * sc rounded up to 32
  int stages;      // stages over n_from
  int splits;      // blocks along K
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of one 8-byte word into shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void copy8(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

// decompose_t64's d digits of 4 consecutive coefficients' values: digit i
// of the 4 as int8, packed into the word at out + i * stride.
__device__ __forceinline__ void digits4(const uint64_t (&x)[4], const Shape& s, int8_t* out, int stride) {
  const int log_b = s.log_b;
  if (s.u32_digits) {  // decompose_t64_u32: rounding_bits >= 33 and log_b * d <= 31 read only the high word
    const uint32_t mask = (1u << log_b) - 1;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = (static_cast<uint32_t>(x[q] >> 32) + (1u << (s.rbits - 33))) >> (s.rbits - 32);
    for (int i = 0; i < s.d; ++i) {
      uint32_t packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t limb = v[q] & mask;
        v[q] >>= log_b;
        const uint32_t carry = (((limb - 1) | v[q]) & limb) >> (log_b - 1);
        v[q] += carry;
        packed |= ((limb - (carry << log_b)) & 255u) << (8 * q);
      }
      *reinterpret_cast<uint32_t*>(out + i * stride) = packed;
    }
    return;
  }
  const uint64_t mask = (1ull << log_b) - 1;
  uint64_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = s.rbits ? (x[q] + (1ull << (s.rbits - 1))) >> s.rbits : x[q];
  for (int i = 0; i < s.d; ++i) {
    uint32_t packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t limb = v[q] & mask;
      v[q] >>= log_b;
      const uint64_t carry = (((limb - 1) | v[q]) & limb) >> (log_b - 1);
      v[q] += carry;
      packed |= (static_cast<uint32_t>(limb - (carry << log_b)) & 255u) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(out + i * stride) = packed;
  }
}

// Stage `st`'s device reads, into shared memory by cp.async (no registers
// held while they fly): the key rows (digit i, coefficient c) of the stage
// for the block's 32 columns (ksk.a, the b column at n_to, zeros past it and
// on padding rows), and each row's mask values of the stage's coefficients
// as stored (the extract's negation is applied when they are read).
__device__ __forceinline__ void issue_stage(uint64_t* raw_key, uint64_t* raw_x, const uint64_t* __restrict__ a_rows,
                                            const uint64_t* __restrict__ ka, const uint64_t* __restrict__ kb,
                                            int st, int n0, int rows, const Shape& s) {
  const int tid = threadIdx.x;
  for (int w = tid; w < s.ks * kCols; w += kThreads) {
    const int kap = w / kCols, cl_col = w - kap * kCols, col = n0 + cl_col;
    const int i = kap >> s.sc_log, c = (st << s.sc_log) + (kap & (s.sc - 1));
    const bool ok = kap < s.d * s.sc && c < s.n_from && col <= s.n_to;
    const long long kk = static_cast<long long>(i) * s.n_from + c;
    const uint64_t* src = !ok ? ka : (col < s.n_to ? ka + kk * s.n_to + col : kb + kk);
    copy8(raw_key + kap * kRawStride + cl_col, src, ok ? 8 : 0);
  }
  for (int v = tid; v < kRows * s.sc; v += kThreads) {
    const int row = v >> s.sc_log, c = (st << s.sc_log) + (v & (s.sc - 1));
    const bool ok = row < rows && c < s.n_from;
    int at = c;
    if (s.big_n) {
      const int j = c & (s.big_n - 1);
      at = c - j + (j ? s.big_n - j : 0);
    }
    copy8(raw_x + v, ok ? a_rows + static_cast<size_t>(row) * s.n_from + at : a_rows, ok ? 8 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Split 4 staged key words (stage rows k0..k0+3 of one column) into the 8
// limb planes: limb j of row k at limbs[(j * 32 + col) * kStride + k]. The
// balanced base-256 digits l_j in [-128, 128) of w are the bytes of
// w + 0x80..80 less 128, which as int8 are those bytes with the top bit
// flipped; a byte transpose (PRMT) packs each limb's 4 rows into a word.
__device__ __forceinline__ void store_unit(const uint64_t* raw_key, int8_t* limbs, int u) {
  constexpr uint64_t kHalf = 0x8080808080808080ull;
  const int chunk = u >> 5, lane = u & 31;
  const int col = (chunk & 3) * 8 + (lane & 7);
  const int k0 = (chunk >> 2) * 16 + 4 * (lane >> 3);
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint64_t v = (raw_key[(k0 + r) * kRawStride + col] + kHalf) ^ kHalf;
    lo[r] = static_cast<uint32_t>(v);
    hi[r] = static_cast<uint32_t>(v >> 32);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* x = h ? hi : lo;
    const uint32_t a01 = __byte_perm(x[0], x[1], 0x5140), b01 = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t a23 = __byte_perm(x[2], x[3], 0x5140), b23 = __byte_perm(x[2], x[3], 0x7362);
    const uint32_t out[4] = {__byte_perm(a01, a23, 0x5410), __byte_perm(a01, a23, 0x7632),
                             __byte_perm(b01, b23, 0x5410), __byte_perm(b01, b23, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(limbs + ((4 * h + j) * kCols + col) * kStride + k0) = out[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    tfhe_key_switch_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b_in, int b_stride,
                           const uint64_t* __restrict__ ka, const uint64_t* __restrict__ kb,
                           unsigned long long* __restrict__ out_a, unsigned long long* __restrict__ out_b,
                           Shape s) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* digs = smem;                      // [kRows][kStride]: digit of stage row k for each batch row
  int8_t* limbs = smem + kRows * kStride;   // [8][kCols][kStride]
  uint64_t* raw_key = reinterpret_cast<uint64_t*>(limbs + 8 * kCols * kStride);  // [kStageK][kRawStride]
  uint64_t* raw_x = raw_key + kStageK * kRawStride;                              // [kRows][sc], 16-byte aligned
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, s.batch - row0);
  const int split = blockIdx.y;
  const int st0 = static_cast<int>(static_cast<long long>(s.stages) * split / s.splits);
  const int st1 = static_cast<int>(static_cast<long long>(s.stages) * (split + 1) / s.splits);
  if (st0 >= st1) return;
  const uint64_t* a_rows = a + static_cast<size_t>(row0) * s.n_from;
  const int units = 8 * s.ks;  // 4-row units of the stage's key tile
  const int mp = warp & 3, nf = warp >> 2;

  int acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;

  issue_stage(raw_key, raw_x, a_rows, ka, kb, st0, n0, rows, s);
  for (int st = st0; st < st1; ++st) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the stage's words are in; the previous stage's products have read the buffers
    for (int u = tid; u < units; u += kThreads) store_unit(raw_key, limbs, u);
    // the digits of each (row, coefficient) of the stage, 4 coefficients a
    // thread; rows and coefficients past the data were staged as 0, whose
    // digits are 0
    for (int item = tid; item < kRows * (s.sc >> 2); item += kThreads) {
      const int row = item >> (s.sc_log - 2), cl = (item << 2) & (s.sc - 1), c = (st << s.sc_log) + cl;
      const ulonglong2* src = reinterpret_cast<const ulonglong2*>(raw_x + (row << s.sc_log) + cl);
      const ulonglong2 x01 = src[0], x23 = src[1];
      uint64_t x[4] = {x01.x, x01.y, x23.x, x23.y};
      if (s.big_n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = (c + q) & (s.big_n - 1) ? 0ull - x[q] : x[q];
      }
      digits4(x, s, digs + row * kStride + cl, s.sc);
    }
    for (int v = tid; v < kRows * (s.ks - s.d * s.sc); v += kThreads) {
      const int pad = s.ks - s.d * s.sc, row = v / pad;
      digs[row * kStride + s.d * s.sc + (v - row * pad)] = 0;
    }
    __syncthreads();  // the staged words are used
    // the next stage's device reads, in flight while this stage's products run
    if (st + 1 < st1) issue_stage(raw_key, raw_x, a_rows, ka, kb, st + 1, n0, rows, s);
    for (int k = 0; k < s.ks; k += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int8_t* base = digs + (mp * 32 + m * 16 + g) * kStride + k + tig * 4;
        af[m][0] = *reinterpret_cast<const uint32_t*>(base);
        af[m][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        af[m][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[m][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* bb = limbs + (j * kCols + nf * 8 + g) * kStride + k + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bb + 16);
        mma_s8(acc[0][j], af[0], b0, b1);
        mma_s8(acc[1][j], af[1], b0, b1);
      }
    }
  }

  // recombine sum_j s_j 2^(8 j) mod 2^64 and add into the output
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mp * 32 + m * 16 + g + 8 * (e >> 1);
      const int col = n0 + nf * 8 + 2 * tig + (e & 1);
      if (row >= rows || col > s.n_to) continue;
      uint64_t sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += static_cast<uint64_t>(static_cast<int64_t>(acc[m][j][e])) << (8 * j);
      if (col < s.n_to) {
        atomicAdd(out_a + static_cast<size_t>(row0 + row) * s.n_to + col, static_cast<unsigned long long>(sum));
      } else {
        if (split == 0) sum += __ldg(b_in + static_cast<size_t>(row0 + row) * b_stride);
        atomicAdd(out_b + row0 + row, static_cast<unsigned long long>(sum));
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace

extern "C" {

// a: (batch, n_from) masks, or the accumulator's (batch, k, N) masks when
// big_n > 0 (the extract folded in); b_in: the b to add, row r at
// r * b_stride; ksk_a (d, n_from, n_to), ksk_b (d, n_from); out_a (batch,
// n_to), out_b (batch,). The outputs are zeroed here, then summed into.
int lft_tfhe_key_switch(const void* a, const void* b_in, int b_stride, const void* ksk_a, const void* ksk_b,
                        void* out_a, void* out_b, int batch, int n_from, int n_to, int big_n, int log_b, int d,
                        int rounding_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n_from < 1 || n_to < 1 || log_b < 1 || log_b > 7 || d < 1 || log_b * d > 64 ||
      (big_n > 0 && (n_from % big_n || (big_n & (big_n - 1)))) || 4 * d > kStageK)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{batch, n_from, n_to, big_n, log_b, d, rounding_bits, rounding_bits >= 33 && log_b * d <= 31 ? 1 : 0,
          4, 2, 0, 0, 0};
  while (2 * s.sc <= std::min(kMaxCoefs, kStageTarget / d)) s.sc *= 2, ++s.sc_log;
  s.ks = (d * s.sc + 31) / 32 * 32;
  s.stages = (n_from + s.sc - 1) / s.sc;
  const int tiles = (n_to + 1 + kCols - 1) / kCols, groups = (batch + kRows - 1) / kRows;
  s.splits = std::max(1, std::min(s.stages, sm_count() / (tiles * groups)));
  cudaError_t err = cudaMemsetAsync(out_a, 0, static_cast<size_t>(batch) * n_to * 8, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(out_b, 0, static_cast<size_t>(batch) * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (kRows + 8 * kCols) * kStride + (kStageK * kRawStride + kRows * kMaxCoefs) * 8;
  static bool attr[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr[dev]) {
    err = cudaFuncSetAttribute(tfhe_key_switch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr[dev] = true;
  }
  tfhe_key_switch_kernel<<<dim3(tiles, s.splits, groups), kThreads, smem, st>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b_in), b_stride,
      static_cast<const uint64_t*>(ksk_a), static_cast<const uint64_t*>(ksk_b),
      static_cast<unsigned long long*>(out_a), static_cast<unsigned long long*>(out_b), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
