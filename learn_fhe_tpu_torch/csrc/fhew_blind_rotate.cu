// K-FHEW-BR: the whole LMKCDEY blind rotation of a batch of FHEW
// ciphertexts in one launch, and the host transcription of its schedule.
//
// Replaces the XLA scan learn_fhe_tpu/models/fhew/bootstrapping.py:423
// (blind_rotate_core_fused, vmapped over the batch at parallel/batch.py:
// 100-105; no Pallas call). Each ciphertext walks its fused schedule of
// (ext_idx, auto_idx) pairs to its first (-1, -1). A step runs
//   1. if ext >= 0, the external product with brk[ext]: the gadget digits
//      of acc's a and b (decompose_zq32, 2d rows), their forward NTTs, per
//      coefficient the Shoup contraction over the 2d rows with the key's
//      a and b rows, two inverse NTTs; the result replaces acc;
//   2. if auto >= 0, the automorphism X -> X^t by the gather map and signs
//      of ak[auto], then the RLWE key switch: the digits of the gathered a
//      (d rows), their forward NTTs, the contraction with ak[auto], two
//      inverse NTTs, and b += the gathered b.
// A phase whose index is -1 is skipped (the JAX vmap pays for both and
// discards one; the result is the same). Every operation is exact mod q, so
// the result is bit-identical to blind_rotate_core_fused_ref.
//
// What bounds it on an H100: integer instruction issue. At the reference
// fixture (N=512, d=4, batch 128) a step is 16 transforms of 512 points per
// ciphertext, about 0.65 M integer instructions, while the keys it reads
// (brk 6.6 MB, ak 0.36 MB) stay in the 50 MB L2. The design:
//   - one 256-thread block per ciphertext, its accumulator (a, b) in shared
//     memory for the whole walk; blocks are independent, so there is no
//     cluster and no synchronisation between blocks, and the block reads its
//     own schedule row;
//   - the digit rows (16 KB at N=512, 2d = 8 rows) wait in a swizzled shared
//     buffer between NTT passes, and the passes run on values held in
//     registers with the helpers that K-NTT and K-STEP share (ntt32.cuh;
//     [3, 3, 3] layers at N=512), one barrier per pass. With 256 threads a
//     forward pass over 8 rows is 2 items of 8 values a thread, and the
//     inverse passes over 2 rows give half the threads one item each;
//   - the twiddle tables are staged in shared memory once per launch;
//   - the contraction reads the key rows with coalesced loads, one
//     coefficient per thread, and writes its two sums over rows 0 and 1 of
//     the buffer, which only the same thread reads;
//   - one instance per ring size 2^LOG_N, so the passes' index arithmetic
//     is constant; the digit count is a run-time value.
// One block per ciphertext puts at most a few blocks on an SM: at batch 128
// the card runs one ciphertext on each of 128 of its 132 SMs. Several
// ciphertexts per block, more resident warps and cheaper conditional
// subtracts are the known ways to make it faster.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>
#include <vector>

#include "ntt32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 11;
constexpr int kMaxRows = 16;  // digit rows of the shared buffer: max(2d, d_ks)

// Zq gadget: log_b, digits, rounding bits and 2^(bits-1) mod q.
struct Gadget {
  int log_b, d, rb;
  uint32_t half;
};

// What a block works on: its shared buffer, the staged twiddles, the prime.
struct Walk {
  uint32_t* buf;  // digit rows: value i of the rows at lft::swizzle(i)
  const uint32_t* psi;
  const uint32_t* psi_s;
  const uint32_t* psi_inv;
  const uint32_t* psi_inv_s;
  uint32_t q, n_inv, n_inv_s;
};

// The d digits of a residue x < q into rows row0 .. row0+d-1 at column j:
// decompose_zq32 of learn_fhe_tpu/ops/gadget.py:108-137 on u32 lanes.
template <int LOG_N>
__device__ __forceinline__ void store_digits(const Walk& k, const Gadget& g, uint32_t x, int row0, int j) {
  const uint32_t q = k.q;
  if (g.rb) x = lft::add_mod(x, g.half, q) >> g.rb;
  uint32_t v = x < (q >> 1) ? x : x - q;  // the centered lift, two's complement
  const uint32_t mask = (1u << g.log_b) - 1u, b_by_2 = 1u << (g.log_b - 1), neg_b = q - (1u << g.log_b);
  for (int i = 0; i < g.d; ++i) {
    const uint32_t limb = v & mask;
    const uint32_t carry = limb + (v & 1u) > b_by_2 ? 1u : 0u;
    v = (v >> g.log_b) + carry;
    k.buf[lft::swizzle(((row0 + i) << LOG_N) + j)] = limb + carry * neg_b;
  }
}

// Forward pass P (layers 3P .. 3P+W-1) of rows 0 .. rows-1 of the buffer,
// then the passes after it; each ends at a barrier.
template <int LOG_N, int P>
__device__ __forceinline__ void forward_passes(const Walk& k, int rows) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  constexpr int log_h = LOG_N - L0 - W;
  constexpr int log_items = LOG_N - W;  // items of a row: 2^log_items
  for (int t = threadIdx.x; t < (rows << log_items); t += kThreads) {
    const int i = t & ((1 << log_items) - 1);
    const int hi = i >> log_h;
    const int base = ((t >> log_items) << LOG_N) + (hi << (LOG_N - L0)) + (i & ((1 << log_h) - 1));
    uint32_t x[R], w[R - 1], ws[R - 1];
    lft::load_row<W, log_h>(x, k.buf, base);
    lft::pass_twiddles<W>(w, ws, k.psi, k.psi_s, L0, hi);
    lft::fwd_radix<W>(x, w, ws, k.q);
    lft::store_row<W, log_h>(x, k.buf, base);
  }
  __syncthreads();
  if constexpr (P + 1 < lft::pass_count(LOG_N)) forward_passes<LOG_N, P + 1>(k, rows);
}

// Inverse pass P of rows 0 and 1 (the 1/N scale in pass 0), then P-1 .. 0;
// each ends at a barrier.
template <int LOG_N, int P>
__device__ __forceinline__ void inverse_passes(const Walk& k) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  constexpr int log_h = LOG_N - L0 - W;
  constexpr int log_items = LOG_N - W;
  for (int t = threadIdx.x; t < (2 << log_items); t += kThreads) {
    const int i = t & ((1 << log_items) - 1);
    const int hi = i >> log_h;
    const int base = ((t >> log_items) << LOG_N) + (hi << (LOG_N - L0)) + (i & ((1 << log_h) - 1));
    uint32_t x[R], w[R - 1], ws[R - 1];
    lft::load_row<W, log_h>(x, k.buf, base);
    lft::pass_twiddles<W>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
    lft::inv_radix<W>(x, w, ws, k.q);
    if constexpr (P == 0) {
#pragma unroll
      for (int m = 0; m < R; ++m) x[m] = lft::mul_shoup(x[m], k.n_inv, k.n_inv_s, k.q);
    }
    lft::store_row<W, log_h>(x, k.buf, base);
  }
  __syncthreads();
  if constexpr (P > 0) inverse_passes<LOG_N, P - 1>(k);
}

// Per coefficient j: the sums over the `rows` NTT rows of row r times key
// row r (Shoup, with the key's duals), for the key's a and b parts; written
// to rows 0 and 1 at column j, which no other thread reads. Ends at a barrier.
template <int LOG_N>
__device__ __forceinline__ void contract(const Walk& k, int rows, const uint32_t* __restrict__ ka,
                                         const uint32_t* __restrict__ kad,
                                         const uint32_t* __restrict__ kb,
                                         const uint32_t* __restrict__ kbd) {
  constexpr int n = 1 << LOG_N;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    uint32_t sa = 0, sb = 0;
    for (int r = 0; r < rows; ++r) {
      const int at = (r << LOG_N) + j;
      const uint32_t x = k.buf[lft::swizzle(at)];
      sa = lft::add_mod(sa, lft::mul_shoup(x, __ldg(ka + at), __ldg(kad + at), k.q), k.q);
      sb = lft::add_mod(sb, lft::mul_shoup(x, __ldg(kb + at), __ldg(kbd + at), k.q), k.q);
    }
    k.buf[lft::swizzle(j)] = sa;
    k.buf[lft::swizzle(n + j)] = sb;
  }
  __syncthreads();
}

// Values of the digit buffer: rows of N, rounded up to a multiple of 32 so
// that lft::swizzle maps the buffer onto itself.
__host__ __device__ constexpr int buffer_values(int rows, int log_n) {
  return (((rows << log_n) + 31) / 32) * 32;
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
    fhew_blind_rotate_kernel(const uint32_t* __restrict__ acc_a, const uint32_t* __restrict__ acc_b,
                             uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_b,
                             const int32_t* __restrict__ ext_idx, const int32_t* __restrict__ auto_idx,
                             int steps, const uint32_t* __restrict__ brk_a,
                             const uint32_t* __restrict__ brk_ad, const uint32_t* __restrict__ brk_b,
                             const uint32_t* __restrict__ brk_bd, const uint32_t* __restrict__ ak_a,
                             const uint32_t* __restrict__ ak_ad, const uint32_t* __restrict__ ak_b,
                             const uint32_t* __restrict__ ak_bd, const int32_t* __restrict__ auto_src,
                             const uint8_t* __restrict__ auto_sign, const uint32_t* __restrict__ psi,
                             const uint32_t* __restrict__ psi_s, const uint32_t* __restrict__ psi_inv,
                             const uint32_t* __restrict__ psi_inv_s, uint32_t q, uint32_t n_inv,
                             uint32_t n_inv_s, Gadget gg, Gadget gk, int buf_values) {
  extern __shared__ uint4 sh4[];  // 16-byte aligned for the buffer's vector accesses
  constexpr int n = 1 << LOG_N;
  uint32_t* buf = reinterpret_cast<uint32_t*>(sh4);
  uint32_t* tw = buf + buf_values;  // psi, psi_s, psi_inv, psi_inv_s
  uint32_t* a = tw + 4 * n;         // the accumulator
  uint32_t* b = a + n;
  uint32_t* gathered_b = b + n;  // the automorphism's b, added after its key switch
  const size_t row = static_cast<size_t>(blockIdx.x) << LOG_N;
  const uint32_t* tables[4] = {psi, psi_s, psi_inv, psi_inv_s};
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int t = 0; t < 4; ++t) tw[t * n + j] = __ldg(tables[t] + j);
    a[j] = __ldg(acc_a + row + j);
    b[j] = __ldg(acc_b + row + j);
  }
  __syncthreads();
  const Walk k{buf, tw, tw + n, tw + 2 * n, tw + 3 * n, q, n_inv, n_inv_s};
  constexpr int kLastPass = lft::pass_count(LOG_N) - 1;
  const int32_t* e_row = ext_idx + static_cast<size_t>(blockIdx.x) * steps;
  const int32_t* a_row = auto_idx + static_cast<size_t>(blockIdx.x) * steps;

  for (int s = 0; s < steps; ++s) {
    const int e = e_row[s], au = a_row[s];  // the same for every thread of the block
    if (e < 0 && au < 0) break;             // the end of this ciphertext's schedule
    if (e >= 0) {
      for (int j = threadIdx.x; j < n; j += kThreads) {
        store_digits<LOG_N>(k, gg, a[j], 0, j);
        store_digits<LOG_N>(k, gg, b[j], gg.d, j);
      }
      __syncthreads();
      forward_passes<LOG_N, 0>(k, 2 * gg.d);
      const size_t key = static_cast<size_t>(e) * (2 * gg.d) << LOG_N;
      contract<LOG_N>(k, 2 * gg.d, brk_a + key, brk_ad + key, brk_b + key, brk_bd + key);
      inverse_passes<LOG_N, kLastPass>(k);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        a[j] = buf[lft::swizzle(j)];
        b[j] = buf[lft::swizzle(n + j)];
      }
      __syncthreads();
    }
    if (au >= 0) {
      const int32_t* src = auto_src + (static_cast<size_t>(au) << LOG_N);
      const uint8_t* sign = auto_sign + (static_cast<size_t>(au) << LOG_N);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const int from = __ldg(src + j);
        uint32_t ga = a[from], gb = b[from];
        if (__ldg(sign + j)) {
          ga = ga ? q - ga : 0u;
          gb = gb ? q - gb : 0u;
        }
        store_digits<LOG_N>(k, gk, ga, 0, j);
        gathered_b[j] = gb;
      }
      __syncthreads();
      forward_passes<LOG_N, 0>(k, gk.d);
      const size_t key = static_cast<size_t>(au) * gk.d << LOG_N;
      contract<LOG_N>(k, gk.d, ak_a + key, ak_ad + key, ak_b + key, ak_bd + key);
      inverse_passes<LOG_N, kLastPass>(k);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        a[j] = buf[lft::swizzle(j)];
        b[j] = lft::add_mod(buf[lft::swizzle(n + j)], gathered_b[j], q);
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    out_a[row + j] = a[j];
    out_b[row + j] = b[j];
  }
}

using WalkKernel = decltype(&fhew_blind_rotate_kernel<1>);

template <int... L>
WalkKernel walk_kernel_at(int log_n, std::integer_sequence<int, L...>) {
  static const WalkKernel table[] = {fhew_blind_rotate_kernel<L + 1>...};
  return table[log_n - 1];
}

// ---------------------------------------------------------------------------
// The schedule, on the host: the C transcription of build_schedule and
// fuse_schedule (learn_fhe_tpu_torch/models/fhew/bootstrapping.py), a copy
// of native/fhe_native.cpp:180-268.
// ---------------------------------------------------------------------------

using i64 = long long;

}  // namespace

extern "C" {

int lft_fhew_blind_rotate(const void* acc_a, const void* acc_b, void* out_a, void* out_b,
                          const void* ext_idx, const void* auto_idx, int batch, int steps,
                          const void* brk_a, const void* brk_ad, const void* brk_b,
                          const void* brk_bd, const void* ak_a, const void* ak_ad,
                          const void* ak_b, const void* ak_bd, const void* auto_src,
                          const void* auto_sign, const void* psi, const void* psi_s,
                          const void* psi_inv, const void* psi_inv_s, int log_n, unsigned int q,
                          unsigned int n_inv, unsigned int n_inv_s, int log_b_g, int d_g, int rb_g,
                          unsigned int half_g, int log_b_k, int d_k, int rb_k, unsigned int half_k,
                          void* stream) {
  const int rows = 2 * d_g > d_k ? 2 * d_g : d_k;
  if (batch < 1 || steps < 0 || log_n < 1 || log_n > kMaxLogN || d_g < 1 || d_k < 1 ||
      rows > kMaxRows || log_b_g < 1 || log_b_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int buf_values = buffer_values(rows < 2 ? 2 : rows, log_n);
  const size_t smem = (static_cast<size_t>(buf_values) + (7u << log_n)) * sizeof(uint32_t);
  const WalkKernel kernel = walk_kernel_at(log_n, std::make_integer_sequence<int, kMaxLogN>{});
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc_a), static_cast<const uint32_t*>(acc_b),
      static_cast<uint32_t*>(out_a), static_cast<uint32_t*>(out_b),
      static_cast<const int32_t*>(ext_idx), static_cast<const int32_t*>(auto_idx), steps,
      static_cast<const uint32_t*>(brk_a), static_cast<const uint32_t*>(brk_ad),
      static_cast<const uint32_t*>(brk_b), static_cast<const uint32_t*>(brk_bd),
      static_cast<const uint32_t*>(ak_a), static_cast<const uint32_t*>(ak_ad),
      static_cast<const uint32_t*>(ak_b), static_cast<const uint32_t*>(ak_bd),
      static_cast<const int32_t*>(auto_src), static_cast<const uint8_t*>(auto_sign),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s),
      static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_s), q, n_inv,
      n_inv_s, Gadget{log_b_g, d_g, rb_g, half_g}, Gadget{log_b_k, d_k, rb_k, half_k}, buf_values);
  return static_cast<int>(cudaGetLastError());
}

// For each of `batch` rows of a (values in Z_2N), the (op, idx) schedule of
// length sched_len: op 0 = external product (idx = key index j), 1 =
// automorphism by g^idx (idx 0: t = -g), 2 = padding. minus_map, plus_map:
// (2N,) value -> dlog or -1. Returns 0, or -1 if a schedule overflows
// sched_len or a value is in both tables.
int lft_fhew_build_schedule(const i64* a, i64 batch, i64 n_lwe, const i64* minus_map,
                            const i64* plus_map, i64 half, int window, int32_t* ops,
                            int32_t* idxs, i64 sched_len) {
  std::vector<std::vector<int32_t>> i_minus(half), i_plus(half);
  for (i64 t = 0; t < batch; ++t) {
    for (i64 l = 0; l < half; ++l) {
      i_minus[l].clear();
      i_plus[l].clear();
    }
    const i64* row = a + t * n_lwe;
    for (i64 j = 0; j < n_lwe; ++j) {
      const i64 aj = row[j];
      const i64 lm = minus_map[aj], lp = plus_map[aj];
      if (lm >= 0 && lp < 0) {
        i_minus[lm].push_back(static_cast<int32_t>(j));
      } else if (lp >= 0 && lm < 0) {
        i_plus[lp].push_back(static_cast<int32_t>(j));
      } else if (aj != 0) {
        return -1;
      }
    }
    int32_t* op_row = ops + t * sched_len;
    int32_t* idx_row = idxs + t * sched_len;
    i64 k = 0;
    auto emit = [&](int32_t op, int32_t idx) -> bool {
      if (k >= sched_len) return false;
      op_row[k] = op;
      idx_row[k] = idx;
      ++k;
      return true;
    };
    auto walk = [&](const std::vector<std::vector<int32_t>>& buckets) -> bool {
      int v = 0;
      for (i64 l = static_cast<i64>(buckets.size()) - 1; l >= 1; --l) {
        for (int32_t j : buckets[l]) {
          if (!emit(0, j)) return false;
        }
        v += 1;
        if (!buckets[l - 1].empty() || v == window || l == 1) {
          if (!emit(1, v)) return false;
          v = 0;
        }
      }
      return true;
    };
    bool ok = walk(i_minus);
    for (int32_t j : i_minus[0]) ok = ok && emit(0, j);
    ok = ok && emit(1, 0);  // ak[0]: t = -g
    ok = ok && walk(i_plus);
    for (int32_t j : i_plus[0]) ok = ok && emit(0, j);
    if (!ok) return -1;
    for (; k < sched_len; ++k) {
      op_row[k] = 2;
      idx_row[k] = 0;
    }
  }
  return 0;
}

// Each automorphism merged into the external product before it: (ops, idxs)
// (batch, sched_len) to (e_out, a_out) of the same shape, -1 where absent.
// Returns the longest fused schedule of the batch.
int lft_fhew_fuse_schedule(const int32_t* ops, const int32_t* idxs, i64 batch, i64 sched_len,
                           int32_t* e_out, int32_t* a_out) {
  i64 max_len = 0;
  for (i64 b = 0; b < batch; ++b) {
    const int32_t* op_row = ops + b * sched_len;
    const int32_t* idx_row = idxs + b * sched_len;
    int32_t* e_row = e_out + b * sched_len;
    int32_t* a_row = a_out + b * sched_len;
    for (i64 t = 0; t < sched_len; ++t) e_row[t] = a_row[t] = -1;
    i64 k = 0;
    bool open_ext = false;
    for (i64 t = 0; t < sched_len; ++t) {
      const int32_t op = op_row[t];
      if (op == 0) {
        e_row[k++] = idx_row[t];
        open_ext = true;
      } else if (op == 1) {
        if (open_ext) {
          a_row[k - 1] = idx_row[t];
          open_ext = false;
        } else {
          a_row[k++] = idx_row[t];
        }
      } else {
        break;  // padding, only at the tail
      }
    }
    if (k > max_len) max_len = k;
  }
  return static_cast<int>(max_len);
}

}  // extern "C"
