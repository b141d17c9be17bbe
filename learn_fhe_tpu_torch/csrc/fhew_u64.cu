// K-EXTPROD64 and K-FHEW-BR64: the u64 engine's external product / key
// switch of a batch of RLWE ciphertexts, and the whole LMKCDEY blind
// rotation of a batch of FHEW ciphertexts in one launch.
//
// Replaces XLA fusions of the JAX package (no Pallas call):
//   K-EXTPROD64 <- rgsw.external_product's u64 branch (learn_fhe_tpu/models/
//                  fhew/rgsw.py:154-159), rgsw.internal_product (rgsw.py:179,
//                  every row of an RGSW through one external product; the
//                  hot loop of key_share_merge) and rlwe.key_switch's u64
//                  branch (rlwe.py:190-214);
//   K-FHEW-BR64 <- the u64 branch of the scan blind_rotate_core_fused
//                  (learn_fhe_tpu/models/fhew/bootstrapping.py:423, u32
//                  false at :436), vmapped over the batch.
// Both run lft64::phase (u64.cuh): per digit row the Zq gadget digit, its
// forward NTT, and its products with the key's evaluation-basis Montgomery
// rows summed in 128 bits; one REDC per output coefficient; two inverse
// NTTs. The results are bit-identical to external_product64_ref and
// blind_rotate_core_fused_ref's u64 branch.
//
// K-FHEW-BR64: each ciphertext walks its fused schedule of (ext_idx,
// auto_idx) pairs to its first (-1, -1). A step runs, if ext >= 0, the
// external product with brk[ext] (2d rows), then, if auto >= 0, the
// automorphism X -> X^t by the gather map and signs of ak[auto] and the key
// switch with ak[auto] (d rows), b += the gathered b.
//
// What bounds them on an H100: at the full multi-key set (q ~ 2^55, N =
// 2048, 2d = 10) an external product is 12 transforms of 2048 u64 points,
// some 135,000 Shoup butterflies of some twenty 32-bit instructions each,
// and its key rows are 320 KB; brk is 197 MB, far beyond the 50 MB L2, so a
// batch of 128 walks streams some 25 GB of key rows from device memory.
// Instructions and bytes come out of the same order. The design, simple
// first: one 512-thread block per ciphertext (one block on an SM: the u64
// passes take many registers), its accumulator (a, b) in shared memory for
// the whole walk; the digit rows go through a buffer of `group` rows (all of
// a phase's rows at both multi-key sets: 208 KB at N=2048), the passes of up
// to 3 layers on values in registers with a barrier after each, the key rows
// read from device memory once per phase, coalesced, into 128-bit sums held
// in registers.
//
// An index outside the key ends that ciphertext's walk (K-EXTPROD64: skips
// that input) before any read by it and ORs a bit into *error (1: ext or
// K-EXTPROD64's key index, 2: auto); that output then holds acc as it stood.
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"

namespace {

using lft64::kThreads;
constexpr int kBadExt = 1, kBadAuto = 2;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may take

// Shared memory of a block, in u64: acc (a, b), the gathered b, the digit rows.
__host__ __device__ constexpr size_t smem_values(int log_n, int group) {
  return static_cast<size_t>(3 + group) << log_n;
}

__device__ __forceinline__ void load_acc(uint64_t* acc, const uint64_t* __restrict__ a,
                                         const uint64_t* __restrict__ b, int log_n) {
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) << log_n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    acc[j] = __ldg(a + row + j);
    acc[n + j] = __ldg(b + row + j);
  }
  __syncthreads();
}

__device__ __forceinline__ void store_acc(const uint64_t* acc, uint64_t* __restrict__ a, uint64_t* __restrict__ b,
                                          int log_n) {
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) << log_n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    a[row + j] = acc[j];
    b[row + j] = acc[n + j];
  }
}

// Input i of the batch against key rows key_idx[i] (rows of 2^log_n each):
// an external product (key_switch 0, rows = 2d) or a key switch of the
// input (key_switch 1, rows = d).
__global__ void __launch_bounds__(kThreads, 1)
    external_product64_kernel(const uint64_t* __restrict__ ct_a, const uint64_t* __restrict__ ct_b,
                              uint64_t* __restrict__ out_a, uint64_t* __restrict__ out_b,
                              const int32_t* __restrict__ key_idx, const uint64_t* __restrict__ key_a,
                              const uint64_t* __restrict__ key_b, int n_keys, int rows, int key_switch,
                              lft64::Tables t, lft64::Gadget g, int log_n, int group, int* __restrict__ error) {
  extern __shared__ uint64_t sh[];
  const int n = 1 << log_n;
  uint64_t* acc = sh;
  uint64_t* gb = sh + 2 * n;
  uint64_t* buf = sh + 3 * n;
  load_acc(acc, ct_a, ct_b, log_n);
  const int e = key_idx[blockIdx.x];
  if (e < 0 || e >= n_keys) {
    if (threadIdx.x == 0) atomicOr(error, kBadExt);
  } else {
    const size_t key = static_cast<size_t>(e) * rows << log_n;
    if (key_switch) {
      lft64::phase<true>(acc, buf, group, gb, log_n, t, g, rows, key_a + key, key_b + key, nullptr, nullptr);
    } else {
      lft64::phase<false>(acc, buf, group, gb, log_n, t, g, rows, key_a + key, key_b + key, nullptr, nullptr);
    }
  }
  store_acc(acc, out_a, out_b, log_n);
}

__global__ void __launch_bounds__(kThreads, 1)
    fhew_blind_rotate64_kernel(const uint64_t* __restrict__ acc_a, const uint64_t* __restrict__ acc_b,
                               uint64_t* __restrict__ out_a, uint64_t* __restrict__ out_b,
                               const int32_t* __restrict__ ext_idx, const int32_t* __restrict__ auto_idx,
                               int steps, const uint64_t* __restrict__ brk_a, const uint64_t* __restrict__ brk_b,
                               int n_keys, const uint64_t* __restrict__ ak_a, const uint64_t* __restrict__ ak_b,
                               const int32_t* __restrict__ auto_src, const uint8_t* __restrict__ auto_sign,
                               int windows, lft64::Tables t, lft64::Gadget gg, lft64::Gadget gk, int log_n,
                               int group, int* __restrict__ error) {
  extern __shared__ uint64_t sh[];
  const int n = 1 << log_n;
  uint64_t* acc = sh;
  uint64_t* gb = sh + 2 * n;
  uint64_t* buf = sh + 3 * n;
  load_acc(acc, acc_a, acc_b, log_n);
  const int32_t* e_row = ext_idx + static_cast<size_t>(blockIdx.x) * steps;
  const int32_t* a_row = auto_idx + static_cast<size_t>(blockIdx.x) * steps;
  const int rows_g = 2 * gg.d;
  int bad = 0;
  for (int s = 0; s < steps; ++s) {
    const int e = e_row[s], au = a_row[s];  // the same for every thread of the block
    if (e == -1 && au == -1) break;         // the end of this ciphertext's schedule
    if (e < -1 || e >= n_keys) bad |= kBadExt;
    if (au < -1 || au >= windows) bad |= kBadAuto;
    if (bad) break;
    if (e >= 0) {
      const size_t key = static_cast<size_t>(e) * rows_g << log_n;
      lft64::phase<false>(acc, buf, group, gb, log_n, t, gg, rows_g, brk_a + key, brk_b + key, nullptr, nullptr);
    }
    if (au >= 0) {
      const size_t key = static_cast<size_t>(au) * gk.d << log_n;
      const size_t map = static_cast<size_t>(au) << log_n;
      lft64::phase<true>(acc, buf, group, gb, log_n, t, gk, gk.d, ak_a + key, ak_b + key, auto_src + map,
                         auto_sign + map);
    }
  }
  if (bad && threadIdx.x == 0) atomicOr(error, bad);
  store_acc(acc, out_a, out_b, log_n);
}

// The digit rows a block's buffer holds at once: as many of `rows` as fit
// in shared memory beside acc and the gathered b (all 10 of an external
// product at N=2048: 208 KB). Fewer rows at a time (4, then 5) ran slower
// on an H100: more barriers, fewer items per thread between them.
int group_rows(int log_n, int rows) {
  const int g = static_cast<int>(kMaxSmem / sizeof(uint64_t) >> log_n) - 3;
  return g < rows ? g : rows;
}

// Whether `rows` products of two residues sum below q 2^64, the bound of one
// REDC; and the shape and gadget arguments the kernels take.
bool bad_args(int log_n, uint64_t q, int rows, int log_b, int d) {
  if (log_n < 1 || log_n > lft64::kMaxLogN || q < 3 || q % 2 == 0 || q >= (1ull << 63)) return true;
  if (rows < 1 || log_b < 1 || d < 1 || log_b * d > 64) return true;
  const unsigned __int128 sq = static_cast<unsigned __int128>(q - 1) * (q - 1);
  return sq * static_cast<unsigned>(rows) >= static_cast<unsigned __int128>(q) << 64;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

lft64::Tables tables(const void* psi, const void* psi_s, const void* psi_inv, const void* psi_inv_s, uint64_t q,
                     uint64_t neg_q_inv, uint64_t n_inv, uint64_t n_inv_s) {
  return lft64::Tables{static_cast<const uint64_t*>(psi), static_cast<const uint64_t*>(psi_s),
                       static_cast<const uint64_t*>(psi_inv), static_cast<const uint64_t*>(psi_inv_s),
                       q, neg_q_inv, n_inv, n_inv_s};
}

}  // namespace

extern "C" {

// ct_a, ct_b, out_a, out_b: (batch, 2^log_n) residues; key_idx: (batch,)
// int32; key_a, key_b: (n_keys, rows, 2^log_n) evaluation-basis Montgomery
// rows; key_switch: 0 for an external product (rows = 2d), 1 for a key
// switch (rows = d); the plan's tables and constants; the gadget (log_b, d,
// rounding bits, 2^(bits-1) mod q); error: one int on the device.
int lft_external_product64(const void* ct_a, const void* ct_b, void* out_a, void* out_b, const void* key_idx,
                           int batch, const void* key_a, const void* key_b, int n_keys, int rows, int key_switch,
                           const void* psi, const void* psi_s, const void* psi_inv, const void* psi_inv_s,
                           int log_n, unsigned long long q, unsigned long long neg_q_inv, unsigned long long n_inv,
                           unsigned long long n_inv_s, int log_b, int d, int rb, unsigned long long half,
                           void* error, void* stream) {
  if (batch < 1 || n_keys < 1 || bad_args(log_n, q, rows, log_b, d) || rows != (key_switch ? d : 2 * d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = group_rows(log_n, rows);
  const size_t smem = smem_values(log_n, group) * sizeof(uint64_t);
  if (const int err = prepare(external_product64_kernel, smem)) return err;
  external_product64_kernel<<<static_cast<unsigned>(batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(ct_a), static_cast<const uint64_t*>(ct_b), static_cast<uint64_t*>(out_a),
      static_cast<uint64_t*>(out_b), static_cast<const int32_t*>(key_idx), static_cast<const uint64_t*>(key_a),
      static_cast<const uint64_t*>(key_b), n_keys, rows, key_switch,
      tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), lft64::make_gadget(log_b, d, rb, half),
      log_n, group, static_cast<int*>(error));
  return static_cast<int>(cudaGetLastError());
}

// The walk of `batch` ciphertexts over their (batch, steps) schedules: acc
// and out (batch, 2^log_n) a and b; brk (n_keys, 2d, 2^log_n), ak (windows,
// d_k, 2^log_n) evaluation-basis Montgomery rows; auto_src (windows, 2^log_n)
// int32, auto_sign bytes; the plan's tables and constants; the RGSW and the
// RLWE gadget; error: one int on the device, OR-ed with 1 (2) where an ext
// (auto) index lies outside the key.
int lft_fhew_blind_rotate64(const void* acc_a, const void* acc_b, void* out_a, void* out_b, const void* ext_idx,
                            const void* auto_idx, int batch, int steps, const void* brk_a, const void* brk_b,
                            int n_keys, const void* ak_a, const void* ak_b, const void* auto_src,
                            const void* auto_sign, int windows, const void* psi, const void* psi_s,
                            const void* psi_inv, const void* psi_inv_s, int log_n, unsigned long long q,
                            unsigned long long neg_q_inv, unsigned long long n_inv, unsigned long long n_inv_s,
                            int log_b_g, int d_g, int rb_g, unsigned long long half_g, int log_b_k, int d_k,
                            int rb_k, unsigned long long half_k, void* error, void* stream) {
  if (batch < 1 || steps < 0 || bad_args(log_n, q, 2 * d_g, log_b_g, d_g) || bad_args(log_n, q, d_k, log_b_k, d_k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = group_rows(log_n, 2 * d_g > d_k ? 2 * d_g : d_k);
  const size_t smem = smem_values(log_n, group) * sizeof(uint64_t);
  if (const int err = prepare(fhew_blind_rotate64_kernel, smem)) return err;
  fhew_blind_rotate64_kernel<<<static_cast<unsigned>(batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(acc_a), static_cast<const uint64_t*>(acc_b), static_cast<uint64_t*>(out_a),
      static_cast<uint64_t*>(out_b), static_cast<const int32_t*>(ext_idx), static_cast<const int32_t*>(auto_idx),
      steps, static_cast<const uint64_t*>(brk_a), static_cast<const uint64_t*>(brk_b), n_keys,
      static_cast<const uint64_t*>(ak_a), static_cast<const uint64_t*>(ak_b), static_cast<const int32_t*>(auto_src),
      static_cast<const uint8_t*>(auto_sign), windows,
      tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s),
      lft64::make_gadget(log_b_g, d_g, rb_g, half_g), lft64::make_gadget(log_b_k, d_k, rb_k, half_k), log_n, group,
      static_cast<int*>(error));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
