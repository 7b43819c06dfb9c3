// RNS fast base conversion (BEHZ, with its alpha*Q overshoot), for Hopper.
//
//   out[b, j, n] = (sum_i s[b, i, n] * table[j, i]) mod p_j
//
// Replaces two Pallas TPU kernels that compute the same function
// (tests/test_bconv_mxu.py holds them bit-identical):
//   * tpu_fhe/ops/bconv_pallas.py:39 _kernel (K11): u64 multiply-accumulate
//     into 128-bit accumulators, one Barrett landing per output limb;
//   * tpu_fhe/ops/bconv_mxu_pallas.py:82 _kernel (K12): the TPU default,
//     the same sum through int8 digit planes on the MXU.
// This kernel takes K11's form: one thread per output coefficient
// (b, j, n), a 128-bit (hi, lo) accumulator, a Barrett reduction with the
// two-word ratio floor(2^128/p) every 63 terms (each term is < 2^122, so
// 63 of them fit; tpu_fhe/ops/bconv.py _ACC_CHUNK) and a mod-p sum of the
// chunks.  Whether K12's int8 tensor-core form beats it is a measurement
// for a later change.
//
// What bounds it on the H100: bytes for the modup/moddown shapes (k <= 15
// inputs, m <= 30 outputs: about k*m 64x64->128 products per coefficient
// against (k + m) * 8 bytes moved).  Each thread reads its k inputs down a
// column (neighbouring threads on neighbouring n, so reads coalesce) and
// the table row is the same for the whole block (broadcast from cache).
// The k inputs are re-read once per output limb, from L2.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kChunk = 63;
constexpr int kThreads = 256;

__device__ __forceinline__ u64 csub(u64 a, u64 q) { return a >= q ? a - q : a; }

// Barrett reduction of the 128-bit (hi, lo) by q < 2^61 with
// floor(2^128/q) = r1:r0 (the same formula as tpu_fhe/ops/modmath.py
// barrett_reduce_u128).
__device__ __forceinline__ u64 barrett128(u64 hi, u64 lo, u64 q, u64 r0, u64 r1) {
  u64 carry = __umul64hi(lo, r0);
  u64 t2lo = lo * r1, t2hi = __umul64hi(lo, r1);
  const u64 t1 = t2lo + carry;
  const u64 t3 = t2hi + (t1 < carry);
  t2lo = hi * r0;
  t2hi = __umul64hi(hi, r0);
  const u64 t1b = t1 + t2lo;
  carry = t2hi + (t1b < t2lo);
  const u64 qe = hi * r1 + t3 + carry;
  return csub(lo - qe * q, q);
}

__global__ void bconv_kernel(const u64 *__restrict__ s, u64 *__restrict__ out,
                             const u64 *__restrict__ table, const u64 *__restrict__ p,
                             const u64 *__restrict__ ratio_lo, const u64 *__restrict__ ratio_hi,
                             int k, int m, int n) {
  const int j = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 pj = p[j], r0 = ratio_lo[j], r1 = ratio_hi[j];
  const u64 *src = s + (size_t)b * k * n + i;
  const u64 *row = table + (size_t)j * k;
  u64 res = 0;
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int c1 = c0 + kChunk < k ? c0 + kChunk : k;
    u64 hi = 0, lo = 0;
    for (int c = c0; c < c1; ++c) {
      const u64 a = src[(size_t)c * n], w = row[c];
      const u64 plo = a * w;
      lo += plo;
      hi += __umul64hi(a, w) + (lo < plo);
    }
    res = csub(res + barrett128(hi, lo, pj, r0, r1), pj);
  }
  out[((size_t)b * m + j) * n + i] = res;
}

}  // namespace

extern "C" {

// s: (batch, k, n); out: (batch, m, n); table: (m, k); p, ratio_lo, ratio_hi: (m,).
int tfhe_bconv(const u64 *s, u64 *out, const u64 *table, const u64 *p, const u64 *ratio_lo,
               const u64 *ratio_hi, int batch, int k, int m, int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, m, batch);
  bconv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, table, p, ratio_lo, ratio_hi, k, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
