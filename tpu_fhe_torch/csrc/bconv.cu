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
//
// tfhe_bconv32 replaces the q32 plan's base conversion,
// tpu_fhe/ops/bconv_mxu_pallas.py:179 _kernel32 (K13), for residues and
// moduli below 2^30 stored as single u32 words.  Each product is below
// 2^60 and a row sum below k * 2^60 < 2^96 (bconv_mxu_pallas.py:186-188),
// so the sum runs exactly in a u64 plus a u32 carry word, for any k, and
// lands once per output limb by the word-fold Barrett of
// tpu_fhe/ops/u32pair.py barrett_reduce96_32: each 32-bit word is folded
// with a Shoup32 multiply by 2^(32 i) mod p.  K13 forms the same sum
// through int8 digit planes on the MXU; this is its SIMT form: one thread
// per coefficient keeps its first 32 inputs in registers across a tile of
// 8 output limbs (the tiles of a coefficient re-read its inputs from L2).
// Whether the int8 tensor-core (wgmma s8) form beats it is a measurement
// for a later change.  What bounds it: bytes, with the multiply count
// close behind (k word products per output coefficient).

#include "modarith.cuh"

namespace {

constexpr int kChunk = 63;
constexpr int kThreads = 256;

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
    for (int c = c0; c < c1; ++c) mac128(hi, lo, src[(size_t)c * n], row[c]);
    res = csub(res + barrett128(hi, lo, pj, r0, r1), pj);
  }
  out[((size_t)b * m + j) * n + i] = res;
}

constexpr int kRegK = 32;      // inputs a thread keeps in registers
constexpr int kOutTile = 8;    // output limbs per thread

__global__ void bconv32_kernel(const u32 *__restrict__ s, u32 *__restrict__ out,
                               const u32 *__restrict__ table, const u32 *__restrict__ p,
                               const u64 *__restrict__ fold, int k, int m, int n) {
  const int b = blockIdx.z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j0 = blockIdx.y * kOutTile;
  const int j1 = j0 + kOutTile < m ? j0 + kOutTile : m;
  const u32 *src = s + (size_t)b * k * n + i;
  u32 x[kRegK];
#pragma unroll
  for (int c = 0; c < kRegK; ++c) x[c] = c < k ? src[(size_t)c * n] : 0;
  for (int j = j0; j < j1; ++j) {
    const u32 *row = table + (size_t)j * k;
    u64 lo = 0;
    u32 hi = 0;
#pragma unroll
    for (int c = 0; c < kRegK; ++c) {
      if (c < k) mac96(hi, lo, x[c], row[c]);
    }
    for (int c = kRegK; c < k; ++c) mac96(hi, lo, src[(size_t)c * n], row[c]);
    out[((size_t)b * m + j) * n + i] = reduce96(lo, hi, p[j], fold, j, m);
  }
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

// s: (batch, k, n); out: (batch, m, n); table: (m, k); p: (m,), all u32
// words below 2^30; fold: (5, m) u64 constants (see reduce96).
int tfhe_bconv32(const u32 *s, u32 *out, const u32 *table, const u32 *p, const u64 *fold,
                 int batch, int k, int m, int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (m + kOutTile - 1) / kOutTile, batch);
  bconv32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, table, p, fold, k, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
