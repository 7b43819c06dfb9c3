// Hybrid-keyswitch inner product, for Hopper.
//
//   out[c, l, n] = sum_{d < beta} t[d, l, n] * evk[d, c, limb_map[l], n] mod q_l
//
// Replaces the four Pallas TPU kernels reached from
// tpu_fhe/eval/evaluator.py key_inner_product:
//   * tpu_fhe/ops/ks_pallas.py:54 _kernel (K7), u64 residues, a key without
//     Shoup words (the Galois keys' default)               -> tfhe_ks
//   * tpu_fhe/ops/ks_pallas.py:96 _kernel32 (K9), u32 residues of the q32
//     plan (q < 2^30), a key without Shoup words           -> tfhe_ks32
//   * tpu_fhe/ops/ks_pallas.py:116 _kernel_shoup (K8), u64 residues,
//     evk_s = floor(evk * 2^64 / q)                         -> tfhe_ks_shoup
//   * tpu_fhe/ops/ks_pallas.py:147 _kernel32_shoup (K10), u32 residues,
//     evk_s = floor(evk * 2^32 / q)                         -> tfhe_ks_shoup32
//
// K7 adds each digit's full 64x64 -> 128-bit product into a (hi, lo) pair
// and lands once with a Barrett reduction by floor(2^128/q); q < 2^61
// keeps beta * q^2 below 2^128 for beta <= 64 (the wrapper checks beta).
// K9's products are below 2^60: they sum exactly in a u64 and a u32 carry
// word, for any beta, and land once with the word-fold Barrett of the q32
// base conversion (reduce96).  With a Shoup-form key (K8, K10) each digit
// product is one lazy Shoup multiply into [0, 2q) and the digit sum runs in
// a one-word accumulator with a conditional subtract of 2q (sums stay below
// 4q, which fits one u32 word for q < 2^30); one final conditional subtract
// lands [0, q).  All four give the same canonical sum.
//
// The key rows [0, size_Ql) ++ [size_Q, size_QP) of the key level are
// picked through limb_map, never concatenated (evaluator.py:417-422); the
// digits d < beta of t and of the key are read, so a key of dnum > beta
// digits serves a lower level.
//
// What bounds it on the H100: bytes.  Per coefficient it reads beta t
// words and 2 * beta key words (4 * beta with Shoup words) and writes two;
// the arithmetic is a few word multiplies per key word.  A key without
// Shoup words moves half the key bytes of a Shoup-form one; the q32 forms
// move half the bytes of the u64 ones.  One thread owns one coefficient of
// one QlP limb for both key parts, so each t word is read once, and
// neighbouring threads read neighbouring addresses.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;

// Offsets of t[d, l, i] and of the two key parts evk[d, c, key, i].
struct Index {
  size_t t, k0, k1;
  __device__ Index(int d, int l, int64_t key, int i, int L, int key_rows, int n)
      : t(((size_t)d * L + l) * n + i),
        k0((((size_t)d * 2 + 0) * key_rows + key) * n + i),
        k1((((size_t)d * 2 + 1) * key_rows + key) * n + i) {}
};

__global__ void ks_kernel(const u64 *__restrict__ t, const u64 *__restrict__ evk,
                          const int64_t *__restrict__ limb_map, const u64 *__restrict__ q_all,
                          const u64 *__restrict__ ratio_lo, const u64 *__restrict__ ratio_hi,
                          u64 *__restrict__ out, int beta, int L, int key_rows, int n) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t key = limb_map[l];
  u64 hi0 = 0, lo0 = 0, hi1 = 0, lo1 = 0;
  for (int d = 0; d < beta; ++d) {
    const Index at(d, l, key, i, L, key_rows, n);
    const u64 a = t[at.t];
    mac128(hi0, lo0, a, evk[at.k0]);
    mac128(hi1, lo1, a, evk[at.k1]);
  }
  const u64 q = q_all[l], r0 = ratio_lo[l], r1 = ratio_hi[l];
  out[(size_t)l * n + i] = barrett128(hi0, lo0, q, r0, r1);
  out[((size_t)L + l) * n + i] = barrett128(hi1, lo1, q, r0, r1);
}

__global__ void ks32_kernel(const u32 *__restrict__ t, const u32 *__restrict__ evk,
                            const int64_t *__restrict__ limb_map, const u32 *__restrict__ q_all,
                            const u64 *__restrict__ fold, u32 *__restrict__ out, int beta, int L,
                            int key_rows, int n) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t key = limb_map[l];
  u64 lo0 = 0, lo1 = 0;
  u32 hi0 = 0, hi1 = 0;
  for (int d = 0; d < beta; ++d) {
    const Index at(d, l, key, i, L, key_rows, n);
    const u32 a = t[at.t];
    mac96(hi0, lo0, a, evk[at.k0]);
    mac96(hi1, lo1, a, evk[at.k1]);
  }
  const u32 q = q_all[l];
  out[(size_t)l * n + i] = reduce96(lo0, hi0, q, fold, l, L);
  out[((size_t)L + l) * n + i] = reduce96(lo1, hi1, q, fold, l, L);
}

template <typename W>
__global__ void ks_shoup_kernel(const W *__restrict__ t, const W *__restrict__ evk,
                                const W *__restrict__ evk_s,
                                const int64_t *__restrict__ limb_map,
                                const W *__restrict__ q_all, W *__restrict__ out,
                                int beta, int L, int key_rows, int n) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const W q = q_all[l], q2 = 2 * q;
  const int64_t key = limb_map[l];
  W acc0 = 0, acc1 = 0;
  for (int d = 0; d < beta; ++d) {
    const Index at(d, l, key, i, L, key_rows, n);
    const W a = t[at.t];
    acc0 = csub(acc0 + shoup_lazy(a, evk[at.k0], evk_s[at.k0], q), q2);
    acc1 = csub(acc1 + shoup_lazy(a, evk[at.k1], evk_s[at.k1], q), q2);
  }
  out[(size_t)l * n + i] = csub(acc0, q);
  out[((size_t)L + l) * n + i] = csub(acc1, q);
}

template <typename W>
int ks_shoup_impl(const W *t, const W *evk, const W *evk_s, const int64_t *limb_map,
                  const W *q, W *out, int beta, int L, int key_rows, int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, L);
  ks_shoup_kernel<W><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, evk, evk_s, limb_map, q, out, beta, L, key_rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// t: (>= beta, L, n); evk: (dnum >= beta, 2, key_rows, n); limb_map: (L,)
// rows of the key; q, ratio_lo, ratio_hi: (L,) moduli of QlP and the words
// of floor(2^128/q); out: (2, L, n).  beta <= 64.
int tfhe_ks(const u64 *t, const u64 *evk, const int64_t *limb_map, const u64 *q,
            const u64 *ratio_lo, const u64 *ratio_hi, u64 *out, int beta, int L, int key_rows,
            int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, L);
  ks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, evk, limb_map, q, ratio_lo, ratio_hi, out, beta, L, key_rows, n);
  return static_cast<int>(cudaGetLastError());
}

// The same as single u32 words (q < 2^30); fold: (5, L) u64 constants of
// the QlP moduli (see reduce96).  Any beta.
int tfhe_ks32(const u32 *t, const u32 *evk, const int64_t *limb_map, const u32 *q,
              const u64 *fold, u32 *out, int beta, int L, int key_rows, int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, L);
  ks32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, evk, limb_map, q, fold, out, beta, L, key_rows, n);
  return static_cast<int>(cudaGetLastError());
}

// t: (>= beta, L, n); evk, evk_s: (dnum >= beta, 2, key_rows, n);
// limb_map: (L,) rows of the key; q: (L,) moduli of QlP; out: (2, L, n).
int tfhe_ks_shoup(const u64 *t, const u64 *evk, const u64 *evk_s, const int64_t *limb_map,
                  const u64 *q, u64 *out, int beta, int L, int key_rows, int n,
                  void *stream) {
  return ks_shoup_impl<u64>(t, evk, evk_s, limb_map, q, out, beta, L, key_rows, n, stream);
}

// The same arguments as single u32 words (q < 2^30).
int tfhe_ks_shoup32(const u32 *t, const u32 *evk, const u32 *evk_s, const int64_t *limb_map,
                    const u32 *q, u32 *out, int beta, int L, int key_rows, int n,
                    void *stream) {
  return ks_shoup_impl<u32>(t, evk, evk_s, limb_map, q, out, beta, L, key_rows, n, stream);
}

}  // extern "C"
