// Hybrid-keyswitch inner product with a Shoup-form key, for Hopper.
//
//   out[c, l, n] = sum_{d < beta} t[d, l, n] * evk[d, c, limb_map[l], n] mod q_l
//
// Replaces two Pallas TPU kernels reached from tpu_fhe/eval/evaluator.py
// key_inner_product, in two word sizes of one templated kernel:
//   * tpu_fhe/ops/ks_pallas.py:116 _kernel_shoup (K8), u64 residues,
//     evk_s = floor(evk * 2^64 / q)                      -> tfhe_ks_shoup
//   * tpu_fhe/ops/ks_pallas.py:147 _kernel32_shoup (K10), u32 residues of
//     the q32 plan (q < 2^30), evk_s = floor(evk * 2^32 / q) -> tfhe_ks_shoup32
// The relinearization key carries the Shoup companion words, so each digit
// product is one lazy Shoup multiply into [0, 2q) and the digit sum runs in
// a one-word accumulator with a conditional subtract of 2q (sums stay below
// 4q, which fits one u32 word for q < 2^30); one final conditional subtract
// lands [0, q).
//
// The key rows [0, size_Ql) ++ [size_Q, size_QP) of the key level are
// picked through limb_map, never concatenated (evaluator.py:417-422).
//
// What bounds it on the H100: bytes.  Per coefficient it reads beta t
// words and 4 * beta key words (two key parts, value and Shoup word) and
// writes two; the arithmetic is 6 * beta word multiplies.  The q32 form
// moves half the bytes.  One thread
// owns one coefficient of one QlP limb for both key parts, so each t word
// is read once, and neighbouring threads read neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef uint32_t u32;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ u64 mulhi(u64 a, u64 b) { return __umul64hi(a, b); }
__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }

template <typename W>
__device__ __forceinline__ W shoup_lazy(W a, W w, W ws, W q) {
  return a * w - mulhi(a, ws) * q;
}

template <typename W>
__device__ __forceinline__ W csub(W a, W q) { return a >= q ? a - q : a; }

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
    const W a = t[((size_t)d * L + l) * n + i];
    const size_t k0 = (((size_t)d * 2 + 0) * key_rows + key) * n + i;
    const size_t k1 = (((size_t)d * 2 + 1) * key_rows + key) * n + i;
    acc0 = csub(acc0 + shoup_lazy(a, evk[k0], evk_s[k0], q), q2);
    acc1 = csub(acc1 + shoup_lazy(a, evk[k1], evk_s[k1], q), q2);
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
