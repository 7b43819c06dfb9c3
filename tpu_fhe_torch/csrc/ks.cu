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
//
// A batch of B ciphertexts (t of (B, beta, L, n), out (B, 2, L, n)) shares
// the key, and one launch serves it: a thread owns its coefficient in BT
// ciphertexts of the batch (BT = 1, 2 or 4, a compile-time per-thread
// batch with BT sets of accumulators), reads each key word once and
// applies it to the BT digit columns; grid.z covers the rest of B.  So the
// key's bytes are read ceil(B / BT) times per launch instead of B times,
// and the bound counts them once per launch.  A 3-D call is B = 1: BT = 1
// and the launch of one ciphertext.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;

// The per-thread batch for a batch of B ciphertexts.
int per_thread(int batch) { return batch >= 3 ? 4 : batch; }

// Offsets of the two key parts evk[d, c, key, i], and of t[b, d, l, i] in
// a batch of t tensors of beta * L * n words each.
struct Index {
  size_t k0, k1;
  __device__ Index(int d, int64_t key, int i, int key_rows, int n)
      : k0((((size_t)d * 2 + 0) * key_rows + key) * n + i),
        k1((((size_t)d * 2 + 1) * key_rows + key) * n + i) {}
};

__device__ __forceinline__ size_t t_at(int b, int d, int l, int i, int beta, int L, int n) {
  return (((size_t)b * beta + d) * L + l) * n + i;
}

// out[b, c, l, i]
__device__ __forceinline__ size_t out_at(int b, int c, int l, int i, int L, int n) {
  return (((size_t)b * 2 + c) * L + l) * n + i;
}

template <int BT>
__global__ void ks_kernel(const u64 *__restrict__ t, const u64 *__restrict__ evk,
                          const int64_t *__restrict__ limb_map, const u64 *__restrict__ q_all,
                          const u64 *__restrict__ ratio_lo, const u64 *__restrict__ ratio_hi,
                          u64 *__restrict__ out, int beta, int L, int key_rows, int n,
                          int batch) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.z * BT;
  if (i >= n) return;
  const int nb = min(BT, batch - b0);
  const int64_t key = limb_map[l];
  u64 hi0[BT], lo0[BT], hi1[BT], lo1[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) hi0[j] = lo0[j] = hi1[j] = lo1[j] = 0;
  for (int d = 0; d < beta; ++d) {
    const Index at(d, key, i, key_rows, n);
    const u64 k0 = evk[at.k0], k1 = evk[at.k1];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const u64 a = t[t_at(b0 + j, d, l, i, beta, L, n)];
        mac128(hi0[j], lo0[j], a, k0);
        mac128(hi1[j], lo1[j], a, k1);
      }
    }
  }
  const u64 q = q_all[l], r0 = ratio_lo[l], r1 = ratio_hi[l];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j < nb) {
      out[out_at(b0 + j, 0, l, i, L, n)] = barrett128(hi0[j], lo0[j], q, r0, r1);
      out[out_at(b0 + j, 1, l, i, L, n)] = barrett128(hi1[j], lo1[j], q, r0, r1);
    }
  }
}

template <int BT>
__global__ void ks32_kernel(const u32 *__restrict__ t, const u32 *__restrict__ evk,
                            const int64_t *__restrict__ limb_map, const u32 *__restrict__ q_all,
                            const u64 *__restrict__ fold, u32 *__restrict__ out, int beta, int L,
                            int key_rows, int n, int batch) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.z * BT;
  if (i >= n) return;
  const int nb = min(BT, batch - b0);
  const int64_t key = limb_map[l];
  u64 lo0[BT], lo1[BT];
  u32 hi0[BT], hi1[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    lo0[j] = lo1[j] = 0;
    hi0[j] = hi1[j] = 0;
  }
  for (int d = 0; d < beta; ++d) {
    const Index at(d, key, i, key_rows, n);
    const u32 k0 = evk[at.k0], k1 = evk[at.k1];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const u32 a = t[t_at(b0 + j, d, l, i, beta, L, n)];
        mac96(hi0[j], lo0[j], a, k0);
        mac96(hi1[j], lo1[j], a, k1);
      }
    }
  }
  const u32 q = q_all[l];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j < nb) {
      out[out_at(b0 + j, 0, l, i, L, n)] = reduce96(lo0[j], hi0[j], q, fold, l, L);
      out[out_at(b0 + j, 1, l, i, L, n)] = reduce96(lo1[j], hi1[j], q, fold, l, L);
    }
  }
}

template <typename W, int BT>
__global__ void ks_shoup_kernel(const W *__restrict__ t, const W *__restrict__ evk,
                                const W *__restrict__ evk_s,
                                const int64_t *__restrict__ limb_map,
                                const W *__restrict__ q_all, W *__restrict__ out,
                                int beta, int L, int key_rows, int n, int batch) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.z * BT;
  if (i >= n) return;
  const int nb = min(BT, batch - b0);
  const W q = q_all[l], q2 = 2 * q;
  const int64_t key = limb_map[l];
  W acc0[BT], acc1[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) acc0[j] = acc1[j] = 0;
  for (int d = 0; d < beta; ++d) {
    const Index at(d, key, i, key_rows, n);
    const W k0 = evk[at.k0], k1 = evk[at.k1], s0 = evk_s[at.k0], s1 = evk_s[at.k1];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const W a = t[t_at(b0 + j, d, l, i, beta, L, n)];
        acc0[j] = csub(acc0[j] + shoup_lazy(a, k0, s0, q), q2);
        acc1[j] = csub(acc1[j] + shoup_lazy(a, k1, s1, q), q2);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j < nb) {
      out[out_at(b0 + j, 0, l, i, L, n)] = csub(acc0[j], q);
      out[out_at(b0 + j, 1, l, i, L, n)] = csub(acc1[j], q);
    }
  }
}

dim3 grid_of(int n, int L, int batch) {
  const int bt = per_thread(batch);
  return dim3((n + kThreads - 1) / kThreads, L, (batch + bt - 1) / bt);
}

template <typename W>
int ks_shoup_impl(const W *t, const W *evk, const W *evk_s, const int64_t *limb_map,
                  const W *q, W *out, int beta, int L, int key_rows, int n, int batch,
                  void *stream) {
  const dim3 grid = grid_of(n, L, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (per_thread(batch)) {
    case 1:
      ks_shoup_kernel<W, 1><<<grid, kThreads, 0, s>>>(t, evk, evk_s, limb_map, q, out, beta,
                                                      L, key_rows, n, batch);
      break;
    case 2:
      ks_shoup_kernel<W, 2><<<grid, kThreads, 0, s>>>(t, evk, evk_s, limb_map, q, out, beta,
                                                      L, key_rows, n, batch);
      break;
    default:
      ks_shoup_kernel<W, 4><<<grid, kThreads, 0, s>>>(t, evk, evk_s, limb_map, q, out, beta,
                                                      L, key_rows, n, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The per-thread batch the kernels take for a batch of B ciphertexts.
int tfhe_ks_per_thread(int batch) { return per_thread(batch); }

// t: (batch, beta, L, n) digits (a 3-D call is batch 1); evk: (dnum >=
// beta, 2, key_rows, n); limb_map: (L,) rows of the key; q, ratio_lo,
// ratio_hi: (L,) moduli of QlP and the words of floor(2^128/q); out:
// (batch, 2, L, n).  beta <= 64.
int tfhe_ks(const u64 *t, const u64 *evk, const int64_t *limb_map, const u64 *q,
            const u64 *ratio_lo, const u64 *ratio_hi, u64 *out, int beta, int L, int key_rows,
            int n, int batch, void *stream) {
  const dim3 grid = grid_of(n, L, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (per_thread(batch)) {
    case 1:
      ks_kernel<1><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, ratio_lo, ratio_hi, out,
                                             beta, L, key_rows, n, batch);
      break;
    case 2:
      ks_kernel<2><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, ratio_lo, ratio_hi, out,
                                             beta, L, key_rows, n, batch);
      break;
    default:
      ks_kernel<4><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, ratio_lo, ratio_hi, out,
                                             beta, L, key_rows, n, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same as single u32 words (q < 2^30); fold: (5, L) u64 constants of
// the QlP moduli (see reduce96).  Any beta.
int tfhe_ks32(const u32 *t, const u32 *evk, const int64_t *limb_map, const u32 *q,
              const u64 *fold, u32 *out, int beta, int L, int key_rows, int n, int batch,
              void *stream) {
  const dim3 grid = grid_of(n, L, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (per_thread(batch)) {
    case 1:
      ks32_kernel<1><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, fold, out, beta, L,
                                               key_rows, n, batch);
      break;
    case 2:
      ks32_kernel<2><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, fold, out, beta, L,
                                               key_rows, n, batch);
      break;
    default:
      ks32_kernel<4><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, fold, out, beta, L,
                                               key_rows, n, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

// t: (batch, beta, L, n); evk, evk_s: (dnum >= beta, 2, key_rows, n);
// limb_map: (L,) rows of the key; q: (L,) moduli of QlP; out:
// (batch, 2, L, n).
int tfhe_ks_shoup(const u64 *t, const u64 *evk, const u64 *evk_s, const int64_t *limb_map,
                  const u64 *q, u64 *out, int beta, int L, int key_rows, int n, int batch,
                  void *stream) {
  return ks_shoup_impl<u64>(t, evk, evk_s, limb_map, q, out, beta, L, key_rows, n, batch,
                            stream);
}

// The same arguments as single u32 words (q < 2^30).
int tfhe_ks_shoup32(const u32 *t, const u32 *evk, const u32 *evk_s, const int64_t *limb_map,
                    const u32 *q, u32 *out, int beta, int L, int key_rows, int n, int batch,
                    void *stream) {
  return ks_shoup_impl<u32>(t, evk, evk_s, limb_map, q, out, beta, L, key_rows, n, batch,
                            stream);
}

}  // extern "C"
