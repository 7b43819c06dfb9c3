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
// What bounds them on the H100: bytes.  Per coefficient a launch reads
// beta t words per ciphertext, 2 * beta key words (4 * beta with Shoup
// words) once, and writes two words per ciphertext; the arithmetic is a
// few word multiplies per key word.
//
// K7, K8, K10 (ks_kernel, ks_shoup_kernel): one thread owns one
// coefficient of one QlP limb for both key parts in BT = 1, 2 or 4
// ciphertexts of a batch (t (B, beta, L, n), out (B, 2, L, n)), a
// compile-time per-thread batch with BT sets of accumulators; it reads
// each key word once and applies it to the BT digit columns, and grid.z
// covers the rest of B, so the key crosses memory ceil(B / BT) times.
//
// K9 (ks32_kernel), designed for the card as a stream: a block owns 1024
// coefficients of one limb, 4 consecutive ones a thread.
//   * The key is read once per launch: a thread loads its 2 * beta key
//     words once (16-byte loads, into registers for beta <= 4) and walks
//     the whole batch, two ciphertexts at a time, so the bytes moved are
//     the bytes the bound counts (at B = 16 the old grid.z read the 93 MB
//     of key rows, more than the 50 MB L2, 4 times).
//   * Every access is 16 bytes a thread: t through streaming loads, out
//     through streaming stores (st.global.cs; nothing reads it back), from
//     pointers computed once and advanced by strides.
//   * The limb's modulus and its five fold words sit in registers for the
//     block's life.  For beta <= 4 (every q32 path: beta is 2) the digit
//     loop is unrolled and the sum of beta products below 2^60 fits one
//     u64 (< 2^62), so the landing's third word is zero; any other beta
//     takes the runtime loop with the u32 carry word, exact for any beta.
//   * Two ciphertexts' 2 * beta loads a thread are in flight at once.

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

// K9: 4 coefficients a thread, kThreads threads a block, one limb a block
// row (blockIdx.y).
constexpr int kVec = 4;

// A limb's modulus and reduce96's five words.
struct Limb32 {
  u32 q, f0, f1, f1s, f2, f2s;
  __device__ u32 land(u64 lo, u32 w2) const { return reduce96(lo, w2, q, f0, f1, f1s, f2, f2s); }
};

__device__ __forceinline__ uint4 ld_key(const u32 *p) {
  return __ldg(reinterpret_cast<const uint4 *>(p));
}
__device__ __forceinline__ uint4 ld_stream(const u32 *p) {
  return __ldcs(reinterpret_cast<const uint4 *>(p));
}
__device__ __forceinline__ void st_stream(u32 *p, uint4 v) {
  __stcs(reinterpret_cast<uint4 *>(p), v);
}

// sum_d a[d] * k[d] mod q word by word, for BETA <= 4 digits (the sum of
// BETA products below 2^60 is below 2^62: one u64, no carry word).
template <int BETA>
__device__ __forceinline__ uint4 digit_dot(const uint4 (&a)[BETA], const uint4 (&k)[BETA],
                                           const Limb32 &c) {
  u64 x = 0, y = 0, z = 0, w = 0;
#pragma unroll
  for (int d = 0; d < BETA; ++d) {
    x += static_cast<u64>(a[d].x) * k[d].x;
    y += static_cast<u64>(a[d].y) * k[d].y;
    z += static_cast<u64>(a[d].z) * k[d].z;
    w += static_cast<u64>(a[d].w) * k[d].w;
  }
  return make_uint4(c.land(x, 0), c.land(y, 0), c.land(z, 0), c.land(w, 0));
}

// BETA = 1 .. 4: the digit loop unrolled, the thread's key words in
// registers; BETA = 0: any beta, the key words re-read (from L1/L2) for each
// ciphertext and summed with the carry word.
template <int BETA>
__global__ void __launch_bounds__(kThreads)
ks32_kernel(const u32 *__restrict__ t, const u32 *__restrict__ evk,
            const int64_t *__restrict__ limb_map, const u32 *__restrict__ q_all,
            const u64 *__restrict__ fold, u32 *__restrict__ out, int beta, int L,
            int key_rows, int n, int batch) {
  const int l = blockIdx.y;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i >= n) return;
  const Limb32 c{q_all[l],
                 static_cast<u32>(fold[l]), static_cast<u32>(fold[L + l]),
                 static_cast<u32>(fold[2 * L + l]), static_cast<u32>(fold[3 * L + l]),
                 static_cast<u32>(fold[4 * L + l])};
  const size_t plane = static_cast<size_t>(L) * n;          // t[b, d], out[b, c]
  const size_t key_plane = static_cast<size_t>(key_rows) * n;  // evk[d, c]
  const u32 *key = evk + limb_map[l] * n + i;                // evk[d, c] at + (2d + c) key_plane
  const u32 *tp = t + static_cast<size_t>(l) * n + i;        // t[b, d] at + d plane
  u32 *op = out + static_cast<size_t>(l) * n + i;            // out[b, c] at + c plane
  if constexpr (BETA > 0) {
    uint4 k0[BETA], k1[BETA];
#pragma unroll
    for (int d = 0; d < BETA; ++d) {
      k0[d] = ld_key(key + 2 * d * key_plane);
      k1[d] = ld_key(key + (2 * d + 1) * key_plane);
    }
    int b = 0;
    for (; b + 2 <= batch; b += 2, tp += 2 * BETA * plane, op += 4 * plane) {
      uint4 a0[BETA], a1[BETA];
#pragma unroll
      for (int d = 0; d < BETA; ++d) {
        a0[d] = ld_stream(tp + d * plane);
        a1[d] = ld_stream(tp + (BETA + d) * plane);
      }
      st_stream(op, digit_dot<BETA>(a0, k0, c));
      st_stream(op + plane, digit_dot<BETA>(a0, k1, c));
      st_stream(op + 2 * plane, digit_dot<BETA>(a1, k0, c));
      st_stream(op + 3 * plane, digit_dot<BETA>(a1, k1, c));
    }
    if (b < batch) {
      uint4 a0[BETA];
#pragma unroll
      for (int d = 0; d < BETA; ++d) a0[d] = ld_stream(tp + d * plane);
      st_stream(op, digit_dot<BETA>(a0, k0, c));
      st_stream(op + plane, digit_dot<BETA>(a0, k1, c));
    }
  } else {
    for (int b = 0; b < batch; ++b, tp += beta * plane, op += 2 * plane) {
      u64 lo0[kVec] = {0, 0, 0, 0}, lo1[kVec] = {0, 0, 0, 0};
      u32 hi0[kVec] = {0, 0, 0, 0}, hi1[kVec] = {0, 0, 0, 0};
      for (int d = 0; d < beta; ++d) {
        const uint4 av = ld_stream(tp + d * plane);
        const uint4 kv0 = ld_key(key + 2 * d * key_plane), kv1 = ld_key(key + (2 * d + 1) * key_plane);
        const u32 a[kVec] = {av.x, av.y, av.z, av.w};
        const u32 w0[kVec] = {kv0.x, kv0.y, kv0.z, kv0.w}, w1[kVec] = {kv1.x, kv1.y, kv1.z, kv1.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          mac96(hi0[e], lo0[e], a[e], w0[e]);
          mac96(hi1[e], lo1[e], a[e], w1[e]);
        }
      }
      st_stream(op, make_uint4(c.land(lo0[0], hi0[0]), c.land(lo0[1], hi0[1]),
                               c.land(lo0[2], hi0[2]), c.land(lo0[3], hi0[3])));
      st_stream(op + plane, make_uint4(c.land(lo1[0], hi1[0]), c.land(lo1[1], hi1[1]),
                                       c.land(lo1[2], hi1[2]), c.land(lo1[3], hi1[3])));
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
// the QlP moduli (see reduce96).  Any beta.  n a multiple of 4, and t, evk
// and out 16-byte aligned (the wrapper checks both).
int tfhe_ks32(const u32 *t, const u32 *evk, const int64_t *limb_map, const u32 *q,
              const u64 *fold, u32 *out, int beta, int L, int key_rows, int n, int batch,
              void *stream) {
  if (n % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n / kVec + kThreads - 1) / kThreads, L);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (beta) {
#define KS32_CASE(B)                                                                        \
  case B:                                                                                   \
    ks32_kernel<B><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, fold, out, beta, L,       \
                                             key_rows, n, batch);                           \
    break;
    KS32_CASE(1)
    KS32_CASE(2)
    KS32_CASE(3)
    KS32_CASE(4)
#undef KS32_CASE
    default:
      ks32_kernel<0><<<grid, kThreads, 0, s>>>(t, evk, limb_map, q, fold, out, beta, L,
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
