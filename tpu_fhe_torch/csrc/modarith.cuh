// Modular-arithmetic device helpers shared by the port's kernels
// (ntt.cu, bconv.cu, ks.cu).  Words are u64 (the u64 plan, q < 2^61) or u32
// (the q32 plan, q < 2^30); every helper is exact in its stated range.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef uint32_t u32;

namespace {

__device__ __forceinline__ u64 mulhi(u64 a, u64 b) { return __umul64hi(a, b); }
__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }

// a * w mod q in [0, 2q) for any a below 2^word, ws = floor(w * 2^word / q)
template <typename W>
__device__ __forceinline__ W shoup_lazy(W a, W w, W ws, W q) {
  return a * w - mulhi(a, ws) * q;
}

// [0, 2q) -> [0, q)
template <typename W>
__device__ __forceinline__ W csub(W a, W q) { return a >= q ? a - q : a; }

// (hi, lo) += a * w: the full 64x64 -> 128-bit product, with the carry out
// of the low word.
__device__ __forceinline__ void mac128(u64 &hi, u64 &lo, u64 a, u64 w) {
  const u64 plo = a * w;
  lo += plo;
  hi += __umul64hi(a, w) + (lo < plo);
}

// (hi, lo) += a * w for u32 words: the 64-bit product into a u64 and a u32
// carry word, so a sum of any number of products below 2^64 stays exact.
__device__ __forceinline__ void mac96(u32 &hi, u64 &lo, u32 a, u32 w) {
  const u64 prod = static_cast<u64>(a) * w;
  lo += prod;
  hi += lo < prod;
}

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

// (w2 : lo) mod q for q < 2^30, the word-fold Barrett of
// tpu_fhe/ops/u32pair.py barrett_reduce96_32.  fold holds rows (5, m) of
// per-modulus constants (modarith.q32_mul_consts): floor(2^32/q), 2^32 mod q
// and its Shoup32 word, 2^64 mod q and its Shoup32 word; j is the modulus.
// The same with the five constants of q given as words (f[r] = fold[r, j]).
__device__ __forceinline__ u32 reduce96(u64 lo, u32 w2, u32 q, u32 f0, u32 f1, u32 f1s, u32 f2,
                                        u32 f2s) {
  const u32 w0 = static_cast<u32>(lo), w1 = static_cast<u32>(lo >> 32);
  const u32 s0 = csub(w0 - __umulhi(w0, f0) * q, q);
  const u32 s1 = csub(shoup_lazy(w1, f1, f1s, q), q);
  const u32 s2 = shoup_lazy(w2, f2, f2s, q);
  return csub(csub(s0 + s1 + s2, 2 * q), q);   // s0 + s1 + s2 < 4q
}

__device__ __forceinline__ u32 reduce96(u64 lo, u32 w2, u32 q, const u64 *fold, int j, int m) {
  return reduce96(lo, w2, q, static_cast<u32>(fold[j]), static_cast<u32>(fold[m + j]),
                  static_cast<u32>(fold[2 * m + j]), static_cast<u32>(fold[3 * m + j]),
                  static_cast<u32>(fold[4 * m + j]));
}

}  // namespace
