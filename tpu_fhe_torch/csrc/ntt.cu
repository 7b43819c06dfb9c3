// Forward and inverse negacyclic NTT over RNS limbs, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of tpu_fhe/ops/ntt_pallas.py:
//   * _fwd_kernel (K1, ntt_pallas.py:362)            -> tfhe_ntt_fwd
//   * _fwd_sub_scale_kernel (K3, ntt_pallas.py:401)  -> tfhe_ntt_fwd_landing
//     (the same forward transform with a compile-time landing epilogue
//     out = (sub - pre * NTT(x)) * post mod q)
//   * _inv_kernel (K2, ntt_pallas.py:449)            -> tfhe_ntt_inv
//     (Gentleman-Sande inverse; the last step multiplies by n^-1 and then,
//     when given, by the caller's per-limb Shoup scale)
//
// Layout: data (..., L, N) of u64 residues, one polynomial row per limb;
// twiddles are the key-level tables (K, N) in SEAL's bit-reversed order, so
// stage m reads entries [m, 2m); limb_map (L,) picks each row's table limb,
// so every chain level and digit complement shares one table.  Output
// order and values equal the golden transform (core/ntt_tables.py) bit for
// bit: lazy values live in [0, 4q) (forward) or [0, 2q) (inverse) and are
// reduced to [0, q) at the end.
//
// What bounds it on the H100: bytes.  A transform does log2(N) butterfly
// stages of a few 64-bit multiplies per element pair; at N = 2^15 one limb
// is 256 KB, more than the 227 KB of shared memory a block can hold, so the
// TPU design (one whole limb in VMEM) does not carry over.  This design is
// the two-phase N = N1 * N2 split: one launch runs the log2(N1) stages of
// stride >= N2 on a tile of N1 rows x 16 columns in shared memory, a second
// runs the remaining log2(N2) stages on contiguous rows of N2 elements,
// plus the epilogue.  Each phase reads and writes the limb once; the
// intermediate (30 limbs of 2^15 u64 = 7.9 MB) stays in the 50 MB L2.
// A first, simple design: twiddles are read from global memory (L1/L2
// cached) and there is no radix-4/8 register blocking yet.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kColTile = 16;       // columns per block in the column phase
constexpr int kColThreads = 256;

__device__ __forceinline__ u64 shoup_lazy(u64 a, u64 w, u64 ws, u64 q) {
  // a * w mod q in [0, 2q) for any a < 2^64, ws = floor(w * 2^64 / q)
  return a * w - __umul64hi(a, ws) * q;
}

__device__ __forceinline__ u64 csub(u64 a, u64 q) { return a >= q ? a - q : a; }

// Harvey forward (Cooley-Tukey) butterfly: x, y in [0, 4q) -> [0, 4q).
__device__ __forceinline__ void fwd_bfly(u64 &x, u64 &y, u64 w, u64 ws, u64 q, u64 q2) {
  const u64 a = x >= q2 ? x - q2 : x;
  const u64 t = shoup_lazy(y, w, ws, q);
  x = a + t;
  y = a - t + q2;
}

// Harvey inverse (Gentleman-Sande) butterfly: x, y in [0, 2q) -> [0, 2q).
__device__ __forceinline__ void inv_bfly(u64 &x, u64 &y, u64 w, u64 ws, u64 q, u64 q2) {
  u64 u = x + y;
  u = u >= q2 ? u - q2 : u;
  const u64 v = x + q2 - y;
  y = shoup_lazy(v, w, ws, q);
  x = u;
}

struct Tables {
  const u64 *w;        // (K, N) twiddles, bit-reversed
  const u64 *ws;       // (K, N) Shoup words
  const u64 *q;        // (K,) moduli
  const int64_t *lm;   // (L,) limb map into K
};

// Column phase of the forward transform: stages m = 1 .. N1/2 (stride
// t = N / 2m >= N2).  Block (blockIdx.x, row) owns columns
// [16 * blockIdx.x, +16) of row `row`, viewed as an N1 x N2 matrix.
__global__ void fwd_cols(const u64 *__restrict__ x, u64 *__restrict__ y, Tables tb,
                         int L, int log_n, int log_n1) {
  extern __shared__ u64 sm[];
  const int n = 1 << log_n, n1 = 1 << log_n1, n2 = n >> log_n1;
  const int row = blockIdx.y;
  const int64_t key = tb.lm[row % L];
  const u64 q = tb.q[key], q2 = 2 * q;
  const u64 *w = tb.w + key * n, *ws = tb.ws + key * n;
  const size_t base = (size_t)row * n + (size_t)blockIdx.x * kColTile;
  for (int e = threadIdx.x; e < n1 * kColTile; e += blockDim.x)
    sm[e] = x[base + (size_t)(e / kColTile) * n2 + e % kColTile];
  __syncthreads();
  for (int m = 1, tt = n1 >> 1; m < n1; m <<= 1, tt >>= 1) {
    for (int k = threadIdx.x; k < (n1 >> 1) * kColTile; k += blockDim.x) {
      const int c = k % kColTile, b = k / kColTile;
      const int i = b / tt, r = i * 2 * tt + b % tt;
      fwd_bfly(sm[r * kColTile + c], sm[(r + tt) * kColTile + c], w[m + i], ws[m + i], q, q2);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n1 * kColTile; e += blockDim.x)
    y[base + (size_t)(e / kColTile) * n2 + e % kColTile] = sm[e];
}

// Row phase of the forward transform: stages m = N1 .. N/2 (stride t < N2)
// on row chunk blockIdx.x (N2 contiguous elements) of polynomial row
// `row`, then the final reduction and, with LANDING, the epilogue
// out = (sub - pre * y) * post mod q (pre may be null).
template <bool LANDING>
__global__ void fwd_rows(u64 *__restrict__ y, Tables tb, const u64 *__restrict__ sub,
                         const u64 *__restrict__ post, const u64 *__restrict__ post_s,
                         const u64 *__restrict__ pre, const u64 *__restrict__ pre_s,
                         int L, int log_n, int log_n1) {
  extern __shared__ u64 sm[];
  const int n = 1 << log_n, n2 = n >> log_n1;
  const int row = blockIdx.y, r = blockIdx.x;
  const int limb = row % L;
  const int64_t key = tb.lm[limb];
  const u64 q = tb.q[key], q2 = 2 * q;
  const u64 *w = tb.w + key * n, *ws = tb.ws + key * n;
  const size_t base = (size_t)row * n + (size_t)r * n2;
  for (int e = threadIdx.x; e < n2; e += blockDim.x) sm[e] = y[base + e];
  __syncthreads();
  for (int m = 1 << log_n1, t = n2 >> 1; t >= 1; m <<= 1, t >>= 1) {
    const int groups_before = r * (n2 / (2 * t));
    for (int k = threadIdx.x; k < (n2 >> 1); k += blockDim.x) {
      const int il = k / t, idx = il * 2 * t + k % t;
      const int i = m + groups_before + il;
      fwd_bfly(sm[idx], sm[idx + t], w[i], ws[i], q, q2);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n2; e += blockDim.x) {
    u64 v = sm[e];
    v = csub(v >= q2 ? v - q2 : v, q);
    if (LANDING) {
      if (pre != nullptr) v = csub(shoup_lazy(v, pre[limb], pre_s[limb], q), q);
      const u64 d = csub(sub[base + e] + q - v, q);
      v = csub(shoup_lazy(d, post[limb], post_s[limb], q), q);
    }
    y[base + e] = v;
  }
}

// Row phase of the inverse transform (runs first): strides t = 1 .. N2/2,
// h = N / 2t groups.  Input canonical, output in [0, 2q).
__global__ void inv_rows(const u64 *__restrict__ x, u64 *__restrict__ y, Tables tb,
                         int L, int log_n, int log_n1) {
  extern __shared__ u64 sm[];
  const int n = 1 << log_n, n2 = n >> log_n1;
  const int row = blockIdx.y, r = blockIdx.x;
  const int64_t key = tb.lm[row % L];
  const u64 q = tb.q[key], q2 = 2 * q;
  const u64 *w = tb.w + key * n, *ws = tb.ws + key * n;
  const size_t base = (size_t)row * n + (size_t)r * n2;
  for (int e = threadIdx.x; e < n2; e += blockDim.x) sm[e] = x[base + e];
  __syncthreads();
  for (int t = 1, h = n >> 1; t < n2; t <<= 1, h >>= 1) {
    const int groups_before = r * (n2 / (2 * t));
    for (int k = threadIdx.x; k < (n2 >> 1); k += blockDim.x) {
      const int il = k / t, idx = il * 2 * t + k % t;
      const int i = h + groups_before + il;
      inv_bfly(sm[idx], sm[idx + t], w[i], ws[i], q, q2);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n2; e += blockDim.x) y[base + e] = sm[e];
}

// Column phase of the inverse transform (runs second): strides
// t = N2 .. N/2, then x n^-1 and, when scale is not null, x scale.
__global__ void inv_cols(u64 *__restrict__ y, Tables tb, const u64 *__restrict__ invn,
                         const u64 *__restrict__ invn_s, const u64 *__restrict__ scale,
                         const u64 *__restrict__ scale_s, int L, int log_n, int log_n1) {
  extern __shared__ u64 sm[];
  const int n = 1 << log_n, n1 = 1 << log_n1, n2 = n >> log_n1;
  const int row = blockIdx.y;
  const int limb = row % L;
  const int64_t key = tb.lm[limb];
  const u64 q = tb.q[key], q2 = 2 * q;
  const u64 *w = tb.w + key * n, *ws = tb.ws + key * n;
  const size_t base = (size_t)row * n + (size_t)blockIdx.x * kColTile;
  for (int e = threadIdx.x; e < n1 * kColTile; e += blockDim.x)
    sm[e] = y[base + (size_t)(e / kColTile) * n2 + e % kColTile];
  __syncthreads();
  for (int tt = 1, h = n1 >> 1; h >= 1; tt <<= 1, h >>= 1) {
    for (int k = threadIdx.x; k < (n1 >> 1) * kColTile; k += blockDim.x) {
      const int c = k % kColTile, b = k / kColTile;
      const int i = b / tt, r = i * 2 * tt + b % tt;
      inv_bfly(sm[r * kColTile + c], sm[(r + tt) * kColTile + c], w[h + i], ws[h + i], q, q2);
    }
    __syncthreads();
  }
  const u64 f = invn[key], fs = invn_s[key];
  for (int e = threadIdx.x; e < n1 * kColTile; e += blockDim.x) {
    u64 v = shoup_lazy(sm[e], f, fs, q);
    if (scale != nullptr) v = shoup_lazy(v, scale[limb], scale_s[limb], q);
    y[base + (size_t)(e / kColTile) * n2 + e % kColTile] = csub(v, q);
  }
}

int split(int log_n) { return log_n / 2; }

// x, out: (rows, N) with rows = (...) * L; out may not alias x.
// sub/post/post_s are used by the landing variant only; pre/pre_s may be null.
int ntt_fwd_impl(bool landing, const u64 *x, u64 *out, const u64 *sub,
                        const u64 *roots, const u64 *roots_s, const u64 *q,
                        const int64_t *limb_map, const u64 *post, const u64 *post_s,
                        const u64 *pre, const u64 *pre_s, int rows, int L, int log_n,
                        void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n1 = split(log_n), n1 = 1 << log_n1, n2 = 1 << (log_n - log_n1);
  const Tables tb{roots, roots_s, q, limb_map};
  fwd_cols<<<dim3(n2 / kColTile, rows), kColThreads, n1 * kColTile * sizeof(u64), s>>>(
      x, out, tb, L, log_n, log_n1);
  const int threads = n2 / 2 < 256 ? n2 / 2 : 256;
  if (landing)
    fwd_rows<true><<<dim3(n1, rows), threads, n2 * sizeof(u64), s>>>(
        out, tb, sub, post, post_s, pre, pre_s, L, log_n, log_n1);
  else
    fwd_rows<false><<<dim3(n1, rows), threads, n2 * sizeof(u64), s>>>(
        out, tb, nullptr, nullptr, nullptr, nullptr, nullptr, L, log_n, log_n1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tfhe_ntt_fwd(const u64 *x, u64 *out, const u64 *roots, const u64 *roots_s, const u64 *q,
                 const int64_t *limb_map, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl(false, x, out, nullptr, roots, roots_s, q, limb_map, nullptr, nullptr,
                      nullptr, nullptr, rows, L, log_n, stream);
}

int tfhe_ntt_fwd_landing(const u64 *x, const u64 *sub, u64 *out, const u64 *roots,
                         const u64 *roots_s, const u64 *q, const int64_t *limb_map,
                         const u64 *post, const u64 *post_s, const u64 *pre,
                         const u64 *pre_s, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl(true, x, out, sub, roots, roots_s, q, limb_map, post, post_s, pre, pre_s,
                      rows, L, log_n, stream);
}

// scale/scale_s (L,) may be null: the transform then ends with n^-1 only.
int tfhe_ntt_inv(const u64 *x, u64 *out, const u64 *inv_roots, const u64 *inv_roots_s,
                 const u64 *q, const int64_t *limb_map, const u64 *invn, const u64 *invn_s,
                 const u64 *scale, const u64 *scale_s, int rows, int L, int log_n,
                 void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n1 = split(log_n), n1 = 1 << log_n1, n2 = 1 << (log_n - log_n1);
  const Tables tb{inv_roots, inv_roots_s, q, limb_map};
  const int threads = n2 / 2 < 256 ? n2 / 2 : 256;
  inv_rows<<<dim3(n1, rows), threads, n2 * sizeof(u64), s>>>(x, out, tb, L, log_n, log_n1);
  inv_cols<<<dim3(n2 / kColTile, rows), kColThreads, n1 * kColTile * sizeof(u64), s>>>(
      out, tb, invn, invn_s, scale, scale_s, L, log_n, log_n1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
