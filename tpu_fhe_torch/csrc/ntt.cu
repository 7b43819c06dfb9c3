// Forward and inverse negacyclic NTT over RNS limbs, for Hopper (sm_90a).
//
// Replaces six Pallas TPU kernels of tpu_fhe/ops/ntt_pallas.py, in two word
// sizes of one templated design:
//   u64 residues (q < 2^61), the u64 plan:
//   * _fwd_kernel (K1, ntt_pallas.py:362)              -> tfhe_ntt_fwd
//   * _fwd_sub_scale_kernel (K3, ntt_pallas.py:401)    -> tfhe_ntt_fwd_landing
//   * _inv_kernel (K2, ntt_pallas.py:449)              -> tfhe_ntt_inv
//   u32 residues (q < 2^30), the q32 plan of composite scaling:
//   * _fwd_kernel32 (K4, ntt_pallas.py:801)            -> tfhe_ntt_fwd32
//   * _fwd_sub_scale_kernel32 (K6, ntt_pallas.py:810)  -> tfhe_ntt_fwd_landing32
//   * _inv_kernel32 (K5, ntt_pallas.py:823)            -> tfhe_ntt_inv32
// The landing variants are the forward transform with a compile-time
// epilogue out = (sub - pre * NTT(x)) * post mod q (pre may be null).  The
// inverse (Gentleman-Sande) ends with x n^-1 and then, when given, x the
// caller's per-limb Shoup scale: two lazy multiplies.  The q32 reference
// folds scale * n^-1 into one pair instead (tpu_fhe/ops/ntt.py:300-307);
// both land on the same canonical value.
//
// Layout: data (..., L, N) of residues, one polynomial row per limb;
// twiddles are the key-level tables (K, N) in SEAL's bit-reversed order, so
// stage m reads entries [m, 2m); limb_map (L,) picks each row's table limb,
// so every chain level and digit complement shares one table.  Output
// order and values equal the golden transform (core/ntt_tables.py) bit for
// bit, in either word: lazy values live in [0, 4q) (forward) or [0, 2q)
// (inverse) and are reduced to [0, q) at the end.  Shoup words are
// floor(w * 2^64 / q) in the u64 form and floor(w * 2^32 / q) in the u32
// form, whose lazy range [0, 4q) fits one word because q < 2^30.
//
// What bounds it on the H100: bytes.  A transform does log2(N) butterfly
// stages of a few word multiplies per element pair; at N = 2^15 one u64
// limb is 256 KB, more than the 227 KB of shared memory a block can hold, so
// the TPU design (one whole limb in VMEM) does not carry over.  This design
// is the two-phase N = N1 * N2 split: one launch runs the log2(N1) stages of
// stride >= N2 on a tile of N1 rows x 16 columns in shared memory, a second
// runs the remaining log2(N2) stages on contiguous rows of N2 elements,
// plus the epilogue.  Each phase reads and writes the limb once; the
// intermediate stays in the 50 MB L2.  The u32 form moves half the bytes
// and replaces each 64-bit high product (__umul64hi) by one __umulhi.
// A first, simple design: twiddles are read from global memory (L1/L2
// cached) and there is no radix-4/8 register blocking yet.

#include "modarith.cuh"

namespace {

constexpr int kColTile = 16;       // columns per block in the column phase
constexpr int kColThreads = 256;

// Harvey forward (Cooley-Tukey) butterfly: x, y in [0, 4q) -> [0, 4q).
template <typename W>
__device__ __forceinline__ void fwd_bfly(W &x, W &y, W w, W ws, W q, W q2) {
  const W a = x >= q2 ? x - q2 : x;
  const W t = shoup_lazy(y, w, ws, q);
  x = a + t;
  y = a - t + q2;
}

// Harvey inverse (Gentleman-Sande) butterfly: x, y in [0, 2q) -> [0, 2q).
template <typename W>
__device__ __forceinline__ void inv_bfly(W &x, W &y, W w, W ws, W q, W q2) {
  W u = x + y;
  u = u >= q2 ? u - q2 : u;
  const W v = x + q2 - y;
  y = shoup_lazy(v, w, ws, q);
  x = u;
}

template <typename W>
struct Tables {
  const W *w;          // (K, N) twiddles, bit-reversed
  const W *ws;         // (K, N) Shoup words
  const W *q;          // (K,) moduli
  const int64_t *lm;   // (L,) limb map into K
};

// One dynamic shared-memory buffer for every instantiation (extern arrays
// of different element types may not share a name).
extern __shared__ __align__(16) unsigned char smem_raw[];

// Column phase of the forward transform: stages m = 1 .. N1/2 (stride
// t = N / 2m >= N2).  Block (blockIdx.x, row) owns columns
// [16 * blockIdx.x, +16) of row `row`, viewed as an N1 x N2 matrix.
template <typename W>
__global__ void fwd_cols(const W *__restrict__ x, W *__restrict__ y, Tables<W> tb,
                         int L, int log_n, int log_n1) {
  W *sm = reinterpret_cast<W *>(smem_raw);
  const int n = 1 << log_n, n1 = 1 << log_n1, n2 = n >> log_n1;
  const int row = blockIdx.y;
  const int64_t key = tb.lm[row % L];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * n, *ws = tb.ws + key * n;
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
template <typename W, bool LANDING>
__global__ void fwd_rows(W *__restrict__ y, Tables<W> tb, const W *__restrict__ sub,
                         const W *__restrict__ post, const W *__restrict__ post_s,
                         const W *__restrict__ pre, const W *__restrict__ pre_s,
                         int L, int log_n, int log_n1) {
  W *sm = reinterpret_cast<W *>(smem_raw);
  const int n = 1 << log_n, n2 = n >> log_n1;
  const int row = blockIdx.y, r = blockIdx.x;
  const int limb = row % L;
  const int64_t key = tb.lm[limb];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * n, *ws = tb.ws + key * n;
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
    W v = sm[e];
    v = csub(v >= q2 ? v - q2 : v, q);
    if (LANDING) {
      if (pre != nullptr) v = csub(shoup_lazy(v, pre[limb], pre_s[limb], q), q);
      const W d = csub(sub[base + e] + q - v, q);
      v = csub(shoup_lazy(d, post[limb], post_s[limb], q), q);
    }
    y[base + e] = v;
  }
}

// Row phase of the inverse transform (runs first): strides t = 1 .. N2/2,
// h = N / 2t groups.  Input canonical, output in [0, 2q).
template <typename W>
__global__ void inv_rows(const W *__restrict__ x, W *__restrict__ y, Tables<W> tb,
                         int L, int log_n, int log_n1) {
  W *sm = reinterpret_cast<W *>(smem_raw);
  const int n = 1 << log_n, n2 = n >> log_n1;
  const int row = blockIdx.y, r = blockIdx.x;
  const int64_t key = tb.lm[row % L];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * n, *ws = tb.ws + key * n;
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
template <typename W>
__global__ void inv_cols(W *__restrict__ y, Tables<W> tb, const W *__restrict__ invn,
                         const W *__restrict__ invn_s, const W *__restrict__ scale,
                         const W *__restrict__ scale_s, int L, int log_n, int log_n1) {
  W *sm = reinterpret_cast<W *>(smem_raw);
  const int n = 1 << log_n, n1 = 1 << log_n1, n2 = n >> log_n1;
  const int row = blockIdx.y;
  const int limb = row % L;
  const int64_t key = tb.lm[limb];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * n, *ws = tb.ws + key * n;
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
  const W f = invn[key], fs = invn_s[key];
  for (int e = threadIdx.x; e < n1 * kColTile; e += blockDim.x) {
    W v = shoup_lazy(sm[e], f, fs, q);
    if (scale != nullptr) v = shoup_lazy(v, scale[limb], scale_s[limb], q);
    y[base + (size_t)(e / kColTile) * n2 + e % kColTile] = csub(v, q);
  }
}

int split(int log_n) { return log_n / 2; }

// x, out: (rows, N) with rows = (...) * L; out may not alias x.
// sub/post/post_s are used by the landing variant only; pre/pre_s may be null.
template <typename W>
int ntt_fwd_impl(bool landing, const W *x, W *out, const W *sub, const W *roots,
                 const W *roots_s, const W *q, const int64_t *limb_map, const W *post,
                 const W *post_s, const W *pre, const W *pre_s, int rows, int L, int log_n,
                 void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n1 = split(log_n), n1 = 1 << log_n1, n2 = 1 << (log_n - log_n1);
  const Tables<W> tb{roots, roots_s, q, limb_map};
  fwd_cols<W><<<dim3(n2 / kColTile, rows), kColThreads, n1 * kColTile * sizeof(W), s>>>(
      x, out, tb, L, log_n, log_n1);
  const int threads = n2 / 2 < 256 ? n2 / 2 : 256;
  if (landing)
    fwd_rows<W, true><<<dim3(n1, rows), threads, n2 * sizeof(W), s>>>(
        out, tb, sub, post, post_s, pre, pre_s, L, log_n, log_n1);
  else
    fwd_rows<W, false><<<dim3(n1, rows), threads, n2 * sizeof(W), s>>>(
        out, tb, nullptr, nullptr, nullptr, nullptr, nullptr, L, log_n, log_n1);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int ntt_inv_impl(const W *x, W *out, const W *inv_roots, const W *inv_roots_s, const W *q,
                 const int64_t *limb_map, const W *invn, const W *invn_s, const W *scale,
                 const W *scale_s, int rows, int L, int log_n, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n1 = split(log_n), n1 = 1 << log_n1, n2 = 1 << (log_n - log_n1);
  const Tables<W> tb{inv_roots, inv_roots_s, q, limb_map};
  const int threads = n2 / 2 < 256 ? n2 / 2 : 256;
  inv_rows<W><<<dim3(n1, rows), threads, n2 * sizeof(W), s>>>(x, out, tb, L, log_n, log_n1);
  inv_cols<W><<<dim3(n2 / kColTile, rows), kColThreads, n1 * kColTile * sizeof(W), s>>>(
      out, tb, invn, invn_s, scale, scale_s, L, log_n, log_n1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tfhe_ntt_fwd(const u64 *x, u64 *out, const u64 *roots, const u64 *roots_s, const u64 *q,
                 const int64_t *limb_map, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl<u64>(false, x, out, nullptr, roots, roots_s, q, limb_map, nullptr,
                           nullptr, nullptr, nullptr, rows, L, log_n, stream);
}

int tfhe_ntt_fwd_landing(const u64 *x, const u64 *sub, u64 *out, const u64 *roots,
                         const u64 *roots_s, const u64 *q, const int64_t *limb_map,
                         const u64 *post, const u64 *post_s, const u64 *pre,
                         const u64 *pre_s, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl<u64>(true, x, out, sub, roots, roots_s, q, limb_map, post, post_s, pre,
                           pre_s, rows, L, log_n, stream);
}

// scale/scale_s (L,) may be null: the transform then ends with n^-1 only.
int tfhe_ntt_inv(const u64 *x, u64 *out, const u64 *inv_roots, const u64 *inv_roots_s,
                 const u64 *q, const int64_t *limb_map, const u64 *invn, const u64 *invn_s,
                 const u64 *scale, const u64 *scale_s, int rows, int L, int log_n,
                 void *stream) {
  return ntt_inv_impl<u64>(x, out, inv_roots, inv_roots_s, q, limb_map, invn, invn_s, scale,
                           scale_s, rows, L, log_n, stream);
}

// The q32 entry points take the same arguments as single u32 words.
int tfhe_ntt_fwd32(const u32 *x, u32 *out, const u32 *roots, const u32 *roots_s, const u32 *q,
                   const int64_t *limb_map, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl<u32>(false, x, out, nullptr, roots, roots_s, q, limb_map, nullptr,
                           nullptr, nullptr, nullptr, rows, L, log_n, stream);
}

int tfhe_ntt_fwd_landing32(const u32 *x, const u32 *sub, u32 *out, const u32 *roots,
                           const u32 *roots_s, const u32 *q, const int64_t *limb_map,
                           const u32 *post, const u32 *post_s, const u32 *pre,
                           const u32 *pre_s, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_impl<u32>(true, x, out, sub, roots, roots_s, q, limb_map, post, post_s, pre,
                           pre_s, rows, L, log_n, stream);
}

int tfhe_ntt_inv32(const u32 *x, u32 *out, const u32 *inv_roots, const u32 *inv_roots_s,
                   const u32 *q, const int64_t *limb_map, const u32 *invn, const u32 *invn_s,
                   const u32 *scale, const u32 *scale_s, int rows, int L, int log_n,
                   void *stream) {
  return ntt_inv_impl<u32>(x, out, inv_roots, inv_roots_s, q, limb_map, invn, invn_s, scale,
                           scale_s, rows, L, log_n, stream);
}

}  // extern "C"
