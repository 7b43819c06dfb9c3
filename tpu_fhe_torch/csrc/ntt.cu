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
//
// tfhe_ntt_fwd32 (K4) alone runs the one-launch design below
// (fwd_cluster), which the other transforms are to move onto: a q32 limb
// of 4 N bytes is held on chip for the whole transform.  Each limb is one
// thread-block cluster of C blocks, each holding M = N / C words in shared
// memory (32 KB up to N = 2^15, 64 KB above: C = 1 up to 2^13, 2 at 2^14,
// 4 at 2^15 and 2^16, 8 at 2^17).
//   * The first log2 C stages (strides >= M) run in registers: block r
//     reads the column slab [r M / C, (r + 1) M / C) of every one of the C
//     chunks straight from device memory, transforms each column's C
//     values, and keeps them in shared memory.  After cluster.sync() one
//     all-to-all exchange over distributed shared memory gives block r the
//     contiguous chunk [r M, (r + 1) M); a second cluster.sync() ends all
//     remote reads before any block can exit.
//   * The remaining stages run in radix-8 passes (radix-4/2 for the last
//     one or two): a thread holds 8 elements and their 7 twiddle pairs in
//     registers through 3 stages, so one __syncthreads() serves 3 stages.
//     The last pass lands each value (the epilogue, a template hook) and
//     stores its 8 consecutive words straight to device memory.
//   * The ring size is a template parameter, so strides, trip counts and
//     shared-memory offsets are compile-time constants; the rest of the
//     index math is shifts and masks.  Shared memory carries one pad word
//     every 32 against bank conflicts at power-of-two strides.
// So the limb crosses device memory once each way, against twice for the
// two-phase kernels.

#include <cooperative_groups.h>

#include <type_traits>

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

// -- the one-launch forward transform (cluster design) ----------------------

namespace cg = cooperative_groups;

// Shared-memory slot of element e: one pad word every 32.
__device__ __forceinline__ int pad32(int e) { return e + (e >> 5); }

// Stages s = 0 .. R-1 of a radix-2^R block in registers: v[k] is element
// base + k * u, the first stage runs at twiddle offset m with group i, and
// stage s pairs k with k + 2^(R-1-s) under twiddle w[((m + i) << s) + g],
// g = k >> (R - s).
template <typename W, int R>
__device__ __forceinline__ void radix_fwd(W (&v)[1 << R], const W *__restrict__ w,
                                          const W *__restrict__ ws, int m, int i, W q, W q2) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int h = 1 << (R - 1 - s);
#pragma unroll
    for (int g = 0; g < (1 << s); ++g) {
      const int tw = ((m + i) << s) + g;
      const W wv = __ldg(w + tw), wsv = __ldg(ws + tw);
#pragma unroll
      for (int kk = 0; kk < h; ++kk) {
        const int k = (g << (R - s)) + kk;
        fwd_bfly(v[k], v[k + h], wv, wsv, q, q2);
      }
    }
  }
}

// The plain forward transform's epilogue: [0, 4q) -> [0, q).  A landing
// epilogue (K3/K6) takes the limb and the element's index in `out`.
template <typename W>
struct FinalReduce {
  __device__ __forceinline__ W operator()(W v, W q, W q2, int /*limb*/, size_t /*idx*/) const {
    return csub(v >= q2 ? v - q2 : v, q);
  }
};

// The shape of one transform, all of it known at compile time: a ring of
// 2^LOG_N words held by C = 2^LOG_C blocks of M = 2^LOG_M words each, in
// chunks of 32 KB up to 4 blocks, then 64 KB; at most 8 blocks (the
// portable cluster size).  MIN_BLOCKS bounds the registers a thread may
// take: 2 blocks of 32 KB chunks per SM hold a 2^15 ring of 59 limbs
// (236 blocks) in one wave with up to 64 registers a thread.
template <typename W, int LOG_N>
struct ClusterShape {
  static constexpr int kLog32K = sizeof(W) == 4 ? 13 : 12;   // words in 32 KB
  static constexpr int LOG_C = LOG_N <= kLog32K       ? 0
                               : LOG_N <= kLog32K + 2 ? LOG_N - kLog32K
                                                      : LOG_N - kLog32K - 1;
  static constexpr int LOG_M = LOG_N - LOG_C, C = 1 << LOG_C, M = 1 << LOG_M;
  static constexpr int THREADS = M / 8 < 512 ? M / 8 : 512;
  static constexpr int SMEM = ((LOG_C > 0 ? M : 0) + M + M / 32) * static_cast<int>(sizeof(W));
  static constexpr int MIN_BLOCKS = LOG_C > 0 && SMEM <= 75 * 1024 ? 2 : 1;
  static_assert(LOG_C <= 3, "at most 8 blocks per cluster");
};

// The passes of R = 3 (radix-8; 2 or 1 for the last one or two) stages,
// from stage STAGE on, over this block's chunk (global elements
// [rank M, (rank + 1) M)) in `buf`; the last pass lands its values through
// `epi` into out_row.  Strides and trip counts are compile-time constants,
// so shared-memory offsets are immediates.
template <typename W, int LOG_N, int STAGE, typename Epi>
__device__ __forceinline__ void local_passes(W *buf, W *__restrict__ out_row,
                                             const W *__restrict__ w, const W *__restrict__ ws,
                                             W q, W q2, int rank, const Epi &epi, int limb) {
  using S = ClusterShape<W, LOG_N>;
  constexpr int LEFT = LOG_N - STAGE;
  constexpr int R = LEFT == 1 ? 1 : (LEFT == 2 || LEFT == 4) ? 2 : 3;
  constexpr bool LAST = R == LEFT;
  constexpr int LOG_T = LOG_N - 1 - STAGE;        // the pass's first stride
  constexpr int LU = LOG_T - (R - 1);             // its last stride
  constexpr int ITERS = (S::M >> R) / S::THREADS;
  static_assert(ITERS >= 1, "a thread per radix group at least");
  const int chunk0 = rank << S::LOG_M;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int qd = threadIdx.x + it * S::THREADS;
    const int lb = ((qd >> LU) << (LU + R)) | (qd & ((1 << LU) - 1));
    const int i = (chunk0 + lb) >> (LOG_T + 1);
    W v[1 << R];
    int slot[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if constexpr (LU >= 5)   // k 2^LU is a multiple of 32: one pad for all
        slot[k] = pad32(lb) + k * ((1 << LU) + (1 << (LU - 5)));
      else
        slot[k] = pad32(lb + (k << LU));
      v[k] = buf[slot[k]];
    }
    radix_fwd<W, R>(v, w, ws, 1 << STAGE, i, q, q2);
    if constexpr (LAST) {                         // LU == 0: 2^R consecutive words
      W *o = out_row + chunk0 + lb;
#pragma unroll
      for (int k = 0; k < (1 << R); ++k)
        v[k] = epi(v[k], q, q2, limb, static_cast<size_t>(chunk0 + lb + k));
      if constexpr (std::is_same<W, u32>::value && R >= 2) {
#pragma unroll
        for (int c = 0; c < (1 << R) / 4; ++c)
          reinterpret_cast<uint4 *>(o)[c] =
              make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < (1 << R); ++k) o[k] = v[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) buf[slot[k]] = v[k];
    }
  }
  if constexpr (!LAST) {
    __syncthreads();
    local_passes<W, LOG_N, STAGE + R>(buf, out_row, w, ws, q, q2, rank, epi, limb);
  }
}

constexpr int kBatch = 2;   // columns a thread loads at once in the first stages

// Grid (C, L, batch), clusters of (C, 1, 1): block (r, limb, b) transforms
// chunk r of row (b, limb).  Shared memory: the column slab (C > 1 only),
// then the padded chunk.
template <typename W, int LOG_N, typename Epi>
__global__ void __launch_bounds__(ClusterShape<W, LOG_N>::THREADS,
                                  ClusterShape<W, LOG_N>::MIN_BLOCKS)
fwd_cluster(const W *__restrict__ x, W *__restrict__ y, Tables<W> tb, Epi epi) {
  using S = ClusterShape<W, LOG_N>;
  constexpr int LOG_C = S::LOG_C, C = S::C, LOG_M = S::LOG_M, M = S::M, T = S::THREADS;
  constexpr int N = 1 << LOG_N;
  W *sm = reinterpret_cast<W *>(smem_raw);
  const int limb = blockIdx.y;
  const size_t row = (size_t)blockIdx.z * gridDim.y + limb;
  const int64_t key = tb.lm[limb];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * N, *ws = tb.ws + key * N;
  const W *src = x + row * N;
  W *buf = sm + (C > 1 ? M : 0);
  int rank = 0;
  if constexpr (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    constexpr int LOG_MC = LOG_M - LOG_C, MC = 1 << LOG_MC;
    static_assert(MC % (kBatch * T) == 0, "whole batches of columns");
    W *slab = sm;                                // (C, M / C): [chunk][column]
#pragma unroll
    for (int it = 0; it < MC / (kBatch * T); ++it) {
      const int j0 = threadIdx.x + it * kBatch * T;
      W v[kBatch][C];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int hi = 0; hi < C; ++hi) v[u][hi] = src[(hi << LOG_M) + (rank << LOG_MC) + j0 + u * T];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        radix_fwd<W, LOG_C>(v[u], w, ws, 1, 0, q, q2);
#pragma unroll
        for (int hi = 0; hi < C; ++hi) slab[(hi << LOG_MC) + j0 + u * T] = v[u][hi];
      }
    }
    cluster.sync();
#pragma unroll
    for (int it = 0; it < MC / (kBatch * T); ++it) {
      const int j0 = threadIdx.x + it * kBatch * T;
      W t[kBatch][C];
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const W *peer = cluster.map_shared_rank(slab, b) + (rank << LOG_MC) + j0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) t[u][b] = peer[u * T];
      }
#pragma unroll
      for (int b = 0; b < C; ++b)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) buf[pad32((b << LOG_MC) + j0 + u * T)] = t[u][b];
    }
    cluster.sync();                              // no remote read after this
  } else {
#pragma unroll
    for (int it = 0; it < M / T; ++it) buf[pad32(threadIdx.x + it * T)] = src[threadIdx.x + it * T];
    __syncthreads();
  }
  local_passes<W, LOG_N, LOG_C>(buf, y + row * N, w, ws, q, q2, rank, epi, limb);
}

template <typename W, int LOG_N, typename Epi>
int launch_fwd_cluster(const W *x, W *out, Tables<W> tb, int rows, int L, Epi epi,
                       cudaStream_t s) {
  using S = ClusterShape<W, LOG_N>;
  auto kernel = fwd_cluster<W, LOG_N, Epi>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S::C, L, rows / L);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, out, tb, epi);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// x, out: (rows, N) with rows = batch * L; out may not alias x.
template <typename W, typename Epi>
int ntt_fwd_cluster(const W *x, W *out, const W *roots, const W *roots_s, const W *q,
                    const int64_t *limb_map, int rows, int L, int log_n, Epi epi,
                    void *stream) {
  if (L <= 0 || rows % L != 0 || rows / L > 65535 || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables<W> tb{roots, roots_s, q, limb_map};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
    case 10: return launch_fwd_cluster<W, 10>(x, out, tb, rows, L, epi, s);
    case 11: return launch_fwd_cluster<W, 11>(x, out, tb, rows, L, epi, s);
    case 12: return launch_fwd_cluster<W, 12>(x, out, tb, rows, L, epi, s);
    case 13: return launch_fwd_cluster<W, 13>(x, out, tb, rows, L, epi, s);
    case 14: return launch_fwd_cluster<W, 14>(x, out, tb, rows, L, epi, s);
    case 15: return launch_fwd_cluster<W, 15>(x, out, tb, rows, L, epi, s);
    case 16: return launch_fwd_cluster<W, 16>(x, out, tb, rows, L, epi, s);
    case 17: return launch_fwd_cluster<W, 17>(x, out, tb, rows, L, epi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
// K4: the one-launch cluster transform.
int tfhe_ntt_fwd32(const u32 *x, u32 *out, const u32 *roots, const u32 *roots_s, const u32 *q,
                   const int64_t *limb_map, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_cluster<u32>(x, out, roots, roots_s, q, limb_map, rows, L, log_n,
                              FinalReduce<u32>{}, stream);
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
