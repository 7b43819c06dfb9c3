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
// stages of a few word multiplies per element pair, and a limb (4 N or 8 N
// bytes) is larger than one block's 227 KB of shared memory from N = 2^15
// on u64 and 2^16 on u32, so the TPU design (one whole limb in VMEM) does
// not carry over.  Two designs:
//
// The one-launch cluster design (K1, K4 and K5): each limb is one
// thread-block cluster of C blocks, each holding M = N / C words in shared
// memory, so the limb crosses device memory once each way.  ClusterShape
// picks C: 32 KB chunks up to 4 blocks, then larger chunks, at most 8
// blocks (the portable cluster size), so a u64 limb at 2^17 is 8 blocks of
// 128 KB.
//   * Forward: block r reads the column slab [r M / C, (r + 1) M / C) of
//     every one of the C chunks straight from device memory and runs the
//     first log2 C stages (strides >= M) in registers, one column of C
//     values at a time; it pushes each value into its owner's chunk over
//     distributed shared memory (cluster.map_shared_rank), and one
//     cluster.sync() later block r holds the contiguous chunk [r M,
//     (r + 1) M).  The remaining stages run locally in radix-8 passes
//     (radix-4/2 for the last one or two): a thread holds 8 elements and
//     their twiddle pairs in registers through 3 stages, so one
//     __syncthreads() serves 3 stages.  The last pass lands each value (the
//     epilogue, a template hook) and stores its 8 consecutive words
//     straight to device memory with 16-byte stores.
//   * Inverse: the mirror.  Block r reads its contiguous chunk with 16-byte
//     loads and runs the stages of stride 1 .. M / 2 locally, first pass
//     straight from the loaded registers; after cluster.sync() it pulls
//     column slab r of every peer's chunk into registers, runs the last
//     log2 C stages (strides M .. N / 2), multiplies by n^-1 and the scale
//     and stores C runs of M / C consecutive words.  A last cluster barrier
//     keeps every block alive until no peer reads its chunk.
//   * The ring size is a template parameter, so strides, trip counts and
//     shared-memory offsets are compile-time constants; the rest of the
//     index math is shifts and masks.  Shared memory carries one pad word
//     every 32 against bank conflicts at power-of-two strides.
//
// The two-phase design (K2, K3 and K6, still to move onto the cluster
// design): N = N1 * N2; one launch runs the log2(N1) stages of stride
// >= N2 on a tile of N1 rows x 16 columns in shared memory, a second runs
// the remaining log2(N2) stages on contiguous rows of N2 elements, plus
// the epilogue.  Each phase reads and writes the limb once; the
// intermediate stays in the 50 MB L2.  Twiddles are read from global
// memory (L1/L2 cached) and there is no radix-4/8 register blocking.

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

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

// -- the two-phase transforms (K2, K3, K6) -----------------------------------

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

// Row phase of the forward landing: stages m = N1 .. N/2 (stride t < N2)
// on row chunk blockIdx.x (N2 contiguous elements) of polynomial row
// `row`, then the final reduction and the epilogue
// out = (sub - pre * y) * post mod q (pre may be null).
template <typename W>
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
    if (pre != nullptr) v = csub(shoup_lazy(v, pre[limb], pre_s[limb], q), q);
    const W d = csub(sub[base + e] + q - v, q);
    y[base + e] = csub(shoup_lazy(d, post[limb], post_s[limb], q), q);
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

// -- the one-launch transforms (cluster design: K1, K4, K5) ------------------

namespace cg = cooperative_groups;

// Shared-memory slot of element e: one pad word every 32.
__device__ __forceinline__ int pad32(int e) { return e + (e >> 5); }

// The cluster barrier in two halves.  A relaxed arrive orders no memory: it
// only says that this block runs.  The plain arrive releases this thread's
// earlier accesses (the remote reads) to the peers' wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

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

// The Gentleman-Sande mirror of radix_fwd: v[k] is element base + k * u,
// the pass's last stage has m twiddle groups and this block is group i;
// stage s pairs k with k + 2^s under twiddle
// w[((m + i) << (R-1-s)) + g], g = k >> (s + 1).
template <typename W, int R>
__device__ __forceinline__ void radix_inv(W (&v)[1 << R], const W *__restrict__ w,
                                          const W *__restrict__ ws, int m, int i, W q, W q2) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int g = 0; g < (1 << (R - 1 - s)); ++g) {
      const int tw = ((m + i) << (R - 1 - s)) + g;
      const W wv = __ldg(w + tw), wsv = __ldg(ws + tw);
#pragma unroll
      for (int kk = 0; kk < h; ++kk) {
        const int k = (g << (s + 1)) + kk;
        inv_bfly(v[k], v[k + h], wv, wsv, q, q2);
      }
    }
  }
}

// K consecutive words at p (16-byte aligned) in 16-byte accesses: the
// inverse's first pass and the forward's last hold 4 or 8 words a thread.
template <typename W, int K>
__device__ __forceinline__ void load_run(const W *__restrict__ p, W (&v)[K]) {
  constexpr int PER = 16 / static_cast<int>(sizeof(W));
  static_assert(K % PER == 0, "whole 16-byte runs");
#pragma unroll
  for (int c = 0; c < K / PER; ++c) {
    if constexpr (std::is_same<W, u32>::value) {
      const uint4 t = __ldg(reinterpret_cast<const uint4 *>(p) + c);
      v[4 * c] = t.x, v[4 * c + 1] = t.y, v[4 * c + 2] = t.z, v[4 * c + 3] = t.w;
    } else {
      const ulonglong2 t = __ldg(reinterpret_cast<const ulonglong2 *>(p) + c);
      v[2 * c] = t.x, v[2 * c + 1] = t.y;
    }
  }
}

template <typename W, int K>
__device__ __forceinline__ void store_run(W *__restrict__ p, const W (&v)[K]) {
  constexpr int PER = 16 / static_cast<int>(sizeof(W));
  static_assert(K % PER == 0, "whole 16-byte runs");
#pragma unroll
  for (int c = 0; c < K / PER; ++c) {
    if constexpr (std::is_same<W, u32>::value)
      reinterpret_cast<uint4 *>(p)[c] =
          make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    else
      reinterpret_cast<ulonglong2 *>(p)[c] = make_ulonglong2(v[2 * c], v[2 * c + 1]);
  }
}

// The plain forward transform's epilogue: [0, 4q) -> [0, q).  A landing
// epilogue takes the limb and the element's index in `out`.
template <typename W>
struct FinalReduce {
  __device__ __forceinline__ W operator()(W v, W q, W q2, int /*limb*/, size_t /*idx*/) const {
    return csub(v >= q2 ? v - q2 : v, q);
  }
};

// The inverse transform's epilogue: x n^-1, then x the caller's per-limb
// scale when there is one: [0, 2q) -> [0, q).
template <typename W>
struct InvEpilogue {
  W q, f, fs, s, ss;
  bool scaled;
  __device__ __forceinline__ W operator()(W v) const {
    v = shoup_lazy(v, f, fs, q);
    if (scaled) v = shoup_lazy(v, s, ss, q);
    return csub(v, q);
  }
};

// The shape of one transform, all of it known at compile time: a ring of
// 2^LOG_N words held by C = 2^LOG_C blocks of M = 2^LOG_M words each, in
// chunks of 32 KB up to 2^kLogC32 = 4 blocks, then larger chunks (a u64
// ring of 2^15 words is 4 blocks of 64 KB: PERF.md times it against 8 of
// 32 KB); at most 8 blocks (the portable cluster size), so a u64 ring of
// 2^17 words is 8 blocks of 128 KB.  Shared memory holds the padded
// chunk alone.  MIN_BLOCKS bounds the registers a thread may take: 2 blocks
// of 32 KB chunks per SM hold a 2^15 ring of 59 limbs (236 blocks) in one
// wave with up to 64 registers a thread.  In the cross-block stages a
// thread holds BATCH columns of C values at once.
template <typename W, int LOG_N>
struct ClusterShape {
  static constexpr int kLog32K = sizeof(W) == 4 ? 13 : 12;   // words in 32 KB
  static constexpr int kLogC32 = 2;
  static constexpr int LOG_C0 = LOG_N <= kLog32K             ? 0
                                : LOG_N <= kLog32K + kLogC32 ? LOG_N - kLog32K
                                                             : LOG_N - kLog32K - 1;
  static constexpr int LOG_C = LOG_C0 < 3 ? LOG_C0 : 3;
  static constexpr int LOG_M = LOG_N - LOG_C, C = 1 << LOG_C, M = 1 << LOG_M;
  static constexpr int LOG_MC = LOG_M - LOG_C, MC = 1 << LOG_MC;   // columns per block
  static constexpr int THREADS = M / 8 < 512 ? M / 8 : 512;
  static constexpr int SMEM = (M + M / 32) * static_cast<int>(sizeof(W));
  static constexpr int MIN_BLOCKS = LOG_C > 0 && SMEM <= 75 * 1024 ? 2 : 1;
  static constexpr int BATCH = MC >= 2 * THREADS ? 2 : 1;
  static_assert(LOG_C == 0 || MC % (BATCH * THREADS) == 0, "whole batches of columns");
};

// The forward passes of R = 3 (radix-8; 2 or 1 for the last one or two)
// stages, from stage STAGE on, over this block's chunk (global elements
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
#pragma unroll
      for (int k = 0; k < (1 << R); ++k)
        v[k] = epi(v[k], q, q2, limb, static_cast<size_t>(chunk0 + lb + k));
      store_run<W>(out_row + chunk0 + lb, v);
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

// Grid (C, L, batch), clusters of (C, 1, 1): block (r, limb, b) transforms
// chunk r of row (b, limb).  Shared memory: the padded chunk.
template <typename W, int LOG_N, typename Epi>
__global__ void __launch_bounds__(ClusterShape<W, LOG_N>::THREADS,
                                  ClusterShape<W, LOG_N>::MIN_BLOCKS)
fwd_cluster(const W *__restrict__ x, W *__restrict__ y, Tables<W> tb, Epi epi) {
  using S = ClusterShape<W, LOG_N>;
  constexpr int LOG_C = S::LOG_C, C = S::C, LOG_M = S::LOG_M, LOG_MC = S::LOG_MC;
  constexpr int T = S::THREADS, B = S::BATCH;
  constexpr int N = 1 << LOG_N;
  W *buf = reinterpret_cast<W *>(smem_raw);
  const int limb = blockIdx.y;
  const size_t row = (size_t)blockIdx.z * gridDim.y + limb;
  const int64_t key = tb.lm[limb];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * N, *ws = tb.ws + key * N;
  const W *src = x + row * N;
  int rank = 0;
  if constexpr (C > 1) {
    cluster_arrive_relaxed();                    // this block runs
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int it = 0; it < S::MC / (B * T); ++it) {
      const int col = (rank << LOG_MC) + threadIdx.x + it * B * T;
      W v[B][C];
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int hi = 0; hi < C; ++hi) v[u][hi] = src[(hi << LOG_M) + col + u * T];
#pragma unroll
      for (int u = 0; u < B; ++u) radix_fwd<W, LOG_C>(v[u], w, ws, 1, 0, q, q2);
      if (it == 0) cluster_wait();               // every peer runs: push
#pragma unroll
      for (int hi = 0; hi < C; ++hi) {
        W *peer = cluster.map_shared_rank(buf, hi);
#pragma unroll
        for (int u = 0; u < B; ++u) peer[pad32(col + u * T)] = v[u][hi];
      }
    }
    cluster.sync();                              // every chunk is whole
  } else {
#pragma unroll
    for (int it = 0; it < S::M / T; ++it) buf[pad32(threadIdx.x + it * T)] = src[threadIdx.x + it * T];
    __syncthreads();
  }
  local_passes<W, LOG_N, LOG_C>(buf, y + row * N, w, ws, q, q2, rank, epi, limb);
}

// The inverse passes over this block's chunk: strides 2^LOG_T .. M / 2 in
// passes of R = 3 stages (2 or 1 for the last one or two).  The first pass
// reads its 2^R consecutive words straight from the row in device memory;
// the last keeps its values in `buf` for the exchange or, with one block
// per ring (C = 1), lands them through `epi` into out_row.
template <typename W, int LOG_N, int LOG_T>
__device__ __forceinline__ void inv_local_passes(const W *__restrict__ src_row, W *buf,
                                                 W *__restrict__ out_row,
                                                 const W *__restrict__ w, const W *__restrict__ ws,
                                                 W q, W q2, int rank, const InvEpilogue<W> &epi) {
  using S = ClusterShape<W, LOG_N>;
  constexpr int LEFT = S::LOG_M - LOG_T;
  constexpr int R = LEFT == 1 ? 1 : (LEFT == 2 || LEFT == 4) ? 2 : 3;
  constexpr bool FIRST = LOG_T == 0, LAST = R == LEFT;
  constexpr int ITERS = (S::M >> R) / S::THREADS;
  constexpr int GROUPS = 1 << (LOG_N - LOG_T - R);   // twiddle groups of the last stage
  static_assert(ITERS >= 1, "a thread per radix group at least");
  const int chunk0 = rank << S::LOG_M;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int qd = threadIdx.x + it * S::THREADS;
    const int lb = ((qd >> LOG_T) << (LOG_T + R)) | (qd & ((1 << LOG_T) - 1));
    const int i = (chunk0 + lb) >> (LOG_T + R);
    W v[1 << R];
    int slot[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if constexpr (LOG_T >= 5)
        slot[k] = pad32(lb) + k * ((1 << LOG_T) + (1 << (LOG_T - 5)));
      else
        slot[k] = pad32(lb + (k << LOG_T));
    }
    if constexpr (FIRST) {                       // 2^R consecutive words
      load_run<W>(src_row + chunk0 + lb, v);
    } else {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) v[k] = buf[slot[k]];
    }
    radix_inv<W, R>(v, w, ws, GROUPS, i, q, q2);
    if constexpr (LAST && S::C == 1) {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) out_row[lb + (k << LOG_T)] = epi(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) buf[slot[k]] = v[k];
    }
  }
  if constexpr (!LAST) {
    __syncthreads();
    inv_local_passes<W, LOG_N, LOG_T + R>(src_row, buf, out_row, w, ws, q, q2, rank, epi);
  }
}

// Grid and clusters as fwd_cluster's.  scale/scale_s (L,) may be null.
template <typename W, int LOG_N>
__global__ void __launch_bounds__(ClusterShape<W, LOG_N>::THREADS,
                                  ClusterShape<W, LOG_N>::MIN_BLOCKS)
inv_cluster(const W *__restrict__ x, W *__restrict__ y, Tables<W> tb,
            const W *__restrict__ invn, const W *__restrict__ invn_s,
            const W *__restrict__ scale, const W *__restrict__ scale_s) {
  using S = ClusterShape<W, LOG_N>;
  constexpr int LOG_C = S::LOG_C, C = S::C, LOG_M = S::LOG_M, LOG_MC = S::LOG_MC;
  constexpr int T = S::THREADS, B = S::BATCH;
  constexpr int N = 1 << LOG_N;
  W *buf = reinterpret_cast<W *>(smem_raw);
  const int limb = blockIdx.y;
  const size_t row = (size_t)blockIdx.z * gridDim.y + limb;
  const int64_t key = tb.lm[limb];
  const W q = tb.q[key], q2 = 2 * q;
  const W *w = tb.w + key * N, *ws = tb.ws + key * N;
  const bool scaled = scale != nullptr;
  const InvEpilogue<W> epi{q, invn[key], invn_s[key], scaled ? scale[limb] : W(0),
                           scaled ? scale_s[limb] : W(0), scaled};
  W *dst = y + row * N;
  if constexpr (C == 1) {
    inv_local_passes<W, LOG_N, 0>(x + row * N, buf, dst, w, ws, q, q2, 0, epi);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    inv_local_passes<W, LOG_N, 0>(x + row * N, buf, dst, w, ws, q, q2, rank, epi);
    cluster.sync();                              // every chunk is transformed
    constexpr int ITERS = S::MC / (B * T);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (rank << LOG_MC) + threadIdx.x + it * B * T;
      W v[B][C];
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const W *peer = cluster.map_shared_rank(buf, b);
#pragma unroll
        for (int u = 0; u < B; ++u) v[u][b] = peer[pad32(col + u * T)];
      }
      if (it == ITERS - 1) cluster_arrive();     // this block's remote reads are done
#pragma unroll
      for (int u = 0; u < B; ++u) {
        radix_inv<W, LOG_C>(v[u], w, ws, 1, 0, q, q2);
#pragma unroll
        for (int b = 0; b < C; ++b) dst[(b << LOG_M) + col + u * T] = epi(v[u][b]);
      }
    }
    cluster_wait();                              // no peer still reads this chunk
  }
}

template <typename S, typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int rows, int L, cudaStream_t s, Args... args) {
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// f(std::integral_constant<int, log_n>) for the ring sizes the kernels take.
template <typename F>
int with_log_n(int log_n, F &&f) {
  switch (log_n) {
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 13: return f(std::integral_constant<int, 13>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 15: return f(std::integral_constant<int, 15>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 17: return f(std::integral_constant<int, 17>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_rows(int rows, int L) { return L <= 0 || rows % L != 0 || rows / L > 65535 || L > 65535; }

// x, out: (rows, N) with rows = batch * L; out may not alias x.
template <typename W, typename Epi>
int ntt_fwd_cluster(const W *x, W *out, const W *roots, const W *roots_s, const W *q,
                    const int64_t *limb_map, int rows, int L, int log_n, Epi epi,
                    void *stream) {
  if (bad_rows(rows, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Tables<W> tb{roots, roots_s, q, limb_map};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_log_n(log_n, [&](auto ln) {
    constexpr int LOG_N = decltype(ln)::value;
    return launch_cluster<ClusterShape<W, LOG_N>>(fwd_cluster<W, LOG_N, Epi>, rows, L, s, x, out,
                                                  tb, epi);
  });
}

// x (16-byte aligned), out: (rows, N) with rows = batch * L; out may not
// alias x.
template <typename W>
int ntt_inv_cluster(const W *x, W *out, const W *inv_roots, const W *inv_roots_s, const W *q,
                    const int64_t *limb_map, const W *invn, const W *invn_s, const W *scale,
                    const W *scale_s, int rows, int L, int log_n, void *stream) {
  if (bad_rows(rows, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Tables<W> tb{inv_roots, inv_roots_s, q, limb_map};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_log_n(log_n, [&](auto ln) {
    constexpr int LOG_N = decltype(ln)::value;
    return launch_cluster<ClusterShape<W, LOG_N>>(inv_cluster<W, LOG_N>, rows, L, s, x, out, tb,
                                                  invn, invn_s, scale, scale_s);
  });
}

int split(int log_n) { return log_n / 2; }

// The two-phase forward landing.  x, out: (rows, N) with rows = (...) * L;
// out may not alias x; pre/pre_s may be null.
template <typename W>
int ntt_fwd_landing_impl(const W *x, W *out, const W *sub, const W *roots, const W *roots_s,
                         const W *q, const int64_t *limb_map, const W *post, const W *post_s,
                         const W *pre, const W *pre_s, int rows, int L, int log_n,
                         void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n1 = split(log_n), n1 = 1 << log_n1, n2 = 1 << (log_n - log_n1);
  const Tables<W> tb{roots, roots_s, q, limb_map};
  fwd_cols<W><<<dim3(n2 / kColTile, rows), kColThreads, n1 * kColTile * sizeof(W), s>>>(
      x, out, tb, L, log_n, log_n1);
  const int threads = n2 / 2 < 256 ? n2 / 2 : 256;
  fwd_rows<W><<<dim3(n1, rows), threads, n2 * sizeof(W), s>>>(out, tb, sub, post, post_s, pre,
                                                               pre_s, L, log_n, log_n1);
  return static_cast<int>(cudaGetLastError());
}

// The two-phase inverse (K2).
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

// K1: the one-launch cluster transform.
int tfhe_ntt_fwd(const u64 *x, u64 *out, const u64 *roots, const u64 *roots_s, const u64 *q,
                 const int64_t *limb_map, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_cluster<u64>(x, out, roots, roots_s, q, limb_map, rows, L, log_n,
                              FinalReduce<u64>{}, stream);
}

int tfhe_ntt_fwd_landing(const u64 *x, const u64 *sub, u64 *out, const u64 *roots,
                         const u64 *roots_s, const u64 *q, const int64_t *limb_map,
                         const u64 *post, const u64 *post_s, const u64 *pre,
                         const u64 *pre_s, int rows, int L, int log_n, void *stream) {
  return ntt_fwd_landing_impl<u64>(x, out, sub, roots, roots_s, q, limb_map, post, post_s, pre,
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
  return ntt_fwd_landing_impl<u32>(x, out, sub, roots, roots_s, q, limb_map, post, post_s, pre,
                                   pre_s, rows, L, log_n, stream);
}

// K5: the one-launch cluster transform; x must be 16-byte aligned.
int tfhe_ntt_inv32(const u32 *x, u32 *out, const u32 *inv_roots, const u32 *inv_roots_s,
                   const u32 *q, const int64_t *limb_map, const u32 *invn, const u32 *invn_s,
                   const u32 *scale, const u32 *scale_s, int rows, int L, int log_n,
                   void *stream) {
  return ntt_inv_cluster<u32>(x, out, inv_roots, inv_roots_s, q, limb_map, invn, invn_s, scale,
                              scale_s, rows, L, log_n, stream);
}

// The blocks per ring (ClusterShape<W, log_n>::C) that the cluster
// transforms launch on words of `word_bytes` (4 or 8), log_n in 10 .. 17.
int tfhe_ntt_cluster_blocks(int word_bytes, int log_n) {
  return with_log_n(log_n, [&](auto ln) {
    constexpr int LOG_N = decltype(ln)::value;
    return word_bytes == 4 ? ClusterShape<u32, LOG_N>::C : ClusterShape<u64, LOG_N>::C;
  });
}

}  // extern "C"
