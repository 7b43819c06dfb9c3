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
// moduli below 2^30 stored as single u32 words, in K13's own form: the sum
// runs on the int8 tensor cores through balanced base-256 digit planes.
//   * Each residue x < 2^30 is 4 balanced digits in [-128, 127]; their
//     bytes are those of x + 0x80808080 with the top bit of each flipped
//     (no byte carries out because x < 2^30): one add and one xor per
//     input, then 8 byte permutes turn 4 inputs' words into one word per
//     plane (4 inputs' digits each), the layout of the MMA's B operand.
//   * The reference's product is A (7 m, 4 k) @ digits (4 k, nT) over the
//     7 byte diagonals, where block (s, p) of A is the table's digit plane
//     s - p, or zero.  The kernel runs only the 16 nonzero blocks, as
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 of table plane a
//     (16 output limbs x 32 inputs, from ops/bconv.py digit_matrix32,
//     built once per table and stored in fragment order: one 16-byte load
//     per lane) with input plane p, accumulated into diagonal a + p: half
//     the tensor-core work of the dense product.  Exact: at most 4k digit
//     products of magnitude <= 2^14 meet in one diagonal, so |D_s| <=
//     4k * 2^14 < 2^31 for k < 2^15; a launch sums at most 512 inputs
//     (the wrapper adds further chunks mod p in the landing).
//   * Each lane ends up holding all 7 diagonals of 4 outputs in its
//     accumulators, so the epilogue runs in registers: the 96-bit sum as
//     G0 + 2^32 G1 (diagonals 0-3 and 4-6, signed, by IMAD.WIDE chains;
//     the row sum itself is below k * 2^60 < 2^96), then reduce96 with the
//     moduli's constants staged in shared memory.
// What bounds it on the H100: the digit-plane form's operations, just
// above its bytes (at 30 -> 59 x 2^15 about 0.0036 ms: 0.0009 of int8
// products at the dense tensor-core rate and 0.0027 of epilogue IMADs,
// against 0.0035 for the 11.7 MB moved).  mma.sync runs at about half of
// wgmma's rate; its time (PERF.md) is still several times that bound.

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

constexpr int kNT = 64;        // coefficients per block
constexpr int kWarps = 8;
constexpr int kItems = 2;      // (input quad, coefficient) items a thread loads at once

extern __shared__ __align__(16) u32 bconv_smem[];

// D += A (16 x 32 s8) @ B (32 x 8 s8), s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4 &a, u32 b0, u32 b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// d = a * b + c, a 32 x 32 -> 64-bit signed multiply-add (one IMAD.WIDE).
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// Block (tile, b): coefficients [64 tile, +64) of batch b, inputs
// [k0, k0 + kc), every output limb.  afrag: the table's digit planes,
// (ceil(m/16), 4, kc_total, 32) uint4; with accumulate the landing adds the
// sum already in `out` mod p.  Shared memory: the input digit planes
// [plane][coefficient][4 inputs per word], then each output modulus with
// its five fold words.
__global__ void __launch_bounds__(kWarps * 32, 4)
bconv32_kernel(const u32 *__restrict__ s, u32 *__restrict__ out,
               const uint4 *__restrict__ afrag, const u32 *__restrict__ p,
               const u64 *__restrict__ fold, int k, int m, int n, int k0, int kc,
               int kc_total, int accumulate) {
  const int ksteps = (kc + 31) >> 5;
  const int sb = (ksteps << 3) + 4;     // row stride: = 4 mod 8, conflict-free fragments
  u32 *bsm = bconv_smem;                // (4, 64, sb)
  u32 *cst = bconv_smem + 4 * kNT * sb; // (6, m): p, then fold rows 0-4
  for (int e = threadIdx.x; e < 6 * m; e += blockDim.x)
    cst[e] = e < m ? p[e] : static_cast<u32>(fold[e - m]);
  const int b = blockIdx.y, n0 = blockIdx.x * kNT;
  const u32 *src = s + ((size_t)b * k + k0) * n + n0;
  const int items = (ksteps << 3) * kNT;  // (input quad, coefficient)
  for (int e0 = threadIdx.x; e0 < items; e0 += kItems * blockDim.x) {
    u32 v[kItems][4];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * blockDim.x, x = e & (kNT - 1), i = (e >> 6) << 2;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[u][r] = e < items && i + r < kc && n0 + x < n ? src[(size_t)(i + r) * n + x] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * blockDim.x, x = e & (kNT - 1), iq = e >> 6;
      if (e >= items) continue;
      // 4 packed digit words (one per input; zero stays zero), then their
      // bytes transposed into one word per plane (4 inputs each)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[u][r] = (v[u][r] + 0x80808080u) ^ 0x80808080u;
      const u32 lo01 = __byte_perm(v[u][0], v[u][1], 0x5140);
      const u32 lo23 = __byte_perm(v[u][2], v[u][3], 0x5140);
      const u32 hi01 = __byte_perm(v[u][0], v[u][1], 0x7362);
      const u32 hi23 = __byte_perm(v[u][2], v[u][3], 0x7362);
      u32 *dst = bsm + x * sb + iq;
      dst[0] = __byte_perm(lo01, lo23, 0x5410);
      dst[kNT * sb] = __byte_perm(lo01, lo23, 0x7632);
      dst[2 * kNT * sb] = __byte_perm(hi01, hi23, 0x5410);
      dst[3 * kNT * sb] = __byte_perm(hi01, hi23, 0x7632);
    }
  }
  __syncthreads();

  // warp item: 16 output limbs x 8 coefficients; diagonal s collects the
  // products of table plane a and input plane s - a
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, h = lane & 3;
  const int groups = (m + 15) >> 4;
  for (int it = warp; it < groups * (kNT / 8); it += kWarps) {
    const int grp = it >> 3, nsub = it & 7;
    int acc[7][4];
#pragma unroll
    for (int d = 0; d < 7; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0;
    const uint4 *af = afrag + ((size_t)grp * 4 * kc_total + (k0 >> 5)) * 32 + lane;
    for (int c = 0; c < ksteps; ++c) {
      u32 bf[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const u32 *row = bsm + (q * kNT + nsub * 8 + g) * sb + c * 8 + h;
        bf[q][0] = row[0];
        bf[q][1] = row[4];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint4 fa = __ldg(af + ((size_t)a * kc_total + c) * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_s8(acc[a + q], fa, bf[q][0], bf[q][1]);
      }
    }
    // the lane holds limbs 16 grp + g (+ 8) at coefficients nsub 8 + 2h (+ 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jj = grp * 16 + g + half * 8;
      if (jj >= m) continue;
      const u32 pj = cst[jj], f0 = cst[m + jj], f1 = cst[2 * m + jj], f1s = cst[3 * m + jj],
                f2 = cst[4 * m + jj], f2s = cst[5 * m + jj];
      u32 *dst = out + ((size_t)b * m + jj) * n + n0 + nsub * 8 + 2 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n0 + nsub * 8 + 2 * h + e >= n) continue;
        const int r = 2 * half + e;
        const long long g0 = mad_wide(
            acc[3][r], 1 << 24, mad_wide(acc[2][r], 1 << 16, mad_wide(acc[1][r], 1 << 8, acc[0][r])));
        const long long g1 = mad_wide(acc[6][r], 1 << 16, mad_wide(acc[5][r], 1 << 8, acc[4][r]));
        // g0 + 2^32 g1 = w0 + 2^32 w1 + 2^64 w2 (mod 2^96, where the value lies)
        const u32 g0hi = static_cast<u32>(g0 >> 32), g1lo = static_cast<u32>(g1);
        const u32 w1 = g0hi + g1lo;
        const u32 w2 = static_cast<u32>(static_cast<int>(g0hi) >> 31) +
                       static_cast<u32>(g1 >> 32) + (w1 < g0hi);
        const u64 lo = (static_cast<u64>(w1) << 32) | static_cast<u32>(g0);
        u32 v = reduce96(lo, w2, pj, f0, f1, f1s, f2, f2s);
        if (accumulate) v = csub(v + dst[e], pj);
        dst[e] = v;
      }
    }
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

// s: (batch, k, n) u32 residues; out: (batch, m, n); afrag: the table's
// digit planes (ceil(m/16), 4, kc_total, 32, 4) words, kc_total =
// ceil(k/32); p: (m,) moduli below 2^30; fold: (5, m) u64 constants (see
// reduce96).  Sums inputs [k0, k0 + kc), kc <= 512 and k0 a multiple of
// 32; with accumulate, adds to out mod p.
int tfhe_bconv32(const u32 *s, u32 *out, const u32 *afrag, const u32 *p, const u64 *fold,
                 int batch, int k, int m, int n, int k0, int kc, int kc_total, int accumulate,
                 void *stream) {
  if (kc < 1 || kc > 512 || (k0 & 31) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (4 * kNT * (((kc + 31) >> 5) * 8 + 4) + 6 * m) * sizeof(u32);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(bconv32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kNT - 1) / kNT, batch);
  bconv32_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      s, out, reinterpret_cast<const uint4 *>(afrag), p, fold, k, m, n, k0, kc, kc_total,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
