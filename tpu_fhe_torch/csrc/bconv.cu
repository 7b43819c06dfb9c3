// RNS fast base conversion (BEHZ, with its alpha*Q overshoot), for Hopper.
//
//   out[b, j, n] = (sum_i s[b, i, n] * table[j, i]) mod p_j
//
// Replaces three Pallas TPU kernels; the first two compute the same
// function (tests/test_bconv_mxu.py holds them bit-identical):
//   * tpu_fhe/ops/bconv_pallas.py:39 _kernel (K11) -> tfhe_bconv: u64
//     multiply-accumulate into 128-bit accumulators, one Barrett landing
//     per output limb;
//   * tpu_fhe/ops/bconv_mxu_pallas.py:82 _kernel (K12) -> tfhe_bconv_mxu:
//     the same sum through int8 digit planes on the tensor cores, the
//     reference's default for k < 64 inputs;
//   * tpu_fhe/ops/bconv_mxu_pallas.py:179 _kernel32 (K13) -> tfhe_bconv32:
//     K12's form for the q32 plan (residues and moduli below 2^30).
//
// tfhe_bconv (K11; the wrapper's kernel for k >= 64): one thread per output
// coefficient (b, j, n), a 128-bit (hi, lo) accumulator, a Barrett
// reduction with the two-word ratio floor(2^128/p) every 63 terms (each
// term is < 2^122, so 63 of them fit; tpu_fhe/ops/bconv.py _ACC_CHUNK) and
// a mod-p sum of the chunks.  Each thread reads its k inputs down a column
// (neighbouring threads on neighbouring n, so reads coalesce) and the
// table row is the same for the whole block (broadcast from cache).
//
// tfhe_bconv_mxu (K12) and tfhe_bconv32 (K13) form the sum through
// balanced base-256 digit planes on the int8 tensor cores.
//   * Each residue is 8 (u64, x < 2^61) or 4 (u32, x < 2^30) balanced
//     digits in [-128, 127]; their bytes are those of x + 0x8080...80 with
//     the top bit of each flipped (no byte carries out, since x < 2^61 or
//     2^30): one add and one xor per word, then byte permutes turn 4
//     inputs' words into one word per plane (4 inputs' digits each), the
//     layout of the MMA's B operand, in shared memory.
//   * The products are mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 of
//     the table's digit fragments (16 output limbs x 32, from
//     ops/bconv.py digit_matrix / digit_matrix32, built once per table and
//     stored in fragment order: one 16-byte load per lane) with the input
//     planes, each accumulated into the byte diagonal s = a + p of its
//     table plane a and input plane p.  Exact: every digit product is at
//     most 2^14 in magnitude, so a diagonal of k inputs stays below 2^23
//     (K12, k < 64) or 2^31 (K13, at most 512 inputs a launch; the
//     wrapper adds further chunks mod p in the landing).
//   * K13: 4 table planes x 4 input planes, 32 inputs per K step, 7
//     diagonals; each lane holds all 7 of 4 outputs, reassembles the
//     96-bit sum as G0 + 2^32 G1 (diagonals 0-3 and 4-6, signed, by
//     IMAD.WIDE chains) and lands it with reduce96.
//   * K12: 8 planes a side, 15 diagonals, 60 accumulators a lane for all
//     of them: too many registers.  So a K step packs two input planes
//     of 16 inputs each (K = 32 = planes 2e and 2e + 1), and the table
//     side is the matching pair A_d = [plane d | plane d - 1] (d = 0..8),
//     whose product with input pair e lands wholly in diagonal d + 2e:
//     36 MMAs per 16 inputs (against 64 with one plane a step, half of
//     whose K would be padding at the main path's k = 15).  The
//     diagonals are summed in their four 64-bit groups G_w (diagonals
//     4w .. 4w + 3) one group at a time, 16 accumulators a lane; each
//     group is folded into a wrapping 128-bit sum of G_w 2^(32 w) (exact:
//     the row sum is below k 2^122 < 2^128), which barrett128 lands with
//     the table's floor(2^128/p), the landing K11 uses.
//
// What bounds them on the H100: operations, just above bytes.  At the
// u64 plan's 15 -> 30 x 2^15 about 0.0051 ms (0.0010 of int8 products at
// the dense tensor-core rate and 0.0041 of epilogue IMADs, against 0.0035
// for the 11.8 MB moved); K13 at 30 -> 59 about 0.0036 ms.  mma.sync runs
// at about half of wgmma's rate, and the landing's 64-bit products are
// several IMADs each; PERF.md has the times.

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

// The bytes of 4 words (one per input, byte p = digit plane p) transposed
// into one word per plane (byte r = input r).
__device__ __forceinline__ void planes_of(const u32 (&v)[4], u32 *pl) {
  const u32 lo01 = __byte_perm(v[0], v[1], 0x5140);
  const u32 lo23 = __byte_perm(v[2], v[3], 0x5140);
  const u32 hi01 = __byte_perm(v[0], v[1], 0x7362);
  const u32 hi23 = __byte_perm(v[2], v[3], 0x7362);
  pl[0] = __byte_perm(lo01, lo23, 0x5410);
  pl[1] = __byte_perm(lo01, lo23, 0x7632);
  pl[2] = __byte_perm(hi01, hi23, 0x5410);
  pl[3] = __byte_perm(hi01, hi23, 0x7632);
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
      u32 pl[4];
      planes_of(v[u], pl);
      u32 *dst = bsm + x * sb + iq;
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q * kNT * sb] = pl[q];
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

// -- K12: u64 residues through 8 digit planes a side ------------------------

constexpr int kLags = 9;       // table fragments A_d = [plane d | plane d - 1], d = 0 .. 8

// (hi, lo) += g 2^(32 W) mod 2^128 for a signed 64-bit g.
template <int W>
__device__ __forceinline__ void add_shifted(u64 &lo, u64 &hi, long long g) {
  if constexpr (W == 0 || W == 1) {
    const u64 add_lo = W == 0 ? static_cast<u64>(g) : static_cast<u64>(g) << 32;
    const u64 add_hi = static_cast<u64>(g >> (W == 0 ? 63 : 32));
    asm("add.cc.u64 %0, %0, %2;\n\taddc.u64 %1, %1, %3;"
        : "+l"(lo), "+l"(hi) : "l"(add_lo), "l"(add_hi));
  } else {
    hi += W == 2 ? static_cast<u64>(g) : static_cast<u64>(g) << 32;
  }
}

// Group W of the 15 byte diagonals (diagonals 4W .. 4W + 3) for one warp
// item, over every K step c (16 inputs, input planes 2e and 2e + 1 of pair
// e), folded into each output's 128-bit sum.  af: the item's table
// fragments, (d, c) at af[(d chunks + c) 32]; brow: the lane's input row,
// pair e of step c at brow[e kNT sb + 8 c] (two plane words).
template <int W>
__device__ __forceinline__ void mxu_group(u64 (&lo)[4], u64 (&hi)[4], const uint4 *af,
                                          const u32 *brow, int chunks, int sb) {
  int acc[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0;
  for (int c = 0; c < chunks; ++c) {
    uint2 bf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (2 * e + 8 >= 4 * W && 2 * e <= 4 * W + 3)   // pair e meets group W
        bf[e] = *reinterpret_cast<const uint2 *>(brow + e * kNT * sb + 8 * c);
#pragma unroll
    for (int d = 0; d < kLags; ++d) {
      if (d + 6 < 4 * W || d > 4 * W + 3) continue;   // A_d meets group W
      const uint4 fa = __ldg(af + (d * chunks + c) * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = d + 2 * e - 4 * W;
        if (s >= 0 && s < 4) mma_s8(acc[s], fa, bf[e].x, bf[e].y);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long g = mad_wide(
        acc[3][r], 1 << 24, mad_wide(acc[2][r], 1 << 16, mad_wide(acc[1][r], 1 << 8, acc[0][r])));
    add_shifted<W>(lo[r], hi[r], g);
  }
}

// Block (tile, b): coefficients [64 tile, +64) of batch b, every input and
// output limb.  afrag: the table's digit fragments (ceil(m/16), 9, chunks,
// 32) uint4, chunks = ceil(k/16).  Warp w owns coefficients 8w .. 8w + 7:
// it writes their input planes to shared memory and reads only those, so
// warps synchronise among themselves alone and one warp's loads overlap
// another's products.  Shared memory: the input planes by pair,
// [e][coefficient][input quad][plane parity] words, row stride sb = 8 mod
// 32 (conflict-free 8-byte fragment loads).
__global__ void __launch_bounds__(kWarps * 32, 4)
bconv_mxu_kernel(const u64 *__restrict__ s, u64 *__restrict__ out,
                 const uint4 *__restrict__ afrag, const u64 *__restrict__ p,
                 const u64 *__restrict__ ratio_lo, const u64 *__restrict__ ratio_hi, int k,
                 int m, int n, int sb) {
  const int chunks = (k + 15) >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, n0 = blockIdx.x * kNT + warp * 8;   // the warp's 8 coefficients
  const u64 *src = s + (size_t)b * k * n + n0;
  u32 *bsm = bconv_smem + warp * 8 * sb;                         // pair e at + e kNT sb
  // lane (coefficient x, input quad iq): the 8-byte stores below hit
  // distinct banks
  const int x = lane & 7;
  for (int iq = lane >> 3; iq < chunks << 2; iq += 4) {
    u32 lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * iq + r;
      const u64 v = (i < k && n0 + x < n ? src[(size_t)i * n + x] : 0ull) + 0x8080808080808080ull;
      lo[r] = static_cast<u32>(v) ^ 0x80808080u;
      hi[r] = static_cast<u32>(v >> 32) ^ 0x80808080u;
    }
    u32 pl[8];
    planes_of(lo, pl);
    planes_of(hi, pl + 4);
    uint2 *dst = reinterpret_cast<uint2 *>(bsm + x * sb + 2 * iq);
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q * kNT * sb / 2] = make_uint2(pl[2 * q], pl[2 * q + 1]);
  }
  __syncwarp();

  // warp item: 16 output limbs x the warp's 8 coefficients
  const int g = lane >> 2, h = lane & 3;
  const u32 *brow = bsm + g * sb + 2 * h;
  const int col = n0 + 2 * h;
  for (int grp = 0; grp < (m + 15) >> 4; ++grp) {
    const uint4 *af = afrag + (size_t)grp * kLags * chunks * 32 + lane;
    u64 lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
    mxu_group<0>(lo, hi, af, brow, chunks, sb);
    mxu_group<1>(lo, hi, af, brow, chunks, sb);
    mxu_group<2>(lo, hi, af, brow, chunks, sb);
    mxu_group<3>(lo, hi, af, brow, chunks, sb);
    // the lane holds limbs 16 grp + g (+ 8) at coefficients col, col + 1
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jj = grp * 16 + g + half * 8;
      if (jj >= m) continue;
      const u64 pj = __ldg(p + jj), r0 = __ldg(ratio_lo + jj), r1 = __ldg(ratio_hi + jj);
      const u64 v0 = barrett128(hi[2 * half], lo[2 * half], pj, r0, r1);
      const u64 v1 = barrett128(hi[2 * half + 1], lo[2 * half + 1], pj, r0, r1);
      u64 *dst = out + ((size_t)b * m + jj) * n + col;
      if (col + 1 < n && (n & 1) == 0) {
        *reinterpret_cast<ulonglong2 *>(dst) = make_ulonglong2(v0, v1);
      } else if (col < n) {
        dst[0] = v0;
        if (col + 1 < n) dst[1] = v1;
      }
    }
  }
}

}  // namespace

extern "C" {

// K11.  s: (batch, k, n); out: (batch, m, n); table: (m, k); p, ratio_lo,
// ratio_hi: (m,).
int tfhe_bconv(const u64 *s, u64 *out, const u64 *table, const u64 *p, const u64 *ratio_lo,
               const u64 *ratio_hi, int batch, int k, int m, int n, void *stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, m, batch);
  bconv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, table, p, ratio_lo, ratio_hi, k, m, n);
  return static_cast<int>(cudaGetLastError());
}

// K12.  s: (batch, k, n) residues below 2^61, 1 <= k < 64; out: (batch,
// m, n); afrag: the table's digit fragments (ceil(m/16), 9, ceil(k/16), 32,
// 4) words (ops/bconv.py digit_matrix); p, ratio_lo, ratio_hi: (m,).
int tfhe_bconv_mxu(const u64 *s, u64 *out, const u32 *afrag, const u64 *p, const u64 *ratio_lo,
                   const u64 *ratio_hi, int batch, int k, int m, int n, void *stream) {
  if (k < 1 || k >= 64) return static_cast<int>(cudaErrorInvalidValue);
  const int sb = k <= 16 ? 8 : 40;   // >= 8 ceil(k/16) words, = 8 mod 32
  const int smem = 4 * kNT * sb * sizeof(u32);   // at most 40 KB
  const dim3 grid((n + kNT - 1) / kNT, batch);
  bconv_mxu_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      s, out, reinterpret_cast<const uint4 *>(afrag), p, ratio_lo, ratio_hi, k, m, n, sb);
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
