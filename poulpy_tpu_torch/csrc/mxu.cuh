// The four-step digit-plane NTT on the int8 tensor cores: shared stages of
// mxu_ntt.cu (the standalone transforms) and fused_mxu.cu (the fused product).
//
// Every stage computes what poulpy_tpu_torch/backends/mxu.py computes
// (mxu4_forward_limbs_ref / mxu4_inverse_ref): balanced base-256 digit planes
// in int32 wrapping arithmetic, products with the reduction-folded weight
// digits, the assemble Σ_d P_d·2^{8d} in int64 and two Montgomery reductions
// (÷2^60), the elementwise Montgomery twiddle between the steps.  Outputs are
// canonical residues, so they equal the plain versions bit for bit.
//
// The products are mma.sync m16n8k32 with s8 operands and s32 sums: digits
// lie in [-128, 127] and K ≤ 4·128, so |partial| ≤ 512·2^14 = 2^23 and the
// int32 sums are exact.  A operands (digit planes) live in shared memory,
// row-major [M][K + PAD] (PAD = 16 bytes keeps the fragment loads free of
// bank conflicts for K a multiple of 32); B operands (weights) come from
// global memory (L2) in fragment order (backends/mxu.py fragments), one
// 8-byte load per lane and k-step.  Each warp takes up to 4 row tiles of 16
// and 8 output columns with their 4 digit blocks, so the 4 partials of an
// output meet in one thread's registers and the epilogue runs there.
#pragma once

#include "modarith.cuh"

namespace poulpy {

constexpr int NDIG = 4;
constexpr int PAD = 16;

// One balanced base-256 digit of v, v advanced to the rest (the int32
// arithmetic of mxu_ntt4.py digitize_planes, wrapping where it wraps).
__device__ __forceinline__ int digit_step(int32_t& v) {
  const int d = (int)(((uint32_t)v + 128u) & 255u) - 128;
  v = (int32_t)((uint32_t)v - (uint32_t)d) >> 8;
  return d;
}

// Σ_d P_d·2^{8d}·2^{-60} mod p, canonical (mxu_ntt.py _assemble / _redc2).
__device__ __forceinline__ uint32_t assemble_redc2(int p0, int p1, int p2, int p3, uint32_t p,
                                                   uint32_t qinv) {
  int64_t v = (int64_t)p0 + ((int64_t)p1 << 8) + ((int64_t)p2 << 16) + ((int64_t)p3 << 24);
  for (int s = 0; s < 2; ++s) {
    const int64_t m = (int64_t)((((uint64_t)v & MASK30) * qinv) & MASK30);
    v = (v + m * (int64_t)p) >> 30;
  }
  if (v < 0) v += p;
  if (v >= (int64_t)p) v -= p;
  return (uint32_t)v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], int2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// C[row][d·ncols + col] = Σ_k A[row][k]·W[k][d·ncols + col], d < NDIG, for
// rows < M (a multiple of 16·MCH) and cols < ncols (a multiple of 8); kdim a
// multiple of 32.  epi(row, col, P0, P1, P2, P3) receives each output's four
// partials.  Ends without a barrier.
template <int MCH, class Epi>
__device__ __forceinline__ void mma_digits_tiles(const int8_t* A, int lda, int M, int kdim,
                                                 const int2* __restrict__ wf, int ncols,
                                                 Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ctiles = ncols >> 3, ksteps = kdim >> 5;
  const int tasks = (M / (16 * MCH)) * ctiles;
  for (int task = threadIdx.x >> 5; task < tasks; task += blockDim.x >> 5) {
    const int m0 = (task / ctiles) * 16 * MCH;
    const int ct = task % ctiles;
    int acc[MCH][NDIG][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      int2 b[NDIG];
#pragma unroll
      for (int d = 0; d < NDIG; ++d)
        b[d] = __ldg(wf + ((size_t)(d * ctiles + ct) * ksteps + ks) * 32 + lane);
#pragma unroll
      for (int mt = 0; mt < MCH; ++mt) {
        const int8_t* row = A + (size_t)(m0 + mt * 16 + g) * lda + ks * 32 + t * 4;
        const uint32_t a[4] = {*(const uint32_t*)row, *(const uint32_t*)(row + 8 * lda),
                               *(const uint32_t*)(row + 16), *(const uint32_t*)(row + 8 * lda + 16)};
#pragma unroll
        for (int d = 0; d < NDIG; ++d) mma_s8(acc[mt][d], a, b[d]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MCH; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        epi(m0 + mt * 16 + g + 8 * (i >> 1), ct * 8 + t * 2 + (i & 1), acc[mt][0][i],
            acc[mt][1][i], acc[mt][2][i], acc[mt][3][i]);
  }
}

template <class Epi>
__device__ __forceinline__ void mma_digits(const int8_t* A, int lda, int M, int kdim,
                                           const int2* __restrict__ wf, int ncols, Epi epi) {
  if (M % 64 == 0)
    mma_digits_tiles<4>(A, lda, M, kdim, wf, ncols, epi);
  else if (M % 32 == 0)
    mma_digits_tiles<2>(A, lda, M, kdim, wf, ncols, epi);
  else
    mma_digits_tiles<1>(A, lda, M, kdim, wf, ncols, epi);
}

// The four-step split of mxu_ntt4.py _split: N1 = min(128, max(2, N/8)).
struct Split {
  int logn, logn1, n, n1, n2;
  __device__ explicit Split(int logn_) : logn(logn_) {
    logn1 = min(7, max(1, logn - 3));
    n = 1 << logn;
    n1 = 1 << logn1;
    n2 = n >> logn1;
  }
  __device__ int lda_a() const { return NDIG * n2 + PAD; }   // operand rows of K = NDIG·n2
  __device__ int lda_b() const { return NDIG * n1 + PAD; }   // operand rows of K = NDIG·n1
  // int2 words of one prime's fragment-order weights, [NDIG·n2]² and [NDIG·n1]²
  __device__ size_t words_a() const { return (size_t)NDIG * n2 * NDIG * n2 / 8; }
  __device__ size_t words_b() const { return (size_t)NDIG * n1 * NDIG * n1 / 8; }
};

// Bytes of the int8 operands of `rows` rows: [rows·n1][lda_a] and [rows·n2][lda_b].
__device__ __forceinline__ size_t planes_a_bytes(const Split& s, int rows) {
  return (size_t)rows * s.n1 * s.lda_a();
}
__device__ __forceinline__ size_t planes_b_bytes(const Split& s, int rows) {
  return (size_t)rows * s.n2 * s.lda_b();
}

// Forward entry: the digit planes of `rows` rows of N int32 values
// src(r, pos) (planes ≥ nd_in zero, rows past the data zero through src) into
// a_op [rows·n1][lda_a]: row r·n1 + (pos mod n1), column i·n2 + pos/n1.
template <class Src>
__device__ __forceinline__ void fwd_planes(int8_t* a_op, int rows, int nd_in, const Split& s,
                                           Src src) {
  const int lda = s.lda_a();
  for (int idx = threadIdx.x; idx < (rows << s.logn); idx += blockDim.x) {
    const int r = idx >> s.logn, pos = idx & (s.n - 1);
    int32_t v = src(r, pos);
    int8_t* dst = a_op + (size_t)(r * s.n1 + (pos & (s.n1 - 1))) * lda + (pos >> s.logn1);
    for (int i = 0; i < NDIG; ++i) dst[i * s.n2] = (int8_t)(i < nd_in ? digit_step(v) : 0);
  }
}

// Forward step A of one prime: a_op → b_op [rows·n2][lda_b], row r·n2 + k2,
// column j·n1 + n1i: digit j of A[r, n1i, k2]·ψ^{n1i(1+2k2)} (tf Montgomery).
__device__ __forceinline__ void fwd_step_a(const int8_t* a_op, int8_t* b_op, int rows,
                                           const Split& s, const int2* __restrict__ ua_f,
                                           const int32_t* __restrict__ tf, uint32_t p,
                                           uint32_t qinv) {
  const int lda_b = s.lda_b();
  mma_digits(a_op, s.lda_a(), rows * s.n1, NDIG * s.n2, ua_f, s.n2,
             [&](int row, int k2, int p0, int p1, int p2, int p3) {
               const int r = row >> s.logn1, n1i = row & (s.n1 - 1);
               const uint32_t a = assemble_redc2(p0, p1, p2, p3, p, qinv);
               int32_t v = (int32_t)mont_mul(a, (uint32_t)__ldg(tf + n1i * s.n2 + k2), p, qinv);
               int8_t* dst = b_op + (size_t)(r * s.n2 + k2) * lda_b + n1i;
               for (int j = 0; j < NDIG; ++j) dst[j * s.n1] = (int8_t)digit_step(v);
             });
}

// Forward step B of one prime: b_op → out(r, k2·n1 + k1, y), y canonical in
// σ order (out is called for padded rows too).
template <class Out>
__device__ __forceinline__ void fwd_step_b(const int8_t* b_op, int rows, const Split& s,
                                           const int2* __restrict__ v0_f, uint32_t p,
                                           uint32_t qinv, Out out) {
  const int logn2 = s.logn - s.logn1;
  mma_digits(b_op, s.lda_b(), rows * s.n2, NDIG * s.n1, v0_f, s.n1,
             [&](int row, int k1, int p0, int p1, int p2, int p3) {
               out(row >> logn2, ((row & (s.n2 - 1)) << s.logn1) + k1,
                   assemble_redc2(p0, p1, p2, p3, p, qinv));
             });
}

// Inverse entry: the 4 digit planes of σ-order residues src(r, pos),
// pos = k2·n1 + k1, into a_op [rows·n2][lda_b]: row r·n2 + k2, column j·n1 + k1.
template <class Src>
__device__ __forceinline__ void inv_planes(int8_t* a_op, int rows, const Split& s, Src src) {
  const int lda = s.lda_b();
  for (int idx = threadIdx.x; idx < (rows << s.logn); idx += blockDim.x) {
    const int r = idx >> s.logn, pos = idx & (s.n - 1);
    int32_t v = src(r, pos);
    int8_t* dst = a_op + (size_t)(r * s.n2 + (pos >> s.logn1)) * lda + (pos & (s.n1 - 1));
    for (int j = 0; j < NDIG; ++j) dst[j * s.n1] = (int8_t)digit_step(v);
  }
}

// Inverse step A of one prime: a_op → b_op [rows·n1][lda_a], row r·n1 + n1i,
// column j·n2 + k2: digit j of B[r, k2, n1i]·ψ^{-n1i(1+2k2)} (ti Montgomery).
__device__ __forceinline__ void inv_step_a(const int8_t* a_op, int8_t* b_op, int rows,
                                           const Split& s, const int2* __restrict__ wa_f,
                                           const int32_t* __restrict__ ti, uint32_t p,
                                           uint32_t qinv) {
  const int lda_a = s.lda_a();
  const int logn2 = s.logn - s.logn1;
  mma_digits(a_op, s.lda_b(), rows * s.n2, NDIG * s.n1, wa_f, s.n1,
             [&](int row, int n1i, int p0, int p1, int p2, int p3) {
               const int r = row >> logn2, k2 = row & (s.n2 - 1);
               const uint32_t b = assemble_redc2(p0, p1, p2, p3, p, qinv);
               int32_t v = (int32_t)mont_mul(b, (uint32_t)__ldg(ti + n1i * s.n2 + k2), p, qinv);
               int8_t* dst = b_op + (size_t)(r * s.n1 + n1i) * lda_a + k2;
               for (int j = 0; j < NDIG; ++j) dst[j * s.n2] = (int8_t)digit_step(v);
             });
}

// Inverse step B of one prime (N^{-1} folded into w0): b_op →
// out(r, n2i·n1 + n1i, x), x the canonical coefficient residue (out is called
// for padded rows too).
template <class Out>
__device__ __forceinline__ void inv_step_b(const int8_t* b_op, int rows, const Split& s,
                                           const int2* __restrict__ w0_f, uint32_t p,
                                           uint32_t qinv, Out out) {
  mma_digits(b_op, s.lda_a(), rows * s.n1, NDIG * s.n2, w0_f, s.n2,
             [&](int row, int n2i, int p0, int p1, int p2, int p3) {
               out(row >> s.logn1, (n2i << s.logn1) + (row & (s.n1 - 1)),
                   assemble_redc2(p0, p1, p2, p3, p, qinv));
             });
}

}  // namespace poulpy
