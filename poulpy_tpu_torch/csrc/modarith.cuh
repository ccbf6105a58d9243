// Modular and wrapping-int64 helpers shared by the poulpy_tpu_torch kernels.
//
// Every function here computes exactly what its twin in
// poulpy_tpu_torch/hal/ntt.py or hal/normalization.py computes, so the kernels'
// outputs equal the plain PyTorch versions' bit for bit: residues are canonical
// in [0, p), Montgomery products use R = 2^30, limbs are wrapping int64.
// Hopper has native 64-bit integer multiplies, so none of the TPU kernels'
// 15-bit digit products or (hi, lo) i32 pairs are needed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace poulpy {

constexpr uint32_t MASK30 = (1u << 30) - 1;

// Layout of the per-prime constants (backends/ntt.py: kernel_tables).  The
// garner weight and the modulus are 128-bit values split into their low and
// high 64 bits (the 64-bit lift reads only the low halves); C_NINV_SHOUP
// holds N^{-1} mod p in its low word and ⌊N^{-1}·2^32/p⌋ in its high word.
constexpr int CONSTS_PER_PRIME = 10;
enum {
  C_P = 0, C_QINV = 1, C_NINV = 2, C_GINV = 3, C_HALF = 4, C_WEIGHT = 5, C_MOD = 6,
  C_WEIGHT_HI = 7, C_MOD_HI = 8, C_NINV_SHOUP = 9
};

constexpr int MAX_PRIMES = 8;
constexpr int MAX_LIMBS = 16;

// REDC_{2^30}(a·b) for a < 2^30, b < p < 2^30: canonical a·b·R^{-1} mod p.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p, uint32_t qinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = ((uint32_t)t * qinv) & MASK30;
  const uint64_t u = (t + (uint64_t)m * p) >> 30;
  return (uint32_t)(u >= p ? u - p : u);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// Σ_k x_k·y_k accumulated in u64 (each term < 2^60), reduced to canonical
// Σ x_k·y_k·R^{-1} mod p.  The accumulator is folded mod p whenever it reaches
// 2^63, so no sum can wrap whatever K and p < 2^30 are.
__device__ __forceinline__ uint64_t mac_guard(uint64_t acc, uint32_t x, uint32_t y, uint32_t p) {
  acc += (uint64_t)x * y;
  return (acc >> 63) ? acc % p : acc;
}

__device__ __forceinline__ uint32_t fold_redc(uint64_t acc, uint32_t p, uint32_t qinv) {
  return mont_mul((uint32_t)(acc % p), 1u, p, qinv);
}

// ---- lazy reduction (fused_mxu.cu's tile design, the butterfly kernels' lazy design) ----

// The lazy reduction's constants of one prime: 2^32 mod p and R² mod p.
struct PrimeK {
  uint32_t p, qinv, c32, r2;
  PrimeK() = default;
  __device__ PrimeK(const int64_t* __restrict__ consts, int pi) {
    p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    c32 = (uint32_t)((1ull << 32) % p);
    r2 = (uint32_t)((1ull << 60) % p);
  }
};

// x mod p kept below 2^62 + 2^32 (any x < 2^64): high word · (2^32 mod p) + low word.
// A sum of products of canonical residues (each < 2^60) folded every 8 terms
// never wraps.
__device__ __forceinline__ uint64_t fold32(uint64_t x, uint32_t c32) {
  return (uint64_t)(uint32_t)(x >> 32) * c32 + (uint32_t)x;
}

// One Montgomery step of x < 2^63: (x + m·p)/2^30 ≡ x·2^{-30}, below x/2^30 + p.
__device__ __forceinline__ uint64_t redc_step(uint64_t x, uint32_t p, uint32_t qinv) {
  const uint32_t m = ((uint32_t)x * qinv) & MASK30;
  return (x + (uint64_t)m * p) >> 30;
}

// Canonical x·2^{-30} mod p for any x < 2^64: fold_redc's value without its
// 64-bit `%` (two Montgomery steps give x·2^{-60} below p + 5, then · R²).
__device__ __forceinline__ uint32_t reduce_redc(uint64_t x, const PrimeK& k) {
  const uint64_t u = redc_step(redc_step(fold32(x, k.c32), k.p, k.qinv), k.p, k.qinv);
  const uint32_t v = (uint32_t)(u >= k.p ? u - k.p : u);
  return mont_mul(v, k.r2, k.p, k.qinv);
}

// Forward negacyclic Cooley–Tukey NTT, in place, of `rows` rows of n = 2^logn
// words in shared memory.  Stage s has 2^s blocks of half-length 2^(logn-1-s);
// block i uses tw[2^s + i] (bit-reversed psi powers, Montgomery form).  The
// caller synchronises before; every stage ends with a barrier.
__device__ __forceinline__ void ntt_fwd_rows(uint32_t* buf, int rows, int logn,
                                             const int32_t* __restrict__ tw,
                                             uint32_t p, uint32_t qinv) {
  const int halfn = 1 << (logn - 1);
  const int total = rows << (logn - 1);
  for (int s = 0; s < logn; ++s) {
    const int hl = logn - 1 - s;
    for (int bf = threadIdx.x; bf < total; bf += blockDim.x) {
      const int row = bf >> (logn - 1);
      const int j = bf & (halfn - 1);
      const int i = j >> hl;
      const int lo = (row << logn) + (i << (hl + 1)) + (j & ((1 << hl) - 1));
      const int hi = lo + (1 << hl);
      const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + i);
      const uint32_t a = buf[lo];
      const uint32_t v = mont_mul(buf[hi], w, p, qinv);
      buf[lo] = add_mod(a, v, p);
      buf[hi] = sub_mod(a, v, p);
    }
    __syncthreads();
  }
}

// Inverse (Gentleman–Sande) of ntt_fwd_rows, without the final N^{-1} scale:
// the caller applies mont_mul(x, ninv) as it reads the result.
__device__ __forceinline__ void ntt_inv_rows(uint32_t* buf, int rows, int logn,
                                             const int32_t* __restrict__ tw_inv,
                                             uint32_t p, uint32_t qinv) {
  const int halfn = 1 << (logn - 1);
  const int total = rows << (logn - 1);
  for (int s = logn - 1; s >= 0; --s) {
    const int hl = logn - 1 - s;
    for (int bf = threadIdx.x; bf < total; bf += blockDim.x) {
      const int row = bf >> (logn - 1);
      const int j = bf & (halfn - 1);
      const int i = j >> hl;
      const int lo = (row << logn) + (i << (hl + 1)) + (j & ((1 << hl) - 1));
      const int hi = lo + (1 << hl);
      const uint32_t w = (uint32_t)__ldg(tw_inv + (1 << s) + i);
      const uint32_t a = buf[lo];
      const uint32_t b = buf[hi];
      buf[lo] = add_mod(a, b, p);
      buf[hi] = mont_mul(sub_mod(a, b, p), w, p, qinv);
    }
    __syncthreads();
  }
}

// ---- wrapping int64 (signed overflow is undefined in C++: go through u64) ----

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

// x << s for any s >= 0 (s >= 64 gives 0): hal/normalization.py _shl_wrap.
__device__ __forceinline__ int64_t shl_wrap(int64_t x, int s) {
  return s >= 64 ? 0 : (int64_t)((uint64_t)x << s);
}

// Arithmetic shift by a signed amount, right shifts clamped to 63.
__device__ __forceinline__ int64_t ash(int64_t x, int s) {
  return s >= 0 ? shl_wrap(x, s) : (x >> (-s < 63 ? -s : 63));
}

// Signed kr-bit window of d·2^t (hal/normalization.py _window).
__device__ __forceinline__ int64_t window(int64_t d, int t, int kr) {
  return wsub(ash(d, t), shl_wrap(ash(d, t - kr), kr));
}

__device__ __forceinline__ int64_t get_digit(int k, int64_t x) {
  return ((int64_t)((uint64_t)x << (64 - k))) >> (64 - k);
}

__device__ __forceinline__ int64_t get_carry(int k, int64_t x, int64_t digit) {
  return wsub(x, digit) >> k;
}

// vec_znx_normalize(kr, a) with lsh = 0, for one coefficient of `size` limbs.
__device__ __forceinline__ void normalize_limbs(const int64_t* a, int size, int64_t* out, int kr) {
  if (size == 1) {
    out[0] = get_digit(kr, get_digit(kr, a[0]));
    return;
  }
  int64_t d = get_digit(kr, a[size - 1]);
  int64_t c = get_carry(kr, a[size - 1], d);
  out[size - 1] = d;
  for (int j = size - 2; j > 0; --j) {
    d = get_digit(kr, a[j]);
    const int64_t carry = get_carry(kr, a[j], d);
    const int64_t dpc = wadd(d, c);
    const int64_t x1 = get_digit(kr, dpc);
    out[j] = x1;
    c = wadd(carry, get_carry(kr, dpc, x1));
  }
  out[0] = get_digit(kr, wadd(get_digit(kr, a[0]), c));
}

// vec_znx_normalize_full(res_size, kr, 0, a, ka) for one coefficient.
__device__ __forceinline__ void normalize_full(const int64_t* a, int a_size, int64_t* out,
                                               int res_size, int kr, int ka) {
  if (kr == ka && res_size == a_size) {
    normalize_limbs(a, a_size, out, kr);
    return;
  }
  int64_t acc[MAX_LIMBS];
  for (int i = 0; i < res_size; ++i) {
    int64_t s = 0;
    for (int j = 0; j < a_size; ++j) s = wadd(s, window(a[j], (i + 1) * kr - (j + 1) * ka, kr));
    acc[i] = s;
  }
  normalize_limbs(acc, res_size, out, kr);
}

// Garner's mixed-radix digits d[0..P) of residues r[0..P) (hal/ntt.py garner_lift).
__device__ __forceinline__ void garner_digits(const uint32_t* r, int P,
                                              const int64_t* __restrict__ consts, uint32_t* d) {
  const int64_t* pprod = consts + P * CONSTS_PER_PRIME;
  for (int i = 0; i < P; ++i) {
    const int64_t* c = consts + i * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    uint32_t x = r[i];
    for (int j = 0; j < i; ++j) x = sub_mod(x, mont_mul(d[j], (uint32_t)pprod[i * P + j], p, qinv), p);
    if (i > 0) x = mont_mul(x, (uint32_t)c[C_GINV], p, qinv);
    d[i] = x;
  }
}

// True when the digit vector exceeds that of floor(M/2): the value is then
// centred by subtracting M.
__device__ __forceinline__ bool garner_above_half(const uint32_t* d, int P,
                                                  const int64_t* __restrict__ consts) {
  bool gt = false, eq = true;
  for (int i = P - 1; i >= 0; --i) {
    const uint32_t h = (uint32_t)consts[i * CONSTS_PER_PRIME + C_HALF];
    gt = gt || (eq && d[i] > h);
    eq = eq && d[i] == h;
  }
  return gt;
}

// Centred Garner CRT lift of one coefficient (hal/ntt.py garner_lift): residues
// r[0..P) → wrapping int64.
__device__ __forceinline__ int64_t garner(const uint32_t* r, int P, const int64_t* __restrict__ consts) {
  uint32_t d[MAX_PRIMES];
  garner_digits(r, P, consts, d);
  uint64_t v = 0;
  for (int i = 0; i < P; ++i)
    v += (uint64_t)d[i] * (uint64_t)consts[i * CONSTS_PER_PRIME + C_WEIGHT];
  if (garner_above_half(d, P, consts)) v -= (uint64_t)consts[C_MOD];
  return (int64_t)v;
}

// The same lift into a wrapping 128-bit value (hal/wide.py garner_lift_wide):
// Σ d_i·W_i mod 2^128, minus M mod 2^128 when centred.
__device__ __forceinline__ __int128 garner128(const uint32_t* r, int P,
                                              const int64_t* __restrict__ consts) {
  uint32_t d[MAX_PRIMES];
  garner_digits(r, P, consts, d);
  unsigned __int128 v = 0;
  for (int i = 0; i < P; ++i) {
    const int64_t* c = consts + i * CONSTS_PER_PRIME;
    const unsigned __int128 w =
        ((unsigned __int128)(uint64_t)c[C_WEIGHT_HI] << 64) | (uint64_t)c[C_WEIGHT];
    v += (unsigned __int128)d[i] * w;
  }
  if (garner_above_half(d, P, consts))
    v -= ((unsigned __int128)(uint64_t)consts[C_MOD_HI] << 64) | (uint64_t)consts[C_MOD];
  return (__int128)v;
}

// hal/wide.py vec_znx_normalize_full_wide(res_size, kr, offset, a, ka) for one
// coefficient of a_size wrapping 128-bit limbs, kr ≤ 59: output limb i sums the
// kr-bit windows [0, 2^kr) of a[j]·2^t, t = (i+1)·kr − (j+1)·ka + offset (a
// window with t ≥ kr is zero), then one carry scan.
__device__ __forceinline__ void normalize_full_wide(const __int128* a, int a_size, int64_t* out,
                                                    int res_size, int kr, int ka, int offset) {
  const uint64_t mask = (1ull << kr) - 1;
  int64_t acc[MAX_LIMBS];
  for (int i = 0; i < res_size; ++i) {
    int64_t s = 0;
    for (int j = 0; j < a_size; ++j) {
      const int t = (i + 1) * kr - ((j + 1) * ka - offset);
      if (t >= kr) continue;
      uint64_t piece;
      if (t > 0) {
        piece = ((uint64_t)a[j] & ((1ull << (kr - t)) - 1)) << t;
      } else {
        const int sh = -t;
        piece = (uint64_t)(sh >= 128 ? a[j] >> 127 : a[j] >> sh) & mask;
      }
      s = wadd(s, (int64_t)piece);
    }
    acc[i] = s;
  }
  normalize_limbs(acc, res_size, out, kr);
}

// ---- shared stages of the fused kernels (fused_product.cu, br_block_step.cu,
// wide_product.cu, wide_tensor.cu, tensor_product.cu) ----

// Entry: rows r0 .. r0+nr−1 of the entry rows of one ciphertext (a: [ci][size_a][n]
// int64, any value; row k = column·rmax + limb, limb < rmax) reduced to [0, p) into
// xin [nr][n].  Ends with a barrier.
__device__ __forceinline__ void load_rows_mod_p(uint32_t* xin, const int64_t* __restrict__ a,
                                                int size_a, int rmax, int r0, int nr, int logn,
                                                uint32_t p) {
  const int n = 1 << logn;
  for (int idx = threadIdx.x; idx < (nr << logn); idx += blockDim.x) {
    const int k = r0 + (idx >> logn);
    const int col = k / rmax;
    const int l = k - col * rmax;
    const int64_t v = a[((int64_t)col * size_a + l) * n + (idx & (n - 1))] % (int64_t)p;
    xin[idx] = (uint32_t)(v < 0 ? v + p : v);
  }
  __syncthreads();
}

// All kk = ci·rmax entry rows.
__device__ __forceinline__ void load_rows_mod_p(uint32_t* xin, const int64_t* __restrict__ a,
                                                int ci, int size_a, int rmax, int logn, uint32_t p) {
  load_rows_mod_p(xin, a, size_a, rmax, 0, ci * rmax, logn, p);
}

// ---- the global layout of the fused kernels ----
//
// A fused kernel keeps a block's residue rows in shared memory where they fit
// (the shared layout).  Where they do not, the wrapper launches the kernel's
// STAGED instance (the global layout): the rows live in a global workspace,
// one slot of rows per block, the block walks its tasks grid-stride, and each
// transform runs in shared memory on at most `srows` rows at a time.

// dst[0, rows·n) ← src, then a barrier.
__device__ __forceinline__ void copy_rows(uint32_t* dst, const uint32_t* src, int rows, int logn) {
  for (int idx = threadIdx.x; idx < (rows << logn); idx += blockDim.x) dst[idx] = src[idx];
  __syncthreads();
}

// Rows [0, rows) of one transform into dst: fill(buf, r0, nr) writes rows
// r0 .. r0+nr−1 into buf, xform(buf, nr) transforms them in place (each ends
// with a barrier).  Shared layout: buf is dst, in one pass.  STAGED: dst is
// the global workspace and the rows pass through `stage` (shared memory)
// `srows` at a time.
template <bool STAGED, class Fill, class Xform>
__device__ __forceinline__ void transform_rows(uint32_t* dst, int rows, uint32_t* stage, int srows,
                                               int logn, Fill fill, Xform xform) {
  if (!STAGED) {
    fill(dst, 0, rows);
    xform(dst, rows);
    return;
  }
  for (int r0 = 0; r0 < rows; r0 += srows) {
    const int nr = min(srows, rows - r0);
    fill(stage, r0, nr);
    xform(stage, nr);
    copy_rows(dst + ((size_t)r0 << logn), stage, nr, logn);
  }
}

// The kernel's work: body(task, slot) for each of `tasks` tasks.  Shared
// layout: one task per block (the grid is the task count).  STAGED: the block
// walks its tasks grid-stride with its own workspace slot of `slot_words`
// words, a barrier between tasks.
template <bool STAGED, class Body>
__device__ __forceinline__ void for_each_task(int tasks, uint32_t* ws, size_t slot_words,
                                              Body body) {
  if (!STAGED) {
    body((int)blockIdx.x, (uint32_t*)nullptr);
    return;
  }
  uint32_t* slot = ws + (size_t)blockIdx.x * slot_words;
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    body(task, slot);
    __syncthreads();
  }
}

// VMP of one prime: output rows m0 .. m0+mrows−1 of the [kk][mdim][n] matrix
// pmp (Montgomery), y[row] = Σ_k xin[k]·pmp[k][m0+row]·R^{-1} mod p, summed in
// u64 with one reduction, into y [mrows][n].  Ends with a barrier.
__device__ __forceinline__ void vmp_rows(uint32_t* y, const uint32_t* xin,
                                         const int32_t* __restrict__ pmp, int kk, int mdim,
                                         int m0, int mrows, int logn, uint32_t p, uint32_t qinv) {
  const int n = 1 << logn;
  for (int idx = threadIdx.x; idx < (mrows << logn); idx += blockDim.x) {
    const int m = m0 + (idx >> logn);
    const int coef = idx & (n - 1);
    uint64_t acc = 0;
    for (int k = 0; k < kk; ++k) {
      acc = mac_guard(acc, xin[(k << logn) + coef],
                      (uint32_t)__ldg(pmp + ((size_t)k * mdim + m) * n + coef), p);
    }
    y[idx] = fold_redc(acc, p, qinv);
  }
  __syncthreads();
}

// The 64-bit value of row `row`, coefficient `coef`, of an inverse-NTT'd block
// ys [P][rows][n] (shared or global memory): the N^{-1} scale, then the Garner
// lift.
__device__ __forceinline__ int64_t lift_limb(const uint32_t* ys, int P, int rows, int logn,
                                             int row, int coef,
                                             const int64_t* __restrict__ consts) {
  uint32_t r[MAX_PRIMES];
  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t yv = ys[(((size_t)pi * rows + row) << logn) + coef];
    r[pi] = mont_mul(yv, (uint32_t)c[C_NINV], (uint32_t)c[C_P], (uint32_t)c[C_QINV]);
  }
  return garner(r, P, consts);
}

// Exit for one output column `col` and coefficient `coef`: the lift of each of
// the psize limbs (ys: [P][mdim][n] residues, rows col·psize + j), zero limbs
// up to ext ≥ psize, + add[j·n] for j < add_size ≤ ext (wrapping int64), then
// normalize_full of the ext limbs to res_size limbs of base 2^kr written to
// out[i·n], i < res_size.  ext ≤ MAX_LIMBS (the wrappers check it).
__device__ __forceinline__ void lift_add_normalize(const uint32_t* ys, int P, int mdim, int logn,
                                                   int col, int psize, int coef,
                                                   const int64_t* __restrict__ add, int add_size,
                                                   int ext, int64_t* __restrict__ out,
                                                   int res_size, int kr, int ka,
                                                   const int64_t* __restrict__ consts) {
  const int n = 1 << logn;
  int64_t big[MAX_LIMBS];
  for (int j = 0; j < ext; ++j) {
    big[j] = j < psize ? lift_limb(ys, P, mdim, logn, col * psize + j, coef, consts) : 0;
    if (j < add_size) big[j] = wadd(big[j], add[(int64_t)j * n]);
  }
  int64_t res[MAX_LIMBS];
  normalize_full(big, ext, res, res_size, kr, ka);
  for (int i = 0; i < res_size; ++i) out[(int64_t)i * n] = res[i];
}

// Rank-1 tensor step, one prime, one coefficient: the limb convolution of
// column pair `pair` (0: a0·b0, 1: a0·b1 + a1·b0, 2: a1·b1) of the NTT'd
// standard residues xa [ncols][size_a][n] and xb [ncols][size_b][n] (ncols 2
// for pair 1, else 1), y[(k − k0)·n + coef] = Σ_{l + j = k} xa_l·xb_j mod p
// for k0 ≤ k < k1 ≤ MAX_LIMBS.  The sums run in u64 folded at 2^63
// (mac_guard) and are reduced once.  IN_PLACE (k0 = 0): every input of the
// coefficient is read before any output is written, so y may alias xa (a
// thread then works on its own column of the rows); otherwise each output
// is written as it is summed.
template <bool IN_PLACE>
__device__ __forceinline__ void pair_conv(uint32_t* y, const uint32_t* xa, const uint32_t* xb,
                                          int pair, int size_a, int size_b, int k0, int k1,
                                          int logn, int coef, uint32_t p) {
  uint32_t res[IN_PLACE ? MAX_LIMBS : 1];
  for (int k = k0; k < k1; ++k) {
    uint64_t acc = 0;
    for (int l = 0; l < size_a; ++l) {
      const int j = k - l;
      if (j < 0 || j >= size_b) continue;
      if (pair == 1) {
        acc = mac_guard(acc, xa[(l << logn) + coef], xb[((size_b + j) << logn) + coef], p);
        acc = mac_guard(acc, xa[((size_a + l) << logn) + coef], xb[(j << logn) + coef], p);
      } else {
        acc = mac_guard(acc, xa[(l << logn) + coef], xb[(j << logn) + coef], p);
      }
    }
    if (IN_PLACE)
      res[k] = (uint32_t)(acc % p);
    else
      y[((k - k0) << logn) + coef] = (uint32_t)(acc % p);
  }
  if (IN_PLACE)
    for (int k = 0; k < k1; ++k) y[(k << logn) + coef] = res[k];
}

// The wide twin of lift_add_normalize: the Garner lift to 128 bits, + the
// sign-extended add[j·n] for j < add_size, then normalize_full_wide with the
// landing offset.
__device__ __forceinline__ void lift_add_normalize_wide(const uint32_t* ys, int P, int mdim,
                                                        int logn, int col, int psize, int coef,
                                                        const int64_t* __restrict__ add,
                                                        int add_size, int64_t* __restrict__ out,
                                                        int res_size, int kr, int ka, int offset,
                                                        const int64_t* __restrict__ consts) {
  const int n = 1 << logn;
  __int128 big[MAX_LIMBS];
  for (int j = 0; j < psize; ++j) {
    uint32_t r[MAX_PRIMES];
    for (int pi = 0; pi < P; ++pi) {
      const int64_t* c = consts + pi * CONSTS_PER_PRIME;
      const uint32_t yv = ys[((size_t)pi * mdim + col * psize + j) * n + coef];
      r[pi] = mont_mul(yv, (uint32_t)c[C_NINV], (uint32_t)c[C_P], (uint32_t)c[C_QINV]);
    }
    big[j] = garner128(r, P, consts);
    if (j < add_size)
      big[j] = (__int128)((unsigned __int128)big[j] +
                           (unsigned __int128)(__int128)add[(int64_t)j * n]);
  }
  int64_t res[MAX_LIMBS];
  normalize_full_wide(big, psize, res, res_size, kr, ka, offset);
  for (int i = 0; i < res_size; ++i) out[(int64_t)i * n] = res[i];
}

// ---- the lift at compile-time shapes (garner_exit.cu's tile design, tensor.cuh's
// lazy design): the Garner constants in shared memory, the limb arrays sized
// at compile time so that they stay in registers ----

// The Garner constants of a basis (backends/ntt.py kernel_tables), in shared
// memory; weight_hi / mod_hi are the 128-bit lift's high words, ninv the
// inverse NTT's N^{-1} (Montgomery).
struct ExitPrimes {
  uint32_t p[MAX_PRIMES], qinv[MAX_PRIMES], ginv[MAX_PRIMES], half[MAX_PRIMES];
  uint32_t ninv[MAX_PRIMES];
  uint32_t pprod[MAX_PRIMES][MAX_PRIMES];
  uint64_t weight[MAX_PRIMES], weight_hi[MAX_PRIMES], mod, mod_hi;
};

// Every thread of the block fills `k`, then a barrier.
__device__ __forceinline__ void load_exit_primes(ExitPrimes& k, const int64_t* __restrict__ consts,
                                                 int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int64_t* c = consts + i * CONSTS_PER_PRIME;
    k.p[i] = (uint32_t)c[C_P], k.qinv[i] = (uint32_t)c[C_QINV];
    k.ginv[i] = (uint32_t)c[C_GINV], k.half[i] = (uint32_t)c[C_HALF];
    k.ninv[i] = (uint32_t)c[C_NINV];
    k.weight[i] = (uint64_t)c[C_WEIGHT], k.weight_hi[i] = (uint64_t)c[C_WEIGHT_HI];
  }
  for (int i = threadIdx.x; i < P * P; i += blockDim.x)
    k.pprod[i / P][i % P] = (uint32_t)consts[P * CONSTS_PER_PRIME + i];
  if (threadIdx.x == 0) k.mod = (uint64_t)consts[C_MOD], k.mod_hi = (uint64_t)consts[C_MOD_HI];
  __syncthreads();
}

// garner_digits and garner_above_half on the constants of `k`: the digits
// d[0..P) of residues r[0..P), and whether the value is centred (PT > 0: P =
// PT at compile time; 0: P ≤ MAX_PRIMES at run time, the loops unrolled over
// MAX_PRIMES with a guard, so r and the digits stay in registers either way).
template <int PT>
__device__ __forceinline__ bool exit_digits(const uint32_t (&r)[PT ? PT : MAX_PRIMES], int P_rt,
                                            const ExitPrimes& k,
                                            uint32_t (&d)[PT ? PT : MAX_PRIMES]) {
  constexpr int PM = PT ? PT : MAX_PRIMES;
  const int P = PT ? PT : P_rt;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    if (i >= P) break;
    const uint32_t p = k.p[i], qinv = k.qinv[i];
    uint32_t x = r[i];
#pragma unroll
    for (int j = 0; j < i; ++j) x = sub_mod(x, mont_mul(d[j], k.pprod[i][j], p, qinv), p);
    if (i > 0) x = mont_mul(x, k.ginv[i], p, qinv);
    d[i] = x;
  }
  bool gt = false, eq = true;
#pragma unroll
  for (int i = PM - 1; i >= 0; --i) {
    if (i >= P) continue;
    gt = gt || (eq && d[i] > k.half[i]);
    eq = eq && d[i] == k.half[i];
  }
  return gt;
}

// modarith.cuh garner on the constants of `k`: the centred lift of residues
// r[0..P) to wrapping int64.
template <int PT>
__device__ __forceinline__ int64_t exit_lift(const uint32_t (&r)[PT ? PT : MAX_PRIMES], int P_rt,
                                             const ExitPrimes& k) {
  constexpr int PM = PT ? PT : MAX_PRIMES;
  const int P = PT ? PT : P_rt;
  uint32_t d[PM];
  const bool above = exit_digits<PT>(r, P_rt, k, d);
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    if (i >= P) break;
    v += (uint64_t)d[i] * k.weight[i];
  }
  return (int64_t)(above ? v - k.mod : v);
}

// modarith.cuh garner128 on the constants of `k`: the same lift into a
// wrapping 128-bit value.
template <int PT>
__device__ __forceinline__ __int128 exit_lift_wide(const uint32_t (&r)[PT ? PT : MAX_PRIMES],
                                                   int P_rt, const ExitPrimes& k) {
  constexpr int PM = PT ? PT : MAX_PRIMES;
  const int P = PT ? PT : P_rt;
  uint32_t d[PM];
  const bool above = exit_digits<PT>(r, P_rt, k, d);
  unsigned __int128 v = 0;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    if (i >= P) break;
    v += (unsigned __int128)d[i] * (((unsigned __int128)k.weight_hi[i] << 64) | k.weight[i]);
  }
  if (above) v -= ((unsigned __int128)k.mod_hi << 64) | k.mod;
  return (__int128)v;
}

// normalize_limbs at a compile-time size.
template <int SIZE>
__device__ __forceinline__ void normalize_limbs_t(const int64_t (&a)[SIZE], int64_t (&out)[SIZE],
                                                  int kr) {
  if constexpr (SIZE == 1) {
    out[0] = get_digit(kr, get_digit(kr, a[0]));
  } else {
    int64_t d = get_digit(kr, a[SIZE - 1]);
    int64_t c = get_carry(kr, a[SIZE - 1], d);
    out[SIZE - 1] = d;
#pragma unroll
    for (int j = SIZE - 2; j > 0; --j) {
      d = get_digit(kr, a[j]);
      const int64_t carry = get_carry(kr, a[j], d);
      const int64_t dpc = wadd(d, c);
      const int64_t x1 = get_digit(kr, dpc);
      out[j] = x1;
      c = wadd(carry, get_carry(kr, dpc, x1));
    }
    out[0] = get_digit(kr, wadd(get_digit(kr, a[0]), c));
  }
}

// normalize_full at compile-time sizes.
template <int A, int RES>
__device__ __forceinline__ void normalize_full_t(const int64_t (&a)[A], int64_t (&out)[RES],
                                                 int kr, int ka) {
  if constexpr (RES == A) {
    if (kr == ka) {
      normalize_limbs_t<RES>(a, out, kr);
      return;
    }
  }
  int64_t acc[RES];
#pragma unroll
  for (int i = 0; i < RES; ++i) {
    int64_t s = 0;
#pragma unroll
    for (int j = 0; j < A; ++j) s = wadd(s, window(a[j], (i + 1) * kr - (j + 1) * ka, kr));
    acc[i] = s;
  }
  normalize_limbs_t<RES>(acc, out, kr);
}

// normalize_full_wide at compile-time sizes.
template <int A, int RES>
__device__ __forceinline__ void normalize_full_wide_t(const __int128 (&a)[A], int64_t (&out)[RES],
                                                      int kr, int ka, int offset) {
  const uint64_t mask = (1ull << kr) - 1;
  int64_t acc[RES];
#pragma unroll
  for (int i = 0; i < RES; ++i) {
    int64_t s = 0;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const int t = (i + 1) * kr - ((j + 1) * ka - offset);
      if (t >= kr) continue;
      uint64_t piece;
      if (t > 0) {
        piece = ((uint64_t)a[j] & ((1ull << (kr - t)) - 1)) << t;
      } else {
        const int sh = -t;
        piece = (uint64_t)(sh >= 128 ? a[j] >> 127 : a[j] >> sh) & mask;
      }
      s = wadd(s, (int64_t)piece);
    }
    acc[i] = s;
  }
  normalize_limbs_t<RES>(acc, out, kr);
}

// ---- the stage clock of the TIMED instances (fused_mxu.cu, fused_product.cu,
// br_block_step.cu, tensor_product.cu, wide_tensor.cu) ----

// Thread 0 adds the SM cycles since its last mark to the stage that a
// barrier has just closed; each block writes its NST sums to
// stamps[block][NST] at the end.  With ON false every call is empty.
template <bool ON, int NST>
struct StageClock {
  long long last = 0, acc[NST] = {};
  __device__ StageClock() {
    if (ON && threadIdx.x == 0) last = clock64();
  }
  __device__ void mark(int stage) {
    if (ON && threadIdx.x == 0) {
      const long long now = clock64();
      acc[stage] += now - last;
      last = now;
    }
  }
  __device__ void store(long long* stamps) const {
    if (ON && threadIdx.x == 0)
      for (int i = 0; i < NST; ++i) stamps[(size_t)blockIdx.x * NST + i] = acc[i];
  }
};

// The stages of the butterfly kernels (fused_product.cu, br_block_step.cu),
// both designs: limbs to residues, forward NTT, VMP (with the block step's
// x-power products), inverse NTT, exit (N^{-1}, Garner, add, normalize).
enum { BF_ENTRY, BF_FWD, BF_VMP, BF_INV, BF_EXIT, BF_NSTAGES };

// The stages of the rank-1 tensor kernels (tensor_product.cu, wide_tensor.cu),
// both designs: limbs to residues and the forward NTT, the limb convolution,
// the inverse NTT, the lift (N^{-1}, Garner, normalize).
enum { TS_ENTRY_FWD, TS_CONV, TS_INV, TS_LIFT, TS_NSTAGES };

// ---- the lazy design of the butterfly kernels (fused_product.cu,
// br_block_step.cu) ----
//
// A block keeps T ciphertexts' residue rows in shared memory as T·P regions
// of R = max(KK, mrows) rows of N words, region t·P + pi for ciphertext t and
// prime pi.  The entry reads each limb once and, for every prime, reduces
// it, runs the forward's first stages on it in registers and writes it into
// row k of the region; the rest of the forward NTT transforms the KK rows of
// every region at once; the VMP overwrites them in place with the mrows
// output rows (a thread reads all KK inputs of its coefficient before it
// writes that coefficient's outputs); the inverse NTT transforms those; the
// exit lifts them (lift_add_normalize, rows stride R).  The NTT keeps values
// lazily in [0, 4p) (forward) or [0, 2p) (inverse), p < 2^30, with Shoup
// twiddles (w, ⌊w·2^32/p⌋) and 32-bit products, in two passes with a
// barrier after each: the stages of bits log N − 1 .. 8 in registers, eight
// points per thread, then those of bits 7 .. 0 inside one warp, 256 points
// per warp in three register passes of eight points per lane, the chunk
// transposed through its own words between them.  So a transform takes 2
// barriers instead of log N, and every butterfly runs in registers.
// Residues are canonical wherever another stage reads them.  8 ≤ log N ≤ 11.

// The compile-time shape of an instance; 0 leaves a dimension to the runtime.
template <int LOGN_, int KK_, int MR_, int P_, int PS_, int RS_>
struct BfShape {
  static constexpr int LOGN = LOGN_, KK = KK_, MR = MR_, P = P_, PS = PS_, RS = RS_;
};

template <int V>
__device__ __forceinline__ int pick(int rt) {
  return V ? V : rt;
}

// The lazy design's constants of one prime: PrimeK's, p − 2^64 mod p,
// Shoup's quotients ⌊c32·2^32/p⌋ and ⌊2^32/p⌋, and the terms a lazy u64 sum
// of products of canonical residues may take between two folds:
// F·(p − 1)² ≤ 2^63, so that a folded sum (< 2^62 + 2^32) plus F terms stays
// below 2^64 (8 for p near 2^30, 128 for p < 2^28).
struct PrimeL : PrimeK {
  uint32_t cneg, c32q, oneq, fold;
  PrimeL() = default;
  __device__ PrimeL(const int64_t* __restrict__ consts, int pi) : PrimeK(consts, pi) {
    cneg = p - (uint32_t)((uint64_t)c32 * c32 % p);
    c32q = (uint32_t)(((uint64_t)c32 << 32) / p);
    oneq = (uint32_t)((1ull << 32) / p);
    const uint64_t f = (1ull << 63) / ((uint64_t)(p - 1) * (p - 1));
    fold = (uint32_t)(f < (1u << 20) ? f : (1u << 20));
  }
};

// Canonical x mod p (hal/ntt.py's floor `%`) of any int64 x, INT64_MIN
// included, in 32-bit products: x = hi·2^32 + lo (hi = x >> 32) ≡
// (hi mod 2^32)·(2^32 mod p) + lo − [x < 0]·(2^64 mod p); both products by
// Shoup (each brought to [0, p)), the sign by + (p − 2^64 mod p), the sum
// below 3p.
__device__ __forceinline__ uint32_t mod_p_i64(int64_t x, const PrimeL& k) {
  const uint32_t hi = (uint32_t)((uint64_t)x >> 32), lo = (uint32_t)x;
  uint32_t a = hi * k.c32 - __umulhi(hi, k.c32q) * k.p;     // [0, 2p)
  uint32_t b = lo - __umulhi(lo, k.oneq) * k.p;             // [0, 2p)
  a = min(a, a - k.p);
  b = min(b, b - k.p);
  uint32_t v = a + b + (x < 0 ? k.cneg : 0u);
  v = min(v, v - 2 * k.p);
  return min(v, v - k.p);
}

// Shoup's product a·w mod p in [0, 2p) for any a < 2^32, w = (w, ⌊w·2^32/p⌋), w < p.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint2 w, uint32_t p) {
  return a * w.x - __umulhi(a, w.y) * p;
}

// Canonical a·w mod p by Shoup's product with the JAX package's 30-bit
// quotient wq = ⌊w·2^30/p⌋ (its shoup_mul_i32_lazy): q = ⌊a·wq/2^30⌋ from a
// 64-bit product, r = a·w − q·p in [0, 2p) for a < 2^30 (Harvey), then one
// conditional subtract.  a, w < p.
__device__ __forceinline__ uint32_t shoup_mul30(uint32_t a, uint32_t w, uint32_t wq, uint32_t p) {
  const uint32_t q = (uint32_t)(((uint64_t)a * wq) >> 30);
  const uint32_t r = a * w - q * p;
  return min(r, r - p);
}

// Lazy Cooley–Tukey butterfly, X, Y in [0, 4p) → [0, 4p): X ← x + w·Y,
// Y ← x − w·Y + 2p, x = X reduced to [0, 2p), w·Y in [0, 2p).
__device__ __forceinline__ void fwd_bfly(uint32_t& X, uint32_t& Y, uint2 w, uint32_t p) {
  const uint32_t p2 = 2 * p;
  const uint32_t x = X >= p2 ? X - p2 : X;
  const uint32_t t = shoup_mul(Y, w, p);
  X = x + t;
  Y = x - t + p2;
}

// Lazy Gentleman–Sande butterfly, X, Y in [0, 2p) → [0, 2p): X ← X + Y,
// Y ← (X − Y)·w.
__device__ __forceinline__ void inv_bfly(uint32_t& X, uint32_t& Y, uint2 w, uint32_t p) {
  const uint32_t p2 = 2 * p;
  const uint32_t s = X + Y;
  Y = shoup_mul(X - Y + p2, w, p);
  X = s >= p2 ? s - p2 : s;
}

// Row rr of a transform over T·P regions of `rows` rows each: its words and prime.
__device__ __forceinline__ uint32_t* lazy_row(uint32_t* buf, int rr, int rows, int R, int P,
                                              int logn, int& pi) {
  const int region = rr / rows;
  pi = region % P;
  return buf + ((size_t)(region * R + rr - region * rows) << logn);
}

// The inverse's stages of bits 8 .. log N − 1 (K = log N − 8 of them; its
// last pass) of every row, one thread per (row, low byte l), the 2^K points
// m·256 + l in registers, ending canonical; the twiddles are the same for
// every thread of a row (the forward's run in lazy_entry_fwd_hi).  Ends
// with a barrier.
template <int K>
__device__ __forceinline__ void ntt_inv_hi(uint32_t* buf, int nrows, int rows, int R, int P,
                                           int logn, const uint2* __restrict__ tw,
                                           const PrimeL* lk) {
  constexpr int M = 1 << K;
  const int n = 1 << logn;
  for (int g = threadIdx.x; g < (nrows << 8); g += blockDim.x) {
    int pi;
    uint32_t* x = lazy_row(buf, g >> 8, rows, R, P, logn, pi) + (g & 255);
    const uint2* twp = tw + (size_t)pi * n;
    const uint32_t p = lk[pi].p;
    uint32_t v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = x[m << 8];
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      const int kb = K - 1 - s;
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (!(j >> kb & 1))
          inv_bfly(v[j], v[j | 1 << kb], __ldg(twp + (1 << s) + (j >> (kb + 1))), p);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) x[m << 8] = v[m] >= p ? v[m] - p : v[m];
  }
  __syncthreads();
}

// Word e of a 256-point chunk in the swizzled order of ntt_pass_lo's
// transposes: bits 4..2 XOR bits 7..5.
__device__ __forceinline__ int chunk_sw(int e) { return e ^ ((e >> 5 & 7) << 2); }

// The stages of bits 7 .. 0 of every row, one warp per 256-point chunk c,
// in three register passes with the chunk transposed between them through
// its own words (swizzled, chunk_sw, so that no two lanes of a load or store
// meet in a bank):
//   A: lane = bits 4..0, registers j = bits 7..5 (points 32·j + lane);
//   B: lane = (bits 7..5, bits 1..0), registers m = bits 4..2;
//   C: lane = bits 6..2, registers (bit 7, bits 1..0): two 16-byte groups.
// Forward: A, B, C, canonical at the end.  INV: C, B, A (the inverse's first
// pass), canonical where `last`.  Ends with a barrier.
template <bool INV>
__device__ __forceinline__ void ntt_pass_lo(uint32_t* buf, int nrows, int rows, int R, int P,
                                            int logn, const uint2* __restrict__ tw,
                                            const PrimeL* lk, bool last) {
  const int n = 1 << logn, lane = threadIdx.x & 31, hb = logn - 8;
  const int h3 = lane >> 2, l2 = lane & 3;           // pass B's lane bits
  for (int q = threadIdx.x >> 5; q < (nrows << hb); q += blockDim.x >> 5) {
    const int c = q & ((1 << hb) - 1);
    int pi;
    uint32_t* x = lazy_row(buf, q >> hb, rows, R, P, logn, pi) + (c << 8);
    const uint2* twp = tw + (size_t)pi * n;
    const uint32_t p = lk[pi].p, p2 = 2 * p;
    uint32_t v[8];
    // pass A: bits 7, 6, 5 (stages hb .. hb + 2)
    auto pass_a = [&] {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int st = INV ? 2 - t : t, kb = 2 - st;    // stage hb + st, bit 7 − st
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >> kb & 1) continue;
          const uint2 w = __ldg(twp + (1 << (hb + st)) + (c << st) + (j >> (kb + 1)));
          if (INV) inv_bfly(v[j], v[j | 1 << kb], w, p);
          else fwd_bfly(v[j], v[j | 1 << kb], w, p);
        }
      }
    };
    // pass B: bits 4, 3, 2 (stages hb + 3 .. hb + 5)
    auto pass_b = [&] {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int u = INV ? 2 - t : t, kb = 2 - u;      // stage hb + 3 + u, bit 4 − u
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (m >> kb & 1) continue;
          const uint2 w = __ldg(twp + (1 << (hb + 3 + u)) + (c << (3 + u)) + (h3 << u) +
                                (m >> (kb + 1)));
          if (INV) inv_bfly(v[m], v[m | 1 << kb], w, p);
          else fwd_bfly(v[m], v[m | 1 << kb], w, p);
        }
      }
    };
    // pass C: bits 1, 0 (stages log N − 2, log N − 1) in each group g = bit 7
    auto pass_c = [&] {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int b = INV ? t : 1 - t;                  // bit b: stage log N − 1 − b
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r >> b & 1) continue;
            const int e = g << 7 | lane << 2 | r;
            const uint2 w = __ldg(twp + (1 << (logn - 1 - b)) + (c << (7 - b)) + (e >> (b + 1)));
            uint32_t& lo = v[g * 4 + r];
            uint32_t& hi = v[g * 4 + (r | 1 << b)];
            if (INV) inv_bfly(lo, hi, w, p);
            else fwd_bfly(lo, hi, w, p);
          }
      }
    };
    // the words of pass A's point j, pass B's m, pass C's group g: natural
    // order, or swizzled where `sw` (pass B's always)
    auto at = [&](int e, bool sw) { return x + (sw ? chunk_sw(e) : e); };
    auto a_load = [&](bool sw) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = *at(j << 5 | lane, sw);
    };
    auto a_store = [&](bool sw) {
#pragma unroll
      for (int j = 0; j < 8; ++j) *at(j << 5 | lane, sw) = v[j];
    };
    auto b_addr = [&](int m) { return at(h3 << 5 | m << 2 | l2, true); };
    auto c_load = [&](bool sw) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(at(g << 7 | lane << 2, sw));
        v[4 * g] = w4.x, v[4 * g + 1] = w4.y, v[4 * g + 2] = w4.z, v[4 * g + 3] = w4.w;
      }
    };
    auto c_store = [&](bool sw) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<uint4*>(at(g << 7 | lane << 2, sw)) =
            uint4{v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]};
    };
    if (!INV) {
      a_load(false);
      pass_a();
      __syncwarp();
      a_store(true);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = *b_addr(m);
      pass_b();
#pragma unroll
      for (int m = 0; m < 8; ++m) *b_addr(m) = v[m];
      __syncwarp();
      c_load(true);
      pass_c();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = v[j] >= p2 ? v[j] - p2 : v[j];
        v[j] = v[j] >= p ? v[j] - p : v[j];
      }
      __syncwarp();
      c_store(false);
    } else {
      c_load(false);
      pass_c();
      __syncwarp();
      c_store(true);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = *b_addr(m);
      pass_b();
#pragma unroll
      for (int m = 0; m < 8; ++m) *b_addr(m) = v[m];
      __syncwarp();
      a_load(true);
      pass_a();
      if (last) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = v[j] >= p ? v[j] - p : v[j];
      }
      __syncwarp();
      a_store(false);
    }
  }
  __syncthreads();
}

// Inverse NTT without the N^{-1} scale (ntt_inv_rows) of rows 0..rows−1 of
// each of the `regions` regions, canonical in and out; tw: the inverse Shoup
// twiddles [P][N] (uint2).  Ends with a barrier.
__device__ __forceinline__ void lazy_ntt_inv(uint32_t* buf, int regions, int rows, int R, int P,
                                             int logn, const uint2* __restrict__ tw,
                                             const PrimeL* lk) {
  const int nrows = regions * rows;
  ntt_pass_lo<true>(buf, nrows, rows, R, P, logn, tw, lk, logn == 8);
  switch (logn - 8) {
    case 1: ntt_inv_hi<1>(buf, nrows, rows, R, P, logn, tw, lk); break;
    case 2: ntt_inv_hi<2>(buf, nrows, rows, R, P, logn, tw, lk); break;
    case 3: ntt_inv_hi<3>(buf, nrows, rows, R, P, logn, tw, lk); break;
    default: break;
  }
}

// Entry and the forward's stages of bits log N − 1 .. 8 (K = log N − 8 of
// them): one thread per (ciphertext t < T, input row k < kk, low byte l)
// reads the 2^K limbs m·256 + l of row k (a: T consecutive [ci][size_a][n]
// int64 ciphertexts, row k = column·rmax + limb at word rowoff[k]; those at
// t ≥ nt read as 0) once, and for every prime reduces them (mod_p_i64),
// runs the K stages in registers (the inverse of ntt_inv_hi) and writes row k of
// region (t, pi).  Ends with a barrier.
template <int K>
__device__ __forceinline__ void lazy_entry_fwd_hi(uint32_t* buf, const int64_t* __restrict__ a,
                                                  const int* rowoff, int T, int nt, int ci,
                                                  int size_a, int kk, int P, int R, int logn,
                                                  const uint2* __restrict__ tw,
                                                  const PrimeL* lk) {
  constexpr int M = 1 << K;
  const int n = 1 << logn;
  for (int g = threadIdx.x; g < ((T * kk) << 8); g += blockDim.x) {
    const int tk = g >> 8, l = g & 255, t = tk / kk, k = tk - t * kk;
    const int64_t* src = a + (int64_t)t * ci * size_a * n + rowoff[k] + l;
    int64_t x[M];
#pragma unroll
    for (int m = 0; m < M; ++m) x[m] = t < nt ? src[m << 8] : 0;
    for (int pi = 0; pi < P; ++pi) {
      const PrimeL& kp = lk[pi];
      const uint2* twp = tw + (size_t)pi * n;
      uint32_t v[M];
#pragma unroll
      for (int m = 0; m < M; ++m) v[m] = mod_p_i64(x[m], kp);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int kb = K - 1 - s;
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (!(j >> kb & 1))
            fwd_bfly(v[j], v[j | 1 << kb], __ldg(twp + (1 << s) + (j >> (kb + 1))), kp.p);
      }
      uint32_t* dst = buf + ((size_t)((t * P + pi) * R + k) << logn) + l;
#pragma unroll
      for (int m = 0; m < M; ++m) dst[m << 8] = v[m];
    }
  }
  __syncthreads();
}

// lazy_entry_fwd_hi for K = log N − 8.
__device__ __forceinline__ void lazy_entry_fwd(uint32_t* buf, const int64_t* __restrict__ a,
                                               const int* rowoff, int T, int nt, int ci,
                                               int size_a, int kk, int P, int R, int logn,
                                               const uint2* __restrict__ tw, const PrimeL* lk) {
  switch (logn - 8) {
    case 0: lazy_entry_fwd_hi<0>(buf, a, rowoff, T, nt, ci, size_a, kk, P, R, logn, tw, lk); break;
    case 1: lazy_entry_fwd_hi<1>(buf, a, rowoff, T, nt, ci, size_a, kk, P, R, logn, tw, lk); break;
    case 2: lazy_entry_fwd_hi<2>(buf, a, rowoff, T, nt, ci, size_a, kk, P, R, logn, tw, lk); break;
    default: lazy_entry_fwd_hi<3>(buf, a, rowoff, T, nt, ci, size_a, kk, P, R, logn, tw, lk); break;
  }
}

// rowoff[k] for k < kk: the word offset of input row k = column·rmax + limb
// in one [ci][size_a][n] ciphertext.  Written by the first kk threads; the
// caller synchronises before its first use.
__device__ __forceinline__ void lazy_row_offsets(int* rowoff, int kk, int rmax, int size_a,
                                                 int logn) {
  if (threadIdx.x < kk) {
    const int col = threadIdx.x / rmax;
    rowoff[threadIdx.x] = (col * size_a + threadIdx.x - col * rmax) << logn;
  }
}

// The VMP of every prime, in place: for each ciphertext t < T, output row m
// < mrows of region (t, pi) ← Σ_i Σ_k x'_{t,i,k}·pm_i[k][m0 + m]·R^{-1},
// x'_{t,i,k} = x_{t,k}·X_{t,i}·R^{-1} (BSTEP: X_{t,i} the Montgomery
// NTT(X^a − 1) row xrow[t·block + i] of xpm1 [2N][P][N], block key elements
// pm [block][P][kk][mdim][N]) or x_{t,k} (the product: pm [P][kk][mdim][N]),
// which is fused_product.cu's / br_block_step.cu's canonical value, so the
// same bits.  SHOUP (with BSTEP): xpm1 is the two-plane table [2N][2][P][N]
// of the plain NTT(X^a − 1) and its quotients ⌊w·2^30/p⌋, and x'_{t,i,k} =
// x_{t,k}·w mod p is Shoup's product (shoup_mul30), the same canonical value.
// One thread per (prime, coefficient) holds its T·kk inputs
// (MK ≥ kk) and, for MC output rows at a time, T·MC sums in registers, so
// each key word is read once per block and each x-power product made once
// per (t, i, k) and group of MC rows; the sums run lazily in u64 (folded
// every PrimeL::fold terms) and are reduced once (reduce_redc).  The caller
// ends it with a barrier.
template <int T, int MK, int MC, bool BSTEP, bool SHOUP = false>
__device__ __forceinline__ void lazy_vmp(uint32_t* buf, const int32_t* __restrict__ pm,
                                         const int32_t* __restrict__ xpm1, const int* xrow,
                                         int block, int kk, int mdim, int m0, int mrows, int P,
                                         int R, int logn, const PrimeL* lk) {
  constexpr bool FOLDS = BSTEP || MK > 8;   // PrimeL::fold ≥ 8: 8 terms never need one
  const int n = 1 << logn;
  for (int it = threadIdx.x; it < (P << logn); it += blockDim.x) {
    const int pi = it >> logn, coef = it & (n - 1);
    const PrimeL k = lk[pi];
    uint32_t x[T][MK];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int q = 0; q < MK; ++q)
        if (q < kk) x[t][q] = buf[((size_t)((t * P + pi) * R + q) << logn) + coef];
#pragma unroll 1
    for (int mc = 0; mc < mrows; mc += MC) {
      uint64_t acc[T][MC];
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int m = 0; m < MC; ++m) acc[t][m] = 0;
      uint32_t terms = 0;
#pragma unroll 1
      for (int i = 0; i < (BSTEP ? block : 1); ++i) {
        const int32_t* pmi =
            pm + ((size_t)(BSTEP ? i * P + pi : pi) * kk * mdim + m0 + mc) * n + coef;
        uint32_t xw[T], xq[T];
        if (BSTEP && SHOUP) {
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int32_t* row = xpm1 + ((size_t)xrow[t * block + i] * 2 * P + pi) * n + coef;
            xw[t] = (uint32_t)__ldg(row);
            xq[t] = (uint32_t)__ldg(row + (size_t)P * n);
          }
        } else if (BSTEP) {
#pragma unroll
          for (int t = 0; t < T; ++t)
            xw[t] = (uint32_t)__ldg(xpm1 + ((size_t)xrow[t * block + i] * P + pi) * n + coef);
        }
#pragma unroll
        for (int q = 0; q < MK; ++q) {
          if (q >= kk) break;
          uint32_t xv[T];
#pragma unroll
          for (int t = 0; t < T; ++t)
            xv[t] = !BSTEP ? x[t][q]
                    : SHOUP ? shoup_mul30(x[t][q], xw[t], xq[t], k.p)
                            : mont_mul(x[t][q], xw[t], k.p, k.qinv);
#pragma unroll
          for (int m = 0; m < MC; ++m) {
            if (mc + m < mrows) {
              const uint64_t w = (uint32_t)__ldg(pmi + (size_t)(q * mdim + m) * n);
#pragma unroll
              for (int t = 0; t < T; ++t) acc[t][m] += xv[t] * w;
            }
          }
          if (FOLDS && ++terms == k.fold) {
            terms = 0;
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
              for (int m = 0; m < MC; ++m) acc[t][m] = fold32(acc[t][m], k.c32);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int m = 0; m < MC; ++m)
          if (mc + m < mrows)
            buf[((size_t)((t * P + pi) * R + mc + m) << logn) + coef] = reduce_redc(acc[t][m], k);
    }
  }
}

}  // namespace poulpy
