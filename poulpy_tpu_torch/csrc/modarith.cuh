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
// high 64 bits (the 64-bit lift reads only the low halves).
constexpr int CONSTS_PER_PRIME = 10;
enum {
  C_P = 0, C_QINV = 1, C_NINV = 2, C_GINV = 3, C_HALF = 4, C_WEIGHT = 5, C_MOD = 6,
  C_WEIGHT_HI = 7, C_MOD_HI = 8
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

}  // namespace poulpy
