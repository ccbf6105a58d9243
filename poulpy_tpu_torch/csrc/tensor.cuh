// The lazy design of the rank-1 tensor kernels (tensor_product.cu, the 64-bit
// lift; wide_tensor.cu, the 128-bit lift).
//
// A block takes one task: a ciphertext and one column pair (pairs 1: the
// cross pair a0·b1 + a1·b0 first, then a0·b0 and a1·b1 — the cross pair
// reads both columns and does twice the work, so the blocks the card
// schedules last are light), or all three pairs (pairs 3, from one
// transform of each operand row).  Its shared memory holds P' regions of R =
// max(in_rows, out_rows) rows of N words, one per prime of a pass: in_rows
// the operand rows the task reads (a's columns, then b's), out_rows its
// npairs·conv convolution rows, written in place.  P' = min(P, srows / R)
// primes run at once; where P' < P the primes go in passes, and the rows of
// every pass but the last go to a global scratch slot [P][out_rows][N] of
// the task until the lift (backends/fused.py tensor_lazy_layout chooses the
// pairs per task and the shared rows by formula).
//
// Per pass: the entry reads each limb once for the pass's primes
// (modarith.cuh lazy_entry_fwd: mod_p_i64 in 32-bit Shoup products, the
// forward's stages of bits log N − 1 .. 8 in registers), then the forward's
// low eight bits (ntt_pass_lo), canonical.  The convolution: one thread per
// (prime, coefficient) sums each output of its column lazily in u64 (a fold
// every 8 terms, modarith.cuh fold32), reduces it once to the canonical
// Σ a·b mod p (reduce_canon: two Montgomery steps and a product by R³ that
// cancels their R^{-1}), and writes the outputs in place after reading
// every input.  The inverse: lazy_ntt_inv (two barriers).  The lift: one
// thread per coefficient, N^{-1} and Garner on the constants in shared
// memory (modarith.cuh exit_lift / exit_lift_wide), then the quadratic
// pair's normalization to dnum digits (d) and the linear pairs' limbs (lin:
// raw 64-bit limbs, or the 128-bit values normalized to lin_size limbs with
// the landing offset).  A shape known to the compiler (TsShape) unrolls the
// convolution and keeps the lift's arrays in registers.  8 ≤ log N ≤ 11.
#pragma once

#include <type_traits>

#include "modarith.cuh"

namespace poulpy {

constexpr int TENSOR_THREADS = 512;

// The compile-time shape of an instance (log N, P, size_a, size_b, conv,
// dnum, lin_size, pairs per task, kr, ka); 0 leaves a dimension to the
// runtime.  Known bases make the normalization's windows constant shifts
// (with run-time bases the relinearize shape's lift spills).
template <int LOGN_, int P_, int SA_, int SB_, int CONV_, int DNUM_, int LIN_, int PAIRS_,
          int KR_, int KA_>
struct TsShape {
  static constexpr int LOGN = LOGN_, P = P_, SA = SA_, SB = SB_, CONV = CONV_, DNUM = DNUM_,
                       LIN = LIN_, PAIRS = PAIRS_, KR = KR_, KA = KA_;
};
using TsRuntime = TsShape<0, 0, 0, 0, 0, 0, 0, 0, 0, 0>;

struct TensorArgs {
  const int64_t* a;
  const int64_t* b;
  int64_t* d;
  int64_t* lin;
  const uint2* tw;
  const int64_t* consts;
  uint32_t* scratch;
  long long* stamps;
  int B, size_a, size_b, conv, dnum, lin_size, kr, ka, offset, P, logn, pairs, srows;
};

template <class S>
bool is_tensor_shape(const TensorArgs& g) {
  return g.logn == S::LOGN && g.P == S::P && g.size_a == S::SA && g.size_b == S::SB &&
         g.conv == S::CONV && g.dnum == S::DNUM && g.lin_size == S::LIN &&
         (S::PAIRS == 0 || g.pairs == S::PAIRS) && g.kr == S::KR && g.ka == S::KA;
}

// Task `task` of a launch: its ciphertext, its pair (−1: all three), the
// columns it reads (ncols from col0) and its pairs.
struct TensorTask {
  int64_t ct;
  int pair, ncols, col0, npairs;
};

__device__ __forceinline__ TensorTask tensor_task(int task, int B, int pairs) {
  if (pairs == 3) return {task, -1, 2, 0, 3};
  if (task < B) return {task, 1, 2, 0, 1};
  const int t = task - B, pair = (t & 1) * 2;
  return {t >> 1, pair, 1, pair >> 1, 1};
}

// Canonical x mod p of any x < 2^64: reduce_redc's two Montgomery steps
// (x·2^{-60}), then the product by r3 = 2^90 mod p (Montgomery: · 2^60).
__device__ __forceinline__ uint32_t reduce_canon(uint64_t x, const PrimeK& k, uint32_t r3) {
  const uint64_t u = redc_step(redc_step(fold32(x, k.c32), k.p, k.qinv), k.p, k.qinv);
  const uint32_t v = (uint32_t)(u >= k.p ? u - k.p : u);
  return mont_mul(v, r3, k.p, k.qinv);
}

// The convolution of one prime and coefficient, in place: x is the region's
// word of that coefficient in row 0 (rows N words apart), holding a's ncols
// columns of sa limbs, then b's of sb limbs; output q·conv + k of the task's
// pair q is Σ_{l + j = k} of the pair's products, canonical.  Every input is
// read before any output is written.
template <class S>
__device__ __forceinline__ void tensor_conv(uint32_t* x, int logn, int sa, int sb, int conv,
                                            const TensorTask& tk, const PrimeK& k, uint32_t r3) {
  constexpr int CM = S::CONV ? S::CONV : MAX_LIMBS, QM = S::PAIRS ? S::PAIRS : 3;
  const int bo = tk.ncols * sa;
  auto at = [&](int row) { return (uint64_t)x[(size_t)row << logn]; };
  uint32_t res[QM][CM];
#pragma unroll
  for (int q = 0; q < QM; ++q) {
    if (q >= tk.npairs) break;
    const int gp = tk.npairs == 3 ? q : tk.pair;
    const int c = gp == 2 && tk.ncols == 2 ? 1 : 0;      // the column a single product reads
#pragma unroll
    for (int kk = 0; kk < CM; ++kk) {
      if (kk >= conv) break;
      uint64_t acc = 0;
      int terms = 0;
#pragma unroll
      for (int l = max(0, kk - sb + 1); l < min(sa, kk + 1); ++l) {
        const int j = kk - l;
        if (gp == 1) {
          acc += at(l) * at(bo + sb + j) + at(sa + l) * at(bo + j);
          terms += 2;
        } else {
          acc += at(c * sa + l) * at(bo + c * sb + j);
          ++terms;
        }
        if (terms > 6) {          // at most 8 products of canonical residues between folds
          acc = fold32(acc, k.c32);
          terms = 0;
        }
      }
      res[q][kk] = reduce_canon(acc, k, r3);
    }
  }
#pragma unroll
  for (int q = 0; q < QM; ++q) {
    if (q >= tk.npairs) break;
#pragma unroll
    for (int kk = 0; kk < CM; ++kk) {
      if (kk >= conv) break;
      x[(size_t)(q * conv + kk) << logn] = res[q][kk];
    }
  }
}

// The lazy design's kernel (WIDE: the 128-bit lift of wide_tensor.cu, else
// tensor_product.cu's 64-bit one).  TIMED: the stage clock, stamps
// [blocks][TS_NSTAGES].
template <class S, bool WIDE, bool TIMED>
__global__ void __launch_bounds__(TENSOR_THREADS, 1) lazy_tensor_kernel(const TensorArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  __shared__ uint32_t r3[MAX_PRIMES];
  __shared__ int rowoff[2 * MAX_LIMBS];
  __shared__ ExitPrimes kp;
  StageClock<TIMED, TS_NSTAGES> clk;
  constexpr int PM = S::P ? S::P : MAX_PRIMES;
  const int logn = pick<S::LOGN>(g.logn), n = 1 << logn;
  const int P = pick<S::P>(g.P), sa = pick<S::SA>(g.size_a), sb = pick<S::SB>(g.size_b);
  const int conv = pick<S::CONV>(g.conv), kr = pick<S::KR>(g.kr), ka = pick<S::KA>(g.ka);
  if (threadIdx.x < P) {
    const PrimeL k(g.consts, threadIdx.x);
    lk[threadIdx.x] = k;
    r3[threadIdx.x] = mont_mul(k.r2, k.r2, k.p, k.qinv);
  }
  if (threadIdx.x < 2 * MAX_LIMBS) rowoff[threadIdx.x] = threadIdx.x << logn;
  load_exit_primes(kp, g.consts, P);

  const TensorTask tk = tensor_task(blockIdx.x, g.B, g.pairs);
  const int in_rows = tk.ncols * (sa + sb), out_rows = tk.npairs * conv;
  const int R = max(in_rows, out_rows), PP = min(P, g.srows / R);
  const int last_p0 = (P - 1) / PP * PP;
  uint32_t* scr = g.scratch + ((size_t)blockIdx.x * P * out_rows << logn);
  const int64_t* asrc = g.a + ((tk.ct * 2 + tk.col0) * sa << logn);
  const int64_t* bsrc = g.b + ((tk.ct * 2 + tk.col0) * sb << logn);
  uint32_t* brows = smem + ((size_t)tk.ncols * sa << logn);

  for (int p0 = 0; p0 < P; p0 += PP) {
    const int pp = min(PP, P - p0);
    const uint2* twf = g.tw + ((size_t)p0 << logn);
    lazy_entry_fwd(smem, asrc, rowoff, 1, 1, 0, 0, tk.ncols * sa, pp, R, logn, twf, lk + p0);
    lazy_entry_fwd(brows, bsrc, rowoff, 1, 1, 0, 0, tk.ncols * sb, pp, R, logn, twf, lk + p0);
    ntt_pass_lo<false>(smem, pp * in_rows, in_rows, R, pp, logn, twf, lk + p0, true);
    clk.mark(TS_ENTRY_FWD);
    for (int it = threadIdx.x; it < (pp << logn); it += TENSOR_THREADS) {
      const int pi = it >> logn;
      tensor_conv<S>(smem + ((size_t)pi * R << logn) + (it & (n - 1)), logn, sa, sb, conv, tk,
                     lk[p0 + pi], r3[p0 + pi]);
    }
    __syncthreads();
    clk.mark(TS_CONV);
    lazy_ntt_inv(smem, pp, out_rows, R, pp, logn, g.tw + ((size_t)(P + p0) << logn), lk + p0);
    if (p0 != last_p0) {                      // this pass's rows wait in the scratch slot
      for (int i = threadIdx.x * 4; i < (pp * out_rows << logn); i += TENSOR_THREADS * 4) {
        const int row = i >> logn, pi = row / out_rows, r = row - pi * out_rows;
        const int c = i & (n - 1);
        *reinterpret_cast<uint4*>(scr + (((size_t)(p0 + pi) * out_rows + r) << logn) + c) =
            *reinterpret_cast<const uint4*>(smem + (((size_t)pi * R + r) << logn) + c);
      }
      __syncthreads();
    }
    clk.mark(TS_INV);
  }

  // the canonical inverse-NTT'd residue of prime pi, output row r, coefficient coef
  auto residue = [&](int pi, int r, int coef) {
    return pi >= last_p0 ? smem[(((size_t)(pi - last_p0) * R + r) << logn) + coef]
                         : scr[(((size_t)pi * out_rows + r) << logn) + coef];
  };
  for (int coef = threadIdx.x; coef < n; coef += TENSOR_THREADS) {
    for (int q = 0; q < tk.npairs; ++q) {
      const int gp = tk.npairs == 3 ? q : tk.pair;
      int64_t* dst = gp == 2 ? g.d + (tk.ct * g.dnum << logn) + coef
                             : g.lin + ((tk.ct * 2 + gp) * g.lin_size << logn) + coef;
      auto lift_row = [&](int j, uint32_t (&r)[PM]) {
#pragma unroll
        for (int pi = 0; pi < PM; ++pi)
          if (pi < P) r[pi] = mont_mul(residue(pi, q * conv + j, coef), kp.ninv[pi], kp.p[pi],
                                       kp.qinv[pi]);
      };
      if constexpr (S::CONV != 0 && !WIDE) {
        if (gp != 2) {                        // the linear pairs' raw limbs
#pragma unroll
          for (int j = 0; j < S::CONV; ++j) {
            uint32_t r[PM];
            lift_row(j, r);
            dst[(size_t)j << logn] = exit_lift<S::P>(r, P, kp);
          }
          continue;
        }
      }
      if constexpr (S::CONV != 0) {
        using Big = typename std::conditional<WIDE, __int128, int64_t>::type;
        Big big[S::CONV];
#pragma unroll
        for (int j = 0; j < S::CONV; ++j) {
          uint32_t r[PM];
          lift_row(j, r);
          if constexpr (WIDE) big[j] = exit_lift_wide<S::P>(r, P, kp);
          else big[j] = exit_lift<S::P>(r, P, kp);
        }
        if constexpr (WIDE) {
          if (gp == 2) {
            int64_t res[S::DNUM];
            normalize_full_wide_t<S::CONV, S::DNUM>(big, res, kr, ka, g.offset);
#pragma unroll
            for (int i = 0; i < S::DNUM; ++i) dst[(size_t)i << logn] = res[i];
          } else {
            int64_t res[S::LIN];
            normalize_full_wide_t<S::CONV, S::LIN>(big, res, ka, ka, g.offset);
#pragma unroll
            for (int i = 0; i < S::LIN; ++i) dst[(size_t)i << logn] = res[i];
          }
        } else {
          int64_t res[S::DNUM];
          normalize_full_t<S::CONV, S::DNUM>(big, res, kr, ka);
#pragma unroll
          for (int i = 0; i < S::DNUM; ++i) dst[(size_t)i << logn] = res[i];
        }
      } else {
        using Big = typename std::conditional<WIDE, __int128, int64_t>::type;
        Big big[MAX_LIMBS];
        for (int j = 0; j < conv; ++j) {
          uint32_t r[PM];
          lift_row(j, r);
          if constexpr (WIDE) big[j] = exit_lift_wide<0>(r, P, kp);
          else big[j] = exit_lift<0>(r, P, kp);
        }
        int64_t res[MAX_LIMBS];
        int rs = conv;
        if constexpr (WIDE) {
          rs = gp == 2 ? g.dnum : g.lin_size;
          normalize_full_wide(big, conv, res, rs, gp == 2 ? kr : ka, ka, g.offset);
        } else if (gp == 2) {
          rs = g.dnum;
          normalize_full(big, conv, res, rs, kr, ka);
        } else {
          for (int i = 0; i < conv; ++i) res[i] = big[i];
        }
        for (int i = 0; i < rs; ++i) dst[(size_t)i << logn] = res[i];
      }
    }
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(TS_LIFT);
  }
  clk.store(g.stamps);
}

// One launch of the lazy design: a block per task (pairs 3: B tasks, else
// 3·B, the cross pairs first), `smem` bytes of shared memory (srows rows).
template <class S, bool WIDE>
int launch_lazy_tensor(const TensorArgs& g, int smem, cudaStream_t stream) {
  const auto kernel = g.stamps != nullptr ? lazy_tensor_kernel<S, WIDE, true>
                                          : lazy_tensor_kernel<S, WIDE, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tasks = (unsigned)(g.pairs == 3 ? g.B : 3 * g.B);
  kernel<<<tasks, TENSOR_THREADS, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace poulpy
