// The fused pipeline in the sublane/lane-split layout, one launch for a batch:
//   the product  out = big_normalize(idft(vmp(dft(a), pm)) [+ small at column 0 | + small64])
//   the block step  acc <- normalize(acc + idft(sum_i NTT(X^{a_i} - 1) * (dft(acc) [x] BRK_i)))
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe with
// POULPY_TPU_SL=1 (pallas_fused.py:875-881; N % 128 == 0, N ≥ 128): every
// [..., N] operand seen as [..., N/128, 128], the transforms split into the
// stages across 128-wide rows (half ≥ 128: slice arithmetic) and the stages
// inside one 128-lane row (half < 128: lane rolls), the inverse running the
// lane stages first (_ntt_rows_sl, _intt_rows_sl, pallas_fused.py:382-576),
// with Montgomery twiddle butterflies (the layout turns the default Shoup
// ones off, pallas_fused.py:881).  The switch sits in _pipe_fn, so it covers
// every caller of that pallas_call: fused_glwe_product (the product, `small`,
// `small64`; caller keyswitching.py, external_product.py, operations.py) and
// fused_br_block_step at steps 1 under rot_mode 0, 1 and 2 (the kernel
// asserts `not sl` for a chain).  Plain twins: poulpy_tpu_torch/backends/
// fused_sl.py fused_glwe_product_sl_ref, fused_br_block_step_sl_ref (the
// plain pipeline with ntt_rows_sl / intt_rows_sl).
//
// The split on Hopper.  One warp owns one NTT row in its registers: lane l
// holds the N/32 points j = l + 32·r.  A stage whose butterfly half is ≥ 32
// (the TPU's sublane stages and its two widest lane stages) pairs two
// registers of the same lane: no barrier, no shuffle.  A stage whose half is
// < 32 pairs lane l with lane l ^ half of the same register through
// __shfl_xor_sync.  So a transform takes no block barrier at all; a row
// touches shared memory only between the transform and the VMP, where every
// thread needs every row of its coefficient.  Twiddles: the Montgomery ones
// of backends/ntt.py kernel_tables (tw [2][P][N]), canonical residues after
// every butterfly (modarith.cuh mont_mul, add_mod, sub_mod), as the JAX
// layout keeps them; a stage's twiddle is one word for a whole register
// where half ≥ 32.
//
// What bounds it on the H100: the modular arithmetic and the VMP's L2 reads
// of the key, as the other butterfly kernels (csrc/fused_product.cu,
// csrc/br_block_step.cu); not HBM.  A ciphertext moves 2·ci·size_a·N·8 bytes
// in and co·res_size·N·8 out against (KK + M)·P transforms of N points and
// block·KK·M·P·N multiply-adds.  This simple design keeps one ciphertext
// and group of cpb output columns per block, so its VMP and exit are the
// lazy design's (modarith.cuh lazy_vmp, lift_add_normalize) at T = 1, and a
// lane holds 64 residues at N 2048.  A transform takes one warp per row, so
// a block of 512 threads would leave most warps idle in the forward of a
// small KK: the wrapper gives a block 512 / b threads where the rows of b
// blocks fit in an SM's shared memory (b = 1, 2 or 4; at 128 registers a
// thread, 512 threads fill an SM's registers), so that b ciphertexts keep
// the SM's warps busy.
//
// Layout (backends/fused_sl.py sl_layout): P regions of R = max(KK, cpb·psize)
// rows of N words, region pi for prime pi, then (block step) the block's
// x-power rows xrow[block] = a_i & (2N − 1): 4·N·P·R + 4·block bytes.  Per
// block: each warp takes (prime, input row) pairs: it reads the row's limbs
// (int64, coalesced), reduces them mod p (mod_p_i64), runs the forward
// transform in registers and stores the row in its region; one barrier; the
// VMP in place, one thread per (prime, coefficient) (lazy_vmp: the product;
// rot_mode 2, the x-power by Montgomery on the input rows; rot_mode 1, by
// Shoup from the two-plane table; rot_mode 0, vmp_xpow_out below, the
// x-power on the output rows); one barrier; each warp takes (prime, output
// row) pairs through the inverse transform (without N^{-1}); one barrier;
// one thread per (column, coefficient) lifts, adds the body / small64 / the
// input accumulator and normalizes (lift_add_normalize).
// 7 ≤ log N ≤ 11; the wrapper refuses other N and rows past shared memory.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

struct SlArgs {
  const int64_t* a;         // [B][ci][size_a][N]
  const int32_t* pm;        // product [P][KK][M][N]; block step [block][P][KK][M][N]
  const int64_t* small;     // [B][s_size][N] or null
  const int64_t* small64;   // [B][co][s64][N] or null
  const int32_t* xpow;      // block step: [2N][P][N] Montgomery, or [2N][2][P][N] (rot_mode 1)
  const int64_t* amounts;   // block step: [B][block]
  int64_t* out;             // [B][co][res_size][N]
  const int32_t* tw;        // [2][P][N] Montgomery twiddles
  const int64_t* consts;
  int ci, size_a, rmax, co, psize, s_size, s64, res_size, kr, ka, cpb, P, block, rot_mode;
};

// Forward negacyclic NTT (ntt_fwd_rows' stages and twiddles) of one row held
// by a warp, v[r] = x[lane + 32·r], canonical in and out.  Stage s pairs
// points j and j + half (half = N >> (s + 1)) with the twiddle tw[2^s +
// (j >> (log N − s))].
template <int LOGN>
__device__ __forceinline__ void warp_ntt_fwd(uint32_t (&v)[(1 << LOGN) / 32],
                                             const int32_t* __restrict__ tw, uint32_t p,
                                             uint32_t qinv, int lane) {
  constexpr int NR = (1 << LOGN) / 32;
#pragma unroll
  for (int s = 0; s < LOGN; ++s) {
    const int hl = LOGN - 1 - s;                    // log2 half
    if (hl >= 5) {                                  // registers r and r + half/32 of the lane
      const int hr = hl - 5;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >> hr & 1) continue;
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + (r >> (hr + 1)));
        const uint32_t t = mont_mul(v[r | 1 << hr], w, p, qinv);
        const uint32_t a = v[r];
        v[r] = add_mod(a, t, p);
        v[r | 1 << hr] = sub_mod(a, t, p);
      }
    } else {                                        // lanes l and l ^ half, one register
      const bool hi = lane >> hl & 1;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t u = __shfl_xor_sync(FULL, v[r], 1 << hl);
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + ((32 * r + lane) >> (hl + 1)));
        const uint32_t t = mont_mul(hi ? v[r] : u, w, p, qinv);
        v[r] = hi ? sub_mod(u, t, p) : add_mod(v[r], t, p);
      }
    }
  }
}

// Inverse (Gentleman–Sande) of warp_ntt_fwd without the N^{-1} scale
// (ntt_inv_rows' stages), the lane stages (half < 32) first, canonical in
// and out.
template <int LOGN>
__device__ __forceinline__ void warp_ntt_inv(uint32_t (&v)[(1 << LOGN) / 32],
                                             const int32_t* __restrict__ tw, uint32_t p,
                                             uint32_t qinv, int lane) {
  constexpr int NR = (1 << LOGN) / 32;
#pragma unroll
  for (int s = LOGN - 1; s >= 0; --s) {
    const int hl = LOGN - 1 - s;
    if (hl >= 5) {
      const int hr = hl - 5;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >> hr & 1) continue;
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + (r >> (hr + 1)));
        const uint32_t a = v[r], b = v[r | 1 << hr];
        v[r] = add_mod(a, b, p);
        v[r | 1 << hr] = mont_mul(sub_mod(a, b, p), w, p, qinv);
      }
    } else {
      const bool hi = lane >> hl & 1;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t u = __shfl_xor_sync(FULL, v[r], 1 << hl);
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + ((32 * r + lane) >> (hl + 1)));
        v[r] = hi ? mont_mul(sub_mod(u, v[r], p), w, p, qinv) : add_mod(v[r], u, p);
      }
    }
  }
}

// Entry and forward transform of one row by the calling warp: the limbs
// src[j] (int64, any value) reduced mod p (mod_p_i64), warp_ntt_fwd, the
// residues stored to dst[j].  Not inlined: one copy per log N serves every
// instance, and its registers are allocated apart from the VMP's and the
// exit's.
template <int LOGN>
__device__ __noinline__ void sl_fwd_row(uint32_t* dst, const int64_t* __restrict__ src,
                                        const int32_t* __restrict__ tw, const PrimeL& k) {
  constexpr int NR = (1 << LOGN) / 32;
  const int lane = threadIdx.x & 31;
  uint32_t v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) v[r] = mod_p_i64(src[lane + 32 * r], k);
  warp_ntt_fwd<LOGN>(v, tw, k.p, k.qinv, lane);
#pragma unroll
  for (int r = 0; r < NR; ++r) dst[lane + 32 * r] = v[r];
}

// The inverse transform (warp_ntt_inv) of the row x in place, by the
// calling warp; not inlined, as sl_fwd_row.
template <int LOGN>
__device__ __noinline__ void sl_inv_row(uint32_t* x, const int32_t* __restrict__ tw, uint32_t p,
                                        uint32_t qinv) {
  constexpr int NR = (1 << LOGN) / 32;
  const int lane = threadIdx.x & 31;
  uint32_t v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) v[r] = x[lane + 32 * r];
  warp_ntt_inv<LOGN>(v, tw, p, qinv, lane);
#pragma unroll
  for (int r = 0; r < NR; ++r) x[lane + 32 * r] = v[r];
}

// The block step's VMP under rot_mode 0, in place: output row m of region pi
// ← Σ_i NTT(X^{a_i} − 1)·(Σ_k x_k·pm_i[k][m]·R^{-1})·R^{-1}, the x-power (the
// Montgomery table [2N][P][N]) on each key element's output row, as
// br_block_step.cu's parent design; one thread per (prime, coefficient)
// reads its KK inputs before it writes its outputs.  The caller ends it with
// a barrier.
__device__ __forceinline__ void vmp_xpow_out(uint32_t* buf, const int32_t* __restrict__ pm,
                                             const int32_t* __restrict__ xpm1, const int* xrow,
                                             int block, int kk, int mdim, int P, int R, int logn,
                                             const PrimeL* lk) {
  constexpr int MC = 8;
  const int n = 1 << logn;
  for (int it = threadIdx.x; it < (P << logn); it += blockDim.x) {
    const int pi = it >> logn, coef = it & (n - 1);
    const PrimeL k = lk[pi];
    uint32_t x[MAX_LIMBS];
#pragma unroll
    for (int q = 0; q < MAX_LIMBS; ++q)
      if (q < kk) x[q] = buf[((size_t)(pi * R + q) << logn) + coef];
#pragma unroll 1
    for (int mc = 0; mc < mdim; mc += MC) {
      uint32_t sum[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) sum[m] = 0;
#pragma unroll 1
      for (int i = 0; i < block; ++i) {
        const int32_t* pmi = pm + ((size_t)(i * P + pi) * kk * mdim + mc) * n + coef;
        const uint32_t w = (uint32_t)__ldg(xpm1 + ((size_t)xrow[i] * P + pi) * n + coef);
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          if (mc + m >= mdim) break;
          uint64_t dot = 0;
#pragma unroll
          for (int q = 0; q < MAX_LIMBS; ++q)
            if (q < kk)
              dot = mac_guard(dot, x[q], (uint32_t)__ldg(pmi + (size_t)(q * mdim + m) * n), k.p);
          sum[m] = add_mod(sum[m], mont_mul(reduce_redc(dot, k), w, k.p, k.qinv), k.p);
        }
      }
#pragma unroll
      for (int m = 0; m < MC; ++m)
        if (mc + m < mdim) buf[((size_t)(pi * R + mc + m) << logn) + coef] = sum[m];
    }
  }
}

// One ciphertext and group of cpb output columns per block (the grid is
// B·co/cpb blocks; the block step: cpb = co).  BSTEP: the block step
// (g.block key elements, the x-power by g.rot_mode, the input accumulator
// added at the exit, size_a limbs read at the aligned positions); else the
// product, with the body at column 0 or the small64 terms (the exit then
// lifts max(psize, s64) limbs).
template <int LOGN, bool BSTEP>
__global__ void __launch_bounds__(MAX_THREADS, 1) fused_sl_kernel(const SlArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  constexpr int N = 1 << LOGN;
  const int kk = g.ci * g.rmax, mrows = g.cpb * g.psize, mdim = g.co * g.psize;
  const int P = g.P, R = max(kk, mrows), groups = g.co / g.cpb;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * g.cpb;
  const int warp = threadIdx.x >> 5;
  int* xrow = (int*)(smem + ((size_t)P * R << LOGN));
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  if (BSTEP)
    for (int i = threadIdx.x; i < g.block; i += blockDim.x)
      xrow[i] = (int)(g.amounts[b * g.block + i] & (2 * N - 1));
  __syncthreads();
  const int64_t* ab = g.a + b * g.ci * g.size_a * N;

  // entry and forward transform: a warp per (prime, input row k = column·rmax + limb)
  for (int rr = warp; rr < P * kk; rr += blockDim.x >> 5) {
    const int pi = rr / kk, k = rr - pi * kk, col = k / g.rmax;
    sl_fwd_row<LOGN>(smem + ((size_t)(pi * R + k) << LOGN),
                     ab + ((int64_t)col * g.size_a + k - col * g.rmax) * N, g.tw + (size_t)pi * N,
                     lk[pi]);
  }
  __syncthreads();

  if (!BSTEP)
    lazy_vmp<1, MAX_LIMBS, 8, false>(smem, g.pm, nullptr, nullptr, 1, kk, mdim, c0 * g.psize,
                                     mrows, P, R, LOGN, lk);
  else if (g.rot_mode == 1)
    lazy_vmp<1, MAX_LIMBS, 8, true, true>(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, 0, mdim,
                                          P, R, LOGN, lk);
  else if (g.rot_mode == 2)
    lazy_vmp<1, MAX_LIMBS, 8, true>(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, 0, mdim, P, R,
                                    LOGN, lk);
  else
    vmp_xpow_out(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, P, R, LOGN, lk);
  __syncthreads();

  // inverse transform: a warp per (prime, output row)
  for (int rr = warp; rr < P * mrows; rr += blockDim.x >> 5) {
    const int pi = rr / mrows, m = rr - pi * mrows;
    sl_inv_row<LOGN>(smem + ((size_t)(pi * R + m) << LOGN), g.tw + (size_t)(P + pi) * N, lk[pi].p,
                     lk[pi].qinv);
  }
  __syncthreads();

  // exit: N^{-1}, Garner, the add, the normalization
  const int ext = g.small64 != nullptr && g.s64 > g.psize ? g.s64 : g.psize;
  for (int idx = threadIdx.x; idx < (g.cpb << LOGN); idx += blockDim.x) {
    const int col = idx >> LOGN, coef = idx & (N - 1);
    const int64_t oc = b * g.co + c0 + col;
    const int64_t* add = nullptr;
    int add_size = 0;
    if (BSTEP) {
      add = ab + (int64_t)col * g.size_a * N + coef;
      add_size = g.size_a < g.psize ? g.size_a : g.psize;
    } else if (g.small64 != nullptr) {
      add = g.small64 + oc * g.s64 * N + coef;
      add_size = g.s64;
    } else if (g.small != nullptr && c0 + col == 0) {
      add = g.small + b * g.s_size * N + coef;
      add_size = g.s_size < g.psize ? g.s_size : g.psize;
    }
    lift_add_normalize(smem, P, R, LOGN, col, g.psize, coef, add, add_size, ext,
                       g.out + oc * g.res_size * N + coef, g.res_size, g.kr, g.ka, g.consts);
  }
}

template <int LOGN>
int launch_n(const SlArgs& g, int blocks, int threads, bool bstep, int smem,
             cudaStream_t stream) {
  const auto kernel = bstep ? fused_sl_kernel<LOGN, true> : fused_sl_kernel<LOGN, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, (unsigned)threads, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: the product's [P, ci·rmax, co·psize, N]
// int32 Montgomery (backends/fused.py pm_kernel_layout or
// pm_kernel_layout_dsize), or the block step's [block, P, …] key elements;
// small: null or [B, s_size, N] int64 (added to column 0); small64: null or
// [B, co, s64, N] int64 (added to every column); block: 0 for the product,
// else the block step's key elements (ci == co, the input accumulator added
// at the exit; small and small64 null), xpow its x-power table (rot_mode 0
// and 2: [2N, P, N] Montgomery NTT(X^j − 1); rot_mode 1: [2N, 2, P, N], the
// plain value and ⌊w·2^30/p⌋) and amounts [B, block] int64; out: [B, co,
// res_size, N] int64, not aliasing a; tw, consts: backends/ntt.py
// kernel_tables; cpb output columns per block, threads per block (a
// multiple of 32 up to 512) and smem from backends/fused_sl.py sl_layout
// (the grid is B·co/cpb blocks).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for log N outside 7..11).
extern "C" int poulpy_fused_sl(const void* a, const void* pm, const void* small,
                               const void* small64, const void* xpow, const void* amounts,
                               void* out, const void* tw, const void* consts, int B, int ci,
                               int size_a, int rmax, int co, int psize, int s_size, int s64,
                               int res_size, int kr, int ka, int cpb, int P, int logn, int block,
                               int rot_mode, int threads, int smem, void* stream) {
  if (cpb < 1 || co % cpb || (block && (cpb != co || small || small64)) || rot_mode < 0 ||
      rot_mode > 2 || threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const SlArgs g{(const int64_t*)a, (const int32_t*)pm, (const int64_t*)small,
                 (const int64_t*)small64, (const int32_t*)xpow, (const int64_t*)amounts,
                 (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co,
                 psize, s_size, s64, res_size, kr, ka, cpb, P, block, rot_mode};
  const int blocks = B * (co / cpb);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool bstep = block > 0;
  switch (logn) {
    case 7: return launch_n<7>(g, blocks, threads, bstep, smem, st);
    case 8: return launch_n<8>(g, blocks, threads, bstep, smem, st);
    case 9: return launch_n<9>(g, blocks, threads, bstep, smem, st);
    case 10: return launch_n<10>(g, blocks, threads, bstep, smem, st);
    case 11: return launch_n<11>(g, blocks, threads, bstep, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
