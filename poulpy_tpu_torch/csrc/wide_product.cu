// Wide fused GLWE product, one launch for a batch:
//   out = big_normalize_wide(idft_wide(vmp(dft(a), pm)) [+ small per column], offset)
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N],
// with the exact convolution values carried in 128 bits (the reference's NTT120
// i128 big accumulator) for base2k up to ~52.
//
// Replaces: poulpy_tpu/backends/pallas_wide.py, _pipe_wide_fn -> _kernel_pipe_wide
// via fused_glwe_product_wide (callers: ckks/ops.py mul's relinearization with
// the linear terms as `small`, external_product.py:94-106 and keyswitching.py:
// 143-167 on wide parameters).  Plain twin: poulpy_tpu_torch/backends/wide.py
// fused_glwe_product_wide_ref.
//
// What bounds it on the H100: not HBM.  A ciphertext moves ci·size_a·N·8 bytes
// in, co·s_size·N·8 of linear terms and co·res_size·N·8 out (88 KB at the CKKS
// mul shape), while the work is KK·P forward and M·P inverse NTT rows of N
// points and KK·M·P·N multiply-adds, then a 128-bit Garner lift of M·N values.
// The TPU kernel's 4×i32-word i128, 26-bit entry split, (hi, lo) i32 output
// pairs and lazy-prime digit products are Mosaic workarounds: here any int64
// limb is reduced exactly, the accumulator is a native __int128, and limbs are
// read and written as int64.  Garner needs every prime of a coefficient at
// once, and all co columns of the mul shape (N 2048, KK 2, co 2, psize 3, P 5)
// with every prime's rows do not fit in shared memory.
//
// Two designs share the entry points' arguments:
//
// The lazy design (wide_product_lazy_kernel; 256 ≤ N ≤ 2048 where one prime's
// rows of a column group fit, backends/wide.py wide_lazy_layout): the
// butterfly kernels' lazy body (modarith.cuh) with the 128-bit exit of the
// tensor kernels' lazy design.  A block takes one ciphertext and the most
// output columns whose rows of one prime fit (all co at every path shape), in
// regions of R = max(KK, cpb·psize) rows, one per prime of a pass; where the
// P regions do not fit at once, the primes go in as few passes as fit, split
// evenly, and the rows of every pass but the last wait in a global scratch
// slot until the lift (the mul shape: 3 + 2 primes, 147,456 B; a column per
// block with all 5 primes at once, 122,880 B, measured 5 % slower: it redoes
// the forward rows of each column).  Per pass: the entry reads each limb once
// for the pass's primes, reduced in 32-bit Shoup products (mod_p_i64), the
// forward's stages of bits log N − 1 .. 8 in registers (lazy_entry_fwd); the
// low eight bits in a warp (ntt_pass_lo), two barriers per transform.  VMP in
// place, one thread per (prime, coefficient), the sums in registers, lazily
// in u64, reduced once (lazy_vmp).  Inverse: lazy_ntt_inv, canonical out.
// Exit: one thread per (column, coefficient), the Garner constants in shared
// memory (load_exit_primes): N^{-1} (a Montgomery product from canonical
// residues), the 128-bit lift of each of the psize limbs (exit_lift_wide),
// the wrapping add of the sign-extended `small` limbs, the pair-window
// normalization with the landing offset.  The mul's shape (MulShape) has an
// instance that knows its sizes and bases, so the lift's __int128 values and
// the windows stay in registers; any other shape takes the runtime-shaped
// instance.
//
// The parent design (wide_product_kernel; N outside 256..2048 or rows past
// the lazy layout, its global layout past shared memory, and the stage
// clock's reference): one block per ciphertext and group of `cpb` output
// columns (backends/fused.py product_layout), the KK input rows of one prime
// at a time and the
// cpb·psize output rows of every prime in shared memory, 4·N·(KK + P·cpb·psize)
// bytes (139,264 at the mul shape, cpb 1: each column block redoes the KK
// forward rows); the entry, NTT, VMP and inverse NTT are modarith.cuh's
// parent device functions (a signed 64-bit % per limb and prime, Montgomery
// butterflies with a barrier per stage), the exit lift_add_normalize_wide.
// Where one column does not fit either (the CKKS-wide key at N 4096: 278,528
// B), the STAGED instance takes fused_product.cu's global layout.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// The stages of both designs' stage clock (backends/wide.py WIDE_STAGES):
// limbs to residues and the forward NTT, the VMP, the inverse NTT, the lift
// (N^{-1}, Garner, add, normalize).
enum { WP_ENTRY_FWD, WP_VMP, WP_INV, WP_LIFT, WP_NSTAGES };

// The parent design.  STAGED: the global layout (modarith.cuh), the block's
// rows in its workspace slot.  TIMED: the stage clock (shared layout only),
// stamps [tasks][WP_NSTAGES].
template <bool STAGED, bool TIMED = false>
__global__ void __launch_bounds__(THREADS, 1) wide_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, int64_t* __restrict__ out,
    const int32_t* __restrict__ tw, const int64_t* __restrict__ consts, int ci, int size_a,
    int rmax, int co, int psize, int s_size, int res_size, int kr, int ka, int offset, int cpb,
    int P, int logn, uint32_t* __restrict__ ws, int srows, int tasks,
    long long* __restrict__ stamps) {
  extern __shared__ uint32_t smem[];
  StageClock<TIMED, WP_NSTAGES> clk;
  const int n = 1 << logn;
  const int kk = ci * rmax;
  const int mdim = co * psize;
  const int mrows = cpb * psize;
  const int groups = co / cpb;
  for_each_task<STAGED>(tasks, ws, (size_t)(kk + P * mrows) * n, [&](int task, uint32_t* slot) {
    const int64_t b = task / groups;
    const int c0 = (task % groups) * cpb;
    uint32_t* xin = STAGED ? slot : smem;    // [kk][n], one prime at a time
    uint32_t* ys = xin + (size_t)kk * n;      // [P][mrows][n]
    const int64_t* ab = a + b * ci * size_a * n;

    for (int pi = 0; pi < P; ++pi) {
      const int64_t* c = consts + pi * CONSTS_PER_PRIME;
      const uint32_t p = (uint32_t)c[C_P];
      const uint32_t qinv = (uint32_t)c[C_QINV];
      transform_rows<STAGED>(
          xin, kk, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            load_rows_mod_p(buf, ab, size_a, rmax, r0, nr, logn, p);
          },
          [&](uint32_t* buf, int nr) {
            ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv);
            clk.mark(WP_ENTRY_FWD);
          });
      transform_rows<STAGED>(
          ys + (size_t)pi * mrows * n, mrows, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            vmp_rows(buf, xin, pm + (size_t)pi * kk * mdim * n, kk, mdim, c0 * psize + r0, nr,
                     logn, p, qinv);
            clk.mark(WP_VMP);
          },
          [&](uint32_t* buf, int nr) {
            ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
            clk.mark(WP_INV);
          });
    }

    const int add_size = small == nullptr ? 0 : (s_size < psize ? s_size : psize);
    for (int idx = threadIdx.x; idx < (cpb << logn); idx += blockDim.x) {
      const int col = idx >> logn;
      const int coef = idx & (n - 1);
      const int64_t oc = b * co + c0 + col;
      lift_add_normalize_wide(ys, P, mrows, logn, col, psize, coef,
                              add_size ? small + oc * s_size * n + coef : nullptr, add_size,
                              out + oc * res_size * n + coef, res_size, kr, ka, offset, consts);
    }
    if (TIMED) {
      __syncthreads();
      clk.mark(WP_LIFT);
    }
  });
  clk.store(stamps);
}

// ---- the lazy design ----

struct WideArgs {
  const int64_t* a;
  const int32_t* pm;
  const int64_t* small;
  int64_t* out;
  uint32_t* scratch;
  const uint2* tw;
  const int64_t* consts;
  long long* stamps;
  int ci, size_a, rmax, co, psize, s_size, res_size, kr, ka, offset, cpb, P, logn, srows;
};

// The compile-time shape of an instance (log N, KK, cpb·psize, P, psize,
// res_size, kr, ka); 0 leaves a dimension to the runtime.  Known bases make
// the normalization's windows constant shifts.
template <int LOGN_, int KK_, int MR_, int P_, int PS_, int RS_, int KR_, int KA_>
struct WideShape {
  static constexpr int LOGN = LOGN_, KK = KK_, MR = MR_, P = P_, PS = PS_, RS = RS_, KR = KR_,
                       KA = KA_;
};

// The CKKS-wide mul's relinearization (backends/wide.py WIDE_SHAPES): N 2048,
// its 2 digits against the tensor key, both columns (co 2, psize 3) per
// block, P 5 in passes of 3 + 2, 2 limbs out, base 2^52 in and out.
using MulShape = WideShape<11, 2, 6, 5, 3, 2, 52, 52>;
using WideRuntime = WideShape<0, 0, 0, 0, 0, 0, 0, 0>;

// One block per ciphertext and group of cpb output columns, its P' regions
// of R rows in shared memory (srows rows: P' = min(P, srows / R) primes per
// pass; where P' < P the primes go in passes, the inverse-NTT'd rows of every
// pass but the last waiting in the block's scratch slot [P][cpb·psize][N]
// until the lift).  TIMED: the stage clock, stamps [blocks][WP_NSTAGES].
template <class S, bool TIMED>
__global__ void __launch_bounds__(THREADS, 1) wide_product_lazy_kernel(const WideArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  __shared__ int rowoff[MAX_LIMBS];
  __shared__ ExitPrimes kp;
  StageClock<TIMED, WP_NSTAGES> clk;
  constexpr int MK = S::KK ? S::KK : MAX_LIMBS, MC = S::MR ? S::MR : 8;
  constexpr int PM = S::P ? S::P : MAX_PRIMES;
  const int logn = pick<S::LOGN>(g.logn), n = 1 << logn;
  const int kk = pick<S::KK>(g.ci * g.rmax), mrows = pick<S::MR>(g.cpb * g.psize);
  const int P = pick<S::P>(g.P), psize = pick<S::PS>(g.psize);
  const int res_size = pick<S::RS>(g.res_size), kr = pick<S::KR>(g.kr), ka = pick<S::KA>(g.ka);
  const int cpb = mrows / psize, R = max(kk, mrows), groups = g.co / cpb, mdim = g.co * psize;
  const int PP = min(P, g.srows / R), last_p0 = (P - 1) / PP * PP;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * cpb;
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  lazy_row_offsets(rowoff, kk, g.rmax, g.size_a, logn);
  load_exit_primes(kp, g.consts, P);
  uint32_t* scr = g.scratch + ((size_t)blockIdx.x * P * mrows << logn);
  const int64_t* ab = g.a + b * g.ci * g.size_a * n;

  for (int p0 = 0; p0 < P; p0 += PP) {
    const int pp = min(PP, P - p0);
    const uint2* twf = g.tw + ((size_t)p0 << logn);
    lazy_entry_fwd(smem, ab, rowoff, 1, 1, g.ci, g.size_a, kk, pp, R, logn, twf, lk + p0);
    ntt_pass_lo<false>(smem, pp * kk, kk, R, pp, logn, twf, lk + p0, true);
    clk.mark(WP_ENTRY_FWD);
    lazy_vmp<1, MK, MC, false>(smem, g.pm + ((size_t)p0 * kk * mdim << logn), nullptr, nullptr,
                               1, kk, mdim, c0 * psize, mrows, pp, R, logn, lk + p0);
    __syncthreads();
    clk.mark(WP_VMP);
    lazy_ntt_inv(smem, pp, mrows, R, pp, logn, g.tw + ((size_t)(P + p0) << logn), lk + p0);
    if (p0 != last_p0) {                      // this pass's rows wait in the scratch slot
      for (int i = threadIdx.x * 4; i < (pp * mrows << logn); i += THREADS * 4) {
        const int row = i >> logn, pi = row / mrows, r = row - pi * mrows;
        const int c = i & (n - 1);
        *reinterpret_cast<uint4*>(scr + (((size_t)(p0 + pi) * mrows + r) << logn) + c) =
            *reinterpret_cast<const uint4*>(smem + (((size_t)pi * R + r) << logn) + c);
      }
      __syncthreads();
    }
    clk.mark(WP_INV);
  }

  // the canonical inverse-NTT'd residue of prime pi, output row r, coefficient coef
  auto residue = [&](int pi, int r, int coef) {
    return pi >= last_p0 ? smem[(((size_t)(pi - last_p0) * R + r) << logn) + coef]
                         : scr[(((size_t)pi * mrows + r) << logn) + coef];
  };
  const int add_size = g.small == nullptr ? 0 : min(g.s_size, psize);
  for (int idx = threadIdx.x; idx < (cpb << logn); idx += THREADS) {
    const int col = idx >> logn, coef = idx & (n - 1);
    const int64_t oc = b * g.co + c0 + col;
    const int64_t* add = add_size ? g.small + (oc * g.s_size << logn) + coef : nullptr;
    int64_t* dst = g.out + (oc * res_size << logn) + coef;
    // limb j's residues, N^{-1} applied: r[pi] canonical
    auto lift_row = [&](int j, uint32_t (&r)[PM]) {
#pragma unroll
      for (int pi = 0; pi < PM; ++pi)
        if (pi < P)
          r[pi] = mont_mul(residue(pi, col * psize + j, coef), kp.ninv[pi], kp.p[pi], kp.qinv[pi]);
    };
    auto plus_small = [&](__int128 v, int j) {
      return (__int128)((unsigned __int128)v + (unsigned __int128)(__int128)add[(size_t)j << logn]);
    };
    if constexpr (S::PS != 0) {
      __int128 big[S::PS];
#pragma unroll
      for (int j = 0; j < S::PS; ++j) {
        uint32_t r[PM];
        lift_row(j, r);
        big[j] = exit_lift_wide<S::P>(r, P, kp);
        if (j < add_size) big[j] = plus_small(big[j], j);
      }
      int64_t res[S::RS];
      normalize_full_wide_t<S::PS, S::RS>(big, res, kr, ka, g.offset);
#pragma unroll
      for (int i = 0; i < S::RS; ++i) dst[(size_t)i << logn] = res[i];
    } else {
      __int128 big[MAX_LIMBS];
      for (int j = 0; j < psize; ++j) {
        uint32_t r[PM];
        lift_row(j, r);
        big[j] = exit_lift_wide<0>(r, P, kp);
        if (j < add_size) big[j] = plus_small(big[j], j);
      }
      int64_t res[MAX_LIMBS];
      normalize_full_wide(big, psize, res, res_size, kr, ka, g.offset);
      for (int i = 0; i < res_size; ++i) dst[(size_t)i << logn] = res[i];
    }
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(WP_LIFT);
  }
  clk.store(g.stamps);
}

template <class S>
bool is_shape(const WideArgs& g) {
  return g.logn == S::LOGN && g.ci * g.rmax == S::KK && g.cpb * g.psize == S::MR &&
         g.P == S::P && g.psize == S::PS && g.res_size == S::RS && g.kr == S::KR &&
         g.ka == S::KA;
}

template <class S>
int launch_lazy(const WideArgs& g, int grid, int smem, cudaStream_t stream) {
  const auto kernel = g.stamps != nullptr ? wide_product_lazy_kernel<S, true>
                                          : wide_product_lazy_kernel<S, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, THREADS, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery
// (backends/fused.py pm_kernel_layout / pm_kernel_layout_dsize); small: [B, co,
// s_size, N] int64 or null; out: [B, co, res_size, N] int64; tw, consts:
// backends/ntt.py kernel_tables; cpb: output columns per block (divides co);
// smem: the layout's shared memory (backends/fused.py product_layout).  ws:
// null for the shared layout, else the global layout's workspace of `grid`
// slots of kk + P·cpb·psize rows of N words, srows rows staged at a time.
// stamps: null, or [B·co/cpb][4] int64 for the stage clock (shared layout
// only).  The parent design.  Returns the cudaError_t of the launch.
extern "C" int poulpy_wide_product(const void* a, const void* pm, const void* small, void* out,
                                   const void* tw, const void* consts, int B, int ci, int size_a,
                                   int rmax, int co, int psize, int s_size, int res_size, int kr,
                                   int ka, int offset, int cpb, int P, int logn, int smem,
                                   void* ws, int srows, int grid, void* stamps, void* stream) {
  const bool staged = ws != nullptr;
  if (staged && stamps != nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = stamps != nullptr ? wide_product_kernel<false, true>
                      : staged          ? wide_product_kernel<true>
                                        : wide_product_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tasks = B * (co / cpb);
  kernel<<<(unsigned)(staged ? grid : tasks), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (int64_t*)out,
      (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co, psize, s_size, res_size,
      kr, ka, offset, cpb, P, logn, (uint32_t*)ws, srows, tasks, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The lazy design: the arguments of poulpy_wide_product without the global
// layout's; scratch: [B·co/cpb][P][cpb·psize][N] 32-bit words where the primes
// go in passes, else null; tw: the Shoup twiddles [2][P][N] uint2
// (backends/ntt.py shoup_tables); cpb, srows (shared rows) and smem from
// backends/wide.py wide_lazy_layout; the grid is B·co/cpb blocks.  stamps:
// null, or [blocks][4] int64 for the stage clock.  Returns the cudaError_t of
// the launch.
extern "C" int poulpy_wide_product_lazy(const void* a, const void* pm, const void* small,
                                        void* out, void* scratch, const void* tw,
                                        const void* consts, int B, int ci, int size_a, int rmax,
                                        int co, int psize, int s_size, int res_size, int kr,
                                        int ka, int offset, int cpb, int P, int logn, int srows,
                                        int smem, void* stamps, void* stream) {
  const WideArgs g{(const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (int64_t*)out,
                   (uint32_t*)scratch, (const uint2*)tw, (const int64_t*)consts,
                   (long long*)stamps, ci, size_a, rmax, co, psize, s_size, res_size, kr, ka,
                   offset, cpb, P, logn, srows};
  const int grid = B * (co / cpb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_shape<MulShape>(g)) return launch_lazy<MulShape>(g, grid, smem, st);
  return launch_lazy<WideRuntime>(g, grid, smem, st);
}
