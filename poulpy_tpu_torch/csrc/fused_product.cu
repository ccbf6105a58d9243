// Fused GLWE x GGSW / GLWE x GGLWE product, one launch for a batch:
//   out = big_normalize(idft(vmp(dft(a), pm)) [+ small at column 0 | + small64 per column])
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe via
// fused_glwe_product, three call patterns: the product (block = 1, no rotate,
// no small, no small64); the keyswitch (the same with `small`, the body limbs
// added to column 0 of the big accumulator before the normalization,
// pallas_fused.py:823-827; caller keyswitching.py:131); the relinearization of
// a rank-1 tensor product (the same with `small64`, the linear terms added to
// every column over max(psize, s64) limbs, pallas_fused.py:829-852; caller
// operations.py:260).  Plain twin: poulpy_tpu_torch/backends/fused.py
// fused_glwe_product_ref.
//
// What bounds it on the H100: not HBM.  A ciphertext moves 2·ci·size_a·N·8
// bytes in (+ s_size·N·8 of body or co·s64·N·8 of linear terms) and
// co·res_size·N·8 out, while the work is (KK + M)·P NTTs of N points plus
// KK·M·P·N multiply-adds against the prepared matrix (4·P·KK·M·N bytes, read
// by every block from L2).  The limits are the instructions of the modular
// arithmetic, the block barriers between stages, shared-memory capacity
// (one block of 512 threads per SM at the headline shape) and the L2 reads
// of the matrix.  The stage clock (TIMED instances, chip_smoke.py phase 3‴)
// read the parent design's VMP at 44 % of the product (a 64-bit `%` per
// dot product) and its entry, NTTs and exit at 12–17 % each.
//
// Two designs share the entry points' arguments:
//
// The lazy design (fused_product_lazy_kernel; every shape whose rows fit,
// 256 ≤ N ≤ 2048, backends/fused.py lazy_layout): one block per ciphertext
// and group of cpb output columns, shared memory holding P regions of
// R = max(KK, cpb·psize) rows, 4·N·P·R bytes (131,072 at the headline
// shape, N 2048, KK 6, M 8, P 2, against the parent's 180,224; the CKKS
// keyswitch and relinearization, KK 6, co 2, psize 6, fit all of co in
// 196,608 B, so their column blocks no longer redo the forward).  Entry:
// each limb read once, eight loads in flight per thread, its residue mod
// every prime without a 64-bit `%` (modarith.cuh mod_p_i64).  NTTs: lazy
// butterflies with Shoup twiddles, every prime's rows at once, two barriers
// per transform (modarith.cuh lazy_ntt_fwd / lazy_ntt_inv).  VMP in place,
// one thread per (prime, coefficient), the sums in registers, lazily in u64
// (lazy_vmp).  Exit as the parent's.  The paths' shapes (ProductShape,
// SmallShape, GateKsShape, RotateShape) have instances that know their
// shape: loops unrolled, the exit's arrays in registers.
//
// The parent design (fused_product_kernel; the global layout past shared
// memory, and the stage clock's reference): one block (512 threads) per
// ciphertext and group of `cpb` output columns (co/cpb blocks per
// ciphertext, cpb the largest divisor of co whose rows fit,
// backends/fused.py product_layout).  Shared memory holds the KK input rows
// of one prime at a time and the cpb·psize output rows of every prime,
// because Garner needs all primes of a coefficient at once:
//   4·N·(KK + P·cpb·psize) bytes.
// At the CKKS keyswitch and relinearization (N 2048, KK 6, co 2, psize 6,
// P 2) all of co needs 245,760 B, over the 232,448 a block may have: cpb = 1
// (147,456 B), and each column block NTTs the KK input rows itself.  Where
// one column does not fit either (bench.py's shape at N 8192 needs 458,752
// B), the STAGED instance takes the global layout of modarith.cuh: the KK
// input rows and the P·co·psize output rows live in a global workspace slot
// of the block, and each transform passes through shared memory srows rows
// at a time (7 at N 8192), the VMP reading the input rows from L2.
// Per prime: reduce the limbs to [0, p) (any int64 is accepted, so |x| < 2^29
// is not a precondition), forward NTT of the KK rows, VMP with u64 sums and
// one reduction, inverse NTT of the block's rows.  Then one thread per
// (column, coefficient) does the N^{-1} scale, the Garner lift in native u64,
// the wrapping add (the body at column 0, limbs j < min(s_size, psize); or the
// column's s64 linear limbs, the lifted limbs extended with zeros to
// ext = max(psize, s64)) and the bit-window normalization of
// hal/normalization.py over ext limbs.  The adds cost one predicated load per
// limb, so the three patterns share one kernel; the small64 exit is its own
// template instance, so that the product and the keyswitch keep the lift of
// psize limbs that the compiler sees.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// The parent design.  S64: the small64 pattern.  Without it ext = psize is
// known to the compiler, and the exit compiles to the plain lift of psize
// limbs.  STAGED: the global layout (modarith.cuh), the block's rows in its
// workspace slot.  TIMED: the stage clock (shared layout only), stamps
// [tasks][BF_NSTAGES].
template <bool S64, bool STAGED, bool TIMED = false>
__global__ void __launch_bounds__(THREADS, 1) fused_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, const int64_t* __restrict__ small64,
    int64_t* __restrict__ out, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int ci, int size_a, int rmax, int co, int psize,
    int s_size, int s64, int res_size, int kr, int ka, int cpb, int P, int logn,
    uint32_t* __restrict__ ws, int srows, int tasks, long long* __restrict__ stamps) {
  extern __shared__ uint32_t smem[];
  StageClock<TIMED, BF_NSTAGES> clk;
  const int n = 1 << logn;
  const int kk = ci * rmax;
  const int mdim = co * psize;
  const int mrows = cpb * psize;
  const int groups = co / cpb;
  for_each_task<STAGED>(tasks, ws, (size_t)(kk + P * mrows) * n, [&](int task, uint32_t* slot) {
    const int64_t b = task / groups;
    const int c0 = (task % groups) * cpb;
    uint32_t* xin = STAGED ? slot : smem;                      // [kk][n], one prime at a time
    uint32_t* ys = xin + (size_t)kk * n;                      // [P][mrows][n]
    const int64_t* ab = a + b * ci * size_a * n;

    for (int pi = 0; pi < P; ++pi) {
      const int64_t* c = consts + pi * CONSTS_PER_PRIME;
      const uint32_t p = (uint32_t)c[C_P];
      const uint32_t qinv = (uint32_t)c[C_QINV];
      transform_rows<STAGED>(
          xin, kk, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            load_rows_mod_p(buf, ab, size_a, rmax, r0, nr, logn, p);
            clk.mark(BF_ENTRY);
          },
          [&](uint32_t* buf, int nr) {
            ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv);
            clk.mark(BF_FWD);
          });
      transform_rows<STAGED>(
          ys + (size_t)pi * mrows * n, mrows, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            vmp_rows(buf, xin, pm + (size_t)pi * kk * mdim * n, kk, mdim, c0 * psize + r0, nr,
                     logn, p, qinv);
            clk.mark(BF_VMP);
          },
          [&](uint32_t* buf, int nr) {
            ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
            clk.mark(BF_INV);
          });
    }

    const int ext = S64 && s64 > psize ? s64 : psize;
    for (int idx = threadIdx.x; idx < (cpb << logn); idx += blockDim.x) {
      const int col = idx >> logn;
      const int coef = idx & (n - 1);
      const int64_t oc = b * co + c0 + col;
      const int64_t* add = nullptr;
      int add_size = 0;
      if (S64) {
        add = small64 + oc * s64 * n + coef;
        add_size = s64;
      } else if (small != nullptr && c0 + col == 0) {
        add = small + (b * s_size) * n + coef;
        add_size = s_size < psize ? s_size : psize;
      }
      lift_add_normalize(ys, P, mrows, logn, col, psize, coef, add, add_size, ext,
                         out + oc * res_size * n + coef, res_size, kr, ka, consts);
    }
    if (TIMED) {
      __syncthreads();
      clk.mark(BF_EXIT);
    }
  });
  clk.store(stamps);
}

// ---- the lazy design (modarith.cuh) ----

struct LazyArgs {
  const int64_t* a;
  const int32_t* pm;
  const int64_t* small;
  const int64_t* small64;
  int64_t* out;
  const uint2* tw;
  const int64_t* consts;
  long long* stamps;
  int ci, size_a, rmax, co, psize, s_size, s64, res_size, kr, ka, cpb, P, logn;
};

// The paths' shapes (log N, KK, cpb·psize, P, psize, res_size;
// backends/fused.py LAZY_SHAPES): bench.py's product, the keyswitch path's
// body add, the gate's keyswitch, the CKKS rotation's keyswitch; any other
// shape (the small64 pattern's too) takes RuntimeShape.
using ProductShape = BfShape<11, 6, 8, 2, 4, 3>;
using SmallShape = BfShape<11, 3, 8, 2, 4, 3>;
using GateKsShape = BfShape<10, 2, 6, 2, 3, 2>;
using RotateShape = BfShape<11, 6, 12, 2, 6, 6>;
using RuntimeShape = BfShape<0, 0, 0, 0, 0, 0>;

// The lazy design: one block per ciphertext and group of cpb output columns
// (backends/fused.py lazy_layout), its P regions of R = max(KK, cpb·psize)
// rows in shared memory.  A shape known to the compiler unrolls the VMP and
// keeps the exit's arrays in registers.  TIMED: the stage clock, stamps
// [blocks][BF_NSTAGES].
template <class S, bool S64, bool TIMED>
__global__ void __launch_bounds__(THREADS, 1) fused_product_lazy_kernel(const LazyArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  __shared__ int rowoff[MAX_LIMBS];
  StageClock<TIMED, BF_NSTAGES> clk;
  constexpr int MK = S::KK ? S::KK : MAX_LIMBS, MC = S::MR ? S::MR : 8;
  const int logn = pick<S::LOGN>(g.logn), n = 1 << logn;
  const int kk = pick<S::KK>(g.ci * g.rmax), mrows = pick<S::MR>(g.cpb * g.psize);
  const int P = pick<S::P>(g.P), psize = pick<S::PS>(g.psize), res_size = pick<S::RS>(g.res_size);
  const int cpb = mrows / psize, R = max(kk, mrows), groups = g.co / cpb;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * cpb;
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  lazy_row_offsets(rowoff, kk, g.rmax, g.size_a, logn);
  __syncthreads();

  lazy_entry_fwd(smem, g.a + b * g.ci * g.size_a * n, rowoff, 1, 1, g.ci, g.size_a, kk, P, R, logn,
                 g.tw, lk);
  clk.mark(BF_ENTRY);
  ntt_pass_lo<false>(smem, P * kk, kk, R, P, logn, g.tw, lk, true);
  clk.mark(BF_FWD);
  lazy_vmp<1, MK, MC, false>(smem, g.pm, nullptr, nullptr, 1, kk, g.co * psize, c0 * psize, mrows,
                             P, R, logn, lk);
  __syncthreads();
  clk.mark(BF_VMP);
  lazy_ntt_inv(smem, P, mrows, R, P, logn, g.tw + (size_t)P * n, lk);
  clk.mark(BF_INV);

  const int ext = S64 && g.s64 > psize ? g.s64 : psize;
  for (int idx = threadIdx.x; idx < (cpb << logn); idx += THREADS) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    const int64_t oc = b * g.co + c0 + col;
    const int64_t* add = nullptr;
    int add_size = 0;
    if (S64) {
      add = g.small64 + oc * g.s64 * n + coef;
      add_size = g.s64;
    } else if (g.small != nullptr && c0 + col == 0) {
      add = g.small + (b * g.s_size) * n + coef;
      add_size = g.s_size < psize ? g.s_size : psize;
    }
    lift_add_normalize(smem, P, R, logn, col, psize, coef, add, add_size, ext,
                       g.out + oc * res_size * n + coef, res_size, g.kr, g.ka, g.consts);
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(BF_EXIT);
  }
  clk.store(g.stamps);
}

template <class S>
bool is_shape(const LazyArgs& g) {
  return g.logn == S::LOGN && g.ci * g.rmax == S::KK && g.cpb * g.psize == S::MR && g.P == S::P &&
         g.psize == S::PS && g.res_size == S::RS;
}

template <class S, bool S64>
int launch_lazy(const LazyArgs& g, int grid, int smem, cudaStream_t stream) {
  const auto kernel = g.stamps != nullptr ? fused_product_lazy_kernel<S, S64, true>
                                          : fused_product_lazy_kernel<S, S64, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, THREADS, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery
// (backends/fused.py pm_kernel_layout); small: [B, s_size, N] int64 or null
// with s_size 0; small64: [B, co, s64, N] int64 or null with s64 0 (at most
// one of the two); out: [B, co, res_size, N] int64; tw, consts: backends/ntt.py
// kernel_tables; cpb: output columns per block (divides co); smem: the
// layout's shared memory (backends/fused.py product_layout).  ws: null for the
// shared layout (a block per task), else the global layout's workspace of
// `grid` slots of kk + P·cpb·psize rows of N words, srows rows staged at a
// time.  Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_product(const void* a, const void* pm, const void* small,
                                    const void* small64, void* out, const void* tw,
                                    const void* consts, int B, int ci, int size_a, int rmax,
                                    int co, int psize, int s_size, int s64, int res_size, int kr,
                                    int ka, int cpb, int P, int logn, int smem, void* ws,
                                    int srows, int grid, void* stamps, void* stream) {
  const bool staged = ws != nullptr;
  if (staged && stamps != nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel =
      stamps != nullptr
          ? (small64 != nullptr ? fused_product_kernel<true, false, true>
                                : fused_product_kernel<false, false, true>)
      : small64 != nullptr
          ? (staged ? fused_product_kernel<true, true> : fused_product_kernel<true, false>)
          : (staged ? fused_product_kernel<false, true> : fused_product_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tasks = B * (co / cpb);
  kernel<<<(unsigned)(staged ? grid : tasks), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (const int64_t*)small64,
      (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co, psize,
      s_size, s64, res_size, kr, ka, cpb, P, logn, (uint32_t*)ws, srows, tasks,
      (long long*)stamps);
  return (int)cudaGetLastError();
}

// The lazy design: the arguments of poulpy_fused_product without the global
// layout's; tw: the Shoup twiddles [2][P][N] uint2 (backends/ntt.py
// shoup_tables); cpb and smem from backends/fused.py lazy_layout; the grid is
// B·co/cpb blocks.  stamps: null, or [blocks][5] int64 for the stage clock.
// Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_product_lazy(const void* a, const void* pm, const void* small,
                                         const void* small64, void* out, const void* tw,
                                         const void* consts, int B, int ci, int size_a, int rmax,
                                         int co, int psize, int s_size, int s64, int res_size,
                                         int kr, int ka, int cpb, int P, int logn, int smem,
                                         void* stamps, void* stream) {
  const LazyArgs g{(const int64_t*)a, (const int32_t*)pm,
                   (const int64_t*)small, (const int64_t*)small64, (int64_t*)out,
                   (const uint2*)tw, (const int64_t*)consts, (long long*)stamps, ci, size_a,
                   rmax, co, psize, s_size, s64, res_size, kr, ka, cpb, P, logn};
  const int grid = B * (co / cpb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (small64 != nullptr) return launch_lazy<RuntimeShape, true>(g, grid, smem, st);
  if (is_shape<ProductShape>(g)) return launch_lazy<ProductShape, false>(g, grid, smem, st);
  if (is_shape<SmallShape>(g)) return launch_lazy<SmallShape, false>(g, grid, smem, st);
  if (is_shape<GateKsShape>(g)) return launch_lazy<GateKsShape, false>(g, grid, smem, st);
  if (is_shape<RotateShape>(g)) return launch_lazy<RotateShape, false>(g, grid, smem, st);
  return launch_lazy<RuntimeShape, false>(g, grid, smem, st);
}
