// One block-binary CGGI blind-rotation step for a batch, one launch:
//   acc <- normalize(acc + idft(sum_i NTT(X^{a_i} - 1) * (dft(acc) [x] BRK_i)))
// from int64 limbs [B, cols, size, N] to normalized int64 limbs [B, cols, res_size, N];
// or, in the lazy design, `steps` such steps chained in one launch.
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe via
// fused_br_block_step (block > 1, rotate, add_acc; caller
// blind_rotation.py:485-527), in these call patterns:
// - steps 1, rot_mode 2 (the x-power applied to the VMP's input rows, from
//   the Montgomery table): the lazy design, poulpy_br_block_step_lazy;
// - steps 1, rot_mode 0 (applied to the VMP's output rows): the parent
//   design, poulpy_br_block_step; both compute the same bits;
// - steps 2, rot_mode 2, the JAX package's default launch (POULPY_TPU_BR_STEPS):
//   the lazy design's chain, poulpy_br_block_step_lazy with steps > 1, each
//   step's normalized accumulator kept in shared memory for the next;
// - steps 1 and 2, rot_mode 1 (POULPY_TPU_ROT_MODE=1, pallas_fused.py:712-724:
//   the x-power as a Shoup product on the VMP's input rows, from the
//   two-plane table of the plain NTT(X^j − 1) and its quotients
//   ⌊w·2^30/p⌋, blind_rotation.py _xpow_minus1_shoup_table): the lazy
//   design's SHOUP instances, poulpy_br_block_step_lazy with shoup = 1, at
//   GateShape and RuntimeShape, single and chained.
// Not replaced here: the sublane/lane-split layout (_ntt_rows_sl /
// _intt_rows_sl, POULPY_TPU_SL=1), which is csrc/fused_sl.cu.
// Plain twin: poulpy_tpu_torch/backends/fused.py fused_br_block_step_ref (the
// jnp block_step of blind_rotation.py:532-550, or with rot_mode 1 the Shoup
// product on dft(acc) before the VMP), `steps` of them in sequence.
//
// What bounds it on the H100: operations and L2, not HBM.  A ciphertext
// moves cols·size·N·8 bytes in and out (32 KB each way at the gate shape),
// but the work per ciphertext is KK·P forward and M·P inverse NTT rows,
// block·KK·M·P·N multiply-adds against the block's key elements and the
// x-power products: about 0.8 M modular products at the gate shape (N 1024,
// KK 4, M 8, P 2, block 8) against 64 KB of traffic.  The key elements of
// the block (4·block·P·KK·M·N bytes, 2 MB at the gate shape) are read by
// every block from L2, and the x-power rows (4·N bytes per prime and key
// element) from device memory.  The stage clock (TIMED instances,
// chip_smoke.py phase 3‴) read the parent design's VMP at 82 % of its
// cycles: a 64-bit `%` per (output row, key element) and an x-power product
// per output row.
//
// Two designs share the entry points' arguments:
//
// The lazy design (br_block_step_lazy_kernel; every shape whose rows fit,
// 256 ≤ N ≤ 2048, backends/fused.py lazy_layout): one block of 512 threads
// per tile of T ciphertexts (2 at the gate shape, GateShape; else 1), each
// with P regions of R = max(KK, M) rows in shared memory (modarith.cuh,
// the lazy design: the entry reads each limb once, lazy Shoup NTTs with two
// barriers per transform, the VMP in place), then the tile's x-power rows.
// The VMP makes x'_{i,k} = x_k·X^{a_i} once per (ciphertext, key element,
// input row), block·KK products instead of block·M, and sums all block·KK
// terms of an output lazily in u64 with one reduction; one thread per
// (prime, coefficient) keeps the tile's sums in registers, so each key word
// read from L2 serves the T ciphertexts.  131,136 B at the gate shape.  The
// chain (CHAIN, steps > 1) runs the whole step `steps` times over
// consecutive key elements; between steps the tile's normalized limbs
// [T][cols][res_size][N] int64 stay in shared memory (65,536 B more at the
// gate shape, 196,736 in all: still one block per SM), the next step's
// entry reads them there, and only the last step writes `out`.  The SHOUP
// instances (rot_mode 1) make x'_{i,k} by Shoup's product with the plain
// table word and its 30-bit quotient (modarith.cuh shoup_mul30) instead of a
// Montgomery product: one 64-bit and two 32-bit multiplies against REDC's
// three, but a second gather per (ciphertext, key element, coefficient)
// from the two-plane table [2N][2][P][N], twice the rows of the Montgomery
// one (32 MiB at N 1024, P 2).
//
// The parent design (br_block_step_kernel; the stage clock's reference, and
// br_block_step_staged_kernel for the global layout): one block per
// ciphertext (512 threads), as fused_product.cu's parent, whose entry and
// exit it shares.  Shared memory holds the KK input rows of one prime and
// the M output rows of every prime, 4·N·(KK + P·M) bytes (81,920 at the gate
// shape).  Per prime: reduce the acc limbs to [0, p) and NTT them; then each
// thread owns one (output row, coefficient) and, for each key element i,
// sums the KK products with BRK_i in u64, reduces once, and multiplies by
// the Montgomery NTT(X^{a_i} - 1) gathered from the [2N, P, N] table at row
// a_i & (2N - 1), adding into a residue it keeps in a register: the block's
// sum never leaves the thread, and no [B, block, P, N] gather is
// materialized.  Inverse NTT of the M rows, then the Garner lift, the
// wrapping add of the input acc limbs (column c, limb j < min(size, psize))
// and the bit-window normalization, as in fused_product.cu.  Where those
// rows do not fit (327,680 B at the gate shape at N 4096),
// br_block_step_staged_kernel keeps them in a global workspace and passes
// each transform through shared memory srows rows at a time (modarith.cuh,
// global layout).  The parent design runs one step per launch: the wrapper
// refuses a chain where the lazy design does not take the shape.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// The parent design's shared layout: the block's rows in shared memory.
// TIMED: the stage clock, stamps [B][BF_NSTAGES].
template <bool TIMED = false>
__global__ void __launch_bounds__(THREADS, 1) br_block_step_kernel(
    const int64_t* __restrict__ acc, const int32_t* __restrict__ pm,
    const int32_t* __restrict__ xpm1, const int64_t* __restrict__ amounts,
    int64_t* __restrict__ out, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int cols, int size, int rmax, int psize, int res_size,
    int kr, int block, int P, int logn, long long* __restrict__ stamps) {
  extern __shared__ uint32_t smem[];
  StageClock<TIMED, BF_NSTAGES> clk;
  const int n = 1 << logn;
  const int kk = cols * rmax;
  const int mdim = cols * psize;
  uint32_t* xin = smem;                      // [kk][n], one prime at a time
  uint32_t* ys = smem + (size_t)kk * n;      // [P][mdim][n]
  const int64_t b = blockIdx.x;
  const int64_t* ab = acc + b * cols * size * n;
  const int64_t* am = amounts + b * block;

  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    load_rows_mod_p(xin, ab, cols, size, rmax, logn, p);
    clk.mark(BF_ENTRY);
    ntt_fwd_rows(xin, kk, logn, tw + (size_t)pi * n, p, qinv);
    clk.mark(BF_FWD);

    uint32_t* y = ys + (size_t)pi * mdim * n;
    for (int idx = threadIdx.x; idx < (mdim << logn); idx += blockDim.x) {
      const int m = idx >> logn;
      const int coef = idx & (n - 1);
      uint32_t sum = 0;
      for (int i = 0; i < block; ++i) {
        const int32_t* pmi = pm + ((size_t)i * P + pi) * kk * mdim * n;
        uint64_t dot = 0;
        for (int k = 0; k < kk; ++k) {
          dot = mac_guard(dot, xin[(k << logn) + coef],
                          (uint32_t)__ldg(pmi + ((size_t)k * mdim + m) * n + coef), p);
        }
        const int64_t row = __ldg(am + i) & (2 * n - 1);
        const uint32_t w = (uint32_t)__ldg(xpm1 + ((size_t)row * P + pi) * n + coef);
        sum = add_mod(sum, mont_mul(fold_redc(dot, p, qinv), w, p, qinv), p);
      }
      y[idx] = sum;
    }
    __syncthreads();
    clk.mark(BF_VMP);
    ntt_inv_rows(y, mdim, logn, tw + (size_t)(P + pi) * n, p, qinv);
    clk.mark(BF_INV);
  }

  const int add_size = size < psize ? size : psize;
  for (int idx = threadIdx.x; idx < (cols << logn); idx += blockDim.x) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    lift_add_normalize(ys, P, mdim, logn, col, psize, coef, ab + (int64_t)col * size * n + coef,
                       add_size, psize, out + ((b * cols + col) * res_size) * n + coef, res_size,
                       kr, kr, consts);
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(BF_EXIT);
  }
  clk.store(stamps);
}

// The global layout (modarith.cuh): the block's rows in its workspace slot,
// each transform staged through shared memory srows rows at a time, the
// blocks walking the ciphertexts.  The same computation as
// br_block_step_kernel, whose code is kept apart: written through the shared
// helpers it ran 1 % slower on the gate path (PERF.md §6).
__global__ void __launch_bounds__(THREADS, 1) br_block_step_staged_kernel(
    const int64_t* __restrict__ acc, const int32_t* __restrict__ pm,
    const int32_t* __restrict__ xpm1, const int64_t* __restrict__ amounts,
    int64_t* __restrict__ out, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int cols, int size, int rmax, int psize, int res_size,
    int kr, int block, int P, int logn, uint32_t* __restrict__ ws, int srows, int tasks) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int kk = cols * rmax;
  const int mdim = cols * psize;
  for_each_task<true>(tasks, ws, (size_t)(kk + P * mdim) * n, [&](int task, uint32_t* xin) {
    uint32_t* ys = xin + (size_t)kk * n;      // [P][mdim][n]
    const int64_t b = task;
    const int64_t* ab = acc + b * cols * size * n;
    const int64_t* am = amounts + b * block;

    for (int pi = 0; pi < P; ++pi) {
      const int64_t* c = consts + pi * CONSTS_PER_PRIME;
      const uint32_t p = (uint32_t)c[C_P];
      const uint32_t qinv = (uint32_t)c[C_QINV];
      transform_rows<true>(
          xin, kk, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            load_rows_mod_p(buf, ab, size, rmax, r0, nr, logn, p);
          },
          [&](uint32_t* buf, int nr) { ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv); });
      transform_rows<true>(
          ys + (size_t)pi * mdim * n, mdim, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            for (int idx = threadIdx.x; idx < (nr << logn); idx += blockDim.x) {
              const int m = r0 + (idx >> logn);
              const int coef = idx & (n - 1);
              uint32_t sum = 0;
              for (int i = 0; i < block; ++i) {
                const int32_t* pmi = pm + ((size_t)i * P + pi) * kk * mdim * n;
                uint64_t dot = 0;
                for (int k = 0; k < kk; ++k) {
                  dot = mac_guard(dot, xin[(k << logn) + coef],
                                  (uint32_t)__ldg(pmi + ((size_t)k * mdim + m) * n + coef), p);
                }
                const int64_t row = __ldg(am + i) & (2 * n - 1);
                const uint32_t w = (uint32_t)__ldg(xpm1 + ((size_t)row * P + pi) * n + coef);
                sum = add_mod(sum, mont_mul(fold_redc(dot, p, qinv), w, p, qinv), p);
              }
              buf[idx] = sum;
            }
            __syncthreads();
          },
          [&](uint32_t* buf, int nr) {
            ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
          });
    }

    const int add_size = size < psize ? size : psize;
    for (int idx = threadIdx.x; idx < (cols << logn); idx += blockDim.x) {
      const int col = idx >> logn;
      const int coef = idx & (n - 1);
      lift_add_normalize(ys, P, mdim, logn, col, psize, coef, ab + (int64_t)col * size * n + coef,
                         add_size, psize, out + ((b * cols + col) * res_size) * n + coef, res_size,
                         kr, kr, consts);
    }
  });
}

// ---- the lazy design (modarith.cuh) ----

struct LazyStepArgs {
  const int64_t* acc;
  const int32_t* pm;
  const int32_t* xpm1;
  const int64_t* amounts;
  int64_t* out;
  const uint2* tw;
  const int64_t* consts;
  long long* stamps;
  int B, cols, size, rmax, psize, res_size, kr, block, steps, P, logn;
};

// The gate's block step (log N, KK, M, P, psize, res_size; backends/fused.py
// LAZY_SHAPES, two ciphertexts per block); any other shape takes
// RuntimeShape, one per block.
using GateShape = BfShape<10, 4, 8, 2, 4, 2>;
using RuntimeShape = BfShape<0, 0, 0, 0, 0, 0>;

// The lazy design: one block per tile of T ciphertexts (backends/fused.py
// lazy_layout), their T·P regions of R = max(KK, M) rows in shared memory,
// then (CHAIN) the tile's normalized limbs nxt [T][cols][res_size][N] int64,
// then the tile's x-power rows xrow [steps][T][block] (a & (2N − 1)).  The
// VMP makes each x-power product once per (ciphertext, key element, input
// row) and reads each key word once per tile (modarith.cuh lazy_vmp).
// CHAIN: g.steps steps (size == res_size), step st over key elements
// st·block … st·block + block − 1; step st's entry reads acc (st 0) or nxt,
// its exit adds those limbs and writes nxt, or `out` at the last step (a
// thread reads the limbs of its (ciphertext, column, coefficient) before it
// writes the same words, and no other thread touches them).  TIMED: the
// stage clock, stamps [blocks][BF_NSTAGES], summed over the steps.  SHOUP:
// g.xpm1 is the two-plane Shoup table [2N][2][P][N] (lazy_vmp's SHOUP), the
// same bits.
template <class S, int T, bool TIMED, bool CHAIN, bool SHOUP = false>
__global__ void __launch_bounds__(THREADS, 1) br_block_step_lazy_kernel(const LazyStepArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  __shared__ int rowoff[MAX_LIMBS];
  StageClock<TIMED, BF_NSTAGES> clk;
  constexpr int MK = S::KK ? S::KK : MAX_LIMBS, MC = S::MR ? S::MR : 8;
  const int logn = pick<S::LOGN>(g.logn), n = 1 << logn;
  const int kk = pick<S::KK>(g.cols * g.rmax), mdim = pick<S::MR>(g.cols * g.psize);
  const int P = pick<S::P>(g.P), psize = pick<S::PS>(g.psize), res_size = pick<S::RS>(g.res_size);
  const int cols = mdim / psize, R = max(kk, mdim), block = g.block;
  const int steps = CHAIN ? g.steps : 1, tb = T * block;
  const int64_t b0 = (int64_t)blockIdx.x * T;
  const int nt = (int)min((int64_t)T, (int64_t)g.B - b0);   // ciphertexts in this tile
  int64_t* nxt = (int64_t*)(smem + ((size_t)T * P * R << logn));
  int* xrow = (int*)(smem + ((size_t)T * P * R << logn)) +
              (CHAIN ? (T * cols * res_size << logn) * 2 : 0);
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  lazy_row_offsets(rowoff, kk, g.rmax, g.size, logn);
  for (int i = threadIdx.x; i < steps * tb; i += THREADS) {
    const int st = CHAIN ? i / tb : 0, r = i - st * tb, t = r / block;
    xrow[i] = t < nt ? (int)(g.amounts[(b0 + t) * steps * block + st * block + r - t * block] &
                             (2 * n - 1))
                     : 0;
  }
  __syncthreads();

  const int64_t* ab = g.acc + b0 * cols * g.size * n;
  const int add_size = g.size < psize ? g.size : psize;
  for (int st = 0; st < steps; ++st) {
    const int64_t* in = CHAIN && st > 0 ? nxt : ab;
    const bool last = !CHAIN || st + 1 == steps;
    lazy_entry_fwd(smem, in, rowoff, T, nt, cols, g.size, kk, P, R, logn, g.tw, lk);
    clk.mark(BF_ENTRY);
    ntt_pass_lo<false>(smem, T * P * kk, kk, R, P, logn, g.tw, lk, true);
    clk.mark(BF_FWD);
    lazy_vmp<T, MK, MC, true, SHOUP>(smem, g.pm + (size_t)st * block * P * kk * mdim * n,
                                     g.xpm1, xrow + st * tb, block, kk, mdim, 0, mdim, P, R,
                                     logn, lk);
    __syncthreads();
    clk.mark(BF_VMP);
    lazy_ntt_inv(smem, T * P, mdim, R, P, logn, g.tw + (size_t)P * n, lk);
    clk.mark(BF_INV);

    for (int idx = threadIdx.x; idx < ((nt * cols) << logn); idx += THREADS) {
      const int tc = idx >> logn, coef = idx & (n - 1);
      const int t = tc / cols, col = tc - t * cols;
      int64_t* dst = last ? g.out + (((b0 + t) * cols + col) * res_size) * n + coef
                          : nxt + ((size_t)tc * res_size << logn) + coef;
      lift_add_normalize(smem + ((size_t)t * P * R << logn), P, R, logn, col, psize, coef,
                         in + ((int64_t)t * cols + col) * g.size * n + coef, add_size, psize, dst,
                         res_size, g.kr, g.kr, g.consts);
    }
    if (TIMED || !last) {
      __syncthreads();
      clk.mark(BF_EXIT);
    }
  }
  clk.store(g.stamps);
}

template <class S, int T, bool CHAIN, bool SHOUP>
int launch_lazy_as(const LazyStepArgs& g, int smem, cudaStream_t stream) {
  const auto kernel = g.stamps != nullptr ? br_block_step_lazy_kernel<S, T, true, CHAIN, SHOUP>
                                          : br_block_step_lazy_kernel<S, T, false, CHAIN, SHOUP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((g.B + T - 1) / T), THREADS, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// One launch of shape S, T ciphertexts per block: the single step, or the
// chain where g.steps > 1; the x-power by Montgomery, or by Shoup (`shoup`).
template <class S, int T>
int launch_lazy(const LazyStepArgs& g, bool shoup, int smem, cudaStream_t stream) {
  if (shoup)
    return g.steps > 1 ? launch_lazy_as<S, T, true, true>(g, smem, stream)
                       : launch_lazy_as<S, T, false, true>(g, smem, stream);
  return g.steps > 1 ? launch_lazy_as<S, T, true, false>(g, smem, stream)
                     : launch_lazy_as<S, T, false, false>(g, smem, stream);
}

}  // namespace

// acc: [B, cols, size, N] int64; pm: [block, P, cols·rmax, cols·psize, N]
// int32 Montgomery (backends/fused.py pm_kernel_layout of the block's key
// elements); xpm1: [2N, P, N] int32 Montgomery NTT(X^j - 1); amounts: [B,
// block] int64; out: [B, cols, res_size, N] int64 (not aliasing acc); tw,
// consts: backends/ntt.py kernel_tables; smem: the layout's shared memory
// (backends/fused.py block_step_layout).  ws: null for the shared layout (a
// block per ciphertext), else the global layout's workspace of `grid` slots
// of cols·rmax + P·cols·psize rows of N words, srows rows staged at a time.
// stamps: null, or [B][5] int64 for the stage clock of the shared layout.
// Returns the cudaError_t of the launch.
extern "C" int poulpy_br_block_step(const void* acc, const void* pm, const void* xpm1,
                                    const void* amounts, void* out, const void* tw,
                                    const void* consts, int B, int cols, int size, int rmax,
                                    int psize, int res_size, int kr, int block, int P, int logn,
                                    int smem, void* ws, int srows, int grid, void* stamps,
                                    void* stream) {
  if (ws == nullptr) {
    const auto kernel =
        stamps != nullptr ? br_block_step_kernel<true> : br_block_step_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)B, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const int64_t*)acc, (const int32_t*)pm, (const int32_t*)xpm1, (const int64_t*)amounts,
        (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, cols, size, rmax, psize,
        res_size, kr, block, P, logn, (long long*)stamps);
  } else {
    if (stamps != nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(br_block_step_staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    br_block_step_staged_kernel<<<(unsigned)grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const int64_t*)acc, (const int32_t*)pm, (const int32_t*)xpm1, (const int64_t*)amounts,
        (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, cols, size, rmax, psize,
        res_size, kr, block, P, logn, (uint32_t*)ws, srows, B);
  }
  return (int)cudaGetLastError();
}

// The lazy design: the arguments of poulpy_br_block_step without the global
// layout's, and `steps` ≥ 1 (steps > 1: the chain, size == res_size; pm
// [steps·block, …], amounts [B, steps·block], step st over key elements
// st·block … st·block + block − 1); shoup: 0, xpm1 the Montgomery table
// [2N, P, N] (rot_mode 2), or 1, xpm1 the two-plane Shoup table
// [2N, 2, P, N] int32 (rot_mode 1); tw: the Shoup twiddles [2][P][N] uint2
// (backends/ntt.py shoup_tables); T ciphertexts per block and smem from
// backends/fused.py lazy_layout (T 2 at GateShape, else 1); the grid is
// ⌈B/T⌉ blocks.  stamps: null, or [blocks][5] int64 for the stage clock.
// Returns the cudaError_t of the launch.
extern "C" int poulpy_br_block_step_lazy(const void* acc, const void* pm, const void* xpm1,
                                         const void* amounts, void* out, const void* tw,
                                         const void* consts, int B, int cols, int size, int rmax,
                                         int psize, int res_size, int kr, int block, int steps,
                                         int shoup, int P, int logn, int T, int smem,
                                         void* stamps, void* stream) {
  if (steps < 1 || (steps > 1 && size != res_size)) return (int)cudaErrorInvalidValue;
  const LazyStepArgs g{(const int64_t*)acc, (const int32_t*)pm, (const int32_t*)xpm1,
                       (const int64_t*)amounts, (int64_t*)out, (const uint2*)tw,
                       (const int64_t*)consts, (long long*)stamps, B, cols, size, rmax, psize,
                       res_size, kr, block, steps, P, logn};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool gate = logn == GateShape::LOGN && cols * rmax == GateShape::KK &&
                    cols * psize == GateShape::MR && P == GateShape::P &&
                    psize == GateShape::PS && res_size == GateShape::RS;
  if (gate && T == 2) return launch_lazy<GateShape, 2>(g, shoup != 0, smem, st);
  if (T == 1) return launch_lazy<RuntimeShape, 1>(g, shoup != 0, smem, st);
  return (int)cudaErrorInvalidValue;
}
