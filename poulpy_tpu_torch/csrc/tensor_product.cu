// Fused rank-1 tensor product, one launch for a batch: for ciphertexts
// a = (a0, a1), b = (b0, b1) of int64 limbs [B, 2, size_a | size_b, N], the limb
// convolutions (a0·b0, a0·b1 + a1·b0, a1·b1) of conv_size limbs each, lifted
// to wrapping int64 (Garner), then
//   d   = big_normalize(a1·b1, dnum limbs of base 2^kr from base 2^ka)   [B, dnum, N]
//   lin = the raw lifted limbs of a0·b0 and a0·b1 + a1·b0                [B, 2, conv_size, N]
// (the quadratic term as the relinearization's gadget digits, the linear terms
// as the 64-bit limbs its product adds per column, fused_product.cu small64).
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _tensor_fn -> _kernel_tensor
// via fused_tensor_product (caller: core/operations.py
// glwe_tensor_relinearize, rank-1 non-wide route).  Plain twin:
// poulpy_tpu_torch/backends/fused.py fused_tensor_product_ref
// (glwe_tensor_product_big + big_normalize).  The 128-bit twin is
// wide_tensor.cu; the two share the lazy design (tensor.cuh) and the parent
// design's entry, NTTs, pair convolution and lift (modarith.cuh).
//
// What bounds it on the H100: not HBM.  A ciphertext pair moves (2·size_a +
// 2·size_b)·N·8 bytes in and (dnum + 2·conv_size)·N·8 out (about 0.4 MB at the
// relinearize path's shape: N 2048, 6 + 6 limbs, conv 11, dnum 6, P 2),
// against (size_a + size_b)·2·P·2 forward NTT rows (the cross pair reads both
// columns), 3·conv_size·P inverse rows, 4·size_a·size_b·P·N multiply-adds and
// a Garner lift of 3·conv_size·N values: the limits are the modular
// arithmetic's instructions, the barriers between stages and shared memory
// (one block of 512 threads per SM at the path's shape).
//
// Two designs share the entry points' arguments:
//
// The lazy design (tensor.cuh; 256 ≤ N ≤ 2048 where one prime's rows of a
// task fit, backends/fused.py tensor_lazy_layout).  At the path's shape all
// three pairs of a ciphertext need 33 conv rows per prime in place, 270,336
// B, over the 232,448 a block may have: a task is one (ciphertext, pair),
// the cross pairs first; a0·b0 and a1·b1 hold both primes at once (2 × 12
// rows, 196,608 B), the cross pair one prime at a time (24 rows), its first
// prime's 11 inverse rows in a scratch slot until the lift.  TensorShape
// (the relinearize path's shape) unrolls the convolution and keeps the
// lift's arrays in registers; any other shape takes the runtime-shaped
// instance.
//
// The parent design (tensor_product_kernel; N ≥ 4096 or rows past shared
// memory, and the stage clock's reference): a block takes one (ciphertext,
// pair) and runs the primes one after another in one workspace of
// max(2·(size_a + size_b), conv_size) rows (196,608 B at the path's shape):
// the columns the pair reads, NTT'd (Montgomery butterflies, a barrier per
// stage); the convolution written in place over them (each thread owns
// whole coefficients, pair_conv); the inverse NTT of the conv_size rows;
// those rows copied to a global scratch [B·3, P, conv, N] u32.  After the
// last prime the block lifts its coefficients from the scratch (written by
// the block itself, visible after the barrier): the quadratic block
// normalizes to d, the linear blocks write raw limbs.  Where the workspace
// does not fit (393,216 B at N 4096 with 6 + 6 limbs), the STAGED instance
// takes the global layout of modarith.cuh: the block's rows live in its
// workspace slot (2·(size_a + size_b) input rows, then the P·conv_size rows
// the scratch held), the blocks walk the tasks, and each transform passes
// through shared memory srows rows at a time.
#include "tensor.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// The parent design.  STAGED: the global layout (modarith.cuh), the block's
// rows in its workspace slot.  TIMED: the stage clock (shared layout only),
// stamps [tasks][TS_NSTAGES].
template <bool STAGED, bool TIMED = false>
__global__ void __launch_bounds__(THREADS, 1) tensor_product_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ d,
    int64_t* __restrict__ lin, uint32_t* scratch, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int size_a, int size_b, int conv_size, int dnum, int kr,
    int ka, int P, int logn, uint32_t* __restrict__ ws, int srows, int tasks,
    long long* __restrict__ stamps) {
  extern __shared__ uint32_t smem[];
  StageClock<TIMED, TS_NSTAGES> clk;
  const int n = 1 << logn;
  const int in_rows = 2 * (size_a + size_b);
  for_each_task<STAGED>(tasks, ws, (size_t)(in_rows + P * conv_size) * n,
                        [&](int task, uint32_t* slot) {
    const int64_t ct = task / 3;
    const int pair = task % 3;                // 0: a0·b0, 1: a0·b1 + a1·b0, 2: a1·b1
    const int col0 = pair == 2 ? 1 : 0;       // first input column the pair reads
    const int ncols = pair == 1 ? 2 : 1;
    const int na = ncols * size_a;
    uint32_t* xa = STAGED ? slot : smem;                      // [ncols][size_a][n]
    uint32_t* xb = xa + (size_t)na * n;                       // [ncols][size_b][n]
    // [P][conv][n]: the slot's rows after the inputs, or the task's scratch rows
    uint32_t* res = STAGED ? xa + (size_t)in_rows * n
                           : scratch + (size_t)task * P * conv_size * n;
    const int64_t* ac = a + ((ct * 2 + col0) * size_a) * n;
    const int64_t* bc = b + ((ct * 2 + col0) * size_b) * n;

    for (int pi = 0; pi < P; ++pi) {
      const int64_t* c = consts + pi * CONSTS_PER_PRIME;
      const uint32_t p = (uint32_t)c[C_P];
      const uint32_t qinv = (uint32_t)c[C_QINV];
      transform_rows<STAGED>(
          xa, na + ncols * size_b, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {   // rows of a, then rows of b
            const int ea = max(0, min(na - r0, nr));
            if (ea) load_rows_mod_p(buf, ac, size_a, size_a, r0, ea, logn, p);
            if (nr > ea)
              load_rows_mod_p(buf + ((size_t)ea << logn), bc, size_b, size_b, r0 + ea - na,
                              nr - ea, logn, p);
          },
          [&](uint32_t* buf, int nr) {
            ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv);
            clk.mark(TS_ENTRY_FWD);
          });
      uint32_t* rp = res + (size_t)pi * conv_size * n;
      if (STAGED) {
        transform_rows<STAGED>(
            rp, conv_size, smem, srows, logn,
            [&](uint32_t* buf, int r0, int nr) {
              for (int coef = threadIdx.x; coef < n; coef += blockDim.x)
                pair_conv<false>(buf, xa, xb, pair, size_a, size_b, r0, r0 + nr, logn, coef, p);
              __syncthreads();
            },
            [&](uint32_t* buf, int nr) {
              ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
            });
      } else {
        for (int coef = threadIdx.x; coef < n; coef += blockDim.x)
          pair_conv<true>(smem, xa, xb, pair, size_a, size_b, 0, conv_size, logn, coef, p);
        __syncthreads();
        clk.mark(TS_CONV);
        ntt_inv_rows(smem, conv_size, logn, tw + (size_t)(P + pi) * n, p, qinv);
        copy_rows(rp, smem, conv_size, logn);   // the workspace is reloaded; the scratch is read
        clk.mark(TS_INV);
      }
    }

    for (int coef = threadIdx.x; coef < n; coef += blockDim.x) {
      if (pair == 2) {
        lift_add_normalize(res, P, conv_size, logn, 0, conv_size, coef, nullptr, 0, conv_size,
                           d + ct * dnum * n + coef, dnum, kr, ka, consts);
      } else {
        int64_t* o = lin + ((ct * 2 + pair) * conv_size) * n + coef;
        for (int j = 0; j < conv_size; ++j)
          o[(int64_t)j * n] = lift_limb(res, P, conv_size, logn, j, coef, consts);
      }
    }
    if (TIMED) {
      __syncthreads();
      clk.mark(TS_LIFT);
    }
  });
  clk.store(stamps);
}

// The relinearize path's shape (log N, P, size_a, size_b, conv, dnum, lin
// limbs, a pair per task, base 2^17 in and out; backends/fused.py
// TENSOR_SHAPES); any other shape takes TsRuntime.
using TensorShape = TsShape<11, 2, 6, 6, 11, 6, 11, 1, 17, 17>;

}  // namespace

// a: [B, 2, size_a, N], b: [B, 2, size_b, N] int64; d: [B, dnum, N], lin: [B, 2,
// conv_size, N] int64; scratch: [B·3, P, conv_size, N] 32-bit words (the
// shared layout) or null; tw, consts: backends/ntt.py kernel_tables; smem: the
// layout's shared memory (backends/fused.py tensor_layout).  ws: null for the
// shared layout (a block per ciphertext and pair), else the global layout's
// workspace of `grid` slots of 2·(size_a + size_b) + P·conv_size rows of N
// words, srows rows staged at a time.  stamps: null, or [B·3][4] int64 for
// the stage clock (shared layout only).  The parent design.  Returns the
// cudaError_t of the launch.
extern "C" int poulpy_tensor_product(const void* a, const void* b, void* d, void* lin,
                                     void* scratch, const void* tw, const void* consts, int B,
                                     int size_a, int size_b, int conv_size, int dnum, int kr,
                                     int ka, int P, int logn, int smem, void* ws, int srows,
                                     int grid, void* stamps, void* stream) {
  const bool staged = ws != nullptr;
  if (staged && stamps != nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = stamps != nullptr ? tensor_product_kernel<false, true>
                      : staged          ? tensor_product_kernel<true>
                                        : tensor_product_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(staged ? grid : B * 3), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (int64_t*)d, (int64_t*)lin, (uint32_t*)scratch,
      (const int32_t*)tw, (const int64_t*)consts, size_a, size_b, conv_size, dnum, kr, ka, P,
      logn, (uint32_t*)ws, srows, B * 3, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The lazy design (tensor.cuh): the arguments of poulpy_tensor_product
// without the layouts'; tw: the Shoup twiddles [2][P][N] uint2
// (backends/ntt.py shoup_tables); scratch: [slots][P][pairs·conv_size][N]
// 32-bit words for the tasks whose primes run in passes (the first `slots`
// tasks), or null; pairs (1 or 3), srows (shared rows) and smem from
// backends/fused.py tensor_lazy_layout.  stamps: null, or [tasks][4] int64
// for the stage clock.  Returns the cudaError_t of the launch.
extern "C" int poulpy_tensor_product_lazy(const void* a, const void* b, void* d, void* lin,
                                          void* scratch, const void* tw, const void* consts,
                                          int B, int size_a, int size_b, int conv_size, int dnum,
                                          int kr, int ka, int P, int logn, int pairs, int srows,
                                          int smem, void* stamps, void* stream) {
  const TensorArgs g{(const int64_t*)a, (const int64_t*)b, (int64_t*)d, (int64_t*)lin,
                     (const uint2*)tw, (const int64_t*)consts, (uint32_t*)scratch,
                     (long long*)stamps, B, size_a, size_b, conv_size, dnum, conv_size, kr, ka,
                     0, P, logn, pairs, srows};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_tensor_shape<TensorShape>(g)) return launch_lazy_tensor<TensorShape, false>(g, smem, st);
  return launch_lazy_tensor<TsRuntime, false>(g, smem, st);
}
