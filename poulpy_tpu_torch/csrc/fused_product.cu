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
// by every block from L2).  The limits are shared-memory capacity, which sets
// how many blocks an SM holds, the block barriers of the NTT stages, and the
// L2 reads of the matrix.
// Design: one block (512 threads) per ciphertext and group of `cpb` output
// columns (co/cpb blocks per ciphertext, cpb the largest divisor of co whose
// rows fit, backends/fused.py product_layout).  Shared memory holds the KK
// input rows of one prime at a time and the cpb·psize output rows of every
// prime, because Garner needs all primes of a coefficient at once:
//   4·N·(KK + P·cpb·psize) bytes.
// Where the whole of co fits (the headline shape, N 2048, KK 6, M 8, P 2, and
// the gate keyswitch, N 1024, KK 2, M 6) cpb = co and a ciphertext is one
// block.  At the CKKS keyswitch and relinearization (N 2048, KK 6, co 2,
// psize 6, P 2) all of co needs 245,760 B, over the 232,448 a block may have:
// cpb = 1 (147,456 B), and each column block NTTs the KK input rows itself.
// Where one column does not fit either (bench.py's shape at N 8192 needs
// 458,752 B), the STAGED instance takes the global layout of modarith.cuh:
// the KK input rows and the P·co·psize output rows live in a global
// workspace slot of the block, and each transform passes through shared
// memory srows rows at a time (7 at N 8192), the VMP reading the input rows
// from L2.
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

// S64: the small64 pattern.  Without it ext = psize is known to the compiler,
// and the exit compiles to the plain lift of psize limbs.  STAGED: the global
// layout (modarith.cuh), the block's rows in its workspace slot.
template <bool S64, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) fused_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, const int64_t* __restrict__ small64,
    int64_t* __restrict__ out, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int ci, int size_a, int rmax, int co, int psize,
    int s_size, int s64, int res_size, int kr, int ka, int cpb, int P, int logn,
    uint32_t* __restrict__ ws, int srows, int tasks) {
  extern __shared__ uint32_t smem[];
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
          },
          [&](uint32_t* buf, int nr) { ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv); });
      transform_rows<STAGED>(
          ys + (size_t)pi * mrows * n, mrows, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            vmp_rows(buf, xin, pm + (size_t)pi * kk * mdim * n, kk, mdim, c0 * psize + r0, nr,
                     logn, p, qinv);
          },
          [&](uint32_t* buf, int nr) {
            ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
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
  });
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
                                    int srows, int grid, void* stream) {
  const bool staged = ws != nullptr;
  const auto kernel = small64 != nullptr
                          ? (staged ? fused_product_kernel<true, true> : fused_product_kernel<true, false>)
                          : (staged ? fused_product_kernel<false, true> : fused_product_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tasks = B * (co / cpb);
  kernel<<<(unsigned)(staged ? grid : tasks), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (const int64_t*)small64,
      (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co, psize,
      s_size, s64, res_size, kr, ka, cpb, P, logn, (uint32_t*)ws, srows, tasks);
  return (int)cudaGetLastError();
}
