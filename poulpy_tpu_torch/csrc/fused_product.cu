// Fused GLWE x GGSW / GLWE x GGLWE product, one launch for a batch:
//   out = big_normalize(idft(vmp(dft(a), pm)) [+ small at column 0])
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe via
// fused_glwe_product, two call patterns: the product (block = 1, no rotate,
// no small, no small64) and the keyswitch (the same with `small`, the body
// limbs added to column 0 of the big accumulator before the normalization,
// pallas_fused.py:823-827; caller keyswitching.py:131).  Plain twin:
// poulpy_tpu_torch/backends/fused.py fused_glwe_product_ref.
//
// What bounds it on the H100: not HBM.  A ciphertext moves 2·ci·size_a·N·8
// bytes in (+ s_size·N·8 of body) and co·res_size·N·8 out, while the work is
// (KK + M)·P NTTs of N points plus KK·M·P·N multiply-adds against the
// prepared matrix (4·P·KK·M·N bytes, read by every block from L2).  The
// limits are shared-memory capacity, which sets how many blocks an SM holds,
// the block barriers of the NTT stages, and the L2 reads of the matrix.
// Design: one block per ciphertext (512 threads).  Shared memory holds the KK
// input rows of one prime at a time and the M output rows of every prime,
// because Garner needs all primes of a coefficient at once:
//   4·N·(KK + P·M) bytes,
// which at the headline shape (N 2048, KK 6, M 8, P 2) leaves room for one
// block per SM; the gate keyswitch (N 1024, KK 2, M 6) takes 57,344.  Per
// prime: reduce the limbs to [0, p) (any int64 is accepted, so |x| < 2^29 is
// not a precondition), forward NTT of the KK rows, VMP with u64 sums and one
// reduction, inverse NTT of the M rows.  Then one thread per (column,
// coefficient) does the N^{-1} scale, the Garner lift in native u64, the
// wrapping add of the body limbs (column 0, limb j < min(s_size, psize)) and
// the bit-window normalization of hal/normalization.py.  The body add costs
// one predicated load per limb, so the two patterns share one kernel.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS, 1) fused_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, int64_t* __restrict__ out,
    const int32_t* __restrict__ tw, const int64_t* __restrict__ consts, int ci, int size_a,
    int rmax, int co, int psize, int s_size, int res_size, int kr, int ka, int P, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int kk = ci * rmax;
  const int mdim = co * psize;
  uint32_t* xin = smem;                      // [kk][n], one prime at a time
  uint32_t* ys = smem + (size_t)kk * n;      // [P][mdim][n]
  const int64_t b = blockIdx.x;

  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    load_rows_mod_p(xin, a + b * ci * size_a * n, ci, size_a, rmax, logn, p);
    ntt_fwd_rows(xin, kk, logn, tw + (size_t)pi * n, p, qinv);

    uint32_t* y = ys + (size_t)pi * mdim * n;
    vmp_rows(y, xin, pm + (size_t)pi * kk * mdim * n, kk, mdim, 0, mdim, logn, p, qinv);
    ntt_inv_rows(y, mdim, logn, tw + (size_t)(P + pi) * n, p, qinv);
  }

  const int add_size = s_size < psize ? s_size : psize;
  for (int idx = threadIdx.x; idx < (co << logn); idx += blockDim.x) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    const bool body = small != nullptr && col == 0;
    const int64_t* add = body ? small + (b * s_size) * n + coef : nullptr;
    lift_add_normalize(ys, P, mdim, logn, col, psize, coef, add, body ? add_size : 0,
                       out + ((b * co + col) * res_size) * n + coef, res_size, kr, ka, consts);
  }
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery
// (backends/fused.py pm_kernel_layout); small: [B, s_size, N] int64 or null
// with s_size 0; out: [B, co, res_size, N] int64; tw, consts: backends/ntt.py
// kernel_tables; smem: backends/fused.py fused_smem_bytes.  Returns the
// cudaError_t of the launch.
extern "C" int poulpy_fused_product(const void* a, const void* pm, const void* small, void* out,
                                    const void* tw, const void* consts, int B, int ci,
                                    int size_a, int rmax, int co, int psize, int s_size,
                                    int res_size, int kr, int ka, int P, int logn, int smem,
                                    void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_product_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fused_product_kernel<<<(unsigned)B, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (int64_t*)out,
      (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co, psize, s_size, res_size,
      kr, ka, P, logn);
  return (int)cudaGetLastError();
}
