// Fused GLWE x GGSW external product, one launch for a batch:
//   out = big_normalize(idft(vmp(dft(a), pm)))
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe via
// fused_glwe_product, the product call pattern only (block = 1, no rotate, no
// small, no small64).  Plain twin: poulpy_tpu_torch/backends/fused.py
// fused_glwe_product_ref (the stage chain of core/external_product.py).
//
// What bounds it on the H100: not HBM.  A ciphertext moves 2·ci·size_a·N·8
// bytes in and co·res_size·N·8 out, while the work is (KK + M)·P NTTs of N
// points plus KK·M·P·N multiply-adds against the prepared matrix (4·P·KK·M·N
// bytes, read by every block from L2).  The limits are shared-memory
// capacity, which sets how many blocks an SM holds, the block barriers of the
// NTT stages, and the L2 reads of the matrix.
// Design: one block per ciphertext (512 threads).  Shared memory holds the KK
// input rows of one prime at a time and the M output rows of every prime,
// because Garner needs all primes of a coefficient at once:
//   4·N·(KK + P·M) bytes,
// which at the headline shape (N 2048, KK 6, M 8, P 2) leaves room for one
// block per SM.  The alternative, one block per (ciphertext,
// output column), would halve that at the price of repeating the forward NTT
// once per column; it is left for a measured later change.  Per prime: reduce
// the limbs to [0, p) (any int64 is accepted, so |x| < 2^29 is not a
// precondition), forward NTT of the KK rows, VMP with u64 sums and one
// reduction, inverse NTT of the M rows.  Then one thread per (column,
// coefficient) does the N^{-1} scale, the Garner lift in native u64 and the
// bit-window normalization of hal/normalization.py, including its same-base
// same-size schedule.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS, 1) fused_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm, int64_t* __restrict__ out,
    const int32_t* __restrict__ tw, const int64_t* __restrict__ consts, int ci, int size_a,
    int rmax, int co, int psize, int res_size, int kr, int ka, int P, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int kk = ci * rmax;
  const int mdim = co * psize;
  uint32_t* xin = smem;                      // [kk][n], one prime at a time
  uint32_t* ys = smem + (size_t)kk * n;      // [P][mdim][n]
  const int64_t b = blockIdx.x;
  const int64_t* ab = a + b * ci * size_a * n;

  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    for (int idx = threadIdx.x; idx < (kk << logn); idx += blockDim.x) {
      const int k = idx >> logn;
      const int col = k / rmax;
      const int l = k - col * rmax;
      const int64_t v = ab[((int64_t)col * size_a + l) * n + (idx & (n - 1))] % (int64_t)p;
      xin[idx] = (uint32_t)(v < 0 ? v + p : v);
    }
    __syncthreads();
    ntt_fwd_rows(xin, kk, logn, tw + (size_t)pi * n, p, qinv);

    uint32_t* y = ys + (size_t)pi * mdim * n;
    const int32_t* pmp = pm + (size_t)pi * kk * mdim * n;
    for (int idx = threadIdx.x; idx < (mdim << logn); idx += blockDim.x) {
      const int m = idx >> logn;
      const int coef = idx & (n - 1);
      uint64_t acc = 0;
      for (int k = 0; k < kk; ++k) {
        acc = mac_guard(acc, xin[(k << logn) + coef],
                        (uint32_t)__ldg(pmp + ((size_t)k * mdim + m) * n + coef), p);
      }
      y[idx] = fold_redc(acc, p, qinv);
    }
    __syncthreads();
    ntt_inv_rows(y, mdim, logn, tw + (size_t)(P + pi) * n, p, qinv);
  }

  for (int idx = threadIdx.x; idx < (co << logn); idx += blockDim.x) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    int64_t big[MAX_LIMBS];
    for (int j = 0; j < psize; ++j) {
      uint32_t r[MAX_PRIMES];
      for (int pi = 0; pi < P; ++pi) {
        const int64_t* c = consts + pi * CONSTS_PER_PRIME;
        const uint32_t yv = ys[((size_t)pi * mdim + col * psize + j) * n + coef];
        r[pi] = mont_mul(yv, (uint32_t)c[C_NINV], (uint32_t)c[C_P], (uint32_t)c[C_QINV]);
      }
      big[j] = garner(r, P, consts);
    }
    int64_t res[MAX_LIMBS];
    normalize_full(big, psize, res, res_size, kr, ka);
    int64_t* o = out + ((b * co + col) * res_size) * n + coef;
    for (int i = 0; i < res_size; ++i) o[(int64_t)i * n] = res[i];
  }
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery
// (backends/fused.py pm_kernel_layout); out: [B, co, res_size, N] int64;
// tw, consts: backends/ntt.py kernel_tables; smem: backends/fused.py
// fused_smem_bytes.  Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_product(const void* a, const void* pm, void* out, const void* tw,
                                    const void* consts, int B, int ci, int size_a, int rmax,
                                    int co, int psize, int res_size, int kr, int ka, int P,
                                    int logn, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_product_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fused_product_kernel<<<(unsigned)B, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (int64_t*)out, (const int32_t*)tw,
      (const int64_t*)consts, ci, size_a, rmax, co, psize, res_size, kr, ka, P, logn);
  return (int)cudaGetLastError();
}
