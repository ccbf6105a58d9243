// One block-binary CGGI blind-rotation step for a batch, one launch:
//   acc <- normalize(acc + idft(sum_i NTT(X^{a_i} - 1) * (dft(acc) [x] BRK_i)))
// from int64 limbs [B, cols, size, N] to normalized int64 limbs [B, cols, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe via
// fused_br_block_step (block > 1, rotate, add_acc; caller
// blind_rotation.py:475).  Its rot_mode 0/1/2 and `steps` variants are one
// computation placed differently on the TPU; this kernel computes it once.
// Plain twin: poulpy_tpu_torch/backends/fused.py fused_br_block_step_ref (the
// jnp block_step of blind_rotation.py:532-550).
//
// What bounds it on the H100: operations, not HBM.  A ciphertext moves
// cols·size·N·8 bytes in and out (32 KB each way at the gate shape), but the
// work per ciphertext is KK·P forward and M·P inverse NTT rows, block·KK·M·P·N
// multiply-adds against the block's key elements and block·M·P·N products by
// the x-power factor: about 0.8 M modular products at the gate shape
// (N 1024, KK 4, M 8, P 2, block 8) against 64 KB of traffic.  The key
// elements of the block (4·block·P·KK·M·N bytes, 2 MB at the gate shape) are
// read by every block from L2, and the x-power rows (4·N bytes per prime and
// key element) from device memory.
// Design: one block per ciphertext (512 threads), as fused_product.cu, whose
// entry and exit it shares.  Shared memory holds the KK input rows of one
// prime and the M output rows of every prime, 4·N·(KK + P·M) bytes (81,920 at
// the gate shape).  Per prime: reduce the acc limbs to [0, p) and NTT them;
// then each thread owns one (output row, coefficient) and, for each key
// element i, sums the KK products with BRK_i in u64, reduces once, and
// multiplies by the Montgomery NTT(X^{a_i} - 1) gathered from the [2N, P, N]
// table at row a_i & (2N - 1), adding into a residue it keeps in a register:
// the block's sum never leaves the thread, and no [B, block, P, N] gather is
// materialized.  Inverse NTT of the M rows, then the Garner lift, the
// wrapping add of the input acc limbs (column c, limb j < min(size, psize))
// and the bit-window normalization, as in fused_product.cu.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS, 1) br_block_step_kernel(
    const int64_t* __restrict__ acc, const int32_t* __restrict__ pm,
    const int32_t* __restrict__ xpm1, const int64_t* __restrict__ amounts,
    int64_t* __restrict__ out, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int cols, int size, int rmax, int psize, int res_size,
    int kr, int block, int P, int logn) {
  extern __shared__ uint32_t smem[];
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
    ntt_fwd_rows(xin, kk, logn, tw + (size_t)pi * n, p, qinv);

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
    ntt_inv_rows(y, mdim, logn, tw + (size_t)(P + pi) * n, p, qinv);
  }

  const int add_size = size < psize ? size : psize;
  for (int idx = threadIdx.x; idx < (cols << logn); idx += blockDim.x) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    lift_add_normalize(ys, P, mdim, logn, col, psize, coef, ab + (int64_t)col * size * n + coef,
                       add_size, psize, out + ((b * cols + col) * res_size) * n + coef, res_size,
                       kr, kr, consts);
  }
}

}  // namespace

// acc: [B, cols, size, N] int64; pm: [block, P, cols·rmax, cols·psize, N]
// int32 Montgomery (backends/fused.py pm_kernel_layout of the block's key
// elements); xpm1: [2N, P, N] int32 Montgomery NTT(X^j - 1); amounts: [B,
// block] int64; out: [B, cols, res_size, N] int64 (not aliasing acc); tw,
// consts: backends/ntt.py kernel_tables; smem: backends/fused.py
// fused_smem_bytes.  Returns the cudaError_t of the launch.
extern "C" int poulpy_br_block_step(const void* acc, const void* pm, const void* xpm1,
                                    const void* amounts, void* out, const void* tw,
                                    const void* consts, int B, int cols, int size, int rmax,
                                    int psize, int res_size, int kr, int block, int P, int logn,
                                    int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(br_block_step_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  br_block_step_kernel<<<(unsigned)B, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int32_t*)pm, (const int32_t*)xpm1, (const int64_t*)amounts,
      (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, cols, size, rmax, psize,
      res_size, kr, block, P, logn);
  return (int)cudaGetLastError();
}
