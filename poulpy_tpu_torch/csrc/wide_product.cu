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
// pairs and lazy-prime digit products are Mosaic workarounds: here the entry
// reduces any int64 limb with a signed 64-bit %, the accumulator is a native
// __int128, and limbs are read and written as int64.
// Design: fused_product.cu's layout (the KK input rows of one prime and the M
// output rows of every prime in shared memory, all live for the Garner lift)
// needs 4·N·(KK + P·M) bytes, 262,144 at the mul shape (N 2048, KK 2, M 6,
// P 5): over the 232,448 a block may have.  So a block takes one ciphertext and a group of
// `cpb` output columns (co/cpb blocks per ciphertext, cpb the largest divisor
// of co that fits, backends/fused.py cols_per_block): 4·N·(KK + P·cpb·psize)
// bytes, 139,264 at the mul shape with cpb 1.  Each block recomputes the KK
// forward NTT rows (cheap beside the M·P inverse rows it keeps); the entry,
// NTT, VMP and inverse NTT are modarith.cuh's device functions, shared with
// fused_product.cu.  Then one thread per (column, coefficient) does the N^{-1}
// scale, the 128-bit Garner lift, the add of the sign-extended `small` limbs
// and the pair-window normalization with the landing offset.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS, 1) wide_product_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, int64_t* __restrict__ out,
    const int32_t* __restrict__ tw, const int64_t* __restrict__ consts, int ci, int size_a,
    int rmax, int co, int psize, int s_size, int res_size, int kr, int ka, int offset, int cpb,
    int P, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int kk = ci * rmax;
  const int mdim = co * psize;
  const int mrows = cpb * psize;
  const int groups = co / cpb;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * cpb;
  uint32_t* xin = smem;                      // [kk][n], one prime at a time
  uint32_t* ys = smem + (size_t)kk * n;      // [P][mrows][n]

  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    load_rows_mod_p(xin, a + b * ci * size_a * n, ci, size_a, rmax, logn, p);
    ntt_fwd_rows(xin, kk, logn, tw + (size_t)pi * n, p, qinv);
    uint32_t* y = ys + (size_t)pi * mrows * n;
    vmp_rows(y, xin, pm + (size_t)pi * kk * mdim * n, kk, mdim, c0 * psize, mrows, logn, p, qinv);
    ntt_inv_rows(y, mrows, logn, tw + (size_t)(P + pi) * n, p, qinv);
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
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery
// (backends/fused.py pm_kernel_layout / pm_kernel_layout_dsize); small: [B, co,
// s_size, N] int64 or null; out: [B, co, res_size, N] int64; tw, consts:
// backends/ntt.py kernel_tables; cpb: output columns per block (divides co);
// smem: backends/fused.py fused_smem_bytes(kk, cpb·psize, P, n).  Returns the
// cudaError_t of the launch.
extern "C" int poulpy_wide_product(const void* a, const void* pm, const void* small, void* out,
                                   const void* tw, const void* consts, int B, int ci, int size_a,
                                   int rmax, int co, int psize, int s_size, int res_size, int kr,
                                   int ka, int offset, int cpb, int P, int logn, int smem,
                                   void* stream) {
  cudaError_t e = cudaFuncSetAttribute(wide_product_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wide_product_kernel<<<(unsigned)B * (unsigned)(co / cpb), THREADS, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (int64_t*)out,
      (const int32_t*)tw, (const int64_t*)consts, ci, size_a, rmax, co, psize, s_size, res_size,
      kr, ka, offset, cpb, P, logn);
  return (int)cudaGetLastError();
}
