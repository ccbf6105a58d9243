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
// wide_tensor.cu; the two share the entry, both NTTs, the pair convolution and
// the lift of modarith.cuh.
//
// What bounds it on the H100: not HBM.  A ciphertext pair moves (2·size_a +
// 2·size_b)·N·8 bytes in and (dnum + 2·conv_size)·N·8 out (about 0.4 MB at the
// relinearize path's shape: N 2048, 6 + 6 limbs, conv 11, dnum 6, P 2),
// against (size_a + size_b)·2·P·2 forward NTT rows (the cross pair reads both
// columns), 3·conv_size·P inverse rows, 4·size_a·size_b·P·N multiply-adds and
// a Garner lift of 3·conv_size·N values.  The TPU kernel's i32 workarounds
// are gone: any int64 limb enters through a signed 64-bit % (no |x| < 2^29,
// no lazy-prime entry), the products of standard residues are summed in u64
// folded at 2^63 (no 30×28 digit pairs, no _redc64_pair, no cnt ≤ 16 rule), the
// lift is the native 64-bit Garner.
// Design: wide_tensor.cu's layout (every input row a pair reads plus P·conv
// output rows in shared memory) needs 4·N·(2·(6 + 6) + 2·11) = 376,832 B at the
// path's shape, over the 232,448 a block may have.  Here a block takes one
// (ciphertext, pair) and runs the primes one after another in one workspace
// of max(2·(size_a + size_b), conv_size) rows (196,608 B at the path's shape):
// the columns the pair reads, NTT'd; the convolution written in place over
// them (each thread owns whole coefficients, pair_conv); the inverse NTT of
// the conv_size rows; those rows copied to a global scratch [B·3, P, conv, N]
// u32.  After the last prime the block lifts its coefficients from the
// scratch (written by the block itself, visible after the barrier): the
// quadratic block normalizes to d, the linear blocks write raw limbs.  The
// scratch costs 2·3·P·conv·N·4 bytes of L2/HBM traffic per pair (0.5 MB at
// the path's shape) and keeps every block's shared memory within one SM.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS, 1) tensor_product_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ d,
    int64_t* __restrict__ lin, uint32_t* scratch, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int size_a, int size_b, int conv_size, int dnum, int kr,
    int ka, int P, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int64_t ct = blockIdx.x / 3;
  const int pair = blockIdx.x % 3;          // 0: a0·b0, 1: a0·b1 + a1·b0, 2: a1·b1
  const int col0 = pair == 2 ? 1 : 0;       // first input column the pair reads
  const int ncols = pair == 1 ? 2 : 1;
  uint32_t* xa = smem;                                      // [ncols][size_a][n]
  uint32_t* xb = xa + (size_t)ncols * size_a * n;           // [ncols][size_b][n]
  uint32_t* res = scratch + (size_t)blockIdx.x * P * conv_size * n;   // [P][conv][n]

  for (int pi = 0; pi < P; ++pi) {
    const int64_t* c = consts + pi * CONSTS_PER_PRIME;
    const uint32_t p = (uint32_t)c[C_P];
    const uint32_t qinv = (uint32_t)c[C_QINV];
    load_rows_mod_p(xa, a + ((ct * 2 + col0) * size_a) * n, ncols, size_a, size_a, logn, p);
    load_rows_mod_p(xb, b + ((ct * 2 + col0) * size_b) * n, ncols, size_b, size_b, logn, p);
    ntt_fwd_rows(xa, ncols * (size_a + size_b), logn, tw + (size_t)pi * n, p, qinv);
    for (int coef = threadIdx.x; coef < n; coef += blockDim.x)
      pair_conv<true>(smem, xa, xb, pair, size_a, size_b, 0, conv_size, logn, coef, p);
    __syncthreads();
    ntt_inv_rows(smem, conv_size, logn, tw + (size_t)(P + pi) * n, p, qinv);
    uint32_t* rp = res + (size_t)pi * conv_size * n;
    for (int idx = threadIdx.x; idx < (conv_size << logn); idx += blockDim.x) rp[idx] = smem[idx];
    __syncthreads();                        // the workspace is reloaded; the scratch is read
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
}

}  // namespace

// a: [B, 2, size_a, N], b: [B, 2, size_b, N] int64; d: [B, dnum, N], lin: [B, 2,
// conv_size, N] int64; scratch: [B·3, P, conv_size, N] 32-bit words; tw,
// consts: backends/ntt.py kernel_tables; smem: backends/fused.py
// tensor_smem_bytes.  Returns the cudaError_t of the launch.
extern "C" int poulpy_tensor_product(const void* a, const void* b, void* d, void* lin,
                                     void* scratch, const void* tw, const void* consts, int B,
                                     int size_a, int size_b, int conv_size, int dnum, int kr,
                                     int ka, int P, int logn, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(tensor_product_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tensor_product_kernel<<<(unsigned)B * 3u, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (int64_t*)d, (int64_t*)lin, (uint32_t*)scratch,
      (const int32_t*)tw, (const int64_t*)consts, size_a, size_b, conv_size, dnum, kr, ka, P,
      logn);
  return (int)cudaGetLastError();
}
