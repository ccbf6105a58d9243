// Wide fused rank-1 tensor product, one launch for a batch: for ciphertexts
// a = (a0, a1), b = (b0, b1) of int64 limbs [B, 2, size_a | size_b, N], the limb
// convolutions (a0·b0, a0·b1 + a1·b0, a1·b1) of conv_size limbs each, lifted
// to 128 bits, then
//   d   = big_normalize_wide(a1·b1, dnum limbs at base 2^kr, offset)    [B, dnum, N]
//   lin = big_normalize_wide(pair c, lin_size limbs at 2^ka, offset)     [B, 2, lin_size, N]
// (the quadratic term as the relinearization's gadget digits, the linear terms
// as the limbs added to its exit; offset is CKKS mul's landing shift).
//
// Replaces: poulpy_tpu/backends/pallas_wide.py, _tensor_wide_fn ->
// _kernel_tensor_wide via fused_tensor_product_wide (caller: ckks/ops.py mul,
// wide rank-1 route).  Plain twin: poulpy_tpu_torch/backends/wide.py
// fused_tensor_product_wide_ref (glwe_tensor_product_big(wide=True) and the two
// normalizations).
//
// What bounds it on the H100: not HBM.  A ciphertext pair moves (2·size_a +
// 2·size_b)·N·8 bytes in and (dnum + 2·lin_size)·N·8 out (128 KB at the CKKS
// mul shape), against (2·size_a + 2·size_b)·P forward and 3·conv_size·P
// inverse NTT rows, 4·size_a·size_b·P·N multiply-adds and a 128-bit Garner
// lift of 3·conv_size·N values.  As in wide_product.cu, the TPU kernel's i32
// workarounds are gone: any int64 limb enters through a signed 64-bit %, the
// lift and the windows use a native __int128.
// Design: all three pairs of one ciphertext in one block would hold 8 input
// rows and 3·conv_size·P = 45 output rows at the mul shape (N 2048, P 5), about
// 434 KB of shared memory.  So a block takes one (ciphertext, pair): the input
// columns that pair reads (both for a0·b1 + a1·b0, one otherwise) NTT'd per
// prime, then conv_size rows per prime kept for the lift: 4·N·(2·size_a +
// 2·size_b + P·conv_size) bytes at most, 188,416 at the mul shape.  The three
// blocks of a ciphertext are independent: the linear-pair blocks write `lin`,
// the quadratic block writes `d`.  Convolution sums of 64-bit products of
// standard residues are folded mod p before they can reach 2^63 (mac_guard, as
// the VMP), so no count of terms can overflow, and reduced once.  Where a
// pair's rows do not fit (376,832 B at the CKKS-wide mul at N 4096), the
// STAGED instance keeps them in a global workspace and passes each transform
// through shared memory srows rows at a time (modarith.cuh, global layout).
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// STAGED: the global layout (modarith.cuh), the block's rows in its
// workspace slot.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) wide_tensor_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ d,
    int64_t* __restrict__ lin, const int32_t* __restrict__ tw,
    const int64_t* __restrict__ consts, int size_a, int size_b, int conv_size, int dnum,
    int lin_size, int kr, int ka, int offset, int P, int logn, uint32_t* __restrict__ ws,
    int srows, int tasks) {
  extern __shared__ uint32_t smem[];
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
    uint32_t* ys = xa + (size_t)in_rows * n;                  // [P][conv_size][n]
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
          [&](uint32_t* buf, int nr) { ntt_fwd_rows(buf, nr, logn, tw + (size_t)pi * n, p, qinv); });
      transform_rows<STAGED>(
          ys + (size_t)pi * conv_size * n, conv_size, smem, srows, logn,
          [&](uint32_t* buf, int r0, int nr) {
            for (int coef = threadIdx.x; coef < n; coef += blockDim.x)
              pair_conv<false>(buf, xa, xb, pair, size_a, size_b, r0, r0 + nr, logn, coef, p);
            __syncthreads();
          },
          [&](uint32_t* buf, int nr) {
            ntt_inv_rows(buf, nr, logn, tw + (size_t)(P + pi) * n, p, qinv);
          });
    }

    for (int coef = threadIdx.x; coef < n; coef += blockDim.x) {
      if (pair == 2) {
        lift_add_normalize_wide(ys, P, conv_size, logn, 0, conv_size, coef, nullptr, 0,
                                d + ct * dnum * n + coef, dnum, kr, ka, offset, consts);
      } else {
        lift_add_normalize_wide(ys, P, conv_size, logn, 0, conv_size, coef, nullptr, 0,
                                lin + (ct * 2 + pair) * lin_size * n + coef, lin_size, ka, ka,
                                offset, consts);
      }
    }
  });
}

}  // namespace

// a: [B, 2, size_a, N], b: [B, 2, size_b, N] int64; d: [B, dnum, N], lin: [B, 2,
// lin_size, N] int64; tw, consts: backends/ntt.py kernel_tables; smem: the
// layout's shared memory (backends/wide.py tensor_wide_layout).  ws: null for
// the shared layout (a block per ciphertext and pair), else the global
// layout's workspace of `grid` slots of 2·(size_a + size_b) + P·conv_size
// rows of N words, srows rows staged at a time.  Returns the cudaError_t of
// the launch.
extern "C" int poulpy_wide_tensor(const void* a, const void* b, void* d, void* lin,
                                  const void* tw, const void* consts, int B, int size_a,
                                  int size_b, int conv_size, int dnum, int lin_size, int kr,
                                  int ka, int offset, int P, int logn, int smem, void* ws,
                                  int srows, int grid, void* stream) {
  const bool staged = ws != nullptr;
  const auto kernel = staged ? wide_tensor_kernel<true> : wide_tensor_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(staged ? grid : B * 3), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (int64_t*)d, (int64_t*)lin, (const int32_t*)tw,
      (const int64_t*)consts, size_a, size_b, conv_size, dnum, lin_size, kr, ka, offset, P, logn,
      (uint32_t*)ws, srows, B * 3);
  return (int)cudaGetLastError();
}
