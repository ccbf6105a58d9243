// Four-step negacyclic NTT as int8 digit-plane products on the tensor cores:
//   forward  int64 limbs [rows, N] (wrapped to int32) → σ-order residues [rows, P, N]
//   inverse  σ-order residues [rows, P, N] → coefficient residues [rows, P, N]
//
// Replaces: poulpy_tpu/backends/pallas_mxu.py, _fwd_fn -> _kernel_fwd and
// _inv_fn -> _kernel_inv (entries pallas_mxu4_forward_limbs /
// pallas_mxu4_inverse; caller mxu_product.py).  Plain twins:
// poulpy_tpu_torch/backends/mxu.py mxu4_forward_limbs_ref / mxu4_inverse_ref.
//
// What bounds it on the H100: the int8 tensor-core rate on paper.  At N 2048
// (n1 128, n2 16) a row costs per prime [128 × 64] × [64 × 64] (step A) and
// [16 × 512] × [512 × 512] (step B) multiply-adds, 4.7 M, against 8 bytes in
// and 16 out; the weights (256 KB per prime for step B) stay in L2.
// Design (simple first): one block of 256 threads per 4 rows; shared memory
// holds the int8 operands of both steps (74,752 B at N 2048, three blocks
// per SM).  The input's digit planes are made once (they do not depend on
// the prime); per prime, step A with its epilogue (assemble, REDC², twiddle,
// the 4 digit planes of the result written transposed as step B's operand),
// then step B with its epilogue (assemble, REDC², the residue to global).
// Each warp reads a weight fragment once for up to 4 row tiles; the weights
// are re-read from L2 by every block (the next thing to cut: more rows per
// block, or weights staged through shared memory).
#include "mxu.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) mxu_forward_kernel(
    const int64_t* __restrict__ x, int32_t* __restrict__ out, const int2* __restrict__ ua_f,
    const int2* __restrict__ v0_f, const int32_t* __restrict__ tf,
    const int64_t* __restrict__ consts, int rows, int nd_in, int P, int logn, int tr) {
  extern __shared__ __align__(16) int8_t smem[];
  const Split s(logn);
  int8_t* a_op = smem;
  int8_t* b_op = smem + planes_a_bytes(s, tr);
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int nr = rows - r0 < tr ? (int)(rows - r0) : tr;
  fwd_planes(a_op, tr, nd_in, s, [&](int r, int pos) -> int32_t {
    return r < nr ? (int32_t)x[(r0 + r) * s.n + pos] : 0;
  });
  __syncthreads();
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    fwd_step_a(a_op, b_op, tr, s, ua_f + pi * s.words_a(), tf + ((size_t)pi << logn), p, qinv);
    __syncthreads();
    fwd_step_b(b_op, tr, s, v0_f + pi * s.words_b(), p, qinv, [&](int r, int pos, uint32_t y) {
      if (r < nr) out[(((r0 + r) * P + pi) << logn) + pos] = (int32_t)y;
    });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) mxu_inverse_kernel(
    const int32_t* __restrict__ y, int32_t* __restrict__ out, const int2* __restrict__ wa_f,
    const int2* __restrict__ w0_f, const int32_t* __restrict__ ti,
    const int64_t* __restrict__ consts, int rows, int P, int logn, int tr) {
  extern __shared__ __align__(16) int8_t smem[];
  const Split s(logn);
  int8_t* a_op = smem;                             // [tr·n2][lda_b]
  int8_t* b_op = smem + planes_b_bytes(s, tr);     // [tr·n1][lda_a]
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int nr = rows - r0 < tr ? (int)(rows - r0) : tr;
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    inv_planes(a_op, tr, s, [&](int r, int pos) -> int32_t {
      return r < nr ? y[(((r0 + r) * P + pi) << logn) + pos] : 0;
    });
    __syncthreads();
    inv_step_a(a_op, b_op, tr, s, wa_f + pi * s.words_b(), ti + ((size_t)pi << logn), p, qinv);
    __syncthreads();
    inv_step_b(b_op, tr, s, w0_f + pi * s.words_a(), p, qinv, [&](int r, int pos, uint32_t v) {
      if (r < nr) out[(((r0 + r) * P + pi) << logn) + pos] = (int32_t)v;
    });
    __syncthreads();
  }
}

int launch_blocks(int rows, int tr) { return (rows + tr - 1) / tr; }

}  // namespace

// x: [rows, N] int64 limbs; out: [rows, P, N] int32; ua_f, v0_f: [P, ...]
// fragment-order int8 weights (backends/mxu.py device_tables); tf: [P, n1, n2]
// int32; consts: backends/ntt.py kernel_tables; tr: rows per block (a multiple
// of 4); smem: backends/mxu.py transform_smem_bytes.  Returns the cudaError_t.
extern "C" int poulpy_mxu_forward(const void* x, void* out, const void* ua_f, const void* v0_f,
                                  const void* tf, const void* consts, int rows, int nd_in, int P,
                                  int logn, int tr, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(mxu_forward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mxu_forward_kernel<<<launch_blocks(rows, tr), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)x, (int32_t*)out, (const int2*)ua_f, (const int2*)v0_f,
      (const int32_t*)tf, (const int64_t*)consts, rows, nd_in, P, logn, tr);
  return (int)cudaGetLastError();
}

// y, out: [rows, P, N] int32; wa_f, w0_f, ti: backends/mxu.py device_tables.
extern "C" int poulpy_mxu_inverse(const void* y, void* out, const void* wa_f, const void* w0_f,
                                  const void* ti, const void* consts, int rows, int P, int logn,
                                  int tr, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(mxu_inverse_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mxu_inverse_kernel<<<launch_blocks(rows, tr), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int32_t*)y, (int32_t*)out, (const int2*)wa_f, (const int2*)w0_f,
      (const int32_t*)ti, (const int64_t*)consts, rows, P, logn, tr);
  return (int)cudaGetLastError();
}
