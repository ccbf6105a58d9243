// The big-accumulator exit on its own: coefficient residues → Garner CRT lift
// to wrapping int64 → + small at column 0 → bit-window normalization,
//   x [B, co, psize, P, N] int32 (canonical, N^{-1} already applied)
//   → out [B, co, res_size, N] int64 limbs of base 2^res_base2k.
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _kernel_b_fn -> _kernel_b
// (caller mxu_product.py, the tail of the "mxu" route).  The JAX layout
// [P, B·co·psize, N] with the body spread to per-(b, co) rows is a TPU layout;
// only the output has to match.  Plain twin: poulpy_tpu_torch/backends/fused.py
// garner_exit_ref.
//
// What bounds it on the H100: HBM.  A coefficient reads psize·P·4 bytes (+
// s_size·8 of body at column 0) and writes res_size·8, against P² modular
// products of the lift per limb.
// Design: one thread per (ciphertext, column, coefficient), consecutive
// threads on consecutive coefficients so every load and store is coalesced;
// the lift (modarith.cuh garner), the wrapping add and normalize_full in
// registers and local memory.
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) garner_exit_kernel(
    const int32_t* __restrict__ x, const int64_t* __restrict__ small, int64_t* __restrict__ out,
    const int64_t* __restrict__ consts, int64_t total, int co, int psize, int s_size,
    int res_size, int kr, int ka, int P, int logn) {
  const int n = 1 << logn;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int coef = (int)(idx & (n - 1));
    const int64_t bc = idx >> logn;                  // b·co + col
    const bool body = small != nullptr && bc % co == 0;
    const int64_t b = bc / co;
    int64_t big[MAX_LIMBS];
    for (int j = 0; j < psize; ++j) {
      uint32_t r[MAX_PRIMES];
      for (int pi = 0; pi < P; ++pi)
        r[pi] = (uint32_t)x[(((bc * psize + j) * P + pi) << logn) + coef];
      big[j] = garner(r, P, consts);
      if (body && j < s_size) big[j] = wadd(big[j], small[((b * s_size + j) << logn) + coef]);
    }
    int64_t res[MAX_LIMBS];
    normalize_full(big, psize, res, res_size, kr, ka);
    for (int i = 0; i < res_size; ++i) out[((bc * res_size + i) << logn) + coef] = res[i];
  }
}

}  // namespace

// x: [B, co, psize, P, N] int32; small: [B, s_size, N] int64 or null with
// s_size 0; out: [B, co, res_size, N] int64; consts: backends/ntt.py
// kernel_tables.  Returns the cudaError_t of the launch.
extern "C" int poulpy_garner_exit(const void* x, const void* small, void* out, const void* consts,
                                  int B, int co, int psize, int s_size, int res_size, int kr,
                                  int ka, int P, int logn, void* stream) {
  const int64_t total = ((int64_t)B * co) << logn;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  garner_exit_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int64_t*)small, (int64_t*)out, (const int64_t*)consts, total, co,
      psize, s_size, res_size, kr, ka, P, logn);
  return (int)cudaGetLastError();
}
