// Negacyclic NTT and inverse NTT on [rows, P, N] int32 residues.
//
// Replaces: poulpy_tpu/backends/pallas_ntt.py, ntt_fn -> _ntt_kernel /
// _ntt_kernel_paired (entries pallas_ntt_forward / pallas_ntt_inverse).
// Plain twin: poulpy_tpu_torch/hal/ntt.py ntt_forward / ntt_inverse.
//
// What bounds it on the H100: each (row, prime) reads and writes its N words
// of HBM once (8 bytes per coefficient); the log N stages in between run out
// of shared memory, so the kernel is bound by shared-memory traffic and the
// log N block barriers, not by HBM.
// Design: one thread block per (row, prime), the row in shared memory (4·N
// bytes), N/2 threads (at most 1024) doing one butterfly each per stage,
// one __syncthreads() between stages.  Twiddles are the host tables of
// hal/ntt.py _host_tables, read through the read-only cache.  Butterflies are
// exact Montgomery products (R = 2^30) with canonical outputs, so the result
// equals the plain version's bit for bit.
#include "modarith.cuh"

namespace {

using namespace poulpy;

__global__ void __launch_bounds__(1024) ntt_kernel(const int32_t* __restrict__ x,
                                                   int32_t* __restrict__ y,
                                                   const int32_t* __restrict__ tw,
                                                   const int64_t* __restrict__ consts,
                                                   int nprimes, int logn, int inverse) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;  // row·P + prime
  const int pi = (int)(row % nprimes);
  const int64_t* c = consts + pi * CONSTS_PER_PRIME;
  const uint32_t p = (uint32_t)c[C_P];
  const uint32_t qinv = (uint32_t)c[C_QINV];
  const int32_t* src = x + row * n;
  int32_t* dst = y + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = (uint32_t)src[i];
  __syncthreads();
  if (!inverse) {
    ntt_fwd_rows(buf, 1, logn, tw + (size_t)pi * n, p, qinv);
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int32_t)buf[i];
  } else {
    ntt_inv_rows(buf, 1, logn, tw + (size_t)(nprimes + pi) * n, p, qinv);
    const uint32_t ninv = (uint32_t)c[C_NINV];
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int32_t)mont_mul(buf[i], ninv, p, qinv);
  }
}

}  // namespace

// x, y: [rows, P, N] int32 (y may not alias x); tw: [2, P, N] int32 forward /
// inverse twiddles; consts: backends/ntt.py kernel_tables.  Returns the
// cudaError_t of the launch.
extern "C" int poulpy_ntt(const void* x, void* y, const void* tw, const void* consts, int rows,
                          int nprimes, int logn, int inverse, void* stream) {
  const int n = 1 << logn;
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ntt_kernel<<<(unsigned)rows * (unsigned)nprimes, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)y, (const int32_t*)tw, (const int64_t*)consts, nprimes, logn, inverse);
  return (int)cudaGetLastError();
}
