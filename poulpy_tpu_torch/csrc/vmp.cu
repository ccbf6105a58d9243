// Vector-matrix product in the NTT domain:
//   out[b, m, p, n] = Σ_k a[b, k, p, n] · pm[k, m, p, n] · R^{-1} mod p
// on int32 residues, pm in Montgomery form (R = 2^30).
//
// Replaces: poulpy_tpu/backends/pallas_vmp.py, _vmp_fn -> _vmp_kernel
// (entry pallas_vmp_apply).  Plain twin: poulpy_tpu_torch/backends/vmp.py
// vmp_apply_ref.
//
// What bounds it on the H100: HBM traffic.  Each output word needs K words of
// `a` and K of `pm` (2·K·4 + 4 bytes) against K 64-bit multiply-adds and one
// reduction, far below the card's operations-per-byte balance.
// Design: one thread per output (b, m, p, n), consecutive threads on
// consecutive n so every load and store is coalesced; `pm` is small and stays
// in L2, and the M threads that share an `a` word hit it in L1/L2.  Products
// are summed in u64 and reduced once (mac_guard folds mod p only if the sum
// reaches 2^63, which K·p^2 with p < 2^28 and K ≤ 6 never does, but the
// 30-bit basis with large K could), so the output is the canonical residue
// the plain version returns.
#include "modarith.cuh"

namespace {

using namespace poulpy;

__global__ void __launch_bounds__(256) vmp_kernel(const int32_t* __restrict__ a,
                                                  const int32_t* __restrict__ pm,
                                                  int32_t* __restrict__ out,
                                                  const int64_t* __restrict__ consts,
                                                  int64_t total, int K, int M, int P, int logn) {
  const int64_t pn_size = (int64_t)P << logn;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t pn = idx % pn_size;  // prime·N + coefficient
    const int64_t bm = idx / pn_size;
    const int m = (int)(bm % M);
    const int64_t b = bm / M;
    const int pi = (int)(pn >> logn);
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    const int32_t* ak = a + b * K * pn_size + pn;
    const int32_t* pk = pm + (int64_t)m * pn_size + pn;
    uint64_t acc = 0;
    for (int k = 0; k < K; ++k) {
      acc = mac_guard(acc, (uint32_t)__ldg(ak + k * pn_size),
                      (uint32_t)__ldg(pk + (int64_t)k * M * pn_size), p);
    }
    out[idx] = (int32_t)fold_redc(acc, p, qinv);
  }
}

}  // namespace

// a: [B, K, P, N], pm: [K, M, P, N], out: [B, M, P, N], all int32; consts:
// backends/ntt.py kernel_tables.  Returns the cudaError_t of the launch.
extern "C" int poulpy_vmp(const void* a, const void* pm, void* out, const void* consts, int B,
                          int K, int M, int P, int n, void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const int64_t total = (int64_t)B * M * P * n;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  vmp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)pm, (int32_t*)out, (const int64_t*)consts, total, K, M, P,
      logn);
  return (int)cudaGetLastError();
}
