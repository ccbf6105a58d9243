// Vector-matrix product in the NTT domain:
//   out[b, m, p, n] = Σ_k a[b, k, p, n] · pm[k, m, p, n] · R^{-1} mod p
// on int32 residues, pm in Montgomery form (R = 2^30).
//
// Replaces: poulpy_tpu/backends/pallas_vmp.py, _vmp_fn -> _vmp_kernel
// (entry pallas_vmp_apply).  Plain twin: poulpy_tpu_torch/backends/vmp.py
// vmp_apply_ref.
//
// What bounds it on the H100: HBM traffic.  Each output word needs K words of
// `a` and K of `pm`, but `a` is shared by the M outputs of a coefficient and
// `pm` by every batch row: the least traffic is `a` read once and `out`
// written once (pm is 0.8 MB at the "mxu" route's shape), 3.76 GB at
// [16384, K 6] × [6, M 8], P 2, N 2048, against K·M 64-bit multiply-adds and
// M reductions per coefficient and row, well below the card's
// operations-per-byte balance.
//
// Two designs.
// - tile (the paths): one thread per column (prime, coefficient), 128
//   columns per block, a chunk of batch rows per block (blockIdx.y).  The
//   thread keeps its column's K·M pm words in registers (the shapes of
//   VmpShape; the runtime-shaped instance stages them in shared memory, one
//   column per thread, or past 48 KB reads them through L1), then
//   walks its rows: loads the K `a` words of the row once (neighbouring
//   threads on neighbouring words, so every load and store is coalesced),
//   forms the M sums in u64 and stores M words.  No division: the prime
//   comes from the column by a shift, the sums stay lazy (K·(p−1)² < 2^64
//   for K ≤ 16; the runtime-shaped instance folds every 8 terms, fold32) and
//   each output is reduced once by two Shoup products of its words
//   (VmpPrime::reduce: acc·2^{-30} = hi·4 + lo·2^{-30}).
// - parent (the first design, kept as the reference): one thread per output
//   word, its column and row recovered by 64-bit `/` and `%`, each `a` word
//   read by the M threads of its outputs and each pm word by every row
//   (through L1 / L2), the sum folded by mac_guard.
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

// The tile design's constants of one prime: Shoup's pairs of 4 and of
// 2^{-30} mod p (R^{-1} = (1 + p·qinv) / 2^30, qinv = −p^{-1} mod 2^30), and
// 2^32 mod p for the folds.
struct VmpPrime {
  uint32_t p, c32;
  uint2 four, rinv;
  __device__ VmpPrime(const int64_t* __restrict__ consts, int pi) {
    p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    const uint32_t r = (uint32_t)((1 + (uint64_t)p * qinv) >> 30);
    c32 = (uint32_t)((1ull << 32) % p);
    four = uint2{4u, (uint32_t)((4ull << 32) / p)};
    rinv = uint2{r, (uint32_t)(((uint64_t)r << 32) / p)};
  }
  // Canonical acc·2^{-30} mod p for any acc < 2^64: hi·4 + lo·2^{-30}.
  __device__ __forceinline__ uint32_t reduce(uint64_t acc) const {
    uint32_t u = shoup_mul((uint32_t)(acc >> 32), four, p) + shoup_mul((uint32_t)acc, rinv, p);
    u = min(u, u - 2 * p);
    return min(u, u - p);
  }
};

// The tile design's compile-time shapes (backends/vmp.py VMP_SHAPES); 0 0 is
// the runtime-shaped instance.
template <int K_, int M_>
struct VmpShape {
  static constexpr int K = K_, M = M_;
};
using RouteShape = VmpShape<6, 8>;      // the "mxu" route's product (K 6, M 8)
using KsShape = VmpShape<3, 8>;         // the "mxu" route's keyswitch (K 3, M 8)
using CkksShape = VmpShape<6, 12>;      // the non-wide CKKS mul (K 6, M 12)
using AnyShape = VmpShape<0, 0>;

constexpr int TILE_COLS = 128;          // columns (threads) per block
constexpr int STAGED_KM = 96;           // pm words per column staged in shared memory (48 KB)

template <class S>
__global__ void __launch_bounds__(TILE_COLS) vmp_tile_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ pm, int32_t* __restrict__ out,
    const int64_t* __restrict__ consts, int B, int K, int M, int logn, int cols, int rows) {
  const int col = blockIdx.x * TILE_COLS + threadIdx.x;
  if (col >= cols) return;
  const VmpPrime pk(consts, col >> logn);
  const int b0 = blockIdx.y * rows, b1 = min(B, b0 + rows);
  const uint32_t* ap = (const uint32_t*)a + col;
  const uint32_t* wp = (const uint32_t*)pm + col;
  int32_t* op = out + col;
  if constexpr (S::K != 0) {
    constexpr int KS = S::K, MS = S::M;
    uint32_t w[KS][MS];
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int m = 0; m < MS; ++m) w[k][m] = __ldg(wp + (size_t)(k * MS + m) * cols);
#pragma unroll 2
    for (int b = b0; b < b1; ++b) {
      uint32_t x[KS];
#pragma unroll
      for (int k = 0; k < KS; ++k) x[k] = __ldg(ap + ((size_t)b * KS + k) * cols);
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        uint64_t acc = 0;                     // K·(p − 1)² < 2^64: no fold
#pragma unroll
        for (int k = 0; k < KS; ++k) acc += (uint64_t)x[k] * w[k][m];
        op[((size_t)b * MS + m) * cols] = (int32_t)pk.reduce(acc);
      }
    }
  } else {
    // the column's pm words in shared memory where K·M ≤ STAGED_KM (each
    // thread its own column: no barrier), else read through L1
    extern __shared__ uint32_t smem[];
    const uint32_t* wk = wp;
    int wstride = cols;
    if (K * M <= STAGED_KM) {
      for (int i = 0; i < K * M; ++i) smem[i * TILE_COLS + threadIdx.x] = __ldg(wp + (size_t)i * cols);
      wk = smem + threadIdx.x;
      wstride = TILE_COLS;
    }
    constexpr int MC = 8, KC = 8;             // outputs per pass, `a` words per load batch
    for (int b = b0; b < b1; ++b) {
      for (int m0 = 0; m0 < M; m0 += MC) {
        uint64_t acc[MC] = {};
        for (int k0 = 0; k0 < K; k0 += KC) {
          uint32_t x[KC];
#pragma unroll
          for (int i = 0; i < KC; ++i)
            x[i] = k0 + i < K ? __ldg(ap + ((size_t)b * K + k0 + i) * cols) : 0u;
          if (k0) {                           // 8 more terms stay below 2^64
#pragma unroll
            for (int i = 0; i < MC; ++i) acc[i] = fold32(acc[i], pk.c32);
          }
#pragma unroll
          for (int i = 0; i < KC; ++i)
            if (k0 + i < K)
#pragma unroll
              for (int j = 0; j < MC; ++j)
                if (m0 + j < M)
                  acc[j] += (uint64_t)x[i] * wk[(size_t)((k0 + i) * M + m0 + j) * wstride];
        }
#pragma unroll
        for (int i = 0; i < MC; ++i)
          if (m0 + i < M) op[((size_t)b * M + m0 + i) * cols] = (int32_t)pk.reduce(acc[i]);
      }
    }
  }
}

int log2_of(int n) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  return logn;
}

}  // namespace

// a: [B, K, P, N], pm: [K, M, P, N], out: [B, M, P, N], all int32; consts:
// backends/ntt.py kernel_tables.  The parent design.  Returns the
// cudaError_t of the launch.
extern "C" int poulpy_vmp(const void* a, const void* pm, void* out, const void* consts, int B,
                          int K, int M, int P, int n, void* stream) {
  const int logn = log2_of(n);
  const int64_t total = (int64_t)B * M * P * n;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  vmp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)pm, (int32_t*)out, (const int64_t*)consts, total, K, M, P,
      logn);
  return (int)cudaGetLastError();
}

// The tile design, same arguments, `rows` batch rows per block
// (backends/vmp.py tile_layout): the shapes of VmpShape take their instance,
// any other the runtime-shaped one.
extern "C" int poulpy_vmp_tile(const void* a, const void* pm, void* out, const void* consts,
                               int B, int K, int M, int P, int n, int rows, void* stream) {
  const int logn = log2_of(n), cols = P * n;
  auto kernel = vmp_tile_kernel<AnyShape>;
  if (K == RouteShape::K && M == RouteShape::M) kernel = vmp_tile_kernel<RouteShape>;
  if (K == KsShape::K && M == KsShape::M) kernel = vmp_tile_kernel<KsShape>;
  if (K == CkksShape::K && M == CkksShape::M) kernel = vmp_tile_kernel<CkksShape>;
  const dim3 grid((cols + TILE_COLS - 1) / TILE_COLS, (B + rows - 1) / rows);
  const bool staged = kernel == vmp_tile_kernel<AnyShape> && K * M <= STAGED_KM;
  const size_t smem = staged ? (size_t)K * M * TILE_COLS * 4 : 0;
  kernel<<<grid, TILE_COLS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)pm, (int32_t*)out, (const int64_t*)consts, B, K, M, logn,
      cols, rows);
  return (int)cudaGetLastError();
}
