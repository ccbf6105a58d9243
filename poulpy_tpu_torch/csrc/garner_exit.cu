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
//
// Two designs.
// - tile (the paths): a 2-D grid, blockIdx.x the (ciphertext, column) row
//   and blockIdx.y a tile of coefficients, so no thread divides; the basis'
//   Garner constants in shared memory, loaded once per block.  The shapes of
//   ExitShape (backends/fused.py EXIT_SHAPES: the "mxu" route's product and
//   keyswitch) are template parameters: a thread takes 4 consecutive
//   coefficients with 16-byte loads of the residues and 16-byte stores of the
//   limbs, and the lift, the body add and the normalize are unrolled, so
//   their arrays stay in registers.  Any other shape takes the runtime-shaped
//   instance, a coefficient per thread (its limb arrays, indexed at run time,
//   in local memory).
// - parent (the first design, kept as the reference): one thread per
//   (ciphertext, column, coefficient) in a grid-stride loop, its row and
//   column by 64-bit `/` and `%`, the constants read from global memory for
//   every coefficient (modarith.cuh garner), the limb arrays in local memory.
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

// ---- the tile design ----

// The compile-time shapes of the tile design (backends/fused.py EXIT_SHAPES):
// primes, limbs in, limbs out, body limbs, output and input base; all 0 is
// the runtime-shaped instance.  V: coefficients per thread.
template <int P_, int PSIZE_, int RES_, int S_SIZE_, int KR_, int KA_>
struct ExitShape {
  static constexpr int P = P_, PSIZE = PSIZE_, RES = RES_, S_SIZE = S_SIZE_, KR = KR_, KA = KA_;
  static constexpr int V = P_ ? 4 : 1;
};
using ProductExit = ExitShape<2, 4, 3, 0, 17, 17>;   // the "mxu" route's product
using KsExit = ExitShape<2, 4, 3, 3, 17, 17>;        // the "mxu" route's keyswitch (body added)
using AnyExit = ExitShape<0, 0, 0, 0, 0, 0>;

constexpr int EXIT_THREADS = 256;

template <class S>
__global__ void __launch_bounds__(EXIT_THREADS) garner_exit_tile_kernel(
    const int32_t* __restrict__ x, const int64_t* __restrict__ small, int64_t* __restrict__ out,
    const int64_t* __restrict__ consts, int co, int psize, int s_size, int res_size, int kr,
    int ka, int P, int logn) {
  __shared__ ExitPrimes k;
  load_exit_primes(k, consts, S::P ? S::P : P);
  const int bc = blockIdx.x;                                     // b·co + column
  const int coef = (blockIdx.y * blockDim.x + threadIdx.x) * S::V;
  const bool body = small != nullptr && bc % co == 0;
  const int b = bc / co;
  if constexpr (S::P != 0) {
    constexpr int V = S::V;
    int64_t big[V][S::PSIZE];
#pragma unroll
    for (int j = 0; j < S::PSIZE; ++j) {
      uint32_t r[V][S::P];
#pragma unroll
      for (int pi = 0; pi < S::P; ++pi) {
        const uint4 w = *(const uint4*)(x + ((((size_t)bc * S::PSIZE + j) * S::P + pi) << logn) + coef);
        r[0][pi] = w.x, r[1][pi] = w.y, r[2][pi] = w.z, r[3][pi] = w.w;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) big[v][j] = exit_lift<S::P>(r[v], S::P, k);
      if (S::S_SIZE > j && body) {
        const longlong2* sp =
            (const longlong2*)(small + (((size_t)b * S::S_SIZE + j) << logn) + coef);
        const longlong2 s0 = sp[0], s1 = sp[1];
        big[0][j] = wadd(big[0][j], s0.x), big[1][j] = wadd(big[1][j], s0.y);
        big[2][j] = wadd(big[2][j], s1.x), big[3][j] = wadd(big[3][j], s1.y);
      }
    }
    int64_t res[V][S::RES];
#pragma unroll
    for (int v = 0; v < V; ++v) normalize_full_t<S::PSIZE, S::RES>(big[v], res[v], S::KR, S::KA);
#pragma unroll
    for (int i = 0; i < S::RES; ++i) {
      longlong2* op = (longlong2*)(out + (((size_t)bc * S::RES + i) << logn) + coef);
      op[0] = make_longlong2(res[0][i], res[1][i]);
      op[1] = make_longlong2(res[2][i], res[3][i]);
    }
  } else {
    int64_t big[MAX_LIMBS];
    for (int j = 0; j < psize; ++j) {
      uint32_t r[MAX_PRIMES];
#pragma unroll
      for (int pi = 0; pi < MAX_PRIMES; ++pi)
        if (pi < P) r[pi] = (uint32_t)x[((((size_t)bc * psize + j) * P + pi) << logn) + coef];
      big[j] = exit_lift<0>(r, P, k);
      if (body && j < s_size) big[j] = wadd(big[j], small[(((size_t)b * s_size + j) << logn) + coef]);
    }
    int64_t res[MAX_LIMBS];
    normalize_full(big, psize, res, res_size, kr, ka);
    for (int i = 0; i < res_size; ++i) out[(((size_t)bc * res_size + i) << logn) + coef] = res[i];
  }
}

template <class S>
bool exit_shape_is(int P, int psize, int res_size, int s_size, int kr, int ka) {
  return P == S::P && psize == S::PSIZE && res_size == S::RES && s_size == S::S_SIZE &&
         kr == S::KR && ka == S::KA;
}

}  // namespace

// x: [B, co, psize, P, N] int32; small: [B, s_size, N] int64 or null with
// s_size 0; out: [B, co, res_size, N] int64; consts: backends/ntt.py
// kernel_tables.  The parent design.  Returns the cudaError_t of the launch.
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

// The tile design, same arguments (B·co < 2^31, N ≥ 4, the tensors 16-byte
// aligned): the shapes of ExitShape take their instance, any other the
// runtime-shaped one.
extern "C" int poulpy_garner_exit_tile(const void* x, const void* small, void* out,
                                       const void* consts, int B, int co, int psize, int s_size,
                                       int res_size, int kr, int ka, int P, int logn,
                                       void* stream) {
  auto kernel = garner_exit_tile_kernel<AnyExit>;
  int v = AnyExit::V;
  if (exit_shape_is<ProductExit>(P, psize, res_size, s_size, kr, ka)) {
    kernel = garner_exit_tile_kernel<ProductExit>;
    v = ProductExit::V;
  } else if (exit_shape_is<KsExit>(P, psize, res_size, s_size, kr, ka)) {
    kernel = garner_exit_tile_kernel<KsExit>;
    v = KsExit::V;
  }
  const int per_row = (1 << logn) / v;                  // threads per (ciphertext, column)
  const int threads = per_row < EXIT_THREADS ? per_row : EXIT_THREADS;
  const dim3 grid((unsigned)((int64_t)B * co), (unsigned)(per_row / threads));
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int64_t*)small, (int64_t*)out, (const int64_t*)consts, co, psize,
      s_size, res_size, kr, ka, P, logn);
  return (int)cudaGetLastError();
}
