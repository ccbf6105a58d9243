// Negacyclic NTT and inverse NTT on [rows, P, N] int32 residues.
//
// Replaces: poulpy_tpu/backends/pallas_ntt.py, ntt_fn -> _ntt_kernel /
// _ntt_kernel_paired (entries pallas_ntt_forward / pallas_ntt_inverse).
// Plain twin: poulpy_tpu_torch/hal/ntt.py ntt_forward / ntt_inverse.
//
// What bounds it on the H100: each (row, prime) reads and writes its N words
// of HBM once (8 bytes per coefficient), about N/2·log N butterflies per row
// in between; at the product path's set-up shape the bytes bound it (0.48 ms
// for 98,304 rows of 2048 points at 3.35 TB/s), so the butterflies and the
// shared-memory passes have to stay under the HBM traffic.
//
// Two designs, chosen per shape by backends/ntt.py lazy_layout:
//
// Lazy (poulpy_ntt_lazy, 256 ≤ N ≤ 8192): a block of 256 threads owns
// max(1, 2048 / N) rows (their words in shared memory) and transforms them
// with the butterfly kernels' two register passes (their copies below), in
// Shoup products with lazy residues ([0, 4p) forward, [0, 2p) inverse), behind one
// block barrier:
//   forward: thread l loads the 2^K points m·256 + l (K = log N − 8) of
//     each of the block's rows straight from HBM — coalesced across l, all
//     of them (eight or more words) issued before the first butterfly —,
//     runs the stages of bits log N − 1 .. 8 in registers (fwd_hi_regs) and
//     writes them to shared memory; barrier; one warp per 256-point chunk
//     runs the stages of bits 7 .. 0 (ntt_lo_chunk, three register passes
//     with two swizzled warp transposes) and stores its canonical points to
//     HBM as 16-byte groups, 512 contiguous bytes per warp store;
//   inverse: the mirror: each warp loads its chunk from HBM as 16-byte
//     groups, runs bits 0 .. 7 into shared memory; barrier; thread l runs
//     bits 8 .. log N − 1 of each row (inv_hi_regs), scales them by N^{-1}
//     in one Shoup product (kernel_tables' C_NINV_SHOUP), makes them
//     canonical and stores them at m·256 + l, coalesced.
//   At N 256 (K 0) a row is one warp's chunk: the warp reads and writes HBM
//   itself and the block has no barrier.
//
// Parent (poulpy_ntt, every other N, and the reference the lazy design is
// timed against): the first design, one block per (row, prime), the row in
// shared memory, N/2 threads (at most 1024) doing one butterfly each per
// stage, one __syncthreads() between the log N stages, exact Montgomery
// products with canonical outputs (modarith.cuh ntt_fwd_rows /
// ntt_inv_rows).
//
// The canonical output is unique, so both designs equal the plain version
// bit for bit.
#include "modarith.cuh"

namespace {

using namespace poulpy;

// The forward's stages of bits log N − 1 .. 8 (K = log N − 8 of them) on
// the 2^K points m·256 + l of one row in registers, v[m] in [0, 4p) → [0,
// 4p) (modarith.cuh lazy_entry_fwd_hi's stages); twp: the row's prime's
// Shoup twiddles, the same for every l.
template <int K>
__device__ __forceinline__ void fwd_hi_regs(uint32_t (&v)[1 << K], const uint2* __restrict__ twp,
                                            uint32_t p) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int kb = K - 1 - s;
#pragma unroll
    for (int j = 0; j < (1 << K); ++j)
      if (!(j >> kb & 1))
        fwd_bfly(v[j], v[j | 1 << kb], __ldg(twp + (1 << s) + (j >> (kb + 1))), p);
  }
}

// The inverse's stages of bits 8 .. log N − 1 (its last pass) on the same
// points, [0, 2p) → [0, 2p) (modarith.cuh ntt_inv_hi's stages); twp: the
// inverse Shoup twiddles.
template <int K>
__device__ __forceinline__ void inv_hi_regs(uint32_t (&v)[1 << K], const uint2* __restrict__ twp,
                                            uint32_t p) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const int kb = K - 1 - s;
#pragma unroll
    for (int j = 0; j < (1 << K); ++j)
      if (!(j >> kb & 1))
        inv_bfly(v[j], v[j | 1 << kb], __ldg(twp + (1 << s) + (j >> (kb + 1))), p);
  }
}

// The stages of bits 7 .. 0 of one 256-point chunk c of a row, in one warp,
// in three register passes with the chunk transposed between them through
// its words x (swizzled, chunk_sw, so that no two lanes of a load or store
// meet in a bank):
//   A: lane = bits 4..0, registers j = bits 7..5 (points 32·j + lane);
//   B: lane = (bits 7..5, bits 1..0), registers m = bits 4..2;
//   C: lane = bits 6..2, registers (bit 7, bits 1..0): two 16-byte groups.
// Forward: A, B, C, canonical at the end.  INV: C, B, A (the inverse's first
// pass), canonical where `last`.  These are modarith.cuh ntt_pass_lo's
// passes, except that the first pass loads its points in natural order from
// `in` and the last stores them, each through `fin`, in natural order to
// `out` (here the chunk in HBM, or x); they are kept apart from ntt_pass_lo
// so that the butterfly kernels' instances compile as they did.  twp: the
// row's prime's Shoup twiddles; hb = log N − 8.
template <bool INV, class Fin>
__device__ __forceinline__ void ntt_lo_chunk(uint32_t* x, const uint32_t* in, uint32_t* out,
                                             const uint2* __restrict__ twp, int c, int hb,
                                             uint32_t p, bool last, Fin fin) {
  const int logn = hb + 8, lane = threadIdx.x & 31;
  const int h3 = lane >> 2, l2 = lane & 3;           // pass B's lane bits
  const uint32_t p2 = 2 * p;
  uint32_t v[8];
  // pass A: bits 7, 6, 5 (stages hb .. hb + 2)
  auto pass_a = [&] {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int st = INV ? 2 - t : t, kb = 2 - st;    // stage hb + st, bit 7 − st
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >> kb & 1) continue;
        const uint2 w = __ldg(twp + (1 << (hb + st)) + (c << st) + (j >> (kb + 1)));
        if (INV) inv_bfly(v[j], v[j | 1 << kb], w, p);
        else fwd_bfly(v[j], v[j | 1 << kb], w, p);
      }
    }
  };
  // pass B: bits 4, 3, 2 (stages hb + 3 .. hb + 5)
  auto pass_b = [&] {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int u = INV ? 2 - t : t, kb = 2 - u;      // stage hb + 3 + u, bit 4 − u
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m >> kb & 1) continue;
        const uint2 w = __ldg(twp + (1 << (hb + 3 + u)) + (c << (3 + u)) + (h3 << u) +
                              (m >> (kb + 1)));
        if (INV) inv_bfly(v[m], v[m | 1 << kb], w, p);
        else fwd_bfly(v[m], v[m | 1 << kb], w, p);
      }
    }
  };
  // pass C: bits 1, 0 (stages log N − 2, log N − 1) in each group g = bit 7
  auto pass_c = [&] {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int b = INV ? t : 1 - t;                  // bit b: stage log N − 1 − b
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r >> b & 1) continue;
          const int e = g << 7 | lane << 2 | r;
          const uint2 w = __ldg(twp + (1 << (logn - 1 - b)) + (c << (7 - b)) + (e >> (b + 1)));
          uint32_t& lo = v[g * 4 + r];
          uint32_t& hi = v[g * 4 + (r | 1 << b)];
          if (INV) inv_bfly(lo, hi, w, p);
          else fwd_bfly(lo, hi, w, p);
        }
    }
  };
  // the words of pass A's point j, pass B's m, pass C's group g: natural
  // order (in `in` or `out`), or swizzled in x (pass B's always)
  auto ix = [](int e, bool sw) { return sw ? chunk_sw(e) : e; };
  auto a_load = [&](const uint32_t* base, bool sw) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = base[ix(j << 5 | lane, sw)];
  };
  auto a_store = [&](uint32_t* base, bool sw) {
#pragma unroll
    for (int j = 0; j < 8; ++j) base[ix(j << 5 | lane, sw)] = v[j];
  };
  auto b_addr = [&](int m) { return x + chunk_sw(h3 << 5 | m << 2 | l2); };
  auto c_load = [&](const uint32_t* base, bool sw) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(base + ix(g << 7 | lane << 2, sw));
      v[4 * g] = w4.x, v[4 * g + 1] = w4.y, v[4 * g + 2] = w4.z, v[4 * g + 3] = w4.w;
    }
  };
  auto c_store = [&](uint32_t* base, bool sw) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<uint4*>(base + ix(g << 7 | lane << 2, sw)) =
          uint4{v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]};
  };
  if (!INV) {
    a_load(in, false);
    pass_a();
    __syncwarp();
    a_store(x, true);
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = *b_addr(m);
    pass_b();
#pragma unroll
    for (int m = 0; m < 8; ++m) *b_addr(m) = v[m];
    __syncwarp();
    c_load(x, true);
    pass_c();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = v[j] >= p2 ? v[j] - p2 : v[j];
      v[j] = fin(v[j] >= p ? v[j] - p : v[j]);
    }
    __syncwarp();
    c_store(out, false);
  } else {
    c_load(in, false);
    pass_c();
    __syncwarp();
    c_store(x, true);
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = *b_addr(m);
    pass_b();
#pragma unroll
    for (int m = 0; m < 8; ++m) *b_addr(m) = v[m];
    __syncwarp();
    a_load(x, true);
    pass_a();
    if (last) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] >= p ? v[j] - p : v[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fin(v[j]);
    __syncwarp();
    a_store(out, false);
  }
}

constexpr int LAZY_THREADS = 256;
// Blocks per SM the lazy instances' registers are bounded for (48 each):
// five blocks' HBM loads in flight per SM, at 8 B of stack or less; unbounded
// (64–97 registers) the blocks per SM fall to 2–4 and the loads with them.
constexpr int LAZY_MIN_BLOCKS = 5;

__global__ void __launch_bounds__(1024) ntt_kernel(const int32_t* __restrict__ x,
                                                   int32_t* __restrict__ y,
                                                   const int32_t* __restrict__ tw,
                                                   const int64_t* __restrict__ consts,
                                                   int nprimes, int logn, int inverse) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;  // row·P + prime
  const int pi = (int)(row % nprimes);
  const int64_t* c = consts + pi * CONSTS_PER_PRIME;
  const uint32_t p = (uint32_t)c[C_P];
  const uint32_t qinv = (uint32_t)c[C_QINV];
  const int32_t* src = x + row * n;
  int32_t* dst = y + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = (uint32_t)src[i];
  __syncthreads();
  if (!inverse) {
    ntt_fwd_rows(smem, 1, logn, tw + (size_t)pi * n, p, qinv);
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int32_t)smem[i];
  } else {
    ntt_inv_rows(smem, 1, logn, tw + (size_t)(nprimes + pi) * n, p, qinv);
    const uint32_t ninv = (uint32_t)c[C_NINV];
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int32_t)mont_mul(smem[i], ninv, p, qinv);
  }
}

// The lazy design of 2^(K+8)-point rows: rows row0 .. row0 + nrows − 1 of
// the block (global row r has prime r mod P), RPB of them per block, their
// words in shared memory; thread t is the column l = t of each row in the
// high pass.  tw: the Shoup twiddles [2][P][N] (forward, inverse;
// backends/ntt.py shoup_tables).
template <int K>
__host__ __device__ constexpr int lazy_rpb() { return K < 3 ? 8 >> K : 1; }

template <int K, bool INV>
__global__ void __launch_bounds__(LAZY_THREADS, LAZY_MIN_BLOCKS) ntt_lazy_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y, const uint2* __restrict__ tw,
    const int64_t* __restrict__ consts, int total, int nprimes) {
  constexpr int M = 1 << K, N = 256 << K, RPB = lazy_rpb<K>();
  extern __shared__ __align__(16) uint32_t smem[];
  const int row0 = blockIdx.x * RPB, l = threadIdx.x;
  const int nrows = min(RPB, total - row0);
  const uint32_t* src = x + (size_t)row0 * N;
  uint32_t* dst = y + (size_t)row0 * N;
  const uint2* twd = tw + (INV ? (size_t)nprimes * N : 0);
  auto prime = [&](int rr) { return (row0 + rr) % nprimes; };
  auto p_of = [&](int pi) { return (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P]; };
  // the Shoup pair of N^{-1}: v in [0, 2^32) → v·N^{-1} mod p, canonical
  auto scale = [&](uint32_t v, int pi, uint32_t p) {
    const uint64_t w = (uint64_t)consts[pi * CONSTS_PER_PRIME + C_NINV_SHOUP];
    const uint32_t r = shoup_mul(v, uint2{(uint32_t)w, (uint32_t)(w >> 32)}, p);
    return r >= p ? r - p : r;
  };
  if (!INV && K > 0) {
    // every load of the thread's columns first, so that they are all in flight
    uint32_t v[RPB][M];
#pragma unroll
    for (int rr = 0; rr < RPB; ++rr)
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (rr < nrows) v[rr][m] = __ldg(src + (size_t)rr * N + (m << 8) + l);
#pragma unroll
    for (int rr = 0; rr < RPB; ++rr) {
      if (rr < nrows) {
        const int pi = prime(rr);
        fwd_hi_regs<K>(v[rr], twd + (size_t)pi * N, p_of(pi));
#pragma unroll
        for (int m = 0; m < M; ++m) smem[rr * N + (m << 8) + l] = v[rr][m];
      }
    }
    __syncthreads();
  }
  for (int q = threadIdx.x >> 5; q < nrows << K; q += LAZY_THREADS / 32) {
    const int rr = q >> K, c = q & (M - 1), pi = prime(rr);
    const uint32_t p = p_of(pi);
    uint32_t* xs = smem + rr * N + (c << 8);
    const size_t at = (size_t)rr * N + (c << 8);
    if (!INV)
      ntt_lo_chunk<false>(xs, K ? xs : src + at, dst + at, twd + (size_t)pi * N, c, K, p, true,
                          [](uint32_t v) { return v; });
    else   // K 0: the whole inverse, scaled on the way out
      ntt_lo_chunk<true>(xs, src + at, K ? xs : dst + at, twd + (size_t)pi * N, c, K, p, false,
                         [&](uint32_t v) { return K ? v : scale(v, pi, p); });
  }
  if (INV && K > 0) {
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPB; ++rr) {
      if (rr < nrows) {
        const int pi = prime(rr);
        const uint32_t p = p_of(pi);
        uint32_t v[M];
#pragma unroll
        for (int m = 0; m < M; ++m) v[m] = smem[rr * N + (m << 8) + l];
        inv_hi_regs<K>(v, twd + (size_t)pi * N, p);
#pragma unroll
        for (int m = 0; m < M; ++m) dst[(size_t)rr * N + (m << 8) + l] = scale(v[m], pi, p);
      }
    }
  }
}

template <int K, bool INV>
int launch_lazy(const void* x, void* y, const void* tw, const void* consts, int total,
                int nprimes, int rpb, int threads, int smem, cudaStream_t stream) {
  constexpr int RPB = lazy_rpb<K>();
  if (rpb != RPB || threads != LAZY_THREADS || smem != 4 * RPB * (256 << K))
    return (int)cudaErrorInvalidValue;
  ntt_lazy_kernel<K, INV><<<(unsigned)((total + RPB - 1) / RPB), LAZY_THREADS, smem, stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint2*)tw, (const int64_t*)consts, total, nprimes);
  return (int)cudaGetLastError();
}

template <bool INV>
int launch_lazy_n(int logn, const void* x, void* y, const void* tw, const void* consts,
                  int total, int nprimes, int rpb, int threads, int smem, cudaStream_t stream) {
  switch (logn) {
    case 8: return launch_lazy<0, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    case 9: return launch_lazy<1, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    case 10: return launch_lazy<2, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    case 11: return launch_lazy<3, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    case 12: return launch_lazy<4, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    case 13: return launch_lazy<5, INV>(x, y, tw, consts, total, nprimes, rpb, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The parent design.  x, y: [rows, P, N] int32 (y may not alias x); tw:
// [2, P, N] int32 forward / inverse Montgomery twiddles; consts:
// backends/ntt.py kernel_tables.  Returns the cudaError_t of the launch.
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

// The lazy design (8 ≤ logn ≤ 13).  x, y: [total = rows·P, N] int32, 16-byte
// aligned (y may not alias x); tw: backends/ntt.py shoup_tables [2, P, N, 2];
// consts: kernel_tables; rpb = max(1, 2048 / N) rows and 256 threads per
// block, smem = 4·rpb·N bytes of shared memory (backends/ntt.py lazy_layout;
// any other value is refused).  Returns the cudaError_t of the launch.
extern "C" int poulpy_ntt_lazy(const void* x, void* y, const void* tw, const void* consts,
                               int total, int nprimes, int logn, int inverse, int rpb, int threads,
                               int smem, void* stream) {
  return inverse ? launch_lazy_n<true>(logn, x, y, tw, consts, total, nprimes, rpb, threads, smem,
                                       (cudaStream_t)stream)
                 : launch_lazy_n<false>(logn, x, y, tw, consts, total, nprimes, rpb, threads,
                                        smem, (cudaStream_t)stream);
}
