// The fused pipeline in the sublane/lane-split layout, one launch for a batch:
//   the product  out = big_normalize(idft(vmp(dft(a), pm)) [+ small at column 0 | + small64])
//   the block step  acc <- normalize(acc + idft(sum_i NTT(X^{a_i} - 1) * (dft(acc) [x] BRK_i)))
// from int64 limbs [B, ci, size_a, N] to normalized int64 limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused.py, _pipe_fn -> _kernel_pipe with
// POULPY_TPU_SL=1 (pallas_fused.py:875-881; N % 128 == 0, N ≥ 128): every
// [..., N] operand seen as [..., N/128, 128], the transforms split into the
// stages across 128-wide rows (half ≥ 128: slice arithmetic) and the stages
// inside one 128-lane row (half < 128: lane rolls), the inverse running the
// lane stages first (_ntt_rows_sl, _intt_rows_sl, pallas_fused.py:382-576).
// The switch sits in _pipe_fn, so it covers every caller of that
// pallas_call: fused_glwe_product (the product, `small`, `small64`; caller
// keyswitching.py, external_product.py, operations.py) and
// fused_br_block_step at steps 1 under rot_mode 0, 1 and 2 (the kernel
// asserts `not sl` for a chain).  Plain twins: poulpy_tpu_torch/backends/
// fused_sl.py fused_glwe_product_sl_ref, fused_br_block_step_sl_ref (the
// plain pipeline with ntt_rows_sl / intt_rows_sl).
//
// What bounds it on the H100: the modular arithmetic and the VMP's L2 reads
// of the key, as the other butterfly kernels (csrc/fused_product.cu,
// csrc/br_block_step.cu); not HBM.  A ciphertext moves 2·ci·size_a·N·8 bytes
// in and co·res_size·N·8 out against (KK + M)·P transforms of N points and
// block·KK·M·P·N multiply-adds.
//
// Two designs share the arguments; backends/fused_sl.py picks one
// (`design=`).  Both keep a row's transform in registers, fuse the entry
// (limbs reduced mod p, mod_p_i64) into the forward, apply the block step's
// x-power in the VMP (rot_mode 2, by Montgomery on the input rows; rot_mode
// 1, by Shoup from the two-plane table; rot_mode 0, on the output rows) and
// share the exit (exit_add, lift_add_normalize).
//
// The split design (fused_sl_split_kernel, poulpy_fused_sl_split; the
// route's; 7 ≤ log N ≤ 13).  A row group of G threads (Split<LOGN>: 128 at
// N 512 .. 2048, N/4 below, N/16 at N 4096 / 8192) owns one row.  Phase 1:
// thread g holds the Q = N/G points g + G·r, one column of the row's
// [N/G, G] tile, so the stages with half ≥ G pair two registers of one
// thread, with one twiddle for the whole group: the TPU's slice arithmetic.
// The forward reads the limbs straight into them.  One exchange through the
// row's own words, behind a named barrier of the group's warps (bar.sync
// id, G), never __syncthreads.  Phase 2: warp w holds chunks of C = max(G,
// 128) points, lane l the points c·C + 32e + l; the stages with 32 ≤ half <
// G pair two registers of a lane, those with half < 32 pair lanes l and l ^
// half, each pair of lanes doing two butterflies, one each, so every
// butterfly makes its twiddle product once (two shuffles per register
// pair).  The inverse runs phase 2 first.  Butterflies are lazy (forward
// [0, 4p), inverse [0, 2p)), canonical at each transform's end, with a
// Montgomery product of R = 2^32 (mont32) against twiddles staged per
// prime and direction in shared memory as w·2^32 mod p: one lane-stage
// twiddle load from shared memory per butterfly, none from global memory
// in a stage.  A block of 512 threads runs its groups over the rows of T
// ciphertexts (one group of cpb output columns each; the wrapper picks the
// most columns of at most SPLIT_MR rows, then the most ciphertexts, whose
// rows let two blocks share an SM), 1,024 threads resident per SM, so
// __launch_bounds__(512, 2) holds every instance to 64 registers; its VMP
// (split_vmp) keeps a thread's output sums, not its inputs, in registers,
// in one pass of up to SPLIT_MR output rows (more: a pass per SPLIT_MR
// rows, the outputs after the inputs).  Shared layout (log N ≤ 11): T·P
// regions of R rows (max(KK, cpb·psize), or KK + cpb·psize past SPLIT_MR
// output rows), then the twiddles [N], then the block step's x-power rows
// [T][block].  Global
// layout (log N 12, 13): the regions in a workspace slot per block, the
// blocks walking the tasks grid-stride; shared memory holds the twiddles, a
// row slot per group for the exchange and the x-power rows.
//
// The parent design (fused_sl_kernel, poulpy_fused_sl; 7 ≤ log N ≤ 11): one
// warp owns one NTT row in its registers: lane l holds the N/32 points j =
// l + 32·r.  A stage whose butterfly half is ≥ 32 pairs two registers of
// the same lane; one whose half is < 32 pairs lane l with lane l ^ half of
// the same register through __shfl_xor_sync, both lanes making the product.
// Twiddles: the Montgomery ones of backends/ntt.py kernel_tables (tw
// [2][P][N]) read with __ldg, canonical residues after every butterfly
// (modarith.cuh mont_mul, add_mod, sub_mod); the VMP modarith.cuh's lazy_vmp
// (vmp_xpow_out below under rot_mode 0).  One ciphertext and group of
// cpb output columns per block of 512 / b threads for the b blocks (1, 2 or
// 4) whose rows fit in an SM; 128 registers a thread.  Layout
// (backends/fused_sl.py sl_layout): P regions of R = max(KK, cpb·psize)
// rows of N words, then the block step's x-power rows xrow[block].
//
// Per block, both designs: forward (entry fused), one barrier; the VMP in
// place, one thread per (prime, coefficient) reading its KK inputs before
// it writes its outputs; one barrier; the inverse of the output rows
// (without N^{-1}); one barrier; one thread per (column, coefficient) lifts,
// adds the body / small64 / the input accumulator and normalizes.  TIMED:
// the stage clock (BF_* stages; the entry's reduction runs inside the
// forward, so BF_ENTRY is the prologue), instances at the paths' shapes
// only: log N 10 (product and block step) and 11 (product).
#include "modarith.cuh"

namespace {

using namespace poulpy;

constexpr int MAX_THREADS = 512;         // the parent design's block
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT_SHARED_LOGN = 11;   // the split design's shared layout: log N ≤ 11
constexpr int SPLIT_MR = 8;             // its VMP's output rows per pass

struct SlArgs {
  const int64_t* a;         // [B][ci][size_a][N]
  const int32_t* pm;        // product [P][KK][M][N]; block step [block][P][KK][M][N]
  const int64_t* small;     // [B][s_size][N] or null
  const int64_t* small64;   // [B][co][s64][N] or null
  const int32_t* xpow;      // block step: [2N][P][N] Montgomery, or [2N][2][P][N] (rot_mode 1)
  const int64_t* amounts;   // block step: [B][block]
  int64_t* out;             // [B][co][res_size][N]
  const int32_t* tw;        // [2][P][N] Montgomery twiddles
  const int64_t* consts;
  uint32_t* ws;             // split, global layout: [grid][T·P·R][N]
  long long* stamps;        // TIMED: [blocks][BF_NSTAGES]
  int ci, size_a, rmax, co, psize, s_size, s64, res_size, kr, ka, cpb, P, block, rot_mode;
  int B, T, tasks;          // split: ciphertexts, per block, tasks (⌈B/T⌉·co/cpb)
};

// The stage clock's instances: the paths' shapes' log N and pattern.
constexpr bool timed_shape(int logn, bool bstep) { return logn == 10 || (logn == 11 && !bstep); }

// ---- the parent design ----

// Forward negacyclic NTT (ntt_fwd_rows' stages and twiddles) of one row held
// by a warp, v[r] = x[lane + 32·r], canonical in and out.  Stage s pairs
// points j and j + half (half = N >> (s + 1)) with the twiddle tw[2^s +
// (j >> (log N − s))].
template <int LOGN>
__device__ __forceinline__ void warp_ntt_fwd(uint32_t (&v)[(1 << LOGN) / 32],
                                             const int32_t* __restrict__ tw, uint32_t p,
                                             uint32_t qinv, int lane) {
  constexpr int NR = (1 << LOGN) / 32;
#pragma unroll
  for (int s = 0; s < LOGN; ++s) {
    const int hl = LOGN - 1 - s;                    // log2 half
    if (hl >= 5) {                                  // registers r and r + half/32 of the lane
      const int hr = hl - 5;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >> hr & 1) continue;
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + (r >> (hr + 1)));
        const uint32_t t = mont_mul(v[r | 1 << hr], w, p, qinv);
        const uint32_t a = v[r];
        v[r] = add_mod(a, t, p);
        v[r | 1 << hr] = sub_mod(a, t, p);
      }
    } else {                                        // lanes l and l ^ half, one register
      const bool hi = lane >> hl & 1;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t u = __shfl_xor_sync(FULL, v[r], 1 << hl);
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + ((32 * r + lane) >> (hl + 1)));
        const uint32_t t = mont_mul(hi ? v[r] : u, w, p, qinv);
        v[r] = hi ? sub_mod(u, t, p) : add_mod(v[r], t, p);
      }
    }
  }
}

// Inverse (Gentleman–Sande) of warp_ntt_fwd without the N^{-1} scale
// (ntt_inv_rows' stages), the lane stages (half < 32) first, canonical in
// and out.
template <int LOGN>
__device__ __forceinline__ void warp_ntt_inv(uint32_t (&v)[(1 << LOGN) / 32],
                                             const int32_t* __restrict__ tw, uint32_t p,
                                             uint32_t qinv, int lane) {
  constexpr int NR = (1 << LOGN) / 32;
#pragma unroll
  for (int s = LOGN - 1; s >= 0; --s) {
    const int hl = LOGN - 1 - s;
    if (hl >= 5) {
      const int hr = hl - 5;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >> hr & 1) continue;
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + (r >> (hr + 1)));
        const uint32_t a = v[r], b = v[r | 1 << hr];
        v[r] = add_mod(a, b, p);
        v[r | 1 << hr] = mont_mul(sub_mod(a, b, p), w, p, qinv);
      }
    } else {
      const bool hi = lane >> hl & 1;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t u = __shfl_xor_sync(FULL, v[r], 1 << hl);
        const uint32_t w = (uint32_t)__ldg(tw + (1 << s) + ((32 * r + lane) >> (hl + 1)));
        v[r] = hi ? mont_mul(sub_mod(u, v[r], p), w, p, qinv) : add_mod(v[r], u, p);
      }
    }
  }
}

// Entry and forward transform of one row by the calling warp: the limbs
// src[j] (int64, any value) reduced mod p (mod_p_i64), warp_ntt_fwd, the
// residues stored to dst[j].  Not inlined: one copy per log N serves every
// instance, and its registers are allocated apart from the VMP's and the
// exit's.
template <int LOGN>
__device__ __noinline__ void sl_fwd_row(uint32_t* dst, const int64_t* __restrict__ src,
                                        const int32_t* __restrict__ tw, const PrimeL& k) {
  constexpr int NR = (1 << LOGN) / 32;
  const int lane = threadIdx.x & 31;
  uint32_t v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) v[r] = mod_p_i64(src[lane + 32 * r], k);
  warp_ntt_fwd<LOGN>(v, tw, k.p, k.qinv, lane);
#pragma unroll
  for (int r = 0; r < NR; ++r) dst[lane + 32 * r] = v[r];
}

// The inverse transform (warp_ntt_inv) of the row x in place, by the
// calling warp; not inlined, as sl_fwd_row.
template <int LOGN>
__device__ __noinline__ void sl_inv_row(uint32_t* x, const int32_t* __restrict__ tw, uint32_t p,
                                        uint32_t qinv) {
  constexpr int NR = (1 << LOGN) / 32;
  const int lane = threadIdx.x & 31;
  uint32_t v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) v[r] = x[lane + 32 * r];
  warp_ntt_inv<LOGN>(v, tw, p, qinv, lane);
#pragma unroll
  for (int r = 0; r < NR; ++r) x[lane + 32 * r] = v[r];
}

// The block step's VMP under rot_mode 0, in place: output row m of region pi
// ← Σ_i NTT(X^{a_i} − 1)·(Σ_k x_k·pm_i[k][m]·R^{-1})·R^{-1}, the x-power (the
// Montgomery table [2N][P][N]) on each key element's output row, as
// br_block_step.cu's parent design; one thread per (prime, coefficient)
// reads its KK inputs before it writes its outputs.  The caller ends it with
// a barrier.
__device__ __forceinline__ void vmp_xpow_out(uint32_t* buf, const int32_t* __restrict__ pm,
                                             const int32_t* __restrict__ xpm1, const int* xrow,
                                             int block, int kk, int mdim, int P, int R, int logn,
                                             const PrimeL* lk) {
  constexpr int MC = 8;
  const int n = 1 << logn;
  for (int it = threadIdx.x; it < (P << logn); it += blockDim.x) {
    const int pi = it >> logn, coef = it & (n - 1);
    const PrimeL k = lk[pi];
    uint32_t x[MAX_LIMBS];
#pragma unroll
    for (int q = 0; q < MAX_LIMBS; ++q)
      if (q < kk) x[q] = buf[((size_t)(pi * R + q) << logn) + coef];
#pragma unroll 1
    for (int mc = 0; mc < mdim; mc += MC) {
      uint32_t sum[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) sum[m] = 0;
#pragma unroll 1
      for (int i = 0; i < block; ++i) {
        const int32_t* pmi = pm + ((size_t)(i * P + pi) * kk * mdim + mc) * n + coef;
        const uint32_t w = (uint32_t)__ldg(xpm1 + ((size_t)xrow[i] * P + pi) * n + coef);
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          if (mc + m >= mdim) break;
          uint64_t dot = 0;
#pragma unroll
          for (int q = 0; q < MAX_LIMBS; ++q)
            if (q < kk)
              dot = mac_guard(dot, x[q], (uint32_t)__ldg(pmi + (size_t)(q * mdim + m) * n), k.p);
          sum[m] = add_mod(sum[m], mont_mul(reduce_redc(dot, k), w, k.p, k.qinv), k.p);
        }
      }
#pragma unroll
      for (int m = 0; m < MC; ++m)
        if (mc + m < mdim) buf[((size_t)(pi * R + mc + m) << logn) + coef] = sum[m];
    }
  }
}

// The exit's add of one output column: (pointer to limb 0 at coef, limbs).
// BSTEP: the input accumulator's column; else small64's column, or the body
// at column 0.
template <bool BSTEP>
__device__ __forceinline__ const int64_t* exit_add(const SlArgs& g, int64_t b, int c, int coef,
                                                   int n, int& add_size) {
  add_size = 0;
  if (BSTEP) {
    add_size = g.size_a < g.psize ? g.size_a : g.psize;
    return g.a + (b * g.ci + c) * g.size_a * n + coef;
  }
  if (g.small64 != nullptr) {
    add_size = g.s64;
    return g.small64 + (b * g.co + c) * g.s64 * n + coef;
  }
  if (g.small != nullptr && c == 0) {
    add_size = g.s_size < g.psize ? g.s_size : g.psize;
    return g.small + b * g.s_size * n + coef;
  }
  return nullptr;
}

// One ciphertext and group of cpb output columns per block (the grid is
// B·co/cpb blocks; the block step: cpb = co).  BSTEP: the block step
// (g.block key elements, the x-power by g.rot_mode, the input accumulator
// added at the exit, size_a limbs read at the aligned positions); else the
// product, with the body at column 0 or the small64 terms (the exit then
// lifts max(psize, s64) limbs).  TIMED: the stage clock.
template <int LOGN, bool BSTEP, bool TIMED>
__global__ void __launch_bounds__(MAX_THREADS, 1) fused_sl_kernel(const SlArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  constexpr int N = 1 << LOGN;
  const int kk = g.ci * g.rmax, mrows = g.cpb * g.psize, mdim = g.co * g.psize;
  const int P = g.P, R = max(kk, mrows), groups = g.co / g.cpb;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * g.cpb;
  const int warp = threadIdx.x >> 5;
  int* xrow = (int*)(smem + ((size_t)P * R << LOGN));
  StageClock<TIMED, BF_NSTAGES> clk;
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  if (BSTEP)
    for (int i = threadIdx.x; i < g.block; i += blockDim.x)
      xrow[i] = (int)(g.amounts[b * g.block + i] & (2 * N - 1));
  __syncthreads();
  clk.mark(BF_ENTRY);
  const int64_t* ab = g.a + b * g.ci * g.size_a * N;

  // entry and forward transform: a warp per (prime, input row k = column·rmax + limb)
  for (int rr = warp; rr < P * kk; rr += blockDim.x >> 5) {
    const int pi = rr / kk, k = rr - pi * kk, col = k / g.rmax;
    sl_fwd_row<LOGN>(smem + ((size_t)(pi * R + k) << LOGN),
                     ab + ((int64_t)col * g.size_a + k - col * g.rmax) * N, g.tw + (size_t)pi * N,
                     lk[pi]);
  }
  __syncthreads();
  clk.mark(BF_FWD);

  if (!BSTEP)
    lazy_vmp<1, MAX_LIMBS, 8, false>(smem, g.pm, nullptr, nullptr, 1, kk, mdim, c0 * g.psize,
                                     mrows, P, R, LOGN, lk);
  else if (g.rot_mode == 1)
    lazy_vmp<1, MAX_LIMBS, 8, true, true>(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, 0, mdim,
                                          P, R, LOGN, lk);
  else if (g.rot_mode == 2)
    lazy_vmp<1, MAX_LIMBS, 8, true>(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, 0, mdim, P, R,
                                    LOGN, lk);
  else
    vmp_xpow_out(smem, g.pm, g.xpow, xrow, g.block, kk, mdim, P, R, LOGN, lk);
  __syncthreads();
  clk.mark(BF_VMP);

  // inverse transform: a warp per (prime, output row)
  for (int rr = warp; rr < P * mrows; rr += blockDim.x >> 5) {
    const int pi = rr / mrows, m = rr - pi * mrows;
    sl_inv_row<LOGN>(smem + ((size_t)(pi * R + m) << LOGN), g.tw + (size_t)(P + pi) * N, lk[pi].p,
                     lk[pi].qinv);
  }
  __syncthreads();
  clk.mark(BF_INV);

  // exit: N^{-1}, Garner, the add, the normalization
  const int ext = g.small64 != nullptr && g.s64 > g.psize ? g.s64 : g.psize;
  for (int idx = threadIdx.x; idx < (g.cpb << LOGN); idx += blockDim.x) {
    const int col = idx >> LOGN, coef = idx & (N - 1);
    int add_size;
    const int64_t* add = exit_add<BSTEP>(g, b, c0 + col, coef, N, add_size);
    lift_add_normalize(smem, P, R, LOGN, col, g.psize, coef, add, add_size, ext,
                       g.out + (b * g.co + c0 + col) * g.res_size * N + coef, g.res_size, g.kr,
                       g.ka, g.consts);
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(BF_EXIT);
  }
  clk.store(g.stamps);
}

// ---- the split design ----

// log2 of the threads of one row group at log N (backends/fused_sl.py
// split_group): N/4 up to N 512, 128 up to 2048, N/16 past it (16 points a
// thread at most).
constexpr int split_logg(int logn) {
  return logn <= 9 ? logn - 2 : logn <= SPLIT_SHARED_LOGN ? 7 : logn - 4;
}

// The geometry at N = 2^LOGN: G threads per row (a row group), Q = N/G
// points each; phase 2's chunks of C points, L per lane, CPW per warp.
template <int LOGN>
struct Split {
  static constexpr int LOGG = split_logg(LOGN);
  static constexpr int G = 1 << LOGG, LOGQ = LOGN - LOGG, Q = 1 << LOGQ;
  static constexpr int LOGC = LOGG > 7 ? LOGG : 7, C = 1 << LOGC, L = C / 32;
  static constexpr int CPW = 1 << (LOGN - LOGC - LOGG + 5);
};

// p^{-1} mod 2^32 of an odd p (Newton: each step doubles the bits; p·p ≡ 1 mod 8).
__device__ __forceinline__ uint32_t inv32(uint32_t p) {
  uint32_t x = p;
#pragma unroll
  for (int i = 0; i < 4; ++i) x *= 2 - p * x;
  return x;
}

// Montgomery's product with R = 2^32, lazily: a·w·2^{-32} mod p in (0, 2p)
// for any a < 2^32 and w < p < 2^30 (the value (a·w − m·p)/2^32 lies in
// (−p, p)); with w = ω·2^32 mod p it is a·ω mod p.  pinv = p^{-1} mod 2^32.
__device__ __forceinline__ uint32_t mont32(uint32_t a, uint32_t w, uint32_t p, uint32_t pinv) {
  const uint64_t t = (uint64_t)a * w;
  const uint32_t m = (uint32_t)t * pinv;
  return (uint32_t)(t >> 32) - __umulhi(m, p) + p;
}

// Lazy Cooley–Tukey butterfly, X, Y in [0, 4p) → [0, 4p): X ← x + w·Y,
// Y ← x − w·Y + 2p, x = X reduced to [0, 2p), w·Y in (0, 2p).
__device__ __forceinline__ void fwd_bfly32(uint32_t& X, uint32_t& Y, uint32_t w, uint32_t p,
                                           uint32_t pinv) {
  const uint32_t p2 = 2 * p;
  const uint32_t x = X >= p2 ? X - p2 : X;
  const uint32_t t = mont32(Y, w, p, pinv);
  X = x + t;
  Y = x - t + p2;
}

// Lazy Gentleman–Sande butterfly, X, Y in [0, 2p) → [0, 2p): X ← X + Y,
// Y ← (X − Y)·w.
__device__ __forceinline__ void inv_bfly32(uint32_t& X, uint32_t& Y, uint32_t w, uint32_t p,
                                           uint32_t pinv) {
  const uint32_t p2 = 2 * p;
  const uint32_t s = X + Y;
  Y = mont32(X - Y + p2, w, p, pinv);
  X = s >= p2 ? s - p2 : s;
}

template <bool INV>
__device__ __forceinline__ void bfly32(uint32_t& X, uint32_t& Y, uint32_t w, uint32_t p,
                                       uint32_t pinv) {
  if (INV) inv_bfly32(X, Y, w, p, pinv);
  else fwd_bfly32(X, Y, w, p, pinv);
}

// A barrier of the nthreads threads of one row group: named barrier id (1 ..
// 15; 0 is __syncthreads'), nthreads a multiple of 32.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// The twiddles of one prime and direction (kernel_tables' Montgomery
// ω·2^30 mod p) into tws [N] as ω·2^32 mod p, mont32's form; then a barrier.
__device__ __forceinline__ void stage_twiddles(uint32_t* tws, const int32_t* __restrict__ tw,
                                               int n, uint32_t p) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    uint32_t x = (uint32_t)__ldg(tw + j) << 2;
    x = x >= 2 * p ? x - 2 * p : x;
    tws[j] = x >= p ? x - p : x;
  }
  __syncthreads();
}

// Phase 1: the stages s < log Q (half ≥ G) of thread g's points g + G·r,
// forward in order, inverse (INV) in reverse; stage s pairs r and r + Q/2^(s+1)
// with twiddle tws[2^s + (r >> (log Q − s))], the group's for all its threads.
template <int LOGN, bool INV>
__device__ __forceinline__ void split_sub(uint32_t (&v)[Split<LOGN>::Q], const uint32_t* tws,
                                          uint32_t p, uint32_t pinv) {
  using S = Split<LOGN>;
#pragma unroll
  for (int i = 0; i < S::LOGQ; ++i) {
    const int s = INV ? S::LOGQ - 1 - i : i, hr = S::Q >> (s + 1);
#pragma unroll
    for (int r = 0; r < S::Q; ++r)
      if (!(r & hr)) bfly32<INV>(v[r], v[r + hr], tws[(1 << s) + (r >> (S::LOGQ - s))], p, pinv);
  }
}

// Phase 2: the stages s ≥ log Q (half h < G) of warp w's chunks, register
// i·L + e the point (w·CPW + i)·C + 32e + l; forward in order, inverse (INV)
// in reverse.  h ≥ 32: registers e and e + h/32 of a chunk, one twiddle for
// the warp.  h < 32: lanes l and l ^ h, registers in pairs (2q, 2q + 1): the
// lane of the low points takes its partner's point of register 2q + 1, the
// other lane the low point of register 2q, each makes that butterfly (one
// twiddle product), and a second shuffle returns the halves.  Twiddle of
// point j: tws[2^s + (j >> (log N − s))].
template <int LOGN, bool INV>
__device__ __forceinline__ void split_lane(uint32_t (&v)[Split<LOGN>::Q], const uint32_t* tws,
                                           uint32_t p, uint32_t pinv, int w, int l) {
  using S = Split<LOGN>;
  constexpr int NS = LOGN - S::LOGQ;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = INV ? LOGN - 1 - i : S::LOGQ + i;
    const int lh = LOGN - 1 - s, k = lh + 1;        // log2 half, log2 (2·half)
    const uint32_t* tb = tws + (1 << s) + ((w * S::CPW * S::C) >> k);
    if (lh >= 5) {
      const int he = 1 << (lh - 5);
#pragma unroll
      for (int c = 0; c < S::CPW; ++c)
#pragma unroll
        for (int e = 0; e < S::L; ++e)
          if (!(e & he))
            bfly32<INV>(v[c * S::L + e], v[c * S::L + e + he], tb[(c * S::C + 32 * e) >> k], p,
                        pinv);
    } else {
      const int h = 1 << lh;
      const bool lo = !(l & h);
      const uint32_t* tl = tb + (l >> k);
#pragma unroll
      for (int q = 0; q < S::Q / 2; ++q) {
        const int e0 = 2 * q, e1 = 2 * q + 1;
        const int o0 = ((e0 / S::L) * S::C + 32 * (e0 % S::L)) >> k;
        const int o1 = ((e1 / S::L) * S::C + 32 * (e1 % S::L)) >> k;
        const uint32_t wv = tl[lo ? o1 : o0];
        const uint32_t u = __shfl_xor_sync(FULL, lo ? v[e0] : v[e1], h);
        uint32_t X = lo ? v[e1] : u, Y = lo ? u : v[e0];
        bfly32<INV>(X, Y, wv, p, pinv);
        const uint32_t u2 = __shfl_xor_sync(FULL, lo ? Y : X, h);
        v[e0] = lo ? u2 : Y;
        v[e1] = lo ? X : u2;
      }
    }
  }
}

// Phase 1's points (g + G·r) → xchg → phase 2's ((w·CPW + i)·C + 32e + l),
// across the group's named barrier `bar`, or (a one-warp group, N 128: the
// same points) nothing.  TO_LANES false: the other way.
template <int LOGN, bool TO_LANES>
__device__ __forceinline__ void split_exchange(uint32_t (&v)[Split<LOGN>::Q], uint32_t* xchg,
                                               int g, int bar) {
  using S = Split<LOGN>;
  if constexpr (S::G > 32) {
    const int w = g >> 5, l = g & 31;
    uint32_t* lanes = xchg + w * S::CPW * S::C + l;
#pragma unroll
    for (int r = 0; r < S::Q; ++r) {
      if (TO_LANES) xchg[g + S::G * r] = v[r];
      else lanes[(r / S::L) * S::C + 32 * (r % S::L)] = v[r];
    }
    group_sync(bar, S::G);
#pragma unroll
    for (int r = 0; r < S::Q; ++r)
      v[r] = TO_LANES ? lanes[(r / S::L) * S::C + 32 * (r % S::L)] : xchg[g + S::G * r];
  }
}

// Entry and forward transform of one row by the calling group: the limbs
// src[j] (int64, any value) reduced mod p into phase 1's registers, phase
// 1, the exchange through xchg (the row's own words, or in the global
// layout the group's shared slot), phase 2, the canonical residues stored
// to dst[j].  Global layout (log N > SPLIT_SHARED_LOGN): a second group
// barrier before xchg is written again.  Not inlined: one copy per log N.
template <int LOGN>
__device__ __noinline__ void split_fwd_row(uint32_t* dst, uint32_t* xchg,
                                           const int64_t* __restrict__ src, const uint32_t* tws,
                                           const PrimeL& k) {
  using S = Split<LOGN>;
  const int g = threadIdx.x & (S::G - 1), w = g >> 5, l = g & 31;
  const int bar = 1 + (threadIdx.x >> S::LOGG);
  const uint32_t p = k.p, p2 = 2 * p, pinv = inv32(p);
  uint32_t v[S::Q];
#pragma unroll
  for (int r = 0; r < S::Q; ++r) v[r] = mod_p_i64(src[g + S::G * r], k);
  split_sub<LOGN, false>(v, tws, p, pinv);
  split_exchange<LOGN, true>(v, xchg, g, bar);
  split_lane<LOGN, false>(v, tws, p, pinv, w, l);
  uint32_t* out = dst + w * S::CPW * S::C + l;
#pragma unroll
  for (int r = 0; r < S::Q; ++r) {
    uint32_t x = v[r] >= p2 ? v[r] - p2 : v[r];
    out[(r / S::L) * S::C + 32 * (r % S::L)] = x >= p ? x - p : x;
  }
  if (LOGN > SPLIT_SHARED_LOGN) group_sync(bar, S::G);
}

// The inverse transform (without N^{-1}) of the canonical row x in place by
// the calling group: phase 2 first, the exchange through xchg, phase 1,
// canonical out; as split_fwd_row for the global layout and inlining.
template <int LOGN>
__device__ __noinline__ void split_inv_row(uint32_t* x, uint32_t* xchg, const uint32_t* tws,
                                           uint32_t p) {
  using S = Split<LOGN>;
  const int g = threadIdx.x & (S::G - 1), w = g >> 5, l = g & 31;
  const int bar = 1 + (threadIdx.x >> S::LOGG);
  const uint32_t pinv = inv32(p);
  const uint32_t* in = x + w * S::CPW * S::C + l;
  uint32_t v[S::Q];
#pragma unroll
  for (int r = 0; r < S::Q; ++r) v[r] = in[(r / S::L) * S::C + 32 * (r % S::L)];
  split_lane<LOGN, true>(v, tws, p, pinv, w, l);
  split_exchange<LOGN, false>(v, xchg, g, bar);
  split_sub<LOGN, true>(v, tws, p, pinv);
#pragma unroll
  for (int r = 0; r < S::Q; ++r) x[g + S::G * r] = v[r] >= p ? v[r] - p : v[r];
  if (LOGN > SPLIT_SHARED_LOGN) group_sync(bar, S::G);
}

// The split design's VMP of one ciphertext's P regions buf (rows stride R):
// one thread per (prime, coefficient) keeps the sums of a group of at most
// SPLIT_MR output rows in registers and reads each input row from the
// region as it goes, so it holds no array of inputs and needs no copy.  It
// writes output row m to row ob + m: ob 0 (in place, after its last read)
// where mrows ≤ SPLIT_MR, one pass; else ob = KK, past the inputs, which
// each further group of rows reads again.  Each key element's input
// x_q is x_q·X (rot_mode 2: Montgomery, from the table [2N][P][N]; 1: Shoup,
// from the two-plane table) once per (key element, input row); under
// rot_mode 0 the key element's sums are reduced and multiplied by X on the
// output side (vmp_xpow_out's order).  The sums run lazily in u64, folded
// every PrimeL::fold terms, reduced once (reduce_redc): lazy_vmp's and
// vmp_xpow_out's canonical values.  The caller ends it with a barrier.
template <bool BSTEP>
__device__ __forceinline__ void split_vmp(uint32_t* buf, const int32_t* __restrict__ pm,
                                          const int32_t* __restrict__ xpm1, const int* xrow,
                                          int block, int rot_mode, int kk, int mdim, int m0,
                                          int mrows, int ob, int P, int R, int logn,
                                          const PrimeL* lk) {
  const int n = 1 << logn;
  for (int it = threadIdx.x; it < (P << logn); it += blockDim.x) {
    const int pi = it >> logn, coef = it & (n - 1);
    const PrimeL k = lk[pi];
    const uint32_t* x = buf + ((size_t)pi * R << logn) + coef;
#pragma unroll 1
    for (int mg = 0; mg < mrows; mg += SPLIT_MR) {
      const int nm = min(SPLIT_MR, mrows - mg);
      uint64_t acc[SPLIT_MR];
      uint32_t out[SPLIT_MR];
#pragma unroll
      for (int m = 0; m < SPLIT_MR; ++m) acc[m] = 0, out[m] = 0;
      uint32_t terms = 0;
#pragma unroll 1
      for (int i = 0; i < (BSTEP ? block : 1); ++i) {
        const int32_t* pmi =
            pm + ((size_t)(BSTEP ? i * P + pi : pi) * kk * mdim + m0 + mg) * n + coef;
        uint32_t xw = 0, xq = 0;
        if (BSTEP && rot_mode == 1) {
          const int32_t* row = xpm1 + ((size_t)xrow[i] * 2 * P + pi) * n + coef;
          xw = (uint32_t)__ldg(row);
          xq = (uint32_t)__ldg(row + (size_t)P * n);
        } else if (BSTEP) {
          xw = (uint32_t)__ldg(xpm1 + ((size_t)xrow[i] * P + pi) * n + coef);
        }
#pragma unroll 1
        for (int q = 0; q < kk; ++q) {
          uint32_t xv = x[(size_t)q << logn];
          if (BSTEP && rot_mode == 1) xv = shoup_mul30(xv, xw, xq, k.p);
          else if (BSTEP && rot_mode == 2) xv = mont_mul(xv, xw, k.p, k.qinv);
          const int32_t* pq = pmi + (size_t)q * mdim * n;
#pragma unroll
          for (int m = 0; m < SPLIT_MR; ++m)
            if (m < nm) acc[m] += (uint64_t)xv * (uint32_t)__ldg(pq + (size_t)m * n);
          if (++terms == k.fold) {
            terms = 0;
#pragma unroll
            for (int m = 0; m < SPLIT_MR; ++m) acc[m] = fold32(acc[m], k.c32);
          }
        }
        if (BSTEP && rot_mode == 0) {
#pragma unroll
          for (int m = 0; m < SPLIT_MR; ++m) {
            out[m] = add_mod(out[m], mont_mul(reduce_redc(acc[m], k), xw, k.p, k.qinv), k.p);
            acc[m] = 0;
          }
          terms = 0;
        }
      }
#pragma unroll
      for (int m = 0; m < SPLIT_MR; ++m)
        if (m < nm)
          buf[((size_t)(pi * R + ob + mg + m) << logn) + coef] =
              BSTEP && rot_mode == 0 ? out[m] : reduce_redc(acc[m], k);
    }
  }
}

// The exit of one task: for t < nt ciphertexts (b0 + t) and cpb columns
// from c0, one thread per (t, column, coefficient) lifts the regions of t
// (stride tile_words), adds (exit_add) and normalizes (lift_add_normalize).
template <bool BSTEP>
__device__ __forceinline__ void split_exit(const uint32_t* rows, size_t tile_words,
                                           const SlArgs& g, int64_t b0, int nt, int c0, int R,
                                           int logn) {
  const int n = 1 << logn;
  const int ext = g.small64 != nullptr && g.s64 > g.psize ? g.s64 : g.psize;
  for (int idx = threadIdx.x; idx < ((nt * g.cpb) << logn); idx += blockDim.x) {
    const int tc = idx >> logn, coef = idx & (n - 1), t = tc / g.cpb, col = tc - t * g.cpb;
    const int64_t b = b0 + t;
    int add_size;
    const int64_t* add = exit_add<BSTEP>(g, b, c0 + col, coef, n, add_size);
    lift_add_normalize(rows + t * tile_words, g.P, R, logn, col, g.psize, coef, add, add_size,
                       ext, g.out + (b * g.co + c0 + col) * g.res_size * n + coef, g.res_size,
                       g.kr, g.ka, g.consts);
  }
}

// T ciphertexts and one group of cpb output columns per task (the block
// step: cpb = co); shared layout: one task per block, global: the blocks
// walk the tasks grid-stride over their workspace slots.  Per prime and
// direction the twiddles are staged, then the row groups take the rows
// (ciphertext, row) of that prime.  BSTEP, the product's flags and TIMED
// as fused_sl_kernel.
template <int LOGN, bool BSTEP, bool TIMED>
__global__ void __launch_bounds__(MAX_THREADS, 2) fused_sl_split_kernel(const SlArgs g) {
  using S = Split<LOGN>;
  constexpr int N = 1 << LOGN;
  constexpr bool STAGED = LOGN > SPLIT_SHARED_LOGN;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ PrimeL lk[MAX_PRIMES];
  const int kk = g.ci * g.rmax, mrows = g.cpb * g.psize, mdim = g.co * g.psize;
  const int ob = mrows > SPLIT_MR ? kk : 0;        // the first output row (split_vmp)
  const int P = g.P, R = max(kk, ob + mrows), T = g.T, groups = g.co / g.cpb;
  const int grp = threadIdx.x >> S::LOGG, ngrp = blockDim.x >> S::LOGG;
  const size_t region = (size_t)R << LOGN, tile = (size_t)T * P * region;
  uint32_t* rows = STAGED ? g.ws + blockIdx.x * tile : smem;
  uint32_t* tws = STAGED ? smem : smem + tile;
  uint32_t* xch = tws + N;                          // global layout: a row slot per group
  int* xrow = (int*)(STAGED ? xch + ((size_t)ngrp << LOGN) : tws + N);
  StageClock<TIMED, BF_NSTAGES> clk;
  if (threadIdx.x < P) lk[threadIdx.x] = PrimeL(g.consts, threadIdx.x);
  for (int task = blockIdx.x; task < g.tasks; task += gridDim.x) {
    const int c0 = (task % groups) * g.cpb;
    const int64_t b0 = (int64_t)(task / groups) * T;
    const int nt = (int)min((int64_t)T, g.B - b0);
    if (BSTEP)
      for (int i = threadIdx.x; i < nt * g.block; i += blockDim.x)
        xrow[i] = (int)(g.amounts[b0 * g.block + i] & (2 * N - 1));
    __syncthreads();
    clk.mark(BF_ENTRY);

    // entry and forward: per prime, a group per (ciphertext t, input row k = column·rmax + limb)
    for (int pi = 0; pi < P; ++pi) {
      stage_twiddles(tws, g.tw + (size_t)pi * N, N, lk[pi].p);
      for (int rr = grp; rr < nt * kk; rr += ngrp) {
        const int t = rr / kk, k = rr - t * kk, col = k / g.rmax;
        uint32_t* row = rows + (t * P + pi) * region + ((size_t)k << LOGN);
        split_fwd_row<LOGN>(row, STAGED ? xch + ((size_t)grp << LOGN) : row,
                            g.a + (((b0 + t) * g.ci + col) * g.size_a + k - col * g.rmax) * N,
                            tws, lk[pi]);
      }
      __syncthreads();
    }
    clk.mark(BF_FWD);

    for (int t = 0; t < nt; ++t)
      split_vmp<BSTEP>(rows + t * P * region, g.pm, g.xpow, xrow + t * g.block, g.block,
                       g.rot_mode, kk, mdim, c0 * g.psize, mrows, ob, P, R, LOGN, lk);
    __syncthreads();
    clk.mark(BF_VMP);

    // inverse: per prime, a group per (ciphertext, output row)
    for (int pi = 0; pi < P; ++pi) {
      stage_twiddles(tws, g.tw + (size_t)(P + pi) * N, N, lk[pi].p);
      for (int rr = grp; rr < nt * mrows; rr += ngrp) {
        const int t = rr / mrows, m = rr - t * mrows;
        uint32_t* row = rows + (t * P + pi) * region + ((size_t)(ob + m) << LOGN);
        split_inv_row<LOGN>(row, STAGED ? xch + ((size_t)grp << LOGN) : row, tws, lk[pi].p);
      }
      __syncthreads();
    }
    clk.mark(BF_INV);

    // exit: N^{-1}, Garner, the add, the normalization
    split_exit<BSTEP>(rows + ((size_t)ob << LOGN), P * region, g, b0, nt, c0, R, LOGN);
    __syncthreads();
    clk.mark(BF_EXIT);
  }
  clk.store(g.stamps);
}

template <class K>
int launch(K kernel, const SlArgs& g, int grid, int threads, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, (unsigned)threads, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// One launch of either design at log N = LOGN (TIMED where g.stamps is set:
// the stage clock's shapes only, else cudaErrorInvalidValue).
template <int LOGN, bool BSTEP>
int launch_n(const SlArgs& g, bool split, int grid, int threads, int smem, cudaStream_t stream) {
  if (LOGN > SPLIT_SHARED_LOGN && !split) return (int)cudaErrorInvalidValue;
  if (g.stamps != nullptr) {
    if constexpr (timed_shape(LOGN, BSTEP)) {
      return split ? launch(fused_sl_split_kernel<LOGN, BSTEP, true>, g, grid, threads, smem,
                            stream)
                   : launch(fused_sl_kernel<LOGN, BSTEP, true>, g, grid, threads, smem, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (LOGN > SPLIT_SHARED_LOGN)
    return launch(fused_sl_split_kernel<LOGN, BSTEP, false>, g, grid, threads, smem, stream);
  else
    return split ? launch(fused_sl_split_kernel<LOGN, BSTEP, false>, g, grid, threads, smem, stream)
                 : launch(fused_sl_kernel<LOGN, BSTEP, false>, g, grid, threads, smem, stream);
}

template <bool BSTEP>
int launch_logn(const SlArgs& g, int logn, bool split, int grid, int threads, int smem,
                cudaStream_t st) {
  switch (logn) {
    case 7: return launch_n<7, BSTEP>(g, split, grid, threads, smem, st);
    case 8: return launch_n<8, BSTEP>(g, split, grid, threads, smem, st);
    case 9: return launch_n<9, BSTEP>(g, split, grid, threads, smem, st);
    case 10: return launch_n<10, BSTEP>(g, split, grid, threads, smem, st);
    case 11: return launch_n<11, BSTEP>(g, split, grid, threads, smem, st);
    case 12: return launch_n<12, BSTEP>(g, split, grid, threads, smem, st);
    case 13: return launch_n<13, BSTEP>(g, split, grid, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The arguments both entry points check and share.
bool bad_args(int co, int cpb, int block, const void* small, const void* small64, int rot_mode) {
  return cpb < 1 || co % cpb || (block && (cpb != co || small || small64)) || rot_mode < 0 ||
         rot_mode > 2;
}

}  // namespace

// The parent design.  a: [B, ci, size_a, N] int64; pm: the product's [P,
// ci·rmax, co·psize, N] int32 Montgomery (backends/fused.py
// pm_kernel_layout or pm_kernel_layout_dsize), or the block step's [block,
// P, …] key elements; small: null or [B, s_size, N] int64 (added to column
// 0); small64: null or [B, co, s64, N] int64 (added to every column); block:
// 0 for the product, else the block step's key elements (ci == co, the
// input accumulator added at the exit; small and small64 null), xpow its
// x-power table (rot_mode 0 and 2: [2N, P, N] Montgomery NTT(X^j − 1);
// rot_mode 1: [2N, 2, P, N], the plain value and ⌊w·2^30/p⌋) and amounts
// [B, block] int64; out: [B, co, res_size, N] int64, not aliasing a; tw,
// consts: backends/ntt.py kernel_tables; stamps: null, or [B·co/cpb][5]
// int64 for the stage clock (log N 10, and 11 for the product); cpb output
// columns per block, threads per block (a multiple of 32 up to 512) and
// smem from backends/fused_sl.py sl_layout (the grid is B·co/cpb blocks).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for log N
// outside 7..11).
extern "C" int poulpy_fused_sl(const void* a, const void* pm, const void* small,
                               const void* small64, const void* xpow, const void* amounts,
                               void* out, const void* tw, const void* consts, void* stamps, int B,
                               int ci, int size_a, int rmax, int co, int psize, int s_size,
                               int s64, int res_size, int kr, int ka, int cpb, int P, int logn,
                               int block, int rot_mode, int threads, int smem, void* stream) {
  if (bad_args(co, cpb, block, small, small64, rot_mode) || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || logn > SPLIT_SHARED_LOGN)
    return (int)cudaErrorInvalidValue;
  const SlArgs g{(const int64_t*)a, (const int32_t*)pm, (const int64_t*)small,
                 (const int64_t*)small64, (const int32_t*)xpow, (const int64_t*)amounts,
                 (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, nullptr,
                 (long long*)stamps, ci, size_a, rmax, co, psize, s_size, s64, res_size, kr, ka,
                 cpb, P, block, rot_mode, B, 1, B * (co / cpb)};
  const bool bstep = block > 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return bstep ? launch_logn<true>(g, logn, false, g.tasks, threads, smem, st)
               : launch_logn<false>(g, logn, false, g.tasks, threads, smem, st);
}

// The split design: the parent's arguments, and T ciphertexts per block,
// the grid (⌈B/T⌉·co/cpb blocks in the shared layout, log N ≤ 11; at most
// that in the global layout, log N 12 and 13, each block walking its tasks
// with its slot of ws [grid][T·P·R][N] u32, R as above), threads per
// block (whole row groups, at most 15 of more than one warp, up to 1,024)
// and smem from backends/fused_sl.py split_layout; stamps: null,
// or [grid][5] int64 for the stage clock (log N 10, and 11 for the
// product).  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for log N outside 7..13 or a missing workspace).
extern "C" int poulpy_fused_sl_split(const void* a, const void* pm, const void* small,
                                     const void* small64, const void* xpow, const void* amounts,
                                     void* out, const void* tw, const void* consts, void* ws,
                                     void* stamps, int B, int ci, int size_a, int rmax, int co,
                                     int psize, int s_size, int s64, int res_size, int kr, int ka,
                                     int cpb, int P, int logn, int block, int rot_mode, int T,
                                     int grid, int threads, int smem, void* stream) {
  // whole row groups, each of more than one warp on a named barrier of its own (1 .. 15)
  const int logg = logn < 7 || logn > 13 ? 0 : split_logg(logn);
  if (bad_args(co, cpb, block, small, small64, rot_mode) || T < 1 || grid < 1 || logg == 0 ||
      (logn > SPLIT_SHARED_LOGN && ws == nullptr) || threads > MAX_THREADS ||
      threads % (1 << logg) || (logg > 5 && threads >> logg > 15))
    return (int)cudaErrorInvalidValue;
  const SlArgs g{(const int64_t*)a, (const int32_t*)pm, (const int64_t*)small,
                 (const int64_t*)small64, (const int32_t*)xpow, (const int64_t*)amounts,
                 (int64_t*)out, (const int32_t*)tw, (const int64_t*)consts, (uint32_t*)ws,
                 (long long*)stamps, ci, size_a, rmax, co, psize, s_size, s64, res_size, kr, ka,
                 cpb, P, block, rot_mode, B, T, (B + T - 1) / T * (co / cpb)};
  const bool bstep = block > 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return bstep ? launch_logn<true>(g, logn, true, grid, threads, smem, st)
               : launch_logn<false>(g, logn, true, grid, threads, smem, st);
}
