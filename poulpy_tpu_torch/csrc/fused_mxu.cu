// Fused GLWE x GGSW / GLWE x GGLWE product and block-binary CGGI step
// through the four-step digit-plane transforms, one launch for a batch:
//   product:    out = normalize(garner(mxu_inverse(vmp(mxu_forward(a), pm_σ))) [+ small at column 0])
//   block step: acc ← normalize(acc + garner(mxu_inverse(Σ_i xpm1_σ[a_i] ⊙ vmp(mxu_forward(acc), BRK_i,σ))))
// from int64 limbs [B, ci, size_a, N] (wrapped to int32) to normalized int64
// limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused_mxu.py, _pipe_mxu_fn ->
// _kernel_pipe_mxu, its three call patterns: fused_mxu_glwe_product (block
// 1, no rotate, no add_acc; with or without `small`) and
// fused_mxu_br_block_step (block > 1, rotate, add_acc; caller
// blind_rotation.py:491-505).  The block count is a runtime argument
// except in the gate's specialised instance.  Plain twins:
// poulpy_tpu_torch/backends/fused_mxu.py fused_mxu_glwe_product_ref and
// fused_mxu_br_block_step_ref.
//
// What bounds it on the H100: on paper the int8 tensor-core rate (at the
// bench shape, N 2048, KK 6, M 8, P 2: 134 M multiply-adds per ciphertext
// against 48 bytes in and 48 out per coefficient); the block step adds
// block·KK·M·P·N int32 modular products of the VMP and block·M·P·N of the
// x-power factor.  In practice L2 and latency: the step-B weights (256 KB
// per prime and direction) and the key words (2 MB per block step) come
// from L2.  The stage clock (TIMED instances, chip_smoke.py phase "stages")
// showed the parent design's VMP at 84 % of the block step and 48 % of the
// product: a 64-bit `%` by a runtime prime per dot product (fold_redc) and
// every key word read once per ciphertext.  In the tile design the block
// step is paced by its VMP (43 %: the key words from L2) and inverse step A
// (22 %), the product and `small` by the step-B-shaped products (inverse
// step A 27–33 %, forward step B 11–18 %: the weights streamed from L2).
//
// Two designs share the entry points' arguments:
//
// The tile design (fused_mxu_tile_kernel; every shape whose rows fit in
// shared memory): one block of 512 threads per tile of T ciphertexts and
// group of cpb output columns (backends/fused_mxu.py tile_layout: T 2 at the
// gate's block step, 1 at N 2048), every stage on the tile's stacked rows,
// so each step-B weight fragment serves 64 rows and each key word the whole
// tile.  The VMP runs one thread per coefficient with the tile's T·M sums in
// registers; the block step makes each x-power product res·X^{a_i} once per
// (ciphertext, key element, input row) and shares it over the M output
// rows.  Sums run lazily in u64 (folded every 8 terms) and are reduced once
// by two Montgomery steps (reduce_redc), without `%`.  The shapes of the
// paths (GateShape, ProductShape, SmallShape) have specialised instances:
// loops unrolled, the weights prefetched two k-steps ahead (mma_pf), the
// input planes four coefficients per thread and one word per plane, the
// exit's arrays in registers; any other shape takes the runtime-shaped
// instance with mxu.cuh's stages.  Shared memory: the x-power rows of the
// block step, the coefficient residues of primes 0..P-2, then the parent's
// staging region for T·kk input and T·mrows output rows.
//
// The parent design (fused_mxu_kernel): one block per ciphertext and group
// of cpb output columns (backends/fused_mxu.py mxu_layout; the block step
// keeps all its columns in one block, as br_block_step.cu).  Shared memory
// holds the inverse's output rows of primes 0..P-2 (the Garner lift needs
// every prime of a coefficient), then a staging region reused by every
// stage, each stage reading at one end and writing at the other:
//   input planes (hi) → step A → planes (lo) → step B → σ residues [KK][N] (hi)
//   → VMP with the σ-order matrix, digitized (lo) → inverse step A → planes (hi)
//   → inverse step B → coefficient residues [mrows][N] (prime P-1: lo, which
//   is where the persistent rows continue).
// Rows are padded to an even count so that every product has M a multiple
// of 16; padded rows are zero.  The block step's VMP runs, per output row
// and coefficient, the KK-term dot product with each key element i in u64
// with one reduction, times the σ-order Montgomery NTT(X^{a_i} − 1) gathered
// from the [2N, P, N] table at row a_i & (2N − 1), summed over the block in
// a register (br_block_step.cu's loop, in σ order).  Then one thread per
// (column, coefficient): the Garner lift of the psize limbs (no N^{-1} scale:
// the inverse's weights carry it), the body at column 0 or (block step) the
// int32-wrapped input limbs j < min(size_a, psize) of the column, as the TPU
// kernel adds them, then normalize_full (modarith.cuh), as garner_exit.cu does.
// Where those rows do not fit (bench.py's shape at N 8192 needs 1.5 MB), its
// STAGED instance takes the global layout of modarith.cuh: the σ residues
// [KK][N] and the coefficient residues [P][mrows][N] live in the block's
// global workspace slot, and the transforms run `crows` rows at a time
// through a staging region of their planes alone (2 rows at N 8192).  Its
// shared instance is the stage clock's reference for the tile design.
#include "mxu.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// The stage clock of the TIMED instances (modarith.cuh StageClock): thread 0
// adds the SM cycles since its last mark to the stage that a barrier has
// just closed, and each block writes its sums to stamps[block][NSTAGES].
enum { ST_PLANES, ST_FWD_A, ST_FWD_B, ST_VMP, ST_INV_A, ST_INV_B, ST_EXIT, NSTAGES };

// BSTEP: the block-step pattern (rotate, add_acc; pm holds `block` key
// elements, xpm1 and amounts are read).  STAGED: the global layout.  TIMED:
// the stage clock (shared layout only), stamps [grid][NSTAGES].
template <bool BSTEP, bool STAGED, bool TIMED = false>
__global__ void __launch_bounds__(THREADS, 1) fused_mxu_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, const int32_t* __restrict__ xpm1,
    const int64_t* __restrict__ amounts, int64_t* __restrict__ out, const int2* __restrict__ ua_f,
    const int2* __restrict__ v0_f, const int32_t* __restrict__ tf, const int2* __restrict__ wa_f,
    const int2* __restrict__ w0_f, const int32_t* __restrict__ ti,
    const int64_t* __restrict__ consts, int ci, int size_a, int rmax, int co, int psize,
    int s_size, int res_size, int kr, int ka, int cpb, int block, int P, int logn, int s_bytes,
    uint32_t* __restrict__ ws, int crows, int tasks, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  StageClock<TIMED, NSTAGES> clk;
  const Split s(logn);
  const int n = s.n;
  const int kk = ci * rmax, mdim = co * psize, mrows = cpb * psize;
  const int groups = co / cpb;
  // shared layout: the persistent rows, then the staging region; STAGED: the staging region alone
  uint8_t* stage = STAGED ? smem : smem + (size_t)4 * (P - 1) * mrows * n;
  int8_t* lo = (int8_t*)stage;
  auto hi = [&](size_t bytes) { return stage + s_bytes - bytes; };
  // rows per transform pass, and their count padded for the products (STAGED
  // pads only where rows·n2 would not be a multiple of 16)
  const int fchunk = STAGED ? crows : kk, mchunk = STAGED ? crows : mrows;
  auto padded = [&](int r) { return STAGED && s.n2 % 16 == 0 ? r : (r + 1) & ~1; };

  for_each_task<STAGED>(tasks, ws, (size_t)(kk + P * mrows) * n, [&](int task, uint32_t* slot) {
    const int64_t b = task / groups;
    const int c0 = (task % groups) * cpb;
    const int64_t* ab = a + b * ci * size_a * n;
    uint32_t* xs = STAGED ? slot + (size_t)kk * n : (uint32_t*)smem;   // [P][mrows][n]

    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
      const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
      // forward: the kk input rows (column-major over ci, limb-minor) → σ residues
      uint32_t* res = STAGED ? slot : (uint32_t*)hi((size_t)4 * kk * n);   // [kk][n]
      for (int r0 = 0; r0 < kk; r0 += fchunk) {
        const int nr = min(fchunk, kk - r0), nrp = padded(nr);
        int8_t* a_op = (int8_t*)hi(planes_a_bytes(s, nrp));
        fwd_planes(a_op, nrp, NDIG, s, [&](int r, int pos) -> int32_t {
          if (r >= nr) return 0;
          const int k = r0 + r, col = k / rmax;
          return (int32_t)ab[((int64_t)col * size_a + (k - col * rmax)) * n + pos];
        });
        __syncthreads();
        clk.mark(ST_PLANES);
        fwd_step_a(a_op, lo, nrp, s, ua_f + pi * s.words_a(), tf + (size_t)pi * n, p, qinv);
        __syncthreads();
        clk.mark(ST_FWD_A);
        fwd_step_b(lo, nrp, s, v0_f + pi * s.words_b(), p, qinv, [&](int r, int pos, uint32_t y) {
          if (r < nr) res[(r0 + r) * n + pos] = y;
        });
        __syncthreads();
        clk.mark(ST_FWD_B);
      }
      // VMP of the block's rows, pointwise in σ order (the block step: Σ over
      // the key elements, each times its x-power row), straight into the
      // inverse's digit planes (row m·n2 + k2, column j·n1 + k1), then the
      // inverse → coefficient residues of prime pi
      const int lda_b = s.lda_b();
      for (int m0 = 0; m0 < mrows; m0 += mchunk) {
        const int nr = min(mchunk, mrows - m0), nrp = padded(nr);
        for (int idx = threadIdx.x; idx < (nrp << s.logn); idx += blockDim.x) {
          const int m = idx >> s.logn, pos = idx & (n - 1);
          int32_t v = 0;
          if (m < nr) {
            const int mm = c0 * psize + m0 + m;
            if (BSTEP) {
              uint32_t sum = 0;
              for (int i = 0; i < block; ++i) {
                const int32_t* pmi = pm + ((size_t)i * P + pi) * kk * mdim * n;
                uint64_t dot = 0;
                for (int k = 0; k < kk; ++k)
                  dot = mac_guard(dot, res[k * n + pos],
                                  (uint32_t)__ldg(pmi + ((size_t)k * mdim + mm) * n + pos), p);
                const int64_t row = __ldg(amounts + b * block + i) & (2 * n - 1);
                const uint32_t w = (uint32_t)__ldg(xpm1 + ((size_t)row * P + pi) * n + pos);
                sum = add_mod(sum, mont_mul(fold_redc(dot, p, qinv), w, p, qinv), p);
              }
              v = (int32_t)sum;
            } else {
              const int32_t* pmp = pm + (size_t)pi * kk * mdim * n;
              uint64_t acc = 0;
              for (int k = 0; k < kk; ++k)
                acc = mac_guard(acc, res[k * n + pos],
                                (uint32_t)__ldg(pmp + ((size_t)k * mdim + mm) * n + pos), p);
              v = (int32_t)fold_redc(acc, p, qinv);
            }
          }
          int8_t* dst = lo + (size_t)(m * s.n2 + (pos >> s.logn1)) * lda_b + (pos & (s.n1 - 1));
          for (int j = 0; j < NDIG; ++j) dst[j * s.n1] = (int8_t)digit_step(v);
        }
        __syncthreads();
        clk.mark(ST_VMP);
        int8_t* c_op = (int8_t*)hi(planes_a_bytes(s, nrp));
        inv_step_a(lo, c_op, nrp, s, wa_f + pi * s.words_b(), ti + (size_t)pi * n, p, qinv);
        __syncthreads();
        clk.mark(ST_INV_A);
        uint32_t* xo = xs + ((size_t)pi * mrows + m0) * n;
        inv_step_b(c_op, nrp, s, w0_f + pi * s.words_a(), p, qinv, [&](int r, int pos, uint32_t v) {
          if (r < nr) xo[r * n + pos] = v;
        });
        __syncthreads();
        clk.mark(ST_INV_B);
      }
    }

    // the exit (the N^{-1} scale of modarith.cuh lift_limb is in the inverse's weights)
    for (int idx = threadIdx.x; idx < (cpb << logn); idx += blockDim.x) {
      const int col = idx >> logn;
      const int coef = idx & (n - 1);
      const bool body = !BSTEP && small != nullptr && c0 + col == 0;
      const int64_t* acc_col = ab + (int64_t)(c0 + col) * size_a * n + coef;
      int64_t big[MAX_LIMBS];
      for (int j = 0; j < psize; ++j) {
        uint32_t r[MAX_PRIMES];
        for (int pi = 0; pi < P; ++pi) r[pi] = xs[((size_t)pi * mrows + col * psize + j) * n + coef];
        big[j] = garner(r, P, consts);
        if (BSTEP && j < size_a) big[j] = wadd(big[j], (int64_t)(int32_t)acc_col[(int64_t)j * n]);
        if (body && j < s_size) big[j] = wadd(big[j], small[(b * s_size + j) * n + coef]);
      }
      int64_t res[MAX_LIMBS];
      normalize_full(big, psize, res, res_size, kr, ka);
      int64_t* o = out + (b * co + c0 + col) * res_size * n + coef;
      for (int i = 0; i < res_size; ++i) o[(int64_t)i * n] = res[i];
    }
    if (TIMED) {
      __syncthreads();
      clk.mark(ST_EXIT);
    }
  });
  clk.store(stamps);
}

// ---- the tile design (the shared layout) ----

// The 4 digit planes of v into the inverse's operand at row `row`, position pos.
__device__ __forceinline__ void put_digits(int8_t* lo, const Split& s, int row, int pos,
                                           int32_t v) {
  int8_t* dst = lo + (size_t)(row * s.n2 + (pos >> s.logn1)) * s.lda_b() + (pos & (s.n1 - 1));
#pragma unroll
  for (int j = 0; j < NDIG; ++j) dst[j * s.n1] = (int8_t)digit_step(v);
}

// ---- the specialised shapes' stages: the step weights prefetched ----

// Compile-time four-step split of N = 2^LOGN (Split).
template <int LOGN>
struct SplitC {
  static constexpr int logn = LOGN, logn1 = LOGN - 3 < 1 ? 1 : (LOGN - 3 > 7 ? 7 : LOGN - 3);
  static constexpr int n = 1 << logn, n1 = 1 << logn1, n2 = n >> logn1, logn2 = logn - logn1;
  static constexpr int lda_a = NDIG * n2 + PAD, lda_b = NDIG * n1 + PAD;
};

// Row tiles of 16 per warp task for M rows: the most of 4, 3, 2, 1 that divide M/16.
__host__ __device__ constexpr int mch_for(int m) {
  return m % 64 == 0 ? 4 : m % 48 == 0 ? 3 : m % 32 == 0 ? 2 : 1;
}

// mma_digits_tiles with every size known: C[row][d·NCOLS + col] = Σ_k
// A[row][k]·W[k][d·NCOLS + col] for M rows and K = 32·KSTEPS, the k-loop
// unrolled and each warp's weight fragments loaded D − 1 k-steps ahead.
template <int M, int KSTEPS, int NCOLS, class Epi>
__device__ __forceinline__ void mma_pf(const int8_t* A, int lda, const int2* __restrict__ wf,
                                       Epi epi) {
  constexpr int MCH = mch_for(M), CT = NCOLS / 8, D = KSTEPS < 3 ? KSTEPS : 3;
  constexpr int TASKS = M / (16 * MCH) * CT;
  constexpr int DSTR = CT * KSTEPS * 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int task = threadIdx.x >> 5; task < TASKS; task += THREADS >> 5) {
    const int m0 = task / CT * 16 * MCH, ct = task % CT;
    const int2* w = wf + (size_t)ct * KSTEPS * 32 + lane;
    int acc[MCH][NDIG][4] = {};
    int2 b[D][NDIG];
#pragma unroll
    for (int ks = 0; ks < D - 1; ++ks)
#pragma unroll
      for (int d = 0; d < NDIG; ++d) b[ks][d] = __ldg(w + d * DSTR + ks * 32);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks + D - 1 < KSTEPS) {
#pragma unroll
        for (int d = 0; d < NDIG; ++d)
          b[(ks + D - 1) % D][d] = __ldg(w + d * DSTR + (ks + D - 1) * 32);
      }
#pragma unroll
      for (int mt = 0; mt < MCH; ++mt) {
        const int8_t* row = A + (size_t)(m0 + mt * 16 + g) * lda + ks * 32 + t * 4;
        const uint32_t a[4] = {*(const uint32_t*)row, *(const uint32_t*)(row + 8 * lda),
                               *(const uint32_t*)(row + 16),
                               *(const uint32_t*)(row + 8 * lda + 16)};
#pragma unroll
        for (int d = 0; d < NDIG; ++d) mma_s8(acc[mt][d], a, b[ks % D][d]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MCH; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        epi(m0 + mt * 16 + g + 8 * (i >> 1), ct * 8 + t * 2 + (i & 1), acc[mt][0][i],
            acc[mt][1][i], acc[mt][2][i], acc[mt][3][i]);
  }
}

// fwd_planes for ROWS rows with four coefficients per thread (columns 4q..4q+3
// of a plane row, k1 + n1·(4q + j)): their loads in flight together, each
// plane's 4 digits stored as one word.
template <int LOGN, int ROWS, class Src>
__device__ __forceinline__ void fwd_planes_pf(int8_t* a_op, Src src) {
  using C = SplitC<LOGN>;
  constexpr int Q = C::n2 / 4;
  for (int idx = threadIdx.x; idx < ROWS * C::n1 * Q; idx += THREADS) {
    const int k1 = idx % C::n1, rq = idx / C::n1, q = rq % Q, r = rq / Q;
    int32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = src(r, k1 + C::n1 * (4 * q + j));
    uint32_t w[NDIG] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < NDIG; ++i) w[i] |= (uint32_t)(uint8_t)digit_step(v[j]) << (8 * j);
    uint32_t* dst = (uint32_t*)(a_op + (size_t)(r * C::n1 + k1) * C::lda_a + 4 * q);
#pragma unroll
    for (int i = 0; i < NDIG; ++i) dst[i * C::n2 / 4] = w[i];
  }
}

// fwd_step_a, fwd_step_b, inv_step_a, inv_step_b (mxu.cuh) for ROWS rows through mma_pf.
template <int LOGN, int ROWS>
__device__ __forceinline__ void fwd_step_a_pf(const int8_t* a_op, int8_t* b_op,
                                              const int2* __restrict__ ua_f,
                                              const int32_t* __restrict__ tf, uint32_t p,
                                              uint32_t qinv) {
  using C = SplitC<LOGN>;
  mma_pf<ROWS * C::n1, C::n2 / 8, C::n2>(a_op, C::lda_a, ua_f,
      [&](int row, int k2, int p0, int p1, int p2, int p3) {
        const int r = row >> C::logn1, n1i = row & (C::n1 - 1);
        const uint32_t a = assemble_redc2(p0, p1, p2, p3, p, qinv);
        int32_t v = (int32_t)mont_mul(a, (uint32_t)__ldg(tf + n1i * C::n2 + k2), p, qinv);
        int8_t* dst = b_op + (size_t)(r * C::n2 + k2) * C::lda_b + n1i;
#pragma unroll
        for (int j = 0; j < NDIG; ++j) dst[j * C::n1] = (int8_t)digit_step(v);
      });
}

template <int LOGN, int ROWS, class Out>
__device__ __forceinline__ void fwd_step_b_pf(const int8_t* b_op, const int2* __restrict__ v0_f,
                                              uint32_t p, uint32_t qinv, Out out) {
  using C = SplitC<LOGN>;
  mma_pf<ROWS * C::n2, C::n1 / 8, C::n1>(b_op, C::lda_b, v0_f,
      [&](int row, int k1, int p0, int p1, int p2, int p3) {
        out(row >> C::logn2, ((row & (C::n2 - 1)) << C::logn1) + k1,
            assemble_redc2(p0, p1, p2, p3, p, qinv));
      });
}

template <int LOGN, int ROWS>
__device__ __forceinline__ void inv_step_a_pf(const int8_t* a_op, int8_t* b_op,
                                              const int2* __restrict__ wa_f,
                                              const int32_t* __restrict__ ti, uint32_t p,
                                              uint32_t qinv) {
  using C = SplitC<LOGN>;
  mma_pf<ROWS * C::n2, C::n1 / 8, C::n1>(a_op, C::lda_b, wa_f,
      [&](int row, int n1i, int p0, int p1, int p2, int p3) {
        const int r = row >> C::logn2, k2 = row & (C::n2 - 1);
        const uint32_t b = assemble_redc2(p0, p1, p2, p3, p, qinv);
        int32_t v = (int32_t)mont_mul(b, (uint32_t)__ldg(ti + n1i * C::n2 + k2), p, qinv);
        int8_t* dst = b_op + (size_t)(r * C::n1 + n1i) * C::lda_a + k2;
#pragma unroll
        for (int j = 0; j < NDIG; ++j) dst[j * C::n2] = (int8_t)digit_step(v);
      });
}

template <int LOGN, int ROWS, class Out>
__device__ __forceinline__ void inv_step_b_pf(const int8_t* b_op, const int2* __restrict__ w0_f,
                                              uint32_t p, uint32_t qinv, Out out) {
  using C = SplitC<LOGN>;
  mma_pf<ROWS * C::n1, C::n2 / 8, C::n2>(b_op, C::lda_a, w0_f,
      [&](int row, int n2i, int p0, int p1, int p2, int p3) {
        out(row >> C::logn1, (n2i << C::logn1) + (row & (C::n1 - 1)),
            assemble_redc2(p0, p1, p2, p3, p, qinv));
      });
}

struct TileArgs {
  const int64_t* a;
  const int32_t* pm;
  const int64_t* small;
  const int32_t* xpm1;
  const int64_t* amounts;
  int64_t* out;
  const int2* ua_f;
  const int2* v0_f;
  const int32_t* tf;
  const int2* wa_f;
  const int2* w0_f;
  const int32_t* ti;
  const int64_t* consts;
  long long* stamps;
  int B, ci, size_a, rmax, co, psize, s_size, res_size, kr, ka, cpb, block, P, logn, T, s_bytes;
};

// The compile-time shape of an instance; 0 leaves a dimension to TileArgs.
template <int T_, int LOGN_, int KK_, int MR_, int P_, int BLOCK_, int PS_, int RS_>
struct Shape {
  static constexpr int T = T_, LOGN = LOGN_, KK = KK_, MR = MR_, P = P_, BLOCK = BLOCK_,
                       PS = PS_, RS = RS_;
};
using RuntimeShape = Shape<0, 0, 0, 0, 0, 0, 0, 0>;
// the paths' shapes (backends/fused_mxu.py TILE_SHAPES): the gate's block
// step, bench.py's product, the keyswitch's product with the body
using GateShape = Shape<2, 10, 4, 8, 2, 8, 4, 2>;
using ProductShape = Shape<1, 11, 6, 8, 2, 0, 4, 3>;
using SmallShape = Shape<1, 11, 3, 8, 2, 0, 4, 3>;

template <int V>
__device__ __forceinline__ int dim(int rt) {
  return V ? V : rt;
}

// Bytes of the x-power rows [T·block] int32 at the head of shared memory.
__device__ __forceinline__ int xrow_bytes(int T, int block) {
  return (4 * T * block + 15) & ~15;
}

// The VMP of one prime for a tile, straight into the inverse's digit planes
// (lo, rows t·mrows + m).  Specialised shapes: one thread per coefficient
// holds the T·MR sums in registers, so each key word is loaded once per tile
// and (block step) each x-power product res·X^{a_i} is made once per
// (ciphertext, key element, input row) and shared by the MR output rows:
//   product     y[t][m] = Σ_k res[t][k]·pm[k][m]·R^{-1}
//   block step  y[t][m] = Σ_i Σ_k (res[t][k]·X_t,i·R^{-1})·pm_i[k][m]·R^{-1}
// — fused_mxu_kernel's Σ_i mont(fold_redc(Σ_k res·pm_i), X_t,i) mod p,
// canonical, so the bits are the same.  The sums run lazily in u64, folded
// every 8 terms, and are reduced once (reduce_redc).
template <class S, bool BSTEP>
__device__ __forceinline__ void vmp_tile(int8_t* lo, const uint32_t* res, const TileArgs& g,
                                         const int* xrow, int pi, int c0, int T, int kk,
                                         int mrows, int P, int block, const Split& s,
                                         const PrimeK& pk) {
  const int n = s.n, mdim = g.co * g.psize, TM = T * mrows;
  if constexpr (S::T != 0) {
    constexpr int TT = S::T, KK = S::KK, MR = S::MR;
    for (int pos = threadIdx.x; pos < n; pos += THREADS) {
      uint64_t acc[TT][MR];
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[t][m] = 0;
      const int nblk = BSTEP ? S::BLOCK : 1;
#pragma unroll 1
      for (int i = 0; i < nblk; ++i) {
        const int32_t* pmi =
            g.pm + ((size_t)(BSTEP ? i * P + pi : pi) * KK * mdim + c0 * g.psize) * n + pos;
        uint32_t xw[TT];
        if (BSTEP) {
#pragma unroll
          for (int t = 0; t < TT; ++t)
            xw[t] = (uint32_t)__ldg(g.xpm1 + ((size_t)xrow[t * S::BLOCK + i] * P + pi) * n + pos);
        }
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          uint32_t x[TT];
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            x[t] = res[(t * KK + k) * n + pos];
            if (BSTEP) x[t] = mont_mul(x[t], xw[t], pk.p, pk.qinv);
          }
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const uint64_t w = (uint32_t)__ldg(pmi + (size_t)(k * mdim + m) * n);
#pragma unroll
            for (int t = 0; t < TT; ++t) acc[t][m] += x[t] * w;
          }
          if ((i * KK + k + 1) % 8 == 0) {
#pragma unroll
            for (int t = 0; t < TT; ++t)
#pragma unroll
              for (int m = 0; m < MR; ++m) acc[t][m] = fold32(acc[t][m], pk.c32);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int m = 0; m < MR; ++m)
          put_digits(lo, s, t * MR + m, pos, (int32_t)reduce_redc(acc[t][m], pk));
    }
    if (TT * MR % 2)   // the padded row
      for (int pos = threadIdx.x; pos < n; pos += THREADS) put_digits(lo, s, TT * MR, pos, 0);
  } else {
    // one output per thread and item, every shape
    const int TMp = (TM + 1) & ~1;
    for (int idx = threadIdx.x; idx < (TMp << s.logn); idx += THREADS) {
      const int m = idx >> s.logn, pos = idx & (n - 1);
      int32_t v = 0;
      if (m < TM) {
        const int t = m / mrows, mm = c0 * g.psize + m - t * mrows;
        const uint32_t* rt = res + (size_t)t * kk * n + pos;
        uint64_t acc = 0;
        int terms = 0;
        for (int i = 0; i < (BSTEP ? block : 1); ++i) {
          const int32_t* pmi =
              g.pm + ((size_t)(BSTEP ? i * P + pi : pi) * kk * mdim + mm) * n + pos;
          const uint32_t xw =
              BSTEP ? (uint32_t)__ldg(g.xpm1 + ((size_t)xrow[t * block + i] * P + pi) * n + pos)
                    : 0;
          for (int k = 0; k < kk; ++k) {
            const uint32_t x = BSTEP ? mont_mul(rt[k * n], xw, pk.p, pk.qinv) : rt[k * n];
            acc += (uint64_t)x * (uint32_t)__ldg(pmi + (size_t)k * mdim * n);
            if (++terms == 8) {
              acc = fold32(acc, pk.c32);
              terms = 0;
            }
          }
        }
        v = (int32_t)reduce_redc(acc, pk);
      }
      put_digits(lo, s, m, pos, v);
    }
  }
}

// The fused MXU kernel, tile design: one block per tile of T ciphertexts and
// group of cpb output columns, every stage on the tile's stacked rows (the
// step-B weight fragments are loaded once per 64 rows and the key words once
// per tile).  Shared memory: the x-power rows (block step), the coefficient
// residues [P−1][T·mrows][N] of primes 0..P−2, then the staging region of
// fused_mxu_kernel for T·kk input and T·mrows output rows.  TIMED: the stage
// clock, stamps [blocks][NSTAGES].
template <class S, bool BSTEP, bool TIMED>
__global__ void __launch_bounds__(THREADS, 1) fused_mxu_tile_kernel(const TileArgs g) {
  constexpr bool FIX = S::T != 0;
  constexpr int FL = FIX ? S::LOGN : 10, FK = FIX ? (S::T * S::KK + 1) & ~1 : 2,
                FM = FIX ? (S::T * S::MR + 1) & ~1 : 2;
  extern __shared__ __align__(16) uint8_t smem[];
  StageClock<TIMED, NSTAGES> clk;
  const int T = dim<S::T>(g.T), logn = dim<S::LOGN>(g.logn), kk = dim<S::KK>(g.ci * g.rmax);
  const int mrows = dim<S::MR>(g.cpb * g.psize), P = dim<S::P>(g.P);
  const int block = dim<S::BLOCK>(g.block), psize = dim<S::PS>(g.psize);
  const int res_size = dim<S::RS>(g.res_size), cpb = mrows / psize;
  const Split s(logn);
  const int n = s.n;
  const int TK = T * kk, TM = T * mrows, TKp = (TK + 1) & ~1, TMp = (TM + 1) & ~1;
  const int groups = g.co / cpb;
  const int c0 = (blockIdx.x % groups) * cpb;
  const int64_t b0 = (int64_t)(blockIdx.x / groups) * T;
  const int nt = (int)min((int64_t)T, (int64_t)g.B - b0);   // ciphertexts in this tile

  int* xrow = (int*)smem;
  uint32_t* xs = (uint32_t*)(smem + xrow_bytes(T, BSTEP ? block : 0));   // [P][TM][n]
  uint8_t* stage = (uint8_t*)(xs + (size_t)(P - 1) * TM * n);
  int8_t* lo = (int8_t*)stage;
  auto hi = [&](size_t bytes) { return stage + g.s_bytes - bytes; };
  if (BSTEP)
    for (int i = threadIdx.x; i < T * block; i += THREADS) {
      const int t = i / block;
      xrow[i] = t < nt ? (int)(g.amounts[(b0 + t) * block + i - t * block] & (2 * n - 1)) : 0;
    }

  for (int pi = 0; pi < P; ++pi) {
    const PrimeK pk(g.consts, pi);
    // forward: the tile's input rows (row t·kk + k: ciphertext t, column-major
    // over ci, limb-minor; rows past the tile zero) → σ residues [TK][n]
    uint32_t* res = (uint32_t*)hi((size_t)4 * TK * n);
    int8_t* a_op = (int8_t*)hi(planes_a_bytes(s, TKp));
    auto src = [&](int r, int pos) -> int32_t {
      const int t = r / kk, k = r - t * kk;
      if (t >= nt) return 0;
      const int col = k / g.rmax;
      return (int32_t)g.a[(((b0 + t) * g.ci + col) * g.size_a + k - col * g.rmax) * n + pos];
    };
    auto to_res = [&](int r, int pos, uint32_t y) {
      if (r < TK) res[r * n + pos] = y;
    };
    if constexpr (FIX) fwd_planes_pf<FL, FK>(a_op, src);
    else fwd_planes(a_op, TKp, NDIG, s, src);
    __syncthreads();
    clk.mark(ST_PLANES);
    const int2* ua = g.ua_f + pi * s.words_a();
    if constexpr (FIX) fwd_step_a_pf<FL, FK>(a_op, lo, ua, g.tf + (size_t)pi * n, pk.p, pk.qinv);
    else fwd_step_a(a_op, lo, TKp, s, ua, g.tf + (size_t)pi * n, pk.p, pk.qinv);
    __syncthreads();
    clk.mark(ST_FWD_A);
    if constexpr (FIX) fwd_step_b_pf<FL, FK>(lo, g.v0_f + pi * s.words_b(), pk.p, pk.qinv, to_res);
    else fwd_step_b(lo, TKp, s, g.v0_f + pi * s.words_b(), pk.p, pk.qinv, to_res);
    __syncthreads();
    clk.mark(ST_FWD_B);
    vmp_tile<S, BSTEP>(lo, res, g, xrow, pi, c0, T, kk, mrows, P, block, s, pk);
    __syncthreads();
    clk.mark(ST_VMP);
    int8_t* c_op = (int8_t*)hi(planes_a_bytes(s, TMp));
    const int2* wa = g.wa_f + pi * s.words_b();
    if constexpr (FIX) inv_step_a_pf<FL, FM>(lo, c_op, wa, g.ti + (size_t)pi * n, pk.p, pk.qinv);
    else inv_step_a(lo, c_op, TMp, s, wa, g.ti + (size_t)pi * n, pk.p, pk.qinv);
    __syncthreads();
    clk.mark(ST_INV_A);
    uint32_t* xo = xs + (size_t)pi * TM * n;   // prime P−1: the staging region's head
    auto to_xo = [&](int r, int pos, uint32_t v) {
      if (r < TM) xo[r * n + pos] = v;
    };
    if constexpr (FIX) inv_step_b_pf<FL, FM>(c_op, g.w0_f + pi * s.words_a(), pk.p, pk.qinv, to_xo);
    else inv_step_b(c_op, TMp, s, g.w0_f + pi * s.words_a(), pk.p, pk.qinv, to_xo);
    __syncthreads();
    clk.mark(ST_INV_B);
  }

  // the exit, one thread per (ciphertext, column, coefficient); the per-thread
  // arrays have the instance's sizes
  constexpr int PSMAX = S::PS ? S::PS : MAX_LIMBS, RSMAX = S::RS ? S::RS : MAX_LIMBS;
  constexpr int PMAX = S::P ? S::P : MAX_PRIMES;
  for (int idx = threadIdx.x; idx < ((nt * cpb) << logn); idx += THREADS) {
    const int tc = idx >> logn, coef = idx & (n - 1);
    const int t = tc / cpb, col = tc - t * cpb;
    const int64_t b = b0 + t;
    const bool body = !BSTEP && g.small != nullptr && c0 + col == 0;
    const int64_t* acc_col = g.a + ((b * g.ci + c0 + col) * g.size_a) * n + coef;
    int64_t big[PSMAX];
#pragma unroll
    for (int j = 0; j < psize; ++j) {
      uint32_t r[PMAX];
#pragma unroll
      for (int pi = 0; pi < P; ++pi)
        r[pi] = xs[((size_t)pi * TM + t * mrows + col * psize + j) * n + coef];
      big[j] = garner(r, P, g.consts);
      if (BSTEP && j < g.size_a) big[j] = wadd(big[j], (int64_t)(int32_t)acc_col[(int64_t)j * n]);
      if (body && j < g.s_size) big[j] = wadd(big[j], g.small[(b * g.s_size + j) * n + coef]);
    }
    int64_t res[RSMAX];
    normalize_full(big, psize, res, res_size, g.kr, g.ka);
    int64_t* o = g.out + ((b * g.co + c0 + col) * res_size) * n + coef;
#pragma unroll
    for (int i = 0; i < res_size; ++i) o[(int64_t)i * n] = res[i];
  }
  if (TIMED) {
    __syncthreads();
    clk.mark(ST_EXIT);
  }
  clk.store(g.stamps);
}

template <class S, bool BSTEP>
int launch_tile(const TileArgs& g, int grid, int smem, cudaStream_t stream) {
  auto kernel = fused_mxu_tile_kernel<S, BSTEP, false>;
  if constexpr (S::T == 0) {
    if (g.stamps != nullptr) return (int)cudaErrorInvalidValue;   // the clock: TILE_SHAPES only
  } else {
    if (g.stamps != nullptr) kernel = fused_mxu_tile_kernel<S, BSTEP, true>;
  }
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, THREADS, (size_t)smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <class S>
bool is_shape(const TileArgs& g, bool bstep) {
  return g.T == S::T && g.logn == S::LOGN && g.ci * g.rmax == S::KK &&
         g.cpb * g.psize == S::MR && g.P == S::P && (bstep ? g.block : 0) == S::BLOCK &&
         g.psize == S::PS && g.res_size == S::RS;
}

}  // namespace

// The tile design: the same arguments as poulpy_fused_mxu_product (without
// the global layout's), plus T ciphertexts per block (backends/fused_mxu.py
// tile_layout); the grid is ⌈B/T⌉·co/cpb blocks.  A shape of TILE_SHAPES
// takes its specialised instance, any other the runtime-shaped one.  stamps:
// null, or [blocks][7] int64 for the stage clock (specialised shapes only).
extern "C" int poulpy_fused_mxu_tile(const void* a, const void* pm, const void* small,
                                     const void* xpm1, const void* amounts, void* out,
                                     const void* ua_f, const void* v0_f, const void* tf,
                                     const void* wa_f, const void* w0_f, const void* ti,
                                     const void* consts, int B, int ci, int size_a, int rmax,
                                     int co, int psize, int s_size, int res_size, int kr, int ka,
                                     int cpb, int block, int P, int logn, int T, int s_bytes,
                                     int smem, void* stamps, void* stream) {
  const TileArgs g{(const int64_t*)a, (const int32_t*)pm, (const int64_t*)small,
                   (const int32_t*)xpm1, (const int64_t*)amounts, (int64_t*)out,
                   (const int2*)ua_f, (const int2*)v0_f, (const int32_t*)tf, (const int2*)wa_f,
                   (const int2*)w0_f, (const int32_t*)ti, (const int64_t*)consts,
                   (long long*)stamps, B, ci, size_a, rmax, co, psize, s_size, res_size, kr, ka,
                   cpb, block, P, logn, T, s_bytes};
  const int grid = (B + T - 1) / T * (co / cpb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (block > 0)
    return is_shape<GateShape>(g, true) ? launch_tile<GateShape, true>(g, grid, smem, st)
                                        : launch_tile<RuntimeShape, true>(g, grid, smem, st);
  if (is_shape<ProductShape>(g, false)) return launch_tile<ProductShape, false>(g, grid, smem, st);
  if (is_shape<SmallShape>(g, false)) return launch_tile<SmallShape, false>(g, grid, smem, st);
  return launch_tile<RuntimeShape, false>(g, grid, smem, st);
}

// a: [B, ci, size_a, N] int64; pm: the product's [P, ci·rmax, co·psize, N] or
// the block step's [block, P, ci·rmax, co·psize, N] int32 Montgomery in σ
// order (backends/fused.py pm_kernel_layout of pmat[..., σ]); small: [B,
// s_size, N] int64 or null with s_size 0; xpm1: the σ-order [2N, P, N] int32
// Montgomery NTT(X^j − 1) and amounts [B, block] int64 for the block step
// (block > 0), else null with block 0; out: [B, co, res_size, N] int64 (not
// aliasing a); ua_f … ti: backends/mxu.py device_tables; consts:
// backends/ntt.py kernel_tables; cpb: output columns per block (divides co);
// s_bytes, smem: the staging region and the whole (backends/fused_mxu.py
// mxu_layout).  ws: null for the shared layout, else the global layout's
// workspace of `grid` slots of ci·rmax + P·cpb·psize rows of N words, crows
// rows per transform pass.  stamps: null, or [tasks][7] int64 for the stage
// clock of the shared layout.  Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_mxu_product(const void* a, const void* pm, const void* small,
                                        const void* xpm1, const void* amounts, void* out,
                                        const void* ua_f, const void* v0_f, const void* tf,
                                        const void* wa_f, const void* w0_f, const void* ti,
                                        const void* consts, int B, int ci, int size_a, int rmax,
                                        int co, int psize, int s_size, int res_size, int kr,
                                        int ka, int cpb, int block, int P, int logn, int s_bytes,
                                        int smem, void* ws, int crows, int grid, void* stamps,
                                        void* stream) {
  const bool staged = ws != nullptr;
  if (staged && stamps != nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel =
      stamps != nullptr
          ? (block > 0 ? fused_mxu_kernel<true, false, true> : fused_mxu_kernel<false, false, true>)
      : block > 0 ? (staged ? fused_mxu_kernel<true, true> : fused_mxu_kernel<true, false>)
                  : (staged ? fused_mxu_kernel<false, true> : fused_mxu_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tasks = B * (co / cpb);
  kernel<<<(unsigned)(staged ? grid : tasks), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (const int32_t*)xpm1,
      (const int64_t*)amounts, (int64_t*)out, (const int2*)ua_f, (const int2*)v0_f,
      (const int32_t*)tf, (const int2*)wa_f, (const int2*)w0_f, (const int32_t*)ti,
      (const int64_t*)consts, ci, size_a, rmax, co, psize, s_size, res_size, kr, ka, cpb, block, P,
      logn, s_bytes, (uint32_t*)ws, crows, tasks, (long long*)stamps);
  return (int)cudaGetLastError();
}
