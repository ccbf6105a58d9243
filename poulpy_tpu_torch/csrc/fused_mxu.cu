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
// blind_rotation.py:491-505).  The block count is a runtime argument, so
// every block size shares the BSTEP instance.  Plain twins:
// poulpy_tpu_torch/backends/fused_mxu.py fused_mxu_glwe_product_ref and
// fused_mxu_br_block_step_ref.
//
// What bounds it on the H100: on paper the int8 tensor-core rate (at the
// bench shape, N 2048, KK 6, M 8, P 2: 134 M multiply-adds per ciphertext
// against 48 bytes in and 48 out per coefficient); the block step adds
// block·KK·M·P·N int32 modular products of the VMP and block·M·P·N of the
// x-power factor, which stay on the int32 lanes and outweigh the transforms
// at the gate shape (N 1024, KK 4, M 8, block 8).  The step-B weights (256 KB
// per prime and direction) and the key elements are read from L2 by every
// block.
// Design (simple first): one block (512 threads) per ciphertext and group of
// `cpb` output columns (backends/fused_mxu.py mxu_layout; the block step
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
// Where those rows do not fit (bench.py's shape at N 8192 needs 1.5 MB), the
// STAGED instance takes the global layout of modarith.cuh: the σ residues
// [KK][N] and the coefficient residues [P][mrows][N] live in the block's
// global workspace slot, and the transforms run `crows` rows at a time
// through a staging region of their planes alone (2 rows at N 8192).
#include "mxu.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

// BSTEP: the block-step pattern (rotate, add_acc; pm holds `block` key
// elements, xpm1 and amounts are read).  STAGED: the global layout.
template <bool BSTEP, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) fused_mxu_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, const int32_t* __restrict__ xpm1,
    const int64_t* __restrict__ amounts, int64_t* __restrict__ out, const int2* __restrict__ ua_f,
    const int2* __restrict__ v0_f, const int32_t* __restrict__ tf, const int2* __restrict__ wa_f,
    const int2* __restrict__ w0_f, const int32_t* __restrict__ ti,
    const int64_t* __restrict__ consts, int ci, int size_a, int rmax, int co, int psize,
    int s_size, int res_size, int kr, int ka, int cpb, int block, int P, int logn, int s_bytes,
    uint32_t* __restrict__ ws, int crows, int tasks) {
  extern __shared__ __align__(16) uint8_t smem[];
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
        fwd_step_a(a_op, lo, nrp, s, ua_f + pi * s.words_a(), tf + (size_t)pi * n, p, qinv);
        __syncthreads();
        fwd_step_b(lo, nrp, s, v0_f + pi * s.words_b(), p, qinv, [&](int r, int pos, uint32_t y) {
          if (r < nr) res[(r0 + r) * n + pos] = y;
        });
        __syncthreads();
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
        int8_t* c_op = (int8_t*)hi(planes_a_bytes(s, nrp));
        inv_step_a(lo, c_op, nrp, s, wa_f + pi * s.words_b(), ti + (size_t)pi * n, p, qinv);
        __syncthreads();
        uint32_t* xo = xs + ((size_t)pi * mrows + m0) * n;
        inv_step_b(c_op, nrp, s, w0_f + pi * s.words_a(), p, qinv, [&](int r, int pos, uint32_t v) {
          if (r < nr) xo[r * n + pos] = v;
        });
        __syncthreads();
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
  });
}

}  // namespace

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
// rows per transform pass.  Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_mxu_product(const void* a, const void* pm, const void* small,
                                        const void* xpm1, const void* amounts, void* out,
                                        const void* ua_f, const void* v0_f, const void* tf,
                                        const void* wa_f, const void* w0_f, const void* ti,
                                        const void* consts, int B, int ci, int size_a, int rmax,
                                        int co, int psize, int s_size, int res_size, int kr,
                                        int ka, int cpb, int block, int P, int logn, int s_bytes,
                                        int smem, void* ws, int crows, int grid, void* stream) {
  const bool staged = ws != nullptr;
  const auto kernel = block > 0 ? (staged ? fused_mxu_kernel<true, true> : fused_mxu_kernel<true, false>)
                                : (staged ? fused_mxu_kernel<false, true> : fused_mxu_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tasks = B * (co / cpb);
  kernel<<<(unsigned)(staged ? grid : tasks), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (const int32_t*)xpm1,
      (const int64_t*)amounts, (int64_t*)out, (const int2*)ua_f, (const int2*)v0_f,
      (const int32_t*)tf, (const int2*)wa_f, (const int2*)w0_f, (const int32_t*)ti,
      (const int64_t*)consts, ci, size_a, rmax, co, psize, s_size, res_size, kr, ka, cpb, block, P,
      logn, s_bytes, (uint32_t*)ws, crows, tasks);
  return (int)cudaGetLastError();
}
