// Fused GLWE x GGSW / GLWE x GGLWE product through the four-step digit-plane
// transforms, one launch for a batch:
//   out = normalize(garner(mxu_inverse(vmp(mxu_forward(a), pm_σ))) [+ small at column 0])
// from int64 limbs [B, ci, size_a, N] (wrapped to int32) to normalized int64
// limbs [B, co, res_size, N].
//
// Replaces: poulpy_tpu/backends/pallas_fused_mxu.py, _pipe_mxu_fn ->
// _kernel_pipe_mxu via fused_mxu_glwe_product, the product and `small` call
// patterns (block = 1, no rotate, no add_acc).  The block-step pattern
// (fused_mxu_br_block_step) takes the template parameters BLOCK, ROTATE and
// ADD_ACC; only <1, false, false> is instantiated here.  Plain twin:
// poulpy_tpu_torch/backends/fused_mxu.py fused_mxu_glwe_product_ref.
//
// What bounds it on the H100: on paper the int8 tensor-core rate (at the
// bench shape, N 2048, KK 6, M 8, P 2: 134 M multiply-adds per ciphertext
// against 48 bytes in and 48 out per coefficient).  The step-B weights (256 KB
// per prime and direction) are read from L2 by every block.
// Design (simple first): one block (512 threads) per ciphertext and group of
// `cpb` output columns (backends/fused.py cols_per_block with this kernel's
// shared-memory formula).  Shared memory holds the inverse's output rows of
// primes 0..P-2 (the Garner lift needs every prime of a coefficient), then a
// staging region reused by every stage, each stage reading at one end and
// writing at the other:
//   input planes (hi) → step A → planes (lo) → step B → σ residues [KK][N] (hi)
//   → VMP with the σ-order matrix, digitized (lo) → inverse step A → planes (hi)
//   → inverse step B → coefficient residues [mrows][N] (prime P-1: lo, which
//   is where the persistent rows continue).
// Rows are padded to an even count so that every product has M a multiple
// of 16; padded rows are zero.  Then one thread per (column, coefficient):
// the Garner lift of the psize limbs (no N^{-1} scale: the inverse's weights
// carry it), the body at column 0, normalize_full (modarith.cuh), as
// garner_exit.cu does.
#include "mxu.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 512;

template <int BLOCK, bool ROTATE, bool ADD_ACC>
__global__ void __launch_bounds__(THREADS, 1) fused_mxu_kernel(
    const int64_t* __restrict__ a, const int32_t* __restrict__ pm,
    const int64_t* __restrict__ small, int64_t* __restrict__ out, const int2* __restrict__ ua_f,
    const int2* __restrict__ v0_f, const int32_t* __restrict__ tf, const int2* __restrict__ wa_f,
    const int2* __restrict__ w0_f, const int32_t* __restrict__ ti,
    const int64_t* __restrict__ consts, int ci, int size_a, int rmax, int co, int psize,
    int s_size, int res_size, int kr, int ka, int cpb, int P, int logn, int s_bytes) {
  static_assert(BLOCK == 1 && !ROTATE && !ADD_ACC, "only the product pattern is instantiated");
  extern __shared__ __align__(16) uint8_t smem[];
  const Split s(logn);
  const int n = s.n;
  const int kk = ci * rmax, mdim = co * psize, mrows = cpb * psize;
  const int kkp = (kk + 1) & ~1, mrp = (mrows + 1) & ~1;
  const int groups = co / cpb;
  const int64_t b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * cpb;
  uint32_t* xs = (uint32_t*)smem;                                  // [P][mrows][n]
  uint8_t* stage = smem + (size_t)4 * (P - 1) * mrows * n;
  int8_t* lo = (int8_t*)stage;
  auto hi = [&](size_t bytes) { return stage + s_bytes - bytes; };
  const int64_t* ab = a + b * ci * size_a * n;

  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    // forward: the kk input rows (column-major over ci, limb-minor) → σ residues
    int8_t* a_op = (int8_t*)hi(planes_a_bytes(s, kkp));
    fwd_planes(a_op, kkp, NDIG, s, [&](int r, int pos) -> int32_t {
      if (r >= kk) return 0;
      const int col = r / rmax;
      return (int32_t)ab[((int64_t)col * size_a + (r - col * rmax)) * n + pos];
    });
    __syncthreads();
    fwd_step_a(a_op, lo, kkp, s, ua_f + pi * s.words_a(), tf + (size_t)pi * n, p, qinv);
    __syncthreads();
    uint32_t* res = (uint32_t*)hi((size_t)4 * kk * n);
    fwd_step_b(lo, kkp, s, v0_f + pi * s.words_b(), p, qinv, [&](int r, int pos, uint32_t y) {
      if (r < kk) res[r * n + pos] = y;
    });
    __syncthreads();
    // VMP of the block's rows, pointwise in σ order, straight into the
    // inverse's digit planes (row m·n2 + k2, column j·n1 + k1)
    const int32_t* pmp = pm + (size_t)pi * kk * mdim * n;
    const int lda_b = s.lda_b();
    for (int idx = threadIdx.x; idx < (mrp << s.logn); idx += blockDim.x) {
      const int m = idx >> s.logn, pos = idx & (n - 1);
      int32_t v = 0;
      if (m < mrows) {
        uint64_t acc = 0;
        for (int k = 0; k < kk; ++k)
          acc = mac_guard(acc, res[k * n + pos],
                          (uint32_t)__ldg(pmp + ((size_t)k * mdim + c0 * psize + m) * n + pos), p);
        v = (int32_t)fold_redc(acc, p, qinv);
      }
      int8_t* dst = lo + (size_t)(m * s.n2 + (pos >> s.logn1)) * lda_b + (pos & (s.n1 - 1));
      for (int j = 0; j < NDIG; ++j) dst[j * s.n1] = (int8_t)digit_step(v);
    }
    __syncthreads();
    // inverse → coefficient residues of prime pi
    int8_t* c_op = (int8_t*)hi(planes_a_bytes(s, mrp));
    inv_step_a(lo, c_op, mrp, s, wa_f + pi * s.words_b(), ti + (size_t)pi * n, p, qinv);
    __syncthreads();
    uint32_t* xo = xs + (size_t)pi * mrows * n;
    inv_step_b(c_op, mrp, s, w0_f + pi * s.words_a(), p, qinv, [&](int r, int pos, uint32_t v) {
      if (r < mrows) xo[r * n + pos] = v;
    });
    __syncthreads();
  }

  // the exit (the N^{-1} scale of modarith.cuh lift_limb is in the inverse's weights)
  for (int idx = threadIdx.x; idx < (cpb << logn); idx += blockDim.x) {
    const int col = idx >> logn;
    const int coef = idx & (n - 1);
    const bool body = small != nullptr && c0 + col == 0;
    int64_t big[MAX_LIMBS];
    for (int j = 0; j < psize; ++j) {
      uint32_t r[MAX_PRIMES];
      for (int pi = 0; pi < P; ++pi) r[pi] = xs[((size_t)pi * mrows + col * psize + j) * n + coef];
      big[j] = garner(r, P, consts);
      if (body && j < s_size) big[j] = wadd(big[j], small[(b * s_size + j) * n + coef]);
    }
    int64_t res[MAX_LIMBS];
    normalize_full(big, psize, res, res_size, kr, ka);
    int64_t* o = out + (b * co + c0 + col) * res_size * n + coef;
    for (int i = 0; i < res_size; ++i) o[(int64_t)i * n] = res[i];
  }
}

}  // namespace

// a: [B, ci, size_a, N] int64; pm: [P, ci·rmax, co·psize, N] int32 Montgomery in
// σ order (backends/fused.py pm_kernel_layout of pmat[..., σ]); small:
// [B, s_size, N] int64 or null with s_size 0; out: [B, co, res_size, N] int64;
// ua_f … ti: backends/mxu.py device_tables; consts: backends/ntt.py
// kernel_tables; cpb: output columns per block (divides co); s_bytes, smem:
// backends/fused_mxu.py fused_mxu_smem_bytes (the staging region, the whole).
// Returns the cudaError_t of the launch.
extern "C" int poulpy_fused_mxu_product(const void* a, const void* pm, const void* small,
                                        void* out, const void* ua_f, const void* v0_f,
                                        const void* tf, const void* wa_f, const void* w0_f,
                                        const void* ti, const void* consts, int B, int ci,
                                        int size_a, int rmax, int co, int psize, int s_size,
                                        int res_size, int kr, int ka, int cpb, int P, int logn,
                                        int s_bytes, int smem, void* stream) {
  const auto kernel = fused_mxu_kernel<1, false, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)B * (unsigned)(co / cpb), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int32_t*)pm, (const int64_t*)small, (int64_t*)out,
      (const int2*)ua_f, (const int2*)v0_f, (const int32_t*)tf, (const int2*)wa_f,
      (const int2*)w0_f, (const int32_t*)ti, (const int64_t*)consts, ci, size_a, rmax, co, psize,
      s_size, res_size, kr, ka, cpb, P, logn, s_bytes);
  return (int)cudaGetLastError();
}
