// Four-step negacyclic NTT as int8 digit-plane products on the tensor cores:
//   forward  int64 limbs [rows, N] (wrapped to int32) → σ-order residues [rows, P, N]
//   inverse  σ-order residues [rows, P, N] → coefficient residues [rows, P, N]
//
// Replaces: poulpy_tpu/backends/pallas_mxu.py, _fwd_fn -> _kernel_fwd and
// _inv_fn -> _kernel_inv (entries pallas_mxu4_forward_limbs /
// pallas_mxu4_inverse; caller mxu_product.py).  Plain twins:
// poulpy_tpu_torch/backends/mxu.py mxu4_forward_limbs_ref / mxu4_inverse_ref.
//
// What bounds it on the H100: on paper bytes and int8 products alike.  At N
// 2048 (n1 128, n2 16) a row costs per prime [16 × 512] × [512 × 512] (the
// inverse's step A) and [128 × 64] × [64 × 64] (its step B) multiply-adds,
// 4.7 M, against 4 bytes in and 4 out per coefficient: 1.25 ms of int8
// products and 1.28 ms of bytes for the "mxu" route's 131,072 rows.  On the
// card the epilogues are most of the work: each output is assembled from
// four int32 partials, reduced mod p, twiddled and (step A) cut into four
// digits, in 32-bit multiplies on the half-rate IMAD pipe.
//
// The parent designs of both transforms (the first designs, kept as the
// reference and the stage clocks' yardstick): one block of 256 threads per 4
// rows; shared memory holds the int8 operands of both steps (74,752 B at N
// 2048); per prime the input's digit planes (the forward's once), step A
// with its epilogue (assemble, REDC², twiddle, the 4 digit planes of the
// result written transposed as step B's operand), then step B with its
// epilogue (assemble, REDC², the residue to global); mma.sync m16n8k32 with
// the weights from L2 in fragment order (mxu.cuh).
//
// The wg designs (mxu_inverse_wg_kernel, mxu_forward_wg_kernel, the paths'
// designs for 512 ≤ N ≤ 8192): see the comments above them.
#include "mxu.cuh"

namespace {

using namespace poulpy;

constexpr int THREADS = 256;

// The stages of the transform kernels' stage clock (TIMED instances) in the
// parent design: the digit planes of the input (the forward's once), step A
// (products, epilogue, digits of the result), step B (products, epilogue,
// the residues to global memory).
enum { INV_PLANES, INV_STEP_A, INV_STEP_B, INV_NSTAGES };

template <bool TIMED>
__global__ void __launch_bounds__(THREADS) mxu_forward_kernel(
    const int64_t* __restrict__ x, int32_t* __restrict__ out, const int2* __restrict__ ua_f,
    const int2* __restrict__ v0_f, const int32_t* __restrict__ tf,
    const int64_t* __restrict__ consts, int rows, int nd_in, int P, int logn, int tr,
    long long* __restrict__ stamps) {
  extern __shared__ __align__(16) int8_t smem[];
  StageClock<TIMED, INV_NSTAGES> clk;
  const Split s(logn);
  int8_t* a_op = smem;
  int8_t* b_op = smem + planes_a_bytes(s, tr);
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int nr = rows - r0 < tr ? (int)(rows - r0) : tr;
  fwd_planes(a_op, tr, nd_in, s, [&](int r, int pos) -> int32_t {
    return r < nr ? (int32_t)x[(r0 + r) * s.n + pos] : 0;
  });
  __syncthreads();
  clk.mark(INV_PLANES);
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    fwd_step_a(a_op, b_op, tr, s, ua_f + pi * s.words_a(), tf + ((size_t)pi << logn), p, qinv);
    __syncthreads();
    clk.mark(INV_STEP_A);
    fwd_step_b(b_op, tr, s, v0_f + pi * s.words_b(), p, qinv, [&](int r, int pos, uint32_t y) {
      if (r < nr) out[(((r0 + r) * P + pi) << logn) + pos] = (int32_t)y;
    });
    __syncthreads();
    clk.mark(INV_STEP_B);
  }
  clk.store(stamps);
}
// The inverse's wg design's (thread 0's warpgroup): step A split into its
// products (the wgmma k-loops) and its epilogues (with the barrier that ends
// step A).
enum { WG_PLANES, WG_STEP_A_PRODUCTS, WG_STEP_A_EPILOGUE, WG_STEP_B, WG_NSTAGES };

template <bool TIMED>
__global__ void __launch_bounds__(THREADS) mxu_inverse_kernel(
    const int32_t* __restrict__ y, int32_t* __restrict__ out, const int2* __restrict__ wa_f,
    const int2* __restrict__ w0_f, const int32_t* __restrict__ ti,
    const int64_t* __restrict__ consts, int rows, int P, int logn, int tr,
    long long* __restrict__ stamps) {
  extern __shared__ __align__(16) int8_t smem[];
  StageClock<TIMED, INV_NSTAGES> clk;
  const Split s(logn);
  int8_t* a_op = smem;                             // [tr·n2][lda_b]
  int8_t* b_op = smem + planes_b_bytes(s, tr);     // [tr·n1][lda_a]
  const int64_t r0 = (int64_t)blockIdx.x * tr;
  const int nr = rows - r0 < tr ? (int)(rows - r0) : tr;
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const uint32_t qinv = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_QINV];
    inv_planes(a_op, tr, s, [&](int r, int pos) -> int32_t {
      return r < nr ? y[(((r0 + r) * P + pi) << logn) + pos] : 0;
    });
    __syncthreads();
    clk.mark(INV_PLANES);
    inv_step_a(a_op, b_op, tr, s, wa_f + pi * s.words_b(), ti + ((size_t)pi << logn), p, qinv);
    __syncthreads();
    clk.mark(INV_STEP_A);
    inv_step_b(b_op, tr, s, w0_f + pi * s.words_a(), p, qinv, [&](int r, int pos, uint32_t v) {
      if (r < nr) out[(((r0 + r) * P + pi) << logn) + pos] = (int32_t)v;
    });
    __syncthreads();
    clk.mark(INV_STEP_B);
  }
  clk.store(stamps);
}

// ---- the inverse's wg design ----
//
// The inverse's wg design.  The parent's stage clock at the path shape
// showed 37 % of its time in the input planes (one dependent 4-byte load per
// thread and step), 47 % in step A, 16 % in step B, with the weights read
// from L2 once per 4 rows and 64-bit epilogues.  Here a task is one prime of
// a group of `rows` rows with rows·n2 = 128 (8 rows at N 2048); one block
// of two warpgroups per SM walks the tasks (persistent grid).  Per task:
//   input   the task's rows were copied to shared memory (cp.async) while the
//           block ran the previous task; the next task's copy starts as soon
//           as these planes are made, so every load of the input overlaps
//           the products;
//   planes  the 4 digit planes as step A's B operand [128 (r, k2)][4·n1
//           (j, k1)] in the no-swizzle core-matrix layout of wgmma (8 rows ×
//           16 bytes per 128-byte core matrix, LBO 128 bytes along K, SBO 8·K
//           bytes along the rows), each warp writing whole core matrices;
//   step A  transposed: C^T [4·n1 (d, n1i)][128] = Wt [4·n1][4·n1] × planes^T,
//           on wgmma m64n128k32 with the weights as the A operand straight
//           from global memory (L2) into registers, two k-steps ahead with
//           two groups of products left running, and the planes from shared
//           memory; a warpgroup takes a pair of 64-row tiles whose rows hold
//           digits (0, 1) and (2, 3) of the same 32 outputs, so an output's
//           four partials meet in one thread (backends/mxu.py wg_tables
//           orders the weights so);
//   epilogue the partials' sum Σ P_d·2^{8d} times 2^{-60} and the twiddle in
//           two 32-bit Shoup products (fold_words: two words without a
//           64-bit sum where the weights bound the partials, fold_mul by the
//           output's constants), its digits (balanced_bytes) written two
//           outputs at a time as step B's operand;
//   step B  [rows·n1][4·n2] × [4·n2][4·n2] on wgmma m64n(4·n2)k32 with both
//           operands in shared memory: the epilogue writes step B's operand
//           in the core-matrix layout, the prime's weights are copied into
//           the planes' bytes (free by then); the same 32-bit reduction,
//           residues to global.
// So each weight byte leaves L2 once per 8 rows instead of 4, no 64-bit
// multiply is left in the epilogues, the digits cost two instructions per
// four, and the input's latency hides behind the previous task.  The int32
// sums stay exact (|partial| ≤ 2^23).

// wgmma D += A·B, A (64 × 32 s8) from registers in the m16n8k32 A layout per
// warp, B (32 × N s8, K-major) from shared memory by its descriptor; D
// (64 × N s32): d[4j + 2e + c] at row 16·warp + g + 8e, column 8j + 2t + c
// (lane 4g + t).  scale 0: D = A·B.
template <int N>
struct WgmmaRS;
template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};
template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};
template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};
template <>
struct WgmmaRS<256> {
  static __device__ __forceinline__ void run(int (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};

// wgmma D += A·B, A (64 × 32 s8) and B (32 × N s8) both K-major in shared
// memory by their descriptors; D (64 × N s32) as WgmmaRS's.
template <int N>
struct WgmmaSS;
template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(int (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale));
  }
};
template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale));
  }
};
template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale));
  }
};
template <>
struct WgmmaSS<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t sdst = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sdst), "l"(src) : "memory");
}
// Ask L2 for `bytes` (a multiple of 16) of global memory at src, 16-byte aligned.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The four balanced base-256 digits of v as the bytes of one word, digit i
// in byte i: those of v + 128·(1 + 2^8 + 2^16 + 2^24), each less 128 (xor
// 0x80).  The balanced digits of a word mod 2^32 are unique, so they equal
// digit_step's four, for every int32 v.
__device__ __forceinline__ uint32_t balanced_bytes(int32_t v) {
  return ((uint32_t)v + 0x80808080u) ^ 0x80808080u;
}

// How an output's four partials become two 32-bit words (lo, hi) with
// Σ_d P_d·2^{8d} ≡ lo + hi·2^s (mod p), per prime and step (backends/mxu.py
// wg_tables "folds"): `split` where the weights bound |P_0 + 2^8·P_1| and
// |P_2 + 2^8·P_3| by A with 2A + p ≤ 2^32: lo = P_0 + 2^8·P_1 + K and
// hi = P_2 + 2^8·P_3 + K (s 16), K = p·⌈A/p⌉; else the int64 sum + K,
// K = p·⌈2^48/p⌉, split into its words (s 32).  Both ≥ 0, K ≡ 0.
struct WgFold {
  uint32_t split, k_lo, k_hi, unused;
};

// The per-prime constants of the wg design: the folds of steps A and B, and
// step B's multipliers (2^{-60}, 2^{s − 60}) with their Shoup quotients.
struct WgPrime {
  WgFold a, b;
  uint4 cb;
};

__device__ __forceinline__ void fold_words(int p0, int p1, int p2, int p3, const WgFold& f,
                                           uint32_t& lo, uint32_t& hi) {
  if (f.split) {
    lo = (uint32_t)p0 + ((uint32_t)p1 << 8) + f.k_lo;
    hi = (uint32_t)p2 + ((uint32_t)p3 << 8) + f.k_lo;
  } else {
    const uint64_t x = (uint64_t)((int64_t)p0 + ((int64_t)p1 << 8) + ((int64_t)p2 << 16) +
                                  ((int64_t)p3 << 24)) +
                       (((uint64_t)f.k_hi << 32) | f.k_lo);
    lo = (uint32_t)x;
    hi = (uint32_t)(x >> 32);
  }
}

// lo·c + hi·c_hi mod p in [0, 4p) by two Shoup products; c = (c, ⌊c·2^32/p⌋,
// c_hi, ⌊c_hi·2^32/p⌋).
__device__ __forceinline__ uint32_t fold_mul(uint32_t lo, uint32_t hi, uint4 c, uint32_t p) {
  return shoup_mul(lo, uint2{c.x, c.y}, p) + shoup_mul(hi, uint2{c.z, c.w}, p);
}

// Canonical of u in [0, 4p).
__device__ __forceinline__ uint32_t canon4(uint32_t u, uint32_t p) {
  u = min(u, u - 2 * p);
  return min(u, u - p);
}

// The shared-memory matrix descriptor of wgmma, no swizzle: start address,
// LBO (next core matrix along K) and SBO (next 8 rows), in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

constexpr int WG_THREADS = 256;   // two warpgroups
constexpr int WG_MB = 128;        // rows·n2 of a task: the N of step A's wgmma
constexpr int WG_INFLIGHT = 2;    // wgmma groups a warpgroup leaves running (wait_group)
constexpr int WG_AHEAD = 2;       // k-steps of weight fragments loaded ahead
constexpr int WG_FRAG_STAGES = WG_INFLIGHT + WG_AHEAD;   // fragment registers in a ring

// The compile-time shape of the wg design at N = 2^LOGN (backends/mxu.py
// wg_layout mirrors it).
template <int LOGN>
struct WgShape {
  static constexpr int logn = LOGN, n = 1 << LOGN;
  static constexpr int logn1 = LOGN - 3 > 7 ? 7 : (LOGN - 3 < 1 ? 1 : LOGN - 3);
  static constexpr int n1 = 1 << logn1, logn2 = LOGN - logn1, n2 = 1 << logn2;
  static constexpr int rows = WG_MB / n2;             // rows per task
  static constexpr int K = NDIG * n1;                 // step A's depth
  static constexpr int ksteps = K / 32, pairs = n1 / 32;
  static constexpr int NB = NDIG * n2;                // step B's N and K
  static constexpr int sbo_b = NB / 16 * 128;         // bytes per 8 rows of step B's operands
  static constexpr int planes_bytes = WG_MB * K;
  static constexpr int stage_bytes = rows * n * 4;
  static constexpr int opb_bytes = rows * n1 * NB;
  static constexpr int smem = planes_bytes + stage_bytes + opb_bytes;
};

// cp.async of task `task`'s rows (prime task % P of rows group task / P) into
// the stage [rows][n] (rows past the data are not copied), then a commit.
template <class S>
__device__ __forceinline__ void wg_stage_load(int32_t* stage, const int32_t* __restrict__ y,
                                              int task, int P, int rows_total) {
  const int grp = task / P, pi = task - grp * P;
  const int64_t r0 = (int64_t)grp * S::rows;
  const int nr = rows_total - r0 < S::rows ? (int)(rows_total - r0) : S::rows;
  constexpr int per_row = S::n / 4;
  for (int c = threadIdx.x; c < nr * per_row; c += WG_THREADS) {
    const int r = c / per_row, c4 = c - r * per_row;
    cp_async16(stage + c * 4, y + (((r0 + r) * P + pi) << S::logn) + c4 * 4);
  }
  cp_async_commit();
}

// word[j] = digit j of v[0], v[1], v[2], v[3] in bytes 0..3: the four values'
// digit words (balanced_bytes) transposed as bytes.
__device__ __forceinline__ void digit_words(const int32_t (&v)[4], uint32_t (&word)[NDIG]) {
  const uint32_t w0 = balanced_bytes(v[0]), w1 = balanced_bytes(v[1]);
  const uint32_t w2 = balanced_bytes(v[2]), w3 = balanced_bytes(v[3]);
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  word[0] = __byte_perm(lo01, lo23, 0x5410), word[1] = __byte_perm(lo01, lo23, 0x7632);
  word[2] = __byte_perm(hi01, hi23, 0x5410), word[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The digit planes of the staged rows (rows ≥ nr zero) in the core-matrix
// layout: one warp per core-matrix column of the four planes, lane 4i + q on
// row 8·mg + i, coefficients k1 .. k1 + 3 (one 16-byte read, four 4-byte
// writes, the digits by balanced_bytes and a 4 × 4 byte transpose).  Ends
// with the proxy fence (the caller's barrier follows).
template <class S>
__device__ __forceinline__ void wg_planes(int8_t* planes, const int32_t* stage, int nr) {
  const int lane = threadIdx.x & 31, i = lane >> 2, q = lane & 3;
  constexpr int kcs = S::n1 / 16, items = (WG_MB / 8) * kcs;
  for (int it = threadIdx.x >> 5; it < items; it += WG_THREADS / 32) {
    const int mg = it / kcs, kc = it - mg * kcs;
    const int m = mg * 8 + i, r = m >> S::logn2, k2 = m & (S::n2 - 1);
    int32_t v[4] = {0, 0, 0, 0};
    if (r < nr) {
      const uint4 x = *(const uint4*)(stage + r * S::n + k2 * S::n1 + kc * 16 + q * 4);
      v[0] = (int32_t)x.x, v[1] = (int32_t)x.y, v[2] = (int32_t)x.z, v[3] = (int32_t)x.w;
    }
    uint32_t word[NDIG];
    digit_words(v, word);
    int8_t* dst = planes + mg * (8 * S::K) + kc * 128 + i * 16 + q * 4;
#pragma unroll
    for (int j = 0; j < NDIG; ++j) *(uint32_t*)(dst + j * (S::n1 / 16) * 128) = word[j];
  }
  fence_proxy_async();
}

// The products of one pair of 64-row tiles whose A operand (weights in
// wg_tables order) comes from global memory (L2) into registers: wq is the
// thread's slice of the pair's fragments [KSTEPS][2][128] uint4, desc the
// K-major B operand [NT][32·KSTEPS] in shared memory; tile h's sums into
// acc_h, weights loaded WG_AHEAD k-steps ahead with WG_INFLIGHT groups left
// running.  Ends with every group done.
template <int KSTEPS, int NT>
__device__ __forceinline__ void wg_pair_products(int (&acc0)[NT / 2], int (&acc1)[NT / 2],
                                                 const uint4* __restrict__ wq, uint64_t desc) {
  constexpr int NS = WG_FRAG_STAGES;
  uint32_t fr[NS][2][4];
#pragma unroll
  for (int s = 0; s < WG_AHEAD; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 f = __ldg(wq + s * 256 + h * 128);
      fr[s][h][0] = f.x, fr[s][h][1] = f.y, fr[s][h][2] = f.z, fr[s][h][3] = f.w;
    }
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    wgmma_fence();
    WgmmaRS<NT>::run(acc0, fr[s % NS][0], desc + (uint64_t)(s * 16), s > 0);
    WgmmaRS<NT>::run(acc1, fr[s % NS][1], desc + (uint64_t)(s * 16), s > 0);
    wgmma_commit();
    wgmma_wait<WG_INFLIGHT>();
    // the slot of k-step s − WG_INFLIGHT, whose group is done, takes s + WG_AHEAD
    if (s + WG_AHEAD < KSTEPS)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 f = __ldg(wq + (s + WG_AHEAD) * 256 + h * 128);
        uint32_t(&slot)[4] = fr[(s + WG_AHEAD) % NS][h];
        slot[0] = f.x, slot[1] = f.y, slot[2] = f.z, slot[3] = f.w;
      }
  }
  wgmma_wait<0>();
}

// Step A of one task: warpgroup wgi takes the tile pairs wgi, wgi + 2, ...;
// wa: the prime's weights in wg_tables order [pairs][ksteps][2][128] uint4;
// tw: the prime's output constants [n1][n2] (fold_mul's, the twiddle and
// 2^{-60} folded in).
template <class S, class Clock>
__device__ __forceinline__ void wg_step_a(const int8_t* planes, int8_t* opb,
                                          const uint4* __restrict__ wa,
                                          const uint4* __restrict__ tw, const WgFold& fa,
                                          uint32_t p, Clock& clk) {
  const int wgi = threadIdx.x >> 7, th = threadIdx.x & 127;
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  const uint64_t desc = wg_desc(planes, 128, 8 * S::K);
  for (int q = wgi; q < S::pairs; q += 2) {
    int acc0[64], acc1[64];
    wg_pair_products<S::ksteps, WG_MB>(acc0, acc1, wa + (size_t)q * S::ksteps * 256 + th, desc);
    clk.mark(WG_STEP_A_PRODUCTS);
    const int n1i = 32 * q + 8 * w + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int m = 8 * j + 2 * t, r = m >> S::logn2, k2 = m & (S::n2 - 1);
      const uint4* tw2 = tw + (n1i << S::logn2) + k2;
      uint32_t x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t lo, hi;
        fold_words(acc0[4 * j + c], acc0[4 * j + 2 + c], acc1[4 * j + c], acc1[4 * j + 2 + c], fa,
                   lo, hi);
        x[c] = balanced_bytes((int32_t)canon4(fold_mul(lo, hi, __ldg(tw2 + c), p), p));
      }
      const int row = r * S::n1 + n1i;
      int8_t* dst = opb + (row >> 3) * S::sbo_b + (row & 7) * 16;
#pragma unroll
      for (int jj = 0; jj < NDIG; ++jj) {   // digit jj of both outputs: bytes jj and 4 + jj
        const int kb = jj * S::n2 + k2;
        *(uint16_t*)(dst + (kb >> 4) * 128 + (kb & 15)) =
            (uint16_t)__byte_perm(x[0], x[1], 0x40 + 0x11 * jj);
      }
    }
    clk.mark(WG_STEP_A_EPILOGUE);
  }
  fence_proxy_async();
}

// Step B of one task on wgmma: [rows·n1][NB] (opb) × [NB][NB] (w0s, the
// prime's weights in shared memory, columns in the order 8·(4·cg + d) + c8
// for digit d of output n2i = 8·cg + c8: backends/mxu.py wg_tables), one
// 64-row tile per warpgroup at a time; the epilogue reduces each output's
// four partials and writes the residue of rows < nr to global memory.
template <class S>
__device__ __forceinline__ void wg_step_b(const int8_t* opb, const int8_t* w0s,
                                          int32_t* __restrict__ out, int64_t r0, int nr, int pi,
                                          int P, const WgPrime& wp, uint32_t p) {
  constexpr int NB = S::NB, per_wg = S::rows * S::n1 / 128;   // 64-row tiles per warpgroup
  const int wgi = threadIdx.x >> 7, th = threadIdx.x & 127;
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  const uint64_t db = wg_desc(w0s, 128, S::sbo_b);
  auto mma_tile = [&](int (&acc)[NB / 2], int tile) {
    const uint64_t da = wg_desc(opb + tile * 8 * S::sbo_b, 128, S::sbo_b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NB / 32; ++ks)
      WgmmaSS<NB>::run(acc, da + (uint64_t)(ks * 16), db + (uint64_t)(ks * 16), ks > 0);
    wgmma_commit();
  };
  auto epilogue = [&](const int (&acc)[NB / 2], int tile) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = tile * 64 + 16 * w + g + 8 * e;
      const int r = row >> S::logn1;
      if (r < nr) {
        int32_t* o = out + (((r0 + r) * P + pi) << S::logn) + (row & (S::n1 - 1));
#pragma unroll
        for (int cg = 0; cg < S::n2 / 8; ++cg)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int b = 16 * cg + 2 * e + c;        // acc[b + 4d]: digit d
            uint32_t lo, hi;
            fold_words(acc[b], acc[b + 4], acc[b + 8], acc[b + 12], wp.b, lo, hi);
            o[(8 * cg + 2 * t + c) << S::logn1] = (int32_t)canon4(fold_mul(lo, hi, wp.cb, p), p);
          }
      }
    }
  };
  // warpgroup wgi takes tiles wgi, wgi + 2, ...
  int acc[NB / 2];
  for (int i = 0; i < per_wg; ++i) {
    mma_tile(acc, wgi + 2 * i);
    wgmma_wait<0>();
    epilogue(acc, wgi + 2 * i);
  }
}

template <int LOGN, bool TIMED>
__global__ void __launch_bounds__(WG_THREADS, 1) mxu_inverse_wg_kernel(
    const int32_t* __restrict__ y, int32_t* __restrict__ out, const uint4* __restrict__ wa,
    const uint4* __restrict__ w0, const uint4* __restrict__ tw, const WgPrime* __restrict__ primes,
    const int64_t* __restrict__ consts, int rows_total, int P, long long* __restrict__ stamps) {
  using S = WgShape<LOGN>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* planes = smem;
  int32_t* stage = (int32_t*)(smem + S::planes_bytes);
  int8_t* opb = smem + S::planes_bytes + S::stage_bytes;
  StageClock<TIMED, WG_NSTAGES> clk;
  const int tasks = (rows_total + S::rows - 1) / S::rows * P;
  constexpr size_t wa_words = (size_t)S::pairs * S::ksteps * 256;   // uint4 per prime
  constexpr int w0_words = S::NB * S::NB / 16;                      // uint4 per prime
  int task = blockIdx.x;
  if (task < tasks) wg_stage_load<S>(stage, y, task, P, rows_total);
  for (; task < tasks; task += gridDim.x) {
    const int grp = task / P, pi = task - grp * P;
    const int64_t r0 = (int64_t)grp * S::rows;
    const int nr = rows_total - r0 < S::rows ? (int)(rows_total - r0) : S::rows;
    cp_async_wait_all();
    __syncthreads();
    wg_planes<S>(planes, stage, nr);
    __syncthreads();
    clk.mark(WG_PLANES);
    if (task + (int)gridDim.x < tasks) wg_stage_load<S>(stage, y, task + gridDim.x, P, rows_total);
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const WgPrime wp = primes[pi];
    wg_step_a<S>(planes, opb, wa + pi * wa_words, tw + ((size_t)pi << LOGN), wp.a, p, clk);
    __syncthreads();
    clk.mark(WG_STEP_A_EPILOGUE);
    // step B's weights into the planes' bytes, free until the next task
    for (int i = threadIdx.x; i < w0_words; i += WG_THREADS)
      ((uint4*)planes)[i] = __ldg(w0 + (size_t)pi * w0_words + i);
    fence_proxy_async();
    __syncthreads();
    wg_step_b<S>(opb, planes, out, r0, nr, pi, P, wp, p);
    __syncthreads();
    clk.mark(WG_STEP_B);
  }
  clk.store(stamps);
}

// One launch of the wg design at N = 2^LOGN on `grid` blocks (at most one
// per SM and one per task: backends/mxu.py wg_layout).
template <int LOGN>
int launch_wg(const void* y, void* out, const void* wa, const void* w0, const void* tw,
              const void* primes, const void* consts, int rows, int P, int grid, void* stamps,
              void* stream) {
  using S = WgShape<LOGN>;
  auto kernel = mxu_inverse_wg_kernel<LOGN, false>;
  if (stamps != nullptr) {
    if (LOGN != 11) return (int)cudaErrorInvalidValue;    // the clock: the path shape only
    kernel = mxu_inverse_wg_kernel<11, true>;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)S::smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, WG_THREADS, S::smem, (cudaStream_t)stream>>>(
      (const int32_t*)y, (int32_t*)out, (const uint4*)wa, (const uint4*)w0, (const uint4*)tw,
      (const WgPrime*)primes, (const int64_t*)consts, rows, P, (long long*)stamps);
  return (int)cudaGetLastError();
}

// ---- the forward's wg design ----
//
// The forward mirrors the inverse: its large product is step B, [rows·n2]
// [4·n1] × [4·n1][4·n1] per prime, the inverse's step A; its step A,
// [rows·n1][nd_in·n2] × [4·n2][4·n2] (K 48 at N 2048, nd_in 3), is small like
// the inverse's step B.  The parent (mxu_forward_kernel) spent its time as
// the inverse's parent did: dependent 8-byte limb loads into the planes, both
// steps on mma.sync with the weights read from L2 once per 4 rows, 64-bit
// epilogues.  Here a task is one prime of a group of `rows` rows with
// rows·n2 = MB (128, or 64 where 128 would not fit in shared memory: N
// 8192); one block of two warpgroups per SM walks the tasks, the primes of
// a group on neighbouring blocks.  Per task:
//   input   the group's int64 limbs, copied to shared memory by 16-byte
//           cp.async (fwd_chunk swizzles them) while the block ran the
//           previous task's step B, and asked of L2 one task ahead (a bulk
//           prefetch), so that the copy finds them there;
//   step A  on wgmma m64n(4·n2)k32 with the digit planes as the register A
//           operand, each thread making its own fragments from the staged
//           limbs (wrapped to int32, zero past nd_in; tile row 16w + g + 8e
//           holds n1i = 2(8w + g) + e, so that a thread's two output rows are
//           neighbouring n1i), and the prime's weights ua in shared memory
//           (every prime's, loaded once per block where they fit; columns in
//           wg_tables' order, so that an output's four digits meet in one
//           thread); two tiles in flight.  Its epilogue is the inverse step
//           A's: the 32-bit fold (fold_words), the twiddle and 2^{-60} in two
//           Shoup products (the constants loaded once per task), then the
//           digit bytes of a representative in [−p, p) rather than of the
//           canonical residue (step B's result is the same mod p), written
//           two outputs at a time as step B's operand [MB (r, k2)][4·n1];
//   step B  transposed, C^T [4·n1 (d, k1)][MB] = V^T × operand^T, on wgmma
//           m64nMBk32 with the weights as the register A operand from L2
//           (wg_pair_products, as the inverse's step A); the same 32-bit fold
//           and the residues to global memory.
// Step B streams its weights from L2 (256 KiB per prime and task) at about
// the card's L2 rate, and the group's limbs arriving from HBM slow it: a task
// of all P primes (the planes made once, the limbs copied once per group)
// put all of that copy into one step B and came out slower (PERF.md, PR 10),
// as did copies by the Tensor Memory Accelerator and 4-byte copies of the low
// words only.

// Shared bytes of the forward's wg design at MB = rows·n2 with the step-A
// weights of `ua_slots` primes: the staged limbs [rows][n] int64, step B's
// operand [MB][4·n1], the weights [4·n2]² per slot.
constexpr int fwd_smem(int n1, int n2, int mb, int ua_slots) {
  return mb / n2 * n1 * n2 * 8 + mb * NDIG * n1 + ua_slots * NDIG * n2 * NDIG * n2;
}

// The wg design's shape at N = 2^LOGN (backends/mxu.py fwd_layout mirrors it).
template <int LOGN>
struct FwdShape {
  static constexpr int logn = LOGN, n = 1 << LOGN;
  static constexpr int logn1 = LOGN - 3 > 7 ? 7 : (LOGN - 3 < 1 ? 1 : LOGN - 3);
  static constexpr int n1 = 1 << logn1, logn2 = LOGN - logn1, n2 = 1 << logn2;
  static constexpr int KB = NDIG * n1, ksteps_b = KB / 32, pairs = n1 / 32;
  static constexpr int NA = NDIG * n2, KS = NA / 32;   // step A's N and k-steps
  static constexpr int MB = fwd_smem(n1, n2, WG_MB, 1) <= 232448 ? WG_MB : WG_MB / 2;
  static constexpr int rows = MB / n2, MA = rows * n1, tiles = MA / 128;   // tiles per warpgroup
  static constexpr int stage_bytes = rows * n * 8, opb_bytes = MB * KB, ua_bytes = NA * NA;
};

// The stages of the forward's clock (TIMED instances): the parent's are the
// inverse's (INV_*); the wg design's (thread 0's warpgroup) are the wait for
// the staged limbs, step A, and step B split into its products and its
// epilogues.
enum { FWD_INPUT, FWD_STEP_A, FWD_STEP_B_PRODUCTS, FWD_STEP_B_EPILOGUE, FWD_NSTAGES };

// The 16-byte chunk of the stage that holds limbs (2c, 2c + 1) of a row, c =
// k2·n1/2 + n1i/2: bits 1–2 of c exchanged with bits 2–3 of k2, so that the
// eight lanes of a quarter-warp that read one n1i pair at four k2 in step A
// fall on distinct banks.
template <class S>
__device__ __forceinline__ int fwd_chunk(int c) {
  return c ^ ((((c >> (S::logn1 - 1)) >> 2) & 3) << 1);
}

// 16-byte cp.async of group grp's limbs [rows][n] int64 into the stage, each
// row's chunks at fwd_chunk (rows past the data are not copied), then a commit.
template <class S>
__device__ __forceinline__ void fwd_stage_load(int8_t* stage, const int64_t* __restrict__ x,
                                               int grp, int rows_total) {
  const int64_t r0 = (int64_t)grp * S::rows;
  const int nr = rows_total - r0 < S::rows ? (int)(rows_total - r0) : S::rows;
  constexpr int per_row = S::n / 2;
  const int64_t* src = x + r0 * S::n;
  for (int i = threadIdx.x; i < nr * per_row; i += WG_THREADS) {
    const int r = i / per_row, c = i - r * per_row;
    cp_async16(stage + (r * per_row + fwd_chunk<S>(c)) * 16, src + 2 * i);
  }
  cp_async_commit();
}

// The A fragments of step A's tile `tile` for this thread (rows n1i, n1i + 1
// of row r of the stage): frag[ks][e + 2·kh] = digits of the limbs at k =
// 32·ks + 16·kh + 4t + 0..3 (k = i·n2 + k2: digit i of limb k2·n1 + n1i + e,
// wrapped to int32; zero past nd_in).
template <class S>
__device__ __forceinline__ void fwd_fragments(uint32_t (&frag)[S::KS][4], const int8_t* stage,
                                              int tile, int nd_in) {
  constexpr int QUADS = S::n2 >= 16 ? S::n2 / 16 : 1;   // 4-k2 quads a thread reads
  const int th = threadIdx.x & 127, w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  const int r = (tile * 64) >> S::logn1;
  const int pair = (((tile * 64) & (S::n1 - 1)) >> 1) + 8 * w + g;   // n1i / 2
  uint32_t words[2][QUADS][NDIG];
#pragma unroll
  for (int qd = 0; qd < QUADS; ++qd) {
    const int k2b = S::n2 >= 16 ? 16 * qd + 4 * t : 4 * (t & 1);
    int32_t v[2][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = fwd_chunk<S>(((k2b + b) << (S::logn1 - 1)) + pair);
      const uint4 x = *(const uint4*)(stage + (r * (S::n / 2) + c) * 16);
      v[0][b] = (int32_t)x.x, v[1][b] = (int32_t)x.z;   // the low words of limbs n1i, n1i + 1
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      digit_words(v[e], words[e][qd]);
#pragma unroll
      for (int i = 0; i < NDIG; ++i)
        if (i >= nd_in) words[e][qd][i] = 0;
    }
  }
#pragma unroll
  for (int ks = 0; ks < S::KS; ++ks)
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int k = 32 * ks + 16 * kh;           // + 4t: the same quad for every t (n2 ≥ 16)
      const int qd = S::n2 >= 16 ? (k % S::n2) / 16 : 0;
      const int i = S::n2 >= 16 ? k / S::n2 : 2 * kh;   // n2 8: digit 2·kh + t/2
#pragma unroll
      for (int e = 0; e < 2; ++e)
        frag[ks][e + 2 * kh] = S::n2 >= 16 ? words[e][qd][i]
                                           : (t >> 1 ? words[e][0][i + 1] : words[e][0][i]);
    }
}

// Step A of one prime: warpgroup wgi takes the 64-row tiles wgi, wgi + 2, ...
// (tile: 64 n1i of one row), A from fwd_fragments, B ua_s [NA (columns in
// wg_tables order)][NA]; the epilogue writes step B's operand opb [MB (r,
// k2)][KB (j, n1i)].  tw: the prime's output constants [n1][n2] (the twiddle
// and 2^{-60} folded in).  A thread's outputs are the same (n1i, k2) in each
// of its tiles (wgi fixes which 64 n1i where n1 is 128), so up to N 2048
// their constants are loaded once; the tiles run two deep, the next tile's
// products in flight during this one's epilogue.
template <class S>
__device__ __forceinline__ void fwd_step_a(const int8_t* stage, const int8_t* ua_s, int8_t* opb,
                                           const uint4* __restrict__ tw, const WgFold& fa,
                                           uint32_t p, int nd_in) {
  constexpr int CG = S::n2 / 8;
  constexpr bool HOIST = S::n2 <= 16;
  const int wgi = threadIdx.x >> 7, th = threadIdx.x & 127;
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  const uint64_t db = wg_desc(ua_s, 128, 8 * S::NA);
  const uint32_t centre = 0x80808080u - p;     // balanced_bytes of v − p
  const int n1i = ((wgi * 64) & (S::n1 - 1)) + 16 * w + 2 * g;   // row e: n1i + e
  const uint4* twt = tw + (n1i << S::logn2) + 2 * t;            // + e·n2 + 8·cg + c
  uint4 cst[HOIST ? CG : 1][2][2];
  if constexpr (HOIST)
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) cst[cg][c][e] = __ldg(twt + (e << S::logn2) + 8 * cg + c);
  auto issue = [&](int (&acc)[S::NA / 2], uint32_t (&frag)[S::KS][4], int tile) {
    fwd_fragments<S>(frag, stage, tile, nd_in);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks)
      WgmmaRS<S::NA>::run(acc, frag[ks], db + (uint64_t)(ks * 16), ks > 0);
    wgmma_commit();
  };
  auto epilogue = [&](const int (&acc)[S::NA / 2], int tile) {
    const int r = (tile * 64) >> S::logn1;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k2 = 8 * cg + 2 * t + c;
        uint32_t x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 16 * cg + 2 * e + c;        // acc[b + 4d]: digit d
          uint32_t lo, hi;
          fold_words(acc[b], acc[b + 4], acc[b + 8], acc[b + 12], fa, lo, hi);
          const uint4 k = HOIST ? cst[HOIST ? cg : 0][c][e]
                                : __ldg(twt + (e << S::logn2) + 8 * cg + c);
          // the digits of u − p ∈ [−p, p), u ∈ [0, 2p): a value ≡ the output
          // (mod p), all step B needs, in one add fewer than the canonical's
          const uint32_t u = fold_mul(lo, hi, k, p);
          x[e] = (min(u, u - 2 * p) + centre) ^ 0x80808080u;
        }
        const int m = r * S::n2 + k2;
        int8_t* dst = opb + (m >> 3) * (8 * S::KB) + (m & 7) * 16;
#pragma unroll
        for (int jj = 0; jj < NDIG; ++jj) {   // digit jj of both outputs: bytes jj and 4 + jj
          const int kb = jj * S::n1 + n1i;
          *(uint16_t*)(dst + (kb >> 4) * 128 + (kb & 15)) =
              (uint16_t)__byte_perm(x[0], x[1], 0x40 + 0x11 * jj);
        }
      }
  };
  // a wgmma reads its A registers until it is done: each tile of the pair
  // its own fragments
  int acc0[S::NA / 2], acc1[S::NA / 2];
  uint32_t frag0[S::KS][4], frag1[S::KS][4];
  issue(acc0, frag0, wgi);
#pragma unroll
  for (int i = 0; i < S::tiles; i += 2) {
    if (i + 1 < S::tiles) {
      issue(acc1, frag1, wgi + 2 * (i + 1));
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    epilogue(acc0, wgi + 2 * i);
    if (i + 1 < S::tiles) {
      if (i + 2 < S::tiles) {
        issue(acc0, frag0, wgi + 2 * (i + 2));
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      epilogue(acc1, wgi + 2 * (i + 1));
    }
  }
  fence_proxy_async();
}

// Step B of one prime: warpgroup wgi takes the pairs wgi, wgi + 2, ... of
// C^T [KB (d, k1)][MB] = V^T × opb^T (v0: the prime's weights in wg_tables
// order); each output's residue of rows < nr to out[r0 + r][pi][k2·n1 + k1].
template <class S, class Clock>
__device__ __forceinline__ void fwd_step_b(const int8_t* opb, const uint4* __restrict__ v0,
                                           int32_t* __restrict__ out, int64_t r0, int nr, int pi,
                                           int P, const WgPrime& wp, uint32_t p, Clock& clk) {
  const int wgi = threadIdx.x >> 7, th = threadIdx.x & 127;
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  const uint64_t desc = wg_desc(opb, 128, 8 * S::KB);
  for (int q = wgi; q < S::pairs; q += 2) {
    int acc0[S::MB / 2], acc1[S::MB / 2];
    wg_pair_products<S::ksteps_b, S::MB>(acc0, acc1, v0 + (size_t)q * S::ksteps_b * 256 + th,
                                         desc);
    clk.mark(FWD_STEP_B_PRODUCTS);
    const int k1 = 32 * q + 8 * w + g;
#pragma unroll
    for (int j = 0; j < S::MB / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = 8 * j + 2 * t + c, r = m >> S::logn2, k2 = m & (S::n2 - 1);
        uint32_t lo, hi;
        fold_words(acc0[4 * j + c], acc0[4 * j + 2 + c], acc1[4 * j + c], acc1[4 * j + 2 + c],
                   wp.b, lo, hi);
        if (r < nr)
          out[(((r0 + r) * P + pi) << S::logn) + (k2 << S::logn1) + k1] =
              (int32_t)canon4(fold_mul(lo, hi, wp.cb, p), p);
      }
    clk.mark(FWD_STEP_B_EPILOGUE);
  }
}

template <int LOGN, bool TIMED>
__global__ void __launch_bounds__(WG_THREADS, 1) mxu_forward_wg_kernel(
    const int64_t* __restrict__ x, int32_t* __restrict__ out, const uint4* __restrict__ v0,
    const uint4* __restrict__ ua, const uint4* __restrict__ tw, const WgPrime* __restrict__ primes,
    const int64_t* __restrict__ consts, int rows_total, int nd_in, int P, int ua_slots,
    long long* __restrict__ stamps) {
  using S = FwdShape<LOGN>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* stage = smem;
  int8_t* opb = smem + S::stage_bytes;
  int8_t* ua_s = opb + S::opb_bytes;
  StageClock<TIMED, FWD_NSTAGES> clk;
  const int tasks = (rows_total + S::rows - 1) / S::rows * P;
  constexpr size_t v0_words = (size_t)S::pairs * S::ksteps_b * 256;   // uint4 per prime
  constexpr int ua_words = S::ua_bytes / 16;
  // every prime's step-A weights once where they fit (ua_slots = P), else
  // the task's prime's at each task
  const bool resident = ua_slots == P;
  if (resident)
    for (int i = threadIdx.x; i < P * ua_words; i += WG_THREADS) ((uint4*)ua_s)[i] = __ldg(ua + i);
  int task = blockIdx.x;
  if (task < tasks) fwd_stage_load<S>(stage, x, task / P, rows_total);
  for (; task < tasks; task += gridDim.x) {
    const int grp = task / P, pi = task - grp * P;
    const int64_t r0 = (int64_t)grp * S::rows;
    const int nr = rows_total - r0 < S::rows ? (int)(rows_total - r0) : S::rows;
    const uint32_t p = (uint32_t)consts[pi * CONSTS_PER_PRIME + C_P];
    const WgPrime wp = primes[pi];
    if (!resident)
      for (int i = threadIdx.x; i < ua_words; i += WG_THREADS)
        ((uint4*)ua_s)[i] = __ldg(ua + (size_t)pi * ua_words + i);
    cp_async_wait_all();
    fence_proxy_async();                        // the weights, for step A's wgmma
    __syncthreads();
    clk.mark(FWD_INPUT);
    const int next = task + (int)gridDim.x;
    if (threadIdx.x == 0 && next < tasks && next / P != grp) {
      const int64_t nr0 = (int64_t)(next / P) * S::rows;
      const int nnr = rows_total - nr0 < S::rows ? (int)(rows_total - nr0) : S::rows;
      prefetch_l2(x + nr0 * S::n, (uint32_t)(nnr * S::n * 8));
    }
    fwd_step_a<S>(stage, ua_s + (resident ? pi * S::ua_bytes : 0), opb,
                  tw + ((size_t)pi << LOGN), wp.a, p, nd_in);
    __syncthreads();
    clk.mark(FWD_STEP_A);
    // the stage is free after step A: the next task's limbs
    if (next < tasks) fwd_stage_load<S>(stage, x, next / P, rows_total);
    fwd_step_b<S>(opb, v0 + pi * v0_words, out, r0, nr, pi, P, wp, p, clk);
    __syncthreads();
    clk.mark(FWD_STEP_B_EPILOGUE);
  }
  clk.store(stamps);
}

// One launch of the forward's wg design at N = 2^LOGN on `grid` blocks.
template <int LOGN>
int launch_fwd_wg(const void* x, void* out, const void* v0, const void* ua, const void* tw,
                  const void* primes, const void* consts, int rows, int nd_in, int P, int grid,
                  void* stamps, void* stream) {
  using S = FwdShape<LOGN>;
  const int ua_slots = fwd_smem(S::n1, S::n2, S::MB, P) <= 232448 ? P : 1;
  const int smem = fwd_smem(S::n1, S::n2, S::MB, ua_slots);
  auto kernel = mxu_forward_wg_kernel<LOGN, false>;
  if (stamps != nullptr) {
    if (LOGN != 11) return (int)cudaErrorInvalidValue;    // the clock: the path shape only
    kernel = mxu_forward_wg_kernel<11, true>;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, WG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)x, (int32_t*)out, (const uint4*)v0, (const uint4*)ua, (const uint4*)tw,
      (const WgPrime*)primes, (const int64_t*)consts, rows, nd_in, P, ua_slots,
      (long long*)stamps);
  return (int)cudaGetLastError();
}

int launch_blocks(int rows, int tr) { return (rows + tr - 1) / tr; }

}  // namespace

// x: [rows, N] int64 limbs; out: [rows, P, N] int32; ua_f, v0_f: [P, ...]
// fragment-order int8 weights (backends/mxu.py device_tables); tf: [P, n1, n2]
// int32; consts: backends/ntt.py kernel_tables; tr: rows per block (a multiple
// of 4); smem: backends/mxu.py transform_smem_bytes.  stamps: null, or
// [blocks][3] int64 for the stage clock (the TIMED instance).  The parent
// design.  Returns the cudaError_t.
extern "C" int poulpy_mxu_forward(const void* x, void* out, const void* ua_f, const void* v0_f,
                                  const void* tf, const void* consts, int rows, int nd_in, int P,
                                  int logn, int tr, int smem, void* stamps, void* stream) {
  const auto kernel = stamps != nullptr ? mxu_forward_kernel<true> : mxu_forward_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<launch_blocks(rows, tr), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int64_t*)x, (int32_t*)out, (const int2*)ua_f, (const int2*)v0_f,
      (const int32_t*)tf, (const int64_t*)consts, rows, nd_in, P, logn, tr, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The forward's wg design: x [rows, N] int64, out [rows, P, N] int32; v0, ua,
// tw, primes: backends/mxu.py wg_tables(forward=True); 9 ≤ logn ≤ 13 (the
// wrapper checks it); grid: fwd_layout.  stamps: null, or [grid][4] int64
// (N 2048 only).
extern "C" int poulpy_mxu_forward_wg(const void* x, void* out, const void* v0, const void* ua,
                                     const void* tw, const void* primes, const void* consts,
                                     int rows, int nd_in, int P, int logn, int grid,
                                     void* stamps, void* stream) {
  switch (logn) {
#define POULPY_FWD(L)                                                                        \
  case L:                                                                                    \
    return launch_fwd_wg<L>(x, out, v0, ua, tw, primes, consts, rows, nd_in, P, grid,       \
                            stamps, stream);
    POULPY_FWD(9) POULPY_FWD(10) POULPY_FWD(11) POULPY_FWD(12) POULPY_FWD(13)
#undef POULPY_FWD
    default: return (int)cudaErrorInvalidValue;
  }
}

// y, out: [rows, P, N] int32; wa_f, w0_f, ti: backends/mxu.py device_tables.
// stamps: null, or [blocks][3] int64 for the stage clock (the TIMED instance).
extern "C" int poulpy_mxu_inverse(const void* y, void* out, const void* wa_f, const void* w0_f,
                                  const void* ti, const void* consts, int rows, int P, int logn,
                                  int tr, int smem, void* stamps, void* stream) {
  const auto kernel = stamps != nullptr ? mxu_inverse_kernel<true> : mxu_inverse_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<launch_blocks(rows, tr), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int32_t*)y, (int32_t*)out, (const int2*)wa_f, (const int2*)w0_f,
      (const int32_t*)ti, (const int64_t*)consts, rows, P, logn, tr, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The wg design: y, out [rows, P, N] int32; wa, w0, tw, primes: backends/mxu.py
// wg_tables; 9 ≤ logn ≤ 13 (the wrapper checks
// it); grid: wg_layout.  stamps: null, or [grid][4] int64 (N 2048 only).
extern "C" int poulpy_mxu_inverse_wg(const void* y, void* out, const void* wa, const void* w0,
                                     const void* tw, const void* primes, const void* consts,
                                     int rows, int P, int logn, int grid, void* stamps,
                                     void* stream) {
  switch (logn) {
#define POULPY_WG(L) \
  case L:            \
    return launch_wg<L>(y, out, wa, w0, tw, primes, consts, rows, P, grid, stamps, stream);
    POULPY_WG(9) POULPY_WG(10) POULPY_WG(11) POULPY_WG(12) POULPY_WG(13)
#undef POULPY_WG
    default: return (int)cudaErrorInvalidValue;
  }
}
