// The CUDA execution model on the CPU, for running a kernel's source without
// a card (tests/test_torch_cuda_emu.py): one std::thread per CUDA thread, the
// blocks of a launch one after another, __syncthreads a barrier of the
// block's threads and __syncwarp one of the warp's, dynamic shared memory a
// buffer per block filled with garbage, a static __shared__ variable one per
// kernel instance (the blocks run one after another), and
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 computed from the
// fragments of the warp's 32 lanes (PTX ISA's fragment layouts) between two
// barriers of the warp; a two-dimensional grid; the warpgroup product
// wgmma.mma_async m64nNk32 s8 (A from the 128 threads' registers, B from
// shared memory through its no-swizzle descriptor, PTX ISA's layouts) between
// two barriers of the warpgroup; cp.async as a plain copy.  The test's build
// step rewrites the source first: `kernel<<<grid, threads, smem,
// stream>>>(args)` into `emu_launch(kernel, grid, threads, smem, stream,
// args)`, each inline asm by its instruction (mma.sync into emu_mma_s8(c, a,
// b), wgmma.mma_async into emu_wgmma_rs(d, a, desc, scale) or, with both
// operands in shared memory, emu_wgmma_ss(d, desc_a, desc_b, scale),
// cp.async.cg into emu_cp_async16(dst, src), the fences, commits and waits
// into nothing: the emulation runs each copy and product to its end at
// once), and `extern __shared__ … smem[]` into a pointer to the block's
// buffer.  Only what the kernels use is here.
#pragma once
#include <algorithm>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__ static

struct uint3s {
  unsigned x, y, z;
};
inline thread_local uint3s threadIdx, blockIdx;
inline uint3s blockDim, gridDim;
struct int2 {
  int x, y;
};
struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct longlong2 {
  long long x, y;
};
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
struct dim3 {
  unsigned x, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline int emu_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const int e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
using std::max;
using std::min;

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void init(int k) {
    n = k;
    count = 0;
    gen = 0;
  }
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(l, [&] { return gen != g; });
    }
  }
};
inline EmuBarrier emu_block_bar;
inline EmuBarrier emu_warp_bar[32];
inline EmuBarrier emu_wg_bar[8];
inline uint32_t emu_wg_a[8][128][4];
inline uint32_t emu_warp_a[32][32][4];
inline int2 emu_warp_b[32][32];
inline uint8_t* emu_dyn_smem = nullptr;
inline thread_local long long emu_clock = 0;

inline void __syncthreads() { emu_block_bar.wait(); }
inline long long clock64() { return ++emu_clock; }
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)((uint64_t)a * b >> 32); }
// Byte i of the result: byte (s >> 4i) & 7 of the eight bytes of y:x.
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t xy = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((xy >> (8 * ((s >> (4 * i)) & 7))) & 255) << (8 * i);
  return r;
}

inline void __syncwarp() { emu_warp_bar[threadIdx.x >> 5].wait(); }

// The shared-window address of a pointer into the block's dynamic buffer.
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const uint8_t*)p - emu_dyn_smem);
}
inline void emu_cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }

// d (+)= A·B for the warpgroup's m64nNk32 s8 product, N = 2R: thread
// 32w + 4g + t holds A rows 16w + g and + 8, columns 4t.. and 16 + 4t..
// (a[e + 2·kh]); B (K-major, no swizzle) element (k, n) at start + (n / 8)·SBO
// + (k / 16)·LBO + (n % 8)·16 + k % 16; d[4j + 2e + c] is row 16w + g + 8e,
// column 8j + 2t + c.
template <int R>
void emu_wgmma_rs(int (&d)[R], const uint32_t (&a)[4], uint64_t desc, int scale) {
  const int wg = threadIdx.x >> 7, th = threadIdx.x & 127;
  for (int i = 0; i < 4; ++i) emu_wg_a[wg][th][i] = a[i];
  emu_wg_bar[wg].wait();
  const uint8_t* start = emu_dyn_smem + ((desc & 0x3FFF) << 4);
  const size_t lbo = ((desc >> 16) & 0x3FFF) << 4, sbo = ((desc >> 32) & 0x3FFF) << 4;
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  auto A = [&](int row, int k) {
    const uint32_t word = emu_wg_a[wg][32 * (row >> 4) + 4 * (row & 7) + ((k & 15) >> 2)]
                                  [((row >> 3) & 1) + 2 * (k >> 4)];
    return (int)(int8_t)(word >> (8 * (k & 3)));
  };
  auto B = [&](int k, int n) {
    return (int)(int8_t)start[(n >> 3) * sbo + (k >> 4) * lbo + (n & 7) * 16 + (k & 15)];
  };
  for (int i = 0; i < R; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
    int sum = 0;
    for (int k = 0; k < 32; ++k) sum += A(row, k) * B(k, col);
    d[i] = (scale ? d[i] : 0) + sum;
  }
  emu_wg_bar[wg].wait();
}

// c += A·B for the warp's m16n8k32 s8 tile: lane 4g + t holds A rows g and
// g + 8, columns 4t..4t+3 and 16 + 4t..; B column g, rows 4t.. and 16 + 4t..;
// C rows g and g + 8, columns 2t and 2t + 1.
inline void emu_mma_s8(int (&c)[4], const uint32_t (&a)[4], int2 b) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = 0; i < 4; ++i) emu_warp_a[w][lane][i] = a[i];
  emu_warp_b[w][lane] = b;
  emu_warp_bar[w].wait();
  const int g = lane >> 2, t = lane & 3;
  auto A = [&](int row, int k) {
    const uint32_t word = emu_warp_a[w][(row & 7) * 4 + ((k & 15) >> 2)][(row >> 3) + 2 * (k >> 4)];
    return (int)(int8_t)(word >> (8 * (k & 3)));
  };
  auto B = [&](int k, int col) {
    const int2 v = emu_warp_b[w][col * 4 + ((k & 15) >> 2)];
    return (int)(int8_t)((uint32_t)(k >> 4 ? v.y : v.x) >> (8 * (k & 3)));
  };
  for (int i = 0; i < 4; ++i) {
    int sum = 0;
    for (int k = 0; k < 32; ++k) sum += A(g + 8 * (i >> 1), k) * B(k, t * 2 + (i & 1));
    c[i] += sum;
  }
  emu_warp_bar[w].wait();
}

// d (+)= A·B for the warpgroup's m64nNk32 s8 product with both operands in
// shared memory, K-major, no swizzle: A element (row, k) at start_a +
// (row / 8)·SBO_a + (k / 16)·LBO_a + (row % 8)·16 + k % 16, B as above; d
// (N / 2 words) as above.
template <int R>
void emu_wgmma_ss(int (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale) {
  const int wg = threadIdx.x >> 7, th = threadIdx.x & 127;
  emu_wg_bar[wg].wait();
  auto operand = [](uint64_t desc, int row, int k) {
    const uint8_t* start = emu_dyn_smem + ((desc & 0x3FFF) << 4);
    const size_t lbo = ((desc >> 16) & 0x3FFF) << 4, sbo = ((desc >> 32) & 0x3FFF) << 4;
    return (int)(int8_t)start[(row >> 3) * sbo + (k >> 4) * lbo + (row & 7) * 16 + (k & 15)];
  };
  const int w = th >> 5, g = (th & 31) >> 2, t = th & 3;
  for (int i = 0; i < R; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
    int sum = 0;
    for (int k = 0; k < 32; ++k) sum += operand(desc_a, row, k) * operand(desc_b, col, k);
    d[i] = (scale ? d[i] : 0) + sum;
  }
  emu_wg_bar[wg].wait();
}

template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, unsigned threads, size_t smem, cudaStream_t, Args... args) {
  if (smem > 232448 || threads > 1024 || threads % 32) {   // what the card refuses
    emu_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = {threads, 1, 1};
  gridDim = {grid.x, grid.y, 1};
  std::vector<uint8_t> buf(smem);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned b = 0; b < grid.x; ++b) {
      memset(buf.data(), 0xA5, buf.size());
      emu_dyn_smem = buf.data();
      emu_block_bar.init((int)threads);
      for (unsigned w = 0; w < threads / 32; ++w) emu_warp_bar[w].init(32);
      for (unsigned w = 0; w < threads / 128; ++w) emu_wg_bar[w].init(128);
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {b, by, 0};
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
