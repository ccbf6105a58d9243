// The CUDA execution model on the CPU, for running a kernel's source without
// a card (tests/test_torch_cuda_emu.py): one std::thread per CUDA thread, the
// blocks of a launch one after another, __syncthreads a barrier of the
// block's threads and __syncwarp one of the warp's, dynamic shared memory a
// buffer per block filled with garbage, a static __shared__ variable one per
// kernel instance (the blocks run one after another), and
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 computed from the
// fragments of the warp's 32 lanes (PTX ISA's fragment layouts) between two
// barriers of the warp.  The test's build step rewrites the source first:
// `kernel<<<grid, threads, smem, stream>>>(args)` into
// `emu_launch(kernel, grid, threads, smem, stream, args)`, each inline mma asm
// into emu_mma_s8(c, a, b), and `extern __shared__ … smem[]` into a pointer to
// the block's buffer.  Only what the fused kernels use is here.
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

inline void __syncwarp() { emu_warp_bar[threadIdx.x >> 5].wait(); }

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

template <class K, class... Args>
void emu_launch(K kernel, unsigned grid, unsigned threads, size_t smem, cudaStream_t,
                Args... args) {
  if (smem > 232448 || threads > 1024 || threads % 32) {   // what the card refuses
    emu_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = {threads, 1, 1};
  gridDim = {grid, 1, 1};
  std::vector<uint8_t> buf(smem);
  for (unsigned b = 0; b < grid; ++b) {
    memset(buf.data(), 0xA5, buf.size());
    emu_dyn_smem = buf.data();
    emu_block_bar.init((int)threads);
    for (unsigned w = 0; w < threads / 32; ++w) emu_warp_bar[w].init(32);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
