// The CUDA execution model on the CPU, for running a kernel's source without
// a card (tests/test_torch_cuda_emu.py): one fiber (a stack of its own,
// switched by emu_swap, x86-64) per CUDA thread, all on the calling thread,
// switched round-robin at the barriers (skipping a fiber whose barrier has
// not opened yet), in ascending thread order in one block and descending in the
// next (the first block's order alternating from launch to launch), so that a
// missing barrier shows whichever of two threads reads the other's write; the
// blocks of a launch one after another, __syncthreads a barrier of the
// block's threads and __syncwarp one of the warp's, `bar.sync id, n` (a named
// barrier: the first n threads to reach barrier id pass it together; the
// test's rewrite turns the asm into emu_bar_sync(id, nthreads)), __shfl_xor_sync an
// exchange through the warp's slots between two of its barriers (a fiber
// that waits yields until the last one arrives; the run has no data race by
// construction and takes one core, however many threads the kernel has),
// dynamic shared memory a buffer per block filled with garbage, a static
// __shared__ variable one per
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
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__ static

struct uint3s {
  unsigned x, y, z;
};
inline uint3s threadIdx, blockIdx;    // the running fiber's (one OS thread runs them all)
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

// emu_swap(from, to): push the callee-saved registers (x86-64 System V) on
// the running stack, store its stack pointer to *from, switch to the stack
// pointer `to` and pop its registers (a fiber's first switch "returns" into
// emu_fiber_entry).  No system call, unlike swapcontext.
#if !defined(__x86_64__)
#error "the emulation's fiber switch (emu_swap) is written for x86-64"
#endif
__attribute__((naked, noinline)) static void emu_swap(void** /*from*/, void* /*to*/) {
  asm("pushq %rbp\n\tpushq %rbx\n\tpushq %r12\n\tpushq %r13\n\tpushq %r14\n\tpushq %r15\n\t"
      "movq %rsp, (%rdi)\n\tmovq %rsi, %rsp\n\t"
      "popq %r15\n\tpopq %r14\n\tpopq %r13\n\tpopq %r12\n\tpopq %rbx\n\tpopq %rbp\n\tret");
}

// The fibers of a launch and the scheduler's stack: emu_yield switches from
// the running fiber back to the scheduler, which resumes the next one.  A
// fiber waiting at a barrier names its generation (`gen`, `at`): the
// scheduler passes it over until that moves on, as resuming it would only
// see the barrier closed and yield again.
struct EmuFiber {
  void* sp;
  const long* gen;
  long at;
  bool done;
};
inline void* emu_sched_sp = nullptr;
inline EmuFiber* emu_fibers = nullptr;
inline unsigned emu_cur = 0;
inline unsigned long emu_launches = 0;   // the order of a launch's first block
inline void emu_yield() { emu_swap(&emu_fibers[emu_cur].sp, emu_sched_sp); }

struct EmuBarrier {
  int n = 0, count = 0;
  long gen = 0;
  void init(int k) {
    n = k;
    count = 0;
    gen = 0;
  }
  void wait() {
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
    } else {
      EmuFiber& f = emu_fibers[emu_cur];
      f.gen = &gen;
      f.at = g;
      do emu_yield();
      while (gen == g);
      f.gen = nullptr;
    }
  }
};
inline EmuBarrier emu_block_bar;
inline EmuBarrier emu_warp_bar[32];
inline EmuBarrier emu_wg_bar[8];
inline EmuBarrier emu_named_bar[16];
inline uint32_t emu_wg_a[8][128][4];
inline uint32_t emu_warp_a[32][32][4];
inline int2 emu_warp_b[32][32];
inline uint8_t* emu_dyn_smem = nullptr;
inline long long emu_clock = 0;      // one counter for every fiber: monotonic

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

// bar.sync id, n: the barrier's count is set by its first arrival of a round.
inline void emu_bar_sync(int id, int n) {
  EmuBarrier& b = emu_named_bar[id];
  if (b.count == 0) b.n = n;
  b.wait();
}

// __shfl_xor_sync: each lane publishes its value in its warp's slot, the
// warp meets at its barrier, each reads lane ^ lane_mask's value, and the
// warp meets again before any slot is written anew.  The kernels pass a full
// mask and the warp's width.
inline uint64_t emu_shfl[32][32];
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask, int = 32) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffled value is at most 8 bytes");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  memcpy(&emu_shfl[w][lane], &v, sizeof(T));
  emu_warp_bar[w].wait();
  T u;
  memcpy(&u, &emu_shfl[w][lane ^ lane_mask], sizeof(T));
  emu_warp_bar[w].wait();
  return u;
}

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

// The body a fiber runs (the kernel with its arguments), then it is done and
// switches to the scheduler for the last time.
inline void (*emu_body)(void*) = nullptr;
inline void* emu_body_arg = nullptr;
[[noreturn]] inline void emu_fiber_entry() {
  emu_body(emu_body_arg);
  emu_fibers[emu_cur].done = true;
  emu_yield();
  __builtin_unreachable();
}

template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, unsigned threads, size_t smem, cudaStream_t, Args... args) {
  if (smem > 232448 || threads > 1024 || threads % 32) {   // what the card refuses
    emu_error = cudaErrorInvalidValue;
    return;
  }
  constexpr size_t STACK = 256 << 10;
  blockDim = {threads, 1, 1};
  gridDim = {grid.x, grid.y, 1};
  std::vector<uint8_t> buf(smem);
  std::vector<EmuFiber> fibers(threads);
  std::unique_ptr<char[]> stacks(new char[STACK * threads]);   // pages touched as used
  emu_fibers = fibers.data();
  auto body = [&] { kernel(args...); };
  emu_body = [](void* f) { (*static_cast<decltype(body)*>(f))(); };
  emu_body_arg = &body;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned b = 0; b < grid.x; ++b) {
      memset(buf.data(), 0xA5, buf.size());
      emu_dyn_smem = buf.data();
      emu_block_bar.init((int)threads);
      for (unsigned w = 0; w < threads / 32; ++w) emu_warp_bar[w].init(32);
      for (unsigned w = 0; w < threads / 128; ++w) emu_wg_bar[w].init(128);
      for (EmuBarrier& nb : emu_named_bar) nb.init(0);
      blockIdx = {b, by, 0};
      for (unsigned t = 0; t < threads; ++t) {
        // the stack top, 16-aligned: a null return address for the entry,
        // the entry as emu_swap's, its six registers
        void** s = (void**)((uintptr_t)(stacks.get() + STACK * (t + 1)) & ~(uintptr_t)15);
        *--s = nullptr;
        *--s = (void*)emu_fiber_entry;
        for (int r = 0; r < 6; ++r) *--s = nullptr;
        fibers[t] = {s, nullptr, 0, false};
      }
      const bool down = (emu_launches + by * grid.x + b) & 1;
      for (unsigned alive = threads; alive;)
        for (unsigned i = 0; i < threads; ++i) {
          const unsigned t = down ? threads - 1 - i : i;
          const EmuFiber& f = fibers[t];
          if (f.done || (f.gen != nullptr && *f.gen == f.at)) continue;
          emu_cur = t;
          threadIdx = {t, 0, 0};
          emu_swap(&emu_sched_sp, fibers[t].sp);
          alive -= fibers[t].done;
        }
    }
  emu_fibers = nullptr;
  ++emu_launches;
}
