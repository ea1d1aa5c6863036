// A CPU stand-in for the parts of the CUDA runtime and device code that
// quanonet_torch/csrc/fused_chain.cu, embed_chain.cu, ucomp.cu, adam.cu and
// hea_chain.cu use, so that their kernels can run on the CPU in tests
// (tests/test_torch_port_fused_emulated.py, _embed_emulated.py,
// _ucomp_emulated.py, _adam_emulated.py, _hea_emulated.py): each CUDA
// thread a user-level context (ucontext) on one OS thread, switched at
// __syncthreads and at the warp shuffles and MMAs, the blocks of a grid one
// after another, one shared-memory array per launch.  The test replaces the source's inline-PTX helpers
// (cp.async copies, TF32 and bf16 rounding, mma.sync) with the emu_*
// functions below, which do the same thing synchronously.  It checks the kernels'
// indexing and algebra, not their timing, their memory ordering or the
// tensor cores' rounding (the MMA here sums in fp32 with round to nearest).
#pragma once
#include <algorithm>
#include <functional>
#include <ucontext.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
#define __restrict__
#define __shared__
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx;   // set by the scheduler for the running thread
inline dim3 blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class T>
cudaError_t cudaFuncSetAttribute(T, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::min;

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

// a launch's shared memory (the dynamic arrays the kernels name)
alignas(16) inline float smem[232448 / 4 + 64];
alignas(16) inline float gsm[232448 / 4 + 64];

// The CUDA threads of a block run as user-level contexts on one OS thread,
// switched at barriers: __syncthreads waits for the whole block, a warp's
// shuffles and MMAs for its 32 lanes.  No host load can starve them.
struct Fiber {
  ucontext_t ctx;
  int wait = 0;      // 0 runnable, 1 at the block barrier, 2 at its warp's
  int shfl = 0;      // which of the two shuffle buffers the next shuffle uses
  bool done = false;
};
inline std::vector<Fiber> g_fibers;
inline std::vector<std::vector<char>> g_stacks;
inline ucontext_t g_sched;
inline int g_cur = 0, g_block_arrived = 0;
inline int g_warp_arrived[64];
inline float g_warp_buf[64][32][8];
inline float g_shfl_buf[2][64][32];

inline void yield_to_scheduler() {
  swapcontext(&g_fibers[g_cur].ctx, &g_sched);
}

inline void __syncthreads() {
  g_fibers[g_cur].wait = 1;
  if (++g_block_arrived == static_cast<int>(blockDim.x)) {
    g_block_arrived = 0;
    for (auto& f : g_fibers)
      if (f.wait == 1) f.wait = 0;
  }
  yield_to_scheduler();
}

inline void warp_sync() {
  const int w = g_cur >> 5;
  g_fibers[g_cur].wait = 2;
  if (++g_warp_arrived[w] == 32) {
    g_warp_arrived[w] = 0;
    for (int l = 0; l < 32; ++l)
      if (g_fibers[32 * w + l].wait == 2) g_fibers[32 * w + l].wait = 0;
  }
  yield_to_scheduler();
}

// A shuffle: each lane posts its value, the warp meets, each lane reads
// its source's.  Shuffles alternate between two buffers, so one meeting
// each will do: a lane posts into a buffer again only two shuffles later,
// past a meeting that every lane reaches after its read of this one.
inline float shfl_from(float v, int src, bool keep) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  int& b = g_fibers[g_cur].shfl;
  g_shfl_buf[b][w][l] = v;
  warp_sync();
  const float r = keep ? v : g_shfl_buf[b][w][src];
  b ^= 1;
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int s) {
  return shfl_from(v, (threadIdx.x & 31) ^ s, false);
}
inline float __shfl_sync(unsigned, float v, int src) {
  return shfl_from(v, src & 31, false);
}
inline void __syncwarp() { warp_sync(); }
// one OS thread runs the whole grid, so a fence has nothing to order and an
// atomic nothing to race with
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* addr, unsigned v) {
  const unsigned old = *addr;
  *addr = old + v;
  return old;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __shfl_down_sync(unsigned, float v, int s) {
  const int src = (threadIdx.x & 31) + s;
  return shfl_from(v, src, src >= 32);
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T>
T __ldg(const T* p) { return *p; }

// cp.async of 16 (or `bytes`) bytes, zeros when !ok
inline void emu_cp16(float* d, const float* s) { std::memcpy(d, s, 16); }
inline void emu_cp16z(float* d, const float* s, bool ok) {
  if (ok) std::memcpy(d, s, 16);
  else std::memset(d, 0, 16);
}
inline void emu_cpz(float* d, const float* s, int bytes, bool ok) {
  if (ok) std::memcpy(d, s, bytes);
  else std::memset(d, 0, bytes);
}

// cvt.rna.tf32.f32: to nearest at a 10-bit mantissa, ties away from zero
inline uint32_t emu_tf32(float v) {
  uint32_t b;
  std::memcpy(&b, &v, 4);
  return (b + 0x1000u) & ~0x1FFFu;
}

// mma.sync m16n8k8 (row.col, TF32 in, fp32 accumulate) by the warp: each
// lane hands in its fragments, laid out as in the PTX ISA (a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g);
// d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1), with g the
// lane / 4 and t the lane % 4)
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  float* me = g_warp_buf[w][l];
  for (int e = 0; e < 4; ++e) me[e] = __uint_as_float(a[e]);
  me[4] = __uint_as_float(b0);
  me[5] = __uint_as_float(b1);
  warp_sync();
  float A[16][8], B[8][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln >> 2, t = ln & 3;
    const float* f = g_warp_buf[w][ln];
    A[g][t] = f[0]; A[g + 8][t] = f[1]; A[g][t + 4] = f[2]; A[g + 8][t + 4] = f[3];
    B[t][g] = f[4]; B[t + 4][g] = f[5];
  }
  warp_sync();
  const int g = l >> 2, t = l & 3;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += A[rows[e]][k] * B[k][cols[e]];
    d[e] += s;
  }
}

// float -> bf16 bits, to nearest even (cvt.rn.bf16.f32; no NaN here)
inline uint32_t emu_bf16(float v) {
  uint32_t b;
  std::memcpy(&b, &v, 4);
  return (b + 0x7FFFu + ((b >> 16) & 1u)) >> 16;
}

// cvt.rn.bf16x2.f32 of (hi, lo): lo in the low half
inline uint32_t emu_bf16x2(float lo, float hi) {
  return emu_bf16(lo) | (emu_bf16(hi) << 16);
}

inline float emu_bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
inline float emu_bf16_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

// mma.sync m16n8k16 (row.col, bf16 in, fp32 accumulate) by the warp, the
// fragments as in the PTX ISA: a0 (g, 2t | 2t + 1), a1 (g + 8, ...), a2 (g,
// 2t + 8 | 2t + 9), a3 (g + 8, ...); b0 (2t | 2t + 1, g), b1 (2t + 8 |
// 2t + 9, g), each register's low half the first; d as in emu_mma
inline void emu_mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                         uint32_t b1) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  float* me = g_warp_buf[w][l];
  for (int e = 0; e < 4; ++e) me[e] = __uint_as_float(a[e]);
  me[4] = __uint_as_float(b0);
  me[5] = __uint_as_float(b1);
  warp_sync();
  float A[16][16], B[16][8];
  auto bits = [](float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    return u;
  };
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln >> 2, t = ln & 3;
    const float* f = g_warp_buf[w][ln];
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = 2 * t + 8 * (r >> 1);
      A[row][col] = emu_bf16_lo(bits(f[r]));
      A[row][col + 1] = emu_bf16_hi(bits(f[r]));
    }
    for (int r = 0; r < 2; ++r) {
      B[2 * t + 8 * r][g] = emu_bf16_lo(bits(f[4 + r]));
      B[2 * t + 8 * r + 1][g] = emu_bf16_hi(bits(f[4 + r]));
    }
  }
  warp_sync();
  const int g = l >> 2, t = l & 3;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A[rows[e]][k] * B[k][cols[e]];
    d[e] += s;
  }
}

// kernel<<<grid, block, bytes, stream>>>(args) becomes
// Launch{grid, block}(kernel)(args)
inline std::function<void()> g_body;

inline void fiber_main() {
  g_body();
  g_fibers[g_cur].done = true;
}

template <class F, class... Args>
void run_grid(dim3 grid, dim3 block, F f, Args... args) {
  gridDim = grid;
  blockDim = block;
  g_body = [=]() { f(args...); };
  constexpr size_t kStack = 256 * 1024;
  if (g_stacks.size() < block.x) g_stacks.resize(block.x, std::vector<char>(kStack));
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      g_fibers.assign(block.x, Fiber());
      g_block_arrived = 0;
      std::memset(g_warp_arrived, 0, sizeof(g_warp_arrived));
      for (unsigned t = 0; t < block.x; ++t) {
        Fiber& fb = g_fibers[t];
        getcontext(&fb.ctx);
        fb.ctx.uc_stack.ss_sp = g_stacks[t].data();
        fb.ctx.uc_stack.ss_size = kStack;
        fb.ctx.uc_link = &g_sched;
        makecontext(&fb.ctx, fiber_main, 0);
      }
      for (unsigned live = block.x; live > 0;) {
        bool moved = false;
        live = 0;
        for (unsigned t = 0; t < block.x; ++t) {
          Fiber& fb = g_fibers[t];
          if (fb.done) continue;
          ++live;
          if (fb.wait != 0) continue;
          g_cur = static_cast<int>(t);
          threadIdx = dim3(t);
          swapcontext(&g_sched, &fb.ctx);
          moved = true;
        }
        if (live > 0 && !moved) std::abort();   // a barrier some thread skips
      }
    }
}

struct Launch {
  dim3 g, b;
  template <class F>
  struct Bound {
    F f;
    dim3 g, b;
    template <class... Args>
    void operator()(Args... args) { run_grid(g, b, f, args...); }
  };
  template <class F>
  Bound<F> operator()(F f) { return Bound<F>{f, g, b}; }
};
