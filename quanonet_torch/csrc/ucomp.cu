// Block-matrix compile of the HEA circuit, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_ucomp.py, joined
// there as the custom VJP _make_ucomp:
//
//   B4f  _fwd_kernel.  Per circuit block b with sublayers s = b*ld + d:
//
//     S_d  = U1t_s . B'_s                 (real x complex)
//     acc  = S_0 . S_1 ... S_{ld-1}
//     mt_b = H . acc . R_b                R_b = H, or I for block `last`
//
//   B4b  _bwd_kernel, the recompute-all VJP: the cotangents of U1t, B'r and
//   B'i from the cotangent (g_r, g_i) of mt.
//
//   Inputs u1t, br, bi (S, D, D) with S = nb*ld, fp32, unpacked; outputs
//   mt_r, mt_i (nb, D, D); H = H^{(x)n} / sqrt(D) is generated from the
//   index parity, never read.  Plain versions:
//   quanonet_torch/ops/cuda_ucomp.py ucomp_dense, ucomp_backward_dense.
//
// What bounds them.  At the flagship (nb 60, ld 2, D 32) the forward is
// about 11 real D^3 products a block, 43 MFLOP in all against 1.5 MB of
// operands and 0.5 MB of output: at 67 TFLOP/s and 3.35 TB/s both bounds
// are under a microsecond, so a call is bound by its launch and by the
// latency of 2*ld + 1 dependent products.  At D = 128 (Q7) the products
// are 64 times larger and the forward is bound by fp32 operations.
//
// Design.  mt_b = H . U1t . B' . U1t . B' ... . R is a chain of right
// products on the rows of H, so row panels are independent through the
// whole block (the block chain's shape of work, csrc/hea_chain.cu, with
// the rows of H as the batch).  One CTA owns a panel of P rows of one
// block: the panel lives in shared memory (two buffers, ping-pong, 16 KB
// at most whatever D), and each operator is streamed through it straight
// from device memory, where a thread reads column j of the operator
// (coalesced across the warp, reused for up to four rows it owns).  So no
// width needs more shared memory than another: D = 128, whose operands
// would not fit an SM, takes the same path with P = 8.  The order of the
// products differs from the plain version's (which folds S_d first), so
// the two agree to fp32 rounding, not bit for bit.
//
// The backward contracts the row index (Obar_k = X_{k-1}^H . Xbar_k with
// X_k the panel after k operators), a sum across panels.  It is done in a
// fixed order without atomics, as the block chain's Mbar is: the sweep
// kernel recomputes every X_k, runs the cotangent back through the
// adjoint operators and writes both to scratch that the wrapper
// allocated; a second kernel gives every output element one thread that
// sums the D rows in order.  Two calls on equal inputs give equal bits.
// A real operator's cotangent is the real part of that product, which is
// the Sr.B'r^T + Si.B'i^T of the TPU kernel.  No tensor cores, no TMA:
// plain fp32, simple.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;   // rows of the panel one thread owns

// A panel of P rows of D complex amplitudes in shared memory.
struct Panel {
  float* r;
  float* i;
};

// Operators: element (k, j) of the matrix the panel is multiplied by.
struct RealOp {               // O
  const float* __restrict__ o;
  int d;
  static constexpr bool kReal = true;
  __device__ __forceinline__ void get(int k, int j, float& vr, float& vi) const {
    vr = __ldg(o + k * d + j);
    vi = 0.f;
  }
};

struct RealOpT {              // O^T
  const float* __restrict__ o;
  int d;
  static constexpr bool kReal = true;
  __device__ __forceinline__ void get(int k, int j, float& vr, float& vi) const {
    vr = __ldg(o + j * d + k);
    vi = 0.f;
  }
};

struct ComplexOp {            // Or + i Oi
  const float* __restrict__ o_r;
  const float* __restrict__ o_i;
  int d;
  static constexpr bool kReal = false;
  __device__ __forceinline__ void get(int k, int j, float& vr, float& vi) const {
    vr = __ldg(o_r + k * d + j);
    vi = __ldg(o_i + k * d + j);
  }
};

struct ComplexOpAdj {         // (Or + i Oi)^H
  const float* __restrict__ o_r;
  const float* __restrict__ o_i;
  int d;
  static constexpr bool kReal = false;
  __device__ __forceinline__ void get(int k, int j, float& vr, float& vi) const {
    vr = __ldg(o_r + j * d + k);
    vi = -__ldg(o_i + j * d + k);
  }
};

struct HadamardOp {           // H^{(x)n} / sqrt(D), symmetric
  float scale;
  static constexpr bool kReal = true;
  __device__ __forceinline__ void get(int k, int j, float& vr, float& vi) const {
    vr = (__popc(k & j) & 1) ? -scale : scale;
    vi = 0.f;
  }
};

// y = x . Op on a panel of p rows; thread t owns column t % d of rows
// t / d, t / d + kThreads / d, ...  Ends with a barrier, so y may be read
// and x overwritten right after.
template <class Op>
__device__ __forceinline__ void apply(const Panel& x, const Panel& y,
                                      const Op& op, int d, int p) {
  const int j = threadIdx.x % d;
  const int rg = threadIdx.x / d;
  const int rgs = kThreads / d;
  float ar[kMaxRows], ai[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) ar[i] = ai[i] = 0.f;
  if (rg < p) {
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      float vr, vi;
      op.get(k, j, vr, vi);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int row = rg + i * rgs;
        if (row < p) {
          const float xr = x.r[row * d + k];
          const float xi = x.i[row * d + k];
          ar[i] = fmaf(xr, vr, ar[i]);
          ai[i] = fmaf(xi, vr, ai[i]);
          if (!Op::kReal) {
            ar[i] = fmaf(-xi, vi, ar[i]);
            ai[i] = fmaf(xr, vi, ai[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int row = rg + i * rgs;
      if (row < p) {
        y.r[row * d + j] = ar[i];
        y.i[row * d + j] = ai[i];
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void swap_panels(Panel& a, Panel& b) {
  const Panel t = a;
  a = b;
  b = t;
}

// The panel's rows of H; ends with a barrier.
__device__ __forceinline__ void load_hadamard(const Panel& x, int row0, int d,
                                              int p, float scale) {
  for (int e = threadIdx.x; e < p * d; e += kThreads) {
    x.r[e] = (__popc((row0 + e / d) & (e % d)) & 1) ? -scale : scale;
    x.i[e] = 0.f;
  }
  __syncthreads();
}

__device__ __forceinline__ void store_panel(const Panel& x, float* dst_r,
                                            float* dst_i, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) {
    dst_r[e] = x.r[e];
    dst_i[e] = x.i[e];
  }
}

// B4f.  Grid (D / P panels, nb blocks).
__global__ void __launch_bounds__(kThreads)
ucomp_fwd_kernel(const float* __restrict__ u1t, const float* __restrict__ br,
                 const float* __restrict__ bi, float* __restrict__ mt_r,
                 float* __restrict__ mt_i, int ld, int d, int p, int last,
                 float scale) {
  extern __shared__ float smem[];
  const int pd = p * d;
  Panel x{smem, smem + pd}, y{smem + 2 * pd, smem + 3 * pd};
  const int blk = blockIdx.y;
  const int row0 = blockIdx.x * p;
  const size_t dd = static_cast<size_t>(d) * d;

  load_hadamard(x, row0, d, p, scale);
  for (int s = blk * ld; s < (blk + 1) * ld; ++s) {
    apply(x, y, RealOp{u1t + s * dd, d}, d, p);
    swap_panels(x, y);
    apply(x, y, ComplexOp{br + s * dd, bi + s * dd, d}, d, p);
    swap_panels(x, y);
  }
  if (blk != last) {
    apply(x, y, HadamardOp{scale}, d, p);
    swap_panels(x, y);
  }
  const size_t out = blk * dd + static_cast<size_t>(row0) * d;
  store_panel(x, mt_r + out, mt_i + out, pd);
}

// B4b, the sweep.  Grid (D / P panels, nb blocks).  Slot q of block b in
// the scratch (nb, 2*ld, D, D): xs holds X_q, the panel before operator
// q (operators in chain order U1t_0, B'_0, U1t_1, B'_1, ...), xb holds
// the cotangent of the panel after it.
__global__ void __launch_bounds__(kThreads)
ucomp_bwd_sweep_kernel(const float* __restrict__ u1t,
                       const float* __restrict__ br,
                       const float* __restrict__ bi,
                       const float* __restrict__ g_r,
                       const float* __restrict__ g_i, float* __restrict__ xs_r,
                       float* __restrict__ xs_i, float* __restrict__ xb_r,
                       float* __restrict__ xb_i, int ld, int d, int p,
                       int last, float scale) {
  extern __shared__ float smem[];
  const int pd = p * d;
  Panel x{smem, smem + pd}, y{smem + 2 * pd, smem + 3 * pd};
  const int blk = blockIdx.y;
  const int row0 = blockIdx.x * p;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t rows = static_cast<size_t>(row0) * d;
  const size_t base = static_cast<size_t>(blk) * 2 * ld * dd + rows;

  // the forward again, every X_q kept
  load_hadamard(x, row0, d, p, scale);
  for (int dep = 0; dep < ld; ++dep) {
    const size_t s = static_cast<size_t>(blk) * ld + dep;
    const size_t q = base + 2 * dep * dd;
    store_panel(x, xs_r + q, xs_i + q, pd);
    apply(x, y, RealOp{u1t + s * dd, d}, d, p);
    swap_panels(x, y);
    store_panel(x, xs_r + q + dd, xs_i + q + dd, pd);
    if (dep + 1 < ld) {       // the last product's result is never needed
      apply(x, y, ComplexOp{br + s * dd, bi + s * dd, d}, d, p);
      swap_panels(x, y);
    }
  }
  __syncthreads();

  // the cotangent back through R (symmetric) and the adjoint operators
  const size_t in = blk * dd + rows;
  for (int e = threadIdx.x; e < pd; e += kThreads) {
    x.r[e] = g_r[in + e];
    x.i[e] = g_i[in + e];
  }
  __syncthreads();
  if (blk != last) {
    apply(x, y, HadamardOp{scale}, d, p);
    swap_panels(x, y);
  }
  for (int dep = ld - 1; dep >= 0; --dep) {
    const size_t s = static_cast<size_t>(blk) * ld + dep;
    const size_t q = base + 2 * dep * dd;
    store_panel(x, xb_r + q + dd, xb_i + q + dd, pd);
    apply(x, y, ComplexOpAdj{br + s * dd, bi + s * dd, d}, d, p);
    swap_panels(x, y);
    store_panel(x, xb_r + q, xb_i + q, pd);
    if (dep > 0) {
      apply(x, y, RealOpT{u1t + s * dd, d}, d, p);
      swap_panels(x, y);
    }
  }
}

// B4b, the operators' cotangents: Obar = X^H . Xbar summed over the D rows
// in order, one thread an element.  Grid (tiles of kThreads elements,
// 2*ld slots, nb blocks).
__global__ void __launch_bounds__(kThreads)
ucomp_bwd_obar_kernel(const float* __restrict__ xs_r,
                      const float* __restrict__ xs_i,
                      const float* __restrict__ xb_r,
                      const float* __restrict__ xb_i,
                      float* __restrict__ u1bar, float* __restrict__ bbar_r,
                      float* __restrict__ bbar_i, int ld, int d) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= d * d) return;
  const int i = e / d, j = e % d;
  const int q = blockIdx.y, blk = blockIdx.z;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t base = (static_cast<size_t>(blk) * 2 * ld + q) * dd;
  float ar = 0.f, ai = 0.f;
#pragma unroll 4
  for (int row = 0; row < d; ++row) {
    const float xr = xs_r[base + row * d + i];
    const float xi = xs_i[base + row * d + i];
    const float cr = xb_r[base + row * d + j];
    const float ci = xb_i[base + row * d + j];
    ar = fmaf(xr, cr, fmaf(xi, ci, ar));
    ai = fmaf(xr, ci, fmaf(-xi, cr, ai));
  }
  const size_t out = (static_cast<size_t>(blk) * ld + q / 2) * dd + e;
  if (q % 2 == 0) {           // U1t is real: the real part
    u1bar[out] = ar;
  } else {
    bbar_r[out] = ar;
    bbar_i[out] = ai;
  }
}

bool bad_shape(int nb, int ld, int d, int p) {
  return nb < 1 || nb > 65535 || ld < 1 || ld > 32767 || d < 2 || d > kThreads ||
         (d & (d - 1)) != 0 || p < 1 || p > d || d % p != 0 ||
         p > kMaxRows * (kThreads / d);
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_ucomp.py).  Each takes device pointers
// of contiguous fp32 tensors and the stream to launch on, and returns the
// cudaError_t of its launches (0 on success).  d is a power of two in
// [2, 256], p (the rows of a panel) divides d, scale = 1 / sqrt(d), last
// is the block whose right factor is I (-1: none).

// B4f.  u1t, br, bi (nb*ld, d, d) -> mt_r, mt_i (nb, d, d).
extern "C" int ucomp_forward(const float* u1t, const float* br,
                             const float* bi, float* mt_r, float* mt_i,
                             int nb, int ld, int d, int p, int last,
                             float scale, void* stream) {
  if (bad_shape(nb, ld, d, p)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(d / p), static_cast<unsigned>(nb));
  const size_t smem = sizeof(float) * 4 * p * d;
  ucomp_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u1t, br, bi, mt_r, mt_i, ld, d, p, last, scale);
  return static_cast<int>(cudaGetLastError());
}

// B4b.  g_r, g_i (nb, d, d): the cotangent of mt.  xs_*, xb_*
// (nb, 2*ld, d, d): scratch.  Writes u1bar, bbar_r, bbar_i (nb*ld, d, d).
extern "C" int ucomp_backward(const float* u1t, const float* br,
                              const float* bi, const float* g_r,
                              const float* g_i, float* xs_r, float* xs_i,
                              float* xb_r, float* xb_i, float* u1bar,
                              float* bbar_r, float* bbar_i, int nb, int ld,
                              int d, int p, int last, float scale,
                              void* stream) {
  if (bad_shape(nb, ld, d, p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(d / p), static_cast<unsigned>(nb));
  const size_t smem = sizeof(float) * 4 * p * d;
  ucomp_bwd_sweep_kernel<<<grid, kThreads, smem, s>>>(
      u1t, br, bi, g_r, g_i, xs_r, xs_i, xb_r, xb_i, ld, d, p, last, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ogrid(static_cast<unsigned>((d * d + kThreads - 1) / kThreads),
                   static_cast<unsigned>(2 * ld), static_cast<unsigned>(nb));
  ucomp_bwd_obar_kernel<<<ogrid, kThreads, 0, s>>>(
      xs_r, xs_i, xb_r, xb_i, u1bar, bbar_r, bbar_i, ld, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ucomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
