// Block-matrix compile of the HEA circuit from the ansatz weights, forward
// and backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_ucomp.py, joined
// there as the custom VJP _make_ucomp:
//
//   B4f  _fwd_kernel.  The Hadamard-folded, transposed block matrices
//        mt_b = H . prod_d (U1t_s . B'_s) . R_b,   s = b*ld + d,
//        R_b = H, or I for block `last` (for every block when last = -2:
//        the final blocks of several chains in one launch).
//   B4b  _bwd_kernel.  The weights' cotangent from the cotangent (g_r, g_i)
//        of mt.
//
// Contract.  Input: the weights w (S, 3, n), S = nb*ld, fp32: per sublayer
// the RY angles (row 0), the RZ angles (row 1) and the second RY angles
// (row 2).  Output of B4f: mt_r, mt_i (nb, D, D), D = 2^n <= 128, in the
// layout the chain kernels read; of B4b: wbar (S, 3, n).  The TPU kernel
// took U1t, B'r, B'i (S, D, D) built by elementwise XLA ops and differentiated
// by autodiff; here no operator matrix exists.  Plain version:
// quanonet_torch/ops/cuda_ucomp.py ucomp_weights_dense (ucomp_dense of
// compile_operands) and ucomp_weights_backward_dense.
//
// The function as gate passes.  Every factor is structured: U1t and U2t are
// Kronecker products of 2 x 2 rotations, the RZ factor a diagonal, P' a
// permutation (the CNOT ring), H a Kronecker product of 2 x 2 butterflies.
// So row r of mt_b is row r of H carried through n-qubit gate passes, for
// each sublayer d:
//
//   RY    per qubit q, c, s = cos, sin(w[s,0,q] / 2): the amplitudes a, b
//         whose indices differ in bit q (a: bit 0) become a c - b s, a s + b c;
//   phase amplitude k times exp(-i/2 sum_q w[s,1,q] (1 - 2 bit_q(k)));
//   RY'   the RY pass with w[s,2,.];
//   ring  x <- x[inv], inv the inverse CNOT-ring permutation;
//
// and last, unless b = last, a Hadamard pass.  That is O(n D) a row where a
// product is O(D^2).  Rows are independent through a block (the block
// chain's shape of work, with the rows of H as the batch).
//
// The backward walks each row back: it recomputes the row's forward, then
// carries the state and the cotangent back together through the inverse
// passes (every pass is unitary: RY(-theta), the conjugate phase, the
// inverse gather), and at each gate takes the cotangent of its angle:
//
//   RY on qubit q:  theta_bar = 1/2 sum_pairs Re(conj(g_b) y_a - conj(g_a) y_b)
//   phase, qubit q: w_bar     = 1/2 sum_k (1 - 2 bit_q(k)) Im(conj(g_k) y_k)
//
// with y, g the state and cotangent right after the gate.  Undoing a pass
// differs from keeping the state by fp32 rounding only.
//
// Design.  A warp carries one row (D <= 32: a lane an amplitude, and
// 32 / D rows a warp up to D rows; D = 64, 128: 2 or 4 amplitudes a lane,
// the high index bits in registers).  A qubit on a lane bit pairs lanes
// through __shfl_xor_sync, one on a register bit pairs registers; the ring
// gather goes through __shfl_sync (D <= 32) or a row in shared memory.  A
// CTA of `warps` warps loads its block's weights once and computes their
// cos and sin (full-precision sincosf, never __sincosf) and the phase
// diagonal of each sublayer into shared memory.  The grid is (ctas, nb):
// the wrapper picks warps and ctas from D, nb and the SM count.  The
// backward reduces each sublayer's 3n angle cotangents over the warp with
// a reduce-scatter butterfly, adds them per warp in shared memory, sums the
// warps in order and writes one partial per (block, CTA); a second small
// launch sums the CTAs of a block in order when there is more than one.
// No atomics: two calls on equal inputs give equal bits.
//
// What bounds it.  At the flagship (nb 60, ld 2, D 32) the gate form is
// about 9 MFLOP forward (the matrix form 29) and 0.5 MB of output, a bound
// of 0.00015 ms at the card's fp32 rate and memory rate
// (chip_smoke.ucomp_counts); a call is bound by its launch and by the
// latency of one row's dependent passes (shuffles): B4f takes about
// 0.002 ms on the card and B4b 0.005-0.006 ms in its two launches, on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).  No tensor
// cores: no D x D product is left for them to do.  No TMA: the only input
// is the weights (7 KB at the flagship), nothing worth a bulk copy.
//
// The opt-in bf16 operand mode (UCOMP_BF16) rounds the TPU kernel's
// products, so it keeps their matrix form: B4f-bf16 and B4b-bf16 below
// ("the bf16 operand mode"), on the tensor cores.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr int kMaxQubits = 7;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;
constexpr int kEveryBlock = -2;   // `last`: every block's right factor is I

// Whether block blk ends with the Hadamard pass (R = H).
__device__ __forceinline__ bool right_h(int blk, int last) {
  return last != kEveryBlock && blk != last;
}

// The layout of one row over a warp at n qubits.
template <int N>
struct Row {
  static constexpr int D = 1 << N;
  static constexpr int A = D > 32 ? D / 32 : 1;     // amplitudes a lane holds
  static constexpr int SEG = D < 32 ? D : 32;       // lanes one row spans
  static constexpr int RW =                         // rows a warp holds
      D >= 32 ? 1 : (32 / D < D ? 32 / D : D);
  static constexpr int G = D / RW;                  // row groups of a block
};

int row_groups(int n) {
  const int d = 1 << n;
  const int rw = d >= 32 ? 1 : (32 / d < d ? 32 / d : d);
  return d / rw;
}

// Index of the amplitude register j of `lane` holds.
template <int N>
__device__ __forceinline__ int amp(int lane, int j) {
  return Row<N>::D > 32 ? lane + 32 * j : (lane & (Row<N>::SEG - 1));
}

// The CNOT ring (control (i + 1) % n, target i, for i = 0 .. n-1): the
// gather that applies it, x_new[k] = x_old[ring_inv(k)], and the one that
// undoes it, x_old[k] = x_new[ring_perm(k)].
template <int N>
__device__ __forceinline__ int ring_perm(int k) {
  if (N > 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) k ^= ((k >> ((i + 1) % N)) & 1) << i;
  }
  return k;
}

template <int N>
__device__ __forceinline__ int ring_inv(int k) {
  if (N > 1) {
#pragma unroll
    for (int i = N - 1; i >= 0; --i) k ^= ((k >> ((i + 1) % N)) & 1) << i;
  }
  return k;
}

// A row's amplitudes in one lane.
template <int N>
struct Amps {
  float r[Row<N>::A], i[Row<N>::A];
};

// Row `row` of H^{(x)n} / sqrt(D).
template <int N>
__device__ __forceinline__ void hadamard_row(Amps<N>& x, int row, int lane,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < Row<N>::A; ++j) {
    x.r[j] = (__popc(row & amp<N>(lane, j)) & 1) ? -scale : scale;
    x.i[j] = 0.f;
  }
}

// The RY pass on x: cs holds (c, s) per qubit.
template <int N>
__device__ __forceinline__ void ry_pass(Amps<N>& x, const float* cs,
                                        int lane) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float c = cs[2 * q], s = cs[2 * q + 1];
    if (q < 5) {
      const int m = 1 << q;
      const float sp = (lane & m) ? s : -s;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        const float pr = __shfl_xor_sync(kFull, x.r[j], m);
        const float pi = __shfl_xor_sync(kFull, x.i[j], m);
        x.r[j] = fmaf(x.r[j], c, pr * sp);
        x.i[j] = fmaf(x.i[j], c, pi * sp);
      }
    } else {
      const int jb = q >= 5 ? 1 << (q - 5) : 0;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        if (j & jb) continue;
        const float ar = x.r[j], ai = x.i[j];
        const float br = x.r[j | jb], bi = x.i[j | jb];
        x.r[j] = fmaf(ar, c, -br * s);
        x.i[j] = fmaf(ai, c, -bi * s);
        x.r[j | jb] = fmaf(ar, s, br * c);
        x.i[j | jb] = fmaf(ai, s, bi * c);
      }
    }
  }
}

// The Hadamard pass x <- x . H^{(x)n} / sqrt(D) (its own inverse).
template <int N>
__device__ __forceinline__ void hadamard_pass(Amps<N>& x, int lane,
                                              float scale) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < 5) {
      const int m = 1 << q;
      const bool hi = lane & m;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        const float pr = __shfl_xor_sync(kFull, x.r[j], m);
        const float pi = __shfl_xor_sync(kFull, x.i[j], m);
        x.r[j] = hi ? pr - x.r[j] : x.r[j] + pr;
        x.i[j] = hi ? pi - x.i[j] : x.i[j] + pi;
      }
    } else {
      const int jb = q >= 5 ? 1 << (q - 5) : 0;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        if (j & jb) continue;
        const float ar = x.r[j], ai = x.i[j];
        x.r[j] = ar + x.r[j | jb];
        x.i[j] = ai + x.i[j | jb];
        x.r[j | jb] = ar - x.r[j | jb];
        x.i[j | jb] = ai - x.i[j | jb];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Row<N>::A; ++j) {
    x.r[j] *= scale;
    x.i[j] *= scale;
  }
}

// x times the phase diagonal z (cos phi, -sin phi), or its conjugate.
template <int N, bool kConj>
__device__ __forceinline__ void phase_pass(Amps<N>& x, const float2* z,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < Row<N>::A; ++j) {
    const float2 p = z[amp<N>(lane, j)];
    const float zi = kConj ? -p.y : p.y;
    const float xr = x.r[j];
    x.r[j] = fmaf(xr, p.x, -x.i[j] * zi);
    x.i[j] = fmaf(x.i[j], p.x, xr * zi);
  }
}

// x_new[k] = x_old[src(k)], src = ring_inv (kInverse false) or ring_perm;
// buf is this warp's row of 2 D floats in shared memory (D > 32).
template <int N, bool kInverse>
__device__ __forceinline__ void ring_pass(Amps<N>& x, float* buf, int lane) {
  constexpr int D = Row<N>::D;
  if (N == 1) return;
  if (D <= 32) {
    const int pos = lane & (D - 1);
    const int src = (lane - pos) | (kInverse ? ring_perm<N>(pos)
                                             : ring_inv<N>(pos));
    x.r[0] = __shfl_sync(kFull, x.r[0], src);
    x.i[0] = __shfl_sync(kFull, x.i[0], src);
  } else {
#pragma unroll
    for (int j = 0; j < Row<N>::A; ++j) {
      buf[lane + 32 * j] = x.r[j];
      buf[D + lane + 32 * j] = x.i[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < Row<N>::A; ++j) {
      const int k = lane + 32 * j;
      const int src = kInverse ? ring_perm<N>(k) : ring_inv<N>(k);
      x.r[j] = buf[src];
      x.i[j] = buf[D + src];
    }
    __syncwarp();
  }
}

// Shared memory of a CTA, in floats: the phase diagonals (ld, D) as
// float2, the (c, s) of both RY layers (ld, 2, n, 2), a row per warp for
// the ring gather (D > 32), and in the backward the warps' angle
// cotangents (warps, ld, 3, n).
__host__ __device__ __forceinline__ int smem_floats(int n, int ld, int warps,
                                                    bool backward) {
  const int d = 1 << n;
  return 2 * ld * d + 4 * ld * n + (d > 32 ? warps * 2 * d : 0) +
         (backward ? warps * ld * 3 * n : 0);
}

struct Tables {
  float2* z;      // (ld, D)
  float* cs;      // (ld, 2, n, 2)
  float* buf;     // (warps, 2, D)
  float* part;    // (warps, ld, 3, n)
};

template <int N>
__device__ __forceinline__ Tables tables(float* smem, int ld, int warps) {
  constexpr int D = Row<N>::D;
  Tables t;
  t.z = reinterpret_cast<float2*>(smem);
  t.cs = smem + 2 * ld * D;
  t.buf = t.cs + 4 * ld * N;
  t.part = t.buf + (D > 32 ? warps * 2 * D : 0);
  return t;
}

// Block blk's weights into the tables; ends with a barrier.
template <int N>
__device__ __forceinline__ void load_tables(const Tables& t,
                                            const float* __restrict__ w,
                                            int blk, int ld) {
  constexpr int D = Row<N>::D;
  const float* wb = w + static_cast<size_t>(blk) * ld * 3 * N;
  for (int e = threadIdx.x; e < ld * 2 * N; e += blockDim.x) {
    const int d = e / (2 * N), layer = (e / N) % 2, q = e % N;
    float s, c;
    sincosf(0.5f * __ldg(wb + (3 * d + 2 * layer) * N + q), &s, &c);
    t.cs[2 * e] = c;
    t.cs[2 * e + 1] = s;
  }
  for (int e = threadIdx.x; e < ld * D; e += blockDim.x) {
    const int d = e / D, k = e % D;
    float ph = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float h = 0.5f * __ldg(wb + (3 * d + 1) * N + q);
      ph += ((k >> q) & 1) ? -h : h;
    }
    float s, c;
    sincosf(ph, &s, &c);
    t.z[e] = make_float2(c, -s);
  }
  __syncthreads();
}

// One sublayer forward.
template <int N>
__device__ __forceinline__ void sublayer(Amps<N>& x, const Tables& t, int d,
                                         float* buf, int lane) {
  ry_pass<N>(x, t.cs + (2 * d) * 2 * N, lane);
  phase_pass<N, false>(x, t.z + d * Row<N>::D, lane);
  ry_pass<N>(x, t.cs + (2 * d + 1) * 2 * N, lane);
  ring_pass<N, false>(x, buf, lane);
}

// B4f.  Grid (ctas, nb); a warp carries row groups warp + warps * blockIdx.x,
// then every (ctas * warps)-th.
template <int N>
__global__ void __launch_bounds__(32 * kMaxWarps)
ucomp_fwd_kernel(const float* __restrict__ w, float* __restrict__ mt_r,
                 float* __restrict__ mt_i, int ld, int last, float scale) {
  using R = Row<N>;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, blk = blockIdx.y;
  const Tables t = tables<N>(smem, ld, warps);
  load_tables<N>(t, w, blk, ld);
  float* buf = t.buf + warp * 2 * R::D;
  const int seg = lane / R::SEG;
  const bool valid = seg < R::RW;
  const size_t base = static_cast<size_t>(blk) * R::D * R::D;
  for (int rg = blockIdx.x * warps + warp; rg < R::G;
       rg += gridDim.x * warps) {
    const int row = rg * R::RW + (valid ? seg : 0);
    Amps<N> x;
    hadamard_row<N>(x, row, lane, scale);
    for (int d = 0; d < ld; ++d) sublayer<N>(x, t, d, buf, lane);
    if (right_h(blk, last)) hadamard_pass<N>(x, lane, scale);
    if (valid) {
      const size_t o = base + static_cast<size_t>(row) * R::D;
#pragma unroll
      for (int j = 0; j < R::A; ++j) {
        mt_r[o + amp<N>(lane, j)] = x.r[j];
        mt_i[o + amp<N>(lane, j)] = x.i[j];
      }
    }
  }
}

// The RY pass of one sublayer walked back: x and g (state and cotangent
// after the pass) become those before it, and acc[q] gains twice the
// cotangent of qubit q's angle, this lane's share.
template <int N>
__device__ __forceinline__ void ry_back(Amps<N>& x, Amps<N>& g,
                                        const float* cs, float* acc,
                                        int lane) {
#pragma unroll
  for (int q = N - 1; q >= 0; --q) {
    const float c = cs[2 * q], s = cs[2 * q + 1];
    if (q < 5) {
      const int m = 1 << q;
      const bool hi = lane & m;
      const float sp = hi ? -s : s;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        const float xr = __shfl_xor_sync(kFull, x.r[j], m);
        const float xi = __shfl_xor_sync(kFull, x.i[j], m);
        const float gr = __shfl_xor_sync(kFull, g.r[j], m);
        const float gi = __shfl_xor_sync(kFull, g.i[j], m);
        // b: + Re(conj(g_b) y_a); a: - Re(conj(g_a) y_b)
        const float t = fmaf(g.r[j], xr, g.i[j] * xi);
        acc[q] += hi ? t : -t;
        x.r[j] = fmaf(x.r[j], c, xr * sp);
        x.i[j] = fmaf(x.i[j], c, xi * sp);
        g.r[j] = fmaf(g.r[j], c, gr * sp);
        g.i[j] = fmaf(g.i[j], c, gi * sp);
      }
    } else {
      const int jb = q >= 5 ? 1 << (q - 5) : 0;
#pragma unroll
      for (int j = 0; j < Row<N>::A; ++j) {
        if (j & jb) continue;
        const int k = j | jb;
        acc[q] += fmaf(g.r[k], x.r[j], g.i[k] * x.i[j]) -
                  fmaf(g.r[j], x.r[k], g.i[j] * x.i[k]);
        const float ar = x.r[j], ai = x.i[j], gar = g.r[j], gai = g.i[j];
        x.r[j] = fmaf(ar, c, x.r[k] * s);
        x.i[j] = fmaf(ai, c, x.i[k] * s);
        x.r[k] = fmaf(x.r[k], c, -ar * s);
        x.i[k] = fmaf(x.i[k], c, -ai * s);
        g.r[j] = fmaf(gar, c, g.r[k] * s);
        g.i[j] = fmaf(gai, c, g.i[k] * s);
        g.r[k] = fmaf(g.r[k], c, -gar * s);
        g.i[k] = fmaf(g.i[k], c, -gai * s);
      }
    }
  }
}

// The phase pass walked back, acc[q] gaining twice the cotangent of qubit
// q's RZ angle: sum_k (1 - 2 bit_q(k)) Im(conj(g_k) y_k).
template <int N>
__device__ __forceinline__ void phase_back(Amps<N>& x, Amps<N>& g,
                                           const float2* z, float* acc,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < Row<N>::A; ++j) {
    const int k = amp<N>(lane, j);
    const float t = fmaf(g.r[j], x.i[j], -g.i[j] * x.r[j]);
#pragma unroll
    for (int q = 0; q < N; ++q) acc[q] += ((k >> q) & 1) ? -t : t;
  }
  phase_pass<N, true>(x, z, lane);
  phase_pass<N, true>(g, z, lane);
}

// The C values v[0 .. C) of every lane summed over the warp, one value
// a lane at the end: a reduce-scatter butterfly.  At offset O, while more
// than one value is left, a lane keeps the half of its values that its bit
// O selects (idx gains that half's start) and adds the partner's copy of
// it, C / 2 shuffles; with one value left, a plain butterfly step.  So V
// values cost V - 1 + log2(32 / V) shuffles, not 5 V.  Lane l ends with
// value idx summed over the warp in a fixed order.
template <int C, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane, int& idx) {
  if constexpr (O > 0) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = up ? v[H + i] : v[i];
        const float give = up ? v[i] : v[H + i];
        v[i] = keep + __shfl_xor_sync(kFull, give, O);
      }
      if (up) idx += H;
      reduce_scatter<H, O / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<1, O / 2>(v, lane, idx);
    }
  }
}

// Values per lane of the angle reduction: 3 n padded to a power of two.
template <int N>
struct Angles {
  static constexpr int V =
      3 * N <= 4 ? 4 : 3 * N <= 8 ? 8 : 3 * N <= 16 ? 16 : 32;
};

// B4b.  Grid (ctas, nb), rows as in the forward.  With ctas == 1 writes
// wbar; else this CTA's partial sums (unscaled) to part (nb, ctas, ld*3*n).
template <int N>
__global__ void __launch_bounds__(32 * kMaxWarps)
ucomp_bwd_kernel(const float* __restrict__ w, const float* __restrict__ g_r,
                 const float* __restrict__ g_i, float* __restrict__ part,
                 float* __restrict__ wbar, int ld, int last, float scale) {
  using R = Row<N>;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, blk = blockIdx.y;
  const int per_block = ld * 3 * N;
  const Tables t = tables<N>(smem, ld, warps);
  for (int e = threadIdx.x; e < warps * per_block; e += blockDim.x)
    t.part[e] = 0.f;
  load_tables<N>(t, w, blk, ld);
  float* buf = t.buf + warp * 2 * R::D;
  float* mine = t.part + warp * per_block;
  const int seg = lane / R::SEG;
  const bool valid = seg < R::RW;
  const size_t base = static_cast<size_t>(blk) * R::D * R::D;
  for (int rg = blockIdx.x * warps + warp; rg < R::G;
       rg += gridDim.x * warps) {
    const int row = rg * R::RW + (valid ? seg : 0);
    Amps<N> x, g;
    hadamard_row<N>(x, row, lane, scale);
    for (int d = 0; d < ld; ++d) sublayer<N>(x, t, d, buf, lane);
    const size_t o = base + static_cast<size_t>(row) * R::D;
#pragma unroll
    for (int j = 0; j < R::A; ++j) {
      g.r[j] = valid ? __ldg(g_r + o + amp<N>(lane, j)) : 0.f;
      g.i[j] = valid ? __ldg(g_i + o + amp<N>(lane, j)) : 0.f;
    }
    if (right_h(blk, last))
      hadamard_pass<N>(g, lane, scale);   // R = H: symmetric
    for (int d = ld - 1; d >= 0; --d) {
      constexpr int V = Angles<N>::V;
      float acc[V];        // rows 0 (RY), 1 (RZ), 2 (RY') of (3, n), padded
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      ring_pass<N, true>(x, buf, lane);
      ring_pass<N, true>(g, buf, lane);
      ry_back<N>(x, g, t.cs + (2 * d + 1) * 2 * N, acc + 2 * N, lane);
      phase_back<N>(x, g, t.z + d * R::D, acc + N, lane);
      ry_back<N>(x, g, t.cs + (2 * d) * 2 * N, acc, lane);
      int idx = 0;
      reduce_scatter<V, 16>(acc, lane, idx);
      if ((lane & (32 / V - 1)) == 0 && idx < 3 * N)
        mine[3 * d * N + idx] += acc[0];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < per_block; e += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < warps; ++v) s += t.part[v * per_block + e];
    if (gridDim.x == 1) {
      wbar[static_cast<size_t>(blk) * per_block + e] = 0.5f * s;
    } else {
      part[(static_cast<size_t>(blk) * gridDim.x + blockIdx.x) * per_block +
           e] = s;
    }
  }
}

// B4b, the CTAs of each block summed in order.  Grid nb.
__global__ void __launch_bounds__(128)
ucomp_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ wbar,
                     int per_block, int ctas) {
  const int blk = blockIdx.x;
  for (int e = threadIdx.x; e < per_block; e += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < ctas; ++c)
      s += part[(static_cast<size_t>(blk) * ctas + c) * per_block + e];
    wbar[static_cast<size_t>(blk) * per_block + e] = 0.5f * s;
  }
}

// ── the bf16 operand mode (UCOMP_BF16): the product form ──────────────────
//
// B4f-bf16 and B4b-bf16, pallas_ucomp's _fwd_kernel and _bwd_kernel under
// UCOMP_BF16: every D x D product of the TPU kernel, here per block and
// unpacked, on bf16-rounded operands (to nearest even) with fp32 sums.  The
// gate form above has no product left to round, so this mode keeps the
// matrix form: the operands u1t, br, bi (S, D, D) come from the elementwise
// build in PyTorch (cuda_ucomp.compile_operands), differentiated there by
// autograd, as in the JAX package.  Per block b, sublayers s = b ld + d:
//
//   forward   S_d = U1t_s . B'_s (two real products); acc = S_0, then
//             acc <- acc . S_d in the three-product form (t1 = ar br,
//             t2 = ai bi, t3 = (ar + ai)(br + bi), the sums in fp32 before
//             their rounding; re t1 - t2, im t3 - t1 - t2); mt = (H acc) R.
//   backward  the algebra of _bwd_kernel: the S_d and fold prefixes
//             recomputed, accbar = (H g) R, and for d = ld-1 .. 0 the
//             four-product S_d-bar = pre^H accbar, accbar <- accbar S_d^H,
//             u1bar = Sbar_r B'r^T + Sbar_i B'i^T, bbar = U1t^T Sbar.
//
// Every operand is rounded where it enters a product, from its fp32 value:
// H (+-fp32(1/sqrt D)) and R, acc, H acc and the cotangents as the TPU
// kernel's _dot rounds them.  Plain version: cuda_ucomp.ucomp_dense and
// ucomp_backward_dense with bf16=True.
//
// Design.  A CTA walks blocks blockIdx.x, + gridDim.x, ...; its kBfWarps
// warps share each product's m16 x n8 output tiles, each tile a chain of
// mma.sync m16n8k16 bf16 (fp32 accumulation) over k, its fragments read
// from fp32 planes (Dp x Dp, Dp = max(D, 16), zero past D: the padding of
// the TPU kernel's block-diagonal packing, exact) and rounded as they are
// packed.  The planes live in shared memory where they fit, else in the
// CTA's part of a device-memory scratch (D = 128, or a deep backward); the
// wrapper picks by ucomp_bf16_bytes.  What bounds it: at the flagship (nb
// 60, ld 2, D 32) 11 (forward) or 24 (backward) products of 32^3 MACs a
// block, 0.04 / 0.09 GFLOP (0.00004 / 0.0001 ms at the card's bf16 peak)
// against 2.0 / 3.4 MB of operands and results (0.0006 / 0.001 ms at its
// memory rate): bytes bound it, and a block's chain of dependent products
// and barriers sets a launch (chip_smoke.py bf16_modes; PERF.md).

constexpr int kBfWarps = 8;

// lo and hi rounded to bf16 (to nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// d += a . b: mma.sync m16n8k16, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Padded width and plane pitch at n qubits.
__host__ __device__ __forceinline__ int bf_dp(int n) {
  return (1 << n) < 16 ? 16 : 1 << n;
}
__host__ __device__ __forceinline__ int bf_pitch(int n) { return bf_dp(n) + 4; }

// Planes a CTA holds: forward acc, S and the next acc (2 each); backward
// the S_d (2 ld), the fold prefixes past S_0 (2 (ld - 2)), accbar, its next
// value and Sbar (6).
__host__ __device__ __forceinline__ int bf_planes(int ld, bool backward) {
  return backward ? 2 * ld + 2 * (ld > 2 ? ld - 2 : 0) + 6 : 6;
}

size_t bf_bytes(int n, int ld, bool backward) {
  return sizeof(float) * static_cast<size_t>(bf_planes(ld, backward)) * bf_dp(n) *
         bf_pitch(n);
}

// An operand of a product: element (i, k) of a D x D matrix, zero outside
// it, in fp32 before its rounding: p[i][k] (+ q[i][k], the sums of the
// three-product form), at row stride ld, transposed with trans, negated with
// neg; without p generated: H^{(x)n} / sqrt(D) (had) or I.
struct Opnd {
  const float* p;
  const float* q;
  int ld;
  bool trans, neg, had;
};

__device__ __forceinline__ Opnd mem(const float* p, int ld, bool trans = false,
                                    bool neg = false, const float* q = nullptr) {
  return Opnd{p, q, ld, trans, neg, false};
}
__device__ __forceinline__ Opnd gen(bool had) {
  return Opnd{nullptr, nullptr, 0, false, false, had};
}

__device__ __forceinline__ float elem(const Opnd& o, int i, int k, int d,
                                      float hs) {
  if (i >= d || k >= d) return 0.f;
  float v;
  if (o.p == nullptr) {
    v = o.had ? ((__popc(i & k) & 1) ? -hs : hs) : (i == k ? 1.f : 0.f);
  } else {
    const int at = o.trans ? k * o.ld + i : i * o.ld + k;
    v = o.p[at];
    if (o.q != nullptr) v += o.q[at];
  }
  return o.neg ? -v : v;
}

// One product term: acc[slot] += A . B.
struct Term {
  Opnd a, b;
  int slot;
};

// A destination: rows of stride ld, written where i, j < lim.
struct Dst {
  float* p;
  int ld, lim;
};

// The terms' sums over the Dp x Dp output, its m16 x n8 tiles shared by the
// warps; then out0 = slot 0, out1 = slot 1, or with kara the three-product
// form's out0 = t0 - t1, out1 = t2 - t0 - t1 (out1.p may be null).  No
// barrier: the caller's follows.
template <int T, bool KARA>
__device__ void bf_gemm(const Term (&terms)[T], Dst out0, Dst out1, int d,
                        int dp, float hs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tn = dp >> 3, tiles = (dp >> 4) * tn;
  for (int t = warp; t < tiles; t += blockDim.x >> 5) {
    const int i0 = (t / tn) * 16 + gid, j0 = (t % tn) * 8 + gid;
    float acc[3][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;
    for (int k0 = 0; k0 < dp; k0 += 16) {
      const int k = k0 + 2 * tig;
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const Opnd& A = terms[u].a;
        const Opnd& B = terms[u].b;
        const uint32_t a[4] = {
            pack_bf16(elem(A, i0, k, d, hs), elem(A, i0, k + 1, d, hs)),
            pack_bf16(elem(A, i0 + 8, k, d, hs), elem(A, i0 + 8, k + 1, d, hs)),
            pack_bf16(elem(A, i0, k + 8, d, hs), elem(A, i0, k + 9, d, hs)),
            pack_bf16(elem(A, i0 + 8, k + 8, d, hs),
                      elem(A, i0 + 8, k + 9, d, hs))};
        const uint32_t b0 = pack_bf16(elem(B, k, j0, d, hs), elem(B, k + 1, j0, d, hs));
        const uint32_t b1 = pack_bf16(elem(B, k + 8, j0, d, hs),
                                      elem(B, k + 9, j0, d, hs));
        mma_bf16(acc[terms[u].slot], a, b0, b1);
      }
    }
    const int r0 = (t / tn) * 16 + gid, c0 = (t % tn) * 8 + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + (e >> 1) * 8, j = c0 + (e & 1);
      const float v0 = KARA ? acc[0][e] - acc[1][e] : acc[0][e];
      const float v1 = KARA ? acc[2][e] - acc[0][e] - acc[1][e] : acc[1][e];
      if (i < out0.lim && j < out0.lim) out0.p[i * out0.ld + j] = v0;
      if (out1.p != nullptr && i < out1.lim && j < out1.lim)
        out1.p[i * out1.ld + j] = v1;
    }
  }
}

// A complex matrix held as two planes.
struct Cplx {
  float* r;
  float* i;
};

__device__ __forceinline__ Dst plane(float* p, int pitch, int dp) {
  return Dst{p, pitch, dp};
}

// dst = a . b, complex, three-product form; the barrier after it.
__device__ void bf_kara(Cplx a, Cplx b, Cplx dst, int d, int dp, int pitch,
                        float hs) {
  const Term terms[3] = {
      {mem(a.r, pitch), mem(b.r, pitch), 0},
      {mem(a.i, pitch), mem(b.i, pitch), 1},
      {mem(a.r, pitch, false, false, a.i), mem(b.r, pitch, false, false, b.i), 2}};
  bf_gemm<3, true>(terms, plane(dst.r, pitch, dp), plane(dst.i, pitch, dp), d, dp,
                   hs);
  __syncthreads();
}

// dst = U1t_s . B'_s (two real products); the barrier after it.
__device__ void bf_sublayer(const float* u1t, const float* br, const float* bi,
                            size_t s, Cplx dst, int d, int dp, int pitch,
                            float hs) {
  const size_t o = s * d * d;
  const Term terms[2] = {{mem(u1t + o, d), mem(br + o, d), 0},
                         {mem(u1t + o, d), mem(bi + o, d), 1}};
  bf_gemm<2, false>(terms, plane(dst.r, pitch, dp), plane(dst.i, pitch, dp), d,
                    dp, hs);
  __syncthreads();
}

// dst = (H x) R for x in planes (src_ld = pitch) or in device memory
// (src_ld = D), through the planes tmp; the barriers after each product.
__device__ void bf_hxr(const float* xr, const float* xi, int src_ld, Cplx tmp,
                       bool r_had, Dst dr, Dst di, int d, int dp, int pitch,
                       float hs) {
  const Term h[2] = {{gen(true), mem(xr, src_ld), 0}, {gen(true), mem(xi, src_ld), 1}};
  bf_gemm<2, false>(h, plane(tmp.r, pitch, dp), plane(tmp.i, pitch, dp), d, dp, hs);
  __syncthreads();
  const Term r[2] = {{mem(tmp.r, pitch), gen(r_had), 0},
                     {mem(tmp.i, pitch), gen(r_had), 1}};
  bf_gemm<2, false>(r, dr, di, d, dp, hs);
  __syncthreads();
}

// B4f-bf16.  Grid ctas; planes in smem, or scratch (ctas, planes, Dp, pitch).
template <int N>
__global__ void __launch_bounds__(32 * kBfWarps)
ucomp_bf16_fwd_kernel(const float* __restrict__ u1t, const float* __restrict__ br,
                      const float* __restrict__ bi, float* __restrict__ mt_r,
                      float* __restrict__ mt_i, float* scratch, int nb, int ld,
                      int last, float hs) {
  constexpr int D = 1 << N;
  const int dp = bf_dp(N), pitch = bf_pitch(N), pl = dp * pitch;
  extern __shared__ __align__(16) float smem[];
  float* base = scratch == nullptr
                    ? smem
                    : scratch + static_cast<size_t>(blockIdx.x) * bf_planes(ld, false) * pl;
  Cplx acc{base, base + pl}, sub{base + 2 * pl, base + 3 * pl},
      nxt{base + 4 * pl, base + 5 * pl};
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    for (int dd = 0; dd < ld; ++dd) {
      const size_t s = static_cast<size_t>(blk) * ld + dd;
      bf_sublayer(u1t, br, bi, s, dd == 0 ? acc : sub, D, dp, pitch, hs);
      if (dd > 0) {
        bf_kara(acc, sub, nxt, D, dp, pitch, hs);
        const Cplx t = acc;
        acc = nxt;
        nxt = t;
      }
    }
    const size_t o = static_cast<size_t>(blk) * D * D;
    bf_hxr(acc.r, acc.i, pitch, sub, right_h(blk, last), Dst{mt_r + o, D, D},
           Dst{mt_i + o, D, D}, D, dp, pitch, hs);
  }
}

// B4b-bf16.  g_r, g_i (nb, D, D) -> u1bar, bbar_r, bbar_i (nb ld, D, D).
template <int N>
__global__ void __launch_bounds__(32 * kBfWarps)
ucomp_bf16_bwd_kernel(const float* __restrict__ u1t, const float* __restrict__ br,
                      const float* __restrict__ bi, const float* __restrict__ g_r,
                      const float* __restrict__ g_i, float* __restrict__ u1bar,
                      float* __restrict__ bbar_r, float* __restrict__ bbar_i,
                      float* scratch, int nb, int ld, int last, float hs) {
  constexpr int D = 1 << N;
  const int dp = bf_dp(N), pitch = bf_pitch(N), pl = dp * pitch;
  extern __shared__ __align__(16) float smem[];
  float* base = scratch == nullptr
                    ? smem
                    : scratch + static_cast<size_t>(blockIdx.x) * bf_planes(ld, true) * pl;
  // S_d at 2 d, the prefixes past S_0 at 2 ld + 2 (d - 1), then the rest
  auto sub = [&](int dd) { return Cplx{base + 2 * dd * pl, base + (2 * dd + 1) * pl}; };
  auto pre = [&](int dd) {
    return dd == 0 ? sub(0)
                   : Cplx{base + (2 * ld + 2 * (dd - 1)) * pl,
                          base + (2 * ld + 2 * (dd - 1) + 1) * pl};
  };
  float* rest = base + (2 * ld + 2 * (ld > 2 ? ld - 2 : 0)) * pl;
  Cplx abar{rest, rest + pl}, nbar{rest + 2 * pl, rest + 3 * pl},
      sbar{rest + 4 * pl, rest + 5 * pl};
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    const size_t s0 = static_cast<size_t>(blk) * ld;
    for (int dd = 0; dd < ld; ++dd)
      bf_sublayer(u1t, br, bi, s0 + dd, sub(dd), D, dp, pitch, hs);
    for (int dd = 1; dd < ld - 1; ++dd) bf_kara(pre(dd - 1), sub(dd), pre(dd), D, dp, pitch, hs);
    const size_t o = static_cast<size_t>(blk) * D * D;
    bf_hxr(g_r + o, g_i + o, D, sbar, right_h(blk, last), plane(abar.r, pitch, dp),
           plane(abar.i, pitch, dp), D, dp, pitch, hs);
    for (int dd = ld - 1; dd >= 0; --dd) {
      Cplx sb = abar;
      if (dd > 0) {
        const Cplx p = pre(dd - 1), sd = sub(dd);
        const Term sbt[4] = {{mem(p.r, pitch, true), mem(abar.r, pitch), 0},
                             {mem(p.i, pitch, true), mem(abar.i, pitch), 0},
                             {mem(p.r, pitch, true), mem(abar.i, pitch), 1},
                             {mem(p.i, pitch, true, true), mem(abar.r, pitch), 1}};
        bf_gemm<4, false>(sbt, plane(sbar.r, pitch, dp), plane(sbar.i, pitch, dp), D,
                          dp, hs);
        const Term nbt[4] = {{mem(abar.r, pitch), mem(sd.r, pitch, true), 0},
                             {mem(abar.i, pitch), mem(sd.i, pitch, true), 0},
                             {mem(abar.i, pitch), mem(sd.r, pitch, true), 1},
                             {mem(abar.r, pitch, false, true), mem(sd.i, pitch, true), 1}};
        bf_gemm<4, false>(nbt, plane(nbar.r, pitch, dp), plane(nbar.i, pitch, dp), D,
                          dp, hs);
        __syncthreads();
        sb = sbar;
      }
      const size_t so = (s0 + dd) * D * D;
      const Term ut[2] = {{mem(sb.r, pitch), mem(br + so, D, true), 0},
                          {mem(sb.i, pitch), mem(bi + so, D, true), 0}};
      bf_gemm<2, false>(ut, Dst{u1bar + so, D, D}, Dst{nullptr, 0, 0}, D, dp, hs);
      const Term bt[2] = {{mem(u1t + so, D, true), mem(sb.r, pitch), 0},
                          {mem(u1t + so, D, true), mem(sb.i, pitch), 1}};
      bf_gemm<2, false>(bt, Dst{bbar_r + so, D, D}, Dst{bbar_i + so, D, D}, D, dp, hs);
      __syncthreads();
      if (dd > 0) {
        const Cplx t = abar;
        abar = nbar;
        nbar = t;
      }
    }
  }
}

bool bad_shape(int n, int nb, int ld, int last, int warps, int ctas,
               bool backward) {
  return n < 1 || n > kMaxQubits || nb < 1 || nb > 65535 || ld < 1 ||
         last < kEveryBlock || last >= nb || warps < 1 ||
         warps > kMaxWarps ||
         ctas < 1 || ctas > 65535 ||
         sizeof(float) * static_cast<size_t>(
             smem_floats(n, ld, warps, backward)) > kMaxSmem;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

float scale_of(int n) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(1 << n)));
}

template <int N>
int bf16_forward_n(const float* u1t, const float* br, const float* bi, float* mt_r,
                   float* mt_i, float* scratch, int nb, int ld, int last, int ctas,
                   cudaStream_t s) {
  const size_t smem = scratch == nullptr ? bf_bytes(N, ld, false) : 0;
  cudaError_t err = allow_smem(ucomp_bf16_fwd_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ucomp_bf16_fwd_kernel<N><<<ctas, 32 * kBfWarps, smem, s>>>(
      u1t, br, bi, mt_r, mt_i, scratch, nb, ld, last, scale_of(N));
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int bf16_backward_n(const float* u1t, const float* br, const float* bi,
                    const float* g_r, const float* g_i, float* u1bar, float* bbar_r,
                    float* bbar_i, float* scratch, int nb, int ld, int last, int ctas,
                    cudaStream_t s) {
  const size_t smem = scratch == nullptr ? bf_bytes(N, ld, true) : 0;
  cudaError_t err = allow_smem(ucomp_bf16_bwd_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ucomp_bf16_bwd_kernel<N><<<ctas, 32 * kBfWarps, smem, s>>>(
      u1t, br, bi, g_r, g_i, u1bar, bbar_r, bbar_i, scratch, nb, ld, last,
      scale_of(N));
  return static_cast<int>(cudaGetLastError());
}

bool bf_bad_shape(int n, int nb, int ld, int last, int ctas, bool backward,
                  const float* scratch) {
  return n < 1 || n > kMaxQubits || nb < 1 || ld < 1 || last < kEveryBlock ||
         last >= nb || ctas < 1 || ctas > 65535 ||
         (scratch == nullptr && bf_bytes(n, ld, backward) > kMaxSmem);
}

template <int N>
int forward_n(const float* w, float* mt_r, float* mt_i, int nb, int ld,
              int last, int warps, int ctas, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(N, ld, warps, false);
  cudaError_t err = allow_smem(ucomp_fwd_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(nb));
  const dim3 block(static_cast<unsigned>(32 * warps));
  ucomp_fwd_kernel<N><<<grid, block, smem, s>>>(w, mt_r, mt_i, ld, last,
                                                scale_of(N));
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int backward_n(const float* w, const float* g_r, const float* g_i,
               float* part, float* wbar, int nb, int ld, int last, int warps,
               int ctas, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(N, ld, warps, true);
  cudaError_t err = allow_smem(ucomp_bwd_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(nb));
  const dim3 block(static_cast<unsigned>(32 * warps));
  ucomp_bwd_kernel<N><<<grid, block, smem, s>>>(w, g_r, g_i, part, wbar, ld,
                                                last, scale_of(N));
  err = cudaGetLastError();
  if (err != cudaSuccess || ctas == 1) return static_cast<int>(err);
  const dim3 sgrid(static_cast<unsigned>(nb));
  const dim3 sblock(128);
  ucomp_bwd_sum_kernel<<<sgrid, sblock, 0, s>>>(part, wbar, ld * 3 * N, ctas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_ucomp.py).  Each takes device pointers
// of contiguous fp32 tensors and the stream to launch on, and returns the
// cudaError_t of its launches (0 on success).  n = 1 .. 7 qubits, w
// (nb*ld, 3, n), last the block whose right factor is I (-1: none, -2:
// every block), warps
// (1 .. 16) the warps of a CTA, ctas the CTAs of a block.

// Row groups of a block at n qubits: the rows a warp carries at once are
// min(32 / D, D) below D = 32, one from there.
extern "C" int ucomp_row_groups(int n) {
  return n < 1 || n > kMaxQubits ? 0 : row_groups(n);
}

// B4f.  w -> mt_r, mt_i (nb, D, D).
extern "C" int ucomp_forward(const float* w, float* mt_r, float* mt_i, int n,
                             int nb, int ld, int last, int warps, int ctas,
                             void* stream) {
  if (bad_shape(n, nb, ld, last, warps, ctas, false))
    return static_cast<int>(cudaErrorInvalidValue);
  using Forward = int (*)(const float*, float*, float*, int, int, int, int,
                         int, cudaStream_t);
  constexpr Forward kForward[] = {forward_n<1>, forward_n<2>, forward_n<3>,
                                  forward_n<4>, forward_n<5>, forward_n<6>,
                                  forward_n<7>};
  return kForward[n - 1](w, mt_r, mt_i, nb, ld, last, warps, ctas,
                         static_cast<cudaStream_t>(stream));
}

// B4b.  g_r, g_i (nb, D, D): the cotangent of mt.  part (nb, ctas, ld*3*n):
// scratch, read only with ctas > 1 (may be null otherwise).  Writes wbar
// (nb*ld, 3, n).
extern "C" int ucomp_backward(const float* w, const float* g_r,
                              const float* g_i, float* part, float* wbar,
                              int n, int nb, int ld, int last, int warps,
                              int ctas, void* stream) {
  if (bad_shape(n, nb, ld, last, warps, ctas, true) ||
      (ctas > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using Backward = int (*)(const float*, const float*, const float*, float*,
                          float*, int, int, int, int, int, cudaStream_t);
  constexpr Backward kBackward[] = {backward_n<1>, backward_n<2>,
                                    backward_n<3>, backward_n<4>,
                                    backward_n<5>, backward_n<6>,
                                    backward_n<7>};
  return kBackward[n - 1](w, g_r, g_i, part, wbar, nb, ld, last, warps, ctas,
                          static_cast<cudaStream_t>(stream));
}

// The bf16 operand mode (UCOMP_BF16), on the operands of
// cuda_ucomp.compile_operands: u1t, br, bi (nb*ld, D, D).  ctas CTAs walk
// the blocks; scratch, when not null, holds their planes in device memory
// (ctas * ucomp_bf16_bytes(n, ld, backward) bytes), else they must fit in
// shared memory.

// Bytes of a CTA's planes.
extern "C" long long ucomp_bf16_bytes(int n, int ld, int backward) {
  return n < 1 || n > kMaxQubits || ld < 1
             ? 0
             : static_cast<long long>(bf_bytes(n, ld, backward != 0));
}

// B4f-bf16.  -> mt_r, mt_i (nb, D, D).
extern "C" int ucomp_bf16_forward(const float* u1t, const float* br,
                                  const float* bi, float* mt_r, float* mt_i,
                                  float* scratch, int n, int nb, int ld,
                                  int last, int ctas, void* stream) {
  if (bf_bad_shape(n, nb, ld, last, ctas, false, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  using Forward = int (*)(const float*, const float*, const float*, float*, float*,
                          float*, int, int, int, int, cudaStream_t);
  constexpr Forward kForward[] = {bf16_forward_n<1>, bf16_forward_n<2>,
                                  bf16_forward_n<3>, bf16_forward_n<4>,
                                  bf16_forward_n<5>, bf16_forward_n<6>,
                                  bf16_forward_n<7>};
  return kForward[n - 1](u1t, br, bi, mt_r, mt_i, scratch, nb, ld, last, ctas,
                         static_cast<cudaStream_t>(stream));
}

// B4b-bf16.  g_r, g_i (nb, D, D): the cotangent of mt -> u1bar, bbar_r,
// bbar_i (nb*ld, D, D), the operands' cotangents.
extern "C" int ucomp_bf16_backward(const float* u1t, const float* br,
                                   const float* bi, const float* g_r,
                                   const float* g_i, float* u1bar,
                                   float* bbar_r, float* bbar_i, float* scratch,
                                   int n, int nb, int ld, int last, int ctas,
                                   void* stream) {
  if (bf_bad_shape(n, nb, ld, last, ctas, true, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  using Backward = int (*)(const float*, const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*, int, int,
                           int, int, cudaStream_t);
  constexpr Backward kBackward[] = {bf16_backward_n<1>, bf16_backward_n<2>,
                                    bf16_backward_n<3>, bf16_backward_n<4>,
                                    bf16_backward_n<5>, bf16_backward_n<6>,
                                    bf16_backward_n<7>};
  return kBackward[n - 1](u1t, br, bi, g_r, g_i, u1bar, bbar_r, bbar_i, scratch,
                          nb, ld, last, ctas, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ucomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
