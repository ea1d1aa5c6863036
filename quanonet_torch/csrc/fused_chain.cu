// Fused-group chain of the HEA circuit for 8..16 qubits, forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_fused.py, joined
// there as the custom VJP of _make_chain:
//
//   B2f  _fwd_kernel (primal output, and the block-input-saving variant)
//
//     s = |0...0>;  for each block b:
//         s <- H^{(x)n} s;   s <- exp(-i phi_b) (.) s
//         linear_depth 0:  s <- H^{(x)n} s
//         else, per sublayer t:  s <- s . U7t_t  on the low 7 qubits (each
//             row's state as a (hi, 128) complex matrix, hi = 2^(n-7));
//             the 2x2 u_{t,j} on each high qubit 7 + j (a butterfly);
//             the CNOT ring, the gather out[k] = s[inv(k)]
//
//   Inputs: u7t_r, u7t_i (S, 128, 128), the low-group unitaries transposed
//   (the encode Hadamard folded into each block's first sublayer); u2_r,
//   u2_i (S, n-7, 4), the high qubits' 2x2 entries [u00, u01, u10, u11]
//   (their tensor product is the dense high-group unitary: the JAX kernel's
//   butterfly mode, here at every n); phi (nb, N, 2^n) raw phases; sub_off
//   (nb + 1) int32, block b's sublayers are [sub_off[b], sub_off[b+1]);
//   ring_inv, ring_perm (2^n) int32, the ring's inverse and forward maps.
//   Outputs: out_r, out_i (N, 2^n); with residuals each block's input state
//   st_r, st_i (nb, N, 2^n).
//
//   B2b  _bwd_kernel, here as three or four launches:
//
//     fused_chain_bwd_kernel   per block, in reverse: recompute the block
//         from its saved input state (writing each sublayer's pre-low state
//         to PRE), then walk back: ct <- ring^T ct (the gather by the ring's
//         forward map); per high qubit, in reverse, the 2x2's cotangent
//         ubar[2a+b] += ct_a . conj(t_b) with t the butterfly's input, and
//         ct <- u^H ct; ct written to CT; ct <- ct . conj(U7t)^T; at the
//         block's start phibar from ct and H s_in, ct <- conj(D) ct, and
//         ct <- H ct (H is self-adjoint).  The butterfly inputs are not
//         stored: the state after all butterflies of sublayer t is the ring's
//         input, ring^T of the next sublayer's pre-low state (or of the
//         block output), and each u is unitary, so t_j = u_j^H t_{j+1} is
//         walked back beside ct.
//     fused_u7bar_kernel       U7bar_t = conj(PRE_t)^T . CT_t, the batch sum,
//         as a GEMM over the N*hi rows of 128 lanes: one CTA per (sublayer,
//         64x64 output tile, slice of rows), row chunks of 16 staged in
//         shared memory, a fixed summation order
//     fused_sum_splits_kernel  the slices summed in slice order
//     fused_u2bar_kernel       the per-CTA partial sums of u2bar (each a
//         fixed-order CTA reduction) summed in CTA order
//
//   No atomics: two calls on equal inputs give equal bits.
//   Plain versions: quanonet_torch/ops/fused_gates.py chain_fused (primal),
//   chain_fused_saved (residuals), chain_fused_backward (backward).
//
// What bounds them.  The low-group products are the work: per sublayer
// N*hi*128*128 complex MACs (forward one, backward three: recompute,
// ct . conj(U7t)^T and the U7bar GEMM), 6 flops each in the three-product
// count of the TPU kernel.  At Q10 Net40-2-20-2, N = 100 that is 9.4 GFLOP
// for the forward, 0.14 ms at the fp32 peak; the bytes (phi 24.6 MB, the
// states 49 MB) are an order of magnitude less, and every CTA re-reads each
// sublayer's U7t (128 KB) from L2.  So operations bound the forward, and
// the L2 traffic of U7t is close behind when a CTA owns few rows.
//
// Design.  One CTA owns R whole rows (R*hi = M "tile rows" of 128 lanes,
// M >= 8) for the whole chain, so the ring and the butterflies, which mix a
// row's amplitudes across the lanes and the high bits, never leave the CTA.
// A group of 128 threads owns the 128 output lanes of a product; each
// thread computes 8 tile rows of one lane (4 when the CTA has at most 16,
// for more warps), reading the state as broadcast float4, with fp32 FMAs
// in four independent chains and no TF32 (the JAX kernel's exact-f32
// default).  U7t streams through shared memory in chunks of 32 k (two 36 KB
// slots, cp.async), the next chunk in flight while the current one is
// used, and the next sublayer's first chunk issued while the butterflies,
// the ring and the Hadamard run: read straight from L2 by each thread, too
// few of its bytes were in flight (~4 KB an SM) to cover the latency.  Up
// to 13 qubits (forward, 2 buffers of re and im, M * 2 KB) and 12
// (backward, 3 buffers, M * 3 KB) the rows live in shared memory beside the
// slots (M <= 64: at most 200 KB); above, one row is 64 KB or more a
// buffer, so the same code runs on a per-CTA scratch in device memory
// (R = 1, L2 resident at the few rows these widths run).  The wrapper
// (ops/cuda_fused.py) picks the side by passing that scratch or not.  The Hadamard is
// n add/sub butterfly stages and one 2^(-n/2) scale, the ring a gather
// through a 2^n index table, the phase exp(-i phi) taken with the accurate
// sincosf.  With a row or two a CTA there is one warp a scheduler, so the
// elementwise passes keep 4 elements a thread in flight.  Rows past N carry
// zeros and are never read or written.  n, N and R are runtime arguments:
// one instance per variant.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kLanes = 128;          // 2^7, the low group
constexpr int kLaneQubits = 7;
constexpr int kRowsPerThread = 8;    // tile rows per thread in a product
constexpr int kMaxThreads = 512;
constexpr size_t kSmemBytes = 232448;   // shared memory a block can use
constexpr size_t kStaticSmem = 1024;    // the backward's reduction scratch
constexpr int kChunk = 32;           // rows of k per staged chunk of U7t
constexpr int kChunks = kLanes / kChunk;
constexpr int kAdjPitch = kChunk + 4;   // padded row of a transposed chunk
constexpr int kSlotHalf = kLanes * kAdjPitch;   // floats of re (or im)
constexpr int kSlotFloats = 2 * kSlotHalf;      // one staging slot
constexpr int kGemmThreads = 256;
constexpr int kGemmTile = 64;
constexpr int kGemmChunk = 16;

struct Buf {
  float* re;
  float* im;
};

constexpr int kBatch = 4;   // elements a thread has in flight in a pass

// pair p of a stage on bit q over R rows of 2^n -> element index with bit
// q clear (the partner is + 2^q)
__device__ __forceinline__ int pair_index(int p, int q, int n) {
  const int r = p >> (n - 1);
  const int w = p & ((1 << (n - 1)) - 1);
  const int k0 = ((w >> q) << (q + 1)) | (w & ((1 << q) - 1));
  return (r << n) + k0;
}

// The elementwise passes below take kBatch elements (or pairs) a thread at
// a time, all loads first: one warp a scheduler is common (a row per CTA),
// so latency, not bandwidth, is what they must hide.

// H^{(x)n} in place on R rows: n add/sub stages, the last scaled
__device__ void hadamard(Buf b, int n, int R, float scale) {
  const int pairs = R << (n - 1);
  for (int q = 0; q < n; ++q) {
    const float s = (q == n - 1) ? scale : 1.f;
    for (int p0 = threadIdx.x; p0 < pairs; p0 += kBatch * blockDim.x) {
      int i0[kBatch];
      float ar[kBatch], br[kBatch], ai[kBatch], bi[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * blockDim.x;
        i0[u] = p < pairs ? pair_index(p, q, n) : -1;
        if (i0[u] >= 0) {
          ar[u] = b.re[i0[u]];
          br[u] = b.re[i0[u] + (1 << q)];
          ai[u] = b.im[i0[u]];
          bi[u] = b.im[i0[u] + (1 << q)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0[u] < 0) continue;
        b.re[i0[u]] = (ar[u] + br[u]) * s;
        b.re[i0[u] + (1 << q)] = (ar[u] - br[u]) * s;
        b.im[i0[u]] = (ai[u] + bi[u]) * s;
        b.im[i0[u] + (1 << q)] = (ai[u] - bi[u]) * s;
      }
    }
    __syncthreads();
  }
}

// state <- exp(-i phi) (.) state for the valid rows
__device__ void phase(Buf b, const float* __restrict__ phi_b, long long row0,
                      int n_rows, int n, int R) {
  const int count = R << n;
  const int valid = static_cast<int>(min(static_cast<long long>(R), n_rows - row0)) << n;
  for (int t0 = threadIdx.x; t0 < count; t0 += kBatch * blockDim.x) {
    float ph[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      ph[u] = t < valid ? phi_b[(row0 << n) + t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t >= valid) continue;
      float sn, cs;
      sincosf(ph[u], &sn, &cs);
      const float xr = b.re[t], xi = b.im[t];
      b.re[t] = cs * xr + sn * xi;
      b.im[t] = cs * xi - sn * xr;
    }
  }
  __syncthreads();
}

// dst (R rows) <- src rows of a (rows, 2^n) array in device memory; zeros
// past n_rows
__device__ void load_rows(Buf dst, const float* src_r, const float* src_i,
                          long long row0, int n_rows, int n, int R) {
  const int count = R << n;
  const int valid = static_cast<int>(min(static_cast<long long>(R), n_rows - row0)) << n;
  const size_t g0 = static_cast<size_t>(row0) << n;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const bool ok = t < valid;
    dst.re[t] = ok ? src_r[g0 + t] : 0.f;
    dst.im[t] = ok ? src_i[g0 + t] : 0.f;
  }
  __syncthreads();
}

// dst rows of a (rows, 2^n) array <- src (R rows), valid rows only; no
// barrier (src is only read)
__device__ void store_rows(float* dst_r, float* dst_i, Buf src,
                           long long row0, int n_rows, int n, int R) {
  const int valid = static_cast<int>(min(static_cast<long long>(R), n_rows - row0)) << n;
  const size_t g0 = static_cast<size_t>(row0) << n;
  for (int t = threadIdx.x; t < valid; t += blockDim.x) {
    dst_r[g0 + t] = src.re[t];
    dst_i[g0 + t] = src.im[t];
  }
}

// dst[r, k] = src[r, idx[k]] (idx: the ring's inverse map, or its forward
// map for ring^T, a 2^n table); elements t >= valid (rows of src past the
// batch) read as zeros
__device__ void ring_gather(Buf dst, const float* src_r, const float* src_i,
                            const int* __restrict__ idx, int n, int R,
                            int valid) {
  const int count = R << n;
  for (int t0 = threadIdx.x; t0 < count; t0 += kBatch * blockDim.x) {
    float vr[kBatch], vi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      vr[u] = vi[u] = 0.f;
      if (t < valid) {
        const int k = t & ((1 << n) - 1);
        const int g = (t - k) + __ldg(idx + k);
        vr[u] = src_r[g];
        vi[u] = src_i[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < count) {
        dst.re[t] = vr[u];
        dst.im[t] = vi[u];
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copy of chunk c of T into a staging slot (no commit): ADJ
// false, rows c*32.. of u7t as they are ([k][j], 32 x 128); ADJ true,
// columns c*32.. of every row j ([j][k], 128 rows of pitch kAdjPitch, so
// that a thread's float4 reads along k meet no bank conflict).
template <bool ADJ>
__device__ void stage_chunk(float* slot, const float* __restrict__ t_r,
                            const float* __restrict__ t_i, int c) {
  constexpr int kVec = kChunk * kLanes / 4;     // float4 per component
  for (int v = threadIdx.x; v < kVec; v += blockDim.x) {
    int dst, src;
    if constexpr (ADJ) {
      const int j = v / (kChunk / 4), q = v % (kChunk / 4);
      dst = j * kAdjPitch + 4 * q;
      src = j * kLanes + c * kChunk + 4 * q;
    } else {
      dst = 4 * v;
      src = c * kChunk * kLanes + 4 * v;
    }
    cp_async16(slot + dst, t_r + src);
    cp_async16(slot + kSlotHalf + dst, t_i + src);
  }
}

// The low-group product on M tile rows of 128 lanes, y = x . T with
// T = u7t (ADJ false) or T = conj(u7t)^T (ADJ true).  T streams through two
// staging slots in chunks of 32 k, the copy of the next chunk in flight
// while the current one is used; each group of 128 threads takes its 8
// tile rows at a time (re-staging T for each further 8).  prefetched: the
// previous call already issued chunk 0 of this T into slot 0; next (when
// not null): issue chunk 0 of the next call's T on the way out.
template <bool ADJ, int P>
__device__ void low_product(const float* x_r, const float* x_i, Buf y,
                            const float* __restrict__ t_r,
                            const float* __restrict__ t_i, int M,
                            float* stage, bool prefetched,
                            const float* next_r, const float* next_i) {
  const int j = threadIdx.x & (kLanes - 1);
  const int groups = blockDim.x / kLanes;
  const int steps = M / (P * groups) * kChunks;
  if (!prefetched) {
    stage_chunk<ADJ>(stage, t_r, t_i, 0);
    cp_async_commit();
  }
  // re = sum xr ur - sum xi ui, im = sum xr ui + sum xi ur: four
  // independent chains a row
  float rr[P], ii[P], ri[P], ir[P];
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps)
      stage_chunk<ADJ>(stage + ((i + 1) & 1) * kSlotFloats, t_r, t_i,
                       (i + 1) % kChunks);
    cp_async_commit();
    cp_async_wait_all_but_one();          // chunk i has landed
    __syncthreads();
    const int c = i % kChunks;
    const int m0 = ((i / kChunks) * groups + threadIdx.x / kLanes) * P;
    const float* s_r = stage + (i & 1) * kSlotFloats;
    const float* s_i = s_r + kSlotHalf;
    if (c == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) rr[p] = ii[p] = ri[p] = ir[p] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 4) {
      float ur[4], ui[4];
      if constexpr (ADJ) {
        const float4 a = *reinterpret_cast<const float4*>(s_r + j * kAdjPitch + kk);
        const float4 b = *reinterpret_cast<const float4*>(s_i + j * kAdjPitch + kk);
        ur[0] = a.x; ur[1] = a.y; ur[2] = a.z; ur[3] = a.w;
        ui[0] = -b.x; ui[1] = -b.y; ui[2] = -b.z; ui[3] = -b.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ur[q] = s_r[(kk + q) * kLanes + j];
          ui[q] = s_i[(kk + q) * kLanes + j];
        }
      }
      const int k = c * kChunk + kk;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 vr = *reinterpret_cast<const float4*>(x_r + (m0 + p) * kLanes + k);
        const float4 vi = *reinterpret_cast<const float4*>(x_i + (m0 + p) * kLanes + k);
        const float xr[4] = {vr.x, vr.y, vr.z, vr.w};
        const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          rr[p] = fmaf(xr[q], ur[q], rr[p]);
          ii[p] = fmaf(xi[q], ui[q], ii[p]);
          ri[p] = fmaf(xr[q], ui[q], ri[p]);
          ir[p] = fmaf(xi[q], ur[q], ir[p]);
        }
      }
    }
    if (c == kChunks - 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        y.re[(m0 + p) * kLanes + j] = rr[p] - ii[p];
        y.im[(m0 + p) * kLanes + j] = ri[p] + ir[p];
      }
    }
    __syncthreads();                      // the slot is free, y is written
  }
  if (next_r != nullptr) {                // steps is even: slot 0 is free
    stage_chunk<ADJ>(stage, next_r, next_i, 0);
    cp_async_commit();
  }
}

// low_product with P = 4 tile rows a thread for M <= 16 (more warps for a
// CTA of one or two rows), else 8
template <bool ADJ>
__device__ __forceinline__ void product(const float* x_r, const float* x_i,
                                        Buf y, const float* t_r,
                                        const float* t_i, int M, float* stage,
                                        bool prefetched, const float* next_r,
                                        const float* next_i) {
  if (M <= 2 * kRowsPerThread)
    low_product<ADJ, kRowsPerThread / 2>(x_r, x_i, y, t_r, t_i, M, stage,
                                         prefetched, next_r, next_i);
  else
    low_product<ADJ, kRowsPerThread>(x_r, x_i, y, t_r, t_i, M, stage,
                                     prefetched, next_r, next_i);
}

// the 2x2 u_{t,j} on each high qubit 7 + j, in place
__device__ void high_butterflies(Buf b, const float* __restrict__ u2r,
                                 const float* __restrict__ u2i, int n, int R) {
  const int pairs = R << (n - 1);
  for (int j = 0; j < n - kLaneQubits; ++j) {
    const int q = kLaneQubits + j;
    float ur[4], ui[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ur[e] = __ldg(u2r + 4 * j + e);
      ui[e] = __ldg(u2i + 4 * j + e);
    }
    for (int p0 = threadIdx.x; p0 < pairs; p0 += kBatch * blockDim.x) {
      int i0[kBatch];
      float ar[kBatch], ai[kBatch], br[kBatch], bi[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * blockDim.x;
        i0[u] = p < pairs ? pair_index(p, q, n) : -1;
        if (i0[u] >= 0) {
          ar[u] = b.re[i0[u]];
          ai[u] = b.im[i0[u]];
          br[u] = b.re[i0[u] + (1 << q)];
          bi[u] = b.im[i0[u] + (1 << q)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0[u] < 0) continue;
        const int i1 = i0[u] + (1 << q);
        b.re[i0[u]] = ur[0] * ar[u] - ui[0] * ai[u] + ur[1] * br[u] - ui[1] * bi[u];
        b.im[i0[u]] = ur[0] * ai[u] + ui[0] * ar[u] + ur[1] * bi[u] + ui[1] * br[u];
        b.re[i1] = ur[2] * ar[u] - ui[2] * ai[u] + ur[3] * br[u] - ui[3] * bi[u];
        b.im[i1] = ur[2] * ai[u] + ui[2] * ar[u] + ur[3] * bi[u] + ui[3] * br[u];
      }
    }
    __syncthreads();
  }
}

// ── B2f: forward, primal output and (SAVE) each block's input state ──────

template <bool SMEM, bool SAVE>
__global__ void __launch_bounds__(kMaxThreads)
fused_chain_fwd_kernel(const float* __restrict__ u7t_r,
                       const float* __restrict__ u7t_i,
                       const float* __restrict__ u2_r,
                       const float* __restrict__ u2_i,
                       const float* __restrict__ phi,
                       const int* __restrict__ sub_off,
                       const int* __restrict__ ring_inv,
                       float* __restrict__ out_r, float* __restrict__ out_i,
                       float* __restrict__ st_r, float* __restrict__ st_i,
                       float* scratch, int nb, int n_rows, int n, int R,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = R << n;                     // floats per buffer component
  const int M = tile / kLanes;
  const int nh = n - kLaneQubits;
  float* base = SMEM ? smem : scratch + static_cast<size_t>(blockIdx.x) * 4 * tile;
  float* stage = SMEM ? smem + 4 * tile : smem;
  const Buf s{base, base + tile}, y{base + 2 * tile, base + 3 * tile};
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n_rows) << n;
  const int n_sub = sub_off[nb];
  const size_t mat = static_cast<size_t>(kLanes) * kLanes;

  for (int t = threadIdx.x; t < tile; t += blockDim.x) {   // |0...0>
    s.re[t] = ((t & ((1 << n) - 1)) == 0 && row0 + (t >> n) < n_rows) ? 1.f : 0.f;
    s.im[t] = 0.f;
  }
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    if constexpr (SAVE) {
      store_rows(st_r + b * nd, st_i + b * nd, s, row0, n_rows, n, R);
      __syncthreads();
    }
    hadamard(s, n, R, scale);
    phase(s, phi + b * nd, row0, n_rows, n, R);
    const int s0 = sub_off[b], s1 = sub_off[b + 1];
    if (s0 == s1) {            // encoding-only block: its left Hadamard
      hadamard(s, n, R, scale);
      continue;
    }
    for (int t = s0; t < s1; ++t) {
      const bool more = t + 1 < n_sub;    // sublayers run in order 0..S-1
      product<false>(s.re, s.im, y, u7t_r + t * mat, u7t_i + t * mat, M, stage,
                     t > 0, more ? u7t_r + (t + 1) * mat : nullptr,
                     more ? u7t_i + (t + 1) * mat : nullptr);
      high_butterflies(y, u2_r + t * nh * 4, u2_i + t * nh * 4, n, R);
      ring_gather(s, y.re, y.im, ring_inv, n, R, tile);
    }
  }
  store_rows(out_r, out_i, s, row0, n_rows, n, R);
}

// ── B2b: the reverse sweep ───────────────────────────────────────────────

// v (8 sums of this thread) -> their sum over the CTA, in a fixed order,
// written by threads 0..7 to dst; red holds 2 x (warps x 8) floats used
// alternately (parity), so one barrier a call suffices
__device__ void cta_sum8(float (&v)[8], float* red, int& parity, float* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
  float* r = red + parity * (kMaxThreads / 32) * 8;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) r[warp * 8 + e] = v[e];
  __syncthreads();
  if (threadIdx.x < 8) {
    float sum = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) sum += r[w * 8 + threadIdx.x];
    dst[threadIdx.x] = sum;
  }
  parity ^= 1;
}

// back through the high butterflies of one sublayer: c holds the cotangent
// at their output, t the state there; per qubit j (in reverse) t <- u^H t
// (the butterfly's input), the CTA's part of u2bar_j, c <- u^H c
__device__ void high_butterflies_back(Buf c, Buf t, const float* __restrict__ u2r,
                                      const float* __restrict__ u2i,
                                      float* part, int n, int R, float* red,
                                      int& parity) {
  const int pairs = R << (n - 1);
  for (int j = n - kLaneQubits - 1; j >= 0; --j) {
    const int q = kLaneQubits + j;
    float ur[4], ui[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ur[e] = __ldg(u2r + 4 * j + e);
      ui[e] = __ldg(u2i + 4 * j + e);
    }
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int i0 = pair_index(p, q, n), i1 = i0 + (1 << q);
      // t <- u^H t: t0' = conj(u00) t0 + conj(u10) t1, t1' = conj(u01) t0 + conj(u11) t1
      const float a_r = t.re[i0], a_i = t.im[i0], b_r = t.re[i1], b_i = t.im[i1];
      const float t0r = ur[0] * a_r + ui[0] * a_i + ur[2] * b_r + ui[2] * b_i;
      const float t0i = ur[0] * a_i - ui[0] * a_r + ur[2] * b_i - ui[2] * b_r;
      const float t1r = ur[1] * a_r + ui[1] * a_i + ur[3] * b_r + ui[3] * b_i;
      const float t1i = ur[1] * a_i - ui[1] * a_r + ur[3] * b_i - ui[3] * b_r;
      const float c0r = c.re[i0], c0i = c.im[i0], c1r = c.re[i1], c1i = c.im[i1];
      // u2bar[2a + b] += c_a conj(t_b)
      v[0] += c0r * t0r + c0i * t0i;  v[4] += c0i * t0r - c0r * t0i;
      v[1] += c0r * t1r + c0i * t1i;  v[5] += c0i * t1r - c0r * t1i;
      v[2] += c1r * t0r + c1i * t0i;  v[6] += c1i * t0r - c1r * t0i;
      v[3] += c1r * t1r + c1i * t1i;  v[7] += c1i * t1r - c1r * t1i;
      t.re[i0] = t0r; t.im[i0] = t0i; t.re[i1] = t1r; t.im[i1] = t1i;
      c.re[i0] = ur[0] * c0r + ui[0] * c0i + ur[2] * c1r + ui[2] * c1i;
      c.im[i0] = ur[0] * c0i - ui[0] * c0r + ur[2] * c1i - ui[2] * c1r;
      c.re[i1] = ur[1] * c0r + ui[1] * c0i + ur[3] * c1r + ui[3] * c1i;
      c.im[i1] = ur[1] * c0i - ui[1] * c0r + ur[3] * c1i - ui[3] * c1r;
    }
    cta_sum8(v, red, parity, part + j * 8);
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
fused_chain_bwd_kernel(const float* __restrict__ u7t_r,
                       const float* __restrict__ u7t_i,
                       const float* __restrict__ u2_r,
                       const float* __restrict__ u2_i,
                       const float* __restrict__ phi,
                       const int* __restrict__ sub_off,
                       const int* __restrict__ ring_inv,
                       const int* __restrict__ ring_perm,
                       const float* __restrict__ st_r,
                       const float* __restrict__ st_i,
                       const float* __restrict__ g_r,
                       const float* __restrict__ g_i,
                       float* pre_r, float* pre_i, float* ct_r, float* ct_i,
                       float* __restrict__ u2part, float* __restrict__ phibar,
                       float* scratch, int nb, int n_rows, int n, int R,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * (kMaxThreads / 32) * 8];
  const int tile = R << n;
  const int M = tile / kLanes;
  const int nh = n - kLaneQubits;
  float* base = SMEM ? smem : scratch + static_cast<size_t>(blockIdx.x) * 6 * tile;
  float* stage = SMEM ? smem + 6 * tile : smem;
  const Buf b0{base, base + tile}, b1{base + 2 * tile, base + 3 * tile},
      b2{base + 4 * tile, base + 5 * tile};
  const size_t mat = static_cast<size_t>(kLanes) * kLanes;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n_rows) << n;
  const int valid = static_cast<int>(min(static_cast<long long>(R), n_rows - row0)) << n;
  int parity = 0;

  load_rows(b2, g_r, g_i, row0, n_rows, n, R);         // ct = g
  for (int b = nb - 1; b >= 0; --b) {
    const int s0 = sub_off[b], s1 = sub_off[b + 1];
    if (s0 == s1) {
      hadamard(b2, n, R, scale);        // back through the trailing H
    } else {
      // recompute the block from its input state, saving each pre-low state
      load_rows(b0, st_r + b * nd, st_i + b * nd, row0, n_rows, n, R);
      hadamard(b0, n, R, scale);
      phase(b0, phi + b * nd, row0, n_rows, n, R);
      for (int t = s0; t < s1; ++t) {
        store_rows(pre_r + t * nd, pre_i + t * nd, b0, row0, n_rows, n, R);
        const bool more = t + 1 < s1;
        product<false>(b0.re, b0.im, b1, u7t_r + t * mat, u7t_i + t * mat, M,
                       stage, t > s0, more ? u7t_r + (t + 1) * mat : nullptr,
                       more ? u7t_i + (t + 1) * mat : nullptr);
        high_butterflies(b1, u2_r + t * nh * 4, u2_i + t * nh * 4, n, R);
        ring_gather(b0, b1.re, b1.im, ring_inv, n, R, tile);
      }
      // b0 holds the block output; walk back through the sublayers
      for (int t = s1 - 1; t >= s0; --t) {
        ring_gather(b1, b2.re, b2.im, ring_perm, n, R, tile);  // ct, ring^T
        if (t == s1 - 1) {                 // the ring's input: ring^T of ...
          ring_gather(b2, b0.re, b0.im, ring_perm, n, R, tile);  // the output
        } else {                           // ... or of the next pre-low state,
          const size_t at = (t + 1) * nd + (static_cast<size_t>(row0) << n);
          ring_gather(b2, pre_r + at, pre_i + at, ring_perm, n, R, valid);
        }                                  // stored for the valid rows only
        high_butterflies_back(b1, b2, u2_r + t * nh * 4, u2_i + t * nh * 4,
                              u2part + (static_cast<size_t>(t) * gridDim.x + blockIdx.x) * nh * 8,
                              n, R, red, parity);
        store_rows(ct_r + t * nd, ct_i + t * nd, b1, row0, n_rows, n, R);
        const bool more = t > s0;
        product<true>(b1.re, b1.im, b2, u7t_r + t * mat, u7t_i + t * mat, M,
                      stage, t < s1 - 1, more ? u7t_r + (t - 1) * mat : nullptr,
                      more ? u7t_i + (t - 1) * mat : nullptr);
      }
    }
    // the phase's cotangent with a = H s_in, then ct <- H conj(D) ct
    load_rows(b0, st_r + b * nd, st_i + b * nd, row0, n_rows, n, R);
    hadamard(b0, n, R, scale);
    const float* ph = phi + b * nd;
    for (int e = threadIdx.x; e < valid; e += blockDim.x) {
      const size_t g = (static_cast<size_t>(row0) << n) + e;
      float sn, cs;
      sincosf(ph[g], &sn, &cs);
      const float pr = cs, pi = -sn;                  // D = pr + i pi
      const float ar = b0.re[e], ai = b0.im[e];
      const float cr = b2.re[e], ci = b2.im[e];
      const float dr = ar * cr + ai * ci;
      const float di = -ai * cr + ar * ci;
      phibar[b * nd + g] = dr * pi - di * pr;
      b2.re[e] = pr * cr + pi * ci;
      b2.im[e] = -pi * cr + pr * ci;
    }
    __syncthreads();
    hadamard(b2, n, R, scale);
  }
}

// U7bar_t[m][j] = sum over rows q of conj(PRE_t[q][m]) CT_t[q][j], the
// rows q of one slice, 16 at a time through shared memory
__global__ void __launch_bounds__(kGemmThreads)
fused_u7bar_kernel(const float* __restrict__ pre_r,
                   const float* __restrict__ pre_i,
                   const float* __restrict__ ct_r,
                   const float* __restrict__ ct_i, float* __restrict__ out_r,
                   float* __restrict__ out_i, int n_sub, long long rows,
                   long long rows_per_split) {
  __shared__ __align__(16) float a_r[kGemmChunk][kGemmTile];
  __shared__ __align__(16) float a_i[kGemmChunk][kGemmTile];
  __shared__ __align__(16) float b_r[kGemmChunk][kGemmTile];
  __shared__ __align__(16) float b_i[kGemmChunk][kGemmTile];
  const int t = blockIdx.x / 4, tile = blockIdx.x % 4;
  const int m0 = (tile / 2) * kGemmTile, j0 = (tile % 2) * kGemmTile;
  const long long q_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long q_end = q_begin + rows_per_split < rows ? q_begin + rows_per_split : rows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lr = threadIdx.x >> 4, lc = (threadIdx.x & 15) * 4;
  const size_t sub = static_cast<size_t>(t) * rows * kLanes;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_r[a][c] = acc_i[a][c] = 0.f;

  for (long long q0 = q_begin; q0 < q_end; q0 += kGemmChunk) {
    const long long q = q0 + lr;
    float4 pr4 = make_float4(0.f, 0.f, 0.f, 0.f), pi4 = pr4, cr4 = pr4, ci4 = pr4;
    if (q < q_end) {
      const size_t row = sub + static_cast<size_t>(q) * kLanes;
      pr4 = *reinterpret_cast<const float4*>(pre_r + row + m0 + lc);
      pi4 = *reinterpret_cast<const float4*>(pre_i + row + m0 + lc);
      cr4 = *reinterpret_cast<const float4*>(ct_r + row + j0 + lc);
      ci4 = *reinterpret_cast<const float4*>(ct_i + row + j0 + lc);
    }
    *reinterpret_cast<float4*>(&a_r[lr][lc]) = pr4;
    *reinterpret_cast<float4*>(&a_i[lr][lc]) = pi4;
    *reinterpret_cast<float4*>(&b_r[lr][lc]) = cr4;
    *reinterpret_cast<float4*>(&b_i[lr][lc]) = ci4;
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kGemmChunk; ++kk) {
      float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        xr[a] = a_r[kk][ty + 16 * a];
        xi[a] = a_i[kk][ty + 16 * a];
        yr[a] = b_r[kk][tx + 16 * a];
        yi[a] = b_i[kk][tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // conj(x) y
          acc_r[a][c] = fmaf(xr[a], yr[c], fmaf(xi[a], yi[c], acc_r[a][c]));
          acc_i[a][c] = fmaf(xr[a], yi[c], fmaf(-xi[a], yr[c], acc_i[a][c]));
        }
    }
    __syncthreads();
  }
  const size_t out0 = (static_cast<size_t>(blockIdx.y) * n_sub + t) * kLanes * kLanes;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t o = out0 + static_cast<size_t>(m0 + ty + 16 * a) * kLanes + j0 + tx + 16 * c;
      out_r[o] = acc_r[a][c];
      out_i[o] = acc_i[a][c];
    }
}

// out[i] = sum over splits s, in order, of part[s][i]
__global__ void __launch_bounds__(kGemmThreads)
fused_sum_splits_kernel(const float* __restrict__ part_r,
                        const float* __restrict__ part_i,
                        float* __restrict__ out_r, float* __restrict__ out_i,
                        int splits, size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kGemmThreads + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * kGemmThreads) {
    float sr = 0.f, si = 0.f;
    for (int s = 0; s < splits; ++s) {
      sr += part_r[s * count + i];
      si += part_i[s * count + i];
    }
    out_r[i] = sr;
    out_i[i] = si;
  }
}

// u2bar[t][j][e] = sum over CTAs c, in order, of part[t][c][j][e] (real
// e < 4, imaginary 4 + e)
__global__ void __launch_bounds__(kGemmThreads)
fused_u2bar_kernel(const float* __restrict__ part, float* __restrict__ out_r,
                   float* __restrict__ out_i, int n_sub, int ctas, int nh) {
  const int count = n_sub * nh * 8;
  for (int i = blockIdx.x * kGemmThreads + threadIdx.x; i < count;
       i += gridDim.x * kGemmThreads) {
    const int e = i % 8, j = (i / 8) % nh, t = i / (8 * nh);
    float sum = 0.f;
    for (int c = 0; c < ctas; ++c)
      sum += part[((static_cast<size_t>(t) * ctas + c) * nh + j) * 8 + e];
    const int o = (t * nh + j) * 4 + (e & 3);
    if (e < 4) out_r[o] = sum; else out_i[o] = sum;
  }
}

// 2^(-n/2), the Hadamard's scale, rounded once
float hadamard_scale(int n) { return static_cast<float>(std::pow(2.0, -0.5 * n)); }

struct Geometry {
  int M, threads, grid;
  bool smem;      // the rows in shared memory (else in device memory)
  size_t bytes;   // dynamic shared memory: the rows' buffers, 2 slots of U7t
};

// rows_per_cta * 2^(n-7) tile rows, a multiple of 8; 128 threads per 4
// (up to 16) or 8 tile rows, at most kMaxThreads; buffers: 4 (forward) or
// 6 (backward) tiles of M x 128 floats, in shared memory unless smem is
// false (the caller's scratch in device memory holds them)
bool geometry(int n, int n_rows, int rows_per_cta, int buffers, bool smem,
              Geometry* g) {
  if (n <= kLaneQubits || n > 16 || n_rows < 1 || rows_per_cta < 1) return false;
  g->M = rows_per_cta << (n - kLaneQubits);
  if (g->M % kRowsPerThread) return false;
  // tile rows a thread in the product: see product()
  const int groups = g->M / (g->M <= 2 * kRowsPerThread ? kRowsPerThread / 2
                                                         : kRowsPerThread);
  g->threads = kLanes * (groups < kMaxThreads / kLanes ? groups : kMaxThreads / kLanes);
  g->grid = (n_rows + rows_per_cta - 1) / rows_per_cta;
  g->smem = smem;
  g->bytes = sizeof(float) * ((smem ? static_cast<size_t>(buffers) * g->M * kLanes : 0) +
                              2 * kSlotFloats);
  return g->bytes + kStaticSmem <= kSmemBytes;
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_fused.py).  Each takes device pointers of
// contiguous fp32 (sub_off: int32) tensors and the stream to launch on, and
// returns the cudaError_t of its launches (0 on success).  8 <= n <= 16,
// nb >= 1, n_rows >= 1; rows_per_cta * 2^(n-7) a multiple of 8.  scratch,
// when not null, holds the CTAs' rows in device memory: (grid, 4,
// rows_per_cta * 2^n) floats for the forward, (grid, 6, ...) for the
// backward, grid = ceil(n_rows / rows_per_cta); when null, the rows live in
// shared memory and must fit there beside the staging slots.  u7t must be
// 16-byte aligned.

// B2f.  st_r, st_i (nb, n_rows, 2^n): each block's input state, written
// when not null (the residuals of the backward).
extern "C" int fused_chain_forward(const float* u7t_r, const float* u7t_i,
                                   const float* u2_r, const float* u2_i,
                                   const float* phi, const int* sub_off,
                                   const int* ring_inv, float* out_r,
                                   float* out_i, float* st_r,
                                   float* st_i, float* scratch, int nb,
                                   int n_rows, int n, int rows_per_cta,
                                   void* stream) {
  Geometry g;
  if (nb < 1 || !geometry(n, n_rows, rows_per_cta, 4, scratch == nullptr, &g) ||
      (st_r == nullptr) != (st_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool save = st_r != nullptr;
  const size_t smem = g.bytes;
  const auto kernel = g.smem ? (save ? fused_chain_fwd_kernel<true, true>
                                     : fused_chain_fwd_kernel<true, false>)
                             : (save ? fused_chain_fwd_kernel<false, true>
                                     : fused_chain_fwd_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, g.threads, smem, s>>>(u7t_r, u7t_i, u2_r, u2_i, phi, sub_off,
                                         ring_inv, out_r, out_i, st_r, st_i, scratch, nb,
                                         n_rows, n, rows_per_cta, hadamard_scale(n));
  return cudaGetLastError();
}

// B2b.  g_r, g_i (n_rows, 2^n): the output's cotangent; st_r, st_i the
// forward's residuals.  Scratch: pre_r, pre_i, ct_r, ct_i (n_sub, n_rows,
// 2^n); u2part (n_sub, grid, n-7, 8); u7part_r, u7part_i (splits, n_sub,
// 128, 128), used when splits > 1.  Writes u7bar_r, u7bar_i (n_sub, 128,
// 128), u2bar_r, u2bar_i (n_sub, n-7, 4) and phibar (nb, n_rows, 2^n).
extern "C" int fused_chain_backward(
    const float* u7t_r, const float* u7t_i, const float* u2_r,
    const float* u2_i, const float* phi, const int* sub_off,
    const int* ring_inv, const int* ring_perm, const float* st_r,
    const float* st_i, const float* g_r, const float* g_i, float* pre_r,
    float* pre_i, float* ct_r, float* ct_i, float* u2part, float* u7part_r,
    float* u7part_i, float* scratch, float* u7bar_r, float* u7bar_i,
    float* u2bar_r, float* u2bar_i, float* phibar, int nb, int n_sub,
    int n_rows, int n, int rows_per_cta, int splits, void* stream) {
  Geometry g;
  if (nb < 1 || n_sub < 0 || splits < 1 ||
      !geometry(n, n_rows, rows_per_cta, 6, scratch == nullptr, &g) ||
      (splits > 1 && (u7part_r == nullptr || u7part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = g.bytes;
  const auto kernel = g.smem ? fused_chain_bwd_kernel<true> : fused_chain_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, g.threads, smem, s>>>(u7t_r, u7t_i, u2_r, u2_i, phi, sub_off,
                                         ring_inv, ring_perm, st_r, st_i, g_r, g_i,
                                         pre_r, pre_i, ct_r,
                                         ct_i, u2part, phibar, scratch, nb, n_rows,
                                         n, rows_per_cta, hadamard_scale(n));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_sub == 0) return err;

  const long long rows = static_cast<long long>(n_rows) << (n - kLaneQubits);
  const long long per_split = (rows + splits - 1) / splits;
  const dim3 ggrid(static_cast<unsigned>(n_sub * 4), static_cast<unsigned>(splits));
  fused_u7bar_kernel<<<ggrid, kGemmThreads, 0, s>>>(
      pre_r, pre_i, ct_r, ct_i, splits > 1 ? u7part_r : u7bar_r,
      splits > 1 ? u7part_i : u7bar_i, n_sub, rows, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t count = static_cast<size_t>(n_sub) * kLanes * kLanes;
    const size_t blocks = (count + kGemmThreads - 1) / kGemmThreads;
    fused_sum_splits_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                              kGemmThreads, 0, s>>>(u7part_r, u7part_i, u7bar_r,
                                                    u7bar_i, splits, count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int nh = n - kLaneQubits;
  const int count = n_sub * nh * 8;
  fused_u2bar_kernel<<<(count + kGemmThreads - 1) / kGemmThreads, kGemmThreads, 0, s>>>(
      u2part, u2bar_r, u2bar_i, n_sub, g.grid, nh);
  return cudaGetLastError();
}

extern "C" const char* fused_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
