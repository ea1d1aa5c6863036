// Block chain of the HEA circuit, forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_hea.py, joined there
// as the custom VJP _make_block_chain:
//
//   B1f  _fwd_kernel (primal output, and the residual-saving variant)
//
//     s_1 = D(x_1) / sqrt(D)
//     s   <- D(x_{b+1}) (.) (s . M_b^T)      for b = 0 .. nb-2
//     out =  s . M_{nb-1}^T
//
//   with D(x_b)_k = exp(-i phi_{b,k}), all in split (re, im) fp32.  Inputs:
//   mt_r, mt_i (nb, D, D) = M_b^T; phi (nb, N, D) raw phases.  Outputs:
//   out_r, out_i (N, D); with residuals also each block's input state
//   states_r, states_i (nb, N, D).  The TPU kernel also saves the
//   post-matmul state u_b; here it is recovered in the backward as
//   u_b = conj(D(x_{b+1})) (.) s_{b+1}, since |D| = 1 (rounding of a few
//   ulp; the backward computes sin/cos of phi_{b+1} anyway), which halves
//   the residual bytes.
//
//   The primal forward also takes the angles in place of the phases
//   (ANGLES; no gradient needed): x (N, nb * n), block-major, as the
//   model's encoding leaves it, read in place (4 bytes a row and qubit,
//   against phi's 4 * D / n).  Each thread forms the phases of its
//   amplitudes in registers as quanonet_torch/ops/hea.py encoding_phases
//   does, phi_{b,k} = 1/2 sum_i z_i(k) x_{b,i} with z_i(k) = 1 - 2 bit_i(k),
//   summed in the same order; the products by +-1 and 1/2 are exact, so
//   the output equals the phase route's bit for bit.
//
//   B1b  _bwd_kernel, the reverse sweep, here as two launches (three when
//   the batch is split into slices):
//
//     hea_chain_bwd_kernel   ubar_{nb-1} = g;  for b = nb-1 .. 0:
//                              sbar_b = ubar_b . conj(M_b^T)^T
//                              phibar_b, ubar_{b-1} from sbar_b, s_b, phi_b
//     hea_chain_mbar_kernel  Mbar_b = conj(s_b)^T . ubar_b, summed over
//                            the batch rows of one slice
//     sum_splits_kernel      the slices summed in a fixed order (large N)
//
//   Plain versions: quanonet_torch/ops/hea.py chain_dense (primal),
//   chain_dense_saved (residuals), chain_backward_dense (backward).
//
// What bounds them.  Each pass does nb*N*D^2 complex MACs per product (the
// forward one, the backward two), 6 flops each in the three-product
// (Karatsuba) form of the TPU kernel, against ~4*(nb*N*D*k + 2*nb*D^2)
// bytes with k = 1 (forward) .. 6 (backward: phi, states, ubar written and
// read, phibar): about 1.5*D/k flops per byte.  The H100's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s) is 20 flops per byte, so at the flagship's
// D = 32 the forward is bound by fp32 operations and the backward sits
// near the ridge.  At the training batch N = 100 neither bound is near:
// each pass is nb = 60 dependent block steps, so it is bound by the
// latency of one block step times nb.
//
// Design.  Forward and sweep: one CTA owns a tile of R batch rows for the
// whole chain, so the state (forward) and sbar (backward) never leave the
// SM between blocks.  A thread owns a P x CJ register tile (P rows, CJ
// amplitudes).  The launch geometry (threads, CJ, P, hence R) is one of
// three tiles per width, chosen by the wrapper from N, D and the SM count
// (cuda_hea.chain_geometry; the table is HEA_TILES below): at the training
// batch small row tiles spread the batch over tens of SMs (N = 100, D = 32:
// R = 8, 13 CTAs), at large N a 2 x 4 register tile keeps the product on
// the FMA units rather than on shared-memory loads.  Per block step the
// operands of the next step are asked for before this step's product:
// the next block matrix goes into the second of two shared buffers with
// cp.async (16 B), the phases (forward) or the phases and the saved state
// (sweep) into registers.  At D = 128 one matrix is 128 KB, so there is a
// single buffer: the next matrix is asked for right after the product and
// lands while the phase step runs.  The forward reads M_b^T along its rows
// (a thread's CJ amplitudes are contiguous: float4 loads); the sweep reads
// M_b^T in place, sbar[r, k] = sum_j ubar[r, j] conj(M_b^T[k, j]), along the
// rows k of M_b^T, stored with a row padded by four floats so that lanes on
// consecutive k (a thread's CJ outputs interleaved at stride JT) hit
// distinct banks.  The row tile is read as warp broadcasts, its rows padded
// the same way.  Mbar is a sum over the batch, which the TPU kernel got for
// free by running the whole batch in one program; here the sweep writes
// ubar (nb, N, D) to a scratch buffer, and the Mbar kernel gives each
// (block, output tile, slice of rows) one CTA that stages chunks of s_b and
// ubar_b rows through shared memory (cp.async, double-buffered) and
// accumulates a register tile of outputs over the rows in a fixed order; a
// third kernel adds the slices in slice order only when the batch is split
// (large N).  No atomics: two calls on equal inputs give equal bits.  The
// primal and residual forward share one geometry and one summation order
// for a given (N, D), so their outputs are equal bit for bit.  The phase
// exp(-i phi) is taken with the accurate sincosf: |phi| reaches tens of
// radians, so neither __sincosf nor --use_fast_math is used.  Ragged batch
// tiles are masked: rows >= N carry zeros and are never read or written.
// No tensor cores, no TF32: plain fp32 FMAs.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>

// The launch geometries, X(D, tile, threads, CJ, P), tiles in order of
// growing row tile R = threads / (D / CJ) * P.  quanonet_torch/ops/
// cuda_hea.py holds the same table (its tests read this one).
#define HEA_TILES(X)                                                        \
  X(2, 0, 32, 1, 1) X(2, 1, 128, 1, 2) X(2, 2, 256, 2, 2)                   \
  X(4, 0, 32, 1, 1) X(4, 1, 128, 2, 2) X(4, 2, 256, 4, 2)                   \
  X(8, 0, 64, 1, 1) X(8, 1, 128, 2, 2) X(8, 2, 256, 4, 2)                   \
  X(16, 0, 128, 1, 1) X(16, 1, 256, 2, 2) X(16, 2, 256, 4, 2)               \
  X(32, 0, 256, 1, 1) X(32, 1, 256, 4, 1) X(32, 2, 256, 4, 2)               \
  X(64, 0, 256, 1, 1) X(64, 1, 256, 2, 2) X(64, 2, 256, 4, 2)               \
  X(128, 0, 256, 1, 1) X(128, 1, 256, 2, 2) X(128, 2, 256, 4, 2)

namespace {

template <int D, int NT, int CJ, int P> struct Tile {
  static constexpr int JT = D / CJ;             // threads along amplitudes
  static constexpr int RG = NT / JT;            // row groups per CTA
  static constexpr int R = RG * P;              // batch rows per CTA
  static constexpr int KV = D < 4 ? D : 4;      // k values per row-tile read
  static constexpr int LD = D < 4 ? D : D + 4;  // padded row: tile, sweep's M
  static constexpr int NBUF = D <= 64 ? 2 : 1;  // block-matrix buffers
  static constexpr int MS = D * LD;             // floats of one staged matrix
  static constexpr size_t fwd_smem_bytes =
      sizeof(float) * (2 * R * LD + 2 * NBUF * D * D);
  static constexpr size_t bwd_smem_bytes =
      sizeof(float) * (2 * R * LD + 2 * NBUF * MS);
  static_assert(JT >= 1 && NT % JT == 0, "a tile's threads cover its rows");
};

// ── asynchronous copies and vector accesses ──────────────────────────────

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// CNT consecutive floats at p (aligned to 4 * CNT bytes)
template <int CNT>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[CNT]) {
  if constexpr (CNT == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CNT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < CNT; ++i) v[i] = p[i];
  }
}

template <int CNT>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[CNT]) {
  if constexpr (CNT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CNT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < CNT; ++i) p[i] = v[i];
  }
}

// M_b^T (D, D) row-major from device memory -> shared memory with rows of
// LDS floats, asked for with cp.async in 16-byte pieces (one piece holds
// all of it at D = 2, where LDS = D)
template <int D, int LDS, int NT>
__device__ __forceinline__ void stage_matrix(const float* __restrict__ g_r,
                                             const float* __restrict__ g_i,
                                             float* s_r, float* s_i) {
  for (int t = threadIdx.x; t < D * D / 4; t += NT) {
    const int off = LDS == D ? 4 * t : (4 * t / D) * LDS + (4 * t) % D;
    cp_async<16>(s_r + off, g_r + 4 * t, 16);
    cp_async<16>(s_i + off, g_i + 4 * t, 16);
  }
}

// ── the two products of a block step ─────────────────────────────────────

// acc (P x CJ) = x . M^T for this thread's rows p * RG + rg and amplitudes
// tj * CJ + c: the row tile x (R, LD) and M^T (D, D) in shared memory
template <class T, int D, int CJ, int P>
__device__ __forceinline__ void fwd_product(
    const float* x_r, const float* x_i, const float* m_r, const float* m_i,
    float (&ar)[P][CJ], float (&ai)[P][CJ], int tj, int rg) {
  constexpr int KV = T::KV, LD = T::LD, RG = T::RG;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < CJ; ++c) ar[p][c] = ai[p][c] = 0.f;

#pragma unroll 4
  for (int k = 0; k < D; k += KV) {
    float xr[P][KV], xi[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      load_vec<KV>(x_r + (p * RG + rg) * LD + k, xr[p]);
      load_vec<KV>(x_i + (p * RG + rg) * LD + k, xi[p]);
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      float mr[CJ], mi[CJ];
      load_vec<CJ>(m_r + (k + kk) * D + tj * CJ, mr);
      load_vec<CJ>(m_i + (k + kk) * D + tj * CJ, mi);
#pragma unroll
      for (int c = 0; c < CJ; ++c)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          ar[p][c] = fmaf(xr[p][kk], mr[c], ar[p][c]);
          ar[p][c] = fmaf(-xi[p][kk], mi[c], ar[p][c]);
          ai[p][c] = fmaf(xr[p][kk], mi[c], ai[p][c]);
          ai[p][c] = fmaf(xi[p][kk], mr[c], ai[p][c]);
        }
    }
  }
}

// sb (P x CJ) = ubar . conj(M^T)^T for this thread's rows and outputs
// k = tk + c * JT: sbar[r, k] = sum_j ubar[r, j] conj(M^T[k, j]), the tile
// ubar (R, LD) and M^T (D, LD) in shared memory, both read along j
template <class T, int D, int CJ, int P>
__device__ __forceinline__ void bwd_product(
    const float* u_r, const float* u_i, const float* m_r, const float* m_i,
    float (&sr)[P][CJ], float (&si)[P][CJ], int tk, int rg) {
  constexpr int KV = T::KV, LD = T::LD, RG = T::RG, JT = T::JT;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < CJ; ++c) sr[p][c] = si[p][c] = 0.f;

#pragma unroll 4
  for (int j = 0; j < D; j += KV) {
    float ur[P][KV], ui[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      load_vec<KV>(u_r + (p * RG + rg) * LD + j, ur[p]);
      load_vec<KV>(u_i + (p * RG + rg) * LD + j, ui[p]);
    }
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      float mr[KV], mi[KV];
      load_vec<KV>(m_r + (tk + c * JT) * LD + j, mr);
      load_vec<KV>(m_i + (tk + c * JT) * LD + j, mi);
#pragma unroll
      for (int jj = 0; jj < KV; ++jj)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          // ubar conj(m) = (ur + i ui)(mr - i mi)
          sr[p][c] = fmaf(ur[p][jj], mr[jj], sr[p][c]);
          sr[p][c] = fmaf(ui[p][jj], mi[jj], sr[p][c]);
          si[p][c] = fmaf(ur[p][jj], -mi[jj], si[p][c]);
          si[p][c] = fmaf(ui[p][jj], mr[jj], si[p][c]);
        }
    }
  }
}

// ── the phases from the angles (B1f's ANGLES route) ──────────────────────

// qubits n of a width D = 2^n
__host__ __device__ constexpr int qubits_of(int d) {
  return d > 1 ? 1 + qubits_of(d / 2) : 0;
}

// the NQ angles of block b at one row of x (rows, nb * NQ), read in place
// with scalar loads (a row's angles need no alignment)
template <int NQ>
__device__ __forceinline__ void load_angles(const float* __restrict__ x,
                                            long long row, int b, int nb,
                                            float (&a)[NQ]) {
  const float* p = x + (row * nb + b) * NQ;
#pragma unroll
  for (int i = 0; i < NQ; ++i) a[i] = p[i];
}

// phi_k of this thread's amplitudes k = tj * CJ + c from one row's angles,
// in hea.encoding_phases' order: z_0 x_0, then + z_i x_i for i = 1 .. NQ-1,
// then times 1/2, with z_i = 1 - 2 bit_i(k); every product is exact
template <int NQ, int CJ>
__device__ __forceinline__ void angle_phases(const float (&a)[NQ], int tj,
                                             float (&ph)[CJ]) {
#pragma unroll
  for (int c = 0; c < CJ; ++c) {
    const int k = tj * CJ + c;
    float f = (k & 1 ? -1.f : 1.f) * a[0];
#pragma unroll
    for (int i = 1; i < NQ; ++i) f = f + ((k >> i) & 1 ? -1.f : 1.f) * a[i];
    ph[c] = 0.5f * f;
  }
}

// ── B1f: forward, primal output and (SAVE) each block's input state ──────

// With ANGLES, phi is the angle matrix x (n, nb * log2 D) and the phases
// are formed in registers (the primal forward only).
template <int D, int NT, int CJ, int P, bool SAVE, bool ANGLES>
__global__ void __launch_bounds__(NT)
hea_chain_fwd_kernel(const float* __restrict__ mt_r,
                     const float* __restrict__ mt_i,
                     const float* __restrict__ phi,
                     float* __restrict__ out_r, float* __restrict__ out_i,
                     float* __restrict__ st_r, float* __restrict__ st_i,
                     int nb, int n, float inv_sqrt) {
  using T = Tile<D, NT, CJ, P>;
  constexpr int JT = T::JT, RG = T::RG, R = T::R, LD = T::LD,
                NBUF = T::NBUF, NQ = qubits_of(D);
  static_assert(!(SAVE && ANGLES), "the angle route saves no residuals");

  extern __shared__ __align__(16) float smem[];
  float* x_r = smem;              // (R, LD) state tile
  float* x_i = x_r + R * LD;
  float* m_r = x_i + R * LD;      // NBUF x (D, D) = M_b^T, row-major
  float* m_i = m_r + NBUF * D * D;

  const int tj = threadIdx.x % JT;
  const int rg = threadIdx.x / JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n) * D;

  // M_0^T (and M_1^T) asked for first: one cp.async group per block
  stage_matrix<D, D, NT>(mt_r, mt_i, m_r, m_i);
  cp_async_commit();
  if constexpr (NBUF == 2) {
    if (nb > 1)
      stage_matrix<D, D, NT>(mt_r + D * D, mt_i + D * D, m_r + D * D,
                             m_i + D * D);
    cp_async_commit();
  }

  // s_1 = D(x_1) H|0...0> = exp(-i phi_0) / sqrt(D)
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = p * RG + rg;              // consecutive rows per warp
    const long long row = row0 + lr;
    float vr[CJ], vi[CJ];
    if (row < n) {
      float ph[CJ];
      if constexpr (ANGLES) {
        float ang[NQ];
        load_angles<NQ>(phi, row, 0, nb, ang);
        angle_phases<NQ, CJ>(ang, tj, ph);
      } else {
        load_vec<CJ>(phi + row * D + tj * CJ, ph);
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        float sn, cs;
        sincosf(ph[c], &sn, &cs);
        vr[c] = cs * inv_sqrt;
        vi[c] = -sn * inv_sqrt;
      }
      if constexpr (SAVE) {
        store_vec<CJ>(st_r + row * D + tj * CJ, vr);
        store_vec<CJ>(st_i + row * D + tj * CJ, vi);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CJ; ++c) vr[c] = vi[c] = 0.f;
    }
    store_vec<CJ>(x_r + lr * LD + tj * CJ, vr);
    store_vec<CJ>(x_i + lr * LD + tj * CJ, vi);
  }

  for (int b = 0;; ++b) {
    // the next phase step's phases (or angles), asked for before the
    // product so that their latency hides behind it
    float ph[P][CJ];
    float ang[P][NQ];
    if (b + 1 < nb) {
      if constexpr (ANGLES) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const long long row = row0 + p * RG + rg;
          if (row < n) load_angles<NQ>(phi, row, b + 1, nb, ang[p]);
        }
      } else {
        const float* pb = phi + static_cast<size_t>(b + 1) * nd;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const long long row = row0 + p * RG + rg;
          if (row < n) load_vec<CJ>(pb + row * D + tj * CJ, ph[p]);
        }
      }
    }
    // M_b^T has landed (the group of M_{b+1}^T may still be in flight)
    cp_async_wait<NBUF - 1>();
    __syncthreads();  // ... for every thread; the state tile is written

    // u = s . M_b^T for this thread's P x CJ tile
    const int buf = NBUF == 2 ? (b & 1) : 0;
    float ar[P][CJ], ai[P][CJ];
    fwd_product<T, D, CJ, P>(x_r, x_i, m_r + buf * D * D, m_i + buf * D * D,
                             ar, ai, tj, rg);
    __syncthreads();  // every thread is done reading s and M_b^T

    // the buffer just read takes the block after next (at D = 128, with a
    // single buffer, the next block), landing while the phase step runs
    const int ahead = b + NBUF;
    if (ahead < nb)
      stage_matrix<D, D, NT>(mt_r + static_cast<size_t>(ahead) * D * D,
                             mt_i + static_cast<size_t>(ahead) * D * D,
                             m_r + buf * D * D, m_i + buf * D * D);
    cp_async_commit();

    if (b == nb - 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
          store_vec<CJ>(out_r + row * D + tj * CJ, ar[p]);
          store_vec<CJ>(out_i + row * D + tj * CJ, ai[p]);
        }
      }
      return;
    }

    // s <- D(x_{b+1}) (.) u, with D = cos(phi) - i sin(phi)
    const size_t blk = static_cast<size_t>(b + 1) * nd;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
      const long long row = row0 + lr;
      if constexpr (ANGLES) {
        if (row < n) angle_phases<NQ, CJ>(ang[p], tj, ph[p]);
      }
      float vr[CJ], vi[CJ];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        vr[c] = vi[c] = 0.f;
        if (row < n) {
          float sn, cs;
          sincosf(ph[p][c], &sn, &cs);
          vr[c] = cs * ar[p][c] + sn * ai[p][c];
          vi[c] = cs * ai[p][c] - sn * ar[p][c];
        }
      }
      if constexpr (SAVE) {
        if (row < n) {
          store_vec<CJ>(st_r + blk + row * D + tj * CJ, vr);
          store_vec<CJ>(st_i + blk + row * D + tj * CJ, vi);
        }
      }
      store_vec<CJ>(x_r + lr * LD + tj * CJ, vr);
      store_vec<CJ>(x_i + lr * LD + tj * CJ, vi);
    }
  }
}

// ── B1b: the reverse sweep, phibar and ubar per block ────────────────────

template <int D, int NT, int CJ, int P>
__global__ void __launch_bounds__(NT)
hea_chain_bwd_kernel(const float* __restrict__ mt_r,
                     const float* __restrict__ mt_i,
                     const float* __restrict__ phi,
                     const float* __restrict__ st_r,
                     const float* __restrict__ st_i,
                     const float* __restrict__ g_r,
                     const float* __restrict__ g_i,
                     float* __restrict__ ub_r, float* __restrict__ ub_i,
                     float* __restrict__ phibar, int nb, int n,
                     float inv_sqrt) {
  using T = Tile<D, NT, CJ, P>;
  constexpr int JT = T::JT, RG = T::RG, R = T::R, LD = T::LD,
                NBUF = T::NBUF, MS = T::MS;

  extern __shared__ __align__(16) float smem[];
  float* u_r = smem;             // (R, LD) ubar tile
  float* u_i = u_r + R * LD;
  float* m_r = u_i + R * LD;     // NBUF x (D, LD) = M_b^T, row k, column j
  float* m_i = m_r + NBUF * MS;

  const int tk = threadIdx.x % JT;  // outputs k = tk + c * JT
  const int rg = threadIdx.x / JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n) * D;

  // M_{nb-1}^T (and M_{nb-2}^T) asked for first: one group per block
  stage_matrix<D, LD, NT>(mt_r + static_cast<size_t>(nb - 1) * D * D,
                          mt_i + static_cast<size_t>(nb - 1) * D * D, m_r,
                          m_i);
  cp_async_commit();
  if constexpr (NBUF == 2) {
    if (nb > 1)
      stage_matrix<D, LD, NT>(mt_r + static_cast<size_t>(nb - 2) * D * D,
                              mt_i + static_cast<size_t>(nb - 2) * D * D,
                              m_r + MS, m_i + MS);
    cp_async_commit();
  }

  // ubar of the current block for this thread's tile; ubar_{nb-1} = g
  float ar[P][CJ], ai[P][CJ];
  const size_t last = static_cast<size_t>(nb - 1) * nd;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long row = row0 + p * RG + rg;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int k = tk + c * JT;
      ar[p][c] = ai[p][c] = 0.f;
      if (row < n) {
        ar[p][c] = g_r[row * D + k];
        ai[p][c] = g_i[row * D + k];
        ub_r[last + row * D + k] = ar[p][c];
        ub_i[last + row * D + k] = ai[p][c];
      }
    }
  }

  for (int i = 0;; ++i) {
    const int b = nb - 1 - i;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        u_r[lr * LD + tk + c * JT] = ar[p][c];
        u_i[lr * LD + tk + c * JT] = ai[p][c];
      }
    }

    // the phase step's operands (phi_b, and s_b past the first block),
    // asked for before the product so that their latency hides behind it
    const size_t blk = static_cast<size_t>(b) * nd;
    float ph[P][CJ], xr[P][CJ], xi[P][CJ];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + p * RG + rg;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const long long idx = row * D + tk + c * JT;
        ph[p][c] = xr[p][c] = xi[p][c] = 0.f;
        if (row < n) {
          ph[p][c] = phi[blk + idx];
          if (b > 0) {
            xr[p][c] = st_r[blk + idx];
            xi[p][c] = st_i[blk + idx];
          }
        }
      }
    }
    // M_b^T has landed (the group of M_{b-1}^T may still be in flight)
    cp_async_wait<NBUF - 1>();
    __syncthreads();  // ... for every thread; the ubar tile is written

    // sbar_b = ubar_b . conj(M_b): sbar[r, k] = sum_j ubar[r, j] conj(M^T[k, j])
    const int buf = NBUF == 2 ? (i & 1) : 0;
    float sr[P][CJ], si[P][CJ];
    bwd_product<T, D, CJ, P>(u_r, u_i, m_r + buf * MS, m_i + buf * MS, sr, si,
                             tk, rg);
    __syncthreads();  // every thread is done reading ubar and M_b^T

    const int ahead = b - NBUF;
    if (ahead >= 0)
      stage_matrix<D, LD, NT>(mt_r + static_cast<size_t>(ahead) * D * D,
                              mt_i + static_cast<size_t>(ahead) * D * D,
                              m_r + buf * MS, m_i + buf * MS);
    cp_async_commit();

    if (b == 0) {
      // s_1 = inv_sqrt (cos phi_0, -sin phi_0)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            float sn, cs;
            sincosf(ph[p][c], &sn, &cs);
            // pr = cos, pi = -sin:  phibar = inv_sqrt (sbar_r pi - sbar_i pr)
            phibar[row * D + tk + c * JT] =
                inv_sqrt * (-sr[p][c] * sn - si[p][c] * cs);
          }
        }
      }
      return;
    }

    // block b's input state s_b = D_b (.) u_{b-1}, D_b = pr + i pi
    const size_t prev = static_cast<size_t>(b - 1) * nd;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + p * RG + rg;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        ar[p][c] = ai[p][c] = 0.f;
        if (row < n) {
          const long long idx = row * D + tk + c * JT;
          float sn, cs;
          sincosf(ph[p][c], &sn, &cs);
          const float pr = cs, pi = -sn;
          // u_{b-1} = conj(D_b) s_b
          const float ur = pr * xr[p][c] + pi * xi[p][c];
          const float ui = pr * xi[p][c] - pi * xr[p][c];
          const float dr = ur * sr[p][c] + ui * si[p][c];
          const float di = -ui * sr[p][c] + ur * si[p][c];
          phibar[blk + idx] = dr * pi - di * pr;
          // ubar_{b-1} = conj(D_b) sbar_b
          ar[p][c] = pr * sr[p][c] + pi * si[p][c];
          ai[p][c] = pr * si[p][c] - pi * sr[p][c];
          ub_r[prev + idx] = ar[p][c];
          ub_i[prev + idx] = ai[p][c];
        }
      }
    }
  }
}

// ── B1b: Mbar_b = conj(s_b)^T . ubar_b over one slice of batch rows ──────

constexpr int kMbarThreads = 256;

template <int D> struct MbarTile {
  static constexpr int TS = D < 32 ? D : (D < 64 ? 32 : 64);  // tile side
  static constexpr int TILES = D / TS;           // tiles along each side
  static constexpr int TM = TS >= 64 ? 4 : (TS >= 32 ? 2 : 1);  // per thread
  static constexpr int TT = TS / TM;             // threads along each side
  static constexpr int TH = TT * TT;             // threads with own outputs
  static constexpr int RS = kMbarThreads / TH;   // threads sharing an output
  static constexpr int RC = 1024 / TS < 64 ? 1024 / TS : 64;  // chunk rows
  static constexpr int VEC = TS < 4 ? TS : 4;    // floats per copy
  static constexpr int STAGE = 4 * RC * TS;      // floats of one chunk
  static_assert(TH <= kMbarThreads && kMbarThreads % TH == 0, "");
};

// rows [r, r + RC) of s_b and ubar_b, columns k0.. / j0.. of the tile ->
// one stage (s_r, s_i, u_r, u_i, each (RC, TS)); rows past the slice are
// zeros (a copy of 0 source bytes)
template <int D>
__device__ __forceinline__ void stage_rows(
    const float* __restrict__ st_r, const float* __restrict__ st_i,
    const float* __restrict__ ub_r, const float* __restrict__ ub_i,
    size_t blk, long long r, long long r_end, int k0, int j0, float* stage) {
  using M = MbarTile<D>;
  constexpr int PER_ROW = M::TS / M::VEC;
  for (int t = threadIdx.x; t < 4 * M::RC * PER_ROW; t += kMbarThreads) {
    const int arr = t / (M::RC * PER_ROW);
    const int rr = (t / PER_ROW) % M::RC, v = t % PER_ROW;
    const long long row = r + rr;
    const bool ok = row < r_end;
    const float* src = arr == 0 ? st_r : arr == 1 ? st_i : arr == 2 ? ub_r : ub_i;
    const int col = (arr < 2 ? k0 : j0) + v * M::VEC;
    cp_async<4 * M::VEC>(stage + (arr * M::RC + rr) * M::TS + v * M::VEC,
                         src + blk + (ok ? row : 0) * D + col,
                         ok ? 4 * M::VEC : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMbarThreads)
hea_chain_mbar_kernel(const float* __restrict__ st_r,
                      const float* __restrict__ st_i,
                      const float* __restrict__ ub_r,
                      const float* __restrict__ ub_i,
                      float* __restrict__ out_r, float* __restrict__ out_i,
                      int nb, int n, int rows_per_split) {
  using M = MbarTile<D>;
  constexpr int TS = M::TS, TM = M::TM, TT = M::TT, TH = M::TH, RS = M::RS,
                RC = M::RC;
  __shared__ __align__(16) float stage[2][M::STAGE];

  const int b = blockIdx.x / (M::TILES * M::TILES);
  const int tile = blockIdx.x % (M::TILES * M::TILES);
  const int k0 = (tile / M::TILES) * TS, j0 = (tile % M::TILES) * TS;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int og = threadIdx.x % TH, rs = threadIdx.x / TH;
  const int tk = og / TT, tj = og % TT;
  const size_t blk = static_cast<size_t>(b) * n * D;

  float accr[TM][TM], acci[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) accr[a][c] = acci[a][c] = 0.f;

  const int chunks = r_end > r_begin
                         ? static_cast<int>((r_end - r_begin + RC - 1) / RC) : 0;
  if (chunks > 0)
    stage_rows<D>(st_r, st_i, ub_r, ub_i, blk, r_begin, r_end, k0, j0,
                  stage[0]);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks)
      stage_rows<D>(st_r, st_i, ub_r, ub_i, blk,
                    r_begin + static_cast<long long>(ch + 1) * RC, r_end, k0,
                    j0, stage[(ch + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch has landed for every thread
    const float* s_r = stage[ch & 1];
    const float* s_i = s_r + RC * TS;
    const float* u_r = s_i + RC * TS;
    const float* u_i = u_r + RC * TS;
    for (int rr = rs; rr < RC; rr += RS) {
      float xr[TM], xi[TM], yr[TM], yi[TM];
      load_vec<TM>(s_r + rr * TS + tk * TM, xr);
      load_vec<TM>(s_i + rr * TS + tk * TM, xi);
      load_vec<TM>(u_r + rr * TS + tj * TM, yr);
      load_vec<TM>(u_i + rr * TS + tj * TM, yi);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) {
          // conj(s) ubar = (xr - i xi)(yr + i yi)
          accr[a][c] = fmaf(xr[a], yr[c], fmaf(xi[a], yi[c], accr[a][c]));
          acci[a][c] = fmaf(xr[a], yi[c], fmaf(-xi[a], yr[c], acci[a][c]));
        }
    }
    __syncthreads();  // every thread is done reading chunk ch
  }

  const size_t out0 =
      (static_cast<size_t>(blockIdx.y) * nb + b) * D * D;
  if constexpr (RS == 1) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const size_t o = out0 + static_cast<size_t>(k0 + tk * TM + a) * D + j0 +
                       tj * TM;
      store_vec<TM>(out_r + o, accr[a]);
      store_vec<TM>(out_i + o, acci[a]);
    }
  } else {
    // TM == 1: RS threads hold partial sums of one entry; add them in order
    float* red_r = stage[0];
    float* red_i = red_r + kMbarThreads;
    red_r[threadIdx.x] = accr[0][0];
    red_i[threadIdx.x] = acci[0][0];
    __syncthreads();
    if (rs == 0) {
      float sr = 0.f, si = 0.f;
      for (int s = 0; s < RS; ++s) {
        sr += red_r[s * TH + og];
        si += red_i[s * TH + og];
      }
      const size_t o = out0 + static_cast<size_t>(k0 + tk) * D + j0 + tj;
      out_r[o] = sr;
      out_i[o] = si;
    }
  }
}

// out[i] = sum over splits s, in order, of part[s][i]
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part_r,
                  const float* __restrict__ part_i, float* __restrict__ out_r,
                  float* __restrict__ out_i, int splits, size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * 256) {
    float sr = 0.f, si = 0.f;
    for (int s = 0; s < splits; ++s) {
      sr += part_r[s * count + i];
      si += part_i[s * count + i];
    }
    out_r[i] = sr;
    out_i[i] = si;
  }
}

// ── launches ─────────────────────────────────────────────────────────────

// A kernel's dynamic shared-memory limit is raised once per device, not on
// every launch: ``done`` holds a bit per device already set.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D, int NT, int CJ, int P, bool SAVE, bool ANGLES = false>
cudaError_t launch_forward(const float* mt_r, const float* mt_i,
                           const float* phi, float* out_r, float* out_i,
                           float* st_r, float* st_i, int nb, int n,
                           cudaStream_t stream) {
  using T = Tile<D, NT, CJ, P>;
  static std::atomic<unsigned> done{0};
  const auto kernel = hea_chain_fwd_kernel<D, NT, CJ, P, SAVE, ANGLES>;
  cudaError_t err = allow_smem(kernel, T::fwd_smem_bytes, done);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + T::R - 1) / T::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, NT, T::fwd_smem_bytes, stream>>>(
      mt_r, mt_i, phi, out_r, out_i, st_r, st_i, nb, n, inv_sqrt);
  return cudaGetLastError();
}

template <int D, int NT, int CJ, int P>
cudaError_t launch_backward(const float* mt_r, const float* mt_i,
                            const float* phi, const float* st_r,
                            const float* st_i, const float* g_r,
                            const float* g_i, float* ub_r, float* ub_i,
                            float* part_r, float* part_i, float* mbar_r,
                            float* mbar_i, float* phibar, int nb, int n,
                            int splits, cudaStream_t stream) {
  using T = Tile<D, NT, CJ, P>;
  using M = MbarTile<D>;
  static std::atomic<unsigned> done{0};
  const auto kernel = hea_chain_bwd_kernel<D, NT, CJ, P>;
  cudaError_t err = allow_smem(kernel, T::bwd_smem_bytes, done);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + T::R - 1) / T::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, NT, T::bwd_smem_bytes, stream>>>(
      mt_r, mt_i, phi, st_r, st_i, g_r, g_i, ub_r, ub_i, phibar, nb, n,
      inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 mgrid(static_cast<unsigned>(nb * M::TILES * M::TILES),
                   static_cast<unsigned>(splits));
  hea_chain_mbar_kernel<D><<<mgrid, kMbarThreads, 0, stream>>>(
      st_r, st_i, ub_r, ub_i, splits > 1 ? part_r : mbar_r,
      splits > 1 ? part_i : mbar_i, nb, n, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t count = static_cast<size_t>(nb) * D * D;
  const size_t blocks = (count + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                      256, 0, stream>>>(part_r, part_i, mbar_r, mbar_i,
                                        splits, count);
  return cudaGetLastError();
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_hea.py).  Each takes device pointers of
// contiguous fp32 tensors (mt and phi 16-byte aligned) and the stream to
// launch on, and returns the cudaError_t of its launches (0 on success).
// d must be a power of two in [2, 128], nb >= 1, n >= 1, and tile one of
// the geometries of HEA_TILES for d (cuda_hea.chain_geometry picks it).

// Rows R of the row tile ``tile`` at width d, or 0 for no such tile: the
// wrapper checks its own table against this one when it loads the library.
extern "C" int hea_chain_tile_rows(int d, int tile) {
#define HEA_ROWS(D_, T_, NT_, CJ_, P_)                                      \
  if (d == D_ && tile == T_) return Tile<D_, NT_, CJ_, P_>::R;
  HEA_TILES(HEA_ROWS)
#undef HEA_ROWS
  return 0;
}

// B1f.  st_r, st_i (nb, n, d): each block's input state, written when not
// null (the residuals of the backward).  The primal and residual variants
// of one (n, d, tile) give equal outputs, bit for bit.
extern "C" int hea_chain_forward(const float* mt_r, const float* mt_i,
                                 const float* phi, float* out_r,
                                 float* out_i, float* st_r, float* st_i,
                                 int nb, int n, int d, int tile,
                                 void* stream) {
  if (nb < 1 || n < 1 || (st_r == nullptr) != (st_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEA_FWD(D_, T_, NT_, CJ_, P_)                                       \
  if (d == D_ && tile == T_)                                                \
    return st_r != nullptr                                                  \
               ? launch_forward<D_, NT_, CJ_, P_, true>(                    \
                     mt_r, mt_i, phi, out_r, out_i, st_r, st_i, nb, n, s)   \
               : launch_forward<D_, NT_, CJ_, P_, false>(                   \
                     mt_r, mt_i, phi, out_r, out_i, st_r, st_i, nb, n, s);
  HEA_TILES(HEA_FWD)
#undef HEA_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// B1f on the angles: x (n, nb * log2 d), contiguous, block-major, in place
// of the phases (any alignment); the primal output only, equal bit for bit
// to hea_chain_forward's on the phases that hea.encoding_phases forms from
// x, at the same tile.
extern "C" int hea_chain_forward_angles(const float* mt_r, const float* mt_i,
                                        const float* x, float* out_r,
                                        float* out_i, int nb, int n, int d,
                                        int tile, void* stream) {
  if (nb < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEA_FWD_ANGLES(D_, T_, NT_, CJ_, P_)                                \
  if (d == D_ && tile == T_)                                                \
    return launch_forward<D_, NT_, CJ_, P_, false, true>(                   \
        mt_r, mt_i, x, out_r, out_i, nullptr, nullptr, nb, n, s);
  HEA_TILES(HEA_FWD_ANGLES)
#undef HEA_FWD_ANGLES
  return static_cast<int>(cudaErrorInvalidValue);
}

// B1b.  g_r, g_i (n, d): the output's cotangent.  ub_r, ub_i (nb, n, d):
// scratch for ubar.  part_r, part_i (splits, nb, d, d): scratch for the
// slices of Mbar, used when splits > 1.  Writes mbar_r, mbar_i (nb, d, d)
// and phibar (nb, n, d).
extern "C" int hea_chain_backward(const float* mt_r, const float* mt_i,
                                  const float* phi, const float* st_r,
                                  const float* st_i, const float* g_r,
                                  const float* g_i, float* ub_r, float* ub_i,
                                  float* part_r, float* part_i,
                                  float* mbar_r, float* mbar_i,
                                  float* phibar, int nb, int n, int d,
                                  int tile, int splits, void* stream) {
  if (nb < 1 || n < 1 || splits < 1 || splits > n ||
      (splits > 1 && (part_r == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEA_BWD(D_, T_, NT_, CJ_, P_)                                       \
  if (d == D_ && tile == T_)                                                \
    return launch_backward<D_, NT_, CJ_, P_>(                               \
        mt_r, mt_i, phi, st_r, st_i, g_r, g_i, ub_r, ub_i, part_r, part_i,  \
        mbar_r, mbar_i, phibar, nb, n, splits, s);
  HEA_TILES(HEA_BWD)
#undef HEA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hea_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
