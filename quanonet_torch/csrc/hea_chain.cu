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
//   B1b  _bwd_kernel, the reverse sweep, here as three launches:
//
//     hea_chain_bwd_kernel   ubar_{nb-1} = g;  for b = nb-1 .. 0:
//                              sbar_b = ubar_b . conj(M_b^T)^T
//                              phibar_b, ubar_{b-1} from sbar_b, s_b, phi_b
//     hea_chain_mbar_kernel  Mbar_b = conj(s_b)^T . ubar_b, summed over
//                            the batch rows of one slice
//     sum_splits_kernel      the slices summed in a fixed order
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
// each pass is nb = 60 dependent block steps on 4 CTAs (~74 MFLOP and
// ~4.6 MB for the backward), so it is bound by latency, the chain of
// staged matrices and barriers.  At N >= 1000 the backward is bound by
// fp32 operations.
//
// Design.  Forward and sweep: one CTA owns a tile of R batch rows for the
// whole chain, so the state (forward) and sbar (backward) never leave the
// SM between blocks.  Per block the CTA stages the block matrix in shared
// memory (the sweep stages M_b = (M_b^T)^T, transposed on the way in with
// a padded row so both the staging writes and the product's reads are
// free of bank conflicts) and the row tile; a thread owns CJ amplitudes
// (lanes on consecutive amplitudes) for P rows and accumulates the
// product as a P x CJ register tile, reading the tile as warp broadcasts
// (float4 over four k at a time).  Mbar is a sum over the batch, which
// the TPU kernel got for free by running the whole batch in one program;
// here it is a cross-CTA sum, made deterministic without atomics: the
// sweep writes ubar (nb, N, D) to a scratch buffer, and the Mbar kernel
// gives each (block, 32x32 output tile, slice of rows) one CTA that sums
// its rows in a fixed order; when there is more than one slice, a third
// kernel adds the slices in slice order.  So two calls on equal inputs
// give equal bits.  The phase exp(-i phi) is taken in-kernel with the
// accurate sincosf: |phi| reaches tens of radians, so neither __sincosf
// nor --use_fast_math is used.  Ragged batch tiles are masked: rows >= N
// carry zeros and are never read or written.  No tensor cores, no TMA:
// plain fp32, simple.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

// rows per thread for each width: keeps the CTA's row tile R at 16..128
template <int D> struct RowsPerThread { static constexpr int value = 1; };
template <> struct RowsPerThread<16> { static constexpr int value = 2; };
template <> struct RowsPerThread<32> { static constexpr int value = 4; };
template <> struct RowsPerThread<64> { static constexpr int value = 4; };
template <> struct RowsPerThread<128> { static constexpr int value = 2; };

template <int D> struct Geometry {
  static constexpr int JT = D < 32 ? D : 32;    // threads along amplitudes
  static constexpr int CJ = D / JT;             // amplitudes per thread
  static constexpr int RG = kThreads / JT;      // row groups per CTA
  static constexpr int P = RowsPerThread<D>::value;
  static constexpr int R = RG * P;              // batch rows per CTA
  static constexpr int KV = D < 4 ? D : 4;      // k values per state read
  static constexpr int LDM = D + 1;             // padded row of the sweep's M
  static constexpr size_t fwd_smem_bytes = sizeof(float) * (2 * D * D + 2 * R * D);
  static constexpr size_t bwd_smem_bytes = sizeof(float) * (2 * D * LDM + 2 * R * D);
};

template <int D>
__device__ __forceinline__ void stage_matrix(const float* __restrict__ g_r,
                                             const float* __restrict__ g_i,
                                             float* s_r, float* s_i) {
  const float4* gr = reinterpret_cast<const float4*>(g_r);
  const float4* gi = reinterpret_cast<const float4*>(g_i);
  float4* sr = reinterpret_cast<float4*>(s_r);
  float4* si = reinterpret_cast<float4*>(s_i);
  for (int t = threadIdx.x; t < D * D / 4; t += kThreads) {
    sr[t] = gr[t];
    si[t] = gi[t];
  }
}

// M^T (row-major, from device memory) -> M in shared memory, rows of LDM
template <int D>
__device__ __forceinline__ void stage_matrix_transposed(
    const float* __restrict__ g_r, const float* __restrict__ g_i, float* s_r,
    float* s_i) {
  constexpr int LDM = Geometry<D>::LDM;
  for (int t = threadIdx.x; t < D * D; t += kThreads) {
    const int k = t / D, j = t % D;             // g[k][j] = M^T[k][j] = M[j][k]
    s_r[j * LDM + k] = g_r[t];
    s_i[j * LDM + k] = g_i[t];
  }
}

// acc (P x CJ) = x_tile . M for this thread's rows and amplitudes, where
// the state tile x (R, D) and M (D, ld) are in shared memory.  CONJ
// multiplies by conj(M) instead of M.
template <int D, int ld, bool CONJ>
__device__ __forceinline__ void tile_product(
    const float* x_r, const float* x_i, const float* m_r, const float* m_i,
    float (&ar)[Geometry<D>::P][Geometry<D>::CJ],
    float (&ai)[Geometry<D>::P][Geometry<D>::CJ], int tj, int rg) {
  using G = Geometry<D>;
  constexpr int JT = G::JT, CJ = G::CJ, RG = G::RG, P = G::P, KV = G::KV;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < CJ; ++c) ar[p][c] = ai[p][c] = 0.f;

#pragma unroll 8
  for (int k = 0; k < D; k += KV) {
    float xr[P][KV], xi[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int off = (p * RG + rg) * D + k;
      if constexpr (KV == 4) {
        const float4 vr = *reinterpret_cast<const float4*>(x_r + off);
        const float4 vi = *reinterpret_cast<const float4*>(x_i + off);
        xr[p][0] = vr.x; xr[p][1] = vr.y; xr[p][2] = vr.z; xr[p][3] = vr.w;
        xi[p][0] = vi.x; xi[p][1] = vi.y; xi[p][2] = vi.z; xi[p][3] = vi.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < KV; ++kk) {
          xr[p][kk] = x_r[off + kk];
          xi[p][kk] = x_i[off + kk];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float mr = m_r[(k + kk) * ld + tj + c * JT];
        const float mi = CONJ ? -m_i[(k + kk) * ld + tj + c * JT]
                              : m_i[(k + kk) * ld + tj + c * JT];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          ar[p][c] = fmaf(xr[p][kk], mr, ar[p][c]);
          ar[p][c] = fmaf(-xi[p][kk], mi, ar[p][c]);
          ai[p][c] = fmaf(xr[p][kk], mi, ai[p][c]);
          ai[p][c] = fmaf(xi[p][kk], mr, ai[p][c]);
        }
      }
    }
  }
}

// ── B1f: forward, primal output and (SAVE) each block's input state ──────

template <int D, bool SAVE>
__global__ void __launch_bounds__(kThreads)
hea_chain_fwd_kernel(const float* __restrict__ mt_r,
                     const float* __restrict__ mt_i,
                     const float* __restrict__ phi,
                     float* __restrict__ out_r, float* __restrict__ out_i,
                     float* __restrict__ st_r, float* __restrict__ st_i,
                     int nb, int n, float inv_sqrt) {
  using G = Geometry<D>;
  constexpr int JT = G::JT, CJ = G::CJ, RG = G::RG, P = G::P, R = G::R;

  extern __shared__ __align__(16) float smem[];
  float* m_r = smem;             // (D, D) = M_b^T, row-major
  float* m_i = m_r + D * D;
  float* s_r = m_i + D * D;      // (R, D) state tile
  float* s_i = s_r + R * D;

  const int tj = threadIdx.x % JT;
  const int rg = threadIdx.x / JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n) * D;

  // s_1 = D(x_1) H|0...0> = exp(-i phi_0) / sqrt(D)
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = p * RG + rg;              // consecutive rows per warp
    const long long row = row0 + lr;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int j = tj + c * JT;
      float vr = 0.f, vi = 0.f;
      if (row < n) {
        float sn, cs;
        sincosf(phi[row * D + j], &sn, &cs);
        vr = cs * inv_sqrt;
        vi = -sn * inv_sqrt;
        if constexpr (SAVE) {
          st_r[row * D + j] = vr;
          st_i[row * D + j] = vi;
        }
      }
      s_r[lr * D + j] = vr;
      s_i[lr * D + j] = vi;
    }
  }
  stage_matrix<D>(mt_r, mt_i, m_r, m_i);
  __syncthreads();

  for (int b = 0;; ++b) {
    // u = s . M_b^T for this thread's P x CJ tile
    float ar[P][CJ], ai[P][CJ];
    tile_product<D, D, false>(s_r, s_i, m_r, m_i, ar, ai, tj, rg);
    __syncthreads();  // every thread is done reading s and M_b

    if (b == nb - 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            const int j = tj + c * JT;
            out_r[row * D + j] = ar[p][c];
            out_i[row * D + j] = ai[p][c];
          }
        }
      }
      return;
    }

    // s <- D(x_{b+1}) (.) u, with D = cos(phi) - i sin(phi)
    const size_t blk = static_cast<size_t>(b + 1) * nd;
    const float* ph = phi + blk;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
      const long long row = row0 + lr;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int j = tj + c * JT;
        float vr = 0.f, vi = 0.f;
        if (row < n) {
          float sn, cs;
          sincosf(ph[row * D + j], &sn, &cs);
          vr = cs * ar[p][c] + sn * ai[p][c];
          vi = cs * ai[p][c] - sn * ar[p][c];
          if constexpr (SAVE) {
            st_r[blk + row * D + j] = vr;
            st_i[blk + row * D + j] = vi;
          }
        }
        s_r[lr * D + j] = vr;
        s_i[lr * D + j] = vi;
      }
    }
    stage_matrix<D>(mt_r + static_cast<size_t>(b + 1) * D * D,
                    mt_i + static_cast<size_t>(b + 1) * D * D, m_r, m_i);
    __syncthreads();
  }
}

// ── B1b: the reverse sweep, phibar and ubar per block ────────────────────

template <int D>
__global__ void __launch_bounds__(kThreads)
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
  using G = Geometry<D>;
  constexpr int JT = G::JT, CJ = G::CJ, RG = G::RG, P = G::P, R = G::R,
                LDM = G::LDM;

  extern __shared__ __align__(16) float smem[];
  float* u_r = smem;             // (R, D) ubar tile
  float* u_i = u_r + R * D;
  float* m_r = u_i + R * D;      // (D, LDM) = M_b, row j, column k
  float* m_i = m_r + D * LDM;

  const int tj = threadIdx.x % JT;
  const int rg = threadIdx.x / JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nd = static_cast<size_t>(n) * D;

  // ubar of the current block for this thread's tile; ubar_{nb-1} = g
  float ar[P][CJ], ai[P][CJ];
  const size_t last = static_cast<size_t>(nb - 1) * nd;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long row = row0 + p * RG + rg;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int j = tj + c * JT;
      ar[p][c] = ai[p][c] = 0.f;
      if (row < n) {
        ar[p][c] = g_r[row * D + j];
        ai[p][c] = g_i[row * D + j];
        ub_r[last + row * D + j] = ar[p][c];
        ub_i[last + row * D + j] = ai[p][c];
      }
    }
  }

  for (int b = nb - 1;; --b) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        u_r[lr * D + tj + c * JT] = ar[p][c];
        u_i[lr * D + tj + c * JT] = ai[p][c];
      }
    }
    stage_matrix_transposed<D>(mt_r + static_cast<size_t>(b) * D * D,
                               mt_i + static_cast<size_t>(b) * D * D, m_r,
                               m_i);
    __syncthreads();

    // sbar_b = ubar_b . conj(M_b): sbar[r, k] = sum_j ubar[r, j] conj(M[j, k])
    float sr[P][CJ], si[P][CJ];
    tile_product<D, LDM, true>(u_r, u_i, m_r, m_i, sr, si, tj, rg);
    __syncthreads();  // every thread is done reading ubar and M_b

    const size_t blk = static_cast<size_t>(b) * nd;
    if (b == 0) {
      // s_1 = inv_sqrt (cos phi_0, -sin phi_0)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            const long long idx = row * D + tj + c * JT;
            float sn, cs;
            sincosf(phi[idx], &sn, &cs);
            // pr = cos, pi = -sin:  phibar = inv_sqrt (sbar_r pi - sbar_i pr)
            phibar[idx] = inv_sqrt * (-sr[p][c] * sn - si[p][c] * cs);
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
          const long long idx = row * D + tj + c * JT;
          float sn, cs;
          sincosf(phi[blk + idx], &sn, &cs);
          const float pr = cs, pi = -sn;
          const float xr = st_r[blk + idx], xi = st_i[blk + idx];
          // u_{b-1} = conj(D_b) s_b
          const float ur = pr * xr + pi * xi;
          const float ui = pr * xi - pi * xr;
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

template <int D> struct MbarGeometry {
  static constexpr int TJ = D < 32 ? D : 32;     // output tile side
  static constexpr int TILES = D / TJ;           // tiles along each side
  static constexpr int G = kThreads / TJ;        // thread groups along k
  static constexpr int KG = G < TJ ? G : TJ;     // distinct k per group pass
  static constexpr int KP = TJ / KG;             // k values per thread
  static constexpr int RS = G / KG;              // threads sharing one entry
};

template <int D>
__global__ void __launch_bounds__(kThreads)
hea_chain_mbar_kernel(const float* __restrict__ st_r,
                      const float* __restrict__ st_i,
                      const float* __restrict__ ub_r,
                      const float* __restrict__ ub_i,
                      float* __restrict__ out_r, float* __restrict__ out_i,
                      int nb, int n, int rows_per_split) {
  using G = MbarGeometry<D>;
  constexpr int TJ = G::TJ, TILES = G::TILES, KG = G::KG, KP = G::KP,
                RS = G::RS;
  __shared__ float red_r[kThreads], red_i[kThreads];

  const int b = blockIdx.x / (TILES * TILES);
  const int tile = blockIdx.x % (TILES * TILES);
  const int k0 = (tile / TILES) * TJ, j0 = (tile % TILES) * TJ;
  const int split = blockIdx.y;
  const long long r_begin = static_cast<long long>(split) * rows_per_split;
  const long long r_end = r_begin + rows_per_split < n
                              ? r_begin + rows_per_split : n;
  const int lane = threadIdx.x % TJ, grp = threadIdx.x / TJ;
  const int kq = grp % KG, rs = grp / KG;
  const int j = j0 + lane;
  const size_t blk = static_cast<size_t>(b) * n * D;

  float accr[KP], acci[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) accr[q] = acci[q] = 0.f;
  for (long long r = r_begin + rs; r < r_end; r += RS) {
    const float ur = ub_r[blk + r * D + j], ui = ub_i[blk + r * D + j];
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const int k = k0 + kq + KG * q;
      const float xr = st_r[blk + r * D + k], xi = st_i[blk + r * D + k];
      // conj(s) ubar = (xr - i xi)(ur + i ui)
      accr[q] = fmaf(xr, ur, fmaf(xi, ui, accr[q]));
      acci[q] = fmaf(xr, ui, fmaf(-xi, ur, acci[q]));
    }
  }

  const size_t out0 = (static_cast<size_t>(split) * nb + b) * D * D;
  if constexpr (RS == 1) {
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const int k = k0 + kq + KG * q;
      out_r[out0 + static_cast<size_t>(k) * D + j] = accr[q];
      out_i[out0 + static_cast<size_t>(k) * D + j] = acci[q];
    }
  } else {
    // KP == 1: RS threads hold partial sums of one entry; add them in order
    red_r[threadIdx.x] = accr[0];
    red_i[threadIdx.x] = acci[0];
    __syncthreads();
    if (rs == 0) {
      float sr = 0.f, si = 0.f;
      for (int s = 0; s < RS; ++s) {
        sr += red_r[(s * KG + kq) * TJ + lane];
        si += red_i[(s * KG + kq) * TJ + lane];
      }
      const int k = k0 + kq;
      out_r[out0 + static_cast<size_t>(k) * D + j] = sr;
      out_i[out0 + static_cast<size_t>(k) * D + j] = si;
    }
  }
}

// out[i] = sum over splits s, in order, of part[s][i]
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part_r,
                  const float* __restrict__ part_i, float* __restrict__ out_r,
                  float* __restrict__ out_i, int splits, size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float sr = 0.f, si = 0.f;
    for (int s = 0; s < splits; ++s) {
      sr += part_r[s * count + i];
      si += part_i[s * count + i];
    }
    out_r[i] = sr;
    out_i[i] = si;
  }
}

template <int D>
cudaError_t launch_forward(const float* mt_r, const float* mt_i,
                           const float* phi, float* out_r, float* out_i,
                           float* st_r, float* st_i, int nb, int n,
                           cudaStream_t stream) {
  using G = Geometry<D>;
  const int smem = static_cast<int>(G::fwd_smem_bytes);
  const bool save = st_r != nullptr;
  const auto kernel = save ? hea_chain_fwd_kernel<D, true>
                           : hea_chain_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + G::R - 1) / G::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, kThreads, smem, stream>>>(mt_r, mt_i, phi, out_r, out_i,
                                           st_r, st_i, nb, n, inv_sqrt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* mt_r, const float* mt_i,
                            const float* phi, const float* st_r,
                            const float* st_i, const float* g_r,
                            const float* g_i, float* ub_r, float* ub_i,
                            float* part_r, float* part_i, float* mbar_r,
                            float* mbar_i, float* phibar, int nb, int n,
                            int splits, cudaStream_t stream) {
  using G = Geometry<D>;
  using MG = MbarGeometry<D>;
  const int smem = static_cast<int>(G::bwd_smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      hea_chain_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + G::R - 1) / G::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  hea_chain_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      mt_r, mt_i, phi, st_r, st_i, g_r, g_i, ub_r, ub_i, phibar, nb, n,
      inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 mgrid(static_cast<unsigned>(nb * MG::TILES * MG::TILES),
                   static_cast<unsigned>(splits));
  float* dst_r = splits > 1 ? part_r : mbar_r;
  float* dst_i = splits > 1 ? part_i : mbar_i;
  hea_chain_mbar_kernel<D><<<mgrid, kThreads, 0, stream>>>(
      st_r, st_i, ub_r, ub_i, dst_r, dst_i, nb, n, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t count = static_cast<size_t>(nb) * D * D;
  const size_t blocks = (count + kThreads - 1) / kThreads;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                      kThreads, 0, stream>>>(part_r, part_i, mbar_r, mbar_i,
                                             splits, count);
  return cudaGetLastError();
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_hea.py).  Each takes device pointers of
// contiguous fp32 tensors and the stream to launch on, and returns the
// cudaError_t of its launches (0 on success).  d must be a power of two
// in [2, 128], nb >= 1, n >= 1.

// B1f.  st_r, st_i (nb, n, d): each block's input state, written when not
// null (the residuals of the backward).
extern "C" int hea_chain_forward(const float* mt_r, const float* mt_i,
                                 const float* phi, float* out_r,
                                 float* out_i, float* st_r, float* st_i,
                                 int nb, int n, int d, void* stream) {
  if (nb < 1 || n < 1 || (st_r == nullptr) != (st_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEA_FWD(D)                                                        \
  case D:                                                                 \
    return launch_forward<D>(mt_r, mt_i, phi, out_r, out_i, st_r, st_i,   \
                             nb, n, s);
  switch (d) {
    HEA_FWD(2) HEA_FWD(4) HEA_FWD(8) HEA_FWD(16) HEA_FWD(32) HEA_FWD(64)
    HEA_FWD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEA_FWD
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
                                  int splits, void* stream) {
  if (nb < 1 || n < 1 || splits < 1 || splits > n ||
      (splits > 1 && (part_r == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEA_BWD(D)                                                        \
  case D:                                                                 \
    return launch_backward<D>(mt_r, mt_i, phi, st_r, st_i, g_r, g_i,      \
                              ub_r, ub_i, part_r, part_i, mbar_r, mbar_i, \
                              phibar, nb, n, splits, s);
  switch (d) {
    HEA_BWD(2) HEA_BWD(4) HEA_BWD(8) HEA_BWD(16) HEA_BWD(32) HEA_BWD(64)
    HEA_BWD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEA_BWD
}

extern "C" const char* hea_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
