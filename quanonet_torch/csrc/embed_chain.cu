// Real-embedding chain of the HEA circuit, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_embed.py, joined there
// as the custom VJP _make_chain (engine name 'embed'):
//
//   B3f  _fwd_kernel (primal output, and the residual-saving variant)
//
//     s_0     = d^(-1/2) [cos t_0 (columns < d) | sin t_0 (columns >= d)]
//     u_b     = s_b . E_b                                  b = 0 .. nb-2
//     s_{b+1} = cos t_{b+1} (.) u_b + sin t_{b+1} (.) swap(u_b)
//     out     = s_{nb-1} . E_{nb-1}
//
//   The state is one real row of width W = 2d ([re | im] when E is the real
//   representation of a complex block matrix); swap exchanges the two halves
//   of the row.  Inputs: e (nb, W, W), t (nb, N, W), both general: nothing
//   here assumes E's block structure or t's antisymmetry.  Outputs: out
//   (N, W); with residuals also s (nb, N, W), each block's input row, and
//   u (nb-1, N, W), each product before its phase step, as the TPU kernel
//   saves them.  (u cannot be recovered from s_{b+1} as the block chain
//   recovers it: for a general t the phase step's 2x2 map has determinant
//   cos(t_lo + t_hi), which vanishes.)
//
//   B3b  _bwd_kernel, the reverse sweep, here as three launches:
//
//     embed_chain_bwd_kernel   ubar_{nb-1} = g;  for b = nb-1 .. 0:
//                                sbar_b = ubar_b . E_b^T
//                                tbar_b, ubar_{b-1} from sbar_b, u_{b-1}, t_b
//     embed_chain_ebar_kernel  Ebar_b = s_b^T . ubar_b, summed over the batch
//                              rows of one slice
//     sum_splits_kernel        the slices summed in a fixed order
//
//   Plain versions: quanonet_torch/ops/cuda_embed.py chain_embed (primal),
//   chain_embed_saved (residuals), chain_embed_backward (backward).
//
// What bounds them.  Each pass does nb*N*W^2 real MACs per product (the
// forward one, the backward two and the outer product Ebar), 2 flops each,
// against 4*(nb*N*W*k + nb*W^2) bytes with k = 1 (forward: t) .. 5
// (backward: t, s, u read, tbar written, and ubar through scratch): about
// W/(2k) flops per byte.  The H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s)
// is 20 flops per byte, so at the flagship's W = 64 the primal forward is
// bound by fp32 operations, and the residual forward and the backward by
// bytes.  At the training batch N = 100 neither bound is near: each pass is
// nb = 60 dependent block steps on 4 CTAs, bound by the latency of the
// staged matrices and barriers, as the block chain is.
//
// Design.  Forward and sweep: one CTA owns a tile of R batch rows for the
// whole chain, so the state (forward) and sbar (backward) never leave the
// SM between blocks.  A thread owns the columns j and j + d of P rows (CJ
// such pairs when d > 32), so both operands of the phase step, which
// crosses the halves of the row, are in its registers and the step needs
// no exchange.  One E_b can be larger than an SM's shared memory (256 KB at
// d = 128), so the product runs over panels of at most 64 rows of E_b
// (forward) or 64 columns (sweep, transposed on the way in with a padded
// row so that neither the staging writes nor the product's reads conflict),
// staged one after the other; the same code serves every width from W = 2
// to 256, and all of E stays in L2 between CTAs.  The product reads the
// row tile as warp broadcasts (float4 over four k) and the panel along
// consecutive columns.  The phase step's operands (the next t, and in the
// sweep u) are asked for before the product and used after it, so their
// trip to device memory hides behind the product.  Ebar is a sum over the
// batch, which the TPU kernel
// got by running the whole batch in one program; here it is a cross-CTA
// sum, made deterministic without atomics: the sweep writes ubar
// (nb, N, W) to a scratch buffer, and the Ebar kernel gives each (block,
// 32x32 output tile, slice of rows) one CTA that sums its rows in a fixed
// order; when there is more than one slice, a third kernel adds the slices
// in slice order.  So two calls on equal inputs give equal bits.  The
// phases are taken with the accurate sincosf: |t| reaches tens of radians
// over up to 60 blocks, so neither __sincosf nor --use_fast_math is used.
// Ragged batch tiles are masked: rows >= N carry zeros and are never read
// or written.  No tensor cores (full fp32, no TF32), no TMA: simple.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

// rows per thread for each half-width d: keeps the register tile at
// P x 2 CJ <= 16 accumulators and the CTA's row tile R at 16..256
template <int D> struct RowsPerThread { static constexpr int value = 1; };
template <> struct RowsPerThread<16> { static constexpr int value = 2; };
template <> struct RowsPerThread<32> { static constexpr int value = 4; };
template <> struct RowsPerThread<64> { static constexpr int value = 4; };
template <> struct RowsPerThread<128> { static constexpr int value = 2; };

template <int D> struct Geometry {
  static constexpr int W = 2 * D;                // row width
  static constexpr int JT = D < 32 ? D : 32;     // threads along one half
  static constexpr int CJ = D / JT;              // column pairs per thread
  static constexpr int NC = 2 * CJ;              // columns per thread
  static constexpr int RG = kThreads / JT;       // row groups per CTA
  static constexpr int P = RowsPerThread<D>::value;
  static constexpr int R = RG * P;               // batch rows per CTA
  static constexpr int KV = W < 4 ? W : 4;       // k values per row-tile read
  static constexpr int LDS = W < 4 ? W : W + 4;  // padded row of the row tile
  static constexpr int KP = W < 64 ? W : 64;     // panel depth
  static constexpr int LDT = W + 1;              // padded row, transposed panel
  static constexpr size_t fwd_smem_bytes = sizeof(float) * (R * LDS + KP * W);
  static constexpr size_t bwd_smem_bytes = sizeof(float) * (R * LDS + KP * LDT);
};

// column of this thread's c-th accumulator: c < CJ in the low half, the
// rest the same columns of the high half
template <int D>
__device__ __forceinline__ int column(int tj, int c) {
  using G = Geometry<D>;
  return c < G::CJ ? tj + c * G::JT : D + tj + (c - G::CJ) * G::JT;
}

// rows k0 .. k0+KP of E_b (row-major) -> the panel, as they are
template <int D>
__device__ __forceinline__ void stage_panel(const float* __restrict__ e,
                                            int k0, float* panel) {
  using G = Geometry<D>;
  const float* src = e + static_cast<size_t>(k0) * G::W;
  if constexpr (G::KP * G::W % 4 == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(src);
    float4* s4 = reinterpret_cast<float4*>(panel);
    for (int i = threadIdx.x; i < G::KP * G::W / 4; i += kThreads) s4[i] = g4[i];
  } else {
    for (int i = threadIdx.x; i < G::KP * G::W; i += kThreads) panel[i] = src[i];
  }
}

// columns j0 .. j0+KP of E_b -> the panel transposed: panel[jj][k] =
// E_b[k][j0 + jj], rows of LDT
template <int D>
__device__ __forceinline__ void stage_panel_transposed(
    const float* __restrict__ e, int j0, float* panel) {
  using G = Geometry<D>;
  for (int i = threadIdx.x; i < G::KP * G::W; i += kThreads) {
    const int jj = i % G::KP, k = i / G::KP;
    panel[jj * G::LDT + k] = e[static_cast<size_t>(k) * G::W + j0 + jj];
  }
}

// acc (P x NC) += x[:, k0 .. k0+KP] . panel for this thread's rows and
// columns; the row tile x (R, LDS) and the panel (KP, ld) in shared memory
template <int D, int ld>
__device__ __forceinline__ void panel_product(
    const float* x, int k0, const float* panel,
    float (&acc)[Geometry<D>::P][Geometry<D>::NC], int tj, int rg) {
  using G = Geometry<D>;
  constexpr int NC = G::NC, RG = G::RG, P = G::P, KV = G::KV, LDS = G::LDS;
#pragma unroll 4
  for (int k = 0; k < G::KP; k += KV) {
    float xv[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int off = (p * RG + rg) * LDS + k0 + k;
      if constexpr (KV == 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + off);
        xv[p][0] = v.x; xv[p][1] = v.y; xv[p][2] = v.z; xv[p][3] = v.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < KV; ++kk) xv[p][kk] = x[off + kk];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float m = panel[(k + kk) * ld + column<D>(tj, c)];
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p][c] = fmaf(xv[p][kk], m, acc[p][c]);
      }
    }
  }
}

// ── B3f: forward, primal output and (SAVE) the residuals s and u ─────────

template <int D, bool SAVE>
__global__ void __launch_bounds__(kThreads)
embed_chain_fwd_kernel(const float* __restrict__ e,
                       const float* __restrict__ t, float* __restrict__ out,
                       float* __restrict__ s_out, float* __restrict__ u_out,
                       int nb, int n, float inv_sqrt) {
  using G = Geometry<D>;
  constexpr int W = G::W, CJ = G::CJ, NC = G::NC, RG = G::RG, P = G::P,
                R = G::R, LDS = G::LDS, KP = G::KP;

  extern __shared__ __align__(16) float smem[];
  float* x = smem;                // (R, LDS) the state tile
  float* panel = smem + R * LDS;  // (KP, W) rows of E_b

  const int tj = threadIdx.x % G::JT;
  const int rg = threadIdx.x / G::JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nw = static_cast<size_t>(n) * W;

  // s_0 = inv_sqrt [cos t_0 | sin t_0]
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = p * RG + rg;
    const long long row = row0 + lr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = column<D>(tj, c);
      float v = 0.f;
      if (row < n) {
        float sn, cs;
        sincosf(t[row * W + j], &sn, &cs);
        v = inv_sqrt * (c < CJ ? cs : sn);
        if constexpr (SAVE) s_out[row * W + j] = v;
      }
      x[lr * LDS + j] = v;
    }
  }

  for (int b = 0;; ++b) {
    // u = s . E_b for this thread's P x NC tile, panel by panel
    float acc[P][NC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[p][c] = 0.f;
    // the next phase step's angles, asked for before the product so that
    // their latency hides behind it
    float tv[P][NC];
    if (b < nb - 1) {
      const float* tb = t + static_cast<size_t>(b + 1) * nw;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tv[p][c] = row < n ? tb[row * W + column<D>(tj, c)] : 0.f;
      }
    }
    const float* eb = e + static_cast<size_t>(b) * W * W;
    for (int k0 = 0; k0 < W; k0 += KP) {
      stage_panel<D>(eb, k0, panel);
      __syncthreads();  // the panel and the state tile are written
      panel_product<D, W>(x, k0, panel, acc, tj, rg);
      __syncthreads();  // every thread is done reading them
    }

    if (b == nb - 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            out[row * W + column<D>(tj, c)] = acc[p][c];
        }
      }
      return;
    }

    // s <- cos t (.) u + sin t (.) swap(u), t = t_{b+1}
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
      const long long row = row0 + lr;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int jl = column<D>(tj, c), jh = jl + D;
        float vl = 0.f, vh = 0.f;
        if (row < n) {
          const float ul = acc[p][c], uh = acc[p][CJ + c];
          float snl, csl, snh, csh;
          sincosf(tv[p][c], &snl, &csl);
          sincosf(tv[p][CJ + c], &snh, &csh);
          vl = csl * ul + snl * uh;
          vh = csh * uh + snh * ul;
          if constexpr (SAVE) {
            u_out[static_cast<size_t>(b) * nw + row * W + jl] = ul;
            u_out[static_cast<size_t>(b) * nw + row * W + jh] = uh;
            s_out[static_cast<size_t>(b + 1) * nw + row * W + jl] = vl;
            s_out[static_cast<size_t>(b + 1) * nw + row * W + jh] = vh;
          }
        }
        x[lr * LDS + jl] = vl;
        x[lr * LDS + jh] = vh;
      }
    }
  }
}

// ── B3b: the reverse sweep, tbar and ubar per block ──────────────────────

template <int D>
__global__ void __launch_bounds__(kThreads)
embed_chain_bwd_kernel(const float* __restrict__ e,
                       const float* __restrict__ t,
                       const float* __restrict__ u,
                       const float* __restrict__ g, float* __restrict__ ub,
                       float* __restrict__ tbar, int nb, int n,
                       float inv_sqrt) {
  using G = Geometry<D>;
  constexpr int W = G::W, CJ = G::CJ, NC = G::NC, RG = G::RG, P = G::P,
                R = G::R, LDS = G::LDS, KP = G::KP, LDT = G::LDT;

  extern __shared__ __align__(16) float smem[];
  float* x = smem;                // (R, LDS) the ubar tile
  float* panel = smem + R * LDS;  // (KP, LDT) columns of E_b, transposed

  const int tj = threadIdx.x % G::JT;
  const int rg = threadIdx.x / G::JT;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nw = static_cast<size_t>(n) * W;

  // ubar of the current block for this thread's tile; ubar_{nb-1} = g
  float ubr[P][NC];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long row = row0 + p * RG + rg;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ubr[p][c] = 0.f;
      if (row < n) {
        const long long idx = row * W + column<D>(tj, c);
        ubr[p][c] = g[idx];
        ub[static_cast<size_t>(nb - 1) * nw + idx] = ubr[p][c];
      }
    }
  }

  for (int b = nb - 1;; --b) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        x[(p * RG + rg) * LDS + column<D>(tj, c)] = ubr[p][c];

    // sbar_b = ubar_b . E_b^T: sbar[r, k] = sum_j ubar[r, j] E_b[k, j]
    float sb[P][NC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) sb[p][c] = 0.f;
    // this block's angles and the product before its phase step, asked
    // for before the product so that their latency hides behind it
    const float* tb = t + static_cast<size_t>(b) * nw;
    float tv[P][NC], uv[P][NC];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + p * RG + rg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const long long idx = row * W + column<D>(tj, c);
        tv[p][c] = row < n ? tb[idx] : 0.f;
        uv[p][c] = row < n && b > 0
                       ? u[static_cast<size_t>(b - 1) * nw + idx] : 0.f;
      }
    }
    const float* eb = e + static_cast<size_t>(b) * W * W;
    for (int j0 = 0; j0 < W; j0 += KP) {
      stage_panel_transposed<D>(eb, j0, panel);
      __syncthreads();  // the panel and the ubar tile are written
      panel_product<D, LDT>(x, j0, panel, sb, tj, rg);
      __syncthreads();  // every thread is done reading them
    }

    float* tbb = tbar + static_cast<size_t>(b) * nw;
    if (b == 0) {
      // s_0 = inv_sqrt [cos t_0 | sin t_0]
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const long long idx = row * W + column<D>(tj, c);
            float sn, cs;
            sincosf(tv[p][c], &sn, &cs);
            tbb[idx] = sb[p][c] * inv_sqrt * (c < CJ ? -sn : cs);
          }
        }
      }
      return;
    }

    // s_b = cos t_b (.) u_{b-1} + sin t_b (.) swap(u_{b-1}):
    //   tbar_b     = sbar (.) (cos t (.) swap(u) - sin t (.) u)
    //   ubar_{b-1} = cos t (.) sbar + swap(sin t (.) sbar)
    float* ubp = ub + static_cast<size_t>(b - 1) * nw;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + p * RG + rg;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        ubr[p][c] = ubr[p][CJ + c] = 0.f;
        if (row < n) {
          const long long il = row * W + column<D>(tj, c), ih = il + D;
          float snl, csl, snh, csh;
          sincosf(tv[p][c], &snl, &csl);
          sincosf(tv[p][CJ + c], &snh, &csh);
          const float ul = uv[p][c], uh = uv[p][CJ + c];
          const float sl = sb[p][c], sh = sb[p][CJ + c];
          tbb[il] = sl * (csl * uh - snl * ul);
          tbb[ih] = sh * (csh * ul - snh * uh);
          ubr[p][c] = csl * sl + snh * sh;
          ubr[p][CJ + c] = csh * sh + snl * sl;
          ubp[il] = ubr[p][c];
          ubp[ih] = ubr[p][CJ + c];
        }
      }
    }
  }
}

// ── B3b: Ebar_b = s_b^T . ubar_b over one slice of batch rows ────────────

template <int D> struct EbarGeometry {
  static constexpr int W = 2 * D;
  static constexpr int TJ = W < 32 ? W : 32;     // output tile side
  static constexpr int TILES = W / TJ;           // tiles along each side
  static constexpr int G = kThreads / TJ;        // thread groups along k
  static constexpr int KG = G < TJ ? G : TJ;     // distinct k per group pass
  static constexpr int KQ = TJ / KG;             // k values per thread
  static constexpr int RS = G / KG;              // threads sharing one entry
};

template <int D>
__global__ void __launch_bounds__(kThreads)
embed_chain_ebar_kernel(const float* __restrict__ s,
                        const float* __restrict__ ub, float* __restrict__ dst,
                        int nb, int n, int rows_per_split) {
  using G = EbarGeometry<D>;
  constexpr int W = G::W, TJ = G::TJ, TILES = G::TILES, KG = G::KG,
                KQ = G::KQ, RS = G::RS;
  __shared__ float red[kThreads];

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
  const size_t blk = static_cast<size_t>(b) * n * W;

  float acc[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) acc[q] = 0.f;
  for (long long r = r_begin + rs; r < r_end; r += RS) {
    const float uv = ub[blk + r * W + j];
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      acc[q] = fmaf(s[blk + r * W + k0 + kq + KG * q], uv, acc[q]);
  }

  const size_t out0 = (static_cast<size_t>(split) * nb + b) * W * W;
  if constexpr (RS == 1) {
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      dst[out0 + static_cast<size_t>(k0 + kq + KG * q) * W + j] = acc[q];
  } else {
    // KQ == 1: RS threads hold partial sums of one entry; add them in order
    red[threadIdx.x] = acc[0];
    __syncthreads();
    if (rs == 0) {
      float sum = 0.f;
      for (int i = 0; i < RS; ++i) sum += red[(i * KG + kq) * TJ + lane];
      dst[out0 + static_cast<size_t>(k0 + kq) * W + j] = sum;
    }
  }
}

// out[i] = sum over splits s, in order, of part[s][i]
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int splits, size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * count + i];
    out[i] = sum;
  }
}

template <int D>
cudaError_t launch_forward(const float* e, const float* t, float* out,
                           float* s_out, float* u_out, int nb, int n,
                           cudaStream_t stream) {
  using G = Geometry<D>;
  const int smem = static_cast<int>(G::fwd_smem_bytes);
  const auto kernel = s_out != nullptr ? embed_chain_fwd_kernel<D, true>
                                       : embed_chain_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + G::R - 1) / G::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, kThreads, smem, stream>>>(e, t, out, s_out, u_out, nb, n,
                                           inv_sqrt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* e, const float* t, const float* s,
                            const float* u, const float* g, float* ub,
                            float* part, float* ebar, float* tbar, int nb,
                            int n, int splits, cudaStream_t stream) {
  using G = Geometry<D>;
  using EG = EbarGeometry<D>;
  const int smem = static_cast<int>(G::bwd_smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      embed_chain_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + G::R - 1) / G::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  embed_chain_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      e, t, u, g, ub, tbar, nb, n, inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 egrid(static_cast<unsigned>(nb * EG::TILES * EG::TILES),
                   static_cast<unsigned>(splits));
  embed_chain_ebar_kernel<D><<<egrid, kThreads, 0, stream>>>(
      s, ub, splits > 1 ? part : ebar, nb, n, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t count = static_cast<size_t>(nb) * G::W * G::W;
  const size_t blocks = (count + kThreads - 1) / kThreads;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                      kThreads, 0, stream>>>(part, ebar, splits, count);
  return cudaGetLastError();
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_embed.py).  Each takes device pointers of
// contiguous fp32 tensors and the stream to launch on, and returns the
// cudaError_t of its launches (0 on success).  d, half the row's width,
// must be a power of two in [1, 128]; nb >= 1, n >= 1.

// B3f.  s_out (nb, n, 2d) and u_out (nb-1, n, 2d): the residuals of the
// backward, written when not null (both or neither).
extern "C" int embed_chain_forward(const float* e, const float* t, float* out,
                                   float* s_out, float* u_out, int nb, int n,
                                   int d, void* stream) {
  if (nb < 1 || n < 1 || (s_out == nullptr) != (u_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMBED_FWD(D)                                                     \
  case D:                                                                \
    return launch_forward<D>(e, t, out, s_out, u_out, nb, n, st);
  switch (d) {
    EMBED_FWD(1) EMBED_FWD(2) EMBED_FWD(4) EMBED_FWD(8) EMBED_FWD(16)
    EMBED_FWD(32) EMBED_FWD(64) EMBED_FWD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EMBED_FWD
}

// B3b.  g (n, 2d): the output's cotangent.  ub (nb, n, 2d): scratch for
// ubar.  part (splits, nb, 2d, 2d): scratch for the slices of Ebar, used
// when splits > 1.  Writes ebar (nb, 2d, 2d) and tbar (nb, n, 2d).
extern "C" int embed_chain_backward(const float* e, const float* t,
                                    const float* s, const float* u,
                                    const float* g, float* ub, float* part,
                                    float* ebar, float* tbar, int nb, int n,
                                    int d, int splits, void* stream) {
  if (nb < 1 || n < 1 || splits < 1 || splits > n ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMBED_BWD(D)                                                     \
  case D:                                                                \
    return launch_backward<D>(e, t, s, u, g, ub, part, ebar, tbar, nb,   \
                              n, splits, st);
  switch (d) {
    EMBED_BWD(1) EMBED_BWD(2) EMBED_BWD(4) EMBED_BWD(8) EMBED_BWD(16)
    EMBED_BWD(32) EMBED_BWD(64) EMBED_BWD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EMBED_BWD
}

extern "C" const char* embed_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
