// Block-chain forward of the HEA circuit, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel quanonet_tpu/ops/pallas_hea.py:_fwd_kernel (the
// forward of _make_block_chain, entered from forward_pallas), primal output
// only:
//
//     s_1 = D(x_1) / sqrt(D)
//     s   <- D(x_{b+1}) (.) (s . M_b^T)      for b = 0 .. nb-2
//     out =  s . M_{nb-1}^T
//
// with D(x_b)_k = exp(-i phi_{b,k}), all in split (re, im) fp32.  Inputs:
// mt_r, mt_i (nb, D, D) = M_b^T; phi (nb, N, D) raw phases.  Outputs:
// out_r, out_i (N, D).  Plain version: quanonet_torch/ops/hea.chain_dense.
//
// What bounds it: nb*N*D^2 complex MACs, which need 6 flops each in the
// three-product (Karatsuba) form of the TPU kernel, against
// ~(nb*N*D + 2*nb*D^2 + 2*N*D)*4 bytes, dominated by the phase tensor: about
// 1.5*D flops per byte.  The H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s)
// is 20 flops per byte, so the chain is bound by fp32 operations at D >= 16
// (50 flops per byte at the flagship's D = 32) and by bytes at D <= 8.  This
// kernel spends 4 FMAs (8 flops) per complex MAC, a third more than that.
//
// Design: one CTA owns a tile of R batch rows for the whole chain, so the
// state never leaves the SM between blocks.  Per block the CTA stages
// M_b^T (re, im) in shared memory; the state tile lives in shared memory.
// A thread owns CJ amplitudes j (lanes on consecutive j, so the matrix reads
// are conflict-free) for P rows, and accumulates u = s . M_b^T as a P x CJ
// register tile: per k it reads CJ matrix pairs and P state pairs, which
// are warp broadcasts (float4 over four k at a time).  The phase
// exp(-i phi) is taken in-kernel with the accurate sincosf: |phi| reaches
// tens of radians, so neither __sincosf nor --use_fast_math is used.
// Ragged batch tiles are masked: rows >= N carry a zero state and are never
// read from phi or written.  No tensor cores, no TMA: plain fp32, simple.

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
  static constexpr size_t smem_bytes = sizeof(float) * (2 * D * D + 2 * R * D);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
hea_chain_fwd_kernel(const float* __restrict__ mt_r,
                     const float* __restrict__ mt_i,
                     const float* __restrict__ phi,
                     float* __restrict__ out_r, float* __restrict__ out_i,
                     int nb, int n, float inv_sqrt) {
  using G = Geometry<D>;
  constexpr int JT = G::JT, CJ = G::CJ, RG = G::RG, P = G::P, R = G::R,
                KV = G::KV;

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
      }
      s_r[lr * D + j] = vr;
      s_i[lr * D + j] = vi;
    }
  }
  stage_matrix<D>(mt_r, mt_i, m_r, m_i);
  __syncthreads();

  for (int b = 0;; ++b) {
    float ar[P][CJ], ai[P][CJ];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < CJ; ++c) ar[p][c] = ai[p][c] = 0.f;

    // u = s . M_b^T for this thread's P x CJ tile
#pragma unroll 8
    for (int k = 0; k < D; k += KV) {
      float xr[P][KV], xi[P][KV];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int off = (p * RG + rg) * D + k;
        if constexpr (KV == 4) {
          const float4 vr = *reinterpret_cast<const float4*>(s_r + off);
          const float4 vi = *reinterpret_cast<const float4*>(s_i + off);
          xr[p][0] = vr.x; xr[p][1] = vr.y; xr[p][2] = vr.z; xr[p][3] = vr.w;
          xi[p][0] = vi.x; xi[p][1] = vi.y; xi[p][2] = vi.z; xi[p][3] = vi.w;
        } else {
#pragma unroll
          for (int kk = 0; kk < KV; ++kk) {
            xr[p][kk] = s_r[off + kk];
            xi[p][kk] = s_i[off + kk];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const float mr = m_r[(k + kk) * D + tj + c * JT];
          const float mi = m_i[(k + kk) * D + tj + c * JT];
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
    const float* ph = phi + static_cast<size_t>(b + 1) * nd;
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

template <int D>
cudaError_t launch(const float* mt_r, const float* mt_i, const float* phi,
                   float* out_r, float* out_i, int nb, int n,
                   cudaStream_t stream) {
  using G = Geometry<D>;
  const int smem = static_cast<int>(G::smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      hea_chain_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + G::R - 1) / G::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  hea_chain_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      mt_r, mt_i, phi, out_r, out_i, nb, n, inv_sqrt);
  return cudaGetLastError();
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_hea.py).  Takes
// device pointers of contiguous fp32 tensors and the stream to launch on;
// returns the cudaError_t of the launch (0 on success).  d must be a power
// of two in [2, 128], nb >= 1, n >= 1.
extern "C" int hea_chain_forward(const float* mt_r, const float* mt_i,
                                 const float* phi, float* out_r,
                                 float* out_i, int nb, int n, int d,
                                 void* stream) {
  if (nb < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch<2>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 4: return launch<4>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 8: return launch<8>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 16: return launch<16>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 32: return launch<32>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 64: return launch<64>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    case 128: return launch<128>(mt_r, mt_i, phi, out_r, out_i, nb, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* hea_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
