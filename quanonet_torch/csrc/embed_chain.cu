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
//   (N, W); with residuals also u (max(nb-1, 1), N, W), each product before
//   its phase step.  The TPU kernel also saves each block's input row s;
//   here s_b is rebuilt where the backward needs it, one phase step from
//   u_{b-1} (s_0 from t_0 alone), which halves the residual bytes.  (u
//   cannot be recovered from s_{b+1} instead: for a general t the phase
//   step's 2x2 map has determinant cos(t_lo + t_hi), which vanishes.)
//
//   B3b  _bwd_kernel, the reverse sweep, here as two launches (three when
//   the batch is split into slices):
//
//     embed_chain_bwd_kernel   ubar_{nb-1} = g;  for b = nb-1 .. 0:
//                                sbar_b = ubar_b . E_b^T
//                                tbar_b, ubar_{b-1} from sbar_b, u_{b-1}, t_b
//     embed_chain_ebar_kernel  Ebar_b = s_b^T . ubar_b, summed over the batch
//                              rows of one slice, s_b rebuilt from u_{b-1}
//                              and t_b
//     sum_splits_kernel        the slices summed in a fixed order (N > 1,024)
//
//   Plain versions: quanonet_torch/ops/cuda_embed.py chain_embed (primal),
//   chain_embed_saved (residuals), chain_embed_backward (backward).
//
// What bounds them.  Each pass does nb*N*W^2 real MACs per product (the
// forward one, the backward three: two in the sweep's products and the
// outer product Ebar), 2 flops each, against about 4*nb*N*W*k bytes with
// k = 1 (forward: t), 2 (with u saved), 3 (backward: t, u read, tbar
// written): W/2, W/4 and W/2 flops per byte, so at the flagship's W = 64
// and the H100's fp32 ridge (20 flops per byte) the primal forward and the
// backward are bound by operations, the residual forward by bytes; and
// every pass takes a sincosf per row, column and block.  At the training batch
// (N = 100) no bound is near: a pass is nb = 60 dependent block steps of a
// few rows each, so what bounds it is one block step's latency on one SM —
// the product's shared-memory reads and FMA chains, the instructions that
// ask for the next panel's copies, the phase step's sincosf, the barrier —
// and at W = 128 and 256 the stream of E_b (64 and 256 KB a block) from L2
// into each SM.
//
// Design.  Forward and sweep: one CTA owns a tile of R batch rows for the
// whole chain, so the state (forward) and ubar (backward) never leave the
// SM between blocks.  A thread owns P rows and CJ column pairs (j, j + d),
// so both operands of the phase step, which crosses the halves of the row,
// are at hand; with KS > 1 the KS lanes of one (rows, pairs) each take a
// slice of every product's depth, add their partial sums by warp
// shuffles, and each finishes CJ / KS of the pairs (its phase step and
// stores), so that a row of the training batch has a warp of its own and
// each lane reads E_b as float4 (CJ = 4).  The launch geometry (threads,
// CJ, P, KS, hence R) is one of three tiles a width (EMBED_TILES below,
// mirrored by cuda_embed.TILES; cuda_embed.embed_geometry picks the
// largest tile that still gives half as many CTAs as SMs, else the
// smallest).  E streams through a ring of NS = 4 panels in shared memory,
// asked for with cp.async (16 B) NS - 1 panels ahead and kept in flight
// across block boundaries, so no block step waits on L2: a panel is E_b
// whole up to W = 64, and 64 (W = 128) or 32 (W = 256) of its rows
// (forward, the product's depth) or columns (sweep) above, at most 32 KB.
// The forward asks for the next panel before its product; the sweep
// spreads those instructions over its product's k steps.  The row tile is
// double-buffered by block parity, so a block step has one barrier a panel
// and no other.  The forward reads E_b along its rows, a thread's CJ
// columns contiguous; the sweep reads E_b in place, sbar[r, k] = sum_j
// ubar[r, j] E_b[k, j], along the rows k of a column panel stored with
// rows padded by four floats, so that lanes on consecutive k (a thread's
// outputs interleaved at stride JT) hit distinct banks.  The phase step's
// operands (the next t; in the sweep t_b and u_{b-1}) are asked for before
// the product and used after it.  Ebar is a sum over the batch, which the
// TPU kernel got by running the whole batch in one program; here the sweep
// writes ubar (nb, N, W) to scratch, and the Ebar kernel gives each (block,
// output tile of at most 64 x 64, slice of rows) one CTA that stages
// chunks of t_b, u_{b-1} (at the tile's columns and at their swap
// partners) and ubar_b rows through a ring of four chunks in shared
// memory (cp.async, three chunks in flight), rebuilds s_b from them in
// shared memory one chunk ahead of the product that reads it (one barrier
// a chunk), and accumulates a register tile of outputs over the rows in a
// fixed order; a batch of up to 1,024 rows is one slice, so the
// training batch's backward is two launches; above, a third kernel adds
// the slices in slice order.  No atomics: two calls on equal inputs give
// equal bits (the shuffle sums too: each step adds two values, the same
// float in either order).  The primal and residual forward share one
// geometry and one summation order for a given (N, d), so their outputs
// are equal bit for bit.  The phases are taken with the accurate sincosf:
// |t| reaches tens of radians over up to 60 blocks, so neither __sincosf
// nor --use_fast_math is used.  Ragged batch tiles are masked: rows >= N
// carry zeros and are never read or written.  No tensor cores, no TF32:
// plain fp32 FMAs.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>

// The launch geometries, X(d, tile, threads, CJ, P, KS), tiles in order of
// growing row tile R = threads / (d / CJ * KS) * P.  quanonet_torch/ops/
// cuda_embed.py holds the same table (its tests read this one).
#define EMBED_TILES(X)                                                      \
  X(1, 0, 32, 1, 1, 1) X(1, 1, 128, 1, 2, 1) X(1, 2, 256, 1, 2, 1)          \
  X(2, 0, 32, 1, 1, 1) X(2, 1, 128, 1, 2, 1) X(2, 2, 256, 2, 2, 1)          \
  X(4, 0, 32, 1, 1, 1) X(4, 1, 128, 2, 2, 1) X(4, 2, 256, 4, 2, 1)          \
  X(8, 0, 64, 1, 1, 1) X(8, 1, 128, 2, 2, 1) X(8, 2, 256, 4, 2, 1)          \
  X(16, 0, 32, 4, 1, 4) X(16, 1, 128, 4, 1, 4) X(16, 2, 256, 4, 4, 1)       \
  X(32, 0, 32, 4, 1, 4) X(32, 1, 256, 4, 1, 4) X(32, 2, 256, 2, 2, 1)       \
  X(64, 0, 64, 4, 1, 2) X(64, 1, 256, 4, 1, 2) X(64, 2, 256, 4, 4, 2)       \
  X(128, 0, 256, 1, 2, 1) X(128, 1, 256, 2, 4, 1) X(128, 2, 256, 4, 4, 1)

namespace {

// A thread owns P rows and CJ column pairs (j, j + d) and, when KS > 1, the
// kg-th of KS slices of each product's depth: the KS threads of one (rows,
// columns) are lanes of one warp, and add their partial sums by shuffles.
template <int D, int NT, int CJ, int P, int KS_> struct Tile {
  static constexpr int W = 2 * D;                 // row width
  static constexpr int JT = D / CJ;               // threads along a half row
  static constexpr int KS = KS_;                  // slices of the depth
  static constexpr int LANES = JT * KS;           // threads of a row group
  static constexpr int RG = NT / LANES;           // row groups per CTA
  static constexpr int R = RG * P;                // batch rows per CTA
  static constexpr int CO = CJ / KS;              // pairs a thread finishes
  static constexpr int KV = W < 4 ? W : 4;        // k values per row-tile read
  static constexpr int LD = W < 4 ? W : W + 4;    // padded row of the row tile
  static constexpr int KP = W * W <= 8192 ? W : 8192 / W;  // panel depth
  static constexpr int KQ = KP / KS;              // a thread's depth a panel
  static constexpr int LDP = KP < 4 ? KP : KP + 4;  // padded row, sweep panel
  static constexpr int PPB = W / KP;              // panels a block
  static constexpr int NS = 4;                    // panels in the ring
  // k steps of a product unrolled: all of them for a small register tile
  // (latency-bound: every load in flight at once), else four
  static constexpr int UNROLL = P * CJ <= 4 ? KQ / KV : 4;
  static constexpr int FWD_SLOT = KP * W;         // floats of a forward panel
  static constexpr int BWD_SLOT = W * LDP;        // floats of a sweep panel
  static constexpr size_t fwd_smem_bytes =
      sizeof(float) * (2 * R * LD + NS * FWD_SLOT);
  static constexpr size_t bwd_smem_bytes =
      sizeof(float) * (2 * R * LD + NS * BWD_SLOT);
  static_assert(JT >= 1 && NT % LANES == 0, "a tile's threads cover its rows");
  static_assert(KS == 1 || (32 % LANES == 0 && CJ % KS == 0),
                "a depth split lies within a warp, each lane finishing pairs");
  static_assert(KQ % KV == 0 && W % KP == 0, "panels hold whole k steps");
};

// ── asynchronous copies and vector accesses ──────────────────────────────

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem) : "memory");
}

// BYTES (4, 8 or 16) bytes, zeros when !valid (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(float* smem, const float* gmem,
                                               bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(size) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES), "r"(size) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
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

// ── the ring of E panels ─────────────────────────────────────────────────

// This thread's share of the copy of one panel into its slot, as NT-strided
// 16-byte pieces, so that the sweep's product can spread the copy over its
// k steps.
// Forward panel q: block q / PPB, rows k0 = (q % PPB) * KP .. k0 + KP of
// E_b, whole rows, as they lie (KP * W contiguous floats).
template <class T, int NT> struct FwdPanel {
  static constexpr int PIECES = T::FWD_SLOT / 4;
  static constexpr int PER_THREAD = (PIECES + NT - 1) / NT;
  const float* src;
  float* slot;
  __device__ FwdPanel(const float* e, int q, float* dst)
      : src(e + static_cast<size_t>(q / T::PPB) * T::W * T::W +
            (q % T::PPB) * T::KP * T::W),
        slot(dst) {}
  __device__ void piece(int i) const {
    const int pc = threadIdx.x + i * NT;
    if (PIECES % NT == 0 || pc < PIECES)
      cp_async16(slot + 4 * pc, src + 4 * pc);
  }
  __device__ void all() const {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) piece(i);
  }
};

// Sweep panel q: block nb-1 - q / PPB, columns j0 = (q % PPB) * KP .. j0 +
// KP of E_b, every row k, into rows of LDP floats (at W = 2 the whole 2 x 2
// matrix in one piece)
template <class T, int NT> struct BwdPanel {
  static constexpr int PER_ROW = T::KP / 4;
  static constexpr int PIECES = T::W < 4 ? 1 : T::W * PER_ROW;
  static constexpr int PER_THREAD = (PIECES + NT - 1) / NT;
  const float* src;
  float* slot;
  __device__ BwdPanel(const float* e, int nb, int q, float* dst)
      : src(e + static_cast<size_t>(nb - 1 - q / T::PPB) * T::W * T::W +
            (q % T::PPB) * T::KP),
        slot(dst) {}
  __device__ void piece(int i) const {
    const int pc = threadIdx.x + i * NT;
    if constexpr (T::W < 4) {
      if (pc == 0) cp_async16(slot, src);
    } else if (PIECES % NT == 0 || pc < PIECES) {
      const int k = pc / PER_ROW, v = pc % PER_ROW;
      cp_async16(slot + k * T::LDP + 4 * v, src + k * T::W + 4 * v);
    }
  }
  __device__ void all() const {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) piece(i);
  }
};

// the pieces of ``copy`` due at k step s of a product of STEPS steps (none
// when ``on`` is false): spread evenly, all of them by the last step
template <int STEPS, class C>
__device__ __forceinline__ void copy_share(const C& copy, bool on, int s) {
  constexpr int PS = (C::PER_THREAD + STEPS - 1) / STEPS;
#pragma unroll
  for (int i = 0; i < PS; ++i)
    if (on && s * PS + i < C::PER_THREAD) copy.piece(s * PS + i);
}

// ── the two products of a block step ─────────────────────────────────────

// (al, ah) += x[:, k0 .. k0+KQ] . panel rows for this thread's rows p * RG +
// rg and columns c0 + c (al) and D + c0 + c (ah): the row tile x (R, LD) and
// the panel's rows (KQ of them, W wide) in shared memory, read along rows
template <class T, int D, int CJ, int P>
__device__ __forceinline__ void fwd_product(
    const float* x, int k0, const float* panel, float (&al)[P][CJ],
    float (&ah)[P][CJ], int c0, int rg) {
  constexpr int KV = T::KV, LD = T::LD, RG = T::RG, W = T::W;
#pragma unroll (T::UNROLL)
  for (int k = 0; k < T::KQ; k += KV) {
    float xv[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_vec<KV>(x + (p * RG + rg) * LD + k0 + k, xv[p]);
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      float ml[CJ], mh[CJ];
      load_vec<CJ>(panel + (k + kk) * W + c0, ml);
      load_vec<CJ>(panel + (k + kk) * W + D + c0, mh);
#pragma unroll
      for (int c = 0; c < CJ; ++c)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          al[p][c] = fmaf(xv[p][kk], ml[c], al[p][c]);
          ah[p][c] = fmaf(xv[p][kk], mh[c], ah[p][c]);
        }
    }
  }
}

// (sl, sh) += ubar[:, j0 .. j0+KQ] . panel^T for this thread's rows and
// outputs k = tk + c * JT (sl) and D + tk + c * JT (sh): sbar[r, k] =
// sum_j ubar[r, j] E_b[k, j], the tile ubar (R, LD) and the column panel
// (W, LDP; its columns j0 - jp .. from jp) in shared memory, both read
// along j; the next panel's copy is asked for on the way
template <class T, int D, int CJ, int P, class C>
__device__ __forceinline__ void bwd_product(
    const float* x, int j0, const float* panel, int jp, float (&sl)[P][CJ],
    float (&sh)[P][CJ], int tk, int rg, const C& copy, bool copy_on) {
  constexpr int KV = T::KV, LD = T::LD, LDP = T::LDP, RG = T::RG,
                JT = T::JT;
#pragma unroll (T::UNROLL)
  for (int j = 0; j < T::KQ; j += KV) {
    copy_share<T::KQ / KV>(copy, copy_on, j / KV);
    float uv[P][KV];
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_vec<KV>(x + (p * RG + rg) * LD + j0 + j, uv[p]);
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      float ml[KV], mh[KV];
      load_vec<KV>(panel + (tk + c * JT) * LDP + jp + j, ml);
      load_vec<KV>(panel + (D + tk + c * JT) * LDP + jp + j, mh);
#pragma unroll
      for (int jj = 0; jj < KV; ++jj)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sl[p][c] = fmaf(uv[p][jj], ml[jj], sl[p][c]);
          sh[p][c] = fmaf(uv[p][jj], mh[jj], sh[p][c]);
        }
    }
  }
}

// The KS partial sums of each of a thread's values, added across the lanes
// of its depth split (lanes JT apart); every lane ends with the same bits
// (each step adds two values, in either order the same float)
template <class T, int P, int CJ>
__device__ __forceinline__ void add_depth_slices(float (&a)[P][CJ]) {
  if constexpr (T::KS > 1) {
#pragma unroll
    for (int m = T::JT; m < T::LANES; m <<= 1)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < CJ; ++c)
          a[p][c] += __shfl_xor_sync(0xffffffffu, a[p][c], m);
  }
}

// v[o * KS + kg]: the pair this lane finishes among the CJ it summed
template <int KS, int CJ>
__device__ __forceinline__ float pick(const float (&v)[CJ], int o, int kg) {
  float r = v[o * KS];
#pragma unroll
  for (int g = 1; g < KS; ++g)
    if (kg == g) r = v[o * KS + g];
  return r;
}

// ── B3f: forward, primal output and (SAVE) the residual u ───────────────

template <int D, int NT, int CJ, int P, int KS, bool SAVE>
__global__ void __launch_bounds__(NT)
embed_chain_fwd_kernel(const float* __restrict__ e,
                       const float* __restrict__ t, float* __restrict__ out,
                       float* __restrict__ u_out, int nb, int n,
                       float inv_sqrt) {
  using T = Tile<D, NT, CJ, P, KS>;
  constexpr int W = T::W, JT = T::JT, RG = T::RG, R = T::R, LD = T::LD,
                KP = T::KP, KQ = T::KQ, PPB = T::PPB, NS = T::NS,
                CO = T::CO, SLOT = T::FWD_SLOT;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // 2 x (R, LD): the state tile by parity
  float* ring = smem + 2 * R * LD;  // NS x (KP, W): rows of E

  const int tj = threadIdx.x % JT;
  const int kg = threadIdx.x / JT % KS;  // depth slice
  const int rg = threadIdx.x / T::LANES;
  const int c0 = tj * CJ;           // columns c0 .. c0+CJ and D + c0 ..
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nw = static_cast<size_t>(n) * W;
  const int panels = nb * PPB;

  // the first NS - 1 panels asked for first: one cp.async group a panel
  for (int q = 0; q < NS - 1; ++q) {
    if (q < panels) FwdPanel<T, NT>(e, q, ring + q * SLOT).all();
    cp_async_commit();
  }

  // the columns this lane finishes: pairs o * KS + kg, o < CO
  auto col = [&](int o) { return c0 + o * KS + kg; };

  // s_0 = inv_sqrt [cos t_0 | sin t_0]
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = p * RG + rg;
    const long long row = row0 + lr;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const int j = col(o);
      float vl = 0.f, vh = 0.f;
      if (row < n) {
        float sn, cs;
        sincosf(t[row * W + j], &sn, &cs);
        vl = inv_sqrt * cs;
        sincosf(t[row * W + D + j], &sn, &cs);
        vh = inv_sqrt * sn;
      }
      xs[lr * LD + j] = vl;
      xs[lr * LD + D + j] = vh;
    }
  }

  for (int b = 0;; ++b) {
    const float* x = xs + (b & 1) * R * LD;
    // the next phase step's angles, asked for before the product so that
    // their latency hides behind it
    float tl[P][CO], th[P][CO];
    if (b + 1 < nb) {
      const float* tb = t + static_cast<size_t>(b + 1) * nw;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          tl[p][o] = row < n ? tb[row * W + col(o)] : 0.f;
          th[p][o] = row < n ? tb[row * W + D + col(o)] : 0.f;
        }
      }
    }

    // u = s . E_b for this thread's P x 2CJ tile and depth slice, panel by
    // panel, then the slices added
    float al[P][CJ], ah[P][CJ];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < CJ; ++c) al[p][c] = ah[p][c] = 0.f;
    for (int pp = 0; pp < PPB; ++pp) {
      const int q = b * PPB + pp;
      cp_async_wait(NS - 2);  // panel q has landed (later ones may not)
      __syncthreads();        // ... for every thread; the state tile is
                              // written, and panel q-1's slot is free
      // the next panel is asked for before the product (spread over the
      // product's k steps measured slower here)
      const int ahead = q + NS - 1;
      if (ahead < panels)
        FwdPanel<T, NT>(e, ahead, ring + (ahead % NS) * SLOT).all();
      cp_async_commit();
      fwd_product<T, D, CJ, P>(x, pp * KP + kg * KQ,
                               ring + (q % NS) * SLOT + kg * KQ * W, al, ah,
                               c0, rg);
    }
    add_depth_slices<T>(al);
    add_depth_slices<T>(ah);

    if (b == nb - 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            out[row * W + col(o)] = pick<KS>(al[p], o, kg);
            out[row * W + D + col(o)] = pick<KS>(ah[p], o, kg);
          }
        }
      }
      return;
    }

    // s <- cos t (.) u + sin t (.) swap(u), t = t_{b+1}, into the other
    // state tile
    float* xn = xs + ((b + 1) & 1) * R * LD;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
      const long long row = row0 + lr;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const int j = col(o);
        const float ul = pick<KS>(al[p], o, kg), uh = pick<KS>(ah[p], o, kg);
        float vl = 0.f, vh = 0.f;
        if (row < n) {
          float snl, csl, snh, csh;
          sincosf(tl[p][o], &snl, &csl);
          sincosf(th[p][o], &snh, &csh);
          vl = csl * ul + snl * uh;
          vh = csh * uh + snh * ul;
          if constexpr (SAVE) {
            float* ub = u_out + static_cast<size_t>(b) * nw + row * W;
            ub[j] = ul;
            ub[D + j] = uh;
          }
        }
        xn[lr * LD + j] = vl;
        xn[lr * LD + D + j] = vh;
      }
    }
  }
}

// ── B3b: the reverse sweep, tbar and ubar per block ──────────────────────

template <int D, int NT, int CJ, int P, int KS>
__global__ void __launch_bounds__(NT)
embed_chain_bwd_kernel(const float* __restrict__ e,
                       const float* __restrict__ t,
                       const float* __restrict__ u,
                       const float* __restrict__ g, float* __restrict__ ub,
                       float* __restrict__ tbar, int nb, int n,
                       float inv_sqrt) {
  using T = Tile<D, NT, CJ, P, KS>;
  constexpr int W = T::W, JT = T::JT, RG = T::RG, R = T::R, LD = T::LD,
                KP = T::KP, KQ = T::KQ, PPB = T::PPB, NS = T::NS,
                CO = T::CO, SLOT = T::BWD_SLOT;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // 2 x (R, LD): the ubar tile by parity
  float* ring = smem + 2 * R * LD;  // NS x (W, LDP): columns of E

  const int tk = threadIdx.x % JT;  // outputs k = tk + c * JT and D + k
  const int kg = threadIdx.x / JT % KS;  // depth slice
  const int rg = threadIdx.x / T::LANES;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t nw = static_cast<size_t>(n) * W;
  const int panels = nb * PPB;

  for (int q = 0; q < NS - 1; ++q) {
    if (q < panels) BwdPanel<T, NT>(e, nb, q, ring + q * SLOT).all();
    cp_async_commit();
  }

  // the columns this lane finishes: outputs of pairs o * KS + kg, o < CO
  auto col = [&](int o) { return tk + (o * KS + kg) * JT; };

  // ubar of the current block for this lane's pairs; ubar_{nb-1} = g
  float al[P][CO], ah[P][CO];
  const size_t last = static_cast<size_t>(nb - 1) * nw;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long row = row0 + p * RG + rg;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const long long il = row * W + col(o), ih = il + D;
      al[p][o] = ah[p][o] = 0.f;
      if (row < n) {
        al[p][o] = g[il];
        ah[p][o] = g[ih];
        ub[last + il] = al[p][o];
        ub[last + ih] = ah[p][o];
      }
    }
  }

  for (int i = 0;; ++i) {
    const int b = nb - 1 - i;
    float* x = xs + (i & 1) * R * LD;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int lr = p * RG + rg;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        x[lr * LD + col(o)] = al[p][o];
        x[lr * LD + D + col(o)] = ah[p][o];
      }
    }

    // this block's angles and the product before its phase step, asked
    // for before the product so that their latency hides behind it
    const float* tb = t + static_cast<size_t>(b) * nw;
    const float* ubm = u + static_cast<size_t>(b > 0 ? b - 1 : 0) * nw;
    float tl[P][CO], th[P][CO], ul[P][CO], uh[P][CO];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + p * RG + rg;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const long long il = row * W + col(o), ih = il + D;
        tl[p][o] = th[p][o] = ul[p][o] = uh[p][o] = 0.f;
        if (row < n) {
          tl[p][o] = tb[il];
          th[p][o] = tb[ih];
          if (b > 0) {
            ul[p][o] = ubm[il];
            uh[p][o] = ubm[ih];
          }
        }
      }
    }

    // sbar_b = ubar_b . E_b^T for this thread's depth slice, panel by panel
    // of E_b's columns, then the slices added
    float sl[P][CJ], sh[P][CJ];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < CJ; ++c) sl[p][c] = sh[p][c] = 0.f;
    for (int pp = 0; pp < PPB; ++pp) {
      const int q = i * PPB + pp;
      cp_async_wait(NS - 2);  // panel q has landed (later ones may not)
      __syncthreads();        // ... for every thread; the ubar tile is
                              // written, and panel q-1's slot is free
      // the next panel's copy asked for on the way through the product, in
      // the instruction slots its shared-memory reads leave free
      const int ahead = q + NS - 1;
      const BwdPanel<T, NT> next(e, nb, ahead < panels ? ahead : q,
                                 ring + (ahead % NS) * SLOT);
      bwd_product<T, D, CJ, P>(x, pp * KP + kg * KQ, ring + (q % NS) * SLOT,
                               kg * KQ, sl, sh, tk, rg, next, ahead < panels);
      cp_async_commit();
    }
    add_depth_slices<T>(sl);
    add_depth_slices<T>(sh);

    float* tbb = tbar + static_cast<size_t>(b) * nw;
    if (b == 0) {
      // s_0 = inv_sqrt [cos t_0 | sin t_0]
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = row0 + p * RG + rg;
        if (row < n) {
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const long long il = row * W + col(o);
            float sn, cs;
            sincosf(tl[p][o], &sn, &cs);
            tbb[il] = pick<KS>(sl[p], o, kg) * inv_sqrt * -sn;
            sincosf(th[p][o], &sn, &cs);
            tbb[il + D] = pick<KS>(sh[p], o, kg) * inv_sqrt * cs;
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
      for (int o = 0; o < CO; ++o) {
        al[p][o] = ah[p][o] = 0.f;
        if (row < n) {
          const long long il = row * W + col(o), ih = il + D;
          float snl, csl, snh, csh;
          sincosf(tl[p][o], &snl, &csl);
          sincosf(th[p][o], &snh, &csh);
          const float s_l = pick<KS>(sl[p], o, kg);
          const float s_h = pick<KS>(sh[p], o, kg);
          tbb[il] = s_l * (csl * uh[p][o] - snl * ul[p][o]);
          tbb[ih] = s_h * (csh * ul[p][o] - snh * uh[p][o]);
          al[p][o] = csl * s_l + snh * s_h;
          ah[p][o] = csh * s_h + snl * s_l;
          ubp[il] = al[p][o];
          ubp[ih] = ah[p][o];
        }
      }
    }
  }
}

// ── B3b: Ebar_b = s_b^T . ubar_b over one slice of batch rows ────────────

constexpr int kEbarThreads = 256;

template <int D> struct EbarTile {
  static constexpr int W = 2 * D;
  static constexpr int TS = W < 64 ? W : 64;     // output tile side
  static constexpr int TILES = W / TS;           // tiles along each side
  static constexpr int TM = TS >= 64 ? 4 : (TS >= 32 ? 2 : 1);  // per thread
  static constexpr int TT = TS / TM;             // threads along each side
  static constexpr int TH = TT * TT;             // threads with own outputs
  static constexpr int RS = kEbarThreads / TH;   // threads sharing an output
  static constexpr int RC = 1024 / TS < 64 ? 1024 / TS : 64;  // chunk rows
  static constexpr int VEC = TS < 4 ? TS : 4;    // floats per copy
  // a tile's columns k are their own swap partners k ^ D when it spans the
  // row; else the partners are another contiguous range, staged apart
  static constexpr bool FULL = TS == W;
  // arrays of a chunk, each (RC, TS): t_b and u_{b-1} at the columns k,
  // ubar_b at the columns j, and (not FULL) u_{b-1} at the partners
  static constexpr int ARRAYS = FULL ? 3 : 4;
  static constexpr int STAGE = ARRAYS * RC * TS;  // floats of one chunk
  static constexpr int NST = 4;                   // chunks in the ring
  // the ring of chunks and two buffers of the rebuilt s_b (RC, TS)
  static constexpr size_t smem_bytes =
      sizeof(float) * (NST * STAGE + 2 * RC * TS);
  static_assert(TH <= kEbarThreads && kEbarThreads % TH == 0, "");
  static_assert(STAGE >= kEbarThreads, "the partial sums fit a stage");
  static_assert(FULL || TS <= D, "a tile's partners lie in the other half");
};

// rows [r, r + RC) of t_b (columns k0..), ubar_b (columns j0..), and past
// the first block of u_{b-1} (columns k0.. and their partners (k0..) ^ D)
// -> one stage; rows past the slice are zeros (a copy of 0 source bytes)
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ t,
                                           const float* __restrict__ u,
                                           const float* __restrict__ ub,
                                           int b, int n, long long r,
                                           long long r_end, int k0, int j0,
                                           float* stage) {
  using M = EbarTile<D>;
  constexpr int PER_ROW = M::TS / M::VEC;
  const size_t nw = static_cast<size_t>(n) * M::W;
  const int arrays = b > 0 ? M::ARRAYS : 2;
  for (int i = threadIdx.x; i < arrays * M::RC * PER_ROW; i += kEbarThreads) {
    const int arr = i / (M::RC * PER_ROW);
    const int rr = (i / PER_ROW) % M::RC, v = i % PER_ROW;
    const long long row = r + rr;
    const bool ok = row < r_end;
    const float* base = arr == 0   ? t + b * nw + k0
                        : arr == 1 ? ub + b * nw + j0
                        : arr == 2 ? u + (b - 1) * nw + k0
                                   : u + (b - 1) * nw + (k0 ^ D);
    cp_async_zfill<4 * M::VEC>(stage + (arr * M::RC + rr) * M::TS + v * M::VEC,
                               base + (ok ? row : 0) * M::W + v * M::VEC, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kEbarThreads)
embed_chain_ebar_kernel(const float* __restrict__ t,
                        const float* __restrict__ u,
                        const float* __restrict__ ub, float* __restrict__ dst,
                        int nb, int n, int rows_per_split, float inv_sqrt) {
  using M = EbarTile<D>;
  constexpr int W = M::W, TS = M::TS, TM = M::TM, TT = M::TT, TH = M::TH,
                RS = M::RS, RC = M::RC;
  extern __shared__ __align__(16) float smem[];  // NST chunks, 2 x s_b
  float* sbs = smem + M::NST * M::STAGE;

  const int b = blockIdx.x / (M::TILES * M::TILES);
  const int tile = blockIdx.x % (M::TILES * M::TILES);
  const int k0 = (tile / M::TILES) * TS, j0 = (tile % M::TILES) * TS;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int og = threadIdx.x % TH, rs = threadIdx.x / TH;
  const int tk = og / TT, tj = og % TT;

  const int chunks =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + RC - 1) / RC) : 0;
  auto stage = [&](int ch) {
    if (ch < chunks)
      stage_rows<D>(t, u, ub, b, n, r_begin + static_cast<long long>(ch) * RC,
                    r_end, k0, j0, smem + (ch % M::NST) * M::STAGE);
    cp_async_commit();
  };
  // s_b of chunk ch at the tile's columns, into its buffer:
  // s_0 = inv_sqrt [cos t_0 | sin t_0],
  // s_b = cos t_b (.) u_{b-1} + sin t_b (.) swap(u_{b-1})
  auto rebuild = [&](int ch) {
    const float* ts = smem + (ch % M::NST) * M::STAGE;  // t_b
    const float* us = ts + 2 * RC * TS;                  // u_{b-1}
    float* sb = sbs + (ch & 1) * RC * TS;
    for (int i = threadIdx.x; i < RC * TS; i += kEbarThreads) {
      const int kk = i % TS;
      float sn, cs;
      sincosf(ts[i], &sn, &cs);
      float v;
      if (b == 0) {
        v = inv_sqrt * (k0 + kk < D ? cs : sn);
      } else {
        const float partner =
            M::FULL ? us[i - kk + (kk ^ D)] : us[RC * TS + i];
        v = cs * us[i] + sn * partner;
      }
      sb[i] = v;
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[a][c] = 0.f;

  // the first NST - 1 chunks asked for first, one cp.async group each; s_b
  // is rebuilt one chunk ahead of the product that reads it, so that a
  // chunk needs one barrier
  for (int ch = 0; ch < M::NST - 1; ++ch) stage(ch);
  cp_async_wait(M::NST - 2);
  __syncthreads();  // chunk 0 has landed for every thread
  if (chunks > 0) rebuild(0);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait(M::NST - 3);  // chunk ch+1 has landed (later ones may not)
    __syncthreads();  // ... for every thread; s_b of chunk ch is written,
                      // and every thread is done with chunk ch-1
    stage(ch + M::NST - 1);  // into chunk ch-1's slot
    if (ch + 1 < chunks) rebuild(ch + 1);
    const float* sb = sbs + (ch & 1) * RC * TS;
    const float* ys = smem + (ch % M::NST) * M::STAGE + RC * TS;  // ubar_b
    for (int rr = rs; rr < RC; rr += RS) {
      float xv[TM], yv[TM];
      load_vec<TM>(sb + rr * TS + tk * TM, xv);
      load_vec<TM>(ys + rr * TS + tj * TM, yv);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[a][c] = fmaf(xv[a], yv[c], acc[a][c]);
    }
  }

  const size_t out0 = (static_cast<size_t>(blockIdx.y) * nb + b) * W * W;
  if constexpr (RS == 1) {
#pragma unroll
    for (int a = 0; a < TM; ++a)
      store_vec<TM>(dst + out0 + static_cast<size_t>(k0 + tk * TM + a) * W +
                        j0 + tj * TM,
                    acc[a]);
  } else {
    // TM == 1: RS threads hold partial sums of one entry; add them in order
    __syncthreads();  // every thread is done reading the last chunk
    smem[threadIdx.x] = acc[0][0];
    __syncthreads();
    if (rs == 0) {
      float sum = 0.f;
      for (int i = 0; i < RS; ++i) sum += smem[i * TH + og];
      dst[out0 + static_cast<size_t>(k0 + tk) * W + j0 + tj] = sum;
    }
  }
}

// out[i] = sum over splits s, in order, of part[s][i]
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int splits, size_t count) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * 256) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * count + i];
    out[i] = sum;
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

template <int D, int NT, int CJ, int P, int KS, bool SAVE>
cudaError_t launch_forward(const float* e, const float* t, float* out,
                           float* u_out, int nb, int n, cudaStream_t stream) {
  using T = Tile<D, NT, CJ, P, KS>;
  static std::atomic<unsigned> done{0};
  const auto kernel = embed_chain_fwd_kernel<D, NT, CJ, P, KS, SAVE>;
  cudaError_t err = allow_smem(kernel, T::fwd_smem_bytes, done);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + T::R - 1) / T::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, NT, T::fwd_smem_bytes, stream>>>(e, t, out, u_out, nb, n,
                                                   inv_sqrt);
  return cudaGetLastError();
}

template <int D, int NT, int CJ, int P, int KS>
cudaError_t launch_backward(const float* e, const float* t, const float* u,
                            const float* g, float* ub, float* part,
                            float* ebar, float* tbar, int nb, int n,
                            int splits, cudaStream_t stream) {
  using T = Tile<D, NT, CJ, P, KS>;
  using M = EbarTile<D>;
  static std::atomic<unsigned> done{0};
  const auto kernel = embed_chain_bwd_kernel<D, NT, CJ, P, KS>;
  cudaError_t err = allow_smem(kernel, T::bwd_smem_bytes, done);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + T::R - 1) / T::R);
  const float inv_sqrt = static_cast<float>(1.0 / std::sqrt(double(D)));
  kernel<<<grid, NT, T::bwd_smem_bytes, stream>>>(e, t, u, g, ub, tbar, nb,
                                                   n, inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_split = (n + splits - 1) / splits;
  const dim3 egrid(static_cast<unsigned>(nb * M::TILES * M::TILES),
                   static_cast<unsigned>(splits));
  static std::atomic<unsigned> ebar_done{0};
  const auto ebar_kernel = embed_chain_ebar_kernel<D>;
  err = allow_smem(ebar_kernel, M::smem_bytes, ebar_done);
  if (err != cudaSuccess) return err;
  ebar_kernel<<<egrid, kEbarThreads, M::smem_bytes, stream>>>(
      t, u, ub, splits > 1 ? part : ebar, nb, n, rows_per_split, inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t count = static_cast<size_t>(nb) * T::W * T::W;
  const size_t blocks = (count + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                      256, 0, stream>>>(part, ebar, splits, count);
  return cudaGetLastError();
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_embed.py).  Each takes device pointers of
// contiguous fp32 tensors (16-byte aligned) and the stream to launch on,
// and returns the cudaError_t of its launches (0 on success).  d, half the
// row's width, must be a power of two in [1, 128]; nb >= 1, n >= 1; tile
// one of the geometries of EMBED_TILES for d (cuda_embed.embed_geometry
// picks it).

// Rows R of the row tile ``tile`` at half-width d, or 0 for no such tile:
// the wrapper checks its own table against this one when it loads the
// library.
extern "C" int embed_chain_tile_rows(int d, int tile) {
#define EMBED_ROWS(D_, T_, NT_, CJ_, P_, KS_)                               \
  if (d == D_ && tile == T_) return Tile<D_, NT_, CJ_, P_, KS_>::R;
  EMBED_TILES(EMBED_ROWS)
#undef EMBED_ROWS
  return 0;
}

// B3f.  u_out (nb-1, n, 2d): the residual of the backward, each block's
// product before its phase step, written when not null.  The primal and
// residual variants of one (n, d, tile) give equal outputs, bit for bit.
extern "C" int embed_chain_forward(const float* e, const float* t, float* out,
                                   float* u_out, int nb, int n, int d,
                                   int tile, void* stream) {
  if (nb < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMBED_FWD(D_, T_, NT_, CJ_, P_, KS_)                                \
  if (d == D_ && tile == T_)                                                \
    return u_out != nullptr                                                 \
               ? launch_forward<D_, NT_, CJ_, P_, KS_, true>(               \
                     e, t, out, u_out, nb, n, st)                           \
               : launch_forward<D_, NT_, CJ_, P_, KS_, false>(              \
                     e, t, out, u_out, nb, n, st);
  EMBED_TILES(EMBED_FWD)
#undef EMBED_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// B3b.  u (max(nb-1, 1), n, 2d): the forward's residual (not read when
// nb = 1).  g (n, 2d): the output's cotangent.  ub (nb, n, 2d): scratch for
// ubar.  part (splits, nb, 2d, 2d): scratch for the slices of Ebar, used
// when splits > 1.  Writes ebar (nb, 2d, 2d) and tbar (nb, n, 2d).
extern "C" int embed_chain_backward(const float* e, const float* t,
                                    const float* u, const float* g, float* ub,
                                    float* part, float* ebar, float* tbar,
                                    int nb, int n, int d, int tile,
                                    int splits, void* stream) {
  if (nb < 1 || n < 1 || splits < 1 || splits > n ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMBED_BWD(D_, T_, NT_, CJ_, P_, KS_)                                \
  if (d == D_ && tile == T_)                                                \
    return launch_backward<D_, NT_, CJ_, P_, KS_>(                          \
        e, t, u, g, ub, part, ebar, tbar, nb, n, splits, st);
  EMBED_TILES(EMBED_BWD)
#undef EMBED_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* embed_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
