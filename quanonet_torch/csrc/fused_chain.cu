// Fused-group chain of the HEA circuit for 8..16 qubits, forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of quanonet_tpu/ops/pallas_fused.py, joined
// there as the custom VJP of _make_chain:
//
//   B2f  _fwd_kernel (primal output, and the block-input-saving variant)
//
//     s = |0...0>;  for each block b:
//         s <- H^{(x)n} s;   s <- D_b (.) s,  D_b[k] = exp(-i phi_b[k]),
//             phi_b[k] = 1/2 sum_i z_i(k) x_{b,i}  (z_i(k) = (-1)^{bit i of k})
//         linear_depth 0:  s <- H^{(x)n} s
//         else, per sublayer t:  s <- s . U7t_t  on the low 7 qubits (each
//             row's state as a (hi, 128) complex matrix, hi = 2^(n-7));
//             the 2x2 u_{t,j} on each high qubit 7 + j (a butterfly);
//             the CNOT ring, out[perm(k)] = s[k]
//
//   Inputs: u7t_r, u7t_i (S, 128, 128), the low-group unitaries transposed
//   (the encode Hadamard folded into each block's first sublayer); u2_r,
//   u2_i (S, n-7, 4), the high qubits' 2x2 entries [u00, u01, u10, u11]
//   (their tensor product is the dense high-group unitary: the JAX kernel's
//   butterfly mode, here at every n); x (nb, N, n) the encoding angles;
//   sub_off (nb + 1) int32, block b's sublayers are [sub_off[b],
//   sub_off[b+1]); sched, the order in which the kernel streams the
//   sublayers' U7t (entry 2 t + adj).  Outputs: out_r, out_i (N, 2^n); with
//   residuals each block's input state st_r, st_i (nb, N, 2^n).
//
//   B2b  _bwd_kernel, here as three or four launches:
//
//     fused_chain_bwd_kernel   per block, in reverse: recompute the block
//         from its saved input state (keeping a = H s_in, writing each
//         sublayer's pre-low state to PRE), then walk back: ct <- ring^T ct
//         (the gather by the ring's forward map); per high qubit, in
//         reverse, the 2x2's cotangent ubar[2a+b] += ct_a . conj(t_b) with t
//         the butterfly's input, and ct <- u^H ct; ct written to CT;
//         ct <- ct . conj(U7t)^T; at the block's start phibar = Im-part of
//         conj(a) ct D, reduced to xbar_i = 1/2 sum_k z_i(k) phibar_k, then
//         ct <- H conj(D) ct (H is self-adjoint).  The butterfly inputs are
//         not stored: the state after all butterflies of the last sublayer
//         is kept from the recompute, the others are ring^T of the next
//         sublayer's pre-low state, and each u is unitary, so
//         t_j = u_j^H t_{j+1} is walked back beside ct.
//     fused_u7bar_kernel       U7bar_t = conj(PRE_t)^T . CT_t, the batch sum,
//         as a GEMM over the N*hi rows of 128 lanes: one CTA per (sublayer,
//         64x64 output tile, slice of rows), a fixed summation order
//     fused_sum_splits_kernel  the slices summed in slice order
//     fused_u2bar_kernel       the per-CTA partial sums of u2bar (each a
//         fixed-order CTA reduction) summed in CTA order
//
//   No atomics: two calls on equal inputs give equal bits.
//   Plain versions: quanonet_torch/ops/fused_gates.py chain_fused_x (primal),
//   chain_fused_saved_x (residuals), chain_fused_backward_x (backward).
//
// What bounds them.  The low-group products are the work: per sublayer
// N*hi*128*128 complex MACs (forward one, backward three: recompute,
// ct . conj(U7t)^T and the U7bar GEMM), 6 flops each in the three-product
// count of the TPU kernel: at Q10 Net40-2-20-2, N = 100, 9.4 GFLOP for the
// forward, 0.14 ms at the fp32 peak.  The bytes (x, the states) are an order
// of magnitude less.  At the training batch a CTA owns one or two rows for
// 60 blocks of dependent work, so what bounds a launch is each CTA's chain
// of passes: its products' tensor-core issue (mma.sync m16n8k8 TF32 issues
// about one MMA per 20 cycles a scheduler on the H100, and the 3xTF32 split
// takes 12 a complex k-step) and the stream of U7t (128 KB a sublayer,
// ~32 bytes a cycle into one SM), then the elementwise passes.
//
// Design.
// * One CTA owns R whole rows (R*hi = M tile rows of 128 lanes, M a
//   multiple of 8) for the whole chain, so the ring and the butterflies,
//   which mix a row's amplitudes across the lanes and the high bits, never
//   leave the CTA.  A tile row is padded to kPitch = 132 floats, so that
//   the MMA fragments below read shared memory without bank conflicts.
// * The low products run on the tensor cores, mma.sync m16n8k8 TF32 with
//   the 3xTF32 split (a_hi b_hi + a_hi b_lo + a_lo b_hi: fp32 quality;
//   plain TF32 drifts ~2 % over 60 blocks).  The tensor cores accumulate
//   with truncation, so each k-step's products go into fresh partial sums
//   that are added in fp32 (accumulating in the MMA put B2b's x-cotangent
//   at 2x its limit).  They compute y^T = A x^T with the 128 outputs as the
//   m side and the tile rows as the n side, so any M that is a multiple of
//   8 maps onto the MMA; A = U7t^T (forward, chunks of 32 rows k, pitch
//   136) or conj(U7t) (adjoint, chunks of 32 columns, pitch 36).  The
//   four-product form is kept: the three-product form (9 MMAs) measured
//   slower, its extra operands spilling registers.
// * U7t streams through a ring of up to kMaxSlots staged chunks in the
//   order of sched, across sublayers and blocks, by cp.async from
//   kCopyWarps warps of their own: issued by the MMA warps the copies
//   stalled them on a full copy queue (a third of the product's time), and
//   bulk (TMA) copies of 128-512 bytes a row were slower still.
// * The elementwise passes hold a thread's amplitudes in registers: the
//   Hadamard is one warp pass over the low 7 bits (two register stages,
//   five shuffles) and one pass per 3 high bits; the phase, with the
//   Hadamard's 2^(-n/2) folded in, rides on the last high pass; each
//   sublayer's high 2x2s and the ring are one pass (butterflies in
//   registers, the 2x2s prefetched into shared memory during the product,
//   then a scatter through the ring's forward map, from a table of its
//   images of single bits).  The phase factors come from x: a low factor
//   (128 values) and a high factor (hi values) a row, one sincosf each,
//   built once per block (the backward reuses them at the block's tail), x
//   of the next block fetched before the current block's products.
// * Up to 13 qubits (forward, 2 buffer pairs) and 12 (backward, 4) the rows
//   live in shared memory; above, one row is 64 KB or more a buffer, so the
//   same code runs on a per-CTA scratch in device memory (R = 1, L2
//   resident at the few rows these widths run), and the product takes the
//   tile rows in batches of at most 4 n8 tiles a warp.  The wrapper
//   (ops/cuda_fused.py) picks the side by passing that scratch or not.
//   Rows past N carry zeros and are never read or written.
// * B2b keeps a = H s_in and the phase factors from the recompute, walks a
//   sublayer's high qubits back in registers (3 at a time) and reduces
//   their u2bar sums once per 3 qubits, and writes xbar (nb, N, n) through
//   one fixed-order CTA reduction per block.  U7bar is a tensor-core GEMM
//   on a 3-stage cp.async ring fed by copy warps.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 128;          // 2^7, the low group
constexpr int kLaneQubits = 7;
constexpr int kPitch = 132;          // floats of a padded tile row
constexpr int kMaxConsumers = 512;   // threads of the products' MMA warps
constexpr int kCopyWarps = 4;        // warps that issue the U7t copies
constexpr int kMaxThreads = kMaxConsumers + 32 * kCopyWarps;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kSmemBytes = 232448;   // shared memory a block can use
constexpr int kChunk = 32;           // contraction values per staged chunk
constexpr int kChunks = kLanes / kChunk;
constexpr int kFwdPitch = 136;       // a forward chunk: 32 rows k of 128 j
constexpr int kAdjPitch = 36;        // an adjoint chunk: 128 rows of 32 j
constexpr int kSlotHalf = kLanes * kAdjPitch;   // >= kChunk * kFwdPitch
constexpr int kSlotFloats = 2 * kSlotHalf;      // one staging slot
constexpr int kMaxSlots = 5;
constexpr int kMaxNb = 4;            // n8 tiles a warp holds at once
constexpr int kMaxQubits = 16;
constexpr int kGroupBits = 3;        // high bits a register pass takes
constexpr int kGemmThreads = 256;
constexpr int kGemmTile = 64;
constexpr int kGemmChunk = 32;
constexpr int kGemmPitch = kGemmTile + 8;
constexpr int kGemmStages = 3;
constexpr int kGemmStageFloats = 4 * kGemmChunk * kGemmPitch;

static_assert(kChunk * kFwdPitch <= kSlotHalf, "a forward chunk fits a slot");

struct Buf {
  float* re;
  float* im;
};

// flat element t of a CTA's rows (row r, amplitude k: t = r 2^n + k) ->
// its float offset in a padded buffer
__device__ __forceinline__ int off(int t) { return (t >> 7) * kPitch + (t & 127); }

// the CNOT ring's forward map: (R psi)[perm(k)] = psi[k]
// (ops/gates.py cnot_ring_permutation).  A chain of CNOTs is linear over
// the bits: perm(a ^ b) = perm(a) ^ perm(b).
__device__ __forceinline__ int ring_perm(int k, int n) {
  for (int i = 0; i < n; ++i) {
    const int c = (i + 1 == n) ? 0 : i + 1;
    k ^= ((k >> c) & 1) << i;
  }
  return k;
}

// perm(k) from the images of single bits (cols[i] = perm(1 << i))
__device__ __forceinline__ int perm_bits(int k, const int* cols, int n) {
  int r = 0;
  for (int i = 0; i < n; ++i)
    if ((k >> i) & 1) r ^= cols[i];
  return r;
}

// perm of the amplitudes of a register pass: element e of a unit whose
// element 0 is amplitude k0 sits at k0 ^ (e << (7 + g0)), so its image is
// perm(k0) ^ the images of e's bits (cols, one per bit of the pass)
template <int GB>
__device__ __forceinline__ int ring_perm_of(int base, const int (&cols)[GB], int e) {
#pragma unroll
  for (int b = 0; b < GB; ++b)
    if ((e >> b) & 1) base ^= cols[b];
  return base;
}

// ── cp.async ────────────────────────────────────────────────────────────

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// 16 bytes, zeros when !valid (src-size 0)
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// ── 3xTF32 on mma.sync m16n8k8 ────────────────────────────────────────────

// v = hi + lo, hi and lo each exact in TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (a zero accumulator, no registers to clear)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// A fragment of a complex operand, split: re, im, and -im
struct FragA {
  uint32_t rh[4], rl[4], ih[4], il[4], nh[4], nl[4];
};

__device__ __forceinline__ void load_frag_a(FragA& f, const float (&re)[4],
                                            const float (&im)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    split_tf32(re[e], f.rh[e], f.rl[e]);
    split_tf32(im[e], f.ih[e], f.il[e]);
    f.nh[e] = f.ih[e] ^ 0x80000000u;   // -im: the sign bit, exact
    f.nl[e] = f.il[e] ^ 0x80000000u;
  }
}

// (yr, yi) += A . (xr + i xi) for the m16 x n8 tile, A = ar + i ai, at
// fp32 quality: a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo is below
// fp32's rounding).  The tensor cores accumulate with truncation, so each
// k-step's products go into fresh partial sums, six chains of two MMAs
// (the hi x hi terms apart from the corrections), added to the running sums
// with round-to-nearest fp32 adds.
__device__ __forceinline__ void cmma(float (&yr)[4], float (&yi)[4], const FragA& a,
                                     float xr0, float xr1, float xi0, float xi1) {
  uint32_t rh0, rl0, rh1, rl1, ih0, il0, ih1, il1;
  split_tf32(xr0, rh0, rl0);
  split_tf32(xr1, rh1, rl1);
  split_tf32(xi0, ih0, il0);
  split_tf32(xi1, ih1, il1);
  float br[4], bi[4], cr1[4], cr2[4], ci1[4], ci2[4];
  mma_tf32_zero(br, a.rh, rh0, rh1);    // re: ar xr - ai xi
  mma_tf32_zero(bi, a.rh, ih0, ih1);    // im: ar xi + ai xr
  mma_tf32_zero(cr1, a.rl, rh0, rh1);
  mma_tf32_zero(cr2, a.nl, ih0, ih1);
  mma_tf32_zero(ci1, a.rl, ih0, ih1);
  mma_tf32_zero(ci2, a.il, rh0, rh1);
  mma_tf32(br, a.nh, ih0, ih1);
  mma_tf32(bi, a.ih, rh0, rh1);
  mma_tf32(cr1, a.rh, rl0, rl1);
  mma_tf32(cr2, a.nh, il0, il1);
  mma_tf32(ci1, a.rh, il0, il1);
  mma_tf32(ci2, a.ih, rl0, rl1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    yr[e] += br[e] + (cr1[e] + cr2[e]);
    yi[e] += bi[e] + (ci1[e] + ci2[e]);
  }
}

// A CTA's rows: n qubits, nh = n - 7 high ones, R rows of M = R 2^nh tile
// rows; row0 its first row, valid_m the tile rows of rows < N, g0 = row0
// 2^n its first element in an (N, 2^n) array.  Tile row m, lane l is
// element g0 + 128 m + l there and float m kPitch + l of a buffer.
struct Rows {
  int n, nh, R, M, valid_m;
  long long row0;
  size_t g0;
};

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// ── the U7t stream ─────────────────────────────────────────────────────────

// Chunks of the sublayers' U7t, in the order the products use them: pass p
// (entry sched[p] = 2 t + adj) takes per_pass chunks, its 4 chunks once per
// batch of tile rows.  Chunk g goes to slot g % slots; the product asks for
// chunk g + slots - 1 as it starts on chunk g, so slots - 1 chunks are in
// flight ahead of the one in use, across passes.
struct Stream {
  const float* u_r;
  const float* u_i;
  const int* sched;
  float* slots;
  int total;      // chunks in the whole stream
  int per_pass;   // chunks of one pass
  int nslots;
};

// The copy of chunk g of the stream (none past the end) into its slot:
// forward (adj 0), rows 32c.. of u7t as they are, [k][j] at pitch 136;
// adjoint, columns 32c.. of every row k, [k][j] at pitch 36; part i takes
// float4 32 i .. of each component, one a lane.
struct Chunk {
  const float* t_r;
  const float* t_i;
  float* slot;
  int c, adj;
};

__device__ __forceinline__ Chunk chunk_of(const Stream& st, int g) {
  Chunk k{nullptr, nullptr, nullptr, 0, 0};
  if (g >= st.total) return k;
  const int v = __ldg(st.sched + g / st.per_pass);
  const size_t mat = static_cast<size_t>(v >> 1) * kLanes * kLanes;
  k.t_r = st.u_r + mat;
  k.t_i = st.u_i + mat;
  k.slot = st.slots + (g % st.nslots) * kSlotFloats;
  k.c = (g % st.per_pass) & (kChunks - 1);
  k.adj = v & 1;
  return k;
}

constexpr int kChunkVec = kChunk * kLanes / 4;   // float4 per component

// the warps of a CTA that run the products' MMAs; the last kCopyWarps
// warps, beyond them, issue the stream's copies, so that their stalls on a
// full copy queue hold up no MMA
__device__ __forceinline__ int mma_warps() { return (blockDim.x >> 5) - kCopyWarps; }
__device__ __forceinline__ bool copy_warp() {
  return static_cast<int>(threadIdx.x >> 5) >= mma_warps();
}

constexpr int kCopyThreads = 32 * kCopyWarps;

__device__ __forceinline__ void stage_part(const Chunk& k, int part) {
  const int q = part * kCopyThreads + (threadIdx.x - 32 * mma_warps());
  int dst, src;
  if (k.adj) {
    const int row = q >> 3, e = q & 7;
    dst = row * kAdjPitch + 4 * e;
    src = row * kLanes + k.c * kChunk + 4 * e;
  } else {
    const int row = q >> 5, e = q & 31;
    dst = row * kFwdPitch + 4 * e;
    src = (k.c * kChunk + row) * kLanes + 4 * e;
  }
  cp_async16(k.slot + dst, k.t_r + src);
  cp_async16(k.slot + kSlotHalf + dst, k.t_i + src);
}

// the whole of chunk g by the copy warps, and its group committed
__device__ void stage(const Stream& st, int g) {
  if (!copy_warp()) return;
  const Chunk k = chunk_of(st, g);
  if (k.slot != nullptr)
    for (int part = 0; part < kChunkVec / kCopyThreads; ++part) stage_part(k, part);
  cp_async_commit();
}

// the stream's first slots - 1 chunks asked for; callers then pass a
// __syncthreads before the first product
__device__ void start_stream(const Stream& st) {
  for (int c = 0; c + 1 < st.nslots; ++c) stage(st, c);
}

// The low-group product of one pass on M tile rows: y = x . U7t (forward)
// or y = x . conj(U7t)^T (adj), as y^T = A x^T on the tensor cores.  MMA
// warp w owns the 16 outputs 16 (w % 8) .. and the n8 tiles w / 8 + G i of
// the M / 8 (G = MMA warps / 8), NB of them at a time; meanwhile the copy
// warp asks for chunk g + slots - 1.  g: the stream position, the pass's
// first chunk on entry, the next pass's on exit.  Ends with a barrier (y
// is written), before which threads i < n_next store next[i] (a value they
// loaded before the call) to next_s.
template <int NB>
__device__ void product(const Stream& st, int& g, const float* x_r,
                        const float* x_i, Buf y, const Rows& q, bool adj,
                        float* next_s, float next, int n_next) {
  const int M = q.M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int groups = mma_warps() >> 3;
  const bool copier = copy_warp();
  const int mt = w & 7, ng = w >> 3;
  const int batches = (M >> 3) / groups / NB;
  const int i0 = mt * 16 + gid;
  for (int bt = 0; bt < batches; ++bt) {
    float yr[NB][4], yi[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) yr[nb][e] = yi[nb][e] = 0.f;
    for (int c = 0; c < kChunks; ++c, ++g) {
      cp_async_wait(st.nslots - 2);        // chunk g has landed (the copy warp's)
      __syncthreads();                     // ... for all; chunk g - 1 is used
      if (copier) {                        // chunk g + slots - 1 to g - 1's slot
        stage(st, g + st.nslots - 1);
        continue;
      }
      const float* s_r = st.slots + (g % st.nslots) * kSlotFloats;
      const float* s_i = s_r + kSlotHalf;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        float ar[4], ai[4];
        if (adj) {        // A[i][kk] = conj(U7t[i][32 c + 8 ks + kk])
          const int b = i0 * kAdjPitch + ks * 8 + tig;
          ar[0] = s_r[b]; ar[1] = s_r[b + 8 * kAdjPitch];
          ar[2] = s_r[b + 4]; ar[3] = s_r[b + 8 * kAdjPitch + 4];
          ai[0] = -s_i[b]; ai[1] = -s_i[b + 8 * kAdjPitch];
          ai[2] = -s_i[b + 4]; ai[3] = -s_i[b + 8 * kAdjPitch + 4];
        } else {          // A[i][kk] = U7t[32 c + 8 ks + kk][i]
          const int b = (ks * 8 + tig) * kFwdPitch + i0;
          ar[0] = s_r[b]; ar[1] = s_r[b + 8];
          ar[2] = s_r[b + 4 * kFwdPitch]; ar[3] = s_r[b + 4 * kFwdPitch + 8];
          ai[0] = s_i[b]; ai[1] = s_i[b + 8];
          ai[2] = s_i[b + 4 * kFwdPitch]; ai[3] = s_i[b + 4 * kFwdPitch + 8];
        }
        FragA fa;
        load_frag_a(fa, ar, ai);
        const int k = c * kChunk + ks * 8 + tig;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int m = (ng + groups * (bt * NB + nb)) * 8 + gid;
          const float* pr = x_r + m * kPitch + k;
          const float* pi = x_i + m * kPitch + k;
          cmma(yr[nb], yi[nb], fa, pr[0], pr[4], pi[0], pi[4]);
        }
      }
    }
    if (copier) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int m = (ng + groups * (bt * NB + nb)) * 8 + 2 * tig;
      const int o = m * kPitch + mt * 16 + gid;
      y.re[o] = yr[nb][0]; y.re[o + kPitch] = yr[nb][1];
      y.re[o + 8] = yr[nb][2]; y.re[o + kPitch + 8] = yr[nb][3];
      y.im[o] = yi[nb][0]; y.im[o + kPitch] = yi[nb][1];
      y.im[o + 8] = yi[nb][2]; y.im[o + kPitch + 8] = yi[nb][3];
    }
  }
  if (static_cast<int>(threadIdx.x) < n_next) next_s[threadIdx.x] = next;
  __syncthreads();
}

// product with NB = the n8 tiles a warp owns, at most kMaxNb
__device__ __forceinline__ void low_product(const Stream& st, int& g,
                                            const float* x_r, const float* x_i,
                                            Buf y, const Rows& q, bool adj,
                                            float* next_s, float next, int n_next) {
  const int per_warp = (q.M >> 3) / (mma_warps() >> 3);
  if (per_warp >= 4)
    product<4>(st, g, x_r, x_i, y, q, adj, next_s, next, n_next);
  else if (per_warp == 2)
    product<2>(st, g, x_r, x_i, y, q, adj, next_s, next, n_next);
  else
    product<1>(st, g, x_r, x_i, y, q, adj, next_s, next, n_next);
}

// ── the elementwise passes ───────────────────────────────────────────────

// H' = 2^(n/2) H^{(x)7} on the low 7 bits of every tile row of b, a warp a
// tile row: bits 5 and 6 in registers, bits 0..4 by shuffles.  With src
// (an (N, 2^n) pair) the rows are read from there (zeros past N), else from
// b; with save, what was read is also stored there (rows < N).
__device__ void wht_low(Buf b, const Rows& q, const float* src_r,
                        const float* src_i, float* save_r, float* save_i) {
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < q.M; m += blockDim.x >> 5) {
    const bool ok = m < q.valid_m;
    const size_t gm = q.g0 + static_cast<size_t>(m) * kLanes + lane;
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (src_r != nullptr) {
        vr[u] = ok ? src_r[gm + 32 * u] : 0.f;
        vi[u] = ok ? src_i[gm + 32 * u] : 0.f;
      } else {
        vr[u] = b.re[m * kPitch + lane + 32 * u];
        vi[u] = b.im[m * kPitch + lane + 32 * u];
      }
      if (save_r != nullptr && ok) {
        save_r[gm + 32 * u] = vr[u];
        save_i[gm + 32 * u] = vi[u];
      }
    }
#pragma unroll
    for (int s = 1; s < 4; s <<= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (!(u & s)) {
          const float ar = vr[u], ai = vi[u];
          vr[u] = ar + vr[u | s]; vi[u] = ai + vi[u | s];
          vr[u | s] = ar - vr[u | s]; vi[u | s] = ai - vi[u | s];
        }
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const bool upper = lane & s;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pr = __shfl_xor_sync(0xffffffffu, vr[u], s);
        const float pi = __shfl_xor_sync(0xffffffffu, vi[u], s);
        vr[u] = upper ? pr - vr[u] : vr[u] + pr;
        vi[u] = upper ? pi - vi[u] : vi[u] + pi;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      b.re[m * kPitch + lane + 32 * u] = vr[u];
      b.im[m * kPitch + lane + 32 * u] = vi[u];
    }
  }
}

// The block's phase factors from xs (R rows of n angles at stride
// kMaxQubits), exp(-i phi) = lf[r][k & 127] hf[m] with phi split into its
// low-qubit and high-qubit sums: lf (R x 128 complex, times scale) and hf
// (M complex).
__device__ void build_factors(const float* xs, float2* lf, float2* hf,
                              const Rows& q, float scale) {
  const int low = q.R * kLanes;
  for (int u = threadIdx.x; u < low + q.M; u += blockDim.x) {
    float a = 0.f, sn, cs;
    if (u < low) {
      const float* xr = xs + (u >> 7) * kMaxQubits;
#pragma unroll
      for (int i = 0; i < kLaneQubits; ++i) a += ((u >> i) & 1) ? -xr[i] : xr[i];
      sincosf(0.5f * a, &sn, &cs);
      lf[u] = make_float2(scale * cs, -scale * sn);
    } else {
      const int v = u - low;
      const float* xr = xs + (v >> q.nh) * kMaxQubits + kLaneQubits;
      for (int j = 0; j < q.nh; ++j) a += ((v >> j) & 1) ? -xr[j] : xr[j];
      sincosf(0.5f * a, &sn, &cs);
      hf[v] = make_float2(cs, -sn);
    }
  }
}

// A register pass over GB high bits g0.. : unit u -> its lane and the tile
// row of its element 0; element e sits at tile row m0 + (e << g0).
template <int GB>
__device__ __forceinline__ void unit_rows(int u, const Rows& q, int g0, int& lane,
                                          int& m0) {
  lane = u & (kLanes - 1);
  const int rest = u >> 7, ob = q.nh - GB;
  const int o = rest & ((1 << ob) - 1), r = rest >> ob;
  m0 = (r << q.nh) | ((o >> g0) << (g0 + GB)) | (o & ((1 << g0) - 1));
}

// H' on high bits g0 .. g0 + GB - 1 of b, in place.  On the last pass
// (last): times mult; with lf, also the phase: the phased values go to out
// (b keeps the unphased ones) or, when out.re is null, into b, and with
// pre_r to the rows' (N, 2^n) array pre.
template <int GB>
__device__ void wht_high(Buf b, const Rows& q, int g0, bool last,
                         const float2* lf, const float2* hf, float mult,
                         Buf out, float* pre_r, float* pre_i) {
  constexpr int E = 1 << GB;
  const int units = (q.M * kLanes) >> GB;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    int lane, m0;
    unit_rows<GB>(u, q, g0, lane, m0);
    float vr[E], vi[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int o = (m0 + (e << g0)) * kPitch + lane;
      vr[e] = b.re[o];
      vi[e] = b.im[o];
    }
#pragma unroll
    for (int s = 1; s < E; s <<= 1)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & s)) {
          const float ar = vr[e], ai = vi[e];
          vr[e] = ar + vr[e | s]; vi[e] = ai + vi[e | s];
          vr[e | s] = ar - vr[e | s]; vi[e | s] = ai - vi[e | s];
        }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int m = m0 + (e << g0);
      const int o = m * kPitch + lane;
      if (last) { vr[e] *= mult; vi[e] *= mult; }
      if (!last || lf == nullptr) {
        b.re[o] = vr[e]; b.im[o] = vi[e];
        continue;
      }
      const float2 l = lf[((m >> q.nh) << 7) | lane], h = hf[m];
      float dr, di, wr, wi;
      cmul(l.x, l.y, h.x, h.y, dr, di);
      cmul(dr, di, vr[e], vi[e], wr, wi);
      if (out.re != nullptr) {
        b.re[o] = vr[e]; b.im[o] = vi[e];
        out.re[o] = wr; out.im[o] = wi;
      } else {
        b.re[o] = wr; b.im[o] = wi;
      }
      if (pre_r != nullptr && m < q.valid_m) {
        const size_t gi = q.g0 + static_cast<size_t>(m) * kLanes + lane;
        pre_r[gi] = wr; pre_i[gi] = wi;
      }
    }
  }
}

// The 2x2s of high qubits 7 + g0 .. 7 + g0 + GB - 1 (u2 of the sublayer,
// (nh, 4)) on y, in place; on the last pass with dst.re, the result is
// scattered through the ring into dst instead, and with pre_r also into
// the rows' (N, 2^n) array pre (rows < N).
template <int GB>
__device__ void butterflies(Buf y, const Rows& q, int g0, bool last,
                            const float* u2s, const int* rcols, Buf dst,
                            float* pre_r, float* pre_i) {
  constexpr int E = 1 << GB;
  float ur[GB][4], ui[GB][4];
#pragma unroll
  for (int j = 0; j < GB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ur[j][e] = u2s[8 * (g0 + j) + e];
      ui[j][e] = u2s[8 * (g0 + j) + 4 + e];
    }
  const int units = (q.M * kLanes) >> GB;
  const int mask = (1 << q.n) - 1;
  int cols[GB];
#pragma unroll
  for (int b = 0; b < GB; ++b) cols[b] = rcols[kLaneQubits + g0 + b];
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    int lane, m0;
    unit_rows<GB>(u, q, g0, lane, m0);
    float vr[E], vi[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int o = (m0 + (e << g0)) * kPitch + lane;
      vr[e] = y.re[o];
      vi[e] = y.im[o];
    }
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & (1 << j))) {
          const int e1 = e | (1 << j);
          const float ar = vr[e], ai = vi[e], cr = vr[e1], ci = vi[e1];
          vr[e] = ur[j][0] * ar - ui[j][0] * ai + ur[j][1] * cr - ui[j][1] * ci;
          vi[e] = ur[j][0] * ai + ui[j][0] * ar + ur[j][1] * ci + ui[j][1] * cr;
          vr[e1] = ur[j][2] * ar - ui[j][2] * ai + ur[j][3] * cr - ui[j][3] * ci;
          vi[e1] = ur[j][2] * ai + ui[j][2] * ar + ur[j][3] * ci + ui[j][3] * cr;
        }
#pragma unroll
    const int t0 = (m0 << 7) | lane;
    const int k0 = last && dst.re != nullptr ? perm_bits(t0 & mask, rcols, q.n) : 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int m = m0 + (e << g0);
      if (!last || dst.re == nullptr) {
        y.re[m * kPitch + lane] = vr[e];
        y.im[m * kPitch + lane] = vi[e];
        continue;
      }
      const int to = (t0 & ~mask) | ring_perm_of<GB>(k0, cols, e);
      dst.re[off(to)] = vr[e];
      dst.im[off(to)] = vi[e];
      if (pre_r != nullptr && m < q.valid_m) {
        pre_r[q.g0 + to] = vr[e];
        pre_i[q.g0 + to] = vi[e];
      }
    }
  }
}

// Back through the 2x2s of high qubits 7 + g0 .. (in reverse) of one
// sublayer: c the cotangent at their output, t the state there.  The first
// pass of a sublayer takes both through ring^T: c gathered from c_in by the
// ring's forward map, t gathered likewise from pre_r (the next sublayer's
// pre-low state, rows < N) or, without pre_r, read from t_buf as it is (the
// state kept from the recompute); later passes read c_out and t_buf.  Per
// qubit: t <- u^H t (the butterfly's input), acc += c_a conj(t_b) for the
// 2x2's cotangent, c <- u^H c.  Writes c to c_out (and, on the last pass,
// to the (N, 2^n) array ct_r), t to t_buf.
template <int GB>
__device__ void walk_back(Buf c_in, Buf c_out, Buf t_buf, const float* pre_r,
                          const float* pre_i, const Rows& q, int g0, bool first,
                          bool last, const float* u2s, const int* rcols,
                          float* ct_r, float* ct_i, float (&acc)[kGroupBits * 8]) {
  constexpr int E = 1 << GB;
  float ur[GB][4], ui[GB][4];
#pragma unroll
  for (int j = 0; j < GB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ur[j][e] = u2s[8 * (g0 + j) + e];
      ui[j][e] = u2s[8 * (g0 + j) + 4 + e];
    }
  const int units = (q.M * kLanes) >> GB;
  const int mask = (1 << q.n) - 1;
  int cols[GB];
#pragma unroll
  for (int b = 0; b < GB; ++b) cols[b] = rcols[kLaneQubits + g0 + b];
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    int lane, m0;
    unit_rows<GB>(u, q, g0, lane, m0);
    const int t0 = (m0 << 7) | lane;
    const int k0 = first ? perm_bits(t0 & mask, rcols, q.n) : 0;
    float cr[E], ci[E], tr[E], ti[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int m = m0 + (e << g0);
      const int o = m * kPitch + lane;
      if (first) {
        const int from = (t0 & ~mask) | ring_perm_of<GB>(k0, cols, e);
        cr[e] = c_in.re[off(from)];
        ci[e] = c_in.im[off(from)];
        if (pre_r != nullptr) {
          const bool ok = m < q.valid_m;
          tr[e] = ok ? pre_r[q.g0 + from] : 0.f;
          ti[e] = ok ? pre_i[q.g0 + from] : 0.f;
        } else {
          tr[e] = t_buf.re[o];
          ti[e] = t_buf.im[o];
        }
      } else {
        cr[e] = c_out.re[o]; ci[e] = c_out.im[o];
        tr[e] = t_buf.re[o]; ti[e] = t_buf.im[o];
      }
    }
#pragma unroll
    for (int j = GB - 1; j >= 0; --j)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & (1 << j))) {
          const int e1 = e | (1 << j);
          // t <- u^H t: t0 = conj(u00) a + conj(u10) b, t1 = conj(u01) a + conj(u11) b
          const float a_r = tr[e], a_i = ti[e], b_r = tr[e1], b_i = ti[e1];
          const float t0r = ur[j][0] * a_r + ui[j][0] * a_i + ur[j][2] * b_r + ui[j][2] * b_i;
          const float t0i = ur[j][0] * a_i - ui[j][0] * a_r + ur[j][2] * b_i - ui[j][2] * b_r;
          const float t1r = ur[j][1] * a_r + ui[j][1] * a_i + ur[j][3] * b_r + ui[j][3] * b_i;
          const float t1i = ur[j][1] * a_i - ui[j][1] * a_r + ur[j][3] * b_i - ui[j][3] * b_r;
          const float c0r = cr[e], c0i = ci[e], c1r = cr[e1], c1i = ci[e1];
          float* v = acc + 8 * j;   // u2bar[2a + b] += c_a conj(t_b)
          v[0] += c0r * t0r + c0i * t0i;  v[4] += c0i * t0r - c0r * t0i;
          v[1] += c0r * t1r + c0i * t1i;  v[5] += c0i * t1r - c0r * t1i;
          v[2] += c1r * t0r + c1i * t0i;  v[6] += c1i * t0r - c1r * t0i;
          v[3] += c1r * t1r + c1i * t1i;  v[7] += c1i * t1r - c1r * t1i;
          tr[e] = t0r; ti[e] = t0i; tr[e1] = t1r; ti[e1] = t1i;
          cr[e] = ur[j][0] * c0r + ui[j][0] * c0i + ur[j][2] * c1r + ui[j][2] * c1i;
          ci[e] = ur[j][0] * c0i - ui[j][0] * c0r + ur[j][2] * c1i - ui[j][2] * c1r;
          cr[e1] = ur[j][1] * c0r + ui[j][1] * c0i + ur[j][3] * c1r + ui[j][3] * c1i;
          ci[e1] = ur[j][1] * c0i - ui[j][1] * c0r + ur[j][3] * c1i - ui[j][3] * c1r;
        }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int m = m0 + (e << g0);
      const int o = m * kPitch + lane;
      c_out.re[o] = cr[e]; c_out.im[o] = ci[e];
      t_buf.re[o] = tr[e]; t_buf.im[o] = ti[e];
      if (last && m < q.valid_m) {
        const size_t gi = q.g0 + static_cast<size_t>(m) * kLanes + lane;
        ct_r[gi] = cr[e]; ct_i[gi] = ci[e];
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// acc (GB x 8 sums of this thread) -> their sum over the CTA, in a fixed
// order (warp trees, then warps in order), written to dst[0 .. 8 GB); red
// holds two sets of per-warp sums used alternately (parity), so this one
// barrier a call suffices.  Every thread calls it; it ends the pass.
template <int GB>
__device__ void reduce_u2(float (&acc)[kGroupBits * 8], float* red, int& parity,
                          float* dst) {
  constexpr int V = 8 * GB;
  float* r = red + parity * kMaxWarps * kGroupBits * 8;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float s = warp_sum(acc[v]);
    if ((threadIdx.x & 31) == 0) r[w * V + v] = s;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float sum = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) sum += r[k * V + threadIdx.x];
    dst[threadIdx.x] = sum;
  }
  parity ^= 1;
}

// The block's start in the backward: with a = H' s_in (unscaled) and the
// phase factors, phibar = Im-part as in the plain version, its sums for
// xbar into xred (per row and warp of the row's 128 lanes, n values), and
// c <- conj(D) c (the scale folded in D).
__device__ void tail(Buf a, Buf c, const Rows& q, const float2* lf,
                     const float2* hf, float* xred) {
  constexpr int kHighMax = kMaxQubits - kLaneQubits;
  const int hi = 1 << q.nh;
  for (int u = threadIdx.x; u < q.R * kLanes; u += blockDim.x) {
    const int r = u >> 7, lane = u & (kLanes - 1);
    const float2 l = lf[u];
    float col = 0.f, hs[kHighMax];
#pragma unroll
    for (int j = 0; j < kHighMax; ++j) hs[j] = 0.f;
    for (int h = 0; h < hi; ++h) {
      const int m = (r << q.nh) | h;
      const int o = m * kPitch + lane;
      const float2 f = hf[m];
      float dr, di;
      cmul(l.x, l.y, f.x, f.y, dr, di);
      const float ar = a.re[o], ai = a.im[o], cr = c.re[o], ci = c.im[o];
      const float pr = ar * cr + ai * ci, pi = ar * ci - ai * cr;   // conj(a) c
      const float ph = pr * di - pi * dr;
      col += ph;
#pragma unroll
      for (int j = 0; j < kHighMax; ++j)
        if (j < q.nh) hs[j] += ((h >> j) & 1) ? -ph : ph;
      c.re[o] = dr * cr + di * ci;
      c.im[o] = dr * ci - di * cr;
    }
    float* dst = xred + (r * 4 + (lane >> 5)) * kMaxQubits;
#pragma unroll
    for (int i = 0; i < kMaxQubits; ++i) {
      if (i >= q.n) break;
      const float v = i < kLaneQubits ? (((lane >> i) & 1) ? -col : col)
                                      : hs[i - kLaneQubits];
      const float s = warp_sum(v);
      if ((lane & 31) == 0) dst[i] = s;
    }
  }
}

// dst (rows of an (N, 2^n) pair, rows < N) <- src
__device__ void store_rows(float* dst_r, float* dst_i, Buf src, const Rows& q) {
  for (int t = threadIdx.x; t < q.valid_m * kLanes; t += blockDim.x) {
    dst_r[q.g0 + t] = src.re[off(t)];
    dst_i[q.g0 + t] = src.im[off(t)];
  }
}

// a register pass over gb (1..3) high bits, by its template
#define FUSED_HIGH_PASS(fn, gb, ...)      \
  do {                                    \
    if ((gb) == 1)                        \
      fn<1>(__VA_ARGS__);                 \
    else if ((gb) == 2)                   \
      fn<2>(__VA_ARGS__);                 \
    else                                  \
      fn<3>(__VA_ARGS__);                 \
  } while (0)

// H' on every high bit of b, 3 at a time, a barrier after each pass; the
// last pass as in wht_high
__device__ void wht_high_all(Buf b, const Rows& q, const float2* lf,
                             const float2* hf, float mult, Buf out,
                             float* pre_r, float* pre_i) {
  for (int g0 = 0; g0 < q.nh; g0 += kGroupBits) {
    const int gb = min(kGroupBits, q.nh - g0);
    const bool last = g0 + gb >= q.nh;
    FUSED_HIGH_PASS(wht_high, gb, b, q, g0, last, lf, hf, mult, out, pre_r, pre_i);
    __syncthreads();
  }
}

// the sublayer's 2x2s on y, 3 qubits a pass, the last pass scattering
// through the ring into dst (when dst.re is not null)
__device__ void butterflies_all(Buf y, const Rows& q, const float* u2s,
                                const int* rcols, Buf dst, float* pre_r,
                                float* pre_i) {
  for (int g0 = 0; g0 < q.nh; g0 += kGroupBits) {
    const int gb = min(kGroupBits, q.nh - g0);
    const bool last = g0 + gb >= q.nh;
    FUSED_HIGH_PASS(butterflies, gb, y, q, g0, last, u2s, rcols, dst, pre_r, pre_i);
    __syncthreads();
  }
}

// the rows' buffers, staging slots and small arrays of one CTA
struct Layout {
  Buf buf[4];
  float* slots;
  float2* lf;
  float2* hf;
  float* xs;
  float* xred;
  float* ured;
  float* u2s;      // the current sublayer's 2x2s, [j][re 4, im 4]
  int* rcols;      // the ring's images of single bits
};

// floats of the small arrays: lf, hf, xs, xred, ured, u2s, rcols
__host__ __device__ constexpr size_t aux_floats(int R, int M) {
  return 2 * static_cast<size_t>(R) * kLanes + 2 * static_cast<size_t>(M) +
         static_cast<size_t>(R) * kMaxQubits + 4 * static_cast<size_t>(R) * kMaxQubits +
         2 * kMaxWarps * kGroupBits * 8 + 8 * kMaxQubits + kMaxQubits;
}

// buffers: 2 (forward) or 4 (backward) pairs, in shared memory or in this
// CTA's part of scratch; then the slots and the small arrays
__device__ Layout layout(float* smem, float* scratch, int buffers, const Rows& q,
                         int nslots) {
  Layout L;
  const int tile = q.M * kPitch;
  float* base = scratch == nullptr
                    ? smem
                    : scratch + static_cast<size_t>(blockIdx.x) * 2 * buffers * tile;
  for (int i = 0; i < buffers; ++i) L.buf[i] = Buf{base + 2 * i * tile, base + (2 * i + 1) * tile};
  float* p = scratch == nullptr ? smem + 2 * buffers * tile : smem;
  L.slots = p;
  p += static_cast<size_t>(nslots) * kSlotFloats;
  L.lf = reinterpret_cast<float2*>(p);
  p += 2 * q.R * kLanes;
  L.hf = reinterpret_cast<float2*>(p);
  p += 2 * q.M;
  L.xs = p;
  p += q.R * kMaxQubits;
  L.xred = p;
  p += 4 * q.R * kMaxQubits;
  L.ured = p;
  p += 2 * kMaxWarps * kGroupBits * 8;
  L.u2s = p;
  p += 8 * kMaxQubits;
  L.rcols = reinterpret_cast<int*>(p);
  return L;
}

// the ring's images of single bits, by threads i < n (before a barrier)
__device__ __forceinline__ void ring_cols(int* rcols, int n) {
  if (static_cast<int>(threadIdx.x) < n) rcols[threadIdx.x] = ring_perm(1 << threadIdx.x, n);
}

// sublayer t's 2x2 entry i < 8 nh for u2s ([j][re 4, im 4]), loaded by
// thread i ahead of its use
__device__ __forceinline__ float u2_entry(const float* __restrict__ u2r,
                                          const float* __restrict__ u2i, int t, int nh) {
  const int i = threadIdx.x;
  if (t < 0 || i >= 8 * nh) return 0.f;
  const int j = i >> 3, e = i & 7;
  const size_t at = (static_cast<size_t>(t) * nh + j) * 4 + (e & 3);
  return e < 4 ? __ldg(u2r + at) : __ldg(u2i + at);
}

__device__ Rows rows_of(int n, int R, int n_rows) {
  Rows q;
  q.n = n;
  q.nh = n - kLaneQubits;
  q.R = R;
  q.M = R << q.nh;
  q.row0 = static_cast<long long>(blockIdx.x) * R;
  const long long valid = min(static_cast<long long>(R), n_rows - q.row0);
  q.valid_m = static_cast<int>(valid) << q.nh;
  q.g0 = static_cast<size_t>(q.row0) << n;
  return q;
}

// x of block b for this CTA's rows (zeros past N): thread i < R n holds
// angle i % n of row i / n
__device__ __forceinline__ float load_angle(const float* __restrict__ x, int b,
                                            const Rows& q, int n_rows) {
  const int i = threadIdx.x;
  if (i >= q.R * q.n) return 0.f;
  const long long row = q.row0 + i / q.n;
  return row < n_rows ? __ldg(x + (static_cast<size_t>(b) * n_rows + row) * q.n + i % q.n)
                      : 0.f;
}

__device__ __forceinline__ void store_angle(float* xs, float v, const Rows& q) {
  const int i = threadIdx.x;
  if (i < q.R * q.n) xs[(i / q.n) * kMaxQubits + i % q.n] = v;
}

// chunks a pass of the product takes: its 4 once per batch of n8 tiles
__device__ __forceinline__ int chunks_per_pass(int M) {
  const int per_warp = (M >> 3) / (mma_warps() >> 3);
  const int nb = per_warp >= kMaxNb ? kMaxNb : per_warp;
  return kChunks * (per_warp / nb);
}

// ── B2f: forward, primal output and (SAVE) each block's input state ──────

// THREADS: the block size it is built for (384 or 640), so that the
// smaller one may use up to 168 registers a thread
template <bool SAVE, int THREADS>
__global__ void __launch_bounds__(THREADS)
fused_chain_fwd_kernel(const float* __restrict__ u7t_r,
                       const float* __restrict__ u7t_i,
                       const float* __restrict__ u2_r,
                       const float* __restrict__ u2_i,
                       const float* __restrict__ x,
                       const int* __restrict__ sub_off,
                       const int* __restrict__ sched,
                       float* __restrict__ out_r, float* __restrict__ out_i,
                       float* __restrict__ st_r, float* __restrict__ st_i,
                       float* scratch, int nb, int n_rows, int n, int R,
                       int nslots, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Rows q = rows_of(n, R, n_rows);
  const Layout L = layout(smem, scratch, 2, q, nslots);
  const Buf s = L.buf[0], y = L.buf[1];
  const Buf none{nullptr, nullptr};
  const size_t nd = static_cast<size_t>(n_rows) << n;
  const int n_sub = sub_off[nb];
  const Stream st{u7t_r, u7t_i, sched, L.slots, n_sub * chunks_per_pass(q.M),
                  chunks_per_pass(q.M), nslots};

  for (int t = threadIdx.x; t < q.M * kLanes; t += blockDim.x) {   // |0...0>
    s.re[off(t)] = ((t & ((1 << n) - 1)) == 0 && t < q.valid_m * kLanes) ? 1.f : 0.f;
    s.im[off(t)] = 0.f;
  }
  store_angle(L.xs, load_angle(x, 0, q, n_rows), q);
  ring_cols(L.rcols, n);
  start_stream(st);
  int g = 0;
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    wht_low(s, q, nullptr, nullptr, SAVE ? st_r + b * nd : nullptr,
            SAVE ? st_i + b * nd : nullptr);
    build_factors(L.xs, L.lf, L.hf, q, scale);
    const float x_next = b + 1 < nb ? load_angle(x, b + 1, q, n_rows) : 0.f;
    __syncthreads();
    wht_high_all(s, q, L.lf, L.hf, 1.f, none, nullptr, nullptr);
    store_angle(L.xs, x_next, q);        // read again only by the next block
    const int s0 = sub_off[b], s1 = sub_off[b + 1];
    if (s0 == s1) {            // encoding-only block: its left Hadamard
      wht_low(s, q, nullptr, nullptr, nullptr, nullptr);
      __syncthreads();
      wht_high_all(s, q, nullptr, nullptr, scale, none, nullptr, nullptr);
      continue;
    }
    for (int t = s0; t < s1; ++t) {
      const float u2v = u2_entry(u2_r, u2_i, t, q.nh);
      low_product(st, g, s.re, s.im, y, q, false, L.u2s, u2v, 8 * q.nh);
      butterflies_all(y, q, L.u2s, L.rcols, s, nullptr, nullptr);
    }
  }
  store_rows(out_r, out_i, s, q);
}

// ── B2b: the reverse sweep ───────────────────────────────────────────────

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
fused_chain_bwd_kernel(const float* __restrict__ u7t_r,
                       const float* __restrict__ u7t_i,
                       const float* __restrict__ u2_r,
                       const float* __restrict__ u2_i,
                       const float* __restrict__ x,
                       const int* __restrict__ sub_off,
                       const int* __restrict__ sched,
                       const float* __restrict__ st_r,
                       const float* __restrict__ st_i,
                       const float* __restrict__ g_r,
                       const float* __restrict__ g_i,
                       float* pre_r, float* pre_i, float* ct_r, float* ct_i,
                       float* __restrict__ u2part, float* __restrict__ xbar,
                       float* scratch, int nb, int n_rows, int n, int R,
                       int nslots, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Rows q = rows_of(n, R, n_rows);
  const Layout L = layout(smem, scratch, 4, q, nslots);
  // a: H' s_in; b0, b1: the recompute's state and product output, then
  // the walk's cotangent and state; b2: the cotangent between products
  const Buf a = L.buf[0], b0 = L.buf[1], b1 = L.buf[2], b2 = L.buf[3];
  const Buf none{nullptr, nullptr};
  const size_t nd = static_cast<size_t>(n_rows) << n;
  const int n_sub = sub_off[nb];
  const int per_pass = chunks_per_pass(q.M);
  const Stream st{u7t_r, u7t_i, sched, L.slots, 2 * n_sub * per_pass, per_pass,
                  nslots};
  const int groups = (q.nh + kGroupBits - 1) / kGroupBits;
  int parity = 0;

  for (int t = threadIdx.x; t < q.M * kLanes; t += blockDim.x) {   // ct = g
    const bool ok = t < q.valid_m * kLanes;
    b2.re[off(t)] = ok ? g_r[q.g0 + t] : 0.f;
    b2.im[off(t)] = ok ? g_i[q.g0 + t] : 0.f;
  }
  store_angle(L.xs, load_angle(x, nb - 1, q, n_rows), q);
  ring_cols(L.rcols, n);
  start_stream(st);
  int g = 0;
  __syncthreads();

  for (int b = nb - 1; b >= 0; --b) {
    const int s0 = sub_off[b], s1 = sub_off[b + 1];
    // a = H' s_in; with sublayers, b0 = D a (the block's first pre-low state)
    wht_low(a, q, st_r + b * nd, st_i + b * nd, nullptr, nullptr);
    build_factors(L.xs, L.lf, L.hf, q, scale);
    const float x_next = b > 0 ? load_angle(x, b - 1, q, n_rows) : 0.f;
    __syncthreads();
    if (s0 == s1) {
      wht_high_all(a, q, nullptr, nullptr, 1.f, none, nullptr, nullptr);
      store_angle(L.xs, x_next, q);
      // back through the trailing H: ct <- H ct
      wht_low(b2, q, nullptr, nullptr, nullptr, nullptr);
      __syncthreads();
      wht_high_all(b2, q, nullptr, nullptr, scale, none, nullptr, nullptr);
    } else {
      wht_high_all(a, q, L.lf, L.hf, 1.f, b0, pre_r + s0 * nd, pre_i + s0 * nd);
      store_angle(L.xs, x_next, q);
      // recompute: the last sublayer's butterflies stay in b1 (the ring's
      // input, where the walk starts)
      for (int t = s0; t < s1; ++t) {
        const float u2v = u2_entry(u2_r, u2_i, t, q.nh);
        const bool more = t + 1 < s1;
        float* pr_next = more ? pre_r + (t + 1) * nd : nullptr;
        float* pi_next = more ? pre_i + (t + 1) * nd : nullptr;
        low_product(st, g, b0.re, b0.im, b1, q, false, L.u2s, u2v, 8 * q.nh);
        butterflies_all(b1, q, L.u2s, L.rcols, more ? b0 : none, pr_next, pi_next);
      }
      for (int t = s1 - 1; t >= s0; --t) {
        const bool kept = t == s1 - 1;
        float* part = u2part + (static_cast<size_t>(t) * gridDim.x + blockIdx.x) * q.nh * 8;
        for (int gi = groups - 1; gi >= 0; --gi) {
          const int g0 = gi * kGroupBits, gb = min(kGroupBits, q.nh - g0);
          float acc[kGroupBits * 8];
#pragma unroll
          for (int v = 0; v < kGroupBits * 8; ++v) acc[v] = 0.f;
          FUSED_HIGH_PASS(walk_back, gb, b2, b0, b1,
                          kept ? nullptr : pre_r + (t + 1) * nd,
                          kept ? nullptr : pre_i + (t + 1) * nd, q, g0,
                          gi == groups - 1, gi == 0, L.u2s, L.rcols,
                          ct_r + t * nd, ct_i + t * nd, acc);
          FUSED_HIGH_PASS(reduce_u2, gb, acc, L.ured, parity, part + 8 * g0);
        }
        // the walk of sublayer t - 1 reads its 2x2s from u2s
        const float u2v = u2_entry(u2_r, u2_i, t > s0 ? t - 1 : -1, q.nh);
        low_product(st, g, b0.re, b0.im, b2, q, true, L.u2s, u2v,
                    t > s0 ? 8 * q.nh : 0);
      }
    }
    // the phase's cotangent, xbar, then ct <- H conj(D) ct
    tail(a, b2, q, L.lf, L.hf, L.xred);
    __syncthreads();
    if (threadIdx.x < q.R * n) {
      const int r = threadIdx.x / n, i = threadIdx.x % n;
      float sum = 0.f;
      for (int w = 0; w < 4; ++w) sum += L.xred[(r * 4 + w) * kMaxQubits + i];
      if (q.row0 + r < n_rows)
        xbar[(static_cast<size_t>(b) * n_rows + q.row0 + r) * n + i] = 0.5f * sum;
    }
    wht_low(b2, q, nullptr, nullptr, nullptr, nullptr);
    __syncthreads();
    wht_high_all(b2, q, nullptr, nullptr, 1.f, none, nullptr, nullptr);
  }
}

// U7bar_t[m][j] = sum over rows q of conj(PRE_t[q][m]) CT_t[q][j], the rows
// of one slice, on the tensor cores: chunks of 32 rows of the 64 columns m
// of PRE and the 64 columns j of CT staged by cp.async in a 3-stage ring
// (zeros past the slice) by kCopyWarps copy warps, each of the eight MMA
// warps a 32 x 16 part of the 64 x 64 tile.
__global__ void __launch_bounds__(kGemmThreads + kCopyThreads)
fused_u7bar_kernel(const float* __restrict__ pre_r,
                   const float* __restrict__ pre_i,
                   const float* __restrict__ ct_r,
                   const float* __restrict__ ct_i, float* __restrict__ out_r,
                   float* __restrict__ out_i, int n_sub, long long rows,
                   long long rows_per_split) {
  extern __shared__ __align__(16) float gsm[];
  const int t = blockIdx.x / 4, tile = blockIdx.x % 4;
  const int m0 = (tile / 2) * kGemmTile, j0 = (tile % 2) * kGemmTile;
  const long long q_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long q_end = q_begin + rows_per_split < rows ? q_begin + rows_per_split : rows;
  const int chunks = static_cast<int>((q_end - q_begin + kGemmChunk - 1) / kGemmChunk);
  const size_t sub = static_cast<size_t>(t) * rows * kLanes;
  const float* src[4] = {pre_r + sub + m0, pre_i + sub + m0, ct_r + sub + j0, ct_i + sub + j0};
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (w >> 2) * 32, wn = (w & 3) * 16;

  const bool copier = w >= kGemmThreads / 32;
  auto issue = [&](int c) {
    if (!copier) return;
    if (c < chunks) {
      float* stage = gsm + (c % kGemmStages) * kGemmStageFloats;
      for (int v = threadIdx.x - kGemmThreads; v < 4 * kGemmChunk * (kGemmTile / 4);
           v += kCopyThreads) {
        const int arr = v / (kGemmChunk * kGemmTile / 4);
        const int rem = v % (kGemmChunk * kGemmTile / 4);
        const int row = rem / (kGemmTile / 4), e = rem % (kGemmTile / 4);
        const long long q = q_begin + static_cast<long long>(c) * kGemmChunk + row;
        const bool ok = q < q_end;
        cp_async16_zfill(stage + (arr * kGemmChunk + row) * kGemmPitch + 4 * e,
                         ok ? src[arr] + static_cast<size_t>(q) * kLanes + 4 * e : src[arr],
                         ok);
      }
    }
    cp_async_commit();
  };

  float yr[2][2][4], yi[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) yr[a][c][e] = yi[a][c][e] = 0.f;

  issue(0);
  issue(1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait(kGemmStages - 2);
    __syncthreads();
    issue(c + kGemmStages - 1);
    if (copier) continue;
    const float* stage = gsm + (c % kGemmStages) * kGemmStageFloats;
    const float* a_r = stage;
    const float* a_i = stage + kGemmChunk * kGemmPitch;
    const float* b_r = stage + 2 * kGemmChunk * kGemmPitch;
    const float* b_i = stage + 3 * kGemmChunk * kGemmPitch;
#pragma unroll
    for (int ks = 0; ks < kGemmChunk / 8; ++ks) {
      const int k = (ks * 8 + tig) * kGemmPitch;
      FragA fa[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {   // A[m][q] = conj(PRE[q][m])
        const int o = k + wm + 16 * a + gid;
        const float ar[4] = {a_r[o], a_r[o + 8], a_r[o + 4 * kGemmPitch],
                             a_r[o + 4 * kGemmPitch + 8]};
        const float ai[4] = {-a_i[o], -a_i[o + 8], -a_i[o + 4 * kGemmPitch],
                             -a_i[o + 4 * kGemmPitch + 8]};
        load_frag_a(fa[a], ar, ai);
      }
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int o = k + wn + 8 * c2 + gid;
#pragma unroll
        for (int a = 0; a < 2; ++a)
          cmma(yr[a][c2], yi[a][c2], fa[a], b_r[o], b_r[o + 4 * kGemmPitch], b_i[o],
               b_i[o + 4 * kGemmPitch]);
      }
    }
  }
  if (copier) return;
  const size_t out0 = (static_cast<size_t>(blockIdx.y) * n_sub + t) * kLanes * kLanes;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      const size_t o = out0 + static_cast<size_t>(m0 + wm + 16 * a + gid) * kLanes + j0 +
                       wn + 8 * c2 + 2 * tig;
      out_r[o] = yr[a][c2][0]; out_r[o + 1] = yr[a][c2][1];
      out_r[o + 8 * kLanes] = yr[a][c2][2]; out_r[o + 8 * kLanes + 1] = yr[a][c2][3];
      out_i[o] = yi[a][c2][0]; out_i[o + 1] = yi[a][c2][1];
      out_i[o + 8 * kLanes] = yi[a][c2][2]; out_i[o + 8 * kLanes + 1] = yi[a][c2][3];
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
  int M, threads, grid, nslots;
  size_t bytes;   // dynamic shared memory
};

// rows_per_cta * 2^(n-7) = M tile rows, a multiple of 8; 256 MMA threads
// below 64 tile rows, else 512, and the copy warp; buffers: 2 (forward) or
// 4 (backward) pairs of
// M x kPitch floats, in shared memory when smem (else in the caller's
// scratch), then as many staging slots as fit (2 .. kMaxSlots) and the
// small arrays
bool geometry(int n, int n_rows, int rows_per_cta, int buffers, bool smem,
              Geometry* g) {
  if (n <= kLaneQubits || n > kMaxQubits || n_rows < 1 || rows_per_cta < 1) return false;
  g->M = rows_per_cta << (n - kLaneQubits);
  if (g->M % 8) return false;
  g->threads = (g->M >= 64 ? kMaxConsumers : kMaxConsumers / 2) + kCopyThreads;
  g->grid = (n_rows + rows_per_cta - 1) / rows_per_cta;
  const size_t slot = sizeof(float) * kSlotFloats;
  const size_t fixed =
      sizeof(float) * ((smem ? 2 * static_cast<size_t>(buffers) * g->M * kPitch : 0) +
                       aux_floats(rows_per_cta, g->M));
  if (fixed + 2 * slot > kSmemBytes) return false;
  const size_t fit = (kSmemBytes - fixed) / slot;
  g->nslots = static_cast<int>(fit < kMaxSlots ? fit : kMaxSlots);
  g->bytes = fixed + g->nslots * slot;
  return true;
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_fused.py).  Each takes device pointers of
// contiguous fp32 (sub_off, sched: int32) tensors and the stream to launch
// on, and returns the cudaError_t of its launches (0 on success).
// 8 <= n <= 16, nb >= 1, n_rows >= 1; rows_per_cta * 2^(n-7) a multiple of
// 8.  scratch, when not null, holds the CTAs' rows in device memory:
// (grid, 2 * buffers, M * 132) floats, buffers 2 for the forward and 4 for
// the backward, grid = ceil(n_rows / rows_per_cta), M = rows_per_cta *
// 2^(n-7); when null, the rows live in shared memory and must fit there.
// u7t must be 16-byte aligned.  sched: forward, the S sublayers in order
// (2 t); backward, per block in reverse, its sublayers in order (2 t), then
// in reverse (2 t + 1).

// B2f.  x (nb, n_rows, n).  st_r, st_i (nb, n_rows, 2^n): each block's
// input state, written when not null (the residuals of the backward).
extern "C" int fused_chain_forward(const float* u7t_r, const float* u7t_i,
                                   const float* u2_r, const float* u2_i,
                                   const float* x, const int* sub_off,
                                   const int* sched, float* out_r,
                                   float* out_i, float* st_r, float* st_i,
                                   float* scratch, int nb, int n_rows, int n,
                                   int rows_per_cta, void* stream) {
  Geometry g;
  if (nb < 1 || !geometry(n, n_rows, rows_per_cta, 2, scratch == nullptr, &g) ||
      (st_r == nullptr) != (st_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kSmall = kMaxConsumers / 2 + kCopyThreads;
  const bool big = g.threads == kMaxThreads;
  const auto kernel = st_r != nullptr
                          ? (big ? fused_chain_fwd_kernel<true, kMaxThreads>
                                 : fused_chain_fwd_kernel<true, kSmall>)
                          : (big ? fused_chain_fwd_kernel<false, kMaxThreads>
                                 : fused_chain_fwd_kernel<false, kSmall>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.bytes));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, g.threads, g.bytes, s>>>(u7t_r, u7t_i, u2_r, u2_i, x, sub_off, sched,
                                             out_r, out_i, st_r, st_i, scratch, nb,
                                             n_rows, n, rows_per_cta, g.nslots,
                                             hadamard_scale(n));
  return cudaGetLastError();
}

// B2b.  g_r, g_i (n_rows, 2^n): the output's cotangent; st_r, st_i the
// forward's residuals.  Scratch: pre_r, pre_i, ct_r, ct_i (n_sub, n_rows,
// 2^n); u2part (n_sub, grid, n-7, 8); u7part_r, u7part_i (splits, n_sub,
// 128, 128), used when splits > 1.  Writes u7bar_r, u7bar_i (n_sub, 128,
// 128), u2bar_r, u2bar_i (n_sub, n-7, 4) and xbar (nb, n_rows, n).
extern "C" int fused_chain_backward(
    const float* u7t_r, const float* u7t_i, const float* u2_r,
    const float* u2_i, const float* x, const int* sub_off, const int* sched,
    const float* st_r, const float* st_i, const float* g_r, const float* g_i,
    float* pre_r, float* pre_i, float* ct_r, float* ct_i, float* u2part,
    float* u7part_r, float* u7part_i, float* scratch, float* u7bar_r,
    float* u7bar_i, float* u2bar_r, float* u2bar_i, float* xbar, int nb,
    int n_sub, int n_rows, int n, int rows_per_cta, int splits, void* stream) {
  Geometry g;
  if (nb < 1 || n_sub < 0 || splits < 1 ||
      !geometry(n, n_rows, rows_per_cta, 4, scratch == nullptr, &g) ||
      (splits > 1 && (u7part_r == nullptr || u7part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = g.threads == kMaxThreads
                          ? fused_chain_bwd_kernel<kMaxThreads>
                          : fused_chain_bwd_kernel<kMaxConsumers / 2 + kCopyThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.bytes));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, g.threads, g.bytes, s>>>(
      u7t_r, u7t_i, u2_r, u2_i, x, sub_off, sched, st_r, st_i, g_r, g_i, pre_r, pre_i,
      ct_r, ct_i, u2part, xbar, scratch, nb, n_rows, n, rows_per_cta, g.nslots,
      hadamard_scale(n));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_sub == 0) return err;

  const long long rows = static_cast<long long>(n_rows) << (n - kLaneQubits);
  const long long per_split = (rows + splits - 1) / splits;
  const dim3 ggrid(static_cast<unsigned>(n_sub * 4), static_cast<unsigned>(splits));
  const size_t gbytes = sizeof(float) * kGemmStages * kGemmStageFloats;
  err = cudaFuncSetAttribute(fused_u7bar_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gbytes));
  if (err != cudaSuccess) return err;
  fused_u7bar_kernel<<<ggrid, kGemmThreads + kCopyThreads, gbytes, s>>>(
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
