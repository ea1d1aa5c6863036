// Adam update of every parameter leaf in one launch, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of quanonet_tpu/ops/pallas_adam.py, _adam_kernel
// (B5), with the same rule (optax.scale_by_adam: the two moment averages,
// bias correction 1 - exp(t log b), the denominator sqrt(v_hat) + eps):
//
//     m <- b1 m + (1 - b1) g            v <- b2 v + (1 - b2) g g
//     p <- p - lr (m / c1) / (sqrt(v / c2) + eps)
//     c1 = 1 - exp(t log b1)            c2 = 1 - exp(t log b2)
//
// p, m and v are updated in place.  Plain version:
// quanonet_torch/ops/cuda_adam.py adam_step_dense.
//
// What bounds it.  Seven fp32 words an element move (p, g, m, v read; p,
// m, v written), plus one entry of the learning-rate table and the update
// count (read once, written once), for about a dozen operations: bound by
// bytes at any size.  The flagship has 2,401 parameters in six leaves,
// 67 KB in all, which the card moves in 0.02 us: there a call is bound by
// its launch, and what a training step pays is the host's work around it.
//
// Design.  Nothing per step on the host but the launch.  The leaves'
// pointers, sizes and first chunks are written once, at bind, into a table
// that the binding keeps on the host (adam_bind); the gradients' column is
// written again only when a gradient has moved (adam_set_grads).  A launch
// hands the table to the kernel by value, as a __grid_constant__
// argument, so every CTA reads its leaf's pointers from the constant bank
// and its first loads are the data (a table in device memory measured
// three dependent loads slower).  Up to kMaxLeaves leaves a binding; the
// wrapper binds more in groups, and only the last launch of a step
// advances the count.  lr and t live on the card, as the TPU kernel takes
// them from its (1, 2) operand: every CTA reads the update count c, takes
// t = c + 1 and lr = lr_table[min(c, len - 1)], and the last CTA to have
// read it (a ticket beside the count: __threadfence, then atomicAdd)
// writes c + 1 and resets the ticket, so the count advances by exactly
// one a step and nothing on the host changes between two steps.  One CTA
// a chunk of 256 elements of one leaf (13 CTAs at the flagship; a single
// CTA walking every chunk measured 3.3 times slower on an H100).  c1 and
// c2 are taken in fp32 with expf, as the TPU kernel takes them.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];   // null: the leaf has no gradient, skipped
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long size[kMaxLeaves];
  int first[kMaxLeaves + 1];    // each leaf's first chunk, then the count
  int leaves;
};

struct Rate {
  const float* lr;
  int lr_len;
  int* count;          // [the updates made, the ticket]
  int advance;
  float b1, b2, one_minus_b1, one_minus_b2, log_b1, log_b2, eps;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ LeafTable tab, const Rate r) {
  const int c = r.count[0];
  const float t = static_cast<float>(c + 1);
  const float lr = r.lr[min(c, r.lr_len - 1)];
  const float c1 = 1.0f - expf(t * r.log_b1);
  const float c2 = 1.0f - expf(t * r.log_b2);
  const int k = blockIdx.x;   // this CTA's chunk
  int leaf = 0;
  while (tab.first[leaf + 1] <= k) ++leaf;
  const float* g = tab.g[leaf];
  const long long e =
      static_cast<long long>(k - tab.first[leaf]) * kThreads + threadIdx.x;
  if (g != nullptr && e < tab.size[leaf]) {
    float* p = tab.p[leaf];
    float* pm = tab.m[leaf];
    float* pv = tab.v[leaf];
    const float ge = g[e];
    const float m = r.b1 * pm[e] + r.one_minus_b1 * ge;
    const float v = r.b2 * pv[e] + r.one_minus_b2 * (ge * ge);
    const float upd = (m / c1) / (sqrtf(v / c2) + r.eps);
    p[e] -= lr * upd;
    pm[e] = m;
    pv[e] = v;
  }
  if (!r.advance) return;
  __syncthreads();   // every thread of this CTA has read the count
  if (threadIdx.x != 0) return;
  unsigned* ticket = reinterpret_cast<unsigned*>(r.count + 1);
  __threadfence();
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  *ticket = 0;
  r.count[0] = c + 1;
}

struct Binding {
  LeafTable tab;
  int leaves;
  int grid;
  float b1, b2, one_minus_b1, one_minus_b2, log_b1, log_b2, eps;
};

int fill(LeafTable& tab, void* const* p, void* const* m, void* const* v,
         const long long* size, int leaves) {
  long long chunks = 0;
  for (int i = 0; i < leaves; ++i) {
    tab.p[i] = static_cast<float*>(p[i]);
    tab.g[i] = nullptr;
    tab.m[i] = static_cast<float*>(m[i]);
    tab.v[i] = static_cast<float*>(v[i]);
    tab.size[i] = size[i];
    tab.first[i] = static_cast<int>(chunks);
    chunks += (size[i] + kThreads - 1) / kThreads;
    if (chunks > 0x7fffffffLL) return -1;
  }
  tab.first[leaves] = static_cast<int>(chunks);
  tab.leaves = leaves;
  return static_cast<int>(chunks);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_adam.py).
//
// Leaves a binding takes at most.
extern "C" int adam_max_leaves() { return kMaxLeaves; }

// Binds `leaves` (1 .. adam_max_leaves()) contiguous fp32 leaves: p, m, v
// host arrays of device pointers, size[i] >= 1 elements each; no gradient
// yet (every leaf skipped until adam_set_grads).  The grid: one CTA a
// chunk of 256 elements.  On success *handle holds the binding; returns a
// cudaError_t.
extern "C" int adam_bind(void* const* p, void* const* m, void* const* v,
                         const long long* size, int leaves, double b1,
                         double b2, double eps, void** handle) {
  *handle = nullptr;
  if (leaves < 1 || leaves > kMaxLeaves) return invalid();
  for (int i = 0; i < leaves; ++i)
    if (size[i] < 1) return invalid();
  auto* b = new Binding();
  b->leaves = leaves;
  const int chunks = fill(b->tab, p, m, v, size, leaves);
  if (chunks < 1) {
    delete b;
    return invalid();
  }
  b->grid = chunks;
  b->b1 = static_cast<float>(b1);
  b->b2 = static_cast<float>(b2);
  b->one_minus_b1 = static_cast<float>(1.0 - b1);
  b->one_minus_b2 = static_cast<float>(1.0 - b2);
  b->log_b1 = static_cast<float>(std::log(b1));
  b->log_b2 = static_cast<float>(std::log(b2));
  b->eps = static_cast<float>(eps);
  *handle = b;
  return 0;
}

// The gradients' column: g a host array of one device pointer a leaf, in
// the bind's order, null for a leaf without a gradient.  It is the table
// of the launches after this call.
extern "C" void adam_set_grads(void* handle, void* const* g) {
  auto* b = static_cast<Binding*>(handle);
  for (int i = 0; i < b->leaves; ++i)
    b->tab.g[i] = static_cast<const float*>(g[i]);
}

// One update of every bound leaf on `stream`: lr_table lr_len >= 1 fp32
// rates on the card; count two ints on the card, the updates made so far
// and the ticket (0 between launches); with `advance`, the launch adds one
// to the count.  Returns the cudaError_t of the launch.
extern "C" int adam_step(void* handle, const float* lr_table, int lr_len,
                         int* count, int advance, void* stream) {
  const auto* b = static_cast<const Binding*>(handle);
  if (lr_len < 1) return invalid();
  const Rate r{lr_table, lr_len, count, advance, b->b1, b->b2,
               b->one_minus_b1, b->one_minus_b2, b->log_b1, b->log_b2,
               b->eps};
  const auto s = static_cast<cudaStream_t>(stream);
  adam_kernel<<<b->grid, kThreads, 0, s>>>(b->tab, r);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of one launch.
extern "C" int adam_grid(void* handle) {
  return static_cast<const Binding*>(handle)->grid;
}

extern "C" void adam_free(void* handle) {
  delete static_cast<Binding*>(handle);
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
