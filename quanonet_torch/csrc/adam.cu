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
// m, v written) for about a dozen operations: bound by bytes at any size.
// The flagship has 2,401 parameters in six leaves, 67 KB in all, which
// the card moves in 0.02 us: a call is bound by its launch.  What the
// kernel saves is launches: an unfused optimizer walks the leaves and
// issues several small kernels for each.
//
// Design.  The leaves' pointers and sizes travel by value in the kernel's
// arguments (up to kMaxLeaves a launch, 2.8 KB of the 4 KB an argument
// list may hold), so there is no table to copy to the card and nothing to
// allocate.  The grid is one CTA per 256 elements of a leaf; a CTA finds
// its leaf by walking the table's first-CTA column.  lr and t are scalars
// of the launch; c1 and c2 are taken in fp32 with expf, as the TPU kernel
// takes them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long size[kMaxLeaves];
  int first_cta[kMaxLeaves + 1];
  int count;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ LeafTable tab, float lr, float t, float b1,
            float b2, float one_minus_b1, float one_minus_b2, float log_b1,
            float log_b2, float eps) {
  const int cta = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < tab.count && tab.first_cta[leaf + 1] <= cta) ++leaf;
  const long long e =
      static_cast<long long>(cta - tab.first_cta[leaf]) * kThreads + threadIdx.x;
  if (e >= tab.size[leaf]) return;
  const float c1 = 1.0f - expf(t * log_b1);
  const float c2 = 1.0f - expf(t * log_b2);
  const float g = tab.g[leaf][e];
  const float m = b1 * tab.m[leaf][e] + one_minus_b1 * g;
  const float v = b2 * tab.v[leaf][e] + one_minus_b2 * (g * g);
  const float upd = (m / c1) / (sqrtf(v / c2) + eps);
  tab.p[leaf][e] -= lr * upd;
  tab.m[leaf][e] = m;
  tab.v[leaf][e] = v;
}

}  // namespace

// C interface, built by quanonet_torch/ops/_build.py and called through
// ctypes (quanonet_torch/ops/cuda_adam.py).  p, g, m, v: host arrays of
// `count` device pointers to contiguous fp32 leaves of `size[i]` elements
// (count <= 64, every size >= 1).  Updates p, m, v in place on `stream`
// and returns the cudaError_t of the launch (0 on success).
extern "C" int adam_step(void* const* p, void* const* g, void* const* m,
                         void* const* v, const long long* size, int count,
                         float lr, float t, float b1, float b2,
                         float one_minus_b1, float one_minus_b2, float log_b1,
                         float log_b2, float eps, void* stream) {
  if (count < 1 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable tab;
  long long ctas = 0;
  for (int i = 0; i < count; ++i) {
    if (size[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    tab.p[i] = static_cast<float*>(p[i]);
    tab.g[i] = static_cast<const float*>(g[i]);
    tab.m[i] = static_cast<float*>(m[i]);
    tab.v[i] = static_cast<float*>(v[i]);
    tab.size[i] = size[i];
    tab.first_cta[i] = static_cast<int>(ctas);
    ctas += (size[i] + kThreads - 1) / kThreads;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  tab.first_cta[count] = static_cast<int>(ctas);
  tab.count = count;
  adam_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      tab, lr, t, b1, b2, one_minus_b1, one_minus_b2, log_b1, log_b2, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
