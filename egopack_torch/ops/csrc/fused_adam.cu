// Fused Adam step with coupled L2 weight decay, over many tensors in one launch.
//
// Replaces the Pallas TPU kernel egopack_tpu/ops/pallas/fused_adam.py
// (fused_adam_leaf -> _adam_kernel, _adam_math). Per element:
//
//   u  = g + wd*p                  (wd == 0: u = g)
//   m' = b1*m + (1-b1)*u           rounded to the moments type
//   v' = b2*v + (1-b2)*(u*u)       rounded to the moments type
//   p' = p + ((m'/bc1) / (sqrt(v'/bc2) + eps)) * (-lr)
//
// p and g are float32; m and v are float32 or bfloat16 (the template
// parameter). p, m and v are updated in place. lr, bc1 and bc2 arrive as
// float32 values computed by the caller.
//
// Bound: memory. Each element reads p, g, m, v and writes p, m, v once
// (28 bytes with float32 moments, 20 with bfloat16) for about a dozen
// float32 operations, far below the card's operations-per-byte ridge. The
// design therefore does one pass over every trainable tensor in ONE launch:
// the host packs up to kMaxTensors (pointer, size) entries into the kernel's
// parameter block, each block takes one kChunk-element slice of one tensor,
// and neighbouring threads touch neighbouring elements so loads coalesce.
// Vectorised 16-byte accesses are later work.
//
// Numerics: build with --fmad=false so that no multiply-add is contracted;
// with IEEE division and square root (nvcc's defaults) every operation then
// rounds exactly as the plain PyTorch version (ops/fused_adam.py,
// fused_adam_reference) rounds it, and the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 64;  // must match MAX_TENSORS in fused_adam.py
constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements per block

struct TensorTable {
  int n_tensors;
  int chunk_start[kMaxTensors + 1];  // first block of each tensor
  long long numel[kMaxTensors];
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* m[kMaxTensors];
  void* v[kMaxTensors];
};

struct Hyper {
  float neg_lr, bc1, bc2, wd, b1, omb1, b2, omb2, eps;
};

template <typename T>
struct Moments;

template <>
struct Moments<float> {
  __device__ static float load(const float* a, long long j) { return a[j]; }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* a, long long j, float x) { a[j] = x; }
};

template <>
struct Moments<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* a, long long j) {
    return __bfloat162float(a[j]);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // x is already a bfloat16 value, so the conversion is exact
  __device__ static void store(__nv_bfloat16* a, long long j, float x) {
    a[j] = __float2bfloat16_rn(x);
  }
};

template <typename MT>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ TensorTable t, const Hyper h) {
  using M = Moments<MT>;
  const int chunk = blockIdx.x;
  int i = 0;
  while (i + 1 < t.n_tensors && t.chunk_start[i + 1] <= chunk) ++i;
  const long long begin = (chunk - t.chunk_start[i]) * kChunk;
  const long long end = min(begin + kChunk, t.numel[i]);
  float* p = t.p[i];
  const float* g = t.g[i];
  MT* m = static_cast<MT*>(t.m[i]);
  MT* v = static_cast<MT*>(t.v[i]);
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const float pj = p[j];
    const float gj = g[j];
    const float u = h.wd != 0.0f ? gj + h.wd * pj : gj;
    const float m2 = M::round(h.b1 * M::load(m, j) + h.omb1 * u);
    const float v2 = M::round(h.b2 * M::load(v, j) + h.omb2 * (u * u));
    const float upd = (m2 / h.bc1) / (sqrtf(v2 / h.bc2) + h.eps);
    p[j] = pj + upd * h.neg_lr;
    M::store(m, j, m2);
    M::store(v, j, v2);
  }
}

}  // namespace

// One launch over n_tensors (1..kMaxTensors) tensors on `stream`. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int egopack_fused_adam(int moments_bf16, int n_tensors,
                                  const long long* numel, void* const* p,
                                  void* const* g, void* const* m,
                                  void* const* v, float lr, float bc1,
                                  float bc2, float wd, float b1, float omb1,
                                  float b2, float omb2, float eps,
                                  void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TensorTable t;
  t.n_tensors = n_tensors;
  long long chunks = 0;
  for (int i = 0; i < n_tensors; ++i) {
    if (numel[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_start[i] = static_cast<int>(chunks);
    t.numel[i] = numel[i];
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.m[i] = m[i];
    t.v[i] = v[i];
    chunks += (numel[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.chunk_start[n_tensors] = static_cast<int>(chunks);
  if (chunks == 0) return 0;
  const Hyper h{-lr, bc1, bc2, wd, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks));
  if (moments_bf16) {
    adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, h);
  } else {
    adam_kernel<float><<<grid, kThreads, 0, s>>>(t, h);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egopack_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
