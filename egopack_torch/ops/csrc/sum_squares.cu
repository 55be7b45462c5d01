// Sums of squares of many float32 tensors into a few output slots, in two
// launches: the train step's global and per-layer L2 norms.
//
// Replaces no TPU kernel. The JAX package takes the norms with
// optax.global_norm (egopack_tpu/train/system.py:75-76), which XLA fuses on
// the TPU; the plain PyTorch version (ops/sum_squares.py,
// sum_squares_reference) queues a square, a sum and an add for every tensor,
// several hundred small launches a step. This kernel computes the same
// function: slot s holds the sum over the tensors whose slot list names s of
// the squares of their elements, or its square root.
//
// Bound: memory. Each element is read once for one multiply-add, far below
// the card's operations-per-byte ridge, so the design is one pass over every
// tensor with enough bytes in flight to keep the memory busy:
// - the host packs every tensor (pointer, size, first chunk) and the slots'
//   member lists into one table passed by value in the kernel's parameters
//   (Hopper's 32 KB parameter space), so no copy to the card precedes the
//   launch and a CUDA graph captures the launch as it is;
// - each tensor is cut into chunks of kChunk elements; a grid of a few
//   blocks a multiprocessor walks the chunks of all tensors (block b takes
//   chunks b, b + gridDim.x, ...), so small tensors share blocks;
// - a thread issues all kVec 16-byte loads of its part of a chunk before it
//   uses one; the leading elements up to a 16-byte boundary and the ragged
//   tail take scalar loads;
// - each chunk's sum goes to its own float64 partial; a second launch of one
//   block sums each tensor's partials, then each slot's tensors, in a fixed
//   order. No atomics: the result is the same bit for bit on every call.
// A thread sums its 32 squares of a chunk in float32; the warp, block and
// cross-block sums are float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 512;   // must match MAX_LEAVES in sum_squares.py
constexpr int kMaxSlots = 256;    // must match MAX_SLOTS
constexpr int kMaxMembers = 1024; // must match MAX_MEMBERS
constexpr int kThreads = 256;
constexpr int kVec = 8;                           // float4 loads a thread
constexpr long long kChunk = kThreads * kVec * 4; // 8192 elements, 32 KB
constexpr int kBlocksPerSm = 4;
constexpr int kFinishThreads = 512;

struct Table {
  int n_leaves;
  int n_slots;
  int roots;
  int chunk_start[kMaxLeaves + 1];  // first chunk of each tensor
  long long numel[kMaxLeaves];
  const float* ptr[kMaxLeaves];
  // the leaves of slot s: member[slot_start[s]] .. member[slot_start[s+1] - 1]
  int slot_start[kMaxSlots + 1];
  unsigned short member[kMaxMembers];
};

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;  // in lane 0
}

__device__ __forceinline__ float sq4(float acc, const float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

__global__ void __launch_bounds__(kThreads)
    sumsq_partial(const __grid_constant__ Table t, double* partials) {
  __shared__ double warp_sums[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = t.chunk_start[t.n_leaves];
  int parity = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x, parity ^= 1) {
    // the tensor of chunk c: the last one whose first chunk is at most c
    // (an empty tensor starts where the next one does, so it is skipped)
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const float* p = t.ptr[lo];
    const long long begin = (c - t.chunk_start[lo]) * kChunk;
    const long long end = min(begin + kChunk, t.numel[lo]);
    // kChunk floats are a multiple of 16 bytes, so every chunk of a tensor
    // starts as far from a 16-byte boundary as the tensor does
    const int lead = static_cast<int>(
        ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
    const long long body = min(begin + lead, end);
    const long long n4 = (end - body) >> 2;
    const float4* q = reinterpret_cast<const float4*>(p + body);
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = threadIdx.x + static_cast<long long>(k) * kThreads;
      v[k] = j < n4 ? __ldg(q + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc = sq4(acc, v[k]);
    const long long tail = body + 4 * n4;
    if (threadIdx.x < body - begin) {
      const float x = __ldg(p + begin + threadIdx.x);
      acc = fmaf(x, x, acc);
    }
    if (threadIdx.x < end - tail) {
      const float x = __ldg(p + tail + threadIdx.x);
      acc = fmaf(x, x, acc);
    }
    const double s = warp_sum(static_cast<double>(acc));
    if (lane == 0) warp_sums[parity][warp] = s;
    // the buffers alternate, so the next chunk's writes cannot meet this
    // chunk's reads, and the one after waits at its own barrier
    __syncthreads();
    if (threadIdx.x == 0) {
      double b = 0.0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) b += warp_sums[parity][w];
      partials[c] = b;
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    sumsq_finish(const __grid_constant__ Table t, const double* partials,
                 float* out) {
  __shared__ double leaf_sum[kMaxLeaves];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < t.n_leaves; i += kFinishThreads / 32) {
    double s = 0.0;
    for (int c = t.chunk_start[i] + lane; c < t.chunk_start[i + 1]; c += 32) {
      s += partials[c];
    }
    s = warp_sum(s);
    if (lane == 0) leaf_sum[i] = s;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < t.n_slots; s += kFinishThreads) {
    double v = 0.0;
    for (int m = t.slot_start[s]; m < t.slot_start[s + 1]; ++m) {
      v += leaf_sum[t.member[m]];
    }
    out[s] = static_cast<float>(t.roots ? sqrt(v) : v);
  }
}

}  // namespace

// out[s] for s < n_slots, as above, over n_leaves (1..kMaxLeaves) tensors:
// leaf i holds numel[i] float32 values at ptr[i]; slot s sums the leaves
// member[slot_start[s]..slot_start[s+1]). partials holds at least as many
// float64 values as there are chunks (egopack_sum_squares_chunks). Two
// launches on `stream`, the first left out where every leaf is empty;
// returns the cudaError_t of the first that failed (0 on success); the
// caller raises on anything else.
extern "C" int egopack_sum_squares(int n_leaves, const long long* numel,
                                   void* const* ptr, int n_slots,
                                   const int* slot_start,
                                   const unsigned short* member, int roots,
                                   void* partials, void* out, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_slots < 1 ||
      n_slots > kMaxSlots || slot_start[0] != 0 ||
      slot_start[n_slots] > kMaxMembers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  t.n_leaves = n_leaves;
  t.n_slots = n_slots;
  t.roots = roots;
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (numel[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_start[i] = static_cast<int>(chunks);
    t.numel[i] = numel[i];
    t.ptr[i] = static_cast<const float*>(ptr[i]);
    chunks += (numel[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.chunk_start[n_leaves] = static_cast<int>(chunks);
  for (int s = 0; s <= n_slots; ++s) {
    if (s > 0 && slot_start[s] < slot_start[s - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.slot_start[s] = slot_start[s];
  }
  for (int m = 0; m < slot_start[n_slots]; ++m) {
    if (member[m] >= n_leaves) return static_cast<int>(cudaErrorInvalidValue);
    t.member[m] = member[m];
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  if (chunks > 0) {
    const long long most = static_cast<long long>(sms) * kBlocksPerSm;
    const unsigned grid = static_cast<unsigned>(chunks < most ? chunks : most);
    sumsq_partial<<<grid, kThreads, 0, s>>>(t, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sumsq_finish<<<1, kFinishThreads, 0, s>>>(t, part, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The number of chunks, and so of float64 partials, for these sizes.
extern "C" long long egopack_sum_squares_chunks(int n_leaves,
                                                const long long* numel) {
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    chunks += (numel[i] + kChunk - 1) / kChunk;
  }
  return chunks;
}

extern "C" const char* egopack_sum_squares_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
