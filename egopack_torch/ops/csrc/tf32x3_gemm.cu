// Batched float32 matrix products on the tensor cores, to float32 accuracy:
// C[b] = op(A[b]) @ op(B[b]) (+ bias), split TF32 ("3xTF32") on wgmma.
//
// Replaces no TPU kernel. The JAX package leaves its products to XLA
// (jnp.dot in egopack_tpu/models/layers.py:TLinear, jnp.einsum in
// egopack_tpu/models/graphone.py:interact), as the port left them to
// cuBLAS; the configurations state float32 compute, which cuBLAS runs on
// the CUDA cores (67 TFLOP/s), and TF32 alone (one tensor-core product)
// changes the result. This kernel keeps float32-level error on the tensor
// cores: every operand x is split into hi, x rounded to the nearest TF32
// value, and lo = x - hi (exact in float32, at most 2^-12 |x|, of which the
// tensor cores read the 11 leading bits), and a.b is taken as a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi; a_lo.b_lo and lo's bits past its 11th (each about
// 2^-23 of |a||b|) are dropped, as the kNN's pass 1 drops the first
// (knn_topk.cu). Each k-step
// of 32 is summed on the tensor cores into a fresh accumulator, its 8 small
// products before its 4 large ones, and then added into the running float32
// sum by the CUDA cores (round to nearest): the tensor cores' own rounding
// of a sum falls on 4 large products at a time, never on the whole K.
//
// Layouts, with K the summed dimension (row-major storage throughout):
//   NT  C = A @ B^T:  A (M, K), B (N, K)   a linear layer's x @ W^T
//   NN  C = A @ B:    A (M, K), B (K, N)   g @ W, GraphONE's x @ W
//   TN  C = A^T @ B:  A (K, M), B (K, N)   the weight gradient g^T @ x
// each batched over a leading index b (A, B, C contiguous per b).
//
// Bound: operations. Three TF32 products a float32 product make the
// ceiling 495 / 3 = 165 TFLOP/s of float32 work; the operands' bytes bind
// only at a few dozen rows (the least time is the larger of the two). What
// binds the kernel itself is the work around the products: every operand
// element is split (4 float operations) and B's halves pass through shared
// memory, which the products read too.
//
// Design (grid: N tiles, M tiles, batch x splits; a block is one or two
// consumer warpgroups of 64 rows each and as many producer warpgroups):
// - Producers: a ring of kStages raw float32 tiles (BM x 32 of A, BN x 32
//   of B) in dynamic shared memory, filled by cp.async (16-byte copies;
//   4-byte ones where rows are not 16-byte aligned), zero-filled outside
//   (M, N, K), so ragged edges need no other masking, two k-steps ahead.
//   wgmma reads a TF32 operand from shared memory K-major only (it has no
//   transpose bit for TF32), so the producers split each raw B tile into
//   hi and lo tiles, K-major in the 128-byte-swizzled layout that wgmma's
//   descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8)): a
//   layout whose B is N-major is transposed in this same step, with no
//   pass over device memory. Reads and writes are free of bank conflicts.
// - Consumers: each thread reads its A fragments (the m16n8k8 layout, 16
//   floats a k-step) straight from the raw tile, K- or M-major alike (rows
//   padded so the reads are free of bank conflicts), splits them in
//   registers and issues the 12 wgmma of the k-step with A in registers.
//   A's halves never touch shared memory.
// - Split B tiles are double-buffered behind named barriers ("full":
//   producers arrive, consumers wait; "empty": the reverse), so the
//   producers split k-step s + 1 while the consumers multiply k-step s. The
//   two-consumer tiles move registers from producers to consumers
//   (setmaxnreg).
// - Split-K over whole k-tiles, for grids that would not fill the card: each
//   split writes its own partial sum, and a second launch adds the splits in
//   a fixed order, then the bias. No atomics: the same inputs give the same
//   bits on every call.
// The tiling (BM 64 or 128, BN 64 or 128, splits) is the caller's choice,
// from the shape alone (ops/gemm.py:plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 32;      // K a k-step: one 128-byte row of floats
constexpr int kStages = 4;   // raw ring depth: kStages - 2 k-steps ahead
constexpr int kSlices = kBK / 8;  // wgmma k8 slices a k-step
constexpr int kAlign = 1024;      // the 128-byte swizzle repeats every 1 KB
constexpr int kRawK = kBK + 4;    // floats a K-major raw row
constexpr int kRawPad = 8;        // floats past ROWS in an M-/N-major raw row
constexpr int kReduceThreads = 256;

template <int WG, int BN>
struct Tile {
  static constexpr int BM = 64 * WG;
  static constexpr int kConsumers = 128 * WG;  // one warpgroup a 64 rows
  static constexpr int kProducers = 128 * WG;  // as many: the split binds
  static constexpr int kThreads = kConsumers + kProducers;
  // a raw tile: ROWS rows of kRawK floats, or 32 k-rows of ROWS + kRawPad
  static constexpr int kRawA = BM * kRawK;
  static constexpr int kRawFloats = kRawA + BN * kRawK;  // A then B
  static constexpr int kSplitFloats = 2 * BN * kBK;      // B hi, then lo
  static constexpr int kAcc = BN / 2;  // accumulator floats a thread
  static constexpr int kSmemBytes =
      4 * (2 * kSplitFloats + kStages * kRawFloats) + kAlign;
  // registers a thread, for the two roles of the 512-thread blocks, which
  // start with 128 each (65536 / 512): the consumers wait for theirs until
  // the producers' are given back
  static constexpr int kProducerRegs = 64;
  static constexpr int kConsumerRegs = 192;
  static_assert(BN == 64 || BN == 128, "wgmma n64 or n128");
  static_assert(BM * 8 % kProducers == 0 && BN * 8 % kProducers == 0,
                "whole 16-byte chunks a thread");
  static_assert(32 * (BM + kRawPad) <= BM * kRawK, "raw tiles fit");
  static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8),
                "the block's registers");
};

// named barriers (0 is __syncthreads): the producers among themselves, and
// for each split buffer "full" (producers arrive, consumers wait) and
// "empty" (consumers arrive, producers wait)
constexpr int kProducerBar = 1;
constexpr int kFullBar = 2;   // + buffer
constexpr int kEmptyBar = 4;  // + buffer

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (or 4), of which the first `bytes` come from `src`
// and the rest are zeros; `bytes` 0 reads nothing.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to the nearest TF32 value (11 significant bits; the 13 low bits
// zero, so the tensor cores read it exactly), by Veltkamp's split: with t =
// 8193 x, hi = t - (t - x) keeps x's 11 leading bits, rounded to nearest,
// and x - hi is exact. Three float operations on the full-rate pipe, where
// cvt.rna.tf32.f32 and integer rounding take several on the half-rate one
// (measured on the card, the split binds the producers); NaN stays NaN.
// Holds for |x| below 2^115 (8193 x is finite), which every activation,
// weight and gradient of the step is by many orders.
__device__ __forceinline__ float tf32(float x) {
  const float t = __fmul_rn(x, 8193.0f);
  return __fsub_rn(t, __fsub_rn(t, x));
}

// lo is left unrounded: the tensor cores read its leading 11 bits, which
// keeps the error of a product where rounding lo kept it (measured on the
// card at the cells' shapes) for 3 float operations fewer an element
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = __fsub_rn(x, hi);
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1)
__device__ __forceinline__ uint64_t descriptor(const float* p) {
  const uint64_t a = shared_address(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the split tiles' writes (generic proxy) made visible to wgmma (async
// proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A . B, 64 x N x 8: A TF32 in registers (each warp 16 rows, in the
// m16n8k8 fragment layout: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4) for lane 4g + t), B TF32 K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const unsigned (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const unsigned (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const unsigned (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (BN == 128) {
    wgmma_n128(d, a, b, scale_d);
  } else {
    wgmma_n64(d, a, b, scale_d);
  }
}

// The copies of one operand's ROWS x 32 tiles into raw stages: a K-major
// operand (element (r, k) at src[r * K + k]) as ROWS rows of kRawK floats,
// an M- or N-major one (at src[k * rows + r]) as 32 k-rows of ROWS +
// kRawPad floats; the padding keeps the consumers' fragment reads of A free
// of bank conflicts. A thread's chunks of 4 floats share a column (K-major)
// or a row (M-/N-major) and lie a fixed number of rows or k apart, so their
// addresses are set once and a k-step adds an offset.
template <int ROWS, int THREADS>
struct Loader {
  static constexpr int kChunks = ROWS * kBK / 4 / THREADS;
  const float* src;   // chunk 0 at k = 0
  const float* safe;  // a valid address for the copies that read nothing
  long long k_mul;   // elements a unit of k moves a chunk (1 or rows)
  long long step;    // elements from chunk i to i + 1
  int dst;           // chunk 0's float offset in the tile
  int dst_step;      // from chunk i to i + 1
  int k_of;          // k of chunk 0 in the tile
  int k_step;        // k from chunk i to i + 1 (0 for K-major)
  int K, rows, row;  // row: chunk 0's row
  bool kmajor, vec;

  __device__ __forceinline__ Loader(const float* base, int r0, int rows_,
                                    int K_, bool kmajor_, bool vec_,
                                    int tid)
      : safe(base), K(K_), rows(rows_), kmajor(kmajor_), vec(vec_) {
    if (kmajor) {
      constexpr int kPerRow = kBK / 4;  // chunks a row
      const int r = tid / kPerRow;
      k_of = tid % kPerRow * 4;
      k_step = 0;
      row = r0 + r;
      src = base + static_cast<long long>(row) * K + k_of;
      k_mul = 1;
      step = static_cast<long long>(THREADS / kPerRow) * K;
      dst = r * kRawK + k_of;
      dst_step = THREADS / kPerRow * kRawK;
    } else {
      constexpr int kPerK = ROWS / 4;  // chunks a k
      const int r = tid % kPerK * 4;
      k_of = tid / kPerK;
      k_step = THREADS / kPerK;
      row = r0 + r;
      src = base + static_cast<long long>(k_of) * rows + row;
      k_mul = rows;
      step = static_cast<long long>(k_step) * rows;
      dst = k_of * (ROWS + kRawPad) + r;
      dst_step = k_step * (ROWS + kRawPad);
    }
  }

  // k-step at k0 into the raw tile `tile`; zeros outside (rows, K)
  __device__ __forceinline__ void issue(float* tile, int k0) const {
    const float* at = src + k0 * k_mul;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = row + (kmajor ? i * (THREADS / (kBK / 4)) : 0);
      const int k = k0 + k_of + i * k_step;
      float* d = tile + dst + i * dst_step;
      const float* q = at + i * step;
      if (vec) {
        // rows and K are multiples of 4 here: a chunk is all in or out
        const bool ok = r < rows && k < K;
        copy16(d, ok ? q : safe, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // element e: (r, k + e) K-major, (r + e, k) otherwise
          const bool ok = kmajor ? r < rows && k + e < K
                                 : r + e < rows && k < K;
          copy4(d + e, ok ? q + e : safe, ok ? 4 : 0);
        }
      }
    }
  }
};

// Splits a raw tile (the Loader's layout) into hi and lo tiles, K-major and
// swizzled: element (r, k) at r * 32 + ((k / 4) ^ (r % 8)) * 4 + k % 4. A
// warp's reads cover whole 128-byte rows (K-major) or 32 consecutive floats
// (M-/N-major), and each 8 lanes of a 16-byte store fill 8 distinct bank
// groups: no conflicts. Every read comes before the first write, so the
// reads are in flight together (the compiler cannot tell the tiles apart).
template <int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo, bool kmajor, int tid) {
  constexpr int kChunks = ROWS * kBK / 4 / THREADS;
  constexpr int kStride = ROWS + kRawPad;
  float4 v[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int u = tid + i * THREADS;
    if (kmajor) {
      v[i] = *reinterpret_cast<const float4*>(raw + u / (kBK / 4) * kRawK +
                                              u % (kBK / 4) * 4);
    } else {
      const float* q = raw + u / ROWS * 4 * kStride + u % ROWS;
      v[i] = make_float4(q[0], q[kStride], q[2 * kStride], q[3 * kStride]);
    }
  }
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int u = tid + i * THREADS;
    // K-major: row u / 8, chunk u % 8; M-/N-major: row u % ROWS, chunk
    // u / ROWS
    const int r = kmajor ? u / (kBK / 4) : u % ROWS;
    const int c = kmajor ? u % (kBK / 4) : u / ROWS;
    float4 h, l;
    split4(v[i], h, l);
    const int at = r * kBK + ((c ^ (r & 7)) * 4);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

struct Problem {
  const float* a;
  const float* b;
  const float* bias;  // (N,) or null; added here only when splits == 1
  float* c;           // C, or the splits' partial sums
  int M, N, K;
  int batch, splits, tiles_per_split;
  bool a_kmajor, b_kmajor, vec_a, vec_b;
};

template <int WG, int BN>
__global__ void __launch_bounds__(Tile<WG, BN>::kThreads, 1)
    tf32x3_gemm(const Problem p) {
  using T = Tile<WG, BN>;
  constexpr int BM = T::BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is taken on shared addresses: align the tiles to 1 KB
  const unsigned base = shared_address(smem_raw);
  float* const smem = reinterpret_cast<float*>(
      smem_raw + ((kAlign - base % kAlign) % kAlign));
  float* const split_buf = smem;                          // 2 buffers
  float* const raw_buf = smem + 2 * T::kSplitFloats;      // kStages stages

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int k_tiles = (p.K + kBK - 1) / kBK;
  const int kt0 = split * p.tiles_per_split;
  const int n = min(kt0 + p.tiles_per_split, k_tiles) - kt0;

  if (tid >= T::kConsumers) {
    // producer warpgroup: raw tiles of A and B through the cp.async ring;
    // B split into buffer s % 2 once the consumers are done with k-step
    // s - 2, which frees that buffer and the ring stage of k-step s + 2
    if constexpr (WG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          T::kProducerRegs));
    }
    const int pt = tid - T::kConsumers;
    const Loader<BM, T::kProducers> load_a(
        p.a + static_cast<long long>(b) * p.M * p.K, m0, p.M, p.K,
        p.a_kmajor, p.vec_a, pt);
    const Loader<BN, T::kProducers> load_b(
        p.b + static_cast<long long>(b) * p.K * p.N, n0, p.N, p.K,
        p.b_kmajor, p.vec_b, pt);
    auto issue = [&](int s) {  // k-step s into ring stage s % kStages
      float* raw = raw_buf + (s % kStages) * T::kRawFloats;
      const int k0 = (kt0 + s) * kBK;
      load_a.issue(raw, k0);
      load_b.issue(raw + T::kRawA, k0);
    };
    // kStages - 2 groups committed (empty past the end), one more a k-step,
    // so the waits count alike for every block
#pragma unroll
    for (int s = 0; s < kStages - 2; ++s) {
      if (s < n) issue(s);
      commit_copies();
    }
    for (int s = 0; s < n; ++s) {
      if (s >= 2) bar_sync(kEmptyBar + (s & 1), T::kThreads);
      if (s + kStages - 2 < n) issue(s + kStages - 2);
      commit_copies();
      wait_copies<kStages - 2>();  // k-step s has landed, for this thread
      bar_sync(kProducerBar, T::kProducers);  // ... for every producer
      const float* raw = raw_buf + (s % kStages) * T::kRawFloats;
      float* sp = split_buf + (s & 1) * T::kSplitFloats;
      split_tile<BN, T::kProducers>(raw + T::kRawA, sp, sp + BN * kBK,
                                    p.b_kmajor, pt);
      fence_async_proxy();
      bar_arrive(kFullBar + (s & 1), T::kThreads);
    }
    return;
  }

  // consumer warpgroups, 64 rows each: A's fragments from the raw stage,
  // split in registers; B's split tiles from the buffer
  if constexpr (WG == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
  }
  const int wg = tid / 128;
  const int lane = tid & 31;
  // this thread's rows of A (and + 8) and k within a slice (and + 4); the
  // raw A tile's element (r, k) at r * rs + k * ks
  const int a_row = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int a_k = lane % 4;
  const int rs = p.a_kmajor ? kRawK : 1;
  const int ks = p.a_kmajor ? 1 : BM + kRawPad;
  float acc[T::kAcc];
  float part[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = part[i] = 0.f;
  for (int s = 0; s < n; ++s) {
    bar_sync(kFullBar + (s & 1), T::kThreads);
    const float* ra = raw_buf + (s % kStages) * T::kRawFloats;
    unsigned a_hi[kSlices][4], a_lo[kSlices][4];
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = a_row + (e & 1) * 8;
        const int k = j * 8 + a_k + (e >> 1) * 4;
        float hi, lo;
        split_tf32(ra[r * rs + k * ks], hi, lo);
        a_hi[j][e] = __float_as_uint(hi);
        a_lo[j][e] = __float_as_uint(lo);
      }
    }
    const float* sp = split_buf + (s & 1) * T::kSplitFloats;
    const uint64_t b_hi = descriptor(sp);
    const uint64_t b_lo = descriptor(sp + BN * kBK);
    fence_registers(part);
    wgmma_fence();
    // the small products of every slice first, into a fresh sum that
    // stays small, then the large ones: the tensor cores' own rounding of
    // the sum falls on 4 of the 12 products, not on all (a slice's k8 is 32
    // bytes further along the swizzled rows)
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      wgmma<BN>(part, a_lo[j], b_hi + 2 * j, j > 0);
      wgmma<BN>(part, a_hi[j], b_lo + 2 * j, 1);
    }
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      wgmma<BN>(part, a_hi[j], b_hi + 2 * j, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(part);
    // buffer s % 2 and ring stage s % kStages are free for k-step s + 2,
    // if there is one
    if (s + 2 < n) bar_arrive(kEmptyBar + (s & 1), T::kThreads);
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] += part[i];
  }

  // epilogue: in a 64 x N accumulator, warp w of the warpgroup holds rows
  // 16w + lane / 4 (+ 8); n8 tile j columns 8j + 2 (lane % 4) (+ 1)
  const int row = m0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  float* C = p.c + (static_cast<long long>(split) * p.batch + b) * p.M * p.N;
  const float* bias = p.splits == 1 ? p.bias : nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (col < p.N) b0 = bias[col];
      if (col + 1 < p.N) b1 = bias[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.M) continue;
      float* out = C + static_cast<long long>(r) * p.N + col;
      const float v0 = acc[4 * j + 2 * h] + b0;
      const float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (p.N % 2 == 0 && col + 1 < p.N) {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
      } else {
        if (col < p.N) out[0] = v0;
        if (col + 1 < p.N) out[1] = v1;
      }
    }
  }
}

// C = sum of the splits' partial sums, split 0 first, then the bias.
__global__ void __launch_bounds__(kReduceThreads)
    tf32x3_gemm_splitk_reduce(const float* __restrict__ part,
                              const float* __restrict__ bias,
                              float* __restrict__ c, long long size, int N,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(kReduceThreads) +
                     threadIdx.x;
       i < size; i += static_cast<long long>(gridDim.x) * kReduceThreads) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[s * size + i];
    if (bias != nullptr) v += bias[i % N];
    c[i] = v;
  }
}

template <int WG, int BN>
cudaError_t launch(const Problem& p, cudaStream_t stream) {
  using T = Tile<WG, BN>;
  // more than the default 48 KB of shared memory: opt in once per device
  static std::atomic<unsigned long long> opted_in{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if ((opted_in.load() & bit) == 0) {
    err = cudaFuncSetAttribute(tf32x3_gemm<WG, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit);
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + T::BM - 1) / T::BM,
                  p.batch * p.splits);
  tf32x3_gemm<WG, BN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One product: layout 0 NT, 1 NN, 2 TN (see the top of this file); tile
// BM = 64 * wg (wg 1 or 2), BN = bn (64 or 128); `splits` equal runs of
// tiles_per_split k-tiles of 32 (the last may be shorter, none empty). With
// splits > 1 the partial sums go to `partial` (splits x batch x M x N) and a
// second launch adds them into C. Returns the cudaError_t of the launches (0
// on success); the caller raises on anything else.
extern "C" int egopack_tf32x3_gemm(const float* a, const float* b,
                                   const float* bias, float* c,
                                   float* partial, int batch, int M, int N,
                                   int K, int layout, int wg, int bn,
                                   int splits, int tiles_per_split,
                                   void* stream) {
  const int k_tiles = (K + kBK - 1) / kBK;
  if (batch < 1 || M < 1 || N < 1 || K < 1 || layout < 0 || layout > 2 ||
      splits < 1 || tiles_per_split < 1 || batch * splits > 65535 ||
      (splits - 1) * tiles_per_split >= k_tiles ||
      splits * tiles_per_split < k_tiles || (splits > 1 && !partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Problem p;
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.c = splits > 1 ? partial : c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.batch = batch;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.a_kmajor = layout != 2;
  p.b_kmajor = layout == 0;
  // 16-byte copies need 16-byte aligned rows of the operand's leading dim
  p.vec_a = aligned16(a) && (p.a_kmajor ? K : M) % 4 == 0;
  p.vec_b = aligned16(b) && (p.b_kmajor ? K : N) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wg == 2 && bn == 128) {
    err = launch<2, 128>(p, s);
  } else if (wg == 2 && bn == 64) {
    err = launch<2, 64>(p, s);
  } else if (wg == 1 && bn == 64) {
    err = launch<1, 64>(p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long size = static_cast<long long>(batch) * M * N;
  const long long blocks = (size + kReduceThreads - 1) / kReduceThreads;
  tf32x3_gemm_splitk_reduce<<<static_cast<int>(blocks < 1056 ? blocks : 1056),
                              kReduceThreads, 0, s>>>(partial, bias, c, size,
                                                      N, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egopack_tf32x3_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
