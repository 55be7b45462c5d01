// Cosine k nearest valid prototypes, for T tasks in one launch pair.
//
// Replaces the Pallas TPU kernel egopack_tpu/ops/pallas/knn_topk.py
// (cosine_knn_pallas -> _knn_kernel, _row_topk). For every task t and
// feature row m:
//
//   d[p] = 1 - (f[m] . b[p]) / (|f[m]| |b[p]|)   for valid prototype rows p
//   d[p] = +inf                                  for masked rows (never read)
//
// and the k smallest (d, p) pairs in (distance, index) order: ties go to the
// lower index, and when fewer than k rows are valid the lowest masked indices
// fill the tail with +inf. That is lax.top_k over the masked distance matrix
// (ops/knn.py, impl="xla"), which the port follows; the Pallas kernel
// repeats one index in that tail instead.
//
// Shapes: features (T, M, F) f32, bank (T, P, F) f32, mask (T, P) bool ->
// idx (T, M, k) int32, dist (T, M, k) f32; 1 <= k <= 32 and k <= P.
//
// Bound: bytes. The products must be float32-accurate, and on the tensor
// cores that costs three TF32 products each (3xTF32, below), so the least
// time is the larger of 4*T*(P*F + M*F) + T*P bytes at 3.35 TB/s and
// 3 * 2*T*M*P*F flops at 495 TFLOP/s. At the phase-2 shape (T=3, M=64,
// F=1024) that is 2*M/4 = 32 flops a byte against 495/3.35/3 = 49 at the
// ridge: the bank's bytes.
//
// 3xTF32: every operand x is split into hi = x rounded to TF32 (10 explicit
// mantissa bits) and lo = x - hi, which the tensor cores read to 10 bits as
// well, and a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small
// terms first, in float32 accumulators; a_lo.b_lo (about 2^-22 relative) is
// dropped. Each product is then within about 2^-21 of a.b relative to
// |a||b|, so over F=1024 terms the cosine is off by at most about 2^-21
// (|f.b| <= |f||b|) plus the accumulators' rounding, inside the 1e-5
// distance tolerance held against the plain version. The norms are exact
// float32 sums of squares on the CUDA cores.
//
// Design:
// - Pass 1, grid (splits, ceil(M/64), T), 8 warps. A block holds 64 feature
//   rows (all of the phase-2 step's M) and walks its share of the bank in
//   tiles of 64 rows, so each bank tile is read once per task. The operands
//   arrive in chunks of 32 along F through a ring of 3 stages in dynamic
//   shared memory, filled by cp.async (16-byte copies, zero-filled outside
//   (M, P, F); 4-byte copies where rows are not 16-byte aligned) with two
//   chunks in flight while one is multiplied. A stage holds the 64 feature
//   rows, then the tile's 64 bank rows, row-major in rows of 32+4 floats
//   (16-byte aligned rows; the fragment loads are free of bank conflicts).
//   The ring runs on across tiles, so the next tile's first chunks load
//   while this tile's candidates are selected.
// - The products: mma.sync m16n8k8 TF32 on the tensor cores, operands read
//   by ldmatrix. Each warp owns a 32x32 quarter of the 64x64 product tile
//   over half of each chunk's k (warps 0-3 k 0-15, warps 4-7 k 16-31), as
//   eight m16n8 accumulators: against 16x32 pieces over all of k, a
//   fragment loaded and split feeds twice the products. The two halves
//   meet in shared memory at the end of the tile. Two threads a row sum the
//   rows' squares from the same stages (the feature rows on a block's first
//   tile only).
// - The selection: each warp merges 8 rows of the product tile into running
//   top-k lists (kept in shared memory; while a row is merged, lane j holds
//   its j-th best). A tile whose candidates beat the k-th best in numbers is
//   bitonic-sorted across the warp and merged with the list in one network;
//   a few survivors are inserted one at a time by ballot and shuffle. The
//   (M, P) matrix never reaches device memory. Each block writes its k best
//   per row to (T, M, splits, k) scratch.
// - Pass 2, one warp per (t, m) row, merges the splits' lists into the
//   final k the same way, 32 candidates at a time.
// Splitting P across blocks keeps the card busy: at the phase-2 shape
// (T, M/64) alone gives 3 blocks for 132 SMs.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kMaxK = 32;    // one list entry per lane; must match knn_topk.py
constexpr int kRows = 64;    // feature rows per block
constexpr int kCols = 64;    // bank rows per tile
constexpr int kChunk = 32;   // F per ring stage
constexpr int kStages = 3;   // ring depth: kStages - 1 chunks in flight
constexpr int kStride = kChunk + 4;  // floats per staged row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMergeThreads = 128;
constexpr int kStageFloats = (kRows + kCols) * kStride;
constexpr int kCopies = (kRows + kCols) * (kChunk / 4) / kThreads;
constexpr int kDsStride = kCols + 4;  // product tile row, 16-byte aligned
constexpr int kWarpRows = 32;         // a warp's piece of the product tile
constexpr int kWarpCols = 32;
constexpr int kWarpM = kWarpRows / 16;     // its m16 fragments of A
constexpr int kWarpTiles = kWarpCols / 8;  // its n8 fragments of B
constexpr int kQuarters = kRows / kWarpRows * (kCols / kWarpCols);
constexpr int kHalfChunk = kChunk / 2;     // k of a chunk a warp multiplies
constexpr int kFewSurvivors = 8;  // up to this many: insert one at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;    // index of an empty or out-of-range slot
// dynamic shared memory: the ring, the two halves of the product tile, the
// lists, the norms; every part starts at a multiple of 128 bytes
constexpr int kSmemBytes =
    4 * (kStages * kStageFloats + 2 * kRows * kDsStride + 2 * kRows * 32 +
         kRows + kCols);

static_assert(kCols == 64, "the selection takes two candidates a lane");
static_assert(2 * kQuarters == kWarps, "two warps a quarter, one a k half");
static_assert(kWarpTiles % 2 == 0, "B fragments load two n8 tiles at once");
static_assert(kRows % kWarps == 0, "each warp merges whole rows");
static_assert(kCopies * kThreads == (kRows + kCols) * (kChunk / 4),
              "the threads copy a stage in whole 16-byte pieces");
static_assert(2 * (kRows + kCols) <= kThreads, "two threads a row's norm");
static_assert(kStageFloats * 4 % 128 == 0 && kRows * kDsStride * 4 % 128 == 0,
              "128-byte aligned parts");

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Offer one candidate per lane to the warp's sorted list (ld, li): lane j < k
// holds the j-th smallest pair, lanes >= k a sentinel that never moves.
__device__ __forceinline__ void offer(float& ld, int& li, float cd, int ci,
                                      bool valid, int k, int lane) {
  const float wd = __shfl_sync(kFull, ld, k - 1);
  const int wi = __shfl_sync(kFull, li, k - 1);
  unsigned pending = __ballot_sync(kFull, valid && before(cd, ci, wd, wi));
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float xd = __shfl_sync(kFull, cd, src);
    const int xi = __shfl_sync(kFull, ci, src);
    const int pos =
        __popc(__ballot_sync(kFull, lane < k && before(ld, li, xd, xi)));
    const float ud = __shfl_up_sync(kFull, ld, 1);
    const int ui = __shfl_up_sync(kFull, li, 1);
    if (pos < k) {
      if (lane == pos) {
        ld = xd;
        li = xi;
      } else if (lane > pos && lane < k) {
        ld = ud;
        li = ui;
      }
    }
  }
}

// Compare-exchange with lane ^ stride: keep the first (keep_min) or the
// second of the two pairs in (distance, index) order.
__device__ __forceinline__ void exchange(float& d, int& i, int stride,
                                         bool keep_min) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (keep_min == before(od, oi, d, i)) {
    d = od;
    i = oi;
  }
}

// Bitonic sort of one pair per lane, ascending across the warp.
__device__ __forceinline__ void sort32(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(d, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// (ld, li) and (cd, ci) each sorted ascending across the warp: leaves in
// (ld, li) the 32 smallest pairs of both, sorted (the minimum against the
// reversed other list is bitonic; a half-cleaner network sorts it).
__device__ __forceinline__ void merge32(float& ld, int& li, float cd, int ci,
                                        int lane) {
  const float rd = __shfl_sync(kFull, cd, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (before(rd, ri, ld, li)) {
    ld = rd;
    li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(ld, li, stride, (lane & stride) == 0);
}

// Merge one candidate per lane (index kNone for none) into the warp's list,
// whose lanes < k hold the k best sorted. Few survivors of the k-th best go
// in one at a time; more are sorted and merged as a whole.
__device__ __forceinline__ void take(float& ld, int& li, float cd, int ci,
                                     int k, int lane) {
  const float wd = __shfl_sync(kFull, ld, k - 1);
  const int wi = __shfl_sync(kFull, li, k - 1);
  const unsigned pass = __ballot_sync(kFull, before(cd, ci, wd, wi));
  if (pass == 0) return;
  if (__popc(pass) <= kFewSurvivors) {
    offer(ld, li, cd, ci, ci != kNone, k, lane);
    return;
  }
  sort32(cd, ci, lane);
  if (lane >= k) {  // only the k best of the list take part
    ld = __int_as_float(0x7f800000);
    li = kNone;
  }
  merge32(ld, li, cd, ci, lane);
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

// Four 8x8 matrices of 16-bit elements from shared memory, lanes 8i..8i+7
// giving the row addresses of matrix i; for 32-bit elements, an 8x4 block
// each, lane l receiving row l / 4, element l % 4 of every block: the
// fragment layouts of mma.sync m16n8k8 TF32 for A (row-major) and B
// (column-major, stored with n as the row).
__device__ __forceinline__ void load_matrices(unsigned (&r)[4],
                                              unsigned address) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(address));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float sumsq(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// The 3xTF32 split of x: hi is x rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna: half a TF32 unit added to the magnitude, the 13
// low bits cleared), lo = x - hi, exact in float32. lo goes to the tensor
// cores as it is: they read a TF32 operand's top 19 bits, so lo loses at
// most 2^-11 of itself, 2^-22 of x. Three integer and float operations,
// where cvt.rna twice takes seven (the compiler guards inf and NaN, which
// the features and the bank do not hold).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                          unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores: a 16x8 (row-major), b 8x8 (column-major)
// TF32, d 16x8 f32, in the fragment layouts of mma.sync m16n8k8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
    knn_partial(const float* __restrict__ feats, const float* __restrict__ bank,
                const unsigned char* __restrict__ mask, int M, int P, int F,
                int k, int tiles_per_split, bool vec,
                float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  // the product tile as two halves over k, each [kRows][kDsStride]
  float* const Ds = ring + kStages * kStageFloats;
  float* const Ds2 = Ds + kRows * kDsStride;
  // running top-k of each row, entry j of row r at [r * 32 + j] (j < k valid)
  float* const Ld = Ds2 + kRows * kDsStride;
  int* const Li = reinterpret_cast<int*>(Ld + kRows * 32);
  float* const inv_nf = reinterpret_cast<float*>(Li + kRows * 32);
  float* const inv_nb = inv_nf + kRows;

  const int t = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* f = feats + static_cast<long long>(t) * M * F;
  const float* b = bank + static_cast<long long>(t) * P * F;
  const unsigned char* valid_row = mask + static_cast<long long>(t) * P;
  const int rows_here = min(kRows, M - m0);
  const int row_lo = warp * (kRows / kWarps);
  const int row_hi = min(row_lo + kRows / kWarps, rows_here);

  // product layout: warp w multiplies quarter w % 4 of the tile over k half
  // w / 4; in an m16n8 accumulator, lane holds rows lane / 4 and lane / 4 +
  // 8, columns 2 (lane % 4) and 2 (lane % 4) + 1
  const int quarter = warp % kQuarters;
  const int khalf = warp / kQuarters * kHalfChunk;
  const int wrow = quarter / (kCols / kWarpCols) * kWarpRows;
  const int wcol = quarter % (kCols / kWarpCols) * kWarpCols;
  float* const Dw = warp < kQuarters ? Ds : Ds2;
  // ldmatrix row addresses, in floats from a stage: A, rows 0-7 and 8-15 of
  // a 16-row fragment at k 0-3, then at k 4-7; B, n8 tiles j and j + 1,
  // each at k 0-3 and 4-7
  const int a_at = (wrow + (lane & 15)) * kStride + (lane >> 4) * 4 + khalf;
  const int b_at = (kRows + wcol + (lane & 7) + (lane >> 4) * 8) * kStride +
                   ((lane >> 3) & 1) * 4 + khalf;
  // norm layout: threads 2r and 2r+1 sum halves of stage row r
  const int nrow = tid >> 1;
  const int nhalf = (tid & 1) * (kChunk / 2);

  for (int r = row_lo; r < row_lo + kRows / kWarps; ++r) {
    Ld[r * 32 + lane] = __int_as_float(0x7f800000);  // +inf
    Li[r * 32 + lane] = kNone;
  }

  const int n_tiles = (P + kCols - 1) / kCols;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int n_chunks = (F + kChunk - 1) / kChunk;
  const int total = (tile_hi - tile_lo) * n_chunks;

  // chunk g of the block's walk (tile tile_lo + g / n_chunks, columns from
  // (g % n_chunks) * kChunk) into ring stage g % kStages
  auto issue = [&](int g) {
    float* dst = ring + (g % kStages) * kStageFloats;
    const int p0 = (tile_lo + g / n_chunks) * kCols;
    const int c0 = (g % n_chunks) * kChunk;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int u = tid + i * kThreads;
      const int row = u / (kChunk / 4);
      const int col = (u % (kChunk / 4)) * 4;
      const bool is_a = row < kRows;
      const int grow = is_a ? m0 + row : p0 + row - kRows;
      const bool in = grow < (is_a ? M : P);
      const float* src =
          (is_a ? f : b) + (in ? static_cast<long long>(grow) * F : 0) + c0 +
          col;
      float* d = dst + row * kStride + col;
      if (vec) {
        const bool ok = in && c0 + col < F;
        copy16(d, ok ? src : f, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && c0 + col + e < F;
          copy4(d + e, ok ? src + e : f, ok ? 4 : 0);
        }
      }
    }
  };

  // prologue: kStages - 1 chunks in flight; a group is committed for every
  // chunk index, empty past the end, so the waits below count alike for
  // every block
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    commit_copies();
  }

  float acc[kWarpM][kWarpTiles][4] = {};
  float sq = 0.f;
  int tile = tile_lo, chunk = 0;
  for (int g = 0; g < total; ++g) {
    wait_copies<kStages - 2>();  // chunk g has landed, for this thread
    // ... and for every thread; and every warp is done with chunk g - 1,
    // whose stage the next issue refills
    __syncthreads();
    if (g + kStages - 1 < total) issue(g + kStages - 1);
    commit_copies();

    const float* st = ring + (g % kStages) * kStageFloats;
    const unsigned sa = shared_address(st + a_at);
    const unsigned sb = shared_address(st + b_at);
#pragma unroll
    for (int kk = 0; kk < kHalfChunk; kk += 8) {
      unsigned a_hi[kWarpM][4], a_lo[kWarpM][4];
#pragma unroll
      for (int i = 0; i < kWarpM; ++i) {
        unsigned a[4];
        load_matrices(a, sa + (i * 16 * kStride + kk) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(a[e]), a_hi[i][e], a_lo[i][e]);
      }
#pragma unroll
      for (int j = 0; j < kWarpTiles; j += 2) {
        unsigned bv[4], b_hi[4], b_lo[4];
        load_matrices(bv, sb + (j * 8 * kStride + kk) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(bv[e]), b_hi[e], b_lo[e]);
#pragma unroll
        for (int i = 0; i < kWarpM; ++i) {
          mma_tf32(acc[i][j], a_lo[i], b_hi[0], b_hi[1]);
          mma_tf32(acc[i][j + 1], a_lo[i], b_hi[2], b_hi[3]);
          mma_tf32(acc[i][j], a_hi[i], b_lo[0], b_lo[1]);
          mma_tf32(acc[i][j + 1], a_hi[i], b_lo[2], b_lo[3]);
          mma_tf32(acc[i][j], a_hi[i], b_hi[0], b_hi[1]);
          mma_tf32(acc[i][j + 1], a_hi[i], b_hi[2], b_hi[3]);
        }
      }
    }
    // the feature rows are the same on every tile: their norms once
    const bool norm_row =
        nrow < kRows + kCols && (nrow >= kRows || tile == tile_lo);
    if (norm_row) {
      const float4* q =
          reinterpret_cast<const float4*>(st + nrow * kStride + nhalf);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) sq += sumsq(q[j]);
    }
    if (++chunk < n_chunks) continue;

    // the tile's products are done: norms, product tile, selection
    sq += __shfl_xor_sync(kFull, sq, 1);
    if (norm_row && nhalf == 0) {
      if (nrow < kRows) {
        inv_nf[nrow] = 1.0f / sqrtf(sq);
      } else {
        inv_nb[nrow - kRows] = 1.0f / sqrtf(sq);
      }
    }
    sq = 0.f;
#pragma unroll
    for (int i = 0; i < kWarpM; ++i) {
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        float* d = Dw + (wrow + i * 16 + (lane >> 2)) * kDsStride + wcol +
                   j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(d) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(d + 8 * kDsStride) =
            make_float2(acc[i][j][2], acc[i][j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
    __syncthreads();
    const int p0 = tile * kCols;
    const bool in0 = p0 + lane < P, in1 = p0 + lane + 32 < P;
    // a masked row is +inf whatever its values (a zero pad row is 0/0)
    const bool ok0 = in0 && valid_row[p0 + lane];
    const bool ok1 = in1 && valid_row[p0 + lane + 32];
    const float nb0 = inv_nb[lane], nb1 = inv_nb[lane + 32];
    // one copy of the selection code, not one per row: the lists live in
    // shared memory
#pragma unroll 1
    for (int row = row_lo; row < row_hi; ++row) {
      float ld = Ld[row * 32 + lane];
      int li = Li[row * 32 + lane];
      const float nf = inv_nf[row];
      const float* d0 = Ds + row * kDsStride + lane;
      const float* d1 = Ds2 + row * kDsStride + lane;
      float c0 = ok0 ? 1.0f - (d0[0] + d1[0]) * nf * nb0
                     : __int_as_float(0x7f800000);
      float c1 = ok1 ? 1.0f - (d0[32] + d1[32]) * nf * nb1
                     : __int_as_float(0x7f800000);
      int i0 = in0 ? p0 + lane : kNone, i1 = in1 ? p0 + lane + 32 : kNone;
      const float wd = __shfl_sync(kFull, ld, k - 1);
      const int wi = __shfl_sync(kFull, li, k - 1);
      const int n = __popc(__ballot_sync(kFull, before(c0, i0, wd, wi))) +
                    __popc(__ballot_sync(kFull, before(c1, i1, wd, wi)));
      if (n > kFewSurvivors) {
        // the tile's 32 best of 64, then the list's k best merged in
        sort32(c0, i0, lane);
        sort32(c1, i1, lane);
        merge32(c0, i0, c1, i1, lane);
        if (lane >= k) {
          ld = __int_as_float(0x7f800000);
          li = kNone;
        }
        merge32(ld, li, c0, i0, lane);
      } else if (n > 0) {
        offer(ld, li, c0, i0, in0, k, lane);
        offer(ld, li, c1, i1, in1, k, lane);
      }
      Ld[row * 32 + lane] = ld;
      Li[row * 32 + lane] = li;
    }
    // Ds, Ds2, inv_nb and the lists are next written after the next tile's
    // first __syncthreads, when every warp is done here
    ++tile;
    chunk = 0;
  }

  for (int row = row_lo; row < row_hi; ++row) {
    if (lane < k) {
      const long long o =
          ((static_cast<long long>(t) * M + m0 + row) * splits + split) * k +
          lane;
      part_d[o] = Ld[row * 32 + lane];
      part_i[o] = Li[row * 32 + lane];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
              int rows, int splits, int k, int* __restrict__ out_i,
              float* __restrict__ out_d) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  float ld = __int_as_float(0x7f800000);
  int li = kNone;
  const int n = splits * k;
  const float* pd = part_d + row * n;
  const int* pi = part_i + row * n;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const bool ok = c < n;
    take(ld, li, ok ? pd[c] : __int_as_float(0x7f800000), ok ? pi[c] : kNone,
         k, lane);
  }
  if (lane < k) {
    out_i[row * k + lane] = li;
    out_d[row * k + lane] = ld;
  }
}

}  // namespace

// One call = one launch pair on `stream`. part_d / part_i hold
// T*M*splits*k entries; splits <= ceil(P / 64). Returns the cudaError_t of
// the launches (0 on success); the caller raises on anything else, among
// them a card that cannot give pass 1 its shared memory.
extern "C" int egopack_cosine_knn(const float* feats, const float* bank,
                                  const unsigned char* mask, int T, int M,
                                  int P, int F, int k, int splits,
                                  float* part_d, int* part_i, int* out_i,
                                  float* out_d, void* stream) {
  const int n_tiles = (P + kCols - 1) / kCols;
  if (T < 1 || M < 1 || P < 1 || F < 1 || k < 1 || k > kMaxK || k > P ||
      splits < 1 || splits > n_tiles || T > 65535 ||
      (M + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  // every block must own at least one tile, or its rows would stay sentinels
  if ((splits - 1) * tiles_per_split >= n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // pass 1 takes more than the default 48 KB of shared memory: opt in once
  // per device
  static std::atomic<unsigned long long> opted_in{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if ((opted_in.load() & bit) == 0) {
    err = cudaFuncSetAttribute(
        knn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(bit);
  }
  // 16-byte copies need 16-byte aligned rows
  const bool vec = F % 4 == 0 && reinterpret_cast<size_t>(feats) % 16 == 0 &&
                   reinterpret_cast<size_t>(bank) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(splits, (M + kRows - 1) / kRows, T);
  knn_partial<<<grid1, kThreads, kSmemBytes, s>>>(
      feats, bank, mask, M, P, F, k, tiles_per_split, vec, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = T * M;
  const int warps = kMergeThreads / 32;
  knn_merge<<<(rows + warps - 1) / warps, kMergeThreads, 0, s>>>(
      part_d, part_i, rows, splits, k, out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egopack_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
