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
// Bound: operations. 2*T*M*P*F flops against 4*T*(P*F + M*F) + T*P bytes,
// about 31 flops a byte at the phase-2 shape (T=3, M=64, F=1024), above the
// card's float32 ridge (67 TFLOP/s over 3.35 TB/s = 20). The products run in
// float32 on the CUDA cores, with FMA, and no tensor cores or TF32, so the
// result stays within float32 rounding of the plain version.
//
// Design:
// - Pass 1, grid (splits, M/32, T), 128 threads. A block holds 32 feature
//   rows and walks its share of the bank in tiles of 64 rows: a register-
//   tiled SIMT product (each thread 4x4 outputs, operands staged in shared
//   memory in chunks of 32 along F, the next chunk's loads in flight while
//   the current one is multiplied), the rows' norms taken from the same
//   loads, then the 32x64 distance tile goes to shared memory and each warp
//   merges 8 rows of it into running top-k lists (kept in shared memory;
//   while a row is merged, lane j holds its j-th best). A tile whose candidates beat the k-th best in
//   numbers is bitonic-sorted across the warp and merged with the list in
//   one network; a few survivors are inserted one at a time by ballot and
//   shuffle. The (M, P) matrix never reaches device memory. Each block
//   writes its k best per row to (T, M, splits, k) scratch.
// - Pass 2, one warp per (t, m) row, merges the splits' lists into the
//   final k the same way, 32 candidates at a time.
// Splitting P across blocks keeps the card busy: at the phase-2 shape
// (T, M/32) alone gives 6 blocks for 132 SMs.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxK = 32;    // one list entry per lane; must match knn_topk.py
constexpr int kRows = 32;    // feature rows per block
constexpr int kCols = 64;    // bank rows per tile
constexpr int kChunk = 32;   // F per staged chunk
constexpr int kThreads = 128;
constexpr int kFewSurvivors = 8;  // up to this many: insert one at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;    // index of an empty or out-of-range slot

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

// Four consecutive floats of row `row` from column `col`, zero outside
// (rows, cols). `vec`: the rows are 16-byte aligned and cols % 4 == 0.
__device__ __forceinline__ float4 load4(const float* base, int row, int rows,
                                        int col, int cols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* p = base + static_cast<long long>(row) * cols + col;
  if (vec) {
    if (col < cols) v = *reinterpret_cast<const float4*>(p);
    return v;
  }
  if (col < cols) v.x = p[0];
  if (col + 1 < cols) v.y = p[1];
  if (col + 2 < cols) v.z = p[2];
  if (col + 3 < cols) v.w = p[3];
  return v;
}

__device__ __forceinline__ float sumsq(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

__global__ void __launch_bounds__(kThreads)
    knn_partial(const float* __restrict__ feats, const float* __restrict__ bank,
                const unsigned char* __restrict__ mask, int M, int P, int F,
                int k, int tiles_per_split, float* __restrict__ part_d,
                int* __restrict__ part_i) {
  __shared__ __align__(16) float As[kChunk][kRows + 4];
  __shared__ __align__(16) float Bs[kChunk][kCols + 4];
  __shared__ float Ds[kRows][kCols + 1];
  __shared__ float inv_nf[kRows];
  __shared__ float inv_nb[kCols];
  // running top-k of each row, entry j of row r at [r][j] (j < k valid)
  __shared__ float Ld[kRows][32];
  __shared__ int Li[kRows][32];

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
  const bool vec = (F % 4) == 0;

  // product layout: thread (ty, tx) owns rows ty*4.. and columns tx*4..; a
  // warp covers 4 ty x 8 tx, so its operand reads are two broadcasts
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  // load layout: A chunk 32 rows x 32 (two float4 each), B chunk 64 x 32
  // (four float4 each); the 4 lanes of a row are neighbours
  const int lrow = tid >> 2;
  const int lcol = (tid & 3) * 4;

  for (int r = warp * (kRows / 4); r < (warp + 1) * (kRows / 4); ++r) {
    Ld[r][lane] = __int_as_float(0x7f800000);  // +inf
    Li[r][lane] = kNone;
  }

  const int n_tiles = (P + kCols - 1) / kCols;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int p0 = tile * kCols;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float sq_a = 0.f, sq_b0 = 0.f, sq_b1 = 0.f;

    // registers carry the next chunk while the current one is multiplied,
    // so its loads overlap the products
    float4 a[2], b0[2], b1[2];
    auto fetch = [&](int c0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + lcol + 16 * h;
        a[h] = load4(f, m0 + lrow, M, col, F, vec);
        b0[h] = load4(b, p0 + lrow, P, col, F, vec);
        b1[h] = load4(b, p0 + lrow + 32, P, col, F, vec);
      }
    };
    fetch(0);
    for (int c0 = 0; c0 < F; c0 += kChunk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lcol + 16 * h;
        sq_a += sumsq(a[h]);
        sq_b0 += sumsq(b0[h]);
        sq_b1 += sumsq(b1[h]);
        As[c + 0][lrow] = a[h].x;
        As[c + 1][lrow] = a[h].y;
        As[c + 2][lrow] = a[h].z;
        As[c + 3][lrow] = a[h].w;
        Bs[c + 0][lrow] = b0[h].x;
        Bs[c + 1][lrow] = b0[h].y;
        Bs[c + 2][lrow] = b0[h].z;
        Bs[c + 3][lrow] = b0[h].w;
        Bs[c + 0][lrow + 32] = b1[h].x;
        Bs[c + 1][lrow + 32] = b1[h].y;
        Bs[c + 2][lrow + 32] = b1[h].z;
        Bs[c + 3][lrow + 32] = b1[h].w;
      }
      __syncthreads();
      if (c0 + kChunk < F) fetch(c0 + kChunk);
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }

    // the 4 lanes that loaded a row hold its partial sums of squares
    sq_a += __shfl_xor_sync(kFull, sq_a, 1);
    sq_a += __shfl_xor_sync(kFull, sq_a, 2);
    sq_b0 += __shfl_xor_sync(kFull, sq_b0, 1);
    sq_b0 += __shfl_xor_sync(kFull, sq_b0, 2);
    sq_b1 += __shfl_xor_sync(kFull, sq_b1, 1);
    sq_b1 += __shfl_xor_sync(kFull, sq_b1, 2);
    if ((tid & 3) == 0) {
      inv_nf[lrow] = 1.0f / sqrtf(sq_a);
      inv_nb[lrow] = 1.0f / sqrtf(sq_b0);
      inv_nb[lrow + 32] = 1.0f / sqrtf(sq_b1);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int p = p0 + c;
        // a masked row is +inf whatever its values (a zero pad row is 0/0)
        const bool ok = p < P && valid_row[p];
        Ds[r][c] = ok ? 1.0f - acc[i][j] * inv_nf[r] * inv_nb[c]
                      : __int_as_float(0x7f800000);
      }
    }
    __syncthreads();
    const bool in0 = p0 + lane < P, in1 = p0 + lane + 32 < P;
    // one copy of the selection code, not one per row: the lists live in
    // shared memory
#pragma unroll 1
    for (int row = warp * (kRows / 4); row < (warp + 1) * (kRows / 4);
         ++row) {
      float ld = Ld[row][lane];
      int li = Li[row][lane];
      float c0 = in0 ? Ds[row][lane] : __int_as_float(0x7f800000);
      float c1 = in1 ? Ds[row][lane + 32] : __int_as_float(0x7f800000);
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
      Ld[row][lane] = ld;
      Li[row][lane] = li;
    }
    __syncthreads();
  }

  for (int row = warp * (kRows / 4); row < (warp + 1) * (kRows / 4); ++row) {
    const int m = m0 + row;
    if (m < M && lane < k) {
      const long long o =
          ((static_cast<long long>(t) * M + m) * splits + split) * k + lane;
      part_d[o] = Ld[row][lane];
      part_i[o] = Li[row][lane];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
              int rows, int splits, int k, int* __restrict__ out_i,
              float* __restrict__ out_d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
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
// the launches (0 on success); the caller raises on anything else.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(splits, (M + kRows - 1) / kRows, T);
  knn_partial<<<grid1, kThreads, 0, s>>>(feats, bank, mask, M, P, F, k,
                                         tiles_per_split, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = T * M;
  const int warps = kThreads / 32;
  knn_merge<<<(rows + warps - 1) / warps, kThreads, 0, s>>>(
      part_d, part_i, rows, splits, k, out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egopack_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
