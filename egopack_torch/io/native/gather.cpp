// Native host-side feature gather for the data pipeline (the port's copy of
// egopack_tpu/io/native/gather.cpp).
//
// The reference's host hot path is numpy fancy-indexing over memmapped
// per-video feature files inside torch's DataLoader workers (reference
// data/ego4d_fho.py:229-238, SURVEY.md §3.5). This library is the native
// layer for it: batched row gathers that release the GIL (ctypes does this
// for the call) and copy with wide memcpy, so the prefetch thread overlaps
// batch assembly with the card's work.
//
// Built at first use by egopack_torch/io/native.py with
// g++ -O3 -march=native -ffp-contract=off -shared -fPIC; without contraction
// to FMA the interpolation rounds as the numpy path does, bit for bit.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// out[i, :] = src[clamp(idx[i], 0, rows-1), :]; idx[i] < 0 zero-fills.
void gather_rows(const float* src, int64_t rows, int64_t dim,
                 const int64_t* idx, int64_t n, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = idx[i];
        if (r < 0) {
            std::memset(out + i * dim, 0, sizeof(float) * dim);
            continue;
        }
        if (r >= rows) r = rows - 1;
        std::memcpy(out + i * dim, src + r * dim, sizeof(float) * dim);
    }
}

// Multi-threaded variant for large batches (n_threads <= hardware threads).
void gather_rows_mt(const float* src, int64_t rows, int64_t dim,
                    const int64_t* idx, int64_t n, float* out,
                    int n_threads) {
    if (n_threads <= 1) {
        gather_rows(src, rows, dim, idx, n, out);
        return;
    }
    std::vector<std::thread> workers;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        workers.emplace_back([=] {
            gather_rows(src, rows, dim, idx + lo, hi - lo, out + lo * dim);
        });
    }
    for (auto& w : workers) w.join();
}

// Linear interpolation gather for the PNR fractional-stride path
// (reference data/ego4d_oscc.py:259-280):
// out[i] = (1-frac[i]) * src[lo[i]] + frac[i] * src[hi[i]],
// exact copy when lo == hi.
void gather_interp(const float* src, int64_t rows, int64_t dim,
                   const int64_t* lo, const int64_t* hi, const float* frac,
                   int64_t n, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t a = lo[i] < 0 ? 0 : (lo[i] >= rows ? rows - 1 : lo[i]);
        int64_t b = hi[i] < 0 ? 0 : (hi[i] >= rows ? rows - 1 : hi[i]);
        const float* pa = src + a * dim;
        if (a == b) {
            std::memcpy(out + i * dim, pa, sizeof(float) * dim);
            continue;
        }
        const float* pb = src + b * dim;
        float f = frac[i];
        float g = 1.0f - f;
        float* po = out + i * dim;
        for (int64_t j = 0; j < dim; ++j) po[j] = g * pa[j] + f * pb[j];
    }
}

}  // extern "C"
