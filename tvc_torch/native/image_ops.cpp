// Batched image resize + CLIP normalization on the host: the port's own
// copy of the JAX package's native image library, built and loaded by
// tvc_torch/native/__init__.py (g++ -O3 -march=native -fopenmp, ctypes).
//
// The host-side input pipeline turns each query image into the vision
// tower's input. This library replaces the per-image PIL resize and
// normalize with an OpenMP-parallel batch op:
//   uint8 [B, H, W, 3] -> float32 [B, S, S, 3], x = (x/255 - mean) / std
//
// Resampling follows PIL's BILINEAR semantics: a separable triangle filter
// whose support scales with the downscale factor (anti-aliased), computed
// via precomputed per-axis weight tables shared across the batch. A failed
// build raises in the loader: there is no PIL fallback behind it.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Per-output-index filter taps for one axis (PIL-style scaled triangle).
struct AxisFilter {
    std::vector<int> start;     // first source index per output index
    std::vector<int> count;     // tap count per output index
    std::vector<float> weights; // taps, [out_size * max_count]
    int max_count = 0;
};

AxisFilter build_filter(int in_size, int out_size) {
    AxisFilter f;
    const double scale = (double)in_size / (double)out_size;
    const double support = scale > 1.0 ? scale : 1.0;  // triangle radius
    const int max_taps = (int)ceil(support * 2.0) + 2;
    f.start.resize(out_size);
    f.count.resize(out_size);
    f.weights.assign((size_t)out_size * max_taps, 0.0f);
    f.max_count = max_taps;
    for (int o = 0; o < out_size; ++o) {
        const double center = (o + 0.5) * scale;
        int lo = (int)floor(center - support + 0.5);
        int hi = (int)floor(center + support + 0.5);
        if (lo < 0) lo = 0;
        if (hi > in_size) hi = in_size;
        double sum = 0.0;
        int n = hi - lo;
        for (int i = 0; i < n; ++i) {
            double d = (lo + i + 0.5 - center) / (scale > 1.0 ? scale : 1.0);
            double w = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
            if (w < 0) w = 0;
            f.weights[(size_t)o * max_taps + i] = (float)w;
            sum += w;
        }
        if (sum > 0) {
            for (int i = 0; i < n; ++i)
                f.weights[(size_t)o * max_taps + i] /= (float)sum;
        }
        f.start[o] = lo;
        f.count[o] = n;
    }
    return f;
}

// Resize one RGB uint8 image with precomputed axis filters, then normalize.
void resize_normalize_one(const uint8_t* src, int h, int w,
                          float* dst, int s,
                          const AxisFilter& fy, const AxisFilter& fx,
                          const float* mean, const float* inv_std,
                          float* hbuf /* [h * s * 3] scratch */) {
    // horizontal pass: [h, w, 3] -> [h, s, 3]
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + (size_t)y * w * 3;
        float* out_row = hbuf + (size_t)y * s * 3;
        for (int ox = 0; ox < s; ++ox) {
            const float* wts = &fx.weights[(size_t)ox * fx.max_count];
            const int x0 = fx.start[ox];
            const int n = fx.count[ox];
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int i = 0; i < n; ++i) {
                const uint8_t* p = row + (size_t)(x0 + i) * 3;
                const float wt = wts[i];
                acc0 += wt * p[0];
                acc1 += wt * p[1];
                acc2 += wt * p[2];
            }
            out_row[ox * 3 + 0] = acc0;
            out_row[ox * 3 + 1] = acc1;
            out_row[ox * 3 + 2] = acc2;
        }
    }
    // vertical pass + normalize: [h, s, 3] -> [s, s, 3]
    for (int oy = 0; oy < s; ++oy) {
        const float* wts = &fy.weights[(size_t)oy * fy.max_count];
        const int y0 = fy.start[oy];
        const int n = fy.count[oy];
        float* out_row = dst + (size_t)oy * s * 3;
        for (int ox = 0; ox < s; ++ox) {
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int i = 0; i < n; ++i) {
                const float* p = hbuf + ((size_t)(y0 + i) * s + ox) * 3;
                const float wt = wts[i];
                acc0 += wt * p[0];
                acc1 += wt * p[1];
                acc2 += wt * p[2];
            }
            out_row[ox * 3 + 0] = (acc0 * (1.0f / 255.0f) - mean[0]) * inv_std[0];
            out_row[ox * 3 + 1] = (acc1 * (1.0f / 255.0f) - mean[1]) * inv_std[1];
            out_row[ox * 3 + 2] = (acc2 * (1.0f / 255.0f) - mean[2]) * inv_std[2];
        }
    }
}

}  // namespace

extern "C" {

// Batched entry point: all images share (h, w).
void resize_normalize_batch(const uint8_t* src, int batch, int h, int w,
                            float* dst, int s,
                            const float* mean, const float* std_) {
    const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
    const AxisFilter fy = build_filter(h, s);
    const AxisFilter fx = build_filter(w, s);
#ifdef _OPENMP
#pragma omp parallel
    {
        std::vector<float> hbuf((size_t)h * s * 3);
#pragma omp for schedule(static)
        for (int b = 0; b < batch; ++b) {
            resize_normalize_one(src + (size_t)b * h * w * 3, h, w,
                                 dst + (size_t)b * s * s * 3, s, fy, fx,
                                 mean, inv_std, hbuf.data());
        }
    }
#else
    std::vector<float> hbuf((size_t)h * s * 3);
    for (int b = 0; b < batch; ++b) {
        resize_normalize_one(src + (size_t)b * h * w * 3, h, w,
                             dst + (size_t)b * s * s * 3, s, fy, fx,
                             mean, inv_std, hbuf.data());
    }
#endif
}

// Per-image shapes: offsets[i] = byte offset of image i; dims = (h_i, w_i).
void resize_normalize_varied(const uint8_t* src, const int64_t* offsets,
                             const int32_t* dims, int batch,
                             float* dst, int s,
                             const float* mean, const float* std_) {
    const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < batch; ++b) {
        const int h = dims[2 * b], w = dims[2 * b + 1];
        const AxisFilter fy = build_filter(h, s);
        const AxisFilter fx = build_filter(w, s);
        std::vector<float> hbuf((size_t)h * s * 3);
        resize_normalize_one(src + offsets[b], h, w,
                             dst + (size_t)b * s * s * 3, s, fy, fx,
                             mean, inv_std, hbuf.data());
    }
}

// L2-normalize rows of a [n, d] float32 matrix in place (bank prep).
void l2_normalize_rows(float* data, int64_t n, int64_t d) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        float* row = data + i * d;
        float sum = 0.0f;
        for (int64_t j = 0; j < d; ++j) sum += row[j] * row[j];
        float inv = sum > 1e-16f ? 1.0f / sqrtf(sum) : 0.0f;
        for (int64_t j = 0; j < d; ++j) row[j] *= inv;
    }
}

int tvc_native_version() { return 2; }

}  // extern "C"
