// Native data-path helpers for the host side of the PyTorch port (the
// port's own copy of fidm_tpu/native/maskgen.cpp, same C ABI, same
// algorithms: the masks are bit-equal to the JAX package's).
//
// In a pure Python/PIL data path the per-batch work (procedural mask rasterization,
// uint8 -> [-1,1] normalization, masked-image composition) can stall the
// feed of a weak host. These C functions do that work at memory speed; Python
// binds them via ctypes (see native/build.py), with the numpy versions when
// the .so cannot be built.
//
// Exposed C ABI:
//   fidm_brush_mask(float* mask, int size, uint64 seed, float cov_min,
//                   float cov_max)                  -> achieved coverage
//   fidm_box_mask(float* mask, int size, uint64 seed, float cov_min,
//                 float cov_max)                    -> achieved coverage
//   fidm_normalize_compose(const uint8* img, const float* mask,
//                          float* image, float* masked, int h, int w)
//
// Masks are float32 [size, size], 1.0 = inpaint hole (the black=inpaint
// convention of the file-loading path).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// xorshift64* — deterministic, seedable, fast
struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
    uint64_t next() {
        s ^= s >> 12;
        s ^= s << 25;
        s ^= s >> 27;
        return s * 0x2545F4914F6CDD1Dull;
    }
    // uniform in [0, 1)
    double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
    double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
    int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
        return lo + (int64_t)(uniform() * (double)(hi - lo));
    }
};

double coverage(const float* mask, int n) {
    double sum = 0;
    for (int i = 0; i < n; ++i) sum += mask[i];
    return sum / n;
}

void fill_disc(float* mask, int size, double cx, double cy, double r) {
    const int y0 = std::max(0, (int)std::floor(cy - r));
    const int y1 = std::min(size - 1, (int)std::ceil(cy + r));
    const int x0 = std::max(0, (int)std::floor(cx - r));
    const int x1 = std::min(size - 1, (int)std::ceil(cx + r));
    const double r2 = r * r;
    for (int y = y0; y <= y1; ++y) {
        const double dy = y - cy;
        float* row = mask + (size_t)y * size;
        for (int x = x0; x <= x1; ++x) {
            const double dx = x - cx;
            if (dx * dx + dy * dy <= r2) row[x] = 1.0f;
        }
    }
}

}  // namespace

extern "C" {

float fidm_brush_mask(float* mask, int size, uint64_t seed,
                      float cov_min, float cov_max) {
    if (size <= 0) return 0.0f;  // n==0 would divide by zero in coverage()
    Rng rng(seed);
    const int n = size * size;
    std::memset(mask, 0, sizeof(float) * n);
    const double target = rng.uniform(cov_min, cov_max);

    for (int stroke = 0; stroke < 12 && coverage(mask, n) < target; ++stroke) {
        double x = rng.uniform(0, size), y = rng.uniform(0, size);
        double angle = rng.uniform(0, 2 * M_PI);
        const int n_seg = (int)rng.randint(4, 16);
        const double radius = rng.uniform(size * 0.02, size * 0.08);
        for (int seg = 0; seg < n_seg; ++seg) {
            angle += rng.uniform(-0.7, 0.7);
            const double length = rng.uniform(size * 0.05, size * 0.2);
            const double nx = std::clamp(x + length * std::cos(angle), 0.0,
                                         size - 1.0);
            const double ny = std::clamp(y + length * std::sin(angle), 0.0,
                                         size - 1.0);
            const int steps = std::max(2, (int)(length / (radius * 0.5)));
            for (int i = 0; i <= steps; ++i) {
                const double t = (double)i / steps;
                fill_disc(mask, size, x + (nx - x) * t, y + (ny - y) * t,
                          radius);
            }
            x = nx;
            y = ny;
            if (coverage(mask, n) >= target) break;
        }
    }
    return (float)coverage(mask, n);
}

float fidm_box_mask(float* mask, int size, uint64_t seed,
                    float cov_min, float cov_max) {
    if (size <= 1) {  // degenerate canvas: nothing a >=1px box can target
        if (size == 1) mask[0] = 0.0f;
        return 0.0f;
    }
    Rng rng(seed);
    const int n = size * size;
    std::memset(mask, 0, sizeof(float) * n);
    const double target = rng.uniform(cov_min, cov_max);

    // min box dim is 4px, but never more than size-1: std::clamp with
    // lo > hi is UB, and the UB outcome here (h = 4 > size) made
    // randint(0, size - h + 1) negative -> out-of-bounds row writes for
    // size < 5 (tests/test_native_fuzz.py)
    const double lo = std::min(4.0, (double)size - 1.0);
    for (int box = 0; box < 8; ++box) {
        const double cov = coverage(mask, n);
        if (cov >= target) break;
        const double remaining = std::max(target - cov, 0.01);
        const double area = remaining * n * rng.uniform(0.5, 1.2);
        const double aspect = rng.uniform(0.4, 2.5);
        const int h = (int)std::clamp(std::sqrt(area * aspect), lo,
                                      size - 1.0);
        const int w = (int)std::clamp(std::sqrt(area / aspect), lo,
                                      size - 1.0);
        const int y = (int)rng.randint(0, size - h + 1);
        const int x = (int)rng.randint(0, size - w + 1);
        for (int yy = y; yy < y + h; ++yy)
            std::fill(mask + (size_t)yy * size + x,
                      mask + (size_t)yy * size + x + w, 1.0f);
    }
    return (float)coverage(mask, n);
}

// uint8 RGB [h,w,3] + mask [h,w] -> image [-1,1] and masked_image in one pass
void fidm_normalize_compose(const uint8_t* img, const float* mask,
                            float* image, float* masked, int h, int w) {
    if (h <= 0 || w <= 0) return;  // (size_t)(-1 * w) would wrap huge
    const size_t npix = (size_t)h * w;
    for (size_t p = 0; p < npix; ++p) {
        const float keep = 1.0f - mask[p];
        for (int c = 0; c < 3; ++c) {
            const float v = img[p * 3 + c] * (2.0f / 255.0f) - 1.0f;
            image[p * 3 + c] = v;
            masked[p * 3 + c] = v * keep;
        }
    }
}

}  // extern "C"
