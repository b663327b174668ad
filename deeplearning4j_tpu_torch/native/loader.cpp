// Native data-loader kernels (the C++ runtime component the reference
// delegates to libnd4j/DataVec for: dataset decode + batch assembly).
//
// Exposed as a plain C ABI consumed via ctypes
// (deeplearning4j_tpu_torch/native/__init__.py builds this file with g++
// at first use into deeplearning4j_tpu_torch/build/ and reports the
// numpy route, with a warning, when no toolchain exists).
//
// Functions fuse the host-side per-batch passes that the numpy path
// performs separately (gather rows by permutation, uint8->float32
// normalize, one-hot expand), so one pass over memory feeds the
// device-bound pipeline. Each result is bit for bit the numpy route's:
// float(i) / 255.0f is the correctly rounded f32 quotient numpy's
// uint8 -> float32 / 255 gives.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Parse an IDX3 image file already loaded into memory.
// Returns 0 on success; fills n/rows/cols. Data begins at offset 16.
int idx3_header(const uint8_t* buf, int64_t len, int64_t* n,
                int64_t* rows, int64_t* cols) {
    if (len < 16) return 1;
    uint32_t magic = (uint32_t(buf[0]) << 24) | (uint32_t(buf[1]) << 16)
                   | (uint32_t(buf[2]) << 8) | uint32_t(buf[3]);
    if (magic != 2051u) return 2;
    auto be = [&](int off) {
        return (int64_t(buf[off]) << 24) | (int64_t(buf[off + 1]) << 16)
             | (int64_t(buf[off + 2]) << 8) | int64_t(buf[off + 3]);
    };
    *n = be(4);
    *rows = be(8);
    *cols = be(12);
    if (len < 16 + (*n) * (*rows) * (*cols)) return 3;
    return 0;
}

// uint8 [n, d] image rows -> float32 [n, d] in [0, 1].
void normalize_u8(const uint8_t* src, float* dst, int64_t count) {
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) lut[i] = float(i) / 255.0f;
        init = true;
    }
    for (int64_t i = 0; i < count; i++) dst[i] = lut[src[i]];
}

// Fused batch assembly: gather rows of u8 features by perm, normalize
// to float32, and one-hot the labels — one pass per example.
//   features: [n, d] uint8; labels: [n] uint8; perm: [b] int64
//   out_x: [b, d] float32; out_y: [b, n_classes] float32 (pre-zeroed
//   not required — fully written)
void assemble_batch_u8(const uint8_t* features, const uint8_t* labels,
                       const int64_t* perm, int64_t b, int64_t d,
                       int64_t n_classes, float* out_x, float* out_y) {
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) lut[i] = float(i) / 255.0f;
        init = true;
    }
    for (int64_t r = 0; r < b; r++) {
        const uint8_t* src = features + perm[r] * d;
        float* dst = out_x + r * d;
        for (int64_t j = 0; j < d; j++) dst[j] = lut[src[j]];
        float* y = out_y + r * n_classes;
        memset(y, 0, sizeof(float) * n_classes);
        int64_t cls = labels[perm[r]];
        if (cls >= 0 && cls < n_classes) y[cls] = 1.0f;
    }
}

// CIFAR-10 binary records: [rec][0]=label, [rec][1..3072]=RGB planes.
// Splits into images [n, 3072] u8 + labels [n] u8.
int split_cifar_records(const uint8_t* buf, int64_t len,
                        uint8_t* images, uint8_t* labels) {
    const int64_t rec = 3073;
    if (len % rec) return 1;
    int64_t n = len / rec;
    for (int64_t i = 0; i < n; i++) {
        labels[i] = buf[i * rec];
        memcpy(images + i * 3072, buf + i * rec + 1, 3072);
    }
    return 0;
}

}  // extern "C"
