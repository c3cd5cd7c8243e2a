// fluxnative — native host code of flux_tpu_torch: the package's own copy of
// the PPM encoder in flux_tpu's native/fluxnative.cpp, so that an installed
// package carries it.
//
// The 16-bit ASCII PPM encoder (the reference writes it with buffered Rust
// I/O, fluxcore/src/image.rs:43-61): an 800x600 frame is 1.44M formatted
// integers, which Python formats one by one.
//
// Exposed as a plain C ABI consumed via ctypes. flux_tpu_torch/native.py
// builds it at first use (g++ -O3 -fPIC -shared) beside the CUDA kernels.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

// Write a non-negative integer < 100000 as decimal, return chars written.
inline int write_u16(char* out, uint32_t v) {
    char tmp[8];
    int n = 0;
    do {
        tmp[n++] = static_cast<char>('0' + (v % 10));
        v /= 10;
    } while (v != 0);
    for (int i = 0; i < n; ++i) out[i] = tmp[n - 1 - i];
    return n;
}

}  // namespace

extern "C" {

// Upper bound of the encoded size for an (h, w) image.
size_t flux_ppm_bound(int32_t h, int32_t w) {
    // header "P3\n<w> <h>\n65535\n" <= 32; per pixel 3 * (5 digits + sep) + 1
    return 32 + static_cast<size_t>(h) * static_cast<size_t>(w) * 19 + 16;
}

// Encode (h, w, 3) float32 pixels in [0, 1] to ASCII P3 with the
// reference's truncating `v * 65535.99` quantization (image.rs:49-52).
// Returns the number of bytes written (<= flux_ppm_bound(h, w)).
size_t flux_ppm_encode(const float* px, int32_t h, int32_t w, char* out) {
    char* p = out;
    std::memcpy(p, "P3\n", 3);
    p += 3;
    p += write_u16(p, static_cast<uint32_t>(w));
    *p++ = ' ';
    p += write_u16(p, static_cast<uint32_t>(h));
    std::memcpy(p, "\n65535\n", 7);
    p += 7;

    const size_t n = static_cast<size_t>(h) * static_cast<size_t>(w);
    for (size_t i = 0; i < n; ++i) {
        const float* c = px + i * 3;
        for (int k = 0; k < 3; ++k) {
            double v = static_cast<double>(c[k]) * 65535.99;
            if (v < 0.0) v = 0.0;
            uint32_t q = static_cast<uint32_t>(v);  // truncation, as image.rs
            if (q > 65535u) q = 65535u;
            p += write_u16(p, q);
            *p++ = (k == 2) ? '\n' : ' ';
        }
    }
    return static_cast<size_t>(p - out);
}

}  // extern "C"
