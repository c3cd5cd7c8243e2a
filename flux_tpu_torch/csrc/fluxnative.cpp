// fluxnative — native host code of flux_tpu_torch: the package's own copy of
// flux_tpu's native/fluxnative.cpp, so that an installed package carries it.
//
// * The 16-bit ASCII PPM encoder (the reference writes it with buffered Rust
//   I/O, fluxcore/src/image.rs:43-61): an 800x600 frame is 1.44M formatted
//   integers, which Python formats one by one; and the same truncating
//   quantization to uint16.
// * The scheduler core (flux_sched_*): the C++ equivalent of the reference's
//   crossbeam machinery — the bounded(1) pull queue that load-balances work
//   units across workers (manager.rs:100,120-141), the CancellableIterator
//   (manager.rs:365-393), the completion ledger behind lost-unit retry, and
//   the WaitGroup barrier (manager.rs:101,166). Handout is one cursor under
//   a lock: workers pull the next undispatched unit exactly once, without
//   the reference's producer thread.
//
// Exposed as a plain C ABI consumed via ctypes. flux_tpu_torch/native.py
// builds it at first use (g++ -O3 -fPIC -shared) beside the CUDA kernels;
// flux_tpu_torch/sched.py declares the flux_sched_* signatures.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <mutex>
#include <vector>

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

// The reference's truncating `v * 65535.99` quantization (image.rs:49-52)
// into [0, 65535]. The product is clamped before the cast, so that a value
// past 65535 (or NaN, taken as 0) never reaches an out-of-range
// float-to-integer conversion.
inline uint32_t quantize(float c) {
    double v = static_cast<double>(c) * 65535.99;
    if (!(v >= 0.0)) return 0;
    return v >= 65535.0 ? 65535u : static_cast<uint32_t>(v);  // truncation, as image.rs
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
            p += write_u16(p, quantize(c[k]));
            *p++ = (k == 2) ? '\n' : ' ';
        }
    }
    return static_cast<size_t>(p - out);
}

// Quantize (n,) float32 in [0,1] to uint16 with the same truncation rule.
void flux_quantize_u16(const float* src, uint16_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<uint16_t>(quantize(src[i]));
}

}  // extern "C"


// ---------------------------------------------------------------------------
// Scheduler core

namespace {

struct Sched {
    std::mutex mu;
    std::condition_variable cv;  // signalled when workers_remaining hits 0
    int32_t n_units;
    int32_t next = 0;            // handout cursor
    int32_t workers_remaining;
    bool cancelled = false;
    std::vector<uint8_t> completed;

    Sched(int32_t n, int32_t workers)
        : n_units(n), workers_remaining(workers), completed(n, 0) {}
};

}  // namespace

extern "C" {

// One dispatch round over n_units work units pulled by n_workers workers;
// NULL for a negative unit count or fewer than one worker.
void* flux_sched_create(int32_t n_units, int32_t n_workers) {
    if (n_units < 0 || n_workers < 1) return nullptr;
    return new Sched(n_units, n_workers);
}

void flux_sched_destroy(void* h) { delete static_cast<Sched*>(h); }

// Pull the next undispatched unit; -1 when the round is exhausted or
// cancelled. Each index is handed out exactly once (the bounded(1)
// pull-queue semantics of manager.rs:100: workers that finish fast pull
// more, which is the whole load balancer).
int32_t flux_sched_pull(void* h) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->cancelled || s->next >= s->n_units) return -1;
    return s->next++;
}

// Record unit `i`'s result as delivered (the ledger behind lost-unit retry).
void flux_sched_complete(void* h, int32_t i) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    if (i >= 0 && i < s->n_units) s->completed[static_cast<size_t>(i)] = 1;
}

// Cancel the round: later pulls drain to -1 (CancellableIterator,
// manager.rs:365-393).
void flux_sched_cancel(void* h) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    s->cancelled = true;
}

int32_t flux_sched_cancelled(void* h) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    return s->cancelled ? 1 : 0;
}

// WaitGroup::done (manager.rs:101): a worker finished its pulls.
void flux_sched_worker_done(void* h) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    if (--s->workers_remaining <= 0) s->cv.notify_all();
}

// WaitGroup::wait barrier; timeout_ms < 0 waits forever. 1 = released,
// 0 = timed out.
int32_t flux_sched_wait(void* h, int64_t timeout_ms) {
    Sched* s = static_cast<Sched*>(h);
    std::unique_lock<std::mutex> lock(s->mu);
    auto ready = [s] { return s->workers_remaining <= 0; };
    if (timeout_ms < 0) {
        s->cv.wait(lock, ready);
        return 1;
    }
    return s->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), ready) ? 1 : 0;
}

// Indices never completed (dispatched but lost, or never dispatched); out
// must hold n_units int32s. Returns the count.
int32_t flux_sched_missing(void* h, int32_t* out) {
    Sched* s = static_cast<Sched*>(h);
    std::lock_guard<std::mutex> lock(s->mu);
    int32_t n = 0;
    for (int32_t i = 0; i < s->n_units; ++i)
        if (!s->completed[static_cast<size_t>(i)]) out[n++] = i;
    return n;
}

}  // extern "C"
