// Native IQ file loader: mmap + background prefetch ring.
//
// The reference's data loaders are native (Rust FFI around SoapySDR /
// cpal, src/blocks/io/rf/soapysdr.rs:99-125 — MTU-sized blocking reads on
// a worker thread).  This is the port's native file-replay analog:
// the file is mapped read-only, a prefetch thread touches pages one
// window ahead of the consumer (madvise WILLNEED + a byte-sum walk so
// cold pages fault off the critical path), and `iq_read` is a plain
// memcpy that releases the GIL on the Python side (ctypes).  With the
// threaded native executor (runtime/native.py) the copy overlaps block
// compute on other cores.
//
// C ABI (ctypes):
//   void*  iq_open(const char* path, int loop);   // NULL on error
//   long   iq_size(void* h);                      // total samples (c64)
//   long   iq_read(void* h, void* out, long n);   // samples copied;
//                                                 // 0 = end (loop==0)
//   void   iq_close(void* h);
//
// Samples are interleaved float32 I/Q pairs (complex64), matching
// FileSdrDriver's raw format.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr long kSample = 8;                 // complex64 bytes
constexpr long kWindow = 4 << 20;           // prefetch window (bytes)

struct Loader {
    int fd = -1;
    const uint8_t* map = nullptr;
    long map_len = 0;                       // mmap length (raw file size)
    long bytes = 0;
    long pos = 0;                           // consumer cursor (bytes)
    long vpos = 0;                          // virtual cursor (monotonic,
                                            // never wraps in loop mode)
    bool loop = false;
    std::atomic<long> want{0};              // prefetch target (virtual)
    std::atomic<bool> stop{false};
    std::mutex mu;
    std::condition_variable cv;
    std::thread prefetcher;
};

void prefetch_loop(Loader* l) {
    // `done` and `want` are VIRTUAL offsets (monotonic, wrap-free); the
    // file offset is done % bytes.  A wrap-resetting cursor here would
    // leave the wait predicate permanently true after the first pass in
    // loop mode — the thread would re-walk the whole file at 100% CPU
    // with no consumer dependence.
    long done = 0;
    for (;;) {
        long target;
        {
            std::unique_lock<std::mutex> lk(l->mu);
            l->cv.wait(lk, [&] {
                return l->stop.load() || l->want.load() > done;
            });
            if (l->stop.load()) return;
            target = l->want.load();
        }
        if (!l->loop && target > l->bytes) target = l->bytes;
        while (done < target && !l->stop.load()) {
            long off0 = done % l->bytes;
            long chunk = target - done;
            if (chunk > kWindow) chunk = kWindow;
            if (chunk > l->bytes - off0) chunk = l->bytes - off0;
            madvise(const_cast<uint8_t*>(l->map) + off0, chunk,
                    MADV_WILLNEED);
            // Touch one byte per page so the fault happens here, not in
            // the consumer's memcpy.
            volatile uint8_t sink = 0;
            for (long off = off0; off < off0 + chunk; off += 4096)
                sink ^= l->map[off];
            (void)sink;
            done += chunk;
        }
    }
}

}  // namespace

extern "C" {

void* iq_open(const char* path, int loop) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < kSample) {
        close(fd);
        return nullptr;
    }
    void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) {
        close(fd);
        return nullptr;
    }
    madvise(map, st.st_size, MADV_SEQUENTIAL);
    auto* l = new Loader;
    l->fd = fd;
    l->map = static_cast<const uint8_t*>(map);
    l->map_len = st.st_size;
    l->bytes = (st.st_size / kSample) * kSample;
    l->loop = loop != 0;
    l->prefetcher = std::thread(prefetch_loop, l);
    return l;
}

long iq_size(void* h) {
    return static_cast<Loader*>(h)->bytes / kSample;
}

long iq_read(void* h, void* out, long n) {
    auto* l = static_cast<Loader*>(h);
    long want_bytes = n * kSample;
    uint8_t* dst = static_cast<uint8_t*>(out);
    long copied = 0;
    while (copied < want_bytes) {
        if (l->pos >= l->bytes) {
            if (!l->loop) break;
            l->pos = 0;
        }
        long avail = l->bytes - l->pos;
        long take = want_bytes - copied < avail ? want_bytes - copied
                                                : avail;
        // Kick the prefetcher one window past what this read needs
        // (virtual offsets; see prefetch_loop).
        long ahead = l->vpos + take + kWindow;
        if (!l->loop && ahead > l->bytes) ahead = l->bytes;
        if (ahead > l->want.load()) {
            {
                std::lock_guard<std::mutex> lk(l->mu);
                l->want.store(ahead);
            }
            l->cv.notify_one();
        }
        std::memcpy(dst + copied, l->map + l->pos, take);
        l->pos += take;
        l->vpos += take;
        copied += take;
    }
    return copied / kSample;
}

void iq_close(void* h) {
    auto* l = static_cast<Loader*>(h);
    l->stop.store(true);
    l->cv.notify_one();
    if (l->prefetcher.joinable()) l->prefetcher.join();
    munmap(const_cast<uint8_t*>(l->map), l->map_len);
    close(l->fd);
    delete l;
}

}  // extern "C"
