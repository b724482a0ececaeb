// Copied from fdc_tpu/runtime/native/ring.cc (verbatim below this line).
// Native streaming runtime: SPSC sample ring buffer + background file source.
//
// The TPU-native equivalent of the runtime layer the reference gets from GNU
// Radio: lock-free ring buffers between the sample source and the batched
// device step (reference runtime: gr::sync_block stream buffers, SURVEY.md
// §1), and a double-buffered background reader as the data-loader.
//
// Samples are complex64 stored as interleaved float32 pairs (the same layout
// fdc_tpu uses across the host<->device boundary, see fdc_tpu/utils/cplx.py).
// Single-producer / single-consumer, wait-free push/pop; blocking pop via
// condition variable for the driver loop.
//
// C ABI only (consumed through ctypes — no pybind11 in this environment).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Ring {
    float* buf;               // 2 floats per complex sample
    size_t capacity;          // in complex samples (power of two)
    size_t mask;
    std::atomic<uint64_t> head{0};  // written samples (producer)
    std::atomic<uint64_t> tail{0};  // consumed samples (consumer)
    std::atomic<int> closed{0};     // producer signalled end-of-stream
    std::mutex m;
    std::condition_variable cv;
};

size_t next_pow2(size_t v) {
    size_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

}  // namespace

extern "C" {

Ring* fdc_ring_create(size_t capacity_samples) {
    if (capacity_samples < 2) capacity_samples = 2;
    size_t cap = next_pow2(capacity_samples);
    Ring* r = new Ring();
    r->buf = new float[cap * 2];
    r->capacity = cap;
    r->mask = cap - 1;
    return r;
}

void fdc_ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->buf;
    delete r;
}

size_t fdc_ring_capacity(const Ring* r) { return r->capacity; }

size_t fdc_ring_size(const Ring* r) {
    return static_cast<size_t>(
        r->head.load(std::memory_order_acquire) -
        r->tail.load(std::memory_order_acquire));
}

void fdc_ring_close(Ring* r) {
    r->closed.store(1, std::memory_order_release);
    std::lock_guard<std::mutex> lk(r->m);
    r->cv.notify_all();
}

int fdc_ring_closed(const Ring* r) {
    return r->closed.load(std::memory_order_acquire);
}

// Clear the end-of-stream flag so the ring can host another producer
// (sequential sources on one driver, e.g. serve --max-conns). Call only
// after the previous producer thread has been join()ed (source stop()):
// a stale producer could re-close the ring mid-stream.
void fdc_ring_reopen(Ring* r) {
    r->closed.store(0, std::memory_order_release);
}

// Push up to n complex samples (2n floats); returns samples accepted.
size_t fdc_ring_push(Ring* r, const float* data, size_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_samps = r->capacity - static_cast<size_t>(head - tail);
    if (n > free_samps) n = free_samps;
    for (size_t i = 0; i < n; ++i) {
        size_t slot = static_cast<size_t>(head + i) & r->mask;
        r->buf[2 * slot] = data[2 * i];
        r->buf[2 * slot + 1] = data[2 * i + 1];
    }
    r->head.store(head + n, std::memory_order_release);
    {
        std::lock_guard<std::mutex> lk(r->m);
        r->cv.notify_all();
    }
    return n;
}

// Pop up to n samples; returns samples popped (non-blocking).
size_t fdc_ring_pop(Ring* r, float* out, size_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i) {
        size_t slot = static_cast<size_t>(tail + i) & r->mask;
        out[2 * i] = r->buf[2 * slot];
        out[2 * i + 1] = r->buf[2 * slot + 1];
    }
    r->tail.store(tail + n, std::memory_order_release);
    {
        std::lock_guard<std::mutex> lk(r->m);
        r->cv.notify_all();
    }
    return n;
}

// Block until exactly n samples are available (or stream closed / timeout).
// Returns samples popped: n on success; < n only after close (end-of-stream
// drain). A timeout with fewer than n samples buffered consumes NOTHING and
// returns 0, so a slow producer never causes silent mid-stream sample loss
// (the caller just retries).
size_t fdc_ring_pop_blocking(Ring* r, float* out, size_t n,
                             double timeout_s) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(timeout_s));
    for (;;) {
        if (fdc_ring_size(r) >= n) return fdc_ring_pop(r, out, n);
        if (fdc_ring_closed(r)) return fdc_ring_pop(r, out, n);
        std::unique_lock<std::mutex> lk(r->m);
        if (r->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
            if (fdc_ring_size(r) >= n || fdc_ring_closed(r))
                return fdc_ring_pop(r, out, n);
            return 0;
        }
    }
}

// Block until at least n samples of space are free, then push all n.
// Returns n, or fewer if the ring was closed while waiting.
size_t fdc_ring_push_blocking(Ring* r, const float* data, size_t n,
                              double timeout_s) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(timeout_s));
    size_t done = 0;
    while (done < n) {
        done += fdc_ring_push(r, data + 2 * done, n - done);
        if (done >= n) break;
        if (fdc_ring_closed(r)) break;
        std::unique_lock<std::mutex> lk(r->m);
        if (r->cv.wait_until(lk, deadline) == std::cv_status::timeout) break;
    }
    return done;
}

// ---------------------------------------------------------------------------
// Background file source (data loader): reads interleaved complex64 from a
// file into the ring on its own thread, double-buffered chunks.
// ---------------------------------------------------------------------------

struct FileSource {
    Ring* ring;
    std::thread th;
    std::atomic<uint64_t> samples_read{0};
    std::atomic<int> stop_flag{0};
    std::atomic<int> done{0};
    std::atomic<int> error{0};
};

static void filesource_main(FileSource* s, std::string path, size_t chunk,
                            int loop) {
    float* tmp = new float[chunk * 2];
    do {
        FILE* f = std::fopen(path.c_str(), "rb");
        if (!f) {
            s->error.store(1, std::memory_order_release);
            break;
        }
        for (;;) {
            if (s->stop_flag.load(std::memory_order_acquire)) break;
            size_t got = std::fread(tmp, sizeof(float) * 2, chunk, f);
            if (got == 0) break;
            size_t pushed = 0;
            while (pushed < got &&
                   !s->stop_flag.load(std::memory_order_acquire)) {
                pushed += fdc_ring_push_blocking(s->ring, tmp + 2 * pushed,
                                                 got - pushed, 0.1);
            }
            // count only what entered the ring (stop mid-push drops the
            // rest — samples_in must match what the consumer can see)
            s->samples_read.fetch_add(pushed, std::memory_order_release);
        }
        std::fclose(f);
    } while (loop && !s->stop_flag.load(std::memory_order_acquire));
    delete[] tmp;
    s->done.store(1, std::memory_order_release);
    fdc_ring_close(s->ring);
}

FileSource* fdc_filesource_start(Ring* ring, const char* path, size_t chunk,
                                 int loop) {
    FileSource* s = new FileSource();
    s->ring = ring;
    s->th = std::thread(filesource_main, s, std::string(path),
                        chunk ? chunk : 65536, loop);
    return s;
}

void fdc_filesource_stop(FileSource* s) {
    if (!s) return;
    s->stop_flag.store(1, std::memory_order_release);
    fdc_ring_close(s->ring);
    if (s->th.joinable()) s->th.join();
    delete s;
}

uint64_t fdc_filesource_samples_read(const FileSource* s) {
    return s->samples_read.load(std::memory_order_acquire);
}

int fdc_filesource_done(const FileSource* s) {
    return s->done.load(std::memory_order_acquire);
}

int fdc_filesource_error(const FileSource* s) {
    return s->error.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// Background TCP socket source: accepts ONE connection and streams
// interleaved complex64 (native-endian float32 pairs) into the ring. The
// network analog of the file source — an external producer (SDR host,
// another process) feeds the channelizer directly, the role the reference
// delegates to GNU Radio's stock network sources.
// ---------------------------------------------------------------------------

struct SocketSource {
    Ring* ring;
    std::thread th;
    std::atomic<uint64_t> samples_read{0};
    std::atomic<int> stop_flag{0};
    std::atomic<int> done{0};
    std::atomic<int> error{0};
    std::atomic<int> lfd{-1};
    std::atomic<int> cfd{-1};
    std::atomic<int> port{0};
};

// poll an fd for readability in 200 ms slices so stop_flag stays responsive
static bool wait_readable(int fd, const std::atomic<int>& stop) {
    for (;;) {
        if (stop.load(std::memory_order_acquire)) return false;
        struct pollfd p = {fd, POLLIN, 0};
        int r = ::poll(&p, 1, 200);
        if (r > 0) return true;
        if (r < 0 && errno != EINTR) return false;
    }
}

static void socketsource_main(SocketSource* s, size_t chunk) {
    int lfd = s->lfd.load(std::memory_order_acquire);
    int cfd = -1;
    // lfd is non-blocking: a connection that is gone again by accept()
    // time (client RST between poll and accept) yields EAGAIN and we
    // re-poll — accept can never hang stop() on the thread join
    while (cfd < 0 && wait_readable(lfd, s->stop_flag)) {
        cfd = ::accept(lfd, nullptr, nullptr);
        if (cfd < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK ||
                errno == ECONNABORTED || errno == EINTR)
                continue;
            if (!s->stop_flag.load(std::memory_order_acquire))
                s->error.store(1, std::memory_order_release);
            break;
        }
    }
    if (cfd >= 0) {
        s->cfd.store(cfd, std::memory_order_release);
        std::vector<float> buf(chunk * 2 + 2);
        char* bytes = reinterpret_cast<char*>(buf.data());
        const size_t cap_bytes = chunk * 8;
        size_t have = 0;  // buffered bytes (may include a partial sample)
        for (;;) {
            if (s->stop_flag.load(std::memory_order_acquire)) break;
            if (!wait_readable(cfd, s->stop_flag)) break;
            ssize_t got = ::recv(cfd, bytes + have, cap_bytes - have, 0);
            if (got == 0) break;  // clean remote close = end-of-stream
            if (got < 0) {
                if (errno == EINTR) continue;
                s->error.store(1, std::memory_order_release);
                break;
            }
            have += static_cast<size_t>(got);
            size_t nsamp = have / 8;
            if (!nsamp) continue;
            size_t pushed = 0;
            while (pushed < nsamp &&
                   !s->stop_flag.load(std::memory_order_acquire)) {
                pushed += fdc_ring_push_blocking(
                    s->ring, buf.data() + 2 * pushed, nsamp - pushed, 0.1);
            }
            // count only what actually entered the ring (a stop mid-push
            // drops the rest; the consumer must not see phantom samples)
            s->samples_read.fetch_add(pushed, std::memory_order_release);
            size_t rem = have - nsamp * 8;
            std::memmove(bytes, bytes + nsamp * 8, rem);
            have = rem;
        }
        ::close(cfd);
        s->cfd.store(-1, std::memory_order_release);
    }
    s->done.store(1, std::memory_order_release);
    fdc_ring_close(s->ring);
}

// Listen on bind_addr:port (empty addr = loopback; port 0 = ephemeral, read
// back via fdc_socketsource_port) and stream one connection into the ring.
SocketSource* fdc_socketsource_start(Ring* ring, const char* bind_addr,
                                     int port, size_t chunk) {
    int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (lfd < 0) return nullptr;
    int one = 1;
    ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in a;
    std::memset(&a, 0, sizeof(a));
    a.sin_family = AF_INET;
    a.sin_port = htons(static_cast<uint16_t>(port));
    if (!bind_addr || !*bind_addr) {
        a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    } else if (::inet_pton(AF_INET, bind_addr, &a.sin_addr) != 1) {
        ::close(lfd);
        return nullptr;
    }
    if (::bind(lfd, reinterpret_cast<sockaddr*>(&a), sizeof(a)) < 0 ||
        ::listen(lfd, 1) < 0 ||
        ::fcntl(lfd, F_SETFL, ::fcntl(lfd, F_GETFL, 0) | O_NONBLOCK) < 0) {
        ::close(lfd);
        return nullptr;
    }
    socklen_t alen = sizeof(a);
    ::getsockname(lfd, reinterpret_cast<sockaddr*>(&a), &alen);
    SocketSource* s = new SocketSource();
    s->ring = ring;
    s->lfd.store(lfd, std::memory_order_release);
    s->port.store(ntohs(a.sin_port), std::memory_order_release);
    s->th = std::thread(socketsource_main, s, chunk ? chunk : 65536);
    return s;
}

void fdc_socketsource_stop(SocketSource* s) {
    if (!s) return;
    s->stop_flag.store(1, std::memory_order_release);
    fdc_ring_close(s->ring);
    if (s->th.joinable()) s->th.join();
    int lfd = s->lfd.exchange(-1);
    if (lfd >= 0) ::close(lfd);
    delete s;
}

int fdc_socketsource_port(const SocketSource* s) {
    return s->port.load(std::memory_order_acquire);
}

uint64_t fdc_socketsource_samples_read(const SocketSource* s) {
    return s->samples_read.load(std::memory_order_acquire);
}

int fdc_socketsource_done(const SocketSource* s) {
    return s->done.load(std::memory_order_acquire);
}

int fdc_socketsource_error(const SocketSource* s) {
    return s->error.load(std::memory_order_acquire);
}

}  // extern "C"
