#include "shm.hpp"

#include "core.hpp"

#include <dirent.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <time.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

namespace kf {

namespace {

// one futex wait slice: long enough to be free when idle, short enough
// that liveness re-checks (peer death, epoch reset, server stop) land
// promptly without needing a cross-process wake
constexpr int kSliceMs = 50;

int64_t now_ms() {
    return std::chrono::duration_cast<std::chrono::milliseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// Non-PRIVATE futex: keyed on (inode, offset) so the two mappings of a
// segment — different virtual addresses even inside one process — wake
// each other.
void futex_wait(std::atomic<uint32_t> *addr, uint32_t expect, int ms) {
    timespec ts{ms / 1000, (ms % 1000) * 1000000L};
    ::syscall(SYS_futex, reinterpret_cast<uint32_t *>(addr), FUTEX_WAIT,
              expect, &ts, nullptr, 0);
}

void futex_wake(std::atomic<uint32_t> *addr) {
    ::syscall(SYS_futex, reinterpret_cast<uint32_t *>(addr), FUTEX_WAKE,
              INT32_MAX, nullptr, nullptr, 0);
}

}  // namespace

std::string shm_dir() {
    char dir[64];
    std::snprintf(dir, sizeof(dir), "/dev/shm/kf-u%u", unsigned(::getuid()));
    if (::mkdir(dir, 0700) != 0 && errno != EEXIST) return "";
    struct stat st{};
    if (::lstat(dir, &st) != 0) return "";
    if (!S_ISDIR(st.st_mode) || st.st_uid != ::getuid() ||
        (st.st_mode & 0777) != 0700)
        return "";
    return dir;
}

bool shm_transport_enabled() {
    const char *e = std::getenv("KF_SHM");
    return !(e && std::strcmp(e, "0") == 0);
}

bool shm_require() {
    const char *e = std::getenv("KF_SHM_REQUIRE");
    return e && std::strcmp(e, "1") == 0;
}

int shm_sweep_stale(int64_t max_age_s) {
    const char *e = std::getenv("KF_SHM_SWEEP");
    if (e && std::strcmp(e, "0") == 0) return 0;
    const std::string dir = shm_dir();
    if (dir.empty()) return 0;
    DIR *d = ::opendir(dir.c_str());
    if (!d) return 0;
    int removed = 0;
    const time_t now = ::time(nullptr);
    while (struct dirent *ent = ::readdir(d)) {
        const char *n = ent->d_name;
        const size_t len = std::strlen(n);
        if (len < 5 || std::strcmp(n + len - 5, ".ring") != 0) continue;
        const std::string path = dir + "/" + n;
        struct stat st{};
        // lstat + regular-file check: never follow a planted symlink
        if (::lstat(path.c_str(), &st) != 0 || !S_ISREG(st.st_mode))
            continue;
        if (now - st.st_mtime < time_t(max_age_s)) continue;  // live?
        if (::unlink(path.c_str()) == 0) {
            removed++;
            KF_WARN("swept stale shm ring %s (age %llds) from a "
                    "previous crashed run",
                    path.c_str(), (long long)(now - st.st_mtime));
        }
    }
    ::closedir(d);
    return removed;
}

std::unique_ptr<ShmRing> ShmRing::create(const std::string &path,
                                         uint32_t capacity) {
    static_assert(sizeof(ShmRingHdr) <= ShmRing::kHdrBytes,
                  "ring header must fit its reserved page slice");
    const size_t len = kHdrBytes + capacity;
    int fd = ::open(path.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, off_t(len)) != 0) {
        ::close(fd);
        ::unlink(path.c_str());
        return nullptr;
    }
    void *mem = ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED,
                       fd, 0);
    ::close(fd);  // the mapping keeps the bytes alive
    if (mem == MAP_FAILED) {
        ::unlink(path.c_str());
        return nullptr;
    }
    auto ring = std::unique_ptr<ShmRing>(new ShmRing());
    ring->h_ = new (mem) ShmRingHdr();
    ring->h_->capacity = capacity;
    // magic published last: an attacher that somehow raced the hello
    // message sees zero and rejects (the socket hello ordinarily
    // guarantees init happened-before attach)
    ring->h_->magic = kMagic;
    ring->data_ = static_cast<uint8_t *>(mem) + kHdrBytes;
    ring->map_len_ = len;
    ring->path_ = path;
    ring->owner_ = true;
    return ring;
}

std::unique_ptr<ShmRing> ShmRing::attach(const std::string &path) {
    int fd = ::open(path.c_str(), O_RDWR | O_NOFOLLOW);
    if (fd < 0) return nullptr;
    struct stat st{};
    if (::fstat(fd, &st) != 0 || st.st_uid != ::getuid() ||
        size_t(st.st_size) <= kHdrBytes) {
        ::close(fd);
        return nullptr;
    }
    const size_t len = size_t(st.st_size);
    void *mem = ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED,
                       fd, 0);
    ::close(fd);
    if (mem == MAP_FAILED) return nullptr;
    auto *h = static_cast<ShmRingHdr *>(mem);
    if (h->magic != kMagic || h->capacity != len - kHdrBytes) {
        ::munmap(mem, len);
        return nullptr;
    }
    auto ring = std::unique_ptr<ShmRing>(new ShmRing());
    ring->h_ = h;
    ring->data_ = static_cast<uint8_t *>(mem) + kHdrBytes;
    ring->map_len_ = len;
    ring->path_ = path;
    return ring;
}

ShmRing::~ShmRing() {
    if (owner_ && h_) close();
    if (h_) ::munmap(static_cast<void *>(h_), map_len_);
    if (owner_) unlink();  // ENOENT after the receiver's unlink: fine
}

void ShmRing::unlink() {
    if (unlinked_) return;
    unlinked_ = true;
    ::unlink(path_.c_str());
}

void ShmRing::close() {
    h_->closed.store(1, std::memory_order_release);
    h_->seq.fetch_add(1, std::memory_order_release);
    futex_wake(&h_->seq);
}

size_t ShmRing::readable() const {
    return size_t(h_->head.load(std::memory_order_acquire) -
                  h_->tail.load(std::memory_order_relaxed));
}

size_t ShmRing::writable() const {
    return h_->capacity -
           size_t(h_->head.load(std::memory_order_relaxed) -
                  h_->tail.load(std::memory_order_acquire));
}

bool ShmRing::write(const void *buf, size_t n, int64_t stall_ms,
                    const std::function<bool()> &alive) {
    const auto *src = static_cast<const uint8_t *>(buf);
    const uint32_t cap = h_->capacity;
    int64_t last_progress = now_ms();
    while (n > 0) {
        size_t avail = writable();
        if (avail == 0) {
            if (h_->closed.load(std::memory_order_acquire)) return false;
            if (alive && !alive()) return false;
            if (stall_ms > 0 && now_ms() - last_progress >= stall_ms)
                return false;
            const uint32_t s = h_->seq.load(std::memory_order_acquire);
            if (writable() == 0) futex_wait(&h_->seq, s, kSliceMs);
            continue;
        }
        const size_t m = n < avail ? n : avail;
        const uint64_t head = h_->head.load(std::memory_order_relaxed);
        const size_t pos = size_t(head % cap);
        const size_t first = m < cap - pos ? m : cap - pos;
        std::memcpy(data_ + pos, src, first);
        if (m > first) std::memcpy(data_, src + first, m - first);
        h_->head.store(head + m, std::memory_order_release);
        h_->seq.fetch_add(1, std::memory_order_release);
        futex_wake(&h_->seq);
        src += m;
        n -= m;
        last_progress = now_ms();
    }
    return true;
}

bool ShmRing::read(void *buf, size_t n, int64_t stall_ms,
                   const std::function<bool()> &alive) {
    auto *dst = static_cast<uint8_t *>(buf);
    const uint32_t cap = h_->capacity;
    int64_t last_progress = now_ms();
    while (n > 0) {
        size_t avail = readable();
        if (avail == 0) {
            // closed is checked AFTER a final readable() pass: the
            // producer closes only after publishing its last bytes
            if (h_->closed.load(std::memory_order_acquire) &&
                readable() == 0)
                return false;
            if (alive && !alive()) return false;
            if (stall_ms > 0 && now_ms() - last_progress >= stall_ms)
                return false;
            const uint32_t s = h_->seq.load(std::memory_order_acquire);
            if (readable() == 0) futex_wait(&h_->seq, s, kSliceMs);
            continue;
        }
        const size_t m = n < avail ? n : avail;
        const uint64_t tail = h_->tail.load(std::memory_order_relaxed);
        const size_t pos = size_t(tail % cap);
        const size_t first = m < cap - pos ? m : cap - pos;
        std::memcpy(dst, data_ + pos, first);
        if (m > first) std::memcpy(dst + first, data_, m - first);
        h_->tail.store(tail + m, std::memory_order_release);
        h_->seq.fetch_add(1, std::memory_order_release);
        futex_wake(&h_->seq);
        dst += m;
        n -= m;
        last_progress = now_ms();
    }
    return true;
}

int ShmRing::wait_readable(int wait_ms) {
    const int64_t deadline = now_ms() + wait_ms;
    for (;;) {
        if (readable() > 0) return 1;
        if (h_->closed.load(std::memory_order_acquire) && readable() == 0)
            return -1;
        const int64_t left = deadline - now_ms();
        if (left <= 0) return 0;
        const uint32_t s = h_->seq.load(std::memory_order_acquire);
        if (readable() == 0 &&
            !h_->closed.load(std::memory_order_acquire))
            futex_wait(&h_->seq, s,
                       int(left < kSliceMs ? left : kSliceMs));
    }
}

}  // namespace kf
