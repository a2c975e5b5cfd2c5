#include "transport.hpp"

#include "trace.hpp"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/un.h>
#include <poll.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstring>

#include "../include/kf.h"

namespace kf {

namespace {

struct ConnHeader {
    uint16_t type;
    uint16_t src_port;
    uint32_t src_ipv4;
    // the dialer's epoch token: lets the server separate a stale-epoch
    // re-dial (peer alive, mid-resize — not a death signal) from a
    // same-epoch conn whose loss means the peer died
    uint32_t token;
} __attribute__((packed));

struct Ack {
    uint32_t token;
} __attribute__((packed));

std::string rdv_key(const PeerID &src, const std::string &name) {
    return src.str() + "|" + name;
}

int64_t now_us() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

bool unix_sockets_disabled() {
    // "0" (and empty) mean enabled: the launcher forwards the variable
    // verbatim through env.CONFIG_VARS, so KF_NO_UNIX_SOCKET=0 must be
    // a usable "explicitly on" spelling, not a surprise disable
    const char *e = std::getenv("KF_NO_UNIX_SOCKET");
    return e != nullptr && *e != '\0' && std::strcmp(e, "0") != 0;
}

int ceil_log2(size_t n) {
    int b = 0;
    while ((size_t(1) << b) < n) b++;
    return b;
}

// Unix sockets default to ~208KB buffers (vs TCP loopback's autotuned
// MBs), which convoys concurrent chunk senders; ask for 4MiB each way
// (the kernel clamps to wmem_max/rmem_max).
void grow_unix_bufs(int fd) {
    int sz = 4 << 20;
    ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

// Per-pair ring capacity: holds a few of the session's ~1MiB chunks;
// bigger messages stream through in pieces as the reader drains.
constexpr uint32_t kShmRingBytes = 4u << 20;

// Per-frame header checksum for the shm rings (FNV-1a 32-bit over the
// serialized name_len/name/flags/len fields). Sockets get framing
// integrity from the kernel's stream discipline; a mmap'd ring has
// none, and a torn or corrupted FRAME HEADER — a mid-frame SIGKILL,
// a stray write into the header bytes — would otherwise make the
// reader deserialize garbage name/length fields and feed a mis-framed
// payload into a reduce. Header corruption surfaces as
// KF_ERR_CORRUPT; a torn PAYLOAD can only stall (missing bytes),
// which the liveness deadline catches as KF_ERR_CONN — it is never
// mis-framed. Payload BYTE corruption inside the mapped region is
// out of scope of this cheap check, the same exposure any in-RAM
// buffer has on every transport (docs/collectives.md "Failure
// semantics").
uint32_t frame_crc32(const uint8_t *data, size_t n) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < n; i++) {
        h ^= data[i];
        h *= 16777619u;
    }
    return h;
}

// KF_SHM_INJECT_CORRUPT=1: seeded-chaos hook — corrupt the checksum of
// the NEXT shm frame this process sends (one-shot latch), so tests and
// the sanitizer smoke can drive the torn-frame detection path
// deterministically end to end. Read per send until it fires, so an
// in-process test can arm it after other clusters already ran.
bool take_corrupt_injection() {
    static std::atomic<bool> fired{false};
    if (fired.load(std::memory_order_relaxed)) return false;
    const char *e = std::getenv("KF_SHM_INJECT_CORRUPT");
    if (!e || std::strcmp(e, "1") != 0) return false;
    return !fired.exchange(true);
}

// KF_SHM_INJECT_ATTACH_FAIL=1: receiver refuses to map offered rings
// (acks 0), driving the real degraded-transport fallback path — the
// deterministic stand-in for /dev/shm ENOSPC or mount policy.
bool inject_attach_fail() {
    const char *e = std::getenv("KF_SHM_INJECT_ATTACH_FAIL");
    return e && std::strcmp(e, "1") == 0;
}

// After the hello exchange the shm socket is silent, so any readability
// (EOF, reset) means the sender is gone or fenced out.
bool shm_sock_dead(int fd) {
    pollfd p{fd, POLLIN, 0};
    const int pr = ::poll(&p, 1, 0);
    if (pr <= 0) return false;
    if (p.revents & (POLLERR | POLLHUP | POLLNVAL)) return true;
    if (p.revents & POLLIN) {
        char b;
        const ssize_t r = ::recv(fd, &b, 1, MSG_PEEK | MSG_DONTWAIT);
        return r == 0 ||
               (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                errno != EINTR);
    }
    return false;
}

}  // namespace

std::string sock_path(const PeerID &p) {
    // sockets live inside a per-uid 0700 directory so another local user
    // can neither squat the path ahead of bind nor connect to it
    char buf[108];
    std::snprintf(buf, sizeof(buf), "/tmp/kf-u%u/%08x-%u.sock",
                  unsigned(::getuid()), p.ipv4, unsigned(p.port));
    return buf;
}

// Create the per-uid socket directory; false (=> TCP fallback) unless it
// ends up existing with mode 0700 and owned by us.
bool ensure_sock_dir() {
    char dir[64];
    std::snprintf(dir, sizeof(dir), "/tmp/kf-u%u", unsigned(::getuid()));
    if (::mkdir(dir, 0700) != 0 && errno != EEXIST) return false;
    struct stat st{};
    if (::lstat(dir, &st) != 0) return false;
    return S_ISDIR(st.st_mode) && st.st_uid == ::getuid() &&
           (st.st_mode & 0777) == 0700;
}

// ------------------------------------------------------------ buffer pool

BufferPool &BufferPool::instance() {
    static BufferPool pool;
    return pool;
}

std::vector<uint8_t> BufferPool::get(size_t n) {
    const int b = ceil_log2(n ? n : 1);
    if (b < kBuckets) {
        std::lock_guard<std::mutex> lk(mu_);
        auto &q = buckets_[b];
        if (!q.empty()) {
            std::vector<uint8_t> v = std::move(q.back());
            q.pop_back();
            cached_ -= v.capacity();
            v.resize(n);  // within capacity: no realloc
            return v;
        }
    }
    std::vector<uint8_t> v;
    v.reserve(size_t(1) << b);
    v.resize(n);
    return v;
}

void BufferPool::put(std::vector<uint8_t> &&v) {
    const size_t cap = v.capacity();
    if (cap == 0 || (cap & (cap - 1)) != 0) return;  // only pow-2 capacities
    const int b = ceil_log2(cap);
    if (b >= kBuckets) return;
    std::lock_guard<std::mutex> lk(mu_);
    if (cached_ + cap > kMaxCachedBytes) return;  // over cap: let it free
    cached_ += cap;
    buckets_[b].push_back(std::move(v));
}

size_t BufferPool::cached_bytes() {
    std::lock_guard<std::mutex> lk(mu_);
    return cached_;
}

// ------------------------------------------------------------------- fd io

bool read_exact(int fd, void *buf, size_t n) {
    auto *p = static_cast<uint8_t *>(buf);
    while (n > 0) {
        ssize_t r = ::read(fd, p, n);
        if (r <= 0) {
            if (r < 0 && errno == EINTR) continue;
            return false;
        }
        p += r;
        n -= size_t(r);
    }
    return true;
}

// Like read_exact but fails if the fd makes no progress for stall_ms
// (message *bodies* must stream continuously once the header arrived; a
// mid-body stall means a dead/partitioned sender and must not hold a
// registered receive past its failure-detection deadline). stall_ms <= 0
// waits indefinitely. Header reads keep plain read_exact: an idle
// connection between collectives is legitimate.
bool read_exact_progress(int fd, void *buf, size_t n, int64_t stall_ms) {
    auto *p = static_cast<uint8_t *>(buf);
    while (n > 0) {
        if (stall_ms > 0) {
            pollfd pfd{fd, POLLIN, 0};
            int pr = ::poll(&pfd, 1, int(stall_ms));
            if (pr < 0 && errno == EINTR) continue;
            if (pr <= 0) return false;  // no progress within stall_ms
        }
        ssize_t r = ::read(fd, p, n);
        if (r <= 0) {
            if (r < 0 && errno == EINTR) continue;
            return false;
        }
        p += r;
        n -= size_t(r);
    }
    return true;
}

int64_t body_stall_ms() {
    static const int64_t v = [] {
        const char *s = std::getenv("KF_BODY_STALL_MS");
        return s ? std::atoll(s) : 60000;
    }();
    return v;
}

bool write_exact(int fd, const void *buf, size_t n) {
    auto *p = static_cast<const uint8_t *>(buf);
    while (n > 0) {
        ssize_t r = ::write(fd, p, n);
        if (r <= 0) {
            if (r < 0 && errno == EINTR) continue;
            return false;
        }
        p += r;
        n -= size_t(r);
    }
    return true;
}

bool write_message(int fd, const std::string &name, uint32_t flags,
                   const void *data, size_t len) {
    // single buffered write: header + name + flags + len + data
    std::vector<uint8_t> buf;
    buf.reserve(12 + name.size() + len);
    auto put_u32 = [&](uint32_t v) {
        buf.insert(buf.end(), (uint8_t *)&v, (uint8_t *)&v + 4);
    };
    put_u32(uint32_t(name.size()));
    buf.insert(buf.end(), name.begin(), name.end());
    put_u32(flags);
    put_u32(uint32_t(len));
    buf.insert(buf.end(), (const uint8_t *)data, (const uint8_t *)data + len);
    return write_exact(fd, buf.data(), buf.size());
}

bool read_message(int fd, WireMessage *out, size_t max_len) {
    uint32_t name_len;
    if (!read_exact(fd, &name_len, 4)) return false;
    if (name_len > 4096) return false;  // sanity: names are short
    out->name.resize(name_len);
    if (name_len && !read_exact(fd, out->name.data(), name_len)) return false;
    if (!read_exact(fd, &out->flags, 4)) return false;
    uint32_t len;
    if (!read_exact(fd, &len, 4)) return false;
    if (len > max_len) return false;
    out->data.resize(len);
    if (len && !read_exact(fd, out->data.data(), len)) return false;
    return true;
}

// ------------------------------------------------------------- rendezvous

void Rendezvous::push(const PeerID &src, WireMessage msg) {
    const std::string key = rdv_key(src, msg.name);
    std::lock_guard<std::mutex> lk(mu_);
    // a receiver may have registered between this message's header read
    // (which chose the queue path) and now — deliver into its slot here or
    // it would wait forever watching a slot no reader will ever claim
    auto qit = q_.find(key);
    const bool queue_empty = qit == q_.end() || qit->second.empty();
    auto sit = slots_.find(key);
    if (queue_empty && sit != slots_.end()) {
        // offer to waiting slots in FIFO order; undersized registrations
        // (an API-contract violation) are failed and skipped so a later,
        // big-enough slot is not stranded watching an unclaimable queue
        auto &dq = sit->second;
        while (!dq.empty()) {
            RecvSlot *slot = dq.front();
            dq.pop_front();
            if (slot->cap >= msg.data.size()) {
                if (dq.empty()) slots_.erase(sit);
                std::memcpy(slot->buf, msg.data.data(), msg.data.size());
                slot->len = msg.data.size();
                slot->state = RecvSlot::done;
                BufferPool::instance().put(std::move(msg.data));
                cv_.notify_all();
                return;
            }
            slot->state = RecvSlot::failed;
        }
        slots_.erase(sit);
    }
    q_[key].push_back(std::move(msg.data));
    cv_.notify_all();
}

// GCC-10's libtsan has no interceptor for pthread_cond_clockwait,
// which libstdc++ uses for steady_clock waits on glibc >= 2.30: under
// TSan the mutex release inside the wait is invisible, so the relock
// on wakeup reports a phantom "double lock" and every cross-thread
// edge through the condvar is lost (cascading false races). Waiting on
// system_clock routes through the intercepted pthread_cond_timedwait.
// pop_into re-checks state and recomputes its deadline from
// steady_clock every iteration, so a wall-clock jump perturbs at most
// one wakeup.
static void cv_wait_until_steady(
    std::condition_variable &cv, std::unique_lock<std::mutex> &lk,
    const std::chrono::steady_clock::time_point &tp) {
#if defined(__SANITIZE_THREAD__)
    cv.wait_until(
        lk, std::chrono::system_clock::now() +
                std::chrono::duration_cast<
                    std::chrono::system_clock::duration>(
                    tp - std::chrono::steady_clock::now()));
#else
    cv.wait_until(lk, tp);
#endif
}

Rendezvous::RecvSlot *Rendezvous::begin_recv(const PeerID &src,
                                             const std::string &name,
                                             size_t len) {
    const std::string key = rdv_key(src, name);
    std::lock_guard<std::mutex> lk(mu_);
    auto qit = q_.find(key);
    if (qit != q_.end() && !qit->second.empty())
        return nullptr;  // FIFO: queued messages drain before slots fill
    auto sit = slots_.find(key);
    if (sit == slots_.end() || sit->second.empty()) return nullptr;
    RecvSlot *slot = sit->second.front();
    if (slot->cap < len) {
        // undersized registration: fail it; message falls back to the queue
        sit->second.pop_front();
        if (sit->second.empty()) slots_.erase(sit);
        slot->state = RecvSlot::failed;
        cv_.notify_all();
        return nullptr;
    }
    sit->second.pop_front();
    if (sit->second.empty()) slots_.erase(sit);
    slot->len = len;
    slot->state = RecvSlot::claimed;
    return slot;
}

void Rendezvous::commit_recv(RecvSlot *slot, bool ok) {
    std::lock_guard<std::mutex> lk(mu_);
    slot->state = ok ? RecvSlot::done : RecvSlot::failed;
    cv_.notify_all();
}

int Rendezvous::pop_into(const PeerID &src, const std::string &name,
                         void *buf, size_t cap, size_t *len,
                         int64_t timeout_ms) {
    TraceScope trace(Tracer::RECV_WAIT);
    const std::string key = rdv_key(src, name);
    const bool stall_log = std::getenv("KF_STALL_DETECTION") != nullptr;
    const auto t0 = std::chrono::steady_clock::now();
    const auto deadline = t0 + std::chrono::milliseconds(timeout_ms);
    auto next_stall_report = t0 + std::chrono::seconds(3);
    RecvSlot slot;
    slot.buf = static_cast<uint8_t *>(buf);
    slot.cap = cap;
    bool registered = false;
    std::unique_lock<std::mutex> lk(mu_);
    {
        auto it = q_.find(key);
        if (it != q_.end() && !it->second.empty()) {
            std::vector<uint8_t> msg = std::move(it->second.front());
            it->second.pop_front();
            if (it->second.empty()) q_.erase(it);
            if (msg.size() > cap) return KF_ERR;
            std::memcpy(buf, msg.data(), msg.size());
            if (len) *len = msg.size();
            BufferPool::instance().put(std::move(msg));
            return KF_OK;
        }
        // nothing queued and the sender's channel rotted (corrupt
        // frame) or died mid-epoch: this receive can never be
        // satisfied — corrupt outranks dead so the distinct failure
        // class stays visible through the recovery path
        if (corrupt_.count(src.str())) return KF_ERR_CORRUPT;
        if (dead_.count(src.str())) return KF_ERR_CONN;
        slots_[key].push_back(&slot);
        registered = true;
    }
    for (;;) {
        if (slot.state == RecvSlot::done) {
            if (len) *len = slot.len;
            return KF_OK;
        }
        if (slot.state == RecvSlot::failed)
            return corrupt_.count(src.str()) ? KF_ERR_CORRUPT
                                             : KF_ERR_CONN;
        const auto now = std::chrono::steady_clock::now();
        // a claimed slot is being written by the reader thread: the buffer
        // is in use, so the timeout must wait for the commit
        if (slot.state == RecvSlot::waiting && timeout_ms > 0 &&
            now >= deadline) {
            if (registered) {
                auto sit = slots_.find(key);
                if (sit != slots_.end()) {
                    auto &dq = sit->second;
                    for (auto i = dq.begin(); i != dq.end(); ++i) {
                        if (*i == &slot) {
                            dq.erase(i);
                            break;
                        }
                    }
                    if (dq.empty()) slots_.erase(sit);
                }
            }
            return KF_ERR_TIMEOUT;
        }
        if (stall_log && now >= next_stall_report) {
            KF_WARN("recv-into of %s stalled for %lds", key.c_str(),
                    long(std::chrono::duration_cast<std::chrono::seconds>(
                             now - t0)
                             .count()));
            next_stall_report = now + std::chrono::seconds(3);
        }
        auto wake = now + std::chrono::seconds(3);  // stall-report tick
        if (timeout_ms > 0 && deadline < wake &&
            slot.state == RecvSlot::waiting)
            wake = deadline;
        cv_wait_until_steady(cv_, lk, wake);
    }
}

void Rendezvous::conn_opened(const PeerID &src) {
    std::lock_guard<std::mutex> lk(mu_);
    live_conns_[src.str()]++;
    // the peer is demonstrably alive (again): lift any death mark;
    // a fresh channel also supersedes a corrupt one (the rotten ring
    // was torn down with its connection)
    dead_.erase(src.str());
    corrupt_.erase(src.str());
}

// Fail every waiting slot registered against peer `key` and wake the
// blocked receivers (caller holds mu_; CONN-vs-CORRUPT is decided by
// the dead_/corrupt_ marks alone).
static void fail_waiting_slots_locked(
    std::unordered_map<std::string, std::deque<Rendezvous::RecvSlot *>>
        &slots,
    const std::string &key) {
    const std::string prefix = key + "|";
    for (auto sit = slots.begin(); sit != slots.end();) {
        if (sit->first.compare(0, prefix.size(), prefix) != 0) {
            ++sit;
            continue;
        }
        for (Rendezvous::RecvSlot *s : sit->second)
            if (s->state == Rendezvous::RecvSlot::waiting)
                s->state = Rendezvous::RecvSlot::failed;
        sit = slots.erase(sit);
    }
}

void Rendezvous::conn_corrupt(const PeerID &src) {
    const std::string key = src.str();
    std::lock_guard<std::mutex> lk(mu_);
    corrupt_.insert(key);
    // the mark alone decides CONN-vs-CORRUPT in pop_into; the failure
    // mechanics are identical to a peer death: fail every waiting slot
    // registered against this peer so blocked receivers return NOW
    fail_waiting_slots_locked(slots_, key);
    cv_.notify_all();
}

void Rendezvous::conn_lost(const PeerID &src, bool may_fail) {
    const std::string key = src.str();
    std::lock_guard<std::mutex> lk(mu_);
    auto it = live_conns_.find(key);
    if (it != live_conns_.end()) {
        if (--it->second > 0) return;  // a newer conn from src is live
        live_conns_.erase(it);
    }
    if (!may_fail) return;  // epoch-switch close or server shutdown
    dead_.insert(key);
    fail_waiting_slots_locked(slots_, key);
    cv_.notify_all();
}

void Rendezvous::clear() {
    std::lock_guard<std::mutex> lk(mu_);
    q_.clear();
    dead_.clear();
    corrupt_.clear();  // the rotten channel dies with its epoch
    // fail every waiting registration so blocked receivers fail fast at an
    // epoch switch instead of timing out; claimed slots are mid-write and
    // resolve via the reader's commit_recv
    for (auto &kv : slots_)
        for (RecvSlot *s : kv.second)
            if (s->state == RecvSlot::waiting) s->state = RecvSlot::failed;
    slots_.clear();
    cv_.notify_all();
}

// ------------------------------------------------------------------ store

int Store::save(const std::string &name, const void *data, int64_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blobs_.find(name);
    if (it != blobs_.end() && int64_t(it->second.size()) != n)
        return KF_ERR_ARG;  // size is immutable per name, like the reference
    auto &blob = blobs_[name];
    blob.assign((const uint8_t *)data, (const uint8_t *)data + n);
    return KF_OK;
}

int Store::load(const std::string &name, std::vector<uint8_t> *out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blobs_.find(name);
    if (it == blobs_.end()) return KF_ERR_NOTFOUND;
    *out = it->second;
    return KF_OK;
}

int VersionedStore::save(const std::string &version, const std::string &name,
                         const void *data, int64_t n) {
    std::shared_ptr<Store> store;
    {
        std::lock_guard<std::mutex> lk(mu_);
        for (auto &p : stores_)
            if (p.first == version) store = p.second;
        if (!store) {
            store = std::make_shared<Store>();
            stores_.emplace_back(version, store);
            while (int(stores_.size()) > window_) stores_.pop_front();
        }
    }
    return store->save(name, data, n);
}

int VersionedStore::load(const std::string &version, const std::string &name,
                         std::vector<uint8_t> *out) {
    std::shared_ptr<Store> store;
    {
        std::lock_guard<std::mutex> lk(mu_);
        for (auto &p : stores_)
            if (p.first == version) store = p.second;
    }
    if (!store) return KF_ERR_NOTFOUND;
    return store->load(name, out);
}

// ----------------------------------------------------------------- client

Client::~Client() {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto &kv : conns_) {
        std::lock_guard<std::mutex> clk(kv.second->mu);
        if (kv.second->fd >= 0) ::close(kv.second->fd);
        kv.second->fd = -1;
    }
    conns_.clear();
    for (auto &kv : shm_) {
        kv.second->abort.store(true);
        std::lock_guard<std::mutex> clk(kv.second->mu);
        if (kv.second->fd >= 0) ::close(kv.second->fd);
        kv.second->fd = -1;
        kv.second->ring.reset();
    }
    shm_.clear();
}

void Client::set_token(uint32_t token) { token_ = token; }

int Client::dial_fd(const PeerID &dest, LinkClass *link) {
    // colocated peers (same IPv4) talk over a Unix socket, skipping the TCP
    // stack (reference: connection.go:60-64 dials SockFile when src/dst
    // share an IP); fall back to TCP if the socket file isn't there yet
    if (dest.colocated_with(self_) && !unix_sockets_disabled()) {
        int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
        if (fd >= 0) {
            sockaddr_un ua{};
            ua.sun_family = AF_UNIX;
            const std::string path = sock_path(dest);
            std::strncpy(ua.sun_path, path.c_str(), sizeof(ua.sun_path) - 1);
            if (::connect(fd, (sockaddr *)&ua, sizeof(ua)) == 0) {
                grow_unix_bufs(fd);
                if (link) *link = LinkClass::uds;
                return fd;
            }
            ::close(fd);
        }
    }
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return KF_ERR_CONN;
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(dest.port);
    addr.sin_addr.s_addr = htonl(dest.ipv4);
    if (::connect(fd, (sockaddr *)&addr, sizeof(addr)) != 0) {
        ::close(fd);
        return KF_ERR_CONN;
    }
    if (link) *link = LinkClass::tcp;
    return fd;
}

int Client::dial(const PeerID &dest, ConnType t, LinkClass *link) {
    TraceScope trace(Tracer::DIAL);
    int fd = dial_fd(dest, link);
    if (fd < 0) return fd;
    ConnHeader h{uint16_t(t), self_.port, self_.ipv4, token_.load()};
    Ack ack{};
    if (!write_exact(fd, &h, sizeof(h)) || !read_exact(fd, &ack, sizeof(ack))) {
        ::close(fd);
        return KF_ERR_CONN;
    }
    if (ack.token != token_.load() &&
        (t == ConnType::collective || t == ConnType::shm)) {
        // stale-epoch fence (reference: connection.go:81-87); shm
        // channels carry collective traffic and fence identically
        ::close(fd);
        return KF_ERR_EPOCH;
    }
    return fd;
}

std::shared_ptr<Client::Conn> Client::get(const PeerID &dest, ConnType t) {
    const uint64_t key = (dest.key() << 3) | uint64_t(t);
    std::lock_guard<std::mutex> lk(mu_);
    auto &c = conns_[key];
    if (!c) c = std::make_shared<Conn>();
    return c;
}

std::shared_ptr<Client::ShmChan> Client::get_shm(const PeerID &dest) {
    std::lock_guard<std::mutex> lk(mu_);
    auto &c = shm_[dest.key()];
    if (!c) c = std::make_shared<ShmChan>();
    return c;
}

int Client::ensure_connected(Conn *c, const PeerID &dest, ConnType t) {
    if (c->fd >= 0) return KF_OK;
    int last = KF_ERR_CONN;
    int epoch_misses = 0;
    // full dial patience is for peers still BOOTING; a peer this conn
    // already reached and then lost has died mid-epoch, and senders must
    // fail fast like receivers do (Rendezvous::fail_peer), not burn the
    // whole patience budget (reference: bounded reconnect,
    // connection.go:81-87)
    const int budget = c->was_connected ? reconnect_retries
                                        : connect_retries;
    for (int i = 0; i <= budget; i++) {
        last = dial(dest, t, &c->link);
        if (last >= 0) break;
        // KF_ERR_EPOCH gets a short retry budget of its own: during a
        // resize, peers switch to the new cluster version at slightly
        // different times, so a dial from the new epoch can race a remote
        // that has not yet bumped its token (the reference retries through
        // this window, connection.go:81-87 + config.go:16-18); each
        // re-dial re-reads our own token, healing the laggard case too.
        // But a *persistently* mismatched token means this worker is
        // genuinely stale (e.g. evicted), and must fail fast rather than
        // burn the full dial-patience loop while holding the conn mutex.
        if (last == KF_ERR_EPOCH && ++epoch_misses > epoch_retries)
            return last;
        std::this_thread::sleep_for(
            std::chrono::milliseconds(connect_retry_ms));
    }
    if (last < 0) return last;
    c->fd = last;
    c->was_connected = true;
    return KF_OK;
}

int Client::send(const PeerID &dest, ConnType t, const std::string &name,
                 uint32_t flags, const void *data, size_t len) {
    TraceScope trace(Tracer::SEND);
    // colocated collective traffic prefers the shared-memory ring (the
    // same colocated_with check that picks the Unix socket); anything
    // short of an established channel falls through to the sockets
    if (t == ConnType::collective && shm_enabled_ &&
        dest.colocated_with(self_) && !(dest == self_)) {
        int rc = send_shm(dest, name, flags, data, len);
        if (rc != kShmFallback) return rc;
    }
    auto c = get(dest, t);
    std::lock_guard<std::mutex> lk(c->mu);
    // a pooled fd may have been kicked by the peer's epoch switch: one
    // transparent re-dial on write failure
    for (int attempt = 0; attempt < 2; attempt++) {
        int rc = ensure_connected(c.get(), dest, t);
        if (rc != KF_OK) return rc;
        if (write_message(c->fd, name, flags, data, len)) {
            counters_->add_egress(c->link, len);
            return KF_OK;
        }
        ::close(c->fd);
        c->fd = -1;
    }
    return KF_ERR_CONN;
}

int Client::send_shm(const PeerID &dest, const std::string &name,
                     uint32_t flags, const void *data, size_t len) {
    auto ch = get_shm(dest);
    std::lock_guard<std::mutex> lk(ch->mu);
    // Degraded-transport mode is FIRST-CLASS, never silent: the pair is
    // counted (kf_link_fallback_total), logged once (failed latches for
    // the epoch; Client::reset clears the channel map, so the next
    // epoch switch retries shm), and KF_SHM_REQUIRE=1 turns the
    // degradation into a loud error for benchmark runs that must not
    // quietly measure the socket path.
    auto degrade = [&](const char *why) -> int {
        ch->failed = true;
        if (shm_require()) {
            // no fallback happens in require mode, so the fallback
            // counter stays untouched: kf_link_fallback_total must
            // mean "bytes moved to sockets", never "failed loudly"
            KF_ERROR("KF_SHM_REQUIRE=1 but shm to %s is unavailable "
                     "(%s): failing instead of degrading to sockets",
                     dest.str().c_str(), why);
            return KF_ERR;
        }
        counters_->shm_fallback.fetch_add(1);
        KF_WARN("shm to %s unavailable (%s): pair degraded to socket "
                "transport for this epoch (kf_link_fallback_total++; "
                "retried at the next epoch switch)",
                dest.str().c_str(), why);
        return kShmFallback;
    };
    if (ch->failed) return shm_require() ? KF_ERR : kShmFallback;
    // the hello socket is the receiver's liveness/epoch signal: its
    // EOF means the ring reader is gone (peer died, or its epoch
    // switch kicked us), so writing would "succeed" into a ring
    // nobody drains. Tear down and re-establish — the fresh dial
    // re-runs the token handshake, so a stale-epoch sender fails
    // with KF_ERR_EPOCH exactly like a kicked socket sender.
    if (ch->ring && shm_sock_dead(ch->fd)) {
        ::close(ch->fd);
        ch->fd = -1;
        ch->ring.reset();
    }
    if (!ch->ring) {
        const std::string dir = shm_dir();
        if (dir.empty()) return degrade("no usable /dev/shm directory");
        // dial with the same patience budgets sockets get: full
        // patience for a dest that may still be booting, the short
        // reconnect budget once this channel was established and lost
        // (a reached-then-lost peer died mid-epoch — senders must fail
        // fast like receivers, not burn 30s re-dialing a corpse and
        // then 30s more on a socket fallback), and the same
        // stale-epoch fencing either way
        int fd = KF_ERR_CONN;
        int epoch_misses = 0;
        const int budget = ch->was_connected ? reconnect_retries
                                             : connect_retries;
        for (int i = 0; i <= budget; i++) {
            if (ch->abort.load()) return KF_ERR_CONN;  // epoch teardown
            fd = dial(dest, ConnType::shm);
            if (fd >= 0) break;
            if (fd == KF_ERR_EPOCH && ++epoch_misses > epoch_retries)
                return fd;  // genuinely stale: fail like a collective
            std::this_thread::sleep_for(
                std::chrono::milliseconds(connect_retry_ms));
        }
        if (fd < 0) {
            if (fd == KF_ERR_EPOCH) return fd;
            if (ch->was_connected) return KF_ERR_CONN;  // died mid-epoch
            return degrade("hello dial exhausted its patience budget");
        }
        char path[192];
        std::snprintf(path, sizeof(path), "%s/%08x-%u-%08x-%u-%u-%u.ring",
                      dir.c_str(), self_.ipv4, unsigned(self_.port),
                      dest.ipv4, unsigned(dest.port), unsigned(::getpid()),
                      unsigned(shm_seq_.fetch_add(1)));
        auto ring = ShmRing::create(path, kShmRingBytes);
        // hello: the ring path travels over the fenced socket; the one
        // ack byte proves the receiver mapped it (a receiver that
        // cannot — /dev/shm full, policy — closes instead, and we keep
        // the socket path with per-pair total message order intact)
        uint8_t ack = 0;
        if (!ring || !write_message(fd, path, 0, nullptr, 0) ||
            !read_exact(fd, &ack, 1) || ack != 1) {
            ::close(fd);
            if (ring) ring->unlink();
            return degrade(!ring ? "ring segment creation failed "
                                   "(/dev/shm full?)"
                                 : "receiver could not map the ring");
        }
        ch->fd = fd;
        ch->abort.store(false);
        ch->ring = std::move(ring);
        ch->was_connected = true;
    }
    // framed like write_message plus a leading u32 header checksum,
    // streamed into the ring; the payload goes source buffer -> ring
    // with no staging vector
    uint8_t hdr[16 + 4096];
    const uint32_t name_len = uint32_t(name.size());
    if (name_len > 4096) return KF_ERR_ARG;
    std::memcpy(hdr + 4, &name_len, 4);
    std::memcpy(hdr + 8, name.data(), name_len);
    const uint32_t len32 = uint32_t(len);
    std::memcpy(hdr + 8 + name_len, &flags, 4);
    std::memcpy(hdr + 12 + name_len, &len32, 4);
    uint32_t crc = frame_crc32(hdr + 4, 12 + name_len);
    if (take_corrupt_injection()) {
        KF_WARN("KF_SHM_INJECT_CORRUPT: corrupting frame %s -> %s",
                name.c_str(), dest.str().c_str());
        crc ^= 0xDEADBEEFu;
    }
    std::memcpy(hdr, &crc, 4);
    const int64_t stall = body_stall_ms();
    auto alive = [&ch] { return !ch->abort.load(); };
    if (!ch->ring->write(hdr, 16 + name_len, stall, alive) ||
        (len && !ch->ring->write(data, len, stall, alive))) {
        // receiver dead or torn down mid-epoch: fail like a lost
        // collective conn (no silent socket fallback — per-pair order
        // is law). `failed` stays false: a later send re-establishes
        // under the short was_connected budget and fails fast again
        // if the peer is really gone.
        ::close(ch->fd);
        ch->fd = -1;
        ch->ring.reset();
        return KF_ERR_CONN;
    }
    counters_->add_egress(LinkClass::shm, len);
    return KF_OK;
}

int Client::request(const PeerID &dest, const std::string &version,
                    const std::string &name, std::vector<uint8_t> *out) {
    auto c = get(dest, ConnType::p2p);
    std::lock_guard<std::mutex> lk(c->mu);
    for (int attempt = 0; attempt < 2; attempt++) {
        int rc = ensure_connected(c.get(), dest, ConnType::p2p);
        if (rc != KF_OK) return rc;
        // body carries the requested store version ("" = unversioned store)
        WireMessage resp;
        if (write_message(c->fd, name, 0, version.data(), version.size()) &&
            read_message(c->fd, &resp) && (resp.flags & kFlagIsResponse)) {
            if (resp.flags & kFlagRequestFailed) return KF_ERR_NOTFOUND;
            counters_->add_ingress(c->link, resp.data.size());
            *out = std::move(resp.data);
            return KF_OK;
        }
        ::close(c->fd);
        c->fd = -1;
    }
    return KF_ERR_CONN;
}

int Client::ping(const PeerID &dest, int64_t *rtt_us) {
    // throwaway connection, like the reference's Ping
    int64_t t0 = now_us();
    int fd = dial(dest, ConnType::ping);
    if (fd < 0) return fd;
    if (!write_message(fd, "ping", 0, nullptr, 0)) {
        ::close(fd);
        return KF_ERR_CONN;
    }
    WireMessage echo;
    bool ok = read_message(fd, &echo);
    ::close(fd);
    if (!ok) return KF_ERR_CONN;
    if (rtt_us) *rtt_us = now_us() - t0;
    return KF_OK;
}

void Client::reset(const std::vector<PeerID> &keep, uint32_t token) {
    token_ = token;
    std::unordered_set<uint64_t> keep_keys;
    for (auto &p : keep) keep_keys.insert(p.key());
    std::lock_guard<std::mutex> lk(mu_);
    for (auto it = conns_.begin(); it != conns_.end();) {
        const uint64_t peer_key = it->first >> 3;
        const auto t = ConnType(it->first & 7);
        // collective conns always reconnect under the new token; others
        // survive only if the peer remains a member
        const bool drop =
            t == ConnType::collective || !keep_keys.count(peer_key);
        if (drop) {
            {
                std::lock_guard<std::mutex> clk(it->second->mu);
                if (it->second->fd >= 0) ::close(it->second->fd);
                it->second->fd = -1;
            }
            it = conns_.erase(it);
        } else {
            ++it;
        }
    }
    // shm channels carry collective traffic: always rebuilt under the
    // new token. `abort` first — a writer blocked on a full ring holds
    // the channel mutex, and must be kicked out (it fails with
    // KF_ERR_CONN, exactly like a socket sender whose fd got closed)
    // before the teardown below can take that mutex.
    for (auto &kv : shm_) kv.second->abort.store(true);
    for (auto &kv : shm_) {
        std::lock_guard<std::mutex> clk(kv.second->mu);
        if (kv.second->fd >= 0) ::close(kv.second->fd);
        kv.second->fd = -1;
        if (kv.second->ring) kv.second->ring->close();
        kv.second->ring.reset();
    }
    shm_.clear();
}

// ----------------------------------------------------------------- server

int Server::start() {
    // startup hygiene: unlink ring debris from previous crashed runs
    // (a producer SIGKILLed inside the create->attach handshake window
    // leaks its file; attached segments never do). Age-gated so a
    // concurrent cluster's in-flight handshake is untouched;
    // KF_SHM_SWEEP=0 opts out (docs/collectives.md).
    if (shm_transport_enabled()) shm_sweep_stale();
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return KF_ERR;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(self_.port);
    // bind the peer's OWN address, not INADDR_ANY: the peer list defines
    // where this worker is reachable, and per-IP binding lets several
    // emulated hosts (loopback aliases) share a port range on one
    // machine the way distinct pod hosts do. NAT'd workers (container
    // addressed by a host IP no local interface carries) get
    // EADDRNOTAVAIL here — fall back to wildcard for them.
    addr.sin_addr.s_addr = htonl(self_.ipv4);
    int rc = ::bind(listen_fd_, (sockaddr *)&addr, sizeof(addr));
    if (rc != 0 && errno == EADDRNOTAVAIL) {
        KF_WARN("%s is not a local address (NAT?); listening on wildcard",
                self_.str().c_str());
        addr.sin_addr.s_addr = htonl(INADDR_ANY);
        rc = ::bind(listen_fd_, (sockaddr *)&addr, sizeof(addr));
    }
    if (rc != 0 || ::listen(listen_fd_, 128) != 0) {
        KF_ERROR("bind/listen failed on %s: %s", self_.str().c_str(),
                 std::strerror(errno));
        ::close(listen_fd_);
        listen_fd_ = -1;
        return KF_ERR;
    }
    // non-blocking listener: the accept loop is poll-driven, and a
    // pending connection can be aborted between poll() readiness and
    // the accept() call (accept(2) documents this race) — a BLOCKING
    // accept would then sit past the self-pipe wakeup and hang stop().
    // Accepted fds do not inherit the flag, so conn readers stay
    // blocking as before.
    ::fcntl(listen_fd_, F_SETFL,
            ::fcntl(listen_fd_, F_GETFL, 0) | O_NONBLOCK);
    if (!unix_sockets_disabled() && ensure_sock_dir()) {
        unix_path_ = sock_path(self_);
        ::unlink(unix_path_.c_str());  // stale socket from a dead process
        unix_fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
        if (unix_fd_ >= 0) {
            sockaddr_un ua{};
            ua.sun_family = AF_UNIX;
            std::strncpy(ua.sun_path, unix_path_.c_str(),
                         sizeof(ua.sun_path) - 1);
            if (::bind(unix_fd_, (sockaddr *)&ua, sizeof(ua)) != 0 ||
                ::listen(unix_fd_, 128) != 0) {
                KF_WARN("unix bind/listen failed on %s: %s (TCP only)",
                        unix_path_.c_str(), std::strerror(errno));
                ::close(unix_fd_);
                unix_fd_ = -1;
            } else {
                ::fcntl(unix_fd_, F_SETFL,
                        ::fcntl(unix_fd_, F_GETFL, 0) | O_NONBLOCK);
            }
        }
    }
    int wp[2];
    if (::pipe(wp) == 0) {
        wake_r_ = wp[0];
        wake_w_ = wp[1];
    }
    running_ = true;
    accept_thread_ = std::thread([this] { accept_loop(listen_fd_, true); });
    if (unix_fd_ >= 0)
        unix_accept_thread_ =
            std::thread([this] { accept_loop(unix_fd_, false); });
    return KF_OK;
}

void Server::stop() {
    if (!running_.exchange(false)) return;
    // wake the accept loops through the self-pipe FIRST: the byte is
    // left unread, so the level-triggered poll wakes BOTH loops however
    // they interleave with this write (shutdown on the listeners is not
    // enough — a listening AF_UNIX socket ignores it on Linux)
    if (wake_w_ >= 0) {
        char one = 1;
        (void)!::write(wake_w_, &one, 1);
    }
    ::shutdown(listen_fd_, SHUT_RDWR);
    if (accept_thread_.joinable()) accept_thread_.join();
    if (unix_accept_thread_.joinable()) unix_accept_thread_.join();
    ::close(listen_fd_);
    listen_fd_ = -1;
    if (unix_fd_ >= 0) {
        ::close(unix_fd_);
        ::unlink(unix_path_.c_str());
        unix_fd_ = -1;
    }
    if (wake_r_ >= 0) ::close(wake_r_);
    if (wake_w_ >= 0) ::close(wake_w_);
    wake_r_ = wake_w_ = -1;
    // kick every reader out of its blocking read, then wait for the
    // (detached) connection threads to drain
    std::unique_lock<std::mutex> lk(mu_);
    for (int fd : live_fds_) ::shutdown(fd, SHUT_RDWR);
    conns_done_cv_.wait(lk, [this] { return active_conns_ == 0; });
}

void Server::drop_connections() {
    std::lock_guard<std::mutex> lk(mu_);
    for (int fd : live_fds_) ::shutdown(fd, SHUT_RDWR);
}

void Server::set_control_handler(ControlHandler h) {
    std::lock_guard<std::mutex> lk(mu_);
    control_handler_ = std::move(h);
}

void Server::set_request_handler(RequestHandler h) {
    std::lock_guard<std::mutex> lk(mu_);
    request_handler_ = std::move(h);
}

void Server::accept_loop(int listen_fd, bool tcp) {
    while (running_) {
        // poll before accept so stop() can wake this loop via the
        // self-pipe even where shutdown() on the listener is a no-op
        // (AF_UNIX); the wake byte stays unread => every loop wakes
        pollfd pfds[2] = {{listen_fd, POLLIN, 0}, {wake_r_, POLLIN, 0}};
        int pr = ::poll(pfds, wake_r_ >= 0 ? 2 : 1, 500);
        if (pr < 0 && errno != EINTR) break;
        if (!running_) break;
        if (pr <= 0 || !(pfds[0].revents & POLLIN)) {
            if (pfds[0].revents & (POLLERR | POLLHUP | POLLNVAL)) break;
            continue;
        }
        int fd = ::accept(listen_fd, nullptr, nullptr);
        if (fd < 0) {
            // EAGAIN: the pending connection vanished between poll()
            // readiness and this call — the race the non-blocking
            // listener exists for; just go back to the poll
            if (running_) continue;
            break;
        }
        if (tcp) {
            int one = 1;
            ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        } else {
            grow_unix_bufs(fd);
        }
        {
            std::lock_guard<std::mutex> lk(mu_);
            live_fds_.insert(fd);
            active_conns_++;
        }
        // detached: reaped via active_conns_ in stop(); the fd is removed
        // from live_fds_ BEFORE close so a recycled fd number can't be
        // erased by a stale cleanup
        const LinkClass link = tcp ? LinkClass::tcp : LinkClass::uds;
        std::thread([this, fd, link] {
            serve_conn(fd, link);
            std::unique_lock<std::mutex> lk(mu_);
            live_fds_.erase(fd);
            ::close(fd);
            if (--active_conns_ == 0) conns_done_cv_.notify_all();
        }).detach();
    }
}

// NOTE: never closes fd — the accept_loop wrapper owns close, so the fd
// number stays registered in live_fds_ until the instant it is released.
void Server::serve_conn(int fd, LinkClass link) {
    ConnHeader h;
    if (!read_exact(fd, &h, sizeof(h))) return;
    Ack ack{token_.load()};
    if (!write_exact(fd, &ack, sizeof(ack))) return;
    const PeerID src{h.src_ipv4, h.src_port};
    const auto t = ConnType(h.type);
    if (t == ConnType::shm) {
        serve_shm(fd, src, h.token == ack.token, ack.token);
        return;
    }
    if (t == ConnType::collective) {
        // a stale-epoch dial (mid-resize laggard) is not a liveness
        // signal either way: its EOF is the dialer noticing our ack's
        // token mismatch, not a death — keep it out of the accounting
        const bool same_epoch = h.token == ack.token;
        if (same_epoch) rdv_->conn_opened(src);
        // collective fast path: after the header, ask the rendezvous for a
        // registered buffer so the body lands in-place (zero-copy); else
        // read into a pooled vector and queue it
        [&] {
            while (running_) {
                uint32_t name_len;
                if (!read_exact(fd, &name_len, 4)) return;
                if (name_len > 4096) return;
                std::string name(name_len, '\0');
                if (name_len && !read_exact(fd, name.data(), name_len))
                    return;
                uint32_t flags, len;
                if (!read_exact(fd, &flags, 4)) return;
                if (!read_exact(fd, &len, 4)) return;
                counters_->add_ingress(link, len);
                const int64_t stall = body_stall_ms();
                if (auto *slot = rdv_->begin_recv(src, name, len)) {
                    const bool ok =
                        len == 0 ||
                        read_exact_progress(fd, slot->buf, len, stall);
                    rdv_->commit_recv(slot, ok);
                    if (!ok) return;
                    continue;
                }
                WireMessage msg;
                msg.name = std::move(name);
                msg.flags = flags;
                msg.data = BufferPool::instance().get(len);
                if (len &&
                    !read_exact_progress(fd, msg.data.data(), len, stall))
                    return;
                rdv_->push(src, std::move(msg));
            }
        }();
        // EOF/error on the sender's LAST same-epoch collective conn means
        // it died mid-epoch (a graceful epoch switch bumps the token
        // BEFORE conns drop, making ack.token stale here): fail its
        // waiting receivers now instead of letting them block out their
        // timeout
        if (same_epoch)
            rdv_->conn_lost(src, running_ && token_.load() == ack.token);
        return;
    }
    WireMessage msg;
    while (running_ && read_message(fd, &msg)) {
        counters_->add_ingress(link, msg.data.size());
        switch (t) {
            case ConnType::collective:
            case ConnType::shm:
                return;  // unreachable: dedicated loops above handle these
            case ConnType::p2p: {
                RequestHandler handler;
                {
                    std::lock_guard<std::mutex> lk(mu_);
                    handler = request_handler_;
                }
                std::vector<uint8_t> blob;
                int rc = KF_ERR_NOTFOUND;
                if (handler) {
                    std::string version(msg.data.begin(), msg.data.end());
                    rc = handler(version, msg.name, &blob);
                }
                uint32_t flags = kFlagIsResponse;
                if (rc != KF_OK) flags |= kFlagRequestFailed;
                if (!write_message(fd, msg.name, flags, blob.data(),
                                   blob.size()))
                    return;
                counters_->add_egress(link, blob.size());
                break;
            }
            case ConnType::control: {
                ControlHandler handler;
                {
                    std::lock_guard<std::mutex> lk(mu_);
                    handler = control_handler_;
                }
                if (handler) handler(msg.name, msg.data);
                break;
            }
            case ConnType::ping:
                if (!write_message(fd, msg.name, 0, msg.data.data(),
                                   msg.data.size()))
                    return;
                break;
        }
        msg = WireMessage{};
    }
}

void Server::serve_shm(int fd, const PeerID &src, bool same_epoch,
                       uint32_t epoch_token) {
    // hello: exactly one message whose name is the sender's ring path
    WireMessage hello;
    if (!read_message(fd, &hello, 4096)) return;
    auto ring = inject_attach_fail() ? nullptr
                                     : ShmRing::attach(hello.name);
    uint8_t ok = ring ? 1 : 0;
    if (ring) ring->unlink();  // both sides mapped: the name can go
    if (!write_exact(fd, &ok, 1) || !ring) return;
    if (same_epoch) rdv_->conn_opened(src);
    // liveness mirrors the collective socket loop, but the data comes
    // out of the ring: the silent hello socket supplies the death /
    // epoch-reset signal (stop() and drop_connections() shut it down
    // like any live fd), polled between messages and inside body waits
    auto alive = [this, fd] { return running_ && !shm_sock_dead(fd); };
    const int64_t stall = body_stall_ms();
    // integrity: a frame whose header fails its checksum or length
    // validation poisons the WHOLE channel (the stream position is
    // untrusted from that byte on) — receivers blocked on this peer
    // fail with KF_ERR_CORRUPT and ride the same recovery path a peer
    // death does, instead of a garbage name/len feeding a reduce
    bool corrupt = false;
    while (running_) {
        const int r = ring->wait_readable(100);
        if (r < 0) break;  // producer closed (clean teardown)
        if (r == 0) {
            if (!alive()) break;
            continue;
        }
        // a message has begun: the rest of its frame streams out under
        // the same mid-body stall contract sockets get
        uint32_t crc, name_len;
        if (!ring->read(&crc, 4, stall, alive)) break;
        if (!ring->read(&name_len, 4, stall, alive)) break;
        if (name_len > 4096) {
            KF_ERROR("shm ring from %s: frame name_len %u fails "
                     "validation — torn/corrupt frame, failing the "
                     "channel (KF_ERR_CORRUPT)",
                     src.str().c_str(), name_len);
            corrupt = true;
            break;
        }
        uint8_t hdr[12 + 4096];
        std::memcpy(hdr, &name_len, 4);
        if (name_len && !ring->read(hdr + 4, name_len, stall, alive))
            break;
        if (!ring->read(hdr + 4 + name_len, 8, stall, alive)) break;
        if (frame_crc32(hdr, 12 + name_len) != crc) {
            KF_ERROR("shm ring from %s: frame header checksum mismatch "
                     "— torn/corrupt frame, failing the channel "
                     "(KF_ERR_CORRUPT)",
                     src.str().c_str());
            corrupt = true;
            break;
        }
        std::string name(reinterpret_cast<char *>(hdr) + 4, name_len);
        uint32_t flags, len;
        std::memcpy(&flags, hdr + 4 + name_len, 4);
        std::memcpy(&len, hdr + 8 + name_len, 4);
        counters_->add_ingress(LinkClass::shm, len);
        if (auto *slot = rdv_->begin_recv(src, name, len)) {
            // registered receive: ring bytes land straight in the
            // caller's buffer — the zero-copy path end to end
            const bool body_ok =
                len == 0 || ring->read(slot->buf, len, stall, alive);
            rdv_->commit_recv(slot, body_ok);
            if (!body_ok) break;
            continue;
        }
        WireMessage msg;
        msg.name = std::move(name);
        msg.flags = flags;
        msg.data = BufferPool::instance().get(len);
        if (len && !ring->read(msg.data.data(), len, stall, alive)) break;
        rdv_->push(src, std::move(msg));
    }
    // the corrupt mark carries the SAME live-token guard conn_lost
    // gets: a stale reader (epoch already switched, clear() already
    // wiped the marks) finishing its detection late must not poison
    // the new epoch's corrupt_ set
    if (corrupt && same_epoch && running_ &&
        token_.load() == epoch_token)
        rdv_->conn_corrupt(src);
    if (same_epoch)
        rdv_->conn_lost(src, running_ && token_.load() == epoch_token);
}

}  // namespace kf
