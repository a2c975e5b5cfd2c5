// TCP transport: framed named messages, connection pool, server,
// collective rendezvous, blob store.
// (Control-plane rebuild of reference srcs/go/rchannel + srcs/go/store.)
//
// Wire protocol (all integers little-endian):
//   on connect:  ConnHeader { u16 type, u16 src_port, u32 src_ipv4 }
//   server ack:  Ack        { u32 token }   -- token = cluster epoch; a
//                Collective dial whose token mismatches the dialer's epoch
//                is rejected (stale-epoch fencing).
//   then a stream of messages:
//                MsgHeader  { u32 name_len, name bytes, u32 flags }
//                Body       { u32 len, data }
#pragma once

#include <atomic>
#include <condition_variable>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "core.hpp"
#include "shm.hpp"

namespace kf {

enum class ConnType : uint16_t {
    ping = 0,
    control = 1,
    collective = 2,
    p2p = 3,
    // shm hello/liveness channel: the dial carries the normal epoch
    // token handshake, then exactly one message naming the sender's
    // ring segment; afterwards the socket is silent and its EOF is the
    // (only) death/epoch-reset signal for the ring reader. Ring frames
    // prepend a u32 FNV-1a checksum of the frame header (name_len,
    // name, flags, len) to the socket frame format, so a torn or
    // header-corrupted frame surfaces as KF_ERR_CORRUPT instead of
    // being mis-framed into a reduce (docs/collectives.md "Failure
    // semantics").
    shm = 4,
};

// Wire link classes for byte attribution (kf_link_stats; kftrace's
// kf_wire_bytes_total{link=...} renders these): TCP socket, AF_UNIX
// socket, shared-memory ring.
enum class LinkClass : int { tcp = 0, uds = 1, shm = 2 };
constexpr int kNumLinkClasses = 3;

// message flags
constexpr uint32_t kFlagIsResponse = 1u << 1;
constexpr uint32_t kFlagRequestFailed = 1u << 2;

struct WireMessage {
    std::string name;
    uint32_t flags = 0;
    std::vector<uint8_t> data;
};

// ------------------------------------------------------------- buffer pool

// Power-of-2 free-list pool for receive buffers (reference:
// srcs/go/rchannel/connection/byte_slice_pool.go keeps per-size-class
// sync.Pools behind recvQ). Vectors handed out have size()==n and a pow-2
// capacity; put() recycles them up to a global cap so steady-state
// collective traffic stops allocating.
class BufferPool {
  public:
    static BufferPool &instance();
    std::vector<uint8_t> get(size_t n);
    void put(std::vector<uint8_t> &&v);
    // bytes currently cached (for tests/metrics)
    size_t cached_bytes();

  private:
    static constexpr int kBuckets = 33;  // capacities 2^0 .. 2^32
    static constexpr size_t kMaxCachedBytes = size_t(1) << 28;  // 256 MiB
    std::mutex mu_;
    std::deque<std::vector<uint8_t>> buckets_[kBuckets];
    size_t cached_ = 0;
};

// RAII pooled buffer: releases back to the pool on scope exit.
class PooledBuf {
  public:
    explicit PooledBuf(size_t n) : v_(BufferPool::instance().get(n)) {}
    ~PooledBuf() { BufferPool::instance().put(std::move(v_)); }
    PooledBuf(const PooledBuf &) = delete;
    PooledBuf &operator=(const PooledBuf &) = delete;
    uint8_t *data() { return v_.data(); }
    size_t size() const { return v_.size(); }

  private:
    std::vector<uint8_t> v_;
};

// Filesystem path of a peer's colocated-peer Unix socket. Derived from
// (uid, ipv4, port) so parallel test clusters of different users cannot
// collide (reference: plan/addr.go:50-59 SockFile). Colocated peers dial
// this instead of TCP loopback; KF_NO_UNIX_SOCKET=1 disables.
std::string sock_path(const PeerID &p);

// ------------------------------------------------------------------- fd io

// Blocking exact-length read/write on a socket fd; false on EOF/error.
bool read_exact(int fd, void *buf, size_t n);
bool write_exact(int fd, const void *buf, size_t n);
bool write_message(int fd, const std::string &name, uint32_t flags,
                   const void *data, size_t len);
// max_len guards allocations against corrupt/hostile length prefixes
bool read_message(int fd, WireMessage *out, size_t max_len = size_t(1) << 33);

// ------------------------------------------------------------- rendezvous

// Named FIFO mailboxes for collective traffic: key = (src peer, tensor
// name). FIFO per key matches per-connection message order, which is what
// makes reduce-phase and bcast-phase messages on the same name unambiguous.
class Rendezvous {
  public:
    // Registered in-place receive: the socket reader writes the message
    // body straight into a slot's caller-owned buffer, skipping the queue
    // allocation + copy (reference: WaitRecvBuf flag, message.go:70-75 +
    // handler/collective.go:34-41 RecvInto).
    struct RecvSlot {
        uint8_t *buf = nullptr;
        size_t cap = 0;
        size_t len = 0;  // filled body length
        enum { waiting, claimed, done, failed } state = waiting;
    };

    void push(const PeerID &src, WireMessage msg);
    // In-place receive into caller memory. Takes an already-queued message
    // if present (recycling its buffer), else registers `buf` so the reader
    // thread fills it directly. Fails with KF_ERR if the message is larger
    // than cap, KF_ERR_CONN if the connection died mid-body or clear() ran.
    int pop_into(const PeerID &src, const std::string &name, void *buf,
                 size_t cap, size_t *len, int64_t timeout_ms);
    // Reader side: claim a waiting slot for (src,name) if one exists and
    // the queue is empty (FIFO order); nullptr = read into a pooled vector
    // and push(). A slot too small for `len` is failed and nullptr returned.
    RecvSlot *begin_recv(const PeerID &src, const std::string &name,
                         size_t len);
    void commit_recv(RecvSlot *slot, bool ok);
    // Drops queued messages and fails all waiting slots (epoch switch).
    void clear();
    // Inbound collective-connection lifecycle, driving peer liveness:
    // when a peer's LAST live conn is lost mid-epoch (may_fail=true, i.e.
    // not an epoch-switch close), the peer is marked dead and every
    // waiting slot registered against it fails — receivers get
    // KF_ERR_CONN immediately instead of blocking out their full timeout
    // (the fail-fast the reference's runner gets from watch.go:136-149
    // process supervision). Queued messages are kept: data that already
    // arrived is still valid. The live-conn count makes a same-epoch
    // client re-dial race harmless: the old conn's EOF is a no-op while
    // the newer conn is open, and a fresh conn lifts any death mark.
    void conn_opened(const PeerID &src);
    void conn_lost(const PeerID &src, bool may_fail);
    // Frame-integrity violation on an inbound channel (shm ring frame
    // failed its header checksum / length validation): the stream
    // position is untrusted, so the whole channel dies and receivers
    // blocked on this peer fail with KF_ERR_CORRUPT — the same
    // fail-fast-into-recovery shape as a peer death, but with a
    // distinct code so a silent-garbage bug class is visible as
    // itself. Lifted like a death mark: clear() (epoch switch) or a
    // fresh conn from the peer.
    void conn_corrupt(const PeerID &src);

  private:
    std::mutex mu_;
    std::condition_variable cv_;
    std::unordered_map<std::string, std::deque<std::vector<uint8_t>>> q_;
    std::unordered_map<std::string, std::deque<RecvSlot *>> slots_;
    std::unordered_set<std::string> dead_;  // peers whose conn died mid-epoch
    // peers whose inbound frames failed integrity checks: receives
    // fail with KF_ERR_CORRUPT instead of KF_ERR_CONN
    std::unordered_set<std::string> corrupt_;
    std::unordered_map<std::string, int> live_conns_;  // inbound, per peer
};

// ------------------------------------------------------------------ store

// Named blobs; size-checked on re-save like the reference store.
class Store {
  public:
    int save(const std::string &name, const void *data, int64_t n);
    // returns KF_OK and copies into out (must be exact size), or
    // KF_ERR_NOTFOUND / KF_ERR_ARG on size mismatch
    int load(const std::string &name, std::vector<uint8_t> *out);

  private:
    std::mutex mu_;
    std::unordered_map<std::string, std::vector<uint8_t>> blobs_;
};

// Sliding window of `window` versioned stores (reference keeps 3 so async
// peers can fetch slightly-stale models while new ones are written).
class VersionedStore {
  public:
    explicit VersionedStore(int window = 3) : window_(window) {}
    int save(const std::string &version, const std::string &name,
             const void *data, int64_t n);
    int load(const std::string &version, const std::string &name,
             std::vector<uint8_t> *out);

  private:
    int window_;
    std::mutex mu_;
    std::deque<std::pair<std::string, std::shared_ptr<Store>>> stores_;
};

// ----------------------------------------------------------------- client

struct Counters {
    std::atomic<uint64_t> egress{0}, ingress{0};
    // per link class (LinkClass order: tcp, unix, shm) — the totals
    // above stay the sum so existing consumers keep their meaning
    std::atomic<uint64_t> egress_link[kNumLinkClasses]{{0}, {0}, {0}};
    std::atomic<uint64_t> ingress_link[kNumLinkClasses]{{0}, {0}, {0}};
    // per-pair shm establishment failures that degraded to sockets
    // (kf_link_fallback_total): the degraded-transport mode is counted
    // and logged, never silent (docs/collectives.md)
    std::atomic<uint64_t> shm_fallback{0};

    void add_egress(LinkClass lc, uint64_t n) {
        egress += n;
        egress_link[int(lc)] += n;
    }
    void add_ingress(LinkClass lc, uint64_t n) {
        ingress += n;
        ingress_link[int(lc)] += n;
    }
};

// Connection pool: one persistent connection per (dest, type). Sends are
// serialized per connection; P2P request/response holds the connection lock
// across the round trip.
class Client {
  public:
    Client(PeerID self, Counters *counters)
        : self_(self), counters_(counters),
          shm_enabled_(shm_transport_enabled()) {}
    ~Client();

    void set_token(uint32_t token);
    // send framed message; establishes the connection on first use
    int send(const PeerID &dest, ConnType t, const std::string &name,
             uint32_t flags, const void *data, size_t len);
    // P2P RPC: request blob `name` (body = version string, may be empty)
    int request(const PeerID &dest, const std::string &version,
                const std::string &name, std::vector<uint8_t> *out);
    int ping(const PeerID &dest, int64_t *rtt_us);
    // Drop connections to peers outside `keep` and adopt the new token.
    void reset(const std::vector<PeerID> &keep, uint32_t token);

    int epoch_retries = 20;         // epoch-token mismatch budget (resize
                                    // convergence window), then fail fast
    int connect_retries = 120;      // x period = dial patience for peers
    int connect_retry_ms = 250;     // that are still starting up
    int reconnect_retries = 6;      // budget once a peer was reached and
                                    // lost: died mid-epoch => fail fast

  private:
    struct Conn {
        std::mutex mu;
        int fd = -1;
        bool was_connected = false;  // ever reached: lost => short retries
        LinkClass link = LinkClass::tcp;  // what dial_fd chose
    };
    // One shm channel per colocated destination: the ring plus its
    // hello/liveness socket. `abort` lets reset()/teardown unstick a
    // writer blocked on a full ring WITHOUT taking `mu` (the writer
    // holds it) — the shm analog of close(fd) kicking write_exact.
    struct ShmChan {
        std::mutex mu;
        int fd = -1;
        std::unique_ptr<ShmRing> ring;  // kf: guarded_by(mu)
        bool failed = false;   // establishment failed: socket fallback
        bool was_connected = false;  // ever established: lost => short
                                     // re-dial budget, fail fast
        std::atomic<bool> abort{false};
    };
    std::shared_ptr<Conn> get(const PeerID &dest, ConnType t);
    std::shared_ptr<ShmChan> get_shm(const PeerID &dest);
    int dial(const PeerID &dest, ConnType t,
             LinkClass *link = nullptr);   // returns fd or negative err
    int dial_fd(const PeerID &dest, LinkClass *link);  // raw connect
    int ensure_connected(Conn *c, const PeerID &dest, ConnType t);
    // Collective send over the shm ring; returns kShmFallback when the
    // channel cannot be (or was never) established — caller falls back
    // to the socket path for the rest of the epoch.
    static constexpr int kShmFallback = 1;
    int send_shm(const PeerID &dest, const std::string &name,
                 uint32_t flags, const void *data, size_t len);

    PeerID self_;
    Counters *counters_;
    std::mutex mu_;
    std::atomic<uint32_t> token_{0};
    bool shm_enabled_ = false;  // snapshot of KF_SHM at construction
    std::atomic<uint32_t> shm_seq_{0};  // unique ring paths per process
    std::unordered_map<uint64_t, std::shared_ptr<Conn>> conns_;
    std::unordered_map<uint64_t, std::shared_ptr<ShmChan>> shm_;
};

// ----------------------------------------------------------------- server

using ControlHandler =
    std::function<void(const std::string &name, const std::vector<uint8_t> &)>;
// Resolve a P2P request to blob bytes; returns KF_OK or KF_ERR_NOTFOUND.
using RequestHandler = std::function<int(
    const std::string &version, const std::string &name,
    std::vector<uint8_t> *out)>;

// Accept loop + one reader thread per connection. Collective messages land
// in the Rendezvous; P2P requests are answered inline on the same socket;
// Control messages invoke the handler; Pings echo.
class Server {
  public:
    Server(PeerID self, Rendezvous *rdv, Counters *counters)
        : self_(self), rdv_(rdv), counters_(counters) {}
    ~Server() { stop(); }

    int start();
    void stop();
    void set_token(uint32_t token) { token_ = token; }
    // Kick every live connection (used at epoch switch so stale-epoch
    // senders must re-handshake against the new token).
    void drop_connections();
    void set_control_handler(ControlHandler h);
    void set_request_handler(RequestHandler h);

  private:
    void accept_loop(int listen_fd, bool tcp);
    void serve_conn(int fd, LinkClass link);
    // Ring-reader loop of one inbound shm channel: attach the segment
    // named by the hello message, ack one byte, then parse framed
    // messages out of the ring into the Rendezvous until the producer
    // closes, the hello socket drops (sender death / epoch reset), or
    // the server stops.
    void serve_shm(int fd, const PeerID &src, bool same_epoch,
                   uint32_t epoch_token);

    PeerID self_;
    Rendezvous *rdv_;
    Counters *counters_;
    std::atomic<uint32_t> token_{0};
    std::atomic<bool> running_{false};
    int listen_fd_ = -1;
    int unix_fd_ = -1;  // colocated-peer listener (AF_UNIX)
    // self-pipe waking the poll-driven accept loops: shutdown(2) on a
    // LISTENING AF_UNIX socket is ENOTCONN on Linux and leaves a blocked
    // accept() blocked forever, so stop() must have a wakeup channel that
    // does not depend on socket semantics at all
    int wake_r_ = -1, wake_w_ = -1;
    std::string unix_path_;
    std::thread accept_thread_;
    std::thread unix_accept_thread_;
    std::mutex mu_;
    std::condition_variable conns_done_cv_;
    int active_conns_ = 0;
    ControlHandler control_handler_;
    RequestHandler request_handler_;
    std::unordered_set<int> live_fds_;
};

}  // namespace kf
