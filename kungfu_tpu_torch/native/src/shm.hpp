// Shared-memory ring transport for colocated peers.
//
// A ShmRing is a single-producer single-consumer byte ring living in a
// mmap'd file under /dev/shm/kf-u<uid>/ (plain open(), not shm_open —
// this glibc keeps shm_open in librt, and a visible per-uid 0700
// directory mirrors the Unix-socket dir policy in transport.cpp). The
// sender streams the exact same framed messages it would write to a
// collective socket (u32 name_len, name, u32 flags, u32 len, body) into
// the ring; the receiver parses them out and feeds the Rendezvous, so
// payload bytes move source buffer -> ring -> registered destination
// buffer without ever entering the kernel socket stack (no serialize
// staging vector, no send/recv copies, no syscall per chunk).
//
// Synchronization is two monotonic cursors (head: bytes ever written,
// tail: bytes ever read) plus one futex word bumped by both sides after
// every cursor move. Waits are sliced (<= ~50 ms) so each side can
// re-check external liveness (peer death, epoch switch, server stop)
// without any shared lock a dying process could hold — there is nothing
// to die holding. Non-PRIVATE futex ops key on (inode, offset), so two
// mappings of the same file — even in one process, where every
// in-process test cluster lives — wake each other correctly.
//
// Lifecycle: the sender creates the file (O_CREAT|O_EXCL), hands the
// path to the receiver over its normal (already epoch-fenced) socket
// dial, and the receiver unlinks it right after mapping — from then on
// the segment lives exactly as long as the two mappings, so a SIGKILL
// on either side leaks nothing once attached.
#pragma once

#include <atomic>
#include <cstdint>
#include <functional>
#include <memory>
#include <string>

namespace kf {

struct ShmRingHdr {
    uint32_t magic = 0;
    uint32_t capacity = 0;                 // data bytes after the header
    std::atomic<uint64_t> head{0};         // producer cursor (bytes written)
    std::atomic<uint64_t> tail{0};         // consumer cursor (bytes read)
    std::atomic<uint32_t> seq{0};          // futex word: bumped on any move
    std::atomic<uint32_t> closed{0};       // producer teardown marker
};

class ShmRing {
  public:
    static constexpr uint32_t kMagic = 0x6b66726eu;  // "kfrn"
    static constexpr size_t kHdrBytes = 64;

    // Producer side: create `path` (O_CREAT|O_EXCL) with `capacity` data
    // bytes. nullptr if the file cannot be created/mapped.
    static std::unique_ptr<ShmRing> create(const std::string &path,
                                           uint32_t capacity);
    // Consumer side: map an existing segment. nullptr on any mismatch.
    static std::unique_ptr<ShmRing> attach(const std::string &path);
    ~ShmRing();
    ShmRing(const ShmRing &) = delete;
    ShmRing &operator=(const ShmRing &) = delete;

    const std::string &path() const { return path_; }
    uint32_t capacity() const { return h_->capacity; }

    // Producer: append exactly n bytes, blocking while the ring is full.
    // False if the consumer frees no space for stall_ms, if `alive`
    // (polled every wait slice) returns false, or if closed.
    bool write(const void *buf, size_t n, int64_t stall_ms,
               const std::function<bool()> &alive);
    // Consumer: pop exactly n bytes. False if the producer writes
    // nothing for stall_ms, if `alive` returns false, or if the
    // producer closed with fewer than n bytes left.
    bool read(void *buf, size_t n, int64_t stall_ms,
              const std::function<bool()> &alive);
    // Consumer idle wait: 1 = bytes readable, 0 = nothing within
    // wait_ms, -1 = producer closed and ring drained.
    int wait_readable(int wait_ms);
    // Producer: mark closed and wake the consumer (clean teardown).
    void close();
    // Remove the filesystem name (receiver calls right after attach;
    // the producer's destructor retries best-effort). Idempotent.
    void unlink();

  private:
    ShmRing() = default;
    size_t readable() const;
    size_t writable() const;
    // Sliced futex wait on seq while `cond` is false; false on
    // stall/abort. progress resets the stall clock inside write/read.
    ShmRingHdr *h_ = nullptr;
    uint8_t *data_ = nullptr;
    size_t map_len_ = 0;
    std::string path_;
    bool owner_ = false;     // creator: destructor closes + unlinks
    bool unlinked_ = false;
};

// Directory for this uid's ring segments (0700, owner-checked like the
// Unix-socket dir); empty string when /dev/shm is unusable.
std::string shm_dir();

// KF_SHM=0 opts the whole process out of the shm transport (colocated
// peers then keep the Unix-socket/TCP path). Read per call so tests can
// flip it between cluster constructions.
bool shm_transport_enabled();

// KF_SHM_REQUIRE=1 turns a would-be socket fallback for a colocated
// pair into a loud KF_ERR instead of silent degradation (benchmark
// runs must never quietly measure the wrong transport). Read per call.
bool shm_require();

// Remove stale ring debris under shm_dir(): a producer SIGKILLed
// between create() and the receiver's attach-unlink leaks its file
// (once attached, segments are anonymous and leak-free). Files older
// than max_age_s are from dead runs — live handshakes complete in
// milliseconds — and are unlinked at Server::start. KF_SHM_SWEEP=0
// opts out (read per call). Returns how many files were removed.
int shm_sweep_stale(int64_t max_age_s = 60);

}  // namespace kf
