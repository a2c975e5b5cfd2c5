// Scoped tracing for libkf hot paths (send/recv-wait/accumulate/...).
//
// The reference wraps hot calls in TRACE_SCOPE macros that log per-scope
// wall time (reference: srcs/cpp/include/kungfu/utils/trace.hpp:1-16,
// enabled by KUNGFU_CONFIG_ENABLE_TRACE). Here scopes accumulate into
// lock-free per-scope counters (count / total us / max us) instead of
// logging per event — hot paths run millions of times, so the artifact
// is a profile, not a log — and the table is exported through
// kf_trace_report() into the /metrics endpoint.
//
// Enabled by KF_TRACE=1 (checked once at first use). Disabled cost: one
// predictable branch per scope.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace kf {

class Tracer {
  public:
    // Fixed scope table: hot paths index by enum, no hashing on the path.
    enum Scope {
        SEND = 0,      // Client::send full write (incl. serialization)
        DIAL,          // connection establishment
        RECV_WAIT,     // Rendezvous::pop_into block time
        ACCUMULATE,    // reduce-kernel time (SIMD/scalar)
        COLLECTIVE,    // whole Session collective call
        N_SCOPES,
    };

    static Tracer &instance() {
        static Tracer t;
        return t;
    }

    bool enabled() const { return enabled_; }

    void record(Scope s, uint64_t us) {
        auto &c = cells_[s];
        c.count.fetch_add(1, std::memory_order_relaxed);
        c.total_us.fetch_add(us, std::memory_order_relaxed);
        uint64_t prev = c.max_us.load(std::memory_order_relaxed);
        while (us > prev &&
               !c.max_us.compare_exchange_weak(prev, us,
                                               std::memory_order_relaxed)) {
        }
    }

    // "scope count total_us max_us\n" per active scope; returns bytes
    // written (excluding the NUL), truncating at cap-1.
    size_t report(char *buf, size_t cap) const {
        static const char *names[N_SCOPES] = {
            "send", "dial", "recv_wait", "accumulate", "collective"};
        std::string out;
        for (int s = 0; s < N_SCOPES; s++) {
            const uint64_t n = cells_[s].count.load();
            if (!n) continue;
            out += names[s];
            out += ' ';
            out += std::to_string(n);
            out += ' ';
            out += std::to_string(cells_[s].total_us.load());
            out += ' ';
            out += std::to_string(cells_[s].max_us.load());
            out += '\n';
        }
        if (cap == 0) return 0;
        const size_t n = out.size() < cap - 1 ? out.size() : cap - 1;
        std::memcpy(buf, out.data(), n);
        buf[n] = '\0';
        return n;
    }

    void reset() {
        for (auto &c : cells_) {
            c.count = 0;
            c.total_us = 0;
            c.max_us = 0;
        }
    }

  private:
    Tracer() {
        const char *e = std::getenv("KF_TRACE");
        enabled_ = e && *e && std::strcmp(e, "0") != 0;
    }

    struct Cell {
        std::atomic<uint64_t> count{0}, total_us{0}, max_us{0};
    };
    Cell cells_[N_SCOPES];
    bool enabled_ = false;
};

// RAII scope timer; ~free when tracing is off.
class TraceScope {
  public:
    explicit TraceScope(Tracer::Scope s) : scope_(s) {
        if (Tracer::instance().enabled())
            t0_ = std::chrono::steady_clock::now().time_since_epoch().count();
    }
    ~TraceScope() {
        if (t0_) {
            const uint64_t us =
                (std::chrono::steady_clock::now().time_since_epoch().count() -
                 t0_) /
                1000;
            Tracer::instance().record(scope_, us);
        }
    }
    TraceScope(const TraceScope &) = delete;
    TraceScope &operator=(const TraceScope &) = delete;

  private:
    Tracer::Scope scope_;
    int64_t t0_ = 0;
};

}  // namespace kf
