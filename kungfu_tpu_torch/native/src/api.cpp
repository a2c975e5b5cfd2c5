// C API over kf::Peer for ctypes consumers.
#include "../include/kf.h"

#include <cstring>
#include <shared_mutex>
#include <string>

#include "ordergroup.hpp"
#include "peer.hpp"
#include "trace.hpp"

using namespace kf;

struct kf_peer {
    Peer impl;
};

// Collectives hold the session under a *shared* lock: concurrent ops on
// distinct names must be able to interleave (serializing them here can
// cross-peer deadlock when two ranks issue ops in different thread order),
// while an elastic update() takes the lock exclusively to swap the session.
namespace {
template <typename F>
int with_session(kf_peer *p, F f) {
    if (!p) return KF_ERR_ARG;
    std::shared_lock<std::shared_mutex> lk(p->impl.session_mu());
    Session *s = p->impl.session();
    if (!s) return KF_ERR;  // before start()
    return f(s);
}
}  // namespace

extern "C" {

kf_peer *kf_peer_new(const char *self_spec, const char *peers,
                     uint32_t version, int strategy, int64_t timeout_ms) {
    PeerID self;
    std::vector<PeerID> peer_list;
    if (!self_spec || !parse_peer(self_spec, &self)) return nullptr;
    if (!parse_peer_list(peers ? peers : "", &peer_list)) return nullptr;
    if (strategy < 0 || strategy > int(Strategy::auto_select)) return nullptr;
    return new kf_peer{Peer(self, std::move(peer_list), version,
                            Strategy(strategy), timeout_ms)};
}

int kf_peer_start(kf_peer *p) { return p ? p->impl.start() : KF_ERR_ARG; }
int kf_peer_stop(kf_peer *p) { return p ? p->impl.stop() : KF_ERR_ARG; }

void kf_peer_free(kf_peer *p) {
    if (!p) return;
    p->impl.stop();
    delete p;
}

int kf_peer_update(kf_peer *p, const char *peers, uint32_t version) {
    if (!p) return KF_ERR_ARG;
    std::vector<PeerID> peer_list;
    if (!parse_peer_list(peers ? peers : "", &peer_list)) return KF_ERR_ARG;
    return p->impl.update(std::move(peer_list), version);
}

// introspection goes through with_session too: the session pointer is
// swapped by elastic updates, and these may be called from other threads
int kf_rank(kf_peer *p) {
    return with_session(p, [](Session *s) { return s->rank(); });
}
int kf_size(kf_peer *p) {
    return with_session(p, [](Session *s) { return s->size(); });
}
int kf_local_rank(kf_peer *p) {
    return with_session(p, [](Session *s) { return s->local_rank(); });
}
int kf_local_size(kf_peer *p) {
    return with_session(p, [](Session *s) { return s->local_size(); });
}
uint32_t kf_version(kf_peer *p) { return p->impl.version(); }
uint64_t kf_uid(kf_peer *p) { return p->impl.uid(); }

int kf_barrier(kf_peer *p) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [](Session *s) { return s->barrier(); });
}

int kf_all_reduce(kf_peer *p, const void *send, void *recv, int64_t count,
                  int dtype, int op, const char *name) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [&](Session *s) {
        return s->all_reduce(send, recv, count, Dtype(dtype), ROp(op), name);
    });
}

int kf_reduce(kf_peer *p, const void *send, void *recv, int64_t count,
              int dtype, int op, int root, const char *name) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [&](Session *s) {
        return s->reduce(send, recv, count, Dtype(dtype), ROp(op), root,
                         name);
    });
}

int kf_broadcast(kf_peer *p, const void *send, void *recv, int64_t count,
                 int dtype, int root, const char *name) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [&](Session *s) {
        return s->broadcast(send, recv, count, Dtype(dtype), root, name);
    });
}

int kf_gather(kf_peer *p, const void *send, int64_t count, void *recv,
              int64_t total_count, int dtype, int root, const char *name) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [&](Session *s) {
        return s->gather(send, count, recv, total_count, Dtype(dtype), root,
                         name);
    });
}

int kf_all_gather(kf_peer *p, const void *send, int64_t count, void *recv,
                  int dtype, const char *name) {
    TraceScope trace(Tracer::COLLECTIVE);
    return with_session(p, [&](Session *s) {
        return s->all_gather(send, count, recv, Dtype(dtype), name);
    });
}

int kf_consensus(kf_peer *p, const void *data, int64_t n, const char *name) {
    return with_session(
        p, [&](Session *s) { return s->consensus(data, n, name); });
}

int kf_save(kf_peer *p, const char *name, const void *data, int64_t n) {
    if (!p || !name) return KF_ERR_ARG;
    return p->impl.store.save(name, data, n);
}

int kf_save_version(kf_peer *p, const char *version, const char *name,
                    const void *data, int64_t n) {
    if (!p || !version || !name) return KF_ERR_ARG;
    return p->impl.vstore.save(version, name, data, n);
}

namespace {
int request_common(kf_peer *p, int rank, const char *version,
                   const char *name, void *out, int64_t n) {
    if (!p || !name || rank < 0) return KF_ERR_ARG;
    PeerID dest;
    {
        std::shared_lock<std::shared_mutex> lk(p->impl.session_mu());
        auto &peers = p->impl.session()->peers();
        if (rank >= int(peers.size())) return KF_ERR_ARG;
        dest = peers[size_t(rank)];
    }
    std::vector<uint8_t> blob;
    int rc = p->impl.client.request(dest, version ? version : "", name, &blob);
    if (rc != KF_OK) return rc;
    if (int64_t(blob.size()) != n) return KF_ERR_ARG;
    std::memcpy(out, blob.data(), blob.size());
    return KF_OK;
}
}  // namespace

int kf_request(kf_peer *p, int rank, const char *name, void *out, int64_t n) {
    return request_common(p, rank, "", name, out, n);
}

int kf_request_version(kf_peer *p, int rank, const char *version,
                       const char *name, void *out, int64_t n) {
    return request_common(p, rank, version, name, out, n);
}

int kf_set_control_handler(kf_peer *p, kf_control_cb cb, void *user) {
    if (!p) return KF_ERR_ARG;
    if (!cb) {
        p->impl.server.set_control_handler(nullptr);
        return KF_OK;
    }
    p->impl.server.set_control_handler(
        [cb, user](const std::string &name, const std::vector<uint8_t> &data) {
            cb(user, name.c_str(), data.data(), int64_t(data.size()));
        });
    return KF_OK;
}

int kf_send_control(kf_peer *p, const char *dest_spec, const char *name,
                    const void *data, int64_t n) {
    if (!p || !dest_spec || !name) return KF_ERR_ARG;
    PeerID dest;
    if (!parse_peer(dest_spec, &dest)) return KF_ERR_ARG;
    return p->impl.client.send(dest, ConnType::control, name, 0, data,
                               size_t(n));
}

int kf_ping(kf_peer *p, int rank, int64_t *rtt_us) {
    if (!p || rank < 0) return KF_ERR_ARG;
    PeerID dest;
    {
        std::shared_lock<std::shared_mutex> lk(p->impl.session_mu());
        auto &peers = p->impl.session()->peers();
        if (rank >= int(peers.size())) return KF_ERR_ARG;
        dest = peers[size_t(rank)];
    }
    return p->impl.client.ping(dest, rtt_us);
}

void kf_stats(kf_peer *p, uint64_t *egress_bytes, uint64_t *ingress_bytes) {
    if (!p) return;
    if (egress_bytes) *egress_bytes = p->impl.counters.egress.load();
    if (ingress_bytes) *ingress_bytes = p->impl.counters.ingress.load();
}

void kf_link_stats(kf_peer *p, uint64_t out[6]) {
    if (!p || !out) return;
    for (int i = 0; i < kNumLinkClasses; i++) {
        out[i] = p->impl.counters.egress_link[i].load();
        out[kNumLinkClasses + i] = p->impl.counters.ingress_link[i].load();
    }
}

uint64_t kf_shm_fallback_total(kf_peer *p) {
    return p ? p->impl.counters.shm_fallback.load() : 0;
}

int kf_hier(kf_peer *p) {
    return with_session(
        p, [](Session *s) { return s->hierarchical() ? 1 : 0; });
}

kf_order_group *kf_order_group_new(int n, const int *exec_order) {
    if (n < 0) return nullptr;
    std::vector<int> order;
    if (exec_order) order.assign(exec_order, exec_order + n);
    try {
        return reinterpret_cast<kf_order_group *>(
            new OrderGroup(n, std::move(order)));
    } catch (const std::exception &) {
        return nullptr;
    }
}

int kf_order_group_start(kf_order_group *g, int rank, kf_task_cb cb,
                         void *user) {
    if (!g || !cb) return KF_ERR_ARG;
    try {
        reinterpret_cast<OrderGroup *>(g)->start(rank,
                                                 [cb, user] { cb(user); });
    } catch (const std::exception &) {
        return KF_ERR_ARG;
    }
    return KF_OK;
}

int kf_order_group_wait(kf_order_group *g, int *arrival_out) {
    if (!g) return KF_ERR_ARG;
    auto *og = reinterpret_cast<OrderGroup *>(g);
    std::vector<int> order = og->wait();
    if (og->size() > 0 && order.empty())
        return KF_ERR;  // a concurrent wait() consumed this cycle's order
    if (arrival_out && !order.empty())
        std::memcpy(arrival_out, order.data(), order.size() * sizeof(int));
    return KF_OK;
}

void kf_order_group_free(kf_order_group *g) {
    delete reinterpret_cast<OrderGroup *>(g);
}

int kf_accumulate(void *dst, const void *src, int64_t count, int dtype,
                  int op, int force_scalar) {
    if (!dst || !src || count < 0 || dtype < 0 || dtype > int(Dtype::f64) ||
        op < 0 || op > int(ROp::sum_sat))
        return KF_ERR_ARG;
    if (force_scalar)
        reduce_accumulate_scalar(dst, src, count, Dtype(dtype), ROp(op));
    else
        reduce_accumulate(dst, src, count, Dtype(dtype), ROp(op));
    return KF_OK;
}

int kf_simd_enabled(int dtype) {
    if (dtype < 0 || dtype > int(Dtype::f64)) return 0;
    // probe with a zero-length call: dispatch happens before the loop
    uint8_t dummy[8] = {0};
    return reduce_accumulate_simd(dummy, dummy, 0, Dtype(dtype), ROp::sum)
               ? 1
               : 0;
}

int64_t kf_trace_report(char *buf, int64_t cap) {
    if (!buf || cap <= 0) return 0;
    return int64_t(Tracer::instance().report(buf, size_t(cap)));
}

void kf_trace_reset(void) { Tracer::instance().reset(); }

int kf_trace_enabled(void) { return Tracer::instance().enabled() ? 1 : 0; }

const char *kf_version_string(void) { return "libkf 0.1.1 (kungfu-tpu)"; }

}  // extern "C"
