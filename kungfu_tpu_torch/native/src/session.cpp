#include "session.hpp"

#include <algorithm>
#include <cstring>
#include <thread>

#include "../include/kf.h"

namespace kf {

namespace {

constexpr int64_t kChunkBytes = 1 << 20;  // 1 MiB, like the reference
constexpr int kMaxChunkThreads = 16;

// Process-independent hash (std::hash is not stable across processes);
// every rank must pick the same strategy for the same chunk name.
uint64_t fnv1a(const std::string &s) {
    uint64_t h = 1469598103934665603ull;
    for (unsigned char c : s) {
        h ^= c;
        h *= 1099511628211ull;
    }
    return h;
}

}  // namespace

Session::Session(PeerID self, std::vector<PeerID> peers, Strategy strategy,
                 Client *client, Rendezvous *rdv, int64_t timeout_ms)
    : self_(self),
      peers_(std::move(peers)),
      client_(client),
      rdv_(rdv),
      timeout_ms_(timeout_ms) {
    local_rank_ = 0;
    local_size_ = 0;
    for (int i = 0; i < int(peers_.size()); i++) {
        if (peers_[i] == self_) rank_ = i;
        if (peers_[i].colocated_with(self_)) {
            if (rank_ < 0) local_rank_++;
            local_size_++;
        }
    }
    strategy_ = resolve_auto(strategy, peers_);
    // hierarchy is re-derived from the PeerList here on EVERY session
    // construction — i.e. on every epoch switch and recovery — so a
    // grow/shrink re-plans the whole intra/inter-host decomposition
    hier_ = hier_enabled();
    strategies_ = hier_ ? build_hierarchical(strategy_, peers_)
                        : build_strategy(strategy_, peers_);
}

std::shared_ptr<const std::vector<GraphPair>> Session::rooted_pairs(
    int root) {
    {
        std::lock_guard<std::mutex> lk(rooted_mu_);
        auto it = rooted_cache_.find(root);
        if (it != rooted_cache_.end()) return it->second;
    }
    const int nv = hier_ ? hier_rooted_variants(strategy_, peers_, root)
                         : rooted_variants(strategy_, peers_);
    auto pairs = std::make_shared<std::vector<GraphPair>>();
    pairs->reserve(size_t(nv));
    for (int v = 0; v < nv; v++)
        pairs->push_back(hier_
                             ? hier_rooted_pair(strategy_, peers_, root, v)
                             : rooted_pair(strategy_, peers_, root, v));
    std::lock_guard<std::mutex> lk(rooted_mu_);
    auto &entry = rooted_cache_[root];
    if (!entry) entry = std::move(pairs);
    return entry;
}

int Session::for_chunks(
    int64_t total_bytes, size_t esz, const std::string &name,
    const std::function<int(int64_t, int64_t, const std::string &, uint64_t)>
        &fn) {
    const int64_t elems_per_chunk =
        std::max<int64_t>(1, kChunkBytes / int64_t(esz));
    const int64_t bytes_per_chunk = elems_per_chunk * int64_t(esz);
    const int64_t n_chunks =
        std::max<int64_t>(1, (total_bytes + bytes_per_chunk - 1) /
                                 bytes_per_chunk);
    auto run_chunk = [&](int64_t ci) -> int {
        const int64_t lo = ci * bytes_per_chunk;
        const int64_t n = std::min(bytes_per_chunk, total_bytes - lo);
        const std::string chunk_name =
            n_chunks == 1
                ? name
                : name + "[" + std::to_string(lo / int64_t(esz)) + "]";
        return fn(lo, n, chunk_name, fnv1a(chunk_name));
    };
    if (n_chunks == 1) return run_chunk(0);
    std::vector<int> rcs(size_t(n_chunks), KF_OK);
    for (int64_t base = 0; base < n_chunks; base += kMaxChunkThreads) {
        const int64_t hi =
            std::min<int64_t>(base + kMaxChunkThreads, n_chunks);
        std::vector<std::thread> ts;
        for (int64_t ci = base; ci < hi; ci++)
            ts.emplace_back([&, ci] { rcs[size_t(ci)] = run_chunk(ci); });
        for (auto &t : ts) t.join();
    }
    for (int rc : rcs)
        if (rc != KF_OK) return rc;
    return KF_OK;
}

int Session::send_chunk(int dst_rank, const std::string &name,
                        const uint8_t *data, int64_t nbytes) {
    return client_->send(peers_[dst_rank], ConnType::collective, name, 0,
                         data, size_t(nbytes));
}

int Session::run_graphs(uint8_t *chunk, int64_t nbytes, Dtype dt, ROp op,
                        const Graph &rg, const Graph &bg,
                        const std::string &name) {
    const int64_t count = nbytes / int64_t(dtype_size(dt));
    // reduce phase: accumulate children (received in-place into a pooled
    // scratch by the socket reader), then forward partial to parent
    if (!rg.prev[rank_].empty()) {
        PooledBuf incoming{size_t(nbytes)};
        for (int prev : rg.prev[rank_]) {
            size_t len = 0;
            int rc = rdv_->pop_into(peers_[prev], name, incoming.data(),
                                    size_t(nbytes), &len, timeout_ms_);
            if (rc != KF_OK) return rc;
            if (int64_t(len) != nbytes) return KF_ERR;
            reduce_accumulate(chunk, incoming.data(), count, dt, op);
        }
    }
    for (int next : rg.next[rank_]) {
        int rc = send_chunk(next, name, chunk, nbytes);
        if (rc != KF_OK) return rc;
    }
    // broadcast phase: the finished value lands directly in `chunk`
    // (zero-copy registered receive), then fan out
    for (int prev : bg.prev[rank_]) {
        size_t len = 0;
        int rc = rdv_->pop_into(peers_[prev], name, chunk, size_t(nbytes),
                                &len, timeout_ms_);
        if (rc != KF_OK) return rc;
        if (int64_t(len) != nbytes) return KF_ERR;
    }
    for (int next : bg.next[rank_]) {
        int rc = send_chunk(next, name, chunk, nbytes);
        if (rc != KF_OK) return rc;
    }
    return KF_OK;
}

int Session::all_reduce(const void *send, void *recv, int64_t count, Dtype dt,
                        ROp op, const std::string &name) {
    const size_t esz = dtype_size(dt);
    const int64_t nbytes = count * int64_t(esz);
    if (recv != send) std::memcpy(recv, send, size_t(nbytes));
    if (peers_.size() <= 1) return KF_OK;
    // each ~1MiB chunk picks a strategy pair by stable name hash so
    // multi-graph strategies (ring, clique, multi-tree) spread chunks
    // across roots
    return for_chunks(
        nbytes, esz, name,
        [&](int64_t lo, int64_t n, const std::string &cname, uint64_t hash) {
            const auto &pair = strategies_[hash % strategies_.size()];
            return run_graphs((uint8_t *)recv + lo, n, dt, op, pair.first,
                              pair.second, cname);
        });
}

int Session::reduce(const void *send, void *recv, int64_t count, Dtype dt,
                    ROp op, int root, const std::string &name) {
    if (root < 0 || root >= size()) return KF_ERR_ARG;
    const size_t esz = dtype_size(dt);
    const int64_t nbytes = count * int64_t(esz);
    if (recv != send && rank_ == root)
        std::memcpy(recv, send, size_t(nbytes));
    if (peers_.size() <= 1) return KF_OK;
    // chunked walk of the configured strategy's reduce graphs re-rooted at
    // `root`; non-roots accumulate in a pooled scratch copy of their chunk
    const auto pairs = rooted_pairs(root);
    Graph no_bcast(size());
    return for_chunks(
        nbytes, esz, name,
        [&](int64_t lo, int64_t n, const std::string &cname, uint64_t hash) {
            const auto &rg = (*pairs)[hash % pairs->size()].first;
            if (rank_ == root)
                return run_graphs((uint8_t *)recv + lo, n, dt, op, rg,
                                  no_bcast, cname);
            PooledBuf scratch{size_t(n)};
            std::memcpy(scratch.data(), (const uint8_t *)send + lo,
                        size_t(n));
            return run_graphs(scratch.data(), n, dt, op, rg, no_bcast,
                              cname);
        });
}

int Session::broadcast(const void *send, void *recv, int64_t count, Dtype dt,
                       int root, const std::string &name) {
    if (root < 0 || root >= size()) return KF_ERR_ARG;
    const size_t esz = dtype_size(dt);
    const int64_t nbytes = count * int64_t(esz);
    if (recv != send && rank_ == root)
        std::memcpy(recv, send, size_t(nbytes));
    if (peers_.size() <= 1) {
        if (recv != send) std::memcpy(recv, send, size_t(nbytes));
        return KF_OK;
    }
    // chunked walk of the configured strategy's bcast graphs re-rooted at
    // `root`; chunk spreading rotates the tree interior so no single relay
    // carries the whole model (elastic joiner resync rides this path)
    const auto pairs = rooted_pairs(root);
    Graph no_reduce(size());
    return for_chunks(
        nbytes, esz, name,
        [&](int64_t lo, int64_t n, const std::string &cname, uint64_t hash) {
            const auto &bg = (*pairs)[hash % pairs->size()].second;
            return run_graphs((uint8_t *)recv + lo, n, dt, ROp::sum,
                              no_reduce, bg, cname);
        });
}

int Session::gather(const void *send, int64_t count, void *recv,
                    int64_t total_count, Dtype dt, int root,
                    const std::string &name) {
    if (root < 0 || root >= size()) return KF_ERR_ARG;
    const size_t esz = dtype_size(dt);
    const int64_t nbytes = count * int64_t(esz);
    if (rank_ != root) {
        // chunked so a large shard streams instead of one monolithic
        // message (reference routes everything through the chunk split,
        // session.go:263-292)
        return for_chunks(
            nbytes, esz, name,
            [&](int64_t lo, int64_t n, const std::string &cname, uint64_t) {
                return send_chunk(root, cname, (const uint8_t *)send + lo,
                                  n);
            });
    }
    if (total_count < count * int64_t(size())) return KF_ERR_ARG;
    std::memcpy((uint8_t *)recv + int64_t(rank_) * nbytes, send,
                size_t(nbytes));
    for (int r = 0; r < size(); r++) {
        if (r == rank_) continue;
        uint8_t *base = (uint8_t *)recv + int64_t(r) * nbytes;
        // registered receive: each chunk lands in its recv slice in-place
        int rc = for_chunks(
            nbytes, esz, name,
            [&](int64_t lo, int64_t n, const std::string &cname,
                uint64_t) -> int {
                size_t len = 0;
                int prc = rdv_->pop_into(peers_[r], cname, base + lo,
                                         size_t(n), &len, timeout_ms_);
                if (prc != KF_OK) return prc;
                return int64_t(len) == n ? KF_OK : KF_ERR;
            });
        if (rc != KF_OK) return rc;
    }
    return KF_OK;
}

int Session::all_gather(const void *send, int64_t count, void *recv, Dtype dt,
                        const std::string &name) {
    const size_t esz = dtype_size(dt);
    const int64_t nbytes = count * int64_t(esz);
    std::memcpy((uint8_t *)recv + int64_t(rank_) * nbytes, send,
                size_t(nbytes));
    if (peers_.size() <= 1) return KF_OK;
    // direct mesh, chunked: everyone streams its shard to everyone
    // (reference: srcs/go/kungfu/session/allgather.go), receives land
    // in-place in the recv slice
    for (int r = 0; r < size(); r++) {
        if (r == rank_) continue;
        int rc = for_chunks(
            nbytes, esz, name,
            [&](int64_t lo, int64_t n, const std::string &cname, uint64_t) {
                return send_chunk(r, cname, (const uint8_t *)send + lo, n);
            });
        if (rc != KF_OK) return rc;
    }
    for (int r = 0; r < size(); r++) {
        if (r == rank_) continue;
        uint8_t *base = (uint8_t *)recv + int64_t(r) * nbytes;
        int rc = for_chunks(
            nbytes, esz, name,
            [&](int64_t lo, int64_t n, const std::string &cname,
                uint64_t) -> int {
                size_t len = 0;
                int prc = rdv_->pop_into(peers_[r], cname, base + lo,
                                         size_t(n), &len, timeout_ms_);
                if (prc != KF_OK) return prc;
                return int64_t(len) == n ? KF_OK : KF_ERR;
            });
        if (rc != KF_OK) return rc;
    }
    return KF_OK;
}

int Session::barrier() {
    uint8_t x = 0, y = 0;
    return all_reduce(&x, &y, 1, Dtype::u8, ROp::sum, "kf::barrier");
}

int Session::consensus(const void *data, int64_t n, const std::string &name) {
    // leaderless value agreement via paired MIN/MAX all-reduces: first on
    // the length, then on the bytes (reference: session.go:105-136)
    uint64_t len = uint64_t(n), lo = 0, hi = 0;
    int rc = all_reduce(&len, &lo, 1, Dtype::u64, ROp::min, name + ":len:min");
    if (rc != KF_OK) return rc;
    rc = all_reduce(&len, &hi, 1, Dtype::u64, ROp::max, name + ":len:max");
    if (rc != KF_OK) return rc;
    if (lo != hi) return 0;
    if (n == 0) return 1;
    std::vector<uint8_t> mn(static_cast<size_t>(n));
    std::vector<uint8_t> mx(static_cast<size_t>(n));
    rc = all_reduce(data, mn.data(), n, Dtype::u8, ROp::min, name + ":min");
    if (rc != KF_OK) return rc;
    rc = all_reduce(data, mx.data(), n, Dtype::u8, ROp::max, name + ":max");
    if (rc != KF_OK) return rc;
    return mn == mx ? 1 : 0;
}

}  // namespace kf
