// Session: immutable per-epoch collective engine over the transport.
// (Control-plane rebuild of reference srcs/go/kungfu/session.)
#pragma once

#include <functional>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <string>
#include <vector>

#include "core.hpp"
#include "transport.hpp"

namespace kf {

class Session {
  public:
    Session(PeerID self, std::vector<PeerID> peers, Strategy strategy,
            Client *client, Rendezvous *rdv, int64_t timeout_ms);

    int rank() const { return rank_; }
    int size() const { return int(peers_.size()); }
    int local_rank() const { return local_rank_; }
    int local_size() const { return local_size_; }
    const std::vector<PeerID> &peers() const { return peers_; }

    // KF_HIER=1 at construction: collectives walk hier(strategy)
    // graphs (intra-host -> masters -> intra-host; docs/collectives.md)
    bool hierarchical() const { return hier_; }
    Strategy strategy() const { return strategy_; }

    int all_reduce(const void *send, void *recv, int64_t count, Dtype dt,
                   ROp op, const std::string &name);
    int reduce(const void *send, void *recv, int64_t count, Dtype dt, ROp op,
               int root, const std::string &name);
    int broadcast(const void *send, void *recv, int64_t count, Dtype dt,
                  int root, const std::string &name);
    int gather(const void *send, int64_t count, void *recv,
               int64_t total_count, Dtype dt, int root,
               const std::string &name);
    int all_gather(const void *send, int64_t count, void *recv, Dtype dt,
                   const std::string &name);
    int barrier();
    // 1 = all peers agree on these bytes, 0 = divergent, <0 = error
    int consensus(const void *data, int64_t n, const std::string &name);

  private:
    // One chunk's reduce-then-broadcast walk over a (reduce, bcast) pair.
    int run_graphs(uint8_t *chunk, int64_t nbytes, Dtype dt, ROp op,
                   const Graph &rg, const Graph &bg, const std::string &name);
    int send_chunk(int dst_rank, const std::string &name, const uint8_t *data,
                   int64_t nbytes);
    // Split [0, total_bytes) into ~1MiB element-aligned chunks and run
    // fn(lo_bytes, n_bytes, chunk_name, name_hash) across the chunk thread
    // pool; every collective routes through this (reference:
    // session.go:263-292 runStrategies chunk split).
    int for_chunks(int64_t total_bytes, size_t esz, const std::string &name,
                   const std::function<int(int64_t, int64_t,
                                           const std::string &, uint64_t)>
                       &fn);
    // Rooted (reduce, bcast) pairs of the configured strategy for explicit-
    // root collectives; one per interior variant for chunk spreading.
    // Cached per root: graphs depend only on (strategy, peers, root).
    std::shared_ptr<const std::vector<GraphPair>> rooted_pairs(int root);

    PeerID self_;
    std::vector<PeerID> peers_;
    int rank_ = -1, local_rank_ = 0, local_size_ = 1;
    Strategy strategy_ = Strategy::star;  // post-AUTO-resolution
    bool hier_ = false;  // KF_HIER snapshot: graphs are hier(strategy_)
    std::vector<GraphPair> strategies_;
    std::mutex rooted_mu_;
    std::unordered_map<int, std::shared_ptr<const std::vector<GraphPair>>>
        rooted_cache_;
    Client *client_;
    Rendezvous *rdv_;
    int64_t timeout_ms_;
};

}  // namespace kf
