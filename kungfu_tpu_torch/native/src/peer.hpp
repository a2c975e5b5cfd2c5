// Peer: process-level control-plane endpoint with epoch-fenced sessions.
// (Control-plane rebuild of reference srcs/go/kungfu/peer/peer.go.)
#pragma once

#include <memory>
#include <mutex>
#include <shared_mutex>

#include "session.hpp"
#include "transport.hpp"

namespace kf {

class Peer {
  public:
    Peer(PeerID self, std::vector<PeerID> peers, uint32_t version,
         Strategy strategy, int64_t timeout_ms);

    int start();
    int stop();
    // Adopt a new membership epoch: fence old collective connections via the
    // token, drop links to departed peers, rebuild the session.
    int update(std::vector<PeerID> peers, uint32_t version);

    Session *session() { return session_.get(); }
    std::shared_mutex &session_mu() { return session_mu_; }
    uint32_t version() const { return version_; }
    uint64_t uid() const {
        return (uint64_t(self_.ipv4) << 32) | (uint64_t(self_.port) << 16) |
               (init_version_ & 0xFFFF);
    }
    PeerID self() const { return self_; }

    Store store;
    VersionedStore vstore;
    Counters counters;
    Client client;
    Server server;
    Rendezvous rdv;
    int64_t timeout_ms;

  private:
    PeerID self_;
    std::vector<PeerID> peers_;
    uint32_t version_;
    uint32_t init_version_;
    Strategy strategy_;
    bool running_ = false;
    std::shared_mutex session_mu_;
    std::unique_ptr<Session> session_;
};

}  // namespace kf
