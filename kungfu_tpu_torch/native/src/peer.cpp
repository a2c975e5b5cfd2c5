#include "peer.hpp"

#include "../include/kf.h"

namespace kf {

Peer::Peer(PeerID self, std::vector<PeerID> peers, uint32_t version,
           Strategy strategy, int64_t timeout_ms_)
    : client(self, &counters),
      server(self, &rdv, &counters),
      timeout_ms(timeout_ms_),
      self_(self),
      peers_(std::move(peers)),
      version_(version),
      init_version_(version),
      strategy_(strategy) {
    server.set_request_handler([this](const std::string &version,
                                      const std::string &name,
                                      std::vector<uint8_t> *out) {
        if (version.empty()) return store.load(name, out);
        return vstore.load(version, name, out);
    });
}

int Peer::start() {
    if (running_) return KF_OK;
    server.set_token(version_);
    client.set_token(version_);
    int rc = server.start();
    if (rc != KF_OK) return rc;
    {
        std::unique_lock<std::shared_mutex> lk(session_mu_);
        session_ = std::make_unique<Session>(self_, peers_, strategy_,
                                             &client, &rdv, timeout_ms);
        if (!peers_.empty() && session_->rank() < 0) {
            KF_ERROR("self %s not in peer list", self_.str().c_str());
            return KF_ERR_ARG;
        }
    }
    running_ = true;
    return KF_OK;
}

int Peer::stop() {
    if (!running_) return KF_OK;
    running_ = false;
    server.stop();
    return KF_OK;
}

int Peer::update(std::vector<PeerID> peers, uint32_t version) {
    std::unique_lock<std::shared_mutex> lk(session_mu_);
    // token bump first: new dials from stale-epoch peers now get rejected,
    // and existing inbound connections are kicked so stale senders must
    // re-handshake against the new token
    server.set_token(version);
    server.drop_connections();
    client.reset(peers, version);
    rdv.clear();
    version_ = version;
    peers_ = std::move(peers);
    session_ = std::make_unique<Session>(self_, peers_, strategy_, &client,
                                         &rdv, timeout_ms);
    if (session_->rank() < 0) {
        KF_ERROR("self %s not in new peer list (epoch %u)",
                 self_.str().c_str(), version);
        return KF_ERR_ARG;
    }
    return KF_OK;
}

}  // namespace kf
