// In-process multi-peer smoke test for libkf — and the TSAN vehicle.
//
// The reference ships an in-proc fake trainer for its C++ integration
// testing (reference: tests/cpp/, scripts/tests/run-integration-tests.sh);
// SURVEY §5.2 notes the rebuild should add race detection, which the
// reference never had. This driver runs a 4-peer loopback cluster from
// one process — concurrent named collectives, epoch switch, store ops —
// so `make tsan-test` puts every lock in transport/session/peer under
// ThreadSanitizer. Exit 0 = all assertions held (and, under TSAN, no
// races reported; TSAN exits non-zero itself otherwise).

#include <atomic>
#include <cassert>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "../include/kf.h"
#include "peer.hpp"

using namespace kf;

namespace {

constexpr int NP = 4;

uint16_t base_port() {
    // overridable so concurrent runs on one host don't collide
    static const uint16_t p = [] {
        const char *e = std::getenv("KF_SMOKE_BASE_PORT");
        return uint16_t(e ? std::atoi(e) : 25800);
    }();
    return p;
}

PeerID make_id(int rank) {
    PeerID p;
    p.ipv4 = (127u << 24) | 1u;  // 127.0.0.1
    p.port = uint16_t(base_port() + rank);
    return p;
}

std::vector<PeerID> make_peers(int np) {
    std::vector<PeerID> out;
    for (int r = 0; r < np; r++) out.push_back(make_id(r));
    return out;
}

void run_rank(Peer *p, int rank, std::atomic<int> *failures) {
    std::vector<float> buf(1027, float(rank + 1));
    std::vector<float> out(1027);

    // concurrent named all-reduces from every rank
    for (int round = 0; round < 5; round++) {
        char name[32];
        std::snprintf(name, sizeof(name), "ar:%d", round);
        int rc;
        {
            std::shared_lock<std::shared_mutex> lk(p->session_mu());
            rc = p->session()->all_reduce(buf.data(), out.data(),
                                          int64_t(buf.size()), Dtype::f32,
                                          ROp::sum, name);
        }
        if (rc != 0 || out[0] != float(NP * (NP + 1) / 2)) {
            std::fprintf(stderr, "rank %d round %d: rc=%d out=%f\n", rank,
                         round, rc, double(out[0]));
            ++*failures;
            return;
        }
    }

    // broadcast from a non-zero root
    std::vector<int32_t> bcast(33, rank == 2 ? 7 : 0);
    {
        std::shared_lock<std::shared_mutex> lk(p->session_mu());
        int rc = p->session()->broadcast(bcast.data(), bcast.data(),
                                         int64_t(bcast.size()), Dtype::i32,
                                         2, "bc");
        if (rc != 0 || bcast[32] != 7) {
            std::fprintf(stderr, "rank %d bcast rc=%d v=%d\n", rank, rc,
                         int(bcast[32]));
            ++*failures;
            return;
        }
    }

    // compressed-gradient wire round: per-bucket scale negotiation
    // (f32 max) followed by a saturating int8 payload sum — the
    // bucketed grad-pipeline protocol, under the sanitizers. Values
    // chosen so lane 0 saturates (+127 clamp) and lane 1 does not.
    for (int b = 0; b < 3; b++) {
        char sname[32], qname[32];
        std::snprintf(sname, sizeof(sname), "gb:%d:s", b);
        std::snprintf(qname, sizeof(qname), "gb:%d:q", b);
        float amax = float(rank + 1), amax_out = 0;
        std::vector<int8_t> q(257, int8_t(100));
        q[1] = int8_t(rank - 2);
        std::shared_lock<std::shared_mutex> lk(p->session_mu());
        int rc = p->session()->all_reduce(&amax, &amax_out, 1, Dtype::f32,
                                          ROp::max, sname);
        int rc2 = p->session()->all_reduce(q.data(), q.data(),
                                           int64_t(q.size()), Dtype::i8,
                                           ROp::sum_sat, qname);
        int sum1 = 0;
        for (int r = 0; r < NP; r++) sum1 += r - 2;
        if (rc != 0 || rc2 != 0 || amax_out != float(NP) || q[0] != 127 ||
            q[1] != int8_t(sum1)) {
            std::fprintf(stderr, "rank %d gb:%d rc=%d/%d amax=%f q0=%d\n",
                         rank, b, rc, rc2, double(amax_out), int(q[0]));
            ++*failures;
            return;
        }
    }

    // store save + barrier
    p->store.save("blob", buf.data(), 16);
    {
        std::shared_lock<std::shared_mutex> lk(p->session_mu());
        if (p->session()->barrier() != 0) {
            ++*failures;
            return;
        }
    }
}

}  // namespace

int main() {
    auto peers = make_peers(NP);
    std::vector<std::unique_ptr<Peer>> ps;
    for (int r = 0; r < NP; r++)
        ps.push_back(std::make_unique<Peer>(peers[r], peers, 0,
                                            Strategy::ring, 20000));
    for (auto &p : ps)
        if (p->start() != 0) {
            std::fprintf(stderr, "start failed\n");
            return 1;
        }

    std::atomic<int> failures{0};
    {
        std::vector<std::thread> ts;
        for (int r = 0; r < NP; r++)
            ts.emplace_back(run_rank, ps[r].get(), r, &failures);
        for (auto &t : ts) t.join();
    }
    if (failures) return 1;

    // epoch switch: shrink to 2 peers, old-epoch fencing under TSAN
    std::vector<PeerID> two{peers[0], peers[1]};
    for (int r = 0; r < 2; r++)
        if (ps[r]->update(two, 1) != 0) {
            std::fprintf(stderr, "update failed\n");
            return 1;
        }
    {
        std::vector<std::thread> ts;
        for (int r = 0; r < 2; r++)
            ts.emplace_back([&, r] {
                std::vector<double> b(64, double(r + 1)), o(64);
                std::shared_lock<std::shared_mutex> lk(
                    ps[r]->session_mu());
                int rc = ps[r]->session()->all_reduce(
                    b.data(), o.data(), 64, Dtype::f64, ROp::sum, "e1");
                if (rc != 0 || o[0] != 3.0) failures++;
            });
        for (auto &t : ts) t.join();
    }
    if (failures) return 1;

    // the 127.0.0.1 cluster above ran its whole collective load over
    // the shm rings (colocated peers, KF_SHM default-on): assert the
    // bytes actually moved off the socket stack
    {
        const uint64_t shm_eg =
            ps[0]->counters.egress_link[int(LinkClass::shm)].load();
        const uint64_t total = ps[0]->counters.egress.load();
        if (shm_transport_enabled() && shm_eg == 0) {
            std::fprintf(stderr, "no shm egress on a colocated cluster\n");
            return 1;
        }
        uint64_t sum = 0;
        for (int i = 0; i < kNumLinkClasses; i++)
            sum += ps[0]->counters.egress_link[i].load();
        if (sum != total) {
            std::fprintf(stderr, "link-class egress %llu != total %llu\n",
                         (unsigned long long)sum,
                         (unsigned long long)total);
            return 1;
        }
    }

    for (auto &p : ps) p->stop();

    // hierarchical round: 2 simulated hosts (127.0.0.1 + 127.0.0.2,
    // both loopback) x 2 peers under KF_HIER=1 — intra-host stage over
    // shm rings, inter-host ring over the masters; results must match
    // the flat formula exactly (integer-valued floats: association-
    // free), exercising the composed graphs under every sanitizer
    ::setenv("KF_HIER", "1", 1);
    std::vector<PeerID> hpeers;
    for (int r = 0; r < NP; r++) {
        PeerID p;
        p.ipv4 = (127u << 24) | (r < NP / 2 ? 1u : 2u);
        p.port = uint16_t(base_port() + 8 + r);
        hpeers.push_back(p);
    }
    std::vector<std::unique_ptr<Peer>> hs;
    for (int r = 0; r < NP; r++)
        hs.push_back(std::make_unique<Peer>(hpeers[r], hpeers, 0,
                                            Strategy::ring, 20000));
    for (auto &p : hs)
        if (p->start() != 0) {
            std::fprintf(stderr, "hier start failed\n");
            return 1;
        }
    {
        std::vector<std::thread> ts;
        for (int r = 0; r < NP; r++)
            ts.emplace_back([&, r] {
                std::vector<float> b(2053, float(r + 1)), o(2053);
                std::shared_lock<std::shared_mutex> lk(hs[r]->session_mu());
                if (!hs[r]->session()->hierarchical()) {
                    std::fprintf(stderr, "rank %d: session not hier\n", r);
                    failures++;
                    return;
                }
                int rc = hs[r]->session()->all_reduce(
                    b.data(), o.data(), int64_t(b.size()), Dtype::f32,
                    ROp::sum, "hier:ar");
                if (rc != 0 || o[2052] != float(NP * (NP + 1) / 2)) {
                    std::fprintf(stderr, "hier rank %d rc=%d out=%f\n", r,
                                 rc, double(o[2052]));
                    failures++;
                    return;
                }
                // rooted collective over the hier graphs too
                std::vector<int64_t> bc(17, r == 3 ? 42 : 0);
                rc = hs[r]->session()->broadcast(bc.data(), bc.data(),
                                                 17, Dtype::i64, 3,
                                                 "hier:bc");
                if (rc != 0 || bc[16] != 42) {
                    std::fprintf(stderr, "hier bcast rank %d rc=%d\n", r,
                                 rc);
                    failures++;
                }
            });
        for (auto &t : ts) t.join();
    }
    ::unsetenv("KF_HIER");
    if (failures) return 1;
    if (shm_transport_enabled() &&
        hs[1]->counters.egress_link[int(LinkClass::shm)].load() == 0) {
        // rank 1 is a leaf: its reduce contribution goes to its
        // colocated master and must ride the ring
        std::fprintf(stderr, "hier leaf sent no shm bytes\n");
        return 1;
    }
    for (auto &p : hs) p->stop();

    // torn-frame integrity round: arm the one-shot corruption
    // injection, run a colocated all-reduce over the rings — the
    // receiver must detect the header-checksum mismatch and fail with
    // KF_ERR_CORRUPT, NEVER return a wrong sum; an epoch switch then
    // heals the transport (fresh rings under the new token). This is
    // the sanitize.sh coverage of the torn-frame path end to end.
    if (shm_transport_enabled()) {
        std::vector<PeerID> cp;
        for (int r = 0; r < 2; r++) {
            PeerID p;
            p.ipv4 = (127u << 24) | 1u;
            p.port = uint16_t(base_port() + 12 + r);
            cp.push_back(p);
        }
        std::vector<std::unique_ptr<Peer>> cs;
        for (int r = 0; r < 2; r++)
            cs.push_back(std::make_unique<Peer>(cp[r], cp, 0,
                                                Strategy::star, 4000));
        for (auto &p : cs)
            if (p->start() != 0) {
                std::fprintf(stderr, "corrupt-round start failed\n");
                return 1;
            }
        ::setenv("KF_SHM_INJECT_CORRUPT", "1", 1);
        int rcs[2] = {0, 0};
        double outs[2] = {0, 0};
        {
            std::vector<std::thread> ts;
            for (int r = 0; r < 2; r++)
                ts.emplace_back([&, r] {
                    std::vector<double> b(63, double(r + 1)), o(63);
                    std::shared_lock<std::shared_mutex> lk(
                        cs[r]->session_mu());
                    rcs[r] = cs[r]->session()->all_reduce(
                        b.data(), o.data(), 63, Dtype::f64, ROp::sum,
                        "corrupt");
                    outs[r] = o[0];
                });
            for (auto &t : ts) t.join();
        }
        ::unsetenv("KF_SHM_INJECT_CORRUPT");
        // rank 0 (STAR root) receives the corrupted reduce frame and
        // must see the integrity failure as itself; nobody may hold a
        // wrong sum
        if (rcs[0] != KF_ERR_CORRUPT) {
            std::fprintf(stderr,
                         "corrupt frame not detected: rc0=%d rc1=%d\n",
                         rcs[0], rcs[1]);
            return 1;
        }
        for (int r = 0; r < 2; r++)
            if (rcs[r] == 0 && outs[r] != 3.0) {
                std::fprintf(stderr, "corrupt frame fed a wrong sum: "
                                     "rank %d out=%f\n",
                             r, outs[r]);
                return 1;
            }
        // epoch switch re-establishes clean rings: sums exact again
        for (int r = 0; r < 2; r++)
            if (cs[r]->update(cp, 1) != 0) {
                std::fprintf(stderr, "corrupt-round update failed\n");
                return 1;
            }
        {
            std::vector<std::thread> ts;
            for (int r = 0; r < 2; r++)
                ts.emplace_back([&, r] {
                    std::vector<double> b(63, double(r + 1)), o(63);
                    std::shared_lock<std::shared_mutex> lk(
                        cs[r]->session_mu());
                    int rc = cs[r]->session()->all_reduce(
                        b.data(), o.data(), 63, Dtype::f64, ROp::sum,
                        "healed");
                    if (rc != 0 || o[0] != 3.0) failures++;
                });
            for (auto &t : ts) t.join();
        }
        if (failures) {
            std::fprintf(stderr, "post-corruption epoch did not heal\n");
            return 1;
        }
        for (auto &p : cs) p->stop();
    }

    // degraded-transport round: the receiver refuses to map rings
    // (the deterministic /dev/shm-ENOSPC stand-in); the pair must fall
    // back to sockets pre-payload (sums stay exact), the fallback must
    // be COUNTED, and no byte may claim the shm link class.
    if (shm_transport_enabled()) {
        ::setenv("KF_SHM_INJECT_ATTACH_FAIL", "1", 1);
        std::vector<PeerID> fp;
        for (int r = 0; r < 2; r++) {
            PeerID p;
            p.ipv4 = (127u << 24) | 1u;
            p.port = uint16_t(base_port() + 14 + r);
            fp.push_back(p);
        }
        std::vector<std::unique_ptr<Peer>> fs;
        for (int r = 0; r < 2; r++)
            fs.push_back(std::make_unique<Peer>(fp[r], fp, 0,
                                                Strategy::star, 20000));
        for (auto &p : fs)
            if (p->start() != 0) {
                std::fprintf(stderr, "fallback-round start failed\n");
                return 1;
            }
        {
            std::vector<std::thread> ts;
            for (int r = 0; r < 2; r++)
                ts.emplace_back([&, r] {
                    std::vector<float> b(501, float(r + 1)), o(501);
                    std::shared_lock<std::shared_mutex> lk(
                        fs[r]->session_mu());
                    int rc = fs[r]->session()->all_reduce(
                        b.data(), o.data(), 501, Dtype::f32, ROp::sum,
                        "fb");
                    if (rc != 0 || o[500] != 3.0f) failures++;
                });
            for (auto &t : ts) t.join();
        }
        ::unsetenv("KF_SHM_INJECT_ATTACH_FAIL");
        if (failures) {
            std::fprintf(stderr, "degraded fallback broke the sum\n");
            return 1;
        }
        uint64_t fallbacks = 0, shm_eg = 0;
        for (auto &p : fs) {
            fallbacks += p->counters.shm_fallback.load();
            shm_eg += p->counters.egress_link[int(LinkClass::shm)].load();
        }
        if (fallbacks == 0 || shm_eg != 0) {
            std::fprintf(stderr,
                         "fallback not counted (%llu) or shm bytes "
                         "leaked (%llu)\n",
                         (unsigned long long)fallbacks,
                         (unsigned long long)shm_eg);
            return 1;
        }
        for (auto &p : fs) p->stop();
    }
    std::printf("smoke ok\n");
    return 0;
}
