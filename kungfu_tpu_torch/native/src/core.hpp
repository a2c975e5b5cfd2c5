// Core value types for libkf: dtypes + reduce kernels, peer identity,
// communication graphs and topology builders, logging.
// (Control-plane rebuild of reference srcs/go/kungfu/base + srcs/go/plan.)
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace kf {

// ---------------------------------------------------------------- logging

enum class LogLevel { debug = 0, info = 1, warn = 2, error = 3 };
LogLevel log_level();
void log_at(LogLevel lvl, const char *fmt, ...)
    __attribute__((format(printf, 2, 3)));
#define KF_DEBUG(...) ::kf::log_at(::kf::LogLevel::debug, __VA_ARGS__)
#define KF_INFO(...) ::kf::log_at(::kf::LogLevel::info, __VA_ARGS__)
#define KF_WARN(...) ::kf::log_at(::kf::LogLevel::warn, __VA_ARGS__)
#define KF_ERROR(...) ::kf::log_at(::kf::LogLevel::error, __VA_ARGS__)

// ----------------------------------------------------------------- dtypes

enum class Dtype : int {
    u8 = 0,
    i8 = 1,
    u16 = 2,
    i16 = 3,
    u32 = 4,
    i32 = 5,
    u64 = 6,
    i64 = 7,
    f16 = 8,
    bf16 = 9,
    f32 = 10,
    f64 = 11,
};

enum class ROp : int { sum = 0, min = 1, max = 2, prod = 3, sum_sat = 4 };

size_t dtype_size(Dtype dt);

// dst[i] = dst[i] (op) src[i]; f16/bf16 accumulate in f32. Dispatches to
// AVX2/F16C kernels when the CPU supports them (KF_NO_SIMD=1 forces the
// portable path); SIMD and portable results are bit-identical.
void reduce_accumulate(void *dst, const void *src, int64_t count, Dtype dt,
                       ROp op);
// Portable scalar path, exported so tests/microbenchmarks can compare.
void reduce_accumulate_scalar(void *dst, const void *src, int64_t count,
                              Dtype dt, ROp op);
// True when an AVX2/F16C kernel handled the call; false = caller must run
// the portable loop (non-x86 builds always return false).
bool reduce_accumulate_simd(void *dst, const void *src, int64_t count,
                            Dtype dt, ROp op);

// ------------------------------------------------------------------ peers

struct PeerID {
    uint32_t ipv4 = 0;
    uint16_t port = 0;

    bool operator==(const PeerID &o) const {
        return ipv4 == o.ipv4 && port == o.port;
    }
    bool operator!=(const PeerID &o) const { return !(*this == o); }
    bool colocated_with(const PeerID &o) const { return ipv4 == o.ipv4; }
    std::string str() const;
    uint64_t key() const { return (uint64_t(ipv4) << 16) | port; }
};

// "a.b.c.d:port" -> PeerID; returns false on malformed input
bool parse_peer(const std::string &s, PeerID *out);
// comma-separated list
bool parse_peer_list(const std::string &s, std::vector<PeerID> *out);

struct PeerIDHash {
    size_t operator()(const PeerID &p) const {
        return std::hash<uint64_t>()(p.key());
    }
};

// ------------------------------------------------------------------ graph

struct Graph {
    int n = 0;
    std::vector<std::vector<int>> next, prev;
    std::vector<bool> self_loop;

    explicit Graph(int n_) : n(n_), next(n_), prev(n_), self_loop(n_, false) {}
    void add_edge(int i, int j) {
        if (i == j) {
            self_loop[i] = true;
            return;
        }
        next[i].push_back(j);
        prev[j].push_back(i);
    }
    Graph reverse() const {
        Graph g(n);
        g.self_loop = self_loop;
        for (int i = 0; i < n; i++)
            for (int j : next[i]) g.add_edge(j, i);
        return g;
    }
};

enum class Strategy : int {
    star = 0,
    ring = 1,
    clique = 2,
    tree = 3,
    binary_tree = 4,
    binary_tree_star = 5,
    multi_binary_tree_star = 6,
    auto_select = 7,
};

// A strategy instance is a list of (reduce, bcast) graph pairs; chunked
// traffic round-robins across pairs for multi-path load balancing.
using GraphPair = std::pair<Graph, Graph>;
std::vector<GraphPair> build_strategy(Strategy s,
                                      const std::vector<PeerID> &peers);
// AUTO -> concrete strategy for this peer list (star on one host,
// binary-tree-star across hosts), identity otherwise.
Strategy resolve_auto(Strategy s, const std::vector<PeerID> &peers);
// Rooted collectives (explicit-root reduce/broadcast): a (reduce, bcast)
// pair of strategy `s` whose graphs converge at / fan out from `root`.
// `variant` (0 <= variant < rooted_variants) rotates the non-root interior
// so chunked transfers spread fan-out load across different trees.
int rooted_variants(Strategy s, const std::vector<PeerID> &peers);
GraphPair rooted_pair(Strategy s, const std::vector<PeerID> &peers, int root,
                      int variant);
// Star bcast graph rooted at r (for explicit-root broadcast/reduce).
Graph star_graph(int k, int r);
Graph reduce_graph_of(const Graph &bcast);

// ------------------------------------------------- hierarchical composition
// KF_HIER=1 (docs/collectives.md): every strategy S becomes hier(S) —
// an intra-host reduce to each host master (leaves -> master, over the
// shm rings when colocated), the *existing* strategy graphs of S
// restricted to the masters for the inter-host stage, then an
// intra-host broadcast (Horovod hierarchical allreduce / BlueConnect
// topology decomposition). Composed as ordinary (reduce, bcast) graph
// pairs in the full rank space, so Session::run_graphs walks them
// unchanged and every byte of the protocol (chunking, rendezvous
// names, epoch fencing) is identical to the flat path.
// With no colocation (every rank its own host) hier(S) == S exactly.
std::vector<GraphPair> build_hierarchical(Strategy s,
                                          const std::vector<PeerID> &peers);
// Rooted variants of hier(S): the master-level interior rotates for
// chunk spreading exactly like the flat rooted pairs.
int hier_rooted_variants(Strategy s, const std::vector<PeerID> &peers,
                         int root);
GraphPair hier_rooted_pair(Strategy s, const std::vector<PeerID> &peers,
                           int root, int variant);
// KF_HIER=1 at Session construction (re-read per construction so every
// epoch switch / recovery re-plans from the live environment+PeerList).
bool hier_enabled();

}  // namespace kf
