#include "core.hpp"

#include "trace.hpp"

#include <cstdarg>
#include <cstdlib>
#include <ctime>
#include <limits>
#include <mutex>
#include <type_traits>

#include "halffloat.hpp"

namespace kf {

// ---------------------------------------------------------------- logging

LogLevel log_level() {
    static LogLevel lvl = [] {
        const char *e = std::getenv("KF_LOG_LEVEL");
        if (!e) return LogLevel::warn;
        std::string s(e);
        if (s == "debug") return LogLevel::debug;
        if (s == "info") return LogLevel::info;
        if (s == "error") return LogLevel::error;
        return LogLevel::warn;
    }();
    return lvl;
}

void log_at(LogLevel lvl, const char *fmt, ...) {
    if (lvl < log_level()) return;
    static std::mutex mu;
    std::lock_guard<std::mutex> lk(mu);
    static const char *names[] = {"DEBUG", "INFO", "WARN", "ERROR"};
    std::fprintf(stderr, "[kf:%s] ", names[int(lvl)]);
    va_list ap;
    va_start(ap, fmt);
    std::vfprintf(stderr, fmt, ap);
    va_end(ap);
    std::fputc('\n', stderr);
}

// ----------------------------------------------------------------- dtypes

size_t dtype_size(Dtype dt) {
    switch (dt) {
        case Dtype::u8:
        case Dtype::i8:
            return 1;
        case Dtype::u16:
        case Dtype::i16:
        case Dtype::f16:
        case Dtype::bf16:
            return 2;
        case Dtype::u32:
        case Dtype::i32:
        case Dtype::f32:
            return 4;
        default:
            return 8;
    }
}

namespace {

// Saturating integer add: clamp at the dtype bounds instead of wrapping.
// Quantized-gradient sums must degrade to clipping (absorbed by the
// error-feedback residual) — a wrapped sum flips the gradient's sign.
template <typename T>
inline T sat_add(T a, T b) {
    T r;
    if (!__builtin_add_overflow(a, b, &r))
        return r;
    return b > 0 ? std::numeric_limits<T>::max()
                 : std::numeric_limits<T>::min();
}

template <typename T>
void accumulate_typed(T *dst, const T *src, int64_t n, ROp op) {
    switch (op) {
        case ROp::sum:
            for (int64_t i = 0; i < n; i++) dst[i] = T(dst[i] + src[i]);
            break;
        case ROp::sum_sat:
            if constexpr (std::is_integral<T>::value) {
                for (int64_t i = 0; i < n; i++)
                    dst[i] = sat_add(dst[i], src[i]);
            } else {
                // floats saturate at +/-inf already: identical to sum
                for (int64_t i = 0; i < n; i++)
                    dst[i] = T(dst[i] + src[i]);
            }
            break;
        case ROp::min:
            for (int64_t i = 0; i < n; i++)
                dst[i] = src[i] < dst[i] ? src[i] : dst[i];
            break;
        case ROp::max:
            for (int64_t i = 0; i < n; i++)
                dst[i] = src[i] > dst[i] ? src[i] : dst[i];
            break;
        case ROp::prod:
            for (int64_t i = 0; i < n; i++) dst[i] = T(dst[i] * src[i]);
            break;
    }
}

template <float (*FromBits)(uint16_t), uint16_t (*ToBits)(float)>
void accumulate_16bit_float(uint16_t *dst, const uint16_t *src, int64_t n,
                            ROp op) {
    for (int64_t i = 0; i < n; i++) {
        float a = FromBits(dst[i]), b = FromBits(src[i]), r;
        switch (op) {
            case ROp::sum:
            case ROp::sum_sat:  // floats saturate at +/-inf already
                r = a + b;
                break;
            case ROp::min:
                r = b < a ? b : a;
                break;
            case ROp::max:
                r = b > a ? b : a;
                break;
            default:
                r = a * b;
                break;
        }
        dst[i] = ToBits(r);
    }
}

}  // namespace

void reduce_accumulate(void *dst, const void *src, int64_t count, Dtype dt,
                       ROp op) {
    TraceScope trace(Tracer::ACCUMULATE);
    if (reduce_accumulate_simd(dst, src, count, dt, op)) return;
    reduce_accumulate_scalar(dst, src, count, dt, op);
}

void reduce_accumulate_scalar(void *dst, const void *src, int64_t count,
                              Dtype dt, ROp op) {
    switch (dt) {
        case Dtype::u8:
            return accumulate_typed((uint8_t *)dst, (const uint8_t *)src,
                                    count, op);
        case Dtype::i8:
            return accumulate_typed((int8_t *)dst, (const int8_t *)src, count,
                                    op);
        case Dtype::u16:
            return accumulate_typed((uint16_t *)dst, (const uint16_t *)src,
                                    count, op);
        case Dtype::i16:
            return accumulate_typed((int16_t *)dst, (const int16_t *)src,
                                    count, op);
        case Dtype::u32:
            return accumulate_typed((uint32_t *)dst, (const uint32_t *)src,
                                    count, op);
        case Dtype::i32:
            return accumulate_typed((int32_t *)dst, (const int32_t *)src,
                                    count, op);
        case Dtype::u64:
            return accumulate_typed((uint64_t *)dst, (const uint64_t *)src,
                                    count, op);
        case Dtype::i64:
            return accumulate_typed((int64_t *)dst, (const int64_t *)src,
                                    count, op);
        case Dtype::f16:
            return accumulate_16bit_float<f16_to_f32, f32_to_f16>(
                (uint16_t *)dst, (const uint16_t *)src, count, op);
        case Dtype::bf16:
            return accumulate_16bit_float<bf16_to_f32, f32_to_bf16>(
                (uint16_t *)dst, (const uint16_t *)src, count, op);
        case Dtype::f32:
            return accumulate_typed((float *)dst, (const float *)src, count,
                                    op);
        case Dtype::f64:
            return accumulate_typed((double *)dst, (const double *)src, count,
                                    op);
    }
}

// ------------------------------------------------------------------ peers

std::string PeerID::str() const {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%u.%u.%u.%u:%u", (ipv4 >> 24) & 0xFF,
                  (ipv4 >> 16) & 0xFF, (ipv4 >> 8) & 0xFF, ipv4 & 0xFF, port);
    return buf;
}

bool parse_peer(const std::string &s, PeerID *out) {
    unsigned a, b, c, d, p;
    char tail;
    if (std::sscanf(s.c_str(), "%u.%u.%u.%u:%u%c", &a, &b, &c, &d, &p,
                    &tail) != 5)
        return false;
    if (a > 255 || b > 255 || c > 255 || d > 255 || p > 65535) return false;
    out->ipv4 = (a << 24) | (b << 16) | (c << 8) | d;
    out->port = uint16_t(p);
    return true;
}

bool parse_peer_list(const std::string &s, std::vector<PeerID> *out) {
    out->clear();
    if (s.empty()) return true;
    size_t pos = 0;
    while (pos <= s.size()) {
        size_t comma = s.find(',', pos);
        std::string part = s.substr(
            pos, comma == std::string::npos ? std::string::npos : comma - pos);
        PeerID id;
        if (!parse_peer(part, &id)) return false;
        out->push_back(id);
        if (comma == std::string::npos) break;
        pos = comma + 1;
    }
    return true;
}

// ----------------------------------------------------------- topologies
// Shapes mirror kungfu_tpu/plan/topology.py (reference:
// srcs/go/plan/topology.go); locality rule: only host-master ranks carry
// cross-host edges.

namespace {

void local_masters(const std::vector<PeerID> &peers, std::vector<int> *masters,
                   std::unordered_map<uint32_t, int> *host_master) {
    for (int r = 0; r < int(peers.size()); r++) {
        if (!host_master->count(peers[r].ipv4)) {
            (*host_master)[peers[r].ipv4] = r;
            masters->push_back(r);
        }
    }
}

Graph binary_tree_star(const std::vector<PeerID> &peers, int offset) {
    Graph g(int(peers.size()));
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    local_masters(peers, &masters, &host_master);
    for (int r = 0; r < int(peers.size()); r++) {
        int m = host_master[peers[r].ipv4];
        if (m != r) g.add_edge(m, r);
    }
    int k = int(masters.size());
    if (k > 1) {
        for (int i = 0; i < k; i++) {
            for (int j : {2 * i + 1, 2 * i + 2}) {
                if (j < k)
                    g.add_edge(masters[(i + offset) % k],
                               masters[(j + offset) % k]);
            }
        }
    }
    return g;
}

std::pair<Graph, Graph> circular_pair(int k, int r) {
    Graph reduce(k), bcast(k);
    for (int i = 0; i < k; i++) reduce.add_edge(i, i);
    for (int i = 1; i < k; i++) {
        reduce.add_edge((r + i) % k, (r + i + 1) % k);
        bcast.add_edge((r + i - 1) % k, (r + i) % k);
    }
    return {reduce, bcast};
}

}  // namespace

Graph star_graph(int k, int r) {
    Graph g(k);
    for (int i = 0; i < k; i++)
        if (i != r) g.add_edge(r, i);
    return g;
}

Graph reduce_graph_of(const Graph &bcast) {
    Graph g = bcast.reverse();
    for (int i = 0; i < g.n; i++) g.add_edge(i, i);
    return g;
}

Strategy resolve_auto(Strategy s, const std::vector<PeerID> &peers) {
    if (s != Strategy::auto_select) return s;
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    local_masters(peers, &masters, &host_master);
    return masters.size() <= 1 ? Strategy::star : Strategy::binary_tree_star;
}

namespace {

// local_masters with `root` forced to be its host's master, so host-aware
// rooted graphs converge at the requested root. masters[0] == root.
void rooted_masters(const std::vector<PeerID> &peers, int root,
                    std::vector<int> *masters,
                    std::unordered_map<uint32_t, int> *host_master) {
    (*host_master)[peers[root].ipv4] = root;
    masters->push_back(root);
    for (int r = 0; r < int(peers.size()); r++) {
        if (!host_master->count(peers[r].ipv4)) {
            (*host_master)[peers[r].ipv4] = r;
            masters->push_back(r);
        }
    }
}

// Binary tree over `order` (order[0] stays the root; the rest rotated by
// `variant`), emitting edges into g.
void binary_tree_over(Graph *g, const std::vector<int> &order, int variant) {
    const int k = int(order.size());
    if (k <= 1) return;
    auto at = [&](int pos) {
        if (pos == 0) return order[0];
        return order[1 + (pos - 1 + variant) % (k - 1)];
    };
    for (int i = 0; i < k; i++)
        for (int j : {2 * i + 1, 2 * i + 2})
            if (j < k) g->add_edge(at(i), at(j));
}

}  // namespace

int rooted_variants(Strategy s, const std::vector<PeerID> &peers) {
    const int k = int(peers.size());
    s = resolve_auto(s, peers);
    switch (s) {
        case Strategy::binary_tree:
            return std::max(1, k - 1);
        case Strategy::binary_tree_star:
        case Strategy::multi_binary_tree_star: {
            std::vector<int> masters;
            std::unordered_map<uint32_t, int> host_master;
            local_masters(peers, &masters, &host_master);
            return std::max(1, int(masters.size()) - 1);
        }
        default:
            return 1;  // star/clique/ring have one rooted shape
    }
}

GraphPair rooted_pair(Strategy s, const std::vector<PeerID> &peers, int root,
                      int variant) {
    const int k = int(peers.size());
    s = resolve_auto(s, peers);
    if (s == Strategy::ring && k > 1) {
        // chain ending (reduce) / starting (bcast) at root
        return circular_pair(k, root);
    }
    Graph bcast(k);
    switch (s) {
        case Strategy::binary_tree: {
            std::vector<int> order;
            order.push_back(root);
            for (int r = 0; r < k; r++)
                if (r != root) order.push_back(r);
            binary_tree_over(&bcast, order, variant);
            break;
        }
        case Strategy::tree:
        case Strategy::binary_tree_star:
        case Strategy::multi_binary_tree_star: {
            std::vector<int> masters;
            std::unordered_map<uint32_t, int> host_master;
            rooted_masters(peers, root, &masters, &host_master);
            for (int r = 0; r < k; r++) {
                int m = host_master[peers[r].ipv4];
                if (m != r) bcast.add_edge(m, r);
            }
            if (s == Strategy::tree) {
                for (size_t i = 1; i < masters.size(); i++)
                    bcast.add_edge(masters[0], masters[i]);
            } else {
                binary_tree_over(&bcast, masters, variant);
            }
            break;
        }
        default:  // star, clique
            bcast = star_graph(k, root);
            break;
    }
    return {reduce_graph_of(bcast), bcast};
}

namespace {

// Copy a master-level graph into the full rank space via masters[i] ->
// global rank, preserving edge order (float accumulation order is part
// of the cross-rank contract).
void embed_masters(const Graph &g, const std::vector<int> &masters,
                   Graph *out) {
    for (int i = 0; i < g.n; i++) {
        if (g.self_loop[size_t(i)]) out->add_edge(masters[i], masters[i]);
        for (int j : g.next[i]) out->add_edge(masters[i], masters[j]);
    }
}

// Compose one master-level (reduce, bcast) pair with the intra-host
// star stages: leaves reduce into their host master, masters run the
// embedded inter-host pair, masters broadcast back to their leaves.
GraphPair compose_hier_pair(const GraphPair &mp, int n,
                            const std::vector<int> &masters,
                            const std::unordered_map<uint32_t, int>
                                &host_master,
                            const std::vector<PeerID> &peers) {
    Graph rg(n), bg(n);
    embed_masters(mp.first, masters, &rg);
    embed_masters(mp.second, masters, &bg);
    for (int r = 0; r < n; r++) {
        const int m = host_master.at(peers[size_t(r)].ipv4);
        if (m == r) continue;
        rg.add_edge(r, m);  // intra-host reduce: leaf -> its master
        bg.add_edge(m, r);  // intra-host bcast: master -> its leaves
    }
    return {rg, bg};
}

}  // namespace

bool hier_enabled() {
    const char *e = std::getenv("KF_HIER");
    return e && std::strcmp(e, "1") == 0;
}

std::vector<GraphPair> build_hierarchical(Strategy s,
                                          const std::vector<PeerID> &peers) {
    const int n = int(peers.size());
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    local_masters(peers, &masters, &host_master);
    if (int(masters.size()) == n) return build_strategy(s, peers);
    std::vector<PeerID> mpeers;
    mpeers.reserve(masters.size());
    for (int m : masters) mpeers.push_back(peers[size_t(m)]);
    // the inter-host stage IS the configured strategy, over the masters
    // (AUTO re-resolves against the master list inside build_strategy)
    auto mpairs = build_strategy(s, mpeers);
    std::vector<GraphPair> out;
    out.reserve(mpairs.size());
    for (auto &mp : mpairs)
        out.push_back(
            compose_hier_pair(mp, n, masters, host_master, peers));
    return out;
}

int hier_rooted_variants(Strategy s, const std::vector<PeerID> &peers,
                         int root) {
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    rooted_masters(peers, root, &masters, &host_master);
    if (int(masters.size()) == int(peers.size()))
        return rooted_variants(s, peers);
    std::vector<PeerID> mpeers;
    for (int m : masters) mpeers.push_back(peers[size_t(m)]);
    return rooted_variants(s, mpeers);
}

GraphPair hier_rooted_pair(Strategy s, const std::vector<PeerID> &peers,
                           int root, int variant) {
    const int n = int(peers.size());
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    rooted_masters(peers, root, &masters, &host_master);
    if (int(masters.size()) == n) return rooted_pair(s, peers, root, variant);
    std::vector<PeerID> mpeers;
    mpeers.reserve(masters.size());
    for (int m : masters) mpeers.push_back(peers[size_t(m)]);
    // masters[0] == root (rooted_masters forces root to master its own
    // host), so the master-level pair is rooted at master index 0
    const GraphPair mp = rooted_pair(s, mpeers, 0, variant);
    return compose_hier_pair(mp, n, masters, host_master, peers);
}

std::vector<GraphPair> build_strategy(Strategy s,
                                      const std::vector<PeerID> &peers) {
    const int k = int(peers.size());
    std::vector<int> masters;
    std::unordered_map<uint32_t, int> host_master;
    local_masters(peers, &masters, &host_master);

    s = resolve_auto(s, peers);

    std::vector<GraphPair> out;
    auto from_bcast = [&](const Graph &b) {
        out.push_back({reduce_graph_of(b), b});
    };
    switch (s) {
        case Strategy::star:
            from_bcast(star_graph(k, 0));
            break;
        case Strategy::ring:
            for (int r = 0; r < k; r++) out.push_back(circular_pair(k, r));
            break;
        case Strategy::clique:
            for (int r = 0; r < k; r++) from_bcast(star_graph(k, r));
            break;
        case Strategy::tree: {
            Graph g(k);
            for (int r = 0; r < k; r++) {
                int m = host_master[peers[r].ipv4];
                if (m != r) g.add_edge(m, r);
            }
            for (size_t i = 1; i < masters.size(); i++)
                g.add_edge(masters[0], masters[i]);
            from_bcast(g);
            break;
        }
        case Strategy::binary_tree: {
            Graph g(k);
            for (int i = 0; i < k; i++)
                for (int j : {2 * i + 1, 2 * i + 2})
                    if (j < k) g.add_edge(i, j);
            from_bcast(g);
            break;
        }
        case Strategy::binary_tree_star:
            from_bcast(binary_tree_star(peers, 0));
            break;
        case Strategy::multi_binary_tree_star:
            for (size_t i = 0; i < masters.size(); i++)
                from_bcast(binary_tree_star(peers, int(i)));
            break;
        default:
            from_bcast(star_graph(k, 0));
            break;
    }
    return out;
}

}  // namespace kf
