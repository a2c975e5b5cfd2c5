/* libkf — TPU-native DCN control plane for kungfu-tpu.
 *
 * This is the C API consumed by Python via ctypes. It provides the
 * runtime the reference implements in Go (reference: srcs/go/rchannel,
 * srcs/go/kungfu/{peer,session}, srcs/go/store): framed named messages over
 * TCP, an epoch-token-fenced peer lifecycle, graph-based CPU collectives,
 * digest consensus, a named blob store with a versioned window, and P2P
 * blob request/response. The TPU *data plane* (gradient all-reduce) lives
 * in XLA/ICI and never touches this library; this is the control plane for
 * elasticity, consensus, model exchange across DCN, and non-TPU testing.
 *
 * Thread-safety: all functions on a kf_peer are safe to call from multiple
 * threads; collectives on distinct names may run concurrently.
 * All blocking calls honor the timeout configured at peer creation.
 */
#ifndef KF_H
#define KF_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct kf_peer kf_peer;

/* dtype codes (wire + kernel) */
enum {
    KF_U8 = 0,
    KF_I8 = 1,
    KF_U16 = 2,
    KF_I16 = 3,
    KF_U32 = 4,
    KF_I32 = 5,
    KF_U64 = 6,
    KF_I64 = 7,
    KF_F16 = 8,
    KF_BF16 = 9,
    KF_F32 = 10,
    KF_F64 = 11,
};

/* reduce op codes. KF_SUM_SAT is the compressed-gradient accumulate:
 * integer dtypes clamp at the dtype bounds instead of wrapping (the sum
 * of int8-quantized gradient shards must degrade to clipping — absorbed
 * by error feedback — never to sign-flipped wraparound); float dtypes
 * behave exactly like KF_SUM (they already saturate at +/-inf). */
enum { KF_SUM = 0, KF_MIN = 1, KF_MAX = 2, KF_PROD = 3, KF_SUM_SAT = 4 };

/* all-reduce topology strategies */
enum {
    KF_STRATEGY_STAR = 0,
    KF_STRATEGY_RING = 1,
    KF_STRATEGY_CLIQUE = 2,
    KF_STRATEGY_TREE = 3,
    KF_STRATEGY_BINARY_TREE = 4,
    KF_STRATEGY_BINARY_TREE_STAR = 5,
    KF_STRATEGY_MULTI_BINARY_TREE_STAR = 6,
    KF_STRATEGY_AUTO = 7,
};

/* error codes (negative returns) */
enum {
    KF_OK = 0,
    KF_ERR = -1,          /* generic failure */
    KF_ERR_TIMEOUT = -2,  /* blocking op timed out */
    KF_ERR_EPOCH = -3,    /* stale epoch token rejected */
    KF_ERR_CONN = -4,     /* cannot establish connection */
    KF_ERR_NOTFOUND = -5, /* P2P request: blob absent on responder */
    KF_ERR_ARG = -6,      /* invalid argument */
    KF_ERR_CORRUPT = -7,  /* wire-frame integrity violation (torn or
                           * corrupted shm-ring frame): the payload is
                           * untrusted and the channel is dead — callers
                           * must treat it like a peer death (recover),
                           * never deserialize the bytes */
};

/* --- lifecycle ---------------------------------------------------------- */

/* self_spec: "ip:port"; peers: comma-separated "ip:port" rank list (must
 * contain self); version: initial cluster epoch; strategy: KF_STRATEGY_*.
 * timeout_ms: per-blocking-op timeout (0 = no timeout). */
kf_peer *kf_peer_new(const char *self_spec, const char *peers,
                     uint32_t version, int strategy, int64_t timeout_ms);
int kf_peer_start(kf_peer *);                 /* start server threads */
int kf_peer_stop(kf_peer *);                  /* stop + join */
void kf_peer_free(kf_peer *);

/* Switch to a new membership epoch: bump token, drop connections to peers
 * not in the new list, rebuild the session. Does NOT barrier — callers
 * barrier explicitly once all peers updated. */
int kf_peer_update(kf_peer *, const char *peers, uint32_t version);

int kf_rank(kf_peer *);
int kf_size(kf_peer *);
int kf_local_rank(kf_peer *);
int kf_local_size(kf_peer *);
uint32_t kf_version(kf_peer *);
uint64_t kf_uid(kf_peer *);

/* --- collectives (control plane, CPU buffers) --------------------------- */

int kf_barrier(kf_peer *);
int kf_all_reduce(kf_peer *, const void *send, void *recv, int64_t count,
                  int dtype, int op, const char *name);
int kf_reduce(kf_peer *, const void *send, void *recv, int64_t count,
              int dtype, int op, int root, const char *name);
int kf_broadcast(kf_peer *, const void *send, void *recv, int64_t count,
                 int dtype, int root, const char *name);
int kf_gather(kf_peer *, const void *send, int64_t count, void *recv,
              int64_t total_count, int dtype, int root, const char *name);
int kf_all_gather(kf_peer *, const void *send, int64_t count, void *recv,
                  int dtype, const char *name);
/* returns 1 if all peers passed identical bytes, 0 if divergent, <0 error */
int kf_consensus(kf_peer *, const void *data, int64_t n, const char *name);

/* --- named blob store + P2P -------------------------------------------- */

int kf_save(kf_peer *, const char *name, const void *data, int64_t n);
int kf_save_version(kf_peer *, const char *version, const char *name,
                    const void *data, int64_t n);
/* Fetch blob `name` from peer at `rank`; out must hold n bytes. */
int kf_request(kf_peer *, int rank, const char *name, void *out, int64_t n);
int kf_request_version(kf_peer *, int rank, const char *version,
                       const char *name, void *out, int64_t n);

/* --- control channel ---------------------------------------------------- */

/* Handler invoked (on a server thread) for every Control message received. */
typedef void (*kf_control_cb)(void *user, const char *name, const void *data,
                              int64_t n);
int kf_set_control_handler(kf_peer *, kf_control_cb cb, void *user);
/* Send a control message to an arbitrary address (e.g. a runner). */
int kf_send_control(kf_peer *, const char *dest_spec, const char *name,
                    const void *data, int64_t n);

/* --- order group --------------------------------------------------------- */

/* Executes N async tasks in a scheduled order regardless of arrival order,
 * recording actual arrival order (the reference's gradient-ordering engine;
 * here it serializes host-side async control-plane ops so all ranks issue
 * named collectives in the same order). Independent of any kf_peer. */
typedef struct kf_order_group kf_order_group;
typedef void (*kf_task_cb)(void *user);

/* exec_order: permutation of 0..n-1 (position -> rank), or NULL for rank
 * order. */
kf_order_group *kf_order_group_new(int n, const int *exec_order);
/* Register task `rank` for this cycle; cb(user) runs on the executor
 * thread in scheduled order. Returns KF_ERR_ARG on bad/duplicate rank. */
int kf_order_group_start(kf_order_group *, int rank, kf_task_cb cb,
                         void *user);
/* Block until all n tasks ran; writes the arrival order (n ints, element i
 * = rank that arrived i-th) into arrival_out if non-NULL, then resets for
 * the next cycle. Returns KF_ERR (arrival_out untouched) if a concurrent
 * wait consumed this cycle's order first. */
int kf_order_group_wait(kf_order_group *, int *arrival_out);
void kf_order_group_free(kf_order_group *);

/* --- monitoring --------------------------------------------------------- */

int kf_ping(kf_peer *, int rank, int64_t *rtt_us); /* RTT to peer */
void kf_stats(kf_peer *, uint64_t *egress_bytes, uint64_t *ingress_bytes);
/* Cumulative payload bytes per wire link class, for the link-class
 * byte attribution of kf_wire_bytes_total{link=...}: out[0..2] =
 * egress over {tcp, unix, shm}, out[3..5] = ingress over the same.
 * The kf_stats totals are always the sum of the classes. */
void kf_link_stats(kf_peer *, uint64_t out[6]);
/* How many per-pair shm channels degraded to the socket path this
 * epoch-lifetime (attach/ENOSPC/hello failures; cumulative across
 * epochs). Feeds kf_link_fallback_total on /metrics — the loud twin of
 * KF_SHM_REQUIRE=1, which turns the degradation into an error. */
uint64_t kf_shm_fallback_total(kf_peer *);
/* 1 when the current session walks hierarchical (KF_HIER=1) graphs:
 * intra-host reduce -> inter-host strategy over host masters ->
 * intra-host broadcast, re-derived from the peer list on every epoch
 * switch. 0 = flat strategy graphs. */
int kf_hier(kf_peer *);

/* --- reduce kernels ------------------------------------------------------ */

/* Elementwise dst[i] = dst[i] (op) src[i] on host buffers — the kernel the
 * collectives accumulate with, exported for tests and microbenchmarks.
 * force_scalar=1 bypasses the AVX2/F16C dispatch; both paths produce
 * bit-identical results. Returns KF_OK / KF_ERR_ARG. */
int kf_accumulate(void *dst, const void *src, int64_t count, int dtype,
                  int op, int force_scalar);
/* 1 if this process will use SIMD kernels for the given dtype, else 0. */
int kf_simd_enabled(int dtype);

/* --- tracing ------------------------------------------------------------- */

/* Scoped timers around libkf hot paths (send / dial / recv_wait /
 * accumulate / collective), enabled by KF_TRACE=1 in the environment.
 * Fills `buf` with "scope count total_us max_us" lines (NUL-terminated,
 * truncated at cap-1) and returns the bytes written; 0 when tracing is
 * off or nothing has been recorded yet. Process-global. */
int64_t kf_trace_report(char *buf, int64_t cap);
void kf_trace_reset(void);
/* 1 when KF_TRACE was set at first use, else 0. */
int kf_trace_enabled(void);

/* library version string */
const char *kf_version_string(void);

#ifdef __cplusplus
}
#endif

#endif /* KF_H */
