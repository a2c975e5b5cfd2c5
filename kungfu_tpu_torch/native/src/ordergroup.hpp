// OrderGroup: execute N async tasks in a scheduled order regardless of the
// order they arrive in, recording the actual arrival order.
//
// Control-plane rebuild of the reference's gradient-ordering engine
// (reference: srcs/go/ordergroup/ordergroup.go). The reference uses it to
// serialize NCCL launches in a negotiated global order; on TPU the XLA SPMD
// compiler fixes collective order at compile time, so here the order group
// serves the *host-side* control plane instead: async control-plane
// collectives issued from multiple Python threads must hit the wire in the
// same order on every rank or two ranks can deadlock waiting on each
// other's named channels. The recorded arrival order is the signal an
// adaptive scheduler broadcasts to re-negotiate the schedule (reference:
// srcs/cpp/src/tensorflow/ops/gpu/scheduler.cpp behavior).
#pragma once

#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace kf {

class OrderGroup {
  public:
    // `n` tasks, identified by ranks 0..n-1. `exec_order`, when non-empty,
    // is a permutation: exec_order[k] is the rank of the task to run k-th.
    // Empty means run in rank order.
    explicit OrderGroup(int n, std::vector<int> exec_order = {});
    // Teardown runs already-arrived tasks up to the first gap in the
    // schedule, then drops the rest (a full cycle should wait() first).
    ~OrderGroup();

    OrderGroup(const OrderGroup &) = delete;
    OrderGroup &operator=(const OrderGroup &) = delete;

    // Hand in task `rank`'s body; returns immediately. The body runs on
    // the executor thread once every task scheduled before `rank` has run.
    // Each rank must be started exactly once per cycle.
    void start(int rank, std::function<void()> task);

    // Block until all n tasks of the current cycle have run, then reset
    // for the next cycle. Returns the arrival order of the finished cycle:
    // element i is the rank whose start() came i-th. Empty (for n > 0)
    // means a concurrent wait() consumed the cycle's order first.
    std::vector<int> wait();

    int size() const { return n_; }

  private:
    void run_loop();

    const int n_;
    std::vector<int> exec_order_;           // schedule: position -> rank
    std::vector<std::function<void()>> tasks_;  // by rank; empty = not arrived
    std::vector<bool> arrived_, done_;      // by rank
    std::vector<int> arrival_;              // arrival order being recorded
    int cycle_ = 0;                         // bumped by wait() on reset
    bool stopping_ = false;
    int waiters_ = 0;  // threads inside wait(); drained by the destructor
    std::mutex mu_;
    std::condition_variable cv_arrive_, cv_done_, cv_idle_;
    std::thread executor_;
};

}  // namespace kf
