#include "ordergroup.hpp"

#include <numeric>
#include <stdexcept>

#include "core.hpp"

namespace kf {

OrderGroup::OrderGroup(int n, std::vector<int> exec_order)
    : n_(n),
      exec_order_(std::move(exec_order)),
      tasks_(size_t(n)),
      arrived_(size_t(n), false),
      done_(size_t(n), false) {
    if (n_ < 0) throw std::invalid_argument("OrderGroup: negative n");
    if (exec_order_.empty()) {
        exec_order_.resize(size_t(n_));
        std::iota(exec_order_.begin(), exec_order_.end(), 0);
    }
    if (int(exec_order_.size()) != n_)
        throw std::invalid_argument("OrderGroup: bad exec_order length");
    std::vector<bool> seen(size_t(n_), false);
    for (int r : exec_order_) {
        if (r < 0 || r >= n_ || seen[size_t(r)])
            throw std::invalid_argument("OrderGroup: not a permutation");
        seen[size_t(r)] = true;
    }
    arrival_.reserve(size_t(n_));
    executor_ = std::thread([this] { run_loop(); });
}

OrderGroup::~OrderGroup() {
    {
        std::unique_lock<std::mutex> lk(mu_);
        // Don't hang forever on an incomplete cycle at teardown; drop
        // never-arrived tasks, let the executor drain what it has, and
        // release any thread still blocked in wait().
        stopping_ = true;
        cv_arrive_.notify_all();
        cv_done_.notify_all();
        // The released waiters still touch mu_/cv_done_ on their way out;
        // the cv/mutex must not be destroyed under them.
        cv_idle_.wait(lk, [&] { return waiters_ == 0; });
    }
    if (executor_.joinable()) executor_.join();
}

void OrderGroup::start(int rank, std::function<void()> task) {
    std::unique_lock<std::mutex> lk(mu_);
    if (rank < 0 || rank >= n_)
        throw std::invalid_argument("OrderGroup: rank out of range");
    if (arrived_[size_t(rank)])
        throw std::logic_error("OrderGroup: rank started twice in a cycle");
    arrived_[size_t(rank)] = true;
    arrival_.push_back(rank);
    tasks_[size_t(rank)] = std::move(task);
    cv_arrive_.notify_all();
}

std::vector<int> OrderGroup::wait() {
    std::unique_lock<std::mutex> lk(mu_);
    waiters_++;
    struct Leave {  // decrement on every return path, under the lock
        OrderGroup *g;
        ~Leave() {
            if (--g->waiters_ == 0) g->cv_idle_.notify_all();
        }
    } leave{this};
    const int cycle = cycle_;
    cv_done_.wait(lk, [&] {
        if (stopping_ || cycle_ != cycle) return true;
        for (int r = 0; r < n_; r++)
            if (!done_[size_t(r)]) return false;
        return true;
    });
    if (cycle_ != cycle) return {};  // lost the race; order went elsewhere
    if (stopping_) {
        for (int r = 0; r < n_; r++)  // incomplete teardown cycle?
            if (!done_[size_t(r)]) return {};
    }
    std::vector<int> order = std::move(arrival_);
    arrival_.clear();
    arrival_.reserve(size_t(n_));
    std::fill(arrived_.begin(), arrived_.end(), false);
    std::fill(done_.begin(), done_.end(), false);
    cycle_++;
    cv_arrive_.notify_all();  // wake executor into the new cycle
    return order;
}

void OrderGroup::run_loop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
        int my_cycle = cycle_;
        for (int k = 0; k < n_; k++) {
            const int rank = exec_order_[size_t(k)];
            cv_arrive_.wait(lk, [&] {
                return stopping_ || cycle_ != my_cycle ||
                       arrived_[size_t(rank)];
            });
            if (cycle_ != my_cycle) break;  // reset raced ahead (empty n=0)
            if (!arrived_[size_t(rank)]) {  // stopping with a partial cycle
                KF_DEBUG("OrderGroup: dropping %d unarrived tasks at stop",
                         n_ - k);
                return;
            }
            auto task = std::move(tasks_[size_t(rank)]);
            tasks_[size_t(rank)] = nullptr;
            lk.unlock();  // run user code without holding the lock
            if (task) task();
            lk.lock();
            done_[size_t(rank)] = true;
            cv_done_.notify_all();
        }
        if (stopping_) return;
        // Sleep until wait() opens the next cycle (or teardown).
        cv_arrive_.wait(lk, [&] { return stopping_ || cycle_ != my_cycle; });
        if (stopping_ && cycle_ == my_cycle) return;
    }
}

}  // namespace kf
