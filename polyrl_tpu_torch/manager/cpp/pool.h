// Fixed-size worker pool with a bounded task queue.
//
// Replaces the manager's thread-per-connection / thread-per-request spawning
// (round-1 review finding): the reference runs on a bounded tokio runtime,
// so a trainer submitting a 10k-request batch must not create 10k OS threads
// here. Submission BLOCKS when the queue is full (backpressure, matching
// tokio's bounded behavior) rather than dropping work.
#pragma once

#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace phttp {

class WorkerPool {
 public:
  explicit WorkerPool(size_t workers, size_t max_queue = 4096)
      : max_queue_(max_queue) {
    threads_.reserve(workers);
    for (size_t i = 0; i < workers; ++i) {
      threads_.emplace_back([this] { run(); });
    }
  }

  ~WorkerPool() { stop(); }

  // Blocks while the queue is full (backpressure). Returns false after stop().
  bool submit(std::function<void()> task) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      not_full_.wait(lk, [this] { return stopped_ || queue_.size() < max_queue_; });
      if (stopped_) return false;
      queue_.push_back(std::move(task));
    }
    not_empty_.notify_one();
    return true;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (stopped_) return;
      stopped_ = true;
    }
    not_empty_.notify_all();
    not_full_.notify_all();
    for (auto& t : threads_) {
      if (t.joinable()) t.join();
    }
  }

  size_t size() const { return threads_.size(); }

 private:
  void run() {
    while (true) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [this] { return stopped_ || !queue_.empty(); });
        if (queue_.empty()) return;  // stopped and drained
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      not_full_.notify_one();
      task();
    }
  }

  std::mutex mu_;
  std::condition_variable not_empty_;
  std::condition_variable not_full_;
  std::deque<std::function<void()>> queue_;
  std::vector<std::thread> threads_;
  size_t max_queue_;
  bool stopped_ = false;
};

}  // namespace phttp
