// Adaptive local/remote workload balancer.
//
// C++ equivalent of the reference's balance.rs (SURVEY.md C16c): a
// hill-climbing controller for the colocated engines' generation window
// (max_local_instance_gen_s). Inputs per step: total gen time, step time,
// trainer bubble (trainer idle waiting on rollout), instance count,
// throughput. Rule (balance.rs:193-205): remote_bubble = step_time -
// total_gen_time; trainer bubble < remote bubble → shrink local gen by
// gap/3 (floor 5 s), else grow by gap/3. A per-instance-count optimal
// table is remembered with EMA (α on throughput-drop, β on count change,
// balance.rs:105-155) and reused instantly when the count changes.
//
// The hardcoded GPU seed tables (8B: {1:190, 2:160, 3:105, 4:70}) are NOT
// ported — they are hardware-specific tuning; the TPU build starts from
// the initial window and learns.
#pragma once

#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>

namespace manager {

class LoadBalanceState {
 public:
  static constexpr double kAlpha = 0.8;   // EMA on throughput drop
  static constexpr double kBeta = 0.2;    // EMA on instance-count change
  static constexpr double kMinGenS = 5.0;
  static constexpr double kInitialGenS = 150.0;

  struct StepStats {
    double step_time_s = 0;
    double total_gen_time_s = 0;
    double local_gen_time_s = 0;
    double trainer_bubble_s = 0;
    double throughput = 0;       // tok/s (or any monotone proxy)
    int num_instances = 0;
  };

  double max_local_gen_s() {
    std::lock_guard<std::mutex> g(mu_);
    return max_local_gen_s_;
  }

  void set_initial_gen_s(double v) {
    std::lock_guard<std::mutex> g(mu_);
    max_local_gen_s_ = std::max(v, kMinGenS);
  }

  // Per-step update; returns the new local-generation window.
  double update(const StepStats& s) {
    std::lock_guard<std::mutex> g(mu_);
    // instance count changed: recall the remembered optimum for this count
    if (s.num_instances != last_instances_ && last_instances_ >= 0) {
      remember_locked(last_instances_, max_local_gen_s_, kBeta);
      auto it = optimal_.find(s.num_instances);
      if (it != optimal_.end()) max_local_gen_s_ = it->second;
    }
    last_instances_ = s.num_instances;

    // throughput-peak tracking: a significant drop pulls the window back
    // toward the best-seen value for this count (balance.rs:156-191).
    if (s.throughput > peak_throughput_) {
      peak_throughput_ = s.throughput;
      best_gen_s_ = max_local_gen_s_;
    } else if (peak_throughput_ > 0 &&
               s.throughput < 0.9 * peak_throughput_ && best_gen_s_ > 0) {
      max_local_gen_s_ = kAlpha * best_gen_s_ + (1 - kAlpha) * max_local_gen_s_;
    }

    // hill climb on the bubble gap
    double remote_bubble = s.step_time_s - s.total_gen_time_s;
    double gap = std::fabs(s.trainer_bubble_s - remote_bubble);
    if (s.trainer_bubble_s < remote_bubble) {
      max_local_gen_s_ -= gap / 3.0;
    } else {
      max_local_gen_s_ += gap / 3.0;
    }
    if (max_local_gen_s_ < kMinGenS) max_local_gen_s_ = kMinGenS;
    remember_locked(s.num_instances, max_local_gen_s_, kBeta);
    return max_local_gen_s_;
  }

  void record_generation(double total_gen_s, double local_gen_s, double mean_resp_len) {
    std::lock_guard<std::mutex> g(mu_);
    last_total_gen_s_ = total_gen_s;
    last_local_gen_s_ = local_gen_s;
    mean_response_len_ = mean_resp_len;
  }

  double last_total_gen_s() {
    std::lock_guard<std::mutex> g(mu_);
    return last_total_gen_s_;
  }
  double mean_response_len() {
    std::lock_guard<std::mutex> g(mu_);
    return mean_response_len_;
  }

  std::map<int, double> optimal_table() {
    std::lock_guard<std::mutex> g(mu_);
    return optimal_;
  }

 private:
  void remember_locked(int count, double value, double ema) {
    auto it = optimal_.find(count);
    if (it == optimal_.end()) {
      optimal_[count] = value;
    } else {
      it->second = ema * value + (1 - ema) * it->second;
    }
  }

  std::mutex mu_;
  double max_local_gen_s_ = kInitialGenS;
  int last_instances_ = -1;
  double peak_throughput_ = 0;
  double best_gen_s_ = -1;
  std::map<int, double> optimal_;
  double last_total_gen_s_ = 0;
  double last_local_gen_s_ = 0;
  double mean_response_len_ = 0;
};

}  // namespace manager
