// Instance registry + scheduler + weight-sender assignment.
//
// C++ equivalent of the reference manager's state.rs (SURVEY.md C16a):
// remote/local instance registries with atomic telemetry, pending set,
// active pool, quota + zero-queue round-robin scheduling
// (state.rs:84-147), round-robin weight-sender assignment (:149-162),
// weight-version orchestration, graceful shutdown (:224-270).
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "balance.h"

namespace manager {

struct Instance {
  std::string endpoint;          // host:port of the rollout engine HTTP server
  bool is_local = false;         // colocated with the trainer (time-sliced)
  int group_idx = 0;             // weight-sender group assignment
  std::string weight_sender;     // assigned sender endpoint ("" = none yet)

  // telemetry (stats poller writes, scheduler reads)
  std::atomic<int64_t> num_running_reqs{0};
  std::atomic<int64_t> num_queued_reqs{0};
  std::atomic<double> last_gen_throughput{0.0};
  std::atomic<int64_t> assigned_batches{0};
  std::atomic<bool> updating_weight{false};
  std::atomic<int64_t> weight_version{-1};
  std::atomic<bool> healthy{false};
  // elastic-pool membership state: consecutive heartbeat (stats-poll)
  // misses — a remote past the configured budget is evicted; draining is
  // the engine's own announcement (server_info) that it took a preemption
  // notice — it leaves the routing set immediately but stays registered
  // until it deregisters or its heartbeat lapses
  std::atomic<int64_t> heartbeat_misses{0};
  std::atomic<bool> draining{false};
  // engine flight-deck telemetry (stats poller forwards from server_info):
  // decode slot occupancy (EWMA), page-pool utilization, server-side
  // latency tails, prefix-cache hit rate, speculative acceptance, and the
  // token-accounting reconciliation ratio — the per-engine load signals a
  // placement layer needs beyond num_running_reqs. Engines that predate
  // the flight deck simply never write them (zeros / frac 1.0).
  std::atomic<double> occupancy{0.0};
  std::atomic<double> page_util{0.0};
  std::atomic<double> ttft_p95_s{0.0};
  std::atomic<double> tpot_p95_s{0.0};
  std::atomic<double> cache_hit_rate{0.0};
  std::atomic<double> spec_accept_rate{0.0};
  std::atomic<double> attributed_frac{1.0};
  // group-shared prefill telemetry: fraction of prompt tokens served from
  // shared/cached pages, and the request-level (length-unbiased) prefix
  // hit fraction
  std::atomic<double> prefill_reuse_frac{0.0};
  std::atomic<double> prefix_hit_frac{0.0};
  // KV memory plane telemetry (rollout/kvledger.py): fraction of resident
  // pages gone cold (idle past the tier threshold) and device HBM headroom
  // in GB. headroom < 0 sentinels "not reported" (CPU engines / ledger
  // off) so the fleet min never counts an unreporting engine as 0 GB.
  std::atomic<double> kv_cold_page_frac{0.0};
  std::atomic<double> hbm_headroom_gb{-1.0};
  // host-RAM KV spill tier (rollout/kvspill.py): fraction of the page pool
  // currently paged out to host RAM (can exceed 1.0 under oversubscription)
  // and the windowed restore rate in pages/dispatch (the thrash signal).
  std::atomic<double> kv_spilled_frac{0.0};
  std::atomic<double> kv_restore_rate{0.0};
  // engine-loop profiler (obs/engine_profile.py): windowed fraction of the
  // loop wall spent dispatching to / waiting on the device, and the
  // bookkeeping (deck+ledger+spill sweep) fraction. device_frac < 0
  // sentinels "not reported" (loop_profile off / pre-profiler engines) so
  // the fleet min never counts an unreporting engine as 0.
  std::atomic<double> device_frac{-1.0};
  std::atomic<double> accounting_frac{0.0};
};

using InstancePtr = std::shared_ptr<Instance>;

class AppState {
 public:
  explicit AppState(int max_assigned_batches = 4)
      : max_assigned_batches_(max_assigned_batches) {}

  // -- registration ----------------------------------------------------

  // Returns assigned (weight_sender, group_idx). Instance starts pending
  // until promote_healthy.
  std::pair<std::string, int> register_instance(const std::string& endpoint,
                                                bool is_local) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    InstancePtr inst;
    if (it != instances_.end()) {
      inst = it->second;
    } else {
      inst = std::make_shared<Instance>();
      inst->endpoint = endpoint;
      instances_[endpoint] = inst;
    }
    inst->is_local = is_local;
    if (inst->weight_sender.empty() && !weight_senders_.empty()) {
      auto [sender, group] = next_sender_locked();
      inst->weight_sender = sender;
      inst->group_idx = group;
    }
    // a re-registration (rejoin after drain/eviction of the same endpoint)
    // starts with a clean bill: no inherited misses or draining flag
    inst->heartbeat_misses = 0;
    inst->draining = false;
    ++joins_;
    if (is_local) {
      // local engines are trusted healthy (they registered from in-process)
      inst->healthy = true;
      active_.insert(endpoint);
      cv_.notify_all();
    } else {
      pending_.insert(endpoint);
    }
    return {inst->weight_sender, inst->group_idx};
  }

  void promote_healthy(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it == instances_.end()) return;
    it->second->healthy = true;
    pending_.erase(endpoint);
    // joins the ACTIVE pool only after weight bootstrap (get_receive_instances
    // → update_weights), mirroring handlers.rs:40-86 — UNLESS the instance
    // already reports the pool's current weight version (a reconcile replay
    // of a healthy fleet after a manager respawn: those engines would never
    // be offered to a sender and would strand outside the routing set
    // forever). With no senders registered (no weight fabric), it goes
    // straight to active.
    if (weight_senders_.empty() ||
        it->second->weight_version.load() >= weight_version_) {
      active_.insert(endpoint);
      cv_.notify_all();
    }
  }

  // Reconcile replay: restore a replayed engine's last-known weight version
  // (monotonic per instance — a stale replay can never rewind a live
  // engine), then re-admit it to the routing set if it is healthy and at
  // the current pool version (the respawned manager must not orphan a
  // caught-up fleet behind a redundant weight bootstrap).
  void set_instance_version(const std::string& endpoint, int64_t version) {
    // versions from real trainer pushes are >= 1 (update_weight_version
    // pre-increments from 0); a reported 0 is an engine's random-init
    // weights and must NOT satisfy the bootstrap gate
    if (version <= 0) return;
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it == instances_.end()) return;
    auto& inst = it->second;
    if (version > inst->weight_version.load()) inst->weight_version = version;
    // re-admission is for caught-up REMOTES only: a time-sliced-out local
    // re-enters exclusively via resume_local_instances, and an instance
    // mid-weight-update re-enters via complete_weight_update
    if (!inst->is_local && inst->healthy.load() && !inst->draining.load() &&
        !inst->updating_weight.load() &&
        inst->weight_version.load() >= weight_version_) {
      active_.insert(endpoint);
      cv_.notify_all();
    }
  }

  // The engine announced it is draining (preemption notice): out of the
  // routing set immediately, but it stays registered — in-flight aborts are
  // still being flushed as salvageable partials through its wire.
  void mark_draining(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it == instances_.end()) return;
    if (!it->second->draining.exchange(true)) ++drain_departures_;
    active_.erase(endpoint);
  }

  // Heartbeat-timeout eviction (scale-down WITHOUT notice): forget the
  // instance and count the eviction. In-flight rids on it fail their
  // stream and continue on survivors through the normal salvage path.
  void evict(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    if (!instances_.count(endpoint)) return;
    active_.erase(endpoint);
    pending_.erase(endpoint);
    instances_.erase(endpoint);
    ++evictions_;
  }

  // Graceful leave (POST /deregister_rollout_instance): the engine (or the
  // pool manager running a preemption drill) announced departure. A drain
  // the heartbeat already booked (mark_draining) is not counted twice.
  void leave(const std::string& endpoint, bool drained) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it == instances_.end()) return;
    bool already_draining = it->second->draining.load();
    active_.erase(endpoint);
    pending_.erase(endpoint);
    instances_.erase(it);
    if (drained) {
      if (!already_draining) ++drain_departures_;
    } else {
      ++evictions_;
    }
  }

  struct PoolCounts {
    int64_t joins = 0, evictions = 0, drain_departures = 0;
    int64_t active = 0, pending = 0, registered = 0;
  };

  PoolCounts pool_counts() {
    std::lock_guard<std::mutex> g(mu_);
    PoolCounts out;
    out.joins = joins_;
    out.evictions = evictions_;
    out.drain_departures = drain_departures_;
    out.active = static_cast<int64_t>(active_.size());
    out.pending = static_cast<int64_t>(pending_.size());
    out.registered = static_cast<int64_t>(instances_.size());
    return out;
  }

  bool is_active(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    return active_.count(endpoint) > 0;
  }

  bool has_instance(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    return instances_.count(endpoint) > 0;
  }

  void deregister(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    active_.erase(endpoint);
    pending_.erase(endpoint);
    instances_.erase(endpoint);
  }

  InstancePtr get(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    return it == instances_.end() ? nullptr : it->second;
  }

  std::vector<InstancePtr> all_instances() {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<InstancePtr> out;
    for (auto& [_, inst] : instances_) out.push_back(inst);
    return out;
  }

  std::vector<InstancePtr> active_instances() {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<InstancePtr> out;
    for (auto& ep : active_) {
      auto it = instances_.find(ep);
      if (it != instances_.end()) out.push_back(it->second);
    }
    return out;
  }

  size_t active_count() {
    std::lock_guard<std::mutex> g(mu_);
    return active_.size();
  }

  // True while the pool can plausibly recover WITHOUT trainer action: an
  // instance is pending its health check, active-but-busy (quota/queue —
  // frees up on the next stats tick), or a drained remote mid-weight-update
  // (the sender poll loop re-admits it). Time-sliced-out LOCALS do NOT
  // count: their only re-admission path is resume_local_instances() at the
  // trainer's next stream, which cannot happen while this batch blocks —
  // waiting on them would deadlock a local-only pool at the window expiry.
  // Used by the scheduler to distinguish "busy, requeue" from "dead, fail"
  // (the reference blocks indefinitely, state.rs:84-147, but its pool is
  // remote-only).
  bool has_prospective_instances() {
    std::lock_guard<std::mutex> g(mu_);
    if (!pending_.empty()) return true;
    for (auto& [ep, inst] : instances_) {
      if (!inst->healthy.load()) continue;
      if (inst->draining.load()) continue;  // announced departure: leaving
      if (active_.count(ep)) return true;
      if (!inst->is_local) return true;
    }
    return false;
  }

  // -- scheduling (reference next_instance_with_type, state.rs:84-147) --

  // Block until an instance is available: quota not exhausted AND zero
  // queued requests; among eligible, pick the LEAST-LOADED (running +
  // queued from the last stats tick, plus batches assigned since — the
  // live signal between ticks), tie-broken round-robin so an idle pool
  // still rotates. want_local filters by locality (-1 = any). Returns
  // nullptr on shutdown/timeout.
  //
  // group_id (group-shared prefill): the first member of a group pins the
  // group to the picked endpoint; later members route to the pin even when
  // it is quota-busy (they WAIT for it rather than splitting the group
  // across engines — split siblings each pay a fresh prompt prefill,
  // structurally defeating the engine's shared-prefill fork). A pin whose
  // endpoint left the routing set (evicted/drained) is dropped and the
  // member re-pins to a survivor — the salvage continuation path then
  // carries the whole group there together.
  InstancePtr next_instance(int want_local = -1, int timeout_ms = 120000,
                            const std::string& group_id = std::string()) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    while (!shutdown_) {
      if (!group_id.empty()) {
        auto pin = group_pins_.find(group_id);
        if (pin != group_pins_.end()) {
          auto it = instances_.find(pin->second);
          bool routed = it != instances_.end() && active_.count(pin->second) &&
                        !it->second->draining.load();
          if (!routed) {
            group_pins_.erase(pin);  // endpoint gone: re-pin below
          } else {
            auto& inst = it->second;
            bool ok = (want_local < 0 ||
                       inst->is_local == (want_local == 1)) &&
                      !inst->updating_weight.load() &&
                      inst->assigned_batches.load() < max_assigned_batches_ &&
                      inst->num_queued_reqs.load() == 0;
            if (ok) {
              inst->assigned_batches.fetch_add(1);
              return inst;
            }
            // pinned but momentarily ineligible (quota/queue): wait for it
            // instead of splitting the group across engines
            if (cv_.wait_until(lk, deadline) == std::cv_status::timeout)
              return nullptr;
            continue;
          }
        }
      }
      std::vector<InstancePtr> eligible;
      for (auto& ep : active_) {
        auto it = instances_.find(ep);
        if (it == instances_.end()) continue;
        auto& inst = it->second;
        if (want_local >= 0 && inst->is_local != (want_local == 1)) continue;
        if (inst->updating_weight.load()) continue;
        if (inst->draining.load()) continue;
        if (inst->assigned_batches.load() >= max_assigned_batches_) continue;
        if (inst->num_queued_reqs.load() > 0) continue;
        eligible.push_back(inst);
      }
      if (!eligible.empty()) {
        auto load = [](const InstancePtr& i) {
          return i->num_running_reqs.load() + i->num_queued_reqs.load() +
                 i->assigned_batches.load();
        };
        size_t start = rr_counter_++ % eligible.size();
        InstancePtr pick = eligible[start];
        int64_t best = load(pick);
        for (size_t k = 1; k < eligible.size(); ++k) {
          auto& cand = eligible[(start + k) % eligible.size()];
          int64_t l = load(cand);
          if (l < best) { best = l; pick = cand; }
        }
        pick->assigned_batches.fetch_add(1);
        if (!group_id.empty()) pin_group_locked(group_id, pick->endpoint);
        return pick;
      }
      if (cv_.wait_until(lk, deadline) == std::cv_status::timeout) return nullptr;
    }
    return nullptr;
  }

  // stats tick: refresh quota + wake blocked schedulers (state.rs quota
  // reset each stats check).
  void reset_quotas() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto& [_, inst] : instances_) inst->assigned_batches = 0;
    cv_.notify_all();
  }

  void notify_available() { cv_.notify_all(); }

  // -- weight-version orchestration (handlers.rs:566-649) ---------------

  // New trainer weights exist: drain the active pool (remote instances must
  // re-bootstrap through the sender), keep/re-add local instances (they get
  // weights in-process). With NO transfer fabric registered there is no
  // sender poll loop to re-admit a drained remote (reference re-admission:
  // sender_agent.py:324-340 → handlers.rs:681-795), so draining would
  // strand it forever — keep the pool as-is and only record the bump;
  // remotes serve stale weights until a fabric is attached.
  int64_t update_weight_version() {
    std::lock_guard<std::mutex> g(mu_);
    ++weight_version_;
    if (weight_senders_.empty()) {
      cv_.notify_all();
      return weight_version_;
    }
    std::set<std::string> next_active;
    for (auto& ep : active_) {
      auto it = instances_.find(ep);
      if (it != instances_.end() && it->second->is_local) next_active.insert(ep);
    }
    active_ = std::move(next_active);
    return weight_version_;
  }

  int64_t weight_version() {
    std::lock_guard<std::mutex> g(mu_);
    return weight_version_;
  }

  // Supervisor replay after a respawn (/reconcile): restore the version a
  // crashed predecessor had reached WITHOUT the drain semantics of
  // update_weight_version — the fresh registry has nothing to drain, and a
  // replayed bump must never re-trigger a pool reset. Monotonic: a stale
  // replay can only raise the version, never rewind it.
  int64_t raise_weight_version_floor(int64_t version) {
    std::lock_guard<std::mutex> g(mu_);
    if (version > weight_version_) weight_version_ = version;
    return weight_version_;
  }

  // Sender polls: return healthy instances whose weights are stale,
  // CAS-marking them updating (handlers.rs:602-649).
  std::vector<InstancePtr> get_receive_instances(const std::string& sender) {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<InstancePtr> out;
    for (auto& [_, inst] : instances_) {
      if (!inst->healthy.load()) continue;
      if (inst->is_local) continue;  // local engines get weights in-process
      if (!sender.empty() && inst->weight_sender != sender) continue;
      if (inst->weight_version.load() >= weight_version_) continue;
      bool expected = false;
      if (inst->updating_weight.compare_exchange_strong(expected, true)) {
        out.push_back(inst);
      }
    }
    return out;
  }

  // Transfer finished: record version, re-insert into the active pool,
  // wake blocked schedulers (handlers.rs:727-786). Invariant: only an
  // instance at the CURRENT version may re-enter the active pool — a push
  // that raced with a newer update_weight_version stays drained and is
  // re-pushed on the sender's next poll.
  void complete_weight_update(const std::string& endpoint, int64_t version) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it == instances_.end()) return;
    it->second->weight_version = version;
    it->second->updating_weight = false;
    if (version >= weight_version_) {
      active_.insert(endpoint);
      cv_.notify_all();
    }
  }

  void abort_weight_update(const std::string& endpoint) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = instances_.find(endpoint);
    if (it != instances_.end()) it->second->updating_weight = false;
  }

  // -- weight senders (launcher PUT /update_weight_senders) -------------

  void set_weight_senders(std::vector<std::string> senders, int groups_per_sender) {
    std::lock_guard<std::mutex> g(mu_);
    weight_senders_ = std::move(senders);
    groups_per_sender_ = std::max(groups_per_sender, 1);
  }

  std::vector<std::string> weight_senders() {
    std::lock_guard<std::mutex> g(mu_);
    return weight_senders_;
  }

  // -- local instance time-slicing (handlers.rs:500-513) ----------------

  // Pull local instances out of the pool (trainer wants the chips back).
  std::vector<InstancePtr> remove_local_from_active() {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<InstancePtr> out;
    for (auto it = active_.begin(); it != active_.end();) {
      auto inst_it = instances_.find(*it);
      if (inst_it != instances_.end() && inst_it->second->is_local) {
        out.push_back(inst_it->second);
        it = active_.erase(it);
      } else {
        ++it;
      }
    }
    return out;
  }

  void add_local_to_active() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto& [ep, inst] : instances_) {
      if (inst->is_local && inst->healthy.load()) active_.insert(ep);
    }
    cv_.notify_all();
  }

  void shutdown() {
    std::lock_guard<std::mutex> g(mu_);
    shutdown_ = true;
    cv_.notify_all();
  }
  bool is_shutdown() {
    std::lock_guard<std::mutex> g(mu_);
    return shutdown_;
  }

  LoadBalanceState balance;

 private:
  std::pair<std::string, int> next_sender_locked() {
    // round-robin over senders × groups (state.rs:149-162)
    size_t total = weight_senders_.size() * static_cast<size_t>(groups_per_sender_);
    size_t idx = sender_rr_++ % std::max<size_t>(total, 1);
    size_t sender_idx = idx / groups_per_sender_;
    int group = static_cast<int>(idx % groups_per_sender_);
    return {weight_senders_[sender_idx], group};
  }

  // group-shared prefill routing pins (group_id -> endpoint), bounded FIFO:
  // groups are batch-lived, so the oldest pins are always dead weight —
  // evicting them cannot split a live group (its members arrive within one
  // batch_generate call, far fewer than kMaxGroupPins groups apart)
  static constexpr size_t kMaxGroupPins = 4096;
  void pin_group_locked(const std::string& group_id,
                        const std::string& endpoint) {
    if (group_pins_.emplace(group_id, endpoint).second) {
      group_pin_order_.push_back(group_id);
      while (group_pin_order_.size() > kMaxGroupPins) {
        group_pins_.erase(group_pin_order_.front());
        group_pin_order_.pop_front();
      }
    } else {
      group_pins_[group_id] = endpoint;
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, InstancePtr> instances_;
  std::set<std::string> active_;
  std::set<std::string> pending_;
  std::vector<std::string> weight_senders_;
  std::map<std::string, std::string> group_pins_;
  std::deque<std::string> group_pin_order_;
  int groups_per_sender_ = 1;
  size_t sender_rr_ = 0;
  size_t rr_counter_ = 0;
  int64_t weight_version_ = 0;
  int max_assigned_batches_;
  bool shutdown_ = false;
  // pool lifecycle counters (cumulative; /metrics + /get_instances_status)
  int64_t joins_ = 0;
  int64_t evictions_ = 0;
  int64_t drain_departures_ = 0;
};

}  // namespace manager
