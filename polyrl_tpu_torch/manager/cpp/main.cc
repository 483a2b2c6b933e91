// polyrl-manager — rollout control plane + fault-tolerant request router.
//
// C++ (TPU-native build) equivalent of the reference's Rust rollout-manager
// (SURVEY.md C16, rollout-manager/src/): instance registry + health checks
// + stats polling, quota/zero-queue round-robin scheduling, streaming
// generation routing with instance eviction and token-level continuation,
// local-engine time-slicing, adaptive local/remote balancing, and
// weight-version orchestration. Routes mirror main.rs:56-70.
//
// Build: make -C polyrl_tpu/manager/cpp   (→ polyrl-manager)

#include <signal.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>

#include "config.h"
#include "http.h"
#include "json.h"
#include "state.h"
#include "utils.h"

namespace manager {

using pjson::Array;
using pjson::Object;
using pjson::Value;

static void log_line(const std::string& msg) {
  // called from every worker/health/stats thread: localtime() hands back a
  // shared static buffer (TSAN-confirmed race) — use the reentrant form
  auto now = std::chrono::system_clock::to_time_t(std::chrono::system_clock::now());
  struct tm tm_buf;
  localtime_r(&now, &tm_buf);
  char buf[32];
  strftime(buf, sizeof(buf), "%H:%M:%S", &tm_buf);
  fprintf(stderr, "[manager %s] %s\n", buf, msg.c_str());
}

// Trace-context propagation (obs/trace.py): the trainer's client sends
// X-Trace-Id/X-Span-Id; the value is sanitized hard (it rides into log
// lines, response headers, and forwarded JSON) — anything outside
// [A-Za-z0-9._-] is dropped, length capped.
static std::string sanitize_trace(const std::string& raw) {
  std::string out;
  out.reserve(raw.size());
  for (char c : raw) {
    if (isalnum(static_cast<unsigned char>(c)) || c == '.' || c == '_' ||
        c == '-')
      out += c;
    if (out.size() >= 64) break;
  }
  return out;
}

static std::string header_of(const phttp::Request& req, const std::string& key) {
  auto it = req.headers.find(key);  // parsed keys are lowercased
  return it == req.headers.end() ? std::string() : sanitize_trace(it->second);
}

class Manager {
 public:
  explicit Manager(Config cfg)
      : cfg_(std::move(cfg)), state_(cfg_.max_assigned_batches_per_stats_check),
        gen_pool_(static_cast<size_t>(std::max(cfg_.generate_workers, 1))) {
    state_.balance.set_initial_gen_s(cfg_.initial_local_gen_s);
  }

  AppState& state() { return state_; }
  const Config& config() const { return cfg_; }

  // ---- generation with eviction + token-level continuation -------------
  // (reference process_single_generate_request, handlers.rs:330-418)

  // Per-chunk progress hook (token-level continuous generation): invoked
  // with each merged engine chunk so the batch stream can forward decoded
  // tokens to the trainer AS THEY ARRIVE. Without it, tokens accumulated
  // here die with this process on a SIGKILL and the trainer restarts the
  // whole request from token 0.
  using ProgressFn = std::function<void(const Value& chunk)>;

  Value process_generate(const Value& request, int want_local = -1,
                         const std::string& trace_id = std::string(),
                         const std::string& parent_span = std::string(),
                         const ProgressFn& progress = ProgressFn()) {
    std::string rid = request["rid"].as_str();
    // group-shared prefill: members of one GRPO group must land on ONE
    // engine (group-affinity pin inside next_instance) or each split
    // sibling pays a fresh prompt prefill
    std::string group_id = request["group_id"].as_str();
    PartialResponse acc;
    // inject the trainer's trace context into the request we forward (and
    // into every continuation built from it) so the engine's spans join
    // the same trace the trainer opened
    Value base = request;
    if (!trace_id.empty()) {
      pjson::Object o = base.as_obj();
      o["trace_id"] = Value(trace_id);
      o["parent_span"] = Value(parent_span);
      base = Value(std::move(o));
    }
    Value current = base;
    // the instance whose abort ended the last attempt: the next attempt
    // goes elsewhere when another instance is eligible
    std::string avoid;
    for (int attempt = 0; attempt < cfg_.max_generate_attempts; ++attempt) {
      InstancePtr inst = state_.next_instance(want_local,
                                              cfg_.schedule_wait_timeout_ms,
                                              group_id, avoid);
      if (!inst) {
        // Busy pool ≠ dead pool: while any healthy/pending instance exists
        // the request requeues without burning a retry attempt (matching the
        // reference's indefinitely-blocking scheduler, state.rs:84-147) —
        // a transiently busy pool must never destroy training data. Only an
        // actually empty pool (every instance evicted/unhealthy) fails.
        if (!state_.is_shutdown() && state_.has_prospective_instances()) {
          log_line("scheduler starved (pool busy), requeueing rid " + rid);
          --attempt;
          continue;
        }
        return error_response(rid, "no instance available");
      }
      // per-attempt rid suffix: engine-side request keys must be unique even
      // when a retry races the dying previous attempt's cleanup (fresh
      // Object: pjson copies alias the shared map)
      pjson::Object req_obj = current.as_obj();
      req_obj["rid"] = Value(rid + "#a" + std::to_string(attempt));
      Value attempt_req(std::move(req_obj));
      StreamEnd end = stream_from_instance(inst, attempt_req, acc, progress);
      // assigned_batches is a RATE quota: incremented on assignment, zeroed
      // by the stats tick — never decremented (reference state.rs:84-147).
      state_.notify_available();
      if (end == StreamEnd::kFinished) return build_final_response(rid, acc);
      // Only a transport/decode failure evicts, and only a remote instance
      // (shutdown + deregister); locals fail by abort during time-slicing,
      // not by dying. An abort terminal is a preemption (time slice, drain,
      // /abort_request): the engine is healthy and keeps its place, the
      // request continues elsewhere. A REQUEST-level engine error
      // (finish_reason=error) retries without eviction — one bad request
      // must not shut down up to max_generate_attempts healthy engines.
      if (end == StreamEnd::kTransportFailure && !inst->is_local) {
        log_line("evicting instance " + inst->endpoint + " after stream failure");
        state_.evict(inst->endpoint);
        std::string ep = inst->endpoint;
        std::thread([ep] { phttp::request("POST", ep, "/shutdown", "{}", 2000); }).detach();
      }
      avoid = end == StreamEnd::kAborted ? inst->endpoint : std::string();
      if (!acc.token_ids.empty()) {
        current = build_continuation_request(base, acc);
      }
    }
    if (!acc.token_ids.empty()) {
      // give the trainer what we have (partial, marked abort)
      acc.finished = false;
      acc.finish_reason = "abort";
      return build_final_response(rid, acc);
    }
    return error_response(rid, "max attempts exhausted");
  }

  // How one attempt's stream ended. kAborted and kRequestError come from
  // a healthy engine (a terminal line it wrote); kTransportFailure is a
  // connect/read/decode failure or a stream that ended unfinished.
  enum class StreamEnd { kFinished, kAborted, kRequestError, kTransportFailure };

  // Stream one attempt into ``acc``.
  StreamEnd stream_from_instance(const InstancePtr& inst, const Value& request,
                                 PartialResponse& acc,
                                 const ProgressFn& progress = ProgressFn()) {
    constexpr StreamEnd kFail = StreamEnd::kTransportFailure;
    std::string host;
    int port;
    if (!phttp::split_endpoint(inst->endpoint, host, port)) return kFail;
    phttp::ClientConn conn;
    if (!conn.connect(host, port, cfg_.generate_timeout_ms)) return kFail;
    // fresh top-level object: pjson::Value copies alias the shared Object,
    // so set() on a plain copy would mutate the caller's request.
    pjson::Object req_obj = request.as_obj();
    req_obj["stream"] = Value(true);
    Value req(std::move(req_obj));
    if (!conn.send_request("POST", host, "/generate", req.dump())) return kFail;
    int status = 0;
    if (!conn.read_header(status) || status != 200) return kFail;
    std::string line;
    while (conn.read_line(line)) {
      if (line.empty()) continue;
      // accept SGLang-style "data: {...}" or bare NDJSON
      if (line.rfind("data:", 0) == 0) line = line.substr(5);
      bool ok = false;
      Value chunk = pjson::Parser::parse(line, &ok);
      if (!ok) return kFail;  // decode error → eviction path
      if (chunk["finish_reason"].as_str() == "abort") {
        // abort = preemption; the terminal line may CARRY salvaged tokens
        // (a salvage-enabled engine drains its pipeline into the partial)
        merge_chunk(acc, chunk);
        if (progress && !chunk["token_ids"].as_arr().empty()) progress(chunk);
        acc.finished = false;  // abort = time-slice preemption → continue elsewhere
        acc.finish_reason.clear();
        return StreamEnd::kAborted;
      }
      if (chunk["finish_reason"].as_str() == "error") {
        // engine-reported failure (e.g. duplicate rid, prefill error): the
        // attempt failed — retry on another instance. Treating it as a
        // finished stream would return success with an empty completion
        // and silently poison the training batch.
        return StreamEnd::kRequestError;
      }
      merge_chunk(acc, chunk);
      if (progress && !chunk["token_ids"].as_arr().empty()) progress(chunk);
      if (acc.finished) return StreamEnd::kFinished;
    }
    return acc.finished ? StreamEnd::kFinished : kFail;
  }

  // ---- batch generate: NDJSON stream with time-sliced local engines ----
  // (reference timed_batch_generate_requests, handlers.rs:442-564)

  void batch_generate(const Value& body, phttp::ResponseWriter& rw,
                      const std::string& trace_id = std::string(),
                      const std::string& parent_span = std::string()) {
    const Array& requests = body["requests"].as_arr();
    double max_local_gen_s = body["max_local_gen_s"].is_num()
                                 ? body["max_local_gen_s"].as_num()
                                 : state_.balance.max_local_gen_s();
    auto t_start = std::chrono::steady_clock::now();

    rw.content_type = "application/x-ndjson";
    if (!rw.start_stream()) return;
    // first line = notifier: the batch was accepted (the trainer's local
    // engines may now context-switch, stream_batch_iter.py:41-43)
    rw.write_chunk("{\"type\":\"notifier\"}\n");

    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::string> ready;
    size_t remaining = requests.size();
    std::atomic<int64_t> total_resp_tokens{0};

    // time-slice watchdog: after the local window, pull local engines from
    // the pool and abort their in-flight requests (handlers.rs:500-513).
    // Started BEFORE the submit loop — submit can block on gen-pool
    // backpressure, and the window is promised from batch start.
    std::atomic<bool> batch_done{false};
    std::thread watchdog([this, max_local_gen_s, &batch_done] {
      double waited = 0;
      while (!batch_done.load() && waited < max_local_gen_s) {
        std::this_thread::sleep_for(std::chrono::milliseconds(200));
        waited += 0.2;
      }
      if (batch_done.load()) return;
      auto locals = state_.remove_local_from_active();
      for (auto& inst : locals) {
        log_line("time-slice: aborting local instance " + inst->endpoint +
                 " after " + std::to_string(max_local_gen_s) + "s");
        phttp::request("POST", inst->endpoint, "/abort_request", "{\"abort_all\":true}", 2000);
      }
    });

    // bounded request concurrency via the shared generate pool (round-1
    // finding: thread-per-request was unbounded). submit() applies
    // backpressure when the pool queue fills; results drain concurrently
    // below, so a huge batch just streams through generate_workers at a
    // time. Everything the task touches stays alive until remaining == 0,
    // which the drain loop waits for before returning.
    for (const auto& r : requests) {
      bool ok = gen_pool_.submit(
          [this, r, trace_id, parent_span, &mu, &cv, &ready, &remaining,
           &total_resp_tokens] {
            // token-level progress forwarding: every merged engine chunk
            // becomes a {"type":"progress"} NDJSON line on the trainer
            // stream, so the trainer's salvage ledger survives a manager
            // death — it re-issues prompt+salvaged instead of re-decoding
            const std::string rid = r["rid"].as_str();
            ProgressFn progress = [rid, &mu, &cv, &ready](const Value& chunk) {
              Object o;
              o["type"] = Value("progress");
              o["rid"] = Value(rid);
              o["token_ids"] = chunk["token_ids"];
              o["logprobs"] = chunk["logprobs"];
              o["weight_version"] = Value(chunk["weight_version"].as_int(-1));
              std::lock_guard<std::mutex> g(mu);
              ready.push_back(Value(std::move(o)).dump() + "\n");
              cv.notify_all();
            };
            Value resp = process_generate(r, -1, trace_id, parent_span,
                                          progress);
            total_resp_tokens += resp["completion_tokens"].as_int();
            std::lock_guard<std::mutex> g(mu);
            ready.push_back(resp.dump() + "\n");
            --remaining;
            cv.notify_all();
          });
      if (!ok) {  // pool stopped (shutdown): account the request as failed
        std::string rid = r["rid"].as_str();
        std::lock_guard<std::mutex> g(mu);
        ready.push_back(error_response(rid, "manager shutdown").dump() + "\n");
        --remaining;
        cv.notify_all();
      }
    }

    // drain results to the trainer as they finish
    {
      std::unique_lock<std::mutex> lk(mu);
      while (remaining > 0 || !ready.empty()) {
        cv.wait(lk, [&] { return !ready.empty() || remaining == 0; });
        while (!ready.empty()) {
          std::string line = std::move(ready.front());
          ready.pop_front();
          lk.unlock();
          rw.write_chunk(line);
          lk.lock();
        }
      }
    }
    batch_done = true;
    watchdog.join();

    double total_s = std::chrono::duration<double>(
                         std::chrono::steady_clock::now() - t_start).count();
    double mean_len = requests.empty() ? 0.0
                          : static_cast<double>(total_resp_tokens.load()) /
                                static_cast<double>(requests.size());
    state_.balance.record_generation(total_s, std::min(total_s, max_local_gen_s), mean_len);
  }

  // ---- background workers ---------------------------------------------

  // Stats poll doubles as the pool HEARTBEAT: every registered healthy
  // instance (not just the active routing set — drained/updating engines
  // still need death detection) is probed each tick. A poll answer resets
  // the miss counter and feeds the scheduler's load/version view; it also
  // carries the engine's own "draining" announcement (preemption notice →
  // out of the routing set before the next batch routes to it). A REMOTE
  // instance missing cfg.heartbeat_failures consecutive polls is EVICTED —
  // an engine that died WITHOUT notice; its in-flight rids fail their
  // streams and continue on survivors through the salvage path.
  void start_stats_poller() {
    stats_thread_ = std::thread([this] {
      while (!state_.is_shutdown()) {
        for (auto& inst : state_.all_instances()) {
          if (!inst->healthy.load()) continue;  // pending: own health check
          auto resp = phttp::request("GET", inst->endpoint, "/get_server_info", "", 2000);
          bool parsed = false;
          if (resp.ok()) {
            Value info = pjson::Parser::parse(resp.body, &parsed);
            if (parsed) {
              inst->heartbeat_misses = 0;
              inst->num_running_reqs = info["num_running_reqs"].as_int();
              inst->num_queued_reqs = info["num_queued_reqs"].as_int();
              inst->last_gen_throughput = info["last_gen_throughput"].as_num();
              // engine flight-deck forwarding: optional fields (absent on
              // pre-flight-deck engines) — only overwrite when reported
              auto fwd = [&](const char* key, std::atomic<double>& dst) {
                if (info[key].is_num()) dst = info[key].as_num();
              };
              fwd("occupancy", inst->occupancy);
              fwd("page_util", inst->page_util);
              fwd("ttft_p95_s", inst->ttft_p95_s);
              fwd("tpot_p95_s", inst->tpot_p95_s);
              fwd("prefix_cache/hit_rate", inst->cache_hit_rate);
              fwd("spec_accept_rate", inst->spec_accept_rate);
              fwd("attributed_frac", inst->attributed_frac);
              fwd("prefill_reuse_frac", inst->prefill_reuse_frac);
              fwd("prefix_hit_frac", inst->prefix_hit_frac);
              // KV memory plane: cold residency + HBM headroom. Absent on
              // ledger-off / CPU engines — headroom keeps its -1 sentinel
              fwd("kv_cold_page_frac", inst->kv_cold_page_frac);
              fwd("hbm_headroom_gb", inst->hbm_headroom_gb);
              // host-RAM spill tier: paged-out fraction + restore rate
              // (absent on spill-off engines — atomics keep their zeros)
              fwd("kv_spilled_frac", inst->kv_spilled_frac);
              fwd("kv_restore_rate", inst->kv_restore_rate);
              // engine-loop profiler: device-vs-host wall split (absent on
              // loop_profile-off engines — device_frac keeps its -1
              // sentinel)
              fwd("device_frac", inst->device_frac);
              fwd("accounting_frac", inst->accounting_frac);
              if (info["draining"].as_bool() && !inst->draining.load()) {
                log_line("instance " + inst->endpoint +
                         " announced draining; leaving routing set");
                state_.mark_draining(inst->endpoint);
              }
              // monotonic version raise from the engine's own report —
              // re-admits a caught-up engine the weight plane lost track of
              if (info["weight_version"].is_num())
                state_.set_instance_version(inst->endpoint,
                                            info["weight_version"].as_int());
            }
          }
          if (!parsed) {
            int64_t misses = inst->heartbeat_misses.fetch_add(1) + 1;
            if (cfg_.heartbeat_failures > 0 && !inst->is_local &&
                misses >= cfg_.heartbeat_failures) {
              log_line("evicting instance " + inst->endpoint + " after " +
                       std::to_string(misses) + " heartbeat misses");
              state_.evict(inst->endpoint);
            }
          }
        }
        state_.reset_quotas();
        std::this_thread::sleep_for(std::chrono::milliseconds(
            static_cast<int>(cfg_.stats_poll_interval_s * 1000)));
      }
    });
  }

  void health_check_async(const std::string& endpoint) {
    std::thread([this, endpoint] {
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::duration<double>(cfg_.health_check_deadline_s);
      while (std::chrono::steady_clock::now() < deadline && !state_.is_shutdown()) {
        auto resp = phttp::request("GET", endpoint, "/health_generate", "", 3000);
        if (resp.ok()) {
          state_.promote_healthy(endpoint);
          log_line("instance healthy: " + endpoint);
          return;
        }
        std::this_thread::sleep_for(std::chrono::duration<double>(cfg_.health_check_interval_s));
      }
      log_line("health check deadline exceeded: " + endpoint);
      state_.deregister(endpoint);
    }).detach();
  }

  void join() {
    if (stats_thread_.joinable()) stats_thread_.join();
  }

  // ---- request accounting (per-route totals for /metrics) --------------

  void count_request(const std::string& path) {
    std::lock_guard<std::mutex> g(hits_mu_);
    ++route_hits_[path];
  }

  std::map<std::string, long> route_hits() {
    std::lock_guard<std::mutex> g(hits_mu_);
    return route_hits_;
  }

 private:
  Config cfg_;
  AppState state_;
  phttp::WorkerPool gen_pool_;
  std::thread stats_thread_;
  std::map<std::string, long> route_hits_;
  std::mutex hits_mu_;
};

// ---- route registration ----------------------------------------------------

void register_routes(phttp::Server& server, Manager& mgr) {
  auto& state = mgr.state();
  // sender/registration ACL (reference utils.rs:303-339): parsed once at
  // route setup; shared by value into the handlers (immutable after).
  const std::vector<Cidr> sender_acl = mgr.config().sender_acl();
  auto acl_reject = [sender_acl](const phttp::Request& req,
                                 phttp::ResponseWriter& rw) -> bool {
    if (ip_allowed(req.peer_ip, sender_acl)) return false;
    log_line("403 " + req.method + " " + req.path +
             " from disallowed ip " + req.peer_ip);
    rw.status = 403;
    rw.body = "{\"error\":\"sender ip not in allowed_sender_ips\"}";
    return true;
  };

  // request observer: per-route totals (exposed at /metrics) + trace-id
  // echo into the response headers + request log, so a trainer-side span
  // can be matched against the manager's own log without guessing.
  server.set_observer([&mgr](const phttp::Request& req,
                             phttp::ResponseWriter& rw) {
    mgr.count_request(req.path);
    std::string trace = header_of(req, "x-trace-id");
    if (trace.empty()) return;
    rw.extra_headers += "X-Trace-Id: " + trace + "\r\n";
    if (req.path == "/generate" || req.path == "/batch_generate_requests" ||
        req.path == "/update_weight_version")
      log_line(req.method + " " + req.path + " trace=" + trace);
  });

  server.route("GET", "/health", [](const phttp::Request&, phttp::ResponseWriter& rw) {
    rw.body = "{\"status\":\"ok\"}";
  });

  server.route("GET", "/get_instances_status",
               [&](const phttp::Request&, phttp::ResponseWriter& rw) {
    Array arr;
    for (auto& inst : state.all_instances()) {
      Object o;
      o["endpoint"] = Value(inst->endpoint);
      o["is_local"] = Value(inst->is_local);
      o["healthy"] = Value(inst->healthy.load());
      o["updating_weight"] = Value(inst->updating_weight.load());
      o["weight_version"] = Value(inst->weight_version.load());
      o["num_running_reqs"] = Value(inst->num_running_reqs.load());
      o["num_queued_reqs"] = Value(inst->num_queued_reqs.load());
      o["weight_sender"] = Value(inst->weight_sender);
      o["group_idx"] = Value(inst->group_idx);
      o["draining"] = Value(inst->draining.load());
      o["heartbeat_misses"] = Value(inst->heartbeat_misses.load());
      o["active"] = Value(state.is_active(inst->endpoint));
      o["last_gen_throughput"] = Value(inst->last_gen_throughput.load());
      o["occupancy"] = Value(inst->occupancy.load());
      o["page_util"] = Value(inst->page_util.load());
      o["ttft_p95_s"] = Value(inst->ttft_p95_s.load());
      o["tpot_p95_s"] = Value(inst->tpot_p95_s.load());
      o["cache_hit_rate"] = Value(inst->cache_hit_rate.load());
      o["spec_accept_rate"] = Value(inst->spec_accept_rate.load());
      o["attributed_frac"] = Value(inst->attributed_frac.load());
      o["prefill_reuse_frac"] = Value(inst->prefill_reuse_frac.load());
      o["prefix_hit_frac"] = Value(inst->prefix_hit_frac.load());
      o["kv_cold_page_frac"] = Value(inst->kv_cold_page_frac.load());
      // -1 sentinels "engine never reported headroom" (CPU / ledger off);
      // omitting the key keeps the fleet min from counting it as 0 GB
      if (inst->hbm_headroom_gb.load() >= 0.0)
        o["hbm_headroom_gb"] = Value(inst->hbm_headroom_gb.load());
      o["kv_spilled_frac"] = Value(inst->kv_spilled_frac.load());
      o["kv_restore_rate"] = Value(inst->kv_restore_rate.load());
      // -1 sentinels "engine never reported a loop profile" (loop_profile
      // off / pre-profiler); omitting the key keeps the fleet min honest
      if (inst->device_frac.load() >= 0.0) {
        o["device_frac"] = Value(inst->device_frac.load());
        o["accounting_frac"] = Value(inst->accounting_frac.load());
      }
      arr.push_back(Value(std::move(o)));
    }
    Object top;
    top["instances"] = Value(std::move(arr));
    top["weight_version"] = Value(state.weight_version());
    top["max_local_gen_s"] = Value(state.balance.max_local_gen_s());
    auto pc = state.pool_counts();
    Object pool;
    pool["joins"] = Value(pc.joins);
    pool["evictions"] = Value(pc.evictions);
    pool["drain_departures"] = Value(pc.drain_departures);
    pool["active"] = Value(pc.active);
    pool["pending"] = Value(pc.pending);
    pool["registered"] = Value(pc.registered);
    top["pool"] = Value(std::move(pool));
    rw.body = Value(std::move(top)).dump();
  });

  // Prometheus text exposition for ops scrapers: pool-level gauges plus
  // per-instance queue depths labeled by endpoint (the same data
  // /get_instances_status serves as JSON).
  server.route("GET", "/metrics",
               [&](const phttp::Request&, phttp::ResponseWriter& rw) {
    // label values per the Prometheus text format: escape \, " and
    // newline — endpoints arrive via the unauthenticated registration
    // route and must not be able to inject metric lines
    auto esc = [](const std::string& s) {
      std::string out;
      out.reserve(s.size());
      for (char c : s) {
        if (c == '\\') out += "\\\\";
        else if (c == '"') out += "\\\"";
        else if (c == '\n') out += "\\n";
        else out += c;
      }
      return out;
    };
    auto insts = state.all_instances();
    long healthy = 0, local_n = 0, running = 0, queued = 0;
    double occ_sum = 0.0, page_util_max = 0.0, tput_sum = 0.0;
    long occ_n = 0;
    std::string per;
    for (auto& inst : insts) {
      if (inst->healthy.load()) healthy++;
      if (inst->is_local) local_n++;
      long r = inst->num_running_reqs.load();
      long q = inst->num_queued_reqs.load();
      running += r;
      queued += q;
      per += "polyrl_mgr_instance_running_reqs{endpoint=\"" +
             esc(inst->endpoint) + "\"} " + std::to_string(r) + "\n";
      per += "polyrl_mgr_instance_queued_reqs{endpoint=\"" +
             esc(inst->endpoint) + "\"} " + std::to_string(q) + "\n";
      // engine flight-deck per-instance load view (the "why is decode
      // occupancy low on engine 3" answer, labeled by endpoint)
      per += "polyrl_mgr_instance_occupancy{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->occupancy.load()) + "\n";
      per += "polyrl_mgr_instance_page_util{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->page_util.load()) + "\n";
      per += "polyrl_mgr_instance_ttft_p95_s{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->ttft_p95_s.load()) + "\n";
      // KV memory plane per-instance view: which engine's resident set is
      // going cold, and who is closest to HBM exhaustion (-1 = unreported)
      per += "polyrl_mgr_instance_kv_cold_page_frac{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->kv_cold_page_frac.load()) + "\n";
      if (inst->hbm_headroom_gb.load() >= 0.0)
        per += "polyrl_mgr_instance_hbm_headroom_gb{endpoint=\"" +
               esc(inst->endpoint) + "\"} " +
               std::to_string(inst->hbm_headroom_gb.load()) + "\n";
      // host-RAM spill tier: who has KV paged out, and who is thrashing
      per += "polyrl_mgr_instance_kv_spilled_frac{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->kv_spilled_frac.load()) + "\n";
      per += "polyrl_mgr_instance_kv_restore_rate{endpoint=\"" +
             esc(inst->endpoint) + "\"} " +
             std::to_string(inst->kv_restore_rate.load()) + "\n";
      // engine-loop profiler: whose loop thread stopped feeding the chip,
      // and whose bookkeeping is eating the loop (-1 = unreported)
      if (inst->device_frac.load() >= 0.0) {
        per += "polyrl_mgr_instance_device_frac{endpoint=\"" +
               esc(inst->endpoint) + "\"} " +
               std::to_string(inst->device_frac.load()) + "\n";
        per += "polyrl_mgr_instance_accounting_frac{endpoint=\"" +
               esc(inst->endpoint) + "\"} " +
               std::to_string(inst->accounting_frac.load()) + "\n";
      }
      if (inst->healthy.load()) {
        occ_sum += inst->occupancy.load();
        ++occ_n;
        if (inst->page_util.load() > page_util_max)
          page_util_max = inst->page_util.load();
        tput_sum += inst->last_gen_throughput.load();
      }
    }
    std::string body;
    body += "# TYPE polyrl_mgr_instances gauge\npolyrl_mgr_instances " +
            std::to_string((long)insts.size()) + "\n";
    body += "# TYPE polyrl_mgr_instances_healthy gauge\n"
            "polyrl_mgr_instances_healthy " + std::to_string(healthy) + "\n";
    body += "# TYPE polyrl_mgr_instances_local gauge\n"
            "polyrl_mgr_instances_local " + std::to_string(local_n) + "\n";
    body += "# TYPE polyrl_mgr_weight_version counter\n"
            "polyrl_mgr_weight_version " +
            std::to_string(state.weight_version()) + "\n";
    body += "# TYPE polyrl_mgr_max_local_gen_s gauge\n"
            "polyrl_mgr_max_local_gen_s " +
            std::to_string(state.balance.max_local_gen_s()) + "\n";
    auto pc = state.pool_counts();
    body += "# TYPE polyrl_mgr_pool_joins counter\npolyrl_mgr_pool_joins " +
            std::to_string(pc.joins) + "\n";
    body += "# TYPE polyrl_mgr_pool_evictions counter\n"
            "polyrl_mgr_pool_evictions " + std::to_string(pc.evictions) + "\n";
    body += "# TYPE polyrl_mgr_pool_drain_departures counter\n"
            "polyrl_mgr_pool_drain_departures " +
            std::to_string(pc.drain_departures) + "\n";
    body += "# TYPE polyrl_mgr_pool_active gauge\npolyrl_mgr_pool_active " +
            std::to_string(pc.active) + "\n";
    body += "# TYPE polyrl_mgr_pool_pending gauge\npolyrl_mgr_pool_pending " +
            std::to_string(pc.pending) + "\n";
    body += "# TYPE polyrl_mgr_running_reqs gauge\npolyrl_mgr_running_reqs " +
            std::to_string(running) + "\n";
    body += "# TYPE polyrl_mgr_queued_reqs gauge\npolyrl_mgr_queued_reqs " +
            std::to_string(queued) + "\n";
    // fleet flight-deck aggregates: mean occupancy over healthy engines,
    // worst page-pool pressure, summed decode throughput
    body += "# TYPE polyrl_mgr_fleet_occupancy gauge\n"
            "polyrl_mgr_fleet_occupancy " +
            std::to_string(occ_n ? occ_sum / occ_n : 0.0) + "\n";
    body += "# TYPE polyrl_mgr_fleet_page_util gauge\n"
            "polyrl_mgr_fleet_page_util " + std::to_string(page_util_max) +
            "\n";
    body += "# TYPE polyrl_mgr_fleet_throughput_tok_s gauge\n"
            "polyrl_mgr_fleet_throughput_tok_s " + std::to_string(tput_sum) +
            "\n";
    body += "# TYPE polyrl_mgr_instance_running_reqs gauge\n";
    body += "# TYPE polyrl_mgr_instance_queued_reqs gauge\n";
    body += "# TYPE polyrl_mgr_instance_occupancy gauge\n";
    body += "# TYPE polyrl_mgr_instance_page_util gauge\n";
    body += "# TYPE polyrl_mgr_instance_ttft_p95_s gauge\n";
    body += "# TYPE polyrl_mgr_instance_kv_cold_page_frac gauge\n";
    body += "# TYPE polyrl_mgr_instance_hbm_headroom_gb gauge\n";
    body += "# TYPE polyrl_mgr_instance_kv_spilled_frac gauge\n";
    body += "# TYPE polyrl_mgr_instance_kv_restore_rate gauge\n";
    body += "# TYPE polyrl_mgr_instance_device_frac gauge\n";
    body += "# TYPE polyrl_mgr_instance_accounting_frac gauge\n";
    body += per;
    long total_reqs = 0;
    std::string per_route;
    for (const auto& kv : mgr.route_hits()) {
      total_reqs += kv.second;
      per_route += "polyrl_mgr_requests_total{path=\"" + esc(kv.first) +
                   "\"} " + std::to_string(kv.second) + "\n";
    }
    // unlabeled total: the trainer's per-step scrape merges only unlabeled
    // series into step records (obs/scrape.py)
    body += "# TYPE polyrl_mgr_requests counter\npolyrl_mgr_requests " +
            std::to_string(total_reqs) + "\n";
    body += "# TYPE polyrl_mgr_requests_total counter\n";
    body += per_route;
    rw.content_type = "text/plain; version=0.0.4";
    rw.body = body;
  });

  server.route("POST", "/register_rollout_instance",
               [&, acl_reject](const phttp::Request& req, phttp::ResponseWriter& rw) {
    if (acl_reject(req, rw)) return;
    Value body = pjson::Parser::parse(req.body);
    std::string endpoint = body["endpoint"].as_str();
    if (endpoint.empty()) { rw.status = 400; rw.body = "{\"error\":\"endpoint required\"}"; return; }
    auto [sender, group] = state.register_instance(endpoint, false);
    mgr.health_check_async(endpoint);
    Object o;
    o["weight_sender_endpoint"] = Value(sender);
    o["group_idx"] = Value(group);
    rw.body = Value(std::move(o)).dump();
    log_line("registered remote instance " + endpoint);
  });

  // Graceful leave (scale-down as a drill): the engine — or the pool
  // manager running a preemption drill — announces departure AFTER
  // draining. ``drained=true`` books it as a drain departure rather than
  // an eviction; idempotent (an already-forgotten endpoint is a no-op).
  server.route("POST", "/deregister_rollout_instance",
               [&, acl_reject](const phttp::Request& req, phttp::ResponseWriter& rw) {
    if (acl_reject(req, rw)) return;
    Value body = pjson::Parser::parse(req.body);
    std::string endpoint = body["endpoint"].as_str();
    if (endpoint.empty()) { rw.status = 400; rw.body = "{\"error\":\"endpoint required\"}"; return; }
    bool known = state.has_instance(endpoint);
    if (known) state.leave(endpoint, body["drained"].as_bool());
    Object o;
    o["status"] = Value("ok");
    o["removed"] = Value(known);
    rw.body = Value(std::move(o)).dump();
    log_line("deregistered instance " + endpoint +
             (body["drained"].as_bool() ? " (drained)" : ""));
  });

  server.route("POST", "/register_local_rollout_instances",
               [&, acl_reject](const phttp::Request& req, phttp::ResponseWriter& rw) {
    if (acl_reject(req, rw)) return;
    Value body = pjson::Parser::parse(req.body);
    for (const auto& ep : body["endpoints"].as_arr())
      state.register_instance(ep.as_str(), true);
    rw.body = "{\"status\":\"ok\"}";
  });

  // Idempotent bulk re-registration for supervisor replay after a respawn
  // (supervisor.py): already-known endpoints are left untouched (no
  // pending-state reset, no double health check), the weight version is
  // only ever RAISED (raise_weight_version_floor — no drain), and senders
  // are re-installed before instances so re-registrations get sender
  // assignments. Safe to call any number of times.
  server.route("POST", "/reconcile",
               [&, acl_reject](const phttp::Request& req, phttp::ResponseWriter& rw) {
    if (acl_reject(req, rw)) return;
    Value body = pjson::Parser::parse(req.body);
    if (body["senders"].is_arr() && !body["senders"].as_arr().empty()) {
      std::vector<std::string> senders;
      for (const auto& s : body["senders"].as_arr()) senders.push_back(s.as_str());
      int groups = static_cast<int>(body["groups_per_sender"].as_int(
          mgr.config().groups_per_sender));
      state.set_weight_senders(std::move(senders), groups);
    }
    int64_t version = state.raise_weight_version_floor(
        body["weight_version"].as_int(0));
    int64_t added_remote = 0, added_local = 0, kept = 0;
    for (const auto& epv : body["remote_endpoints"].as_arr()) {
      const std::string ep = epv.as_str();
      if (ep.empty()) continue;
      if (state.has_instance(ep)) { ++kept; continue; }
      state.register_instance(ep, false);
      mgr.health_check_async(ep);
      ++added_remote;
    }
    for (const auto& epv : body["local_endpoints"].as_arr()) {
      const std::string ep = epv.as_str();
      if (ep.empty()) continue;
      if (state.has_instance(ep)) { ++kept; continue; }
      state.register_instance(ep, true);
      ++added_local;
    }
    // pool-membership replay: each engine's last-known weight version.
    // Without this a respawned manager sees every replayed engine at -1,
    // gates the whole (healthy, caught-up) fleet behind a redundant weight
    // bootstrap, and orphans it if no sender ever re-pushes. Monotonic and
    // bootstrap-gated inside set_instance_version, so a double replay (or
    // a stale one) is a no-op.
    if (body["instance_versions"].is_obj()) {
      for (const auto& [ep, ver] : body["instance_versions"].as_obj())
        state.set_instance_version(ep, ver.as_int(-1));
    }
    Object o;
    o["status"] = Value("ok");
    o["added_remote"] = Value(added_remote);
    o["added_local"] = Value(added_local);
    o["kept"] = Value(kept);
    o["weight_version"] = Value(version);
    rw.body = Value(std::move(o)).dump();
    log_line("reconcile: +" + std::to_string(added_remote) + " remote, +" +
             std::to_string(added_local) + " local, " + std::to_string(kept) +
             " kept, weight_version " + std::to_string(version));
  });

  server.route("POST", "/generate",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    Value body = pjson::Parser::parse(req.body);
    rw.body = mgr.process_generate(body, -1, header_of(req, "x-trace-id"),
                                   header_of(req, "x-span-id")).dump();
  });

  server.route("POST", "/batch_generate_requests",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    Value body = pjson::Parser::parse(req.body);
    mgr.batch_generate(body, rw, header_of(req, "x-trace-id"),
                       header_of(req, "x-span-id"));
  });

  server.route("POST", "/update_weight_version",
               [&](const phttp::Request&, phttp::ResponseWriter& rw) {
    int64_t v = state.update_weight_version();
    Object o;
    o["weight_version"] = Value(v);
    rw.body = Value(std::move(o)).dump();
    log_line("weight version -> " + std::to_string(v));
  });

  server.route("POST", "/get_receive_instances",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    Value body = pjson::Parser::parse(req.body);
    auto insts = state.get_receive_instances(body["sender"].as_str());
    Array arr;
    for (auto& inst : insts) {
      Object o;
      o["endpoint"] = Value(inst->endpoint);
      o["group_idx"] = Value(inst->group_idx);
      o["bootstrap"] = Value(inst->weight_version.load() < 0);
      arr.push_back(Value(std::move(o)));
    }
    Object top;
    top["instances"] = Value(std::move(arr));
    top["weight_version"] = Value(state.weight_version());
    rw.body = Value(std::move(top)).dump();
  });

  server.route("POST", "/update_weights",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    // transfer complete for these instances: tell each engine to load from
    // its receiver agent, then rejoin the pool (handlers.rs:681-795)
    Value body = pjson::Parser::parse(req.body);
    int64_t version = body["weight_version"].is_num() ? body["weight_version"].as_int()
                                                      : state.weight_version();
    Array results;
    for (const auto& epv : body["instances"].as_arr()) {
      std::string ep = epv.as_str();
      Object per;
      per["endpoint"] = Value(ep);
      auto resp = phttp::request("POST", ep, "/update_weights_from_agent",
                                 "{\"weight_version\":" + std::to_string(version) + "}",
                                 120000);
      if (resp.ok()) {
        state.complete_weight_update(ep, version);
        per["success"] = Value(true);
      } else {
        state.abort_weight_update(ep);
        per["success"] = Value(false);
      }
      results.push_back(Value(std::move(per)));
    }
    Object top;
    top["results"] = Value(std::move(results));
    rw.body = Value(std::move(top)).dump();
  });

  server.route("POST", "/abort_weight_update",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    // sender-side push failed (receiver missing / TCP error): clear the
    // updating_weight CAS so the instance is retried on the next sender
    // poll instead of being drained forever
    Value body = pjson::Parser::parse(req.body);
    for (const auto& epv : body["instances"].as_arr())
      state.abort_weight_update(epv.as_str());
    rw.body = "{\"status\":\"ok\"}";
  });

  server.route("PUT", "/update_weight_senders",
               [&, acl_reject](const phttp::Request& req, phttp::ResponseWriter& rw) {
    if (acl_reject(req, rw)) return;
    Value body = pjson::Parser::parse(req.body);
    std::vector<std::string> senders;
    for (const auto& s : body["senders"].as_arr()) senders.push_back(s.as_str());
    int groups = static_cast<int>(body["groups_per_sender"].as_int(mgr.config().groups_per_sender));
    state.set_weight_senders(std::move(senders), groups);
    rw.body = "{\"status\":\"ok\"}";
  });

  server.route("POST", "/shutdown_instances",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    Value body = pjson::Parser::parse(req.body);
    bool skip_updating = body["skip_if_updating_weights"].as_bool();
    int count = 0;
    for (auto& inst : state.all_instances()) {
      if (inst->is_local) continue;
      if (skip_updating && inst->updating_weight.load()) continue;
      phttp::request("POST", inst->endpoint, "/shutdown", "{}", 2000);
      state.deregister(inst->endpoint);
      ++count;
    }
    Object o;
    o["shutdown_count"] = Value(count);
    rw.body = Value(std::move(o)).dump();
  });

  server.route("POST", "/update_metrics",
               [&](const phttp::Request& req, phttp::ResponseWriter& rw) {
    Value body = pjson::Parser::parse(req.body);
    LoadBalanceState::StepStats s;
    s.step_time_s = body["step_time_s"].as_num();
    s.total_gen_time_s = body["total_gen_time_s"].is_num()
                             ? body["total_gen_time_s"].as_num()
                             : state.balance.last_total_gen_s();
    s.trainer_bubble_s = body["trainer_bubble_s"].as_num();
    s.throughput = body["throughput"].as_num();
    s.num_instances = static_cast<int>(body["num_instances"].as_int(
        static_cast<int64_t>(state.active_count())));
    double new_window = state.balance.update(s);
    Object o;
    o["max_local_gen_s"] = Value(new_window);
    o["num_instances"] = Value(static_cast<int64_t>(state.active_count()));
    rw.body = Value(std::move(o)).dump();
  });

  server.route("POST", "/abort_local_requests",
               [&](const phttp::Request&, phttp::ResponseWriter& rw) {
    auto locals = state.remove_local_from_active();
    for (auto& inst : locals)
      phttp::request("POST", inst->endpoint, "/abort_request", "{\"abort_all\":true}", 2000);
    Object o;
    o["aborted_instances"] = Value(static_cast<int64_t>(locals.size()));
    rw.body = Value(std::move(o)).dump();
  });

  server.route("POST", "/resume_local_instances",
               [&](const phttp::Request&, phttp::ResponseWriter& rw) {
    state.add_local_to_active();
    rw.body = "{\"status\":\"ok\"}";
  });
}

}  // namespace manager

int main(int argc, char** argv) {
  signal(SIGPIPE, SIG_IGN);
  manager::Config cfg;
  try {
    cfg = manager::load_config(argc, argv);
  } catch (const std::exception& e) {
    fprintf(stderr, "bad config: %s\n", e.what());
    return 1;
  }
  manager::Manager mgr(cfg);
  phttp::Server server(static_cast<size_t>(std::max(cfg.http_workers, 1)));
  manager::register_routes(server, mgr);

  std::string host;
  int port;
  if (!phttp::split_endpoint(cfg.bind_addr, host, port)) {
    fprintf(stderr, "bad --bind-addr %s\n", cfg.bind_addr.c_str());
    return 1;
  }
  int bound = server.listen(host, port);
  if (bound < 0) {
    fprintf(stderr, "failed to bind %s\n", cfg.bind_addr.c_str());
    return 1;
  }
  manager::log_line("listening on " + host + ":" + std::to_string(bound));
  printf("LISTENING %d\n", bound);
  fflush(stdout);
  mgr.start_stats_poller();
  server.serve();
  return 0;
}
