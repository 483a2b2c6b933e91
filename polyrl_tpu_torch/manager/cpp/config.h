// CLI + TOML-subset config (override order: CLI > file > default),
// mirroring the reference's config plane (SURVEY.md C16f, config.rs:6).
#pragma once

#include <arpa/inet.h>

#include <cstdint>
#include <fstream>
#include <map>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace manager {

// IPv4 CIDR filter for the sender/registration ACL (the reference enforces
// allowed_sender_ips on both sides, utils.rs:303-339). A bare IP parses as
// /32.
struct Cidr {
  uint32_t addr = 0;  // host byte order
  uint32_t mask = 0;

  bool contains(uint32_t ip) const { return (ip & mask) == (addr & mask); }
};

inline bool parse_ipv4(const std::string& s, uint32_t& out) {
  in_addr a{};
  if (inet_pton(AF_INET, s.c_str(), &a) != 1) return false;
  out = ntohl(a.s_addr);
  return true;
}

inline Cidr parse_cidr(const std::string& spec) {
  Cidr c;
  size_t slash = spec.find('/');
  std::string ip = slash == std::string::npos ? spec : spec.substr(0, slash);
  int bits = 32;
  if (slash != std::string::npos) {
    bits = std::stoi(spec.substr(slash + 1));
    if (bits < 0 || bits > 32) throw std::invalid_argument("bad CIDR " + spec);
  }
  if (!parse_ipv4(ip, c.addr)) throw std::invalid_argument("bad CIDR " + spec);
  c.mask = bits == 0 ? 0 : (~0u << (32 - bits));
  return c;
}

// empty allowlist = open (matches the reference default: the field is
// opt-in); otherwise the peer IP must fall inside one of the CIDRs.
inline bool ip_allowed(const std::string& peer_ip,
                       const std::vector<Cidr>& allow) {
  if (allow.empty()) return true;
  uint32_t ip = 0;
  if (!parse_ipv4(peer_ip, ip)) return false;
  for (const auto& c : allow)
    if (c.contains(ip)) return true;
  return false;
}

// `["a", "b"]` or bare `a,b` → vector of trimmed strings.
inline std::vector<std::string> parse_string_list(std::string v) {
  std::vector<std::string> out;
  if (!v.empty() && v.front() == '[' && v.back() == ']')
    v = v.substr(1, v.size() - 2);
  std::stringstream ss(v);
  std::string item;
  while (std::getline(ss, item, ',')) {
    size_t a = item.find_first_not_of(" \t\"'");
    size_t b = item.find_last_not_of(" \t\"'");
    if (a != std::string::npos) out.push_back(item.substr(a, b - a + 1));
  }
  return out;
}

struct Config {
  std::string bind_addr = "0.0.0.0:30000";
  int max_assigned_batches_per_stats_check = 4;
  double stats_poll_interval_s = 1.0;
  double health_check_interval_s = 2.0;
  double health_check_deadline_s = 300.0;
  // elastic pool: consecutive stats-poll misses before a REMOTE instance
  // is evicted (heartbeat-timeout death detection; locals are exempt —
  // they fail by time-slice abort, not by dying). 0 disables eviction.
  int heartbeat_failures = 3;
  int max_generate_attempts = 5;
  int generate_timeout_ms = 600000;
  int schedule_wait_timeout_ms = 120000;  // block on instance availability
  int groups_per_sender = 4;
  double initial_local_gen_s = 150.0;
  // bounded concurrency (reference: tokio runtime; round-1 finding):
  // connection workers serve HTTP (streaming batches hold one each);
  // generate workers bound concurrent per-request engine streams.
  int http_workers = 64;
  int generate_workers = 128;
  // CIDR allowlist enforced on PUT /update_weight_senders and instance
  // registration (empty = open; reference utils.rs:303-339)
  std::vector<std::string> allowed_sender_ips;

  std::vector<Cidr> sender_acl() const {
    std::vector<Cidr> out;
    for (const auto& s : allowed_sender_ips) out.push_back(parse_cidr(s));
    return out;
  }
};

// Minimal TOML subset: `key = value` lines; strings, ints, floats, bools,
// arrays of strings; [sections] flattened as "section.key".
inline std::map<std::string, std::string> parse_toml(const std::string& path) {
  std::map<std::string, std::string> out;
  std::ifstream f(path);
  std::string line, section;
  while (std::getline(f, line)) {
    size_t hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    auto trim = [](std::string s) {
      size_t a = s.find_first_not_of(" \t\r");
      size_t b = s.find_last_not_of(" \t\r");
      return a == std::string::npos ? std::string() : s.substr(a, b - a + 1);
    };
    line = trim(line);
    if (line.empty()) continue;
    if (line.front() == '[' && line.back() == ']') {
      section = trim(line.substr(1, line.size() - 2));
      continue;
    }
    size_t eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string key = trim(line.substr(0, eq));
    std::string val = trim(line.substr(eq + 1));
    if (val.size() >= 2 && val.front() == '"' && val.back() == '"')
      val = val.substr(1, val.size() - 2);
    out[(section.empty() ? key : section + "." + key)] = val;
  }
  return out;
}

inline Config load_config(int argc, char** argv) {
  Config cfg;
  std::string config_file;
  // pass 1: find --config-file
  for (int i = 1; i < argc - 1; ++i)
    if (std::string(argv[i]) == "--config-file") config_file = argv[i + 1];
  if (!config_file.empty()) {
    auto kv = parse_toml(config_file);
    auto get = [&](const std::string& k) -> const std::string* {
      auto it = kv.find(k);
      return it == kv.end() ? nullptr : &it->second;
    };
    if (auto* v = get("bind_addr")) cfg.bind_addr = *v;
    if (auto* v = get("max_assigned_batches_per_stats_check"))
      cfg.max_assigned_batches_per_stats_check = std::stoi(*v);
    if (auto* v = get("stats_poll_interval_s")) cfg.stats_poll_interval_s = std::stod(*v);
    if (auto* v = get("health_check_interval_s")) cfg.health_check_interval_s = std::stod(*v);
    if (auto* v = get("health_check_deadline_s")) cfg.health_check_deadline_s = std::stod(*v);
    if (auto* v = get("heartbeat_failures")) cfg.heartbeat_failures = std::stoi(*v);
    if (auto* v = get("max_generate_attempts")) cfg.max_generate_attempts = std::stoi(*v);
    if (auto* v = get("generate_timeout_ms")) cfg.generate_timeout_ms = std::stoi(*v);
    if (auto* v = get("schedule_wait_timeout_ms")) cfg.schedule_wait_timeout_ms = std::stoi(*v);
    if (auto* v = get("groups_per_sender")) cfg.groups_per_sender = std::stoi(*v);
    if (auto* v = get("initial_local_gen_s")) cfg.initial_local_gen_s = std::stod(*v);
    if (auto* v = get("http_workers")) cfg.http_workers = std::stoi(*v);
    if (auto* v = get("generate_workers")) cfg.generate_workers = std::stoi(*v);
    if (auto* v = get("allowed_sender_ips"))
      cfg.allowed_sender_ips = parse_string_list(*v);
  }
  // pass 2: CLI overrides
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    std::string v = argv[i + 1];
    if (a == "--bind-addr") cfg.bind_addr = v;
    else if (a == "--max-assigned-batches") cfg.max_assigned_batches_per_stats_check = std::stoi(v);
    else if (a == "--stats-poll-interval-s") cfg.stats_poll_interval_s = std::stod(v);
    else if (a == "--health-check-interval-s") cfg.health_check_interval_s = std::stod(v);
    else if (a == "--health-check-deadline-s") cfg.health_check_deadline_s = std::stod(v);
    else if (a == "--heartbeat-failures") cfg.heartbeat_failures = std::stoi(v);
    else if (a == "--max-generate-attempts") cfg.max_generate_attempts = std::stoi(v);
    else if (a == "--generate-timeout-ms") cfg.generate_timeout_ms = std::stoi(v);
    else if (a == "--schedule-wait-timeout-ms") cfg.schedule_wait_timeout_ms = std::stoi(v);
    else if (a == "--groups-per-sender") cfg.groups_per_sender = std::stoi(v);
    else if (a == "--initial-local-gen-s") cfg.initial_local_gen_s = std::stod(v);
    else if (a == "--http-workers") cfg.http_workers = std::stoi(v);
    else if (a == "--generate-workers") cfg.generate_workers = std::stoi(v);
    else if (a == "--allowed-sender-ips")
      cfg.allowed_sender_ips = parse_string_list(v);
  }
  cfg.sender_acl();  // fail fast on malformed CIDRs at startup, not first use
  return cfg;
}

}  // namespace manager
