// Minimal HTTP/1.1 server + client over POSIX sockets.
//
// Control-plane scale (tens of rollout instances, one trainer): a
// thread-per-connection blocking server is simpler and plenty — the data
// plane's heavy lifting (token streaming) is line-oriented proxying, which
// the client here exposes as a streaming line reader. Plays the role of
// axum/reqwest in the reference manager (SURVEY.md C16, main.rs:56-70).
#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "pool.h"

namespace phttp {

struct Request {
  std::string method;
  std::string path;     // without query
  std::string query;
  std::map<std::string, std::string> headers;
  std::string body;
  std::string peer_ip;  // dotted-quad of the connecting socket (for ACLs)
};

// Streaming response writer handed to handlers. Either set status+body and
// return, or call start_stream() then write_chunk() for chunked NDJSON.
class ResponseWriter {
 public:
  explicit ResponseWriter(int fd) : fd_(fd) {}

  int status = 200;
  std::string content_type = "application/json";
  std::string body;
  // extra response headers, each a full "Name: value\r\n" line (e.g. the
  // X-Trace-Id echo); emitted by both the plain and the streaming path
  std::string extra_headers;

  bool start_stream() {
    if (streaming_) return true;
    std::string head = "HTTP/1.1 200 OK\r\nContent-Type: " + content_type +
                       "\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n" +
                       extra_headers + "\r\n";
    if (!write_all(head.data(), head.size())) return false;
    streaming_ = true;
    return true;
  }

  bool write_chunk(const std::string& data) {
    if (data.empty()) return true;
    char len[32];
    snprintf(len, sizeof(len), "%zx\r\n", data.size());
    std::string chunk = std::string(len) + data + "\r\n";
    return write_all(chunk.data(), chunk.size());
  }

  void finish() {
    if (streaming_) {
      const char* end = "0\r\n\r\n";
      write_all(end, 5);
    } else {
      char head[256];
      const char* status_text = status == 200 ? "OK" : (status == 404 ? "Not Found" : (status == 403 ? "Forbidden" : (status >= 500 ? "Internal Server Error" : "Bad Request")));
      snprintf(head, sizeof(head),
               "HTTP/1.1 %d %s\r\nContent-Type: %s\r\nContent-Length: %zu\r\nConnection: close\r\n",
               status, status_text, content_type.c_str(), body.size());
      std::string full = std::string(head) + extra_headers + "\r\n";
      write_all(full.data(), full.size());
      write_all(body.data(), body.size());
    }
  }

  bool streaming() const { return streaming_; }

 private:
  bool write_all(const char* data, size_t len) {
    size_t off = 0;
    while (off < len) {
      ssize_t n = ::send(fd_, data + off, len - off, MSG_NOSIGNAL);
      if (n <= 0) return false;
      off += static_cast<size_t>(n);
    }
    return true;
  }

  int fd_;
  bool streaming_ = false;
};

using Handler = std::function<void(const Request&, ResponseWriter&)>;

class Server {
 public:
  // Bounded connection concurrency (round-1 finding: thread-per-connection
  // was unbounded; the reference runs a bounded tokio runtime). Streaming
  // connections (batch NDJSON to the trainer) occupy a worker for their
  // whole lifetime, so the default leaves generous headroom over the
  // handful of trainer + per-instance control connections.
  explicit Server(size_t workers = 64) : workers_(workers) {}

  void route(const std::string& method, const std::string& path, Handler h) {
    routes_[method + " " + path] = std::move(h);
  }

  // Invoked for every request BEFORE the handler runs (request counting,
  // trace echo). Set once before serve(); runs on worker threads.
  void set_observer(Handler fn) { observer_ = std::move(fn); }

  // bind+listen; returns the bound port (for port 0 = ephemeral) or -1.
  int listen(const std::string& host, int port) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr.s_addr = host.empty() || host == "0.0.0.0"
                               ? INADDR_ANY
                               : inet_addr(host.c_str());
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) return -1;
    if (::listen(listen_fd_, 128) < 0) return -1;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
    return ntohs(addr.sin_port);
  }

  void serve() {
    running_ = true;
    pool_ = std::make_unique<WorkerPool>(workers_);
    while (running_) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = ::accept(listen_fd_, reinterpret_cast<sockaddr*>(&peer), &plen);
      if (fd < 0) {
        if (!running_) break;
        continue;
      }
      char ip[INET_ADDRSTRLEN] = {0};
      inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
      std::string peer_ip(ip);
      if (!pool_->submit([this, fd, peer_ip] { handle_conn(fd, peer_ip); }))
        ::close(fd);
    }
    pool_->stop();
  }

  void stop() {
    running_ = false;
    // unblock serve() even when it is parked in pool_->submit() on a full
    // queue (connection saturation) — stop() wakes the not_full_ waiters
    if (pool_) pool_->stop();
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
  }

 private:
  void handle_conn(int fd, const std::string& peer_ip = std::string()) {
    Request req;
    req.peer_ip = peer_ip;
    if (read_request(fd, req)) {
      ResponseWriter rw(fd);
      if (observer_) observer_(req, rw);
      auto it = routes_.find(req.method + " " + req.path);
      if (it == routes_.end()) {
        rw.status = 404;
        rw.body = "{\"error\":\"not found\"}";
      } else {
        try {
          it->second(req, rw);
        } catch (const std::exception& e) {
          if (!rw.streaming()) {
            rw.status = 500;
            rw.body = std::string("{\"error\":\"") + e.what() + "\"}";
          }
        }
      }
      rw.finish();
    }
    ::close(fd);
  }

  static bool read_request(int fd, Request& req) {
    std::string buf;
    char tmp[8192];
    size_t header_end = std::string::npos;
    while (header_end == std::string::npos) {
      ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) return false;
      buf.append(tmp, static_cast<size_t>(n));
      header_end = buf.find("\r\n\r\n");
      if (buf.size() > (16u << 20)) return false;
    }
    // request line
    size_t line_end = buf.find("\r\n");
    std::string line = buf.substr(0, line_end);
    size_t sp1 = line.find(' ');
    size_t sp2 = line.find(' ', sp1 + 1);
    if (sp1 == std::string::npos || sp2 == std::string::npos) return false;
    req.method = line.substr(0, sp1);
    std::string target = line.substr(sp1 + 1, sp2 - sp1 - 1);
    size_t q = target.find('?');
    req.path = q == std::string::npos ? target : target.substr(0, q);
    req.query = q == std::string::npos ? "" : target.substr(q + 1);
    // headers
    size_t pos = line_end + 2;
    while (pos < header_end) {
      size_t eol = buf.find("\r\n", pos);
      std::string h = buf.substr(pos, eol - pos);
      size_t colon = h.find(':');
      if (colon != std::string::npos) {
        std::string key = h.substr(0, colon);
        for (auto& c : key) c = static_cast<char>(tolower(c));
        size_t vstart = h.find_first_not_of(' ', colon + 1);
        req.headers[key] = vstart == std::string::npos ? "" : h.substr(vstart);
      }
      pos = eol + 2;
    }
    size_t content_len = 0;
    auto it = req.headers.find("content-length");
    if (it != req.headers.end()) {
      try {
        content_len = std::stoul(it->second);
      } catch (const std::exception&) {
        return false;  // malformed header: drop the connection, not the server
      }
      if (content_len > (64u << 20)) return false;
    }
    req.body = buf.substr(header_end + 4);
    while (req.body.size() < content_len) {
      ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) return false;
      req.body.append(tmp, static_cast<size_t>(n));
    }
    return true;
  }

  std::map<std::string, Handler> routes_;
  Handler observer_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  size_t workers_;
  std::unique_ptr<WorkerPool> pool_;
};

// ---- client ---------------------------------------------------------------

struct ClientResponse {
  int status = 0;
  std::string body;
  bool ok() const { return status >= 200 && status < 300; }
};

// "host:port" → (host, port)
inline bool split_endpoint(const std::string& ep, std::string& host, int& port) {
  std::string s = ep;
  auto scheme = s.find("://");
  if (scheme != std::string::npos) s = s.substr(scheme + 3);
  auto slash = s.find('/');
  if (slash != std::string::npos) s = s.substr(0, slash);
  auto colon = s.rfind(':');
  if (colon == std::string::npos) return false;
  host = s.substr(0, colon);
  port = std::stoi(s.substr(colon + 1));
  return true;
}

class ClientConn {
 public:
  ~ClientConn() { close(); }

  bool connect(const std::string& host, int port, int timeout_ms) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0) return false;
    fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd_ < 0) { freeaddrinfo(res); return false; }
    set_timeout(timeout_ms);
    int rc = ::connect(fd_, res->ai_addr, res->ai_addrlen);
    freeaddrinfo(res);
    if (rc != 0) { close(); return false; }
    int one = 1;
    setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    return true;
  }

  void set_timeout(int timeout_ms) {
    if (fd_ < 0) return;
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd_, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  }

  bool send_request(const std::string& method, const std::string& host,
                    const std::string& path, const std::string& body,
                    const std::string& content_type = "application/json") {
    std::string req = method + " " + path + " HTTP/1.1\r\nHost: " + host +
                      "\r\nContent-Type: " + content_type +
                      "\r\nContent-Length: " + std::to_string(body.size()) +
                      "\r\nConnection: close\r\n\r\n" + body;
    return write_all(req.data(), req.size());
  }

  // Read status line + headers; leaves body streaming via read_line/read_rest.
  bool read_header(int& status) {
    while (true) {
      size_t he = buf_.find("\r\n\r\n");
      if (he != std::string::npos) {
        size_t le = buf_.find("\r\n");
        std::string line = buf_.substr(0, le);
        size_t sp = line.find(' ');
        status = 0;
        if (sp != std::string::npos) {
          try {
            status = std::stoi(line.substr(sp + 1, 3));
          } catch (const std::exception&) {
            return false;  // malformed status line
          }
        }
        std::string headers_lower = buf_.substr(0, he);
        for (auto& c : headers_lower) c = static_cast<char>(tolower(c));
        chunked_ = headers_lower.find("transfer-encoding: chunked") != std::string::npos;
        buf_.erase(0, he + 4);
        return true;
      }
      if (!fill()) return false;
    }
  }

  // Next logical line of the (possibly chunked) body; false on EOF/error.
  bool read_line(std::string& line) {
    while (true) {
      size_t nl = decoded_.find('\n');
      if (nl != std::string::npos) {
        line = decoded_.substr(0, nl);
        if (!line.empty() && line.back() == '\r') line.pop_back();
        decoded_.erase(0, nl + 1);
        return true;
      }
      if (!pump()) {
        if (!decoded_.empty()) {
          line = std::move(decoded_);
          decoded_.clear();
          return true;
        }
        return false;
      }
    }
  }

  std::string read_rest() {
    while (pump()) {}
    std::string out = std::move(decoded_);
    decoded_.clear();
    return out;
  }

  void close() {
    if (fd_ >= 0) { ::close(fd_); fd_ = -1; }
  }

 private:
  bool fill() {
    char tmp[16384];
    ssize_t n = ::recv(fd_, tmp, sizeof(tmp), 0);
    if (n <= 0) return false;
    buf_.append(tmp, static_cast<size_t>(n));
    return true;
  }

  // move decoded body bytes from buf_ into decoded_; false when body ends.
  bool pump() {
    if (!chunked_) {
      if (buf_.empty() && !fill()) return false;
      decoded_ += buf_;
      buf_.clear();
      return true;
    }
    while (true) {
      size_t le = buf_.find("\r\n");
      if (le == std::string::npos) {
        if (!fill()) return false;
        continue;
      }
      size_t chunk_len = 0;
      try {
        chunk_len = std::stoul(buf_.substr(0, le), nullptr, 16);
      } catch (const std::exception&) {
        return false;  // garbage chunk-size line from a half-dead peer
      }
      if (chunk_len == 0) return false;  // final chunk
      while (buf_.size() < le + 2 + chunk_len + 2) {
        if (!fill()) return false;
      }
      decoded_.append(buf_, le + 2, chunk_len);
      buf_.erase(0, le + 2 + chunk_len + 2);
      return true;
    }
  }

  bool write_all(const char* data, size_t len) {
    size_t off = 0;
    while (off < len) {
      ssize_t n = ::send(fd_, data + off, len - off, MSG_NOSIGNAL);
      if (n <= 0) return false;
      off += static_cast<size_t>(n);
    }
    return true;
  }

  int fd_ = -1;
  std::string buf_;
  std::string decoded_;
  bool chunked_ = false;
};

// One-shot convenience request.
inline ClientResponse request(const std::string& method, const std::string& endpoint,
                              const std::string& path, const std::string& body,
                              int timeout_ms = 5000) {
  ClientResponse resp;
  std::string host;
  int port;
  if (!split_endpoint(endpoint, host, port)) return resp;
  ClientConn conn;
  if (!conn.connect(host, port, timeout_ms)) return resp;
  if (!conn.send_request(method, host, path, body)) return resp;
  if (!conn.read_header(resp.status)) return resp;
  resp.body = conn.read_rest();
  return resp;
}

}  // namespace phttp
