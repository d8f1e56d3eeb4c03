// Lighthouse quorum service — C++ twin of torchft_tpu_torch/lighthouse.py, itself
// the behavioral twin of the reference Rust service (src/lighthouse.rs).
//
// Semantics (see the Python docstrings for the full derivation):
//  - quorum_compute: heartbeat freshness filter, fast-quorum when all
//    previous members are back, shrink_only restriction, min_replicas,
//    anti-split-brain strict majority, join-timeout straggler wait.
//  - tick loop bumping quorum_id on membership change / commit failures;
//    participants cleared after issuance.
//  - blocking quorum RPC honoring client deadlines; parked waiters that a
//    quorum excluded are re-registered atomically inside the tick.

#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "types.h"
#include "wire.h"

namespace tpuft {

using Clock = std::chrono::steady_clock;

struct LighthouseConfig {
  uint64_t min_replicas = 1;
  uint64_t join_timeout_ms = 100;
  uint64_t quorum_tick_ms = 100;
  uint64_t heartbeat_timeout_ms = 5000;
};

struct MemberDetails {
  Clock::time_point joined;
  QuorumMember member;
};

struct LighthouseState {
  std::map<std::string, MemberDetails> participants;
  std::map<std::string, Clock::time_point> heartbeats;
  bool has_prev = false;
  Quorum prev_quorum;
  int64_t quorum_id = 0;
};

// (quorum participants or empty, reason); `met` out-param signals validity.
inline std::vector<QuorumMember> quorum_compute(
    Clock::time_point now, const LighthouseState& state,
    const LighthouseConfig& cfg, bool* met, std::string* reason) {
  const auto hb_timeout = std::chrono::milliseconds(cfg.heartbeat_timeout_ms);
  std::set<std::string> healthy_replicas;
  for (const auto& [rid, ts] : state.heartbeats)
    if (now - ts < hb_timeout) healthy_replicas.insert(rid);

  std::map<std::string, const MemberDetails*> healthy_participants;
  for (const auto& [rid, details] : state.participants)
    if (healthy_replicas.count(rid)) healthy_participants[rid] = &details;

  std::vector<QuorumMember> candidates;
  bool shrink_only = false;
  for (const auto& [rid, details] : healthy_participants) {
    candidates.push_back(details->member);
    shrink_only = shrink_only || details->member.shrink_only;
  }
  std::sort(candidates.begin(), candidates.end(),
            [](const QuorumMember& a, const QuorumMember& b) {
              return a.replica_id < b.replica_id;
            });

  char meta[160];
  std::snprintf(meta, sizeof(meta),
                "[%zu/%zu participants healthy][%zu heartbeating][shrink_only=%s]",
                healthy_participants.size(), state.participants.size(),
                healthy_replicas.size(), shrink_only ? "True" : "False");

  if (state.has_prev) {
    std::set<std::string> prev_ids;
    for (const auto& p : state.prev_quorum.participants)
      prev_ids.insert(p.replica_id);
    if (shrink_only) {
      std::vector<QuorumMember> filtered;
      for (const auto& m : candidates)
        if (prev_ids.count(m.replica_id)) filtered.push_back(m);
      candidates = std::move(filtered);
    }
    bool fast = true;
    for (const auto& rid : prev_ids)
      if (!healthy_participants.count(rid)) fast = false;
    if (fast) {
      *met = true;
      *reason = std::string("Fast quorum found! ") + meta;
      return candidates;
    }
  }

  if (healthy_participants.size() < cfg.min_replicas) {
    *met = false;
    *reason = "New quorum not ready, only have " +
              std::to_string(healthy_participants.size()) +
              " participants, need min_replicas " +
              std::to_string(cfg.min_replicas) + " " + meta;
    return {};
  }

  if (healthy_participants.size() <= healthy_replicas.size() / 2) {
    *met = false;
    *reason = "New quorum not ready, only have " +
              std::to_string(healthy_participants.size()) +
              " participants, need at least half of " +
              std::to_string(healthy_replicas.size()) + " healthy workers " +
              meta;
    return {};
  }

  bool all_joined = healthy_participants.size() == healthy_replicas.size();
  Clock::time_point first_joined = now;
  for (const auto& [rid, details] : healthy_participants)
    first_joined = std::min(first_joined, details->joined);
  if (!all_joined &&
      now - first_joined < std::chrono::milliseconds(cfg.join_timeout_ms)) {
    *met = false;
    *reason = std::string("Valid quorum waiting for stragglers due to join timeout ") + meta;
    return {};
  }

  *met = true;
  *reason = std::string("Valid quorum found ") + meta;
  return candidates;
}

class LighthouseServer {
 public:
  LighthouseServer(const std::string& bind_addr, const LighthouseConfig& cfg)
      : cfg_(cfg) {
    listen_fd_ = listen_on(bind_addr, &port_);
    accept_thread_ = std::thread([this] { serve(); });
    tick_thread_ = std::thread([this] { run_ticks(); });
  }

  ~LighthouseServer() { shutdown(); }

  int port() const { return port_; }

  void shutdown() {
    bool expected = false;
    if (!shutdown_.compare_exchange_strong(expected, true)) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    cv_.notify_all();
    if (accept_thread_.joinable()) accept_thread_.join();
    if (tick_thread_.joinable()) tick_thread_.join();
    conns_.shutdown_all_and_wait();  // handlers must exit before we die
  }

 private:
  void serve() {
    while (!shutdown_) {
      int conn = ::accept(listen_fd_, nullptr, nullptr);
      if (conn < 0) return;
      configure_socket(conn);
      conns_.add(conn);
      std::thread([this, conn] {
        handle(conn);
        conns_.remove(conn);
      }).detach();
    }
  }

  void run_ticks() {
    while (!shutdown_) {
      std::this_thread::sleep_for(std::chrono::milliseconds(cfg_.quorum_tick_ms));
      std::unique_lock<std::mutex> lock(mu_);
      tick_locked();
    }
  }

  void register_member_locked(const QuorumMember& m) {
    auto now = Clock::now();
    state_.heartbeats[m.replica_id] = now;  // implicit heartbeat
    state_.participants[m.replica_id] = MemberDetails{now, m};
  }

  void tick_locked() {
    bool met = false;
    std::string reason;
    auto participants = quorum_compute(Clock::now(), state_, cfg_, &met, &reason);
    if (!met) return;

    bool commit_failures = false;
    for (const auto& p : participants)
      if (p.commit_failures > 0) commit_failures = true;

    auto changed = [&] {
      if (!state_.has_prev) return true;
      const auto& prev = state_.prev_quorum.participants;
      if (prev.size() != participants.size()) return true;
      for (size_t i = 0; i < prev.size(); ++i)
        if (prev[i].replica_id != participants[i].replica_id) return true;
      return false;
    }();
    if (changed || commit_failures) state_.quorum_id += 1;

    Quorum q;
    q.quorum_id = state_.quorum_id;
    q.participants = participants;
    q.created =
        std::chrono::duration<double>(
            std::chrono::system_clock::now().time_since_epoch())
            .count();
    state_.prev_quorum = q;
    state_.has_prev = true;
    state_.participants.clear();

    // atomically re-register parked waiters the quorum excluded
    std::set<std::string> included;
    for (const auto& p : participants) included.insert(p.replica_id);
    for (const auto& [token, member] : parked_)
      if (!included.count(member.replica_id)) register_member_locked(member);

    generation_ += 1;
    cv_.notify_all();
  }

  void handle(int conn) {
    try {
      // protocol sniff: HTTP (dashboard) vs framed RPC on one port
      char head[4] = {0};
      ssize_t peeked = ::recv(conn, head, 4, MSG_PEEK);
      if (peeked >= 3 && (std::memcmp(head, "GET", 3) == 0 ||
                          std::memcmp(head, "POS", 3) == 0 ||
                          std::memcmp(head, "HEA", 3) == 0)) {
        handle_http(conn);
        ::close(conn);
        return;
      }
      while (true) {
        auto [type, body] = recv_frame(conn);
        Reader r(body.data(), body.size());
        switch (type) {
          case LH_HEARTBEAT_REQ: {
            std::string rid = r.str();
            {
              std::lock_guard<std::mutex> lock(mu_);
              state_.heartbeats[rid] = Clock::now();
            }
            send_frame(conn, LH_HEARTBEAT_RESP, Writer{});
            break;
          }
          case LH_QUORUM_REQ:
            handle_quorum(conn, r);
            break;
          case LH_STATUS_REQ: {
            Writer w;
            w.str(status_json());
            send_frame(conn, LH_STATUS_RESP, w);
            break;
          }
          default:
            send_error(conn, ERR_INVALID, "bad lighthouse op");
        }
      }
    } catch (const std::exception&) {
    }
    ::close(conn);
  }

  void handle_quorum(int conn, Reader& r) {
    QuorumMember requester = QuorumMember::decode(r);
    uint64_t timeout_ms = r.u64();
    auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);

    Quorum result;
    bool failed = false;
    ErrCode fail_code = ERR_TIMEOUT;
    std::string fail_msg;
    uint64_t token = next_token_++;
    {
      std::unique_lock<std::mutex> lock(mu_);
      register_member_locked(requester);
      parked_[token] = requester;
      uint64_t gen = generation_;
      tick_locked();  // proactive tick
      while (true) {
        if (generation_ > gen) {
          gen = generation_;
          bool in_quorum = false;
          for (const auto& p : state_.prev_quorum.participants)
            if (p.replica_id == requester.replica_id) in_quorum = true;
          if (in_quorum) {
            result = state_.prev_quorum;
            break;
          }
          // excluded; tick_locked already re-registered us — keep waiting
        }
        if (Clock::now() >= deadline || shutdown_) {
          failed = true;
          fail_code = shutdown_ ? ERR_SHUTDOWN : ERR_TIMEOUT;
          fail_msg = "quorum request for '" + requester.replica_id + "' " +
                     (shutdown_ ? "aborted by shutdown" : "timed out");
          break;
        }
        cv_.wait_until(
            lock, std::min(deadline, Clock::now() + std::chrono::milliseconds(100)));
      }
      parked_.erase(token);
    }

    // socket IO outside the server lock
    if (failed) {
      send_error(conn, fail_code, fail_msg);
      return;
    }
    Writer w;
    result.encode(w);
    send_frame(conn, LH_QUORUM_RESP, w);
  }

  void handle_http(int conn) {
    set_recv_timeout(conn, 5.0);
    std::string req;
    char buf[2048];
    while (req.find("\r\n\r\n") == std::string::npos) {
      ssize_t got = ::recv(conn, buf, sizeof(buf), 0);
      if (got <= 0) return;
      req.append(buf, static_cast<size_t>(got));
      if (req.size() > 1 << 20) return;
    }
    std::string path = "/";
    auto sp1 = req.find(' ');
    if (sp1 != std::string::npos) {
      auto sp2 = req.find(' ', sp1 + 1);
      if (sp2 != std::string::npos) path = req.substr(sp1 + 1, sp2 - sp1 - 1);
    }

    std::string body;
    std::string ctype = "application/json";
    std::string status = "200 OK";
    const std::string kill_prefix = "/replica/";
    const std::string kill_suffix = "/kill";
    if (path.rfind(kill_prefix, 0) == 0 &&
        path.size() > kill_prefix.size() + kill_suffix.size() &&
        path.compare(path.size() - kill_suffix.size(), kill_suffix.size(),
                     kill_suffix) == 0) {
      std::string rid = path.substr(
          kill_prefix.size(),
          path.size() - kill_prefix.size() - kill_suffix.size());
      bool ok = kill_replica(rid);
      body = std::string("{\"ok\": ") + (ok ? "true" : "false") + "}";
      if (!ok) status = "404 Not Found";
    } else if (path == "/status.json" || path == "/status" || path == "/") {
      body = status_json();
    } else {
      status = "404 Not Found";
      body = "{\"error\": \"unknown path\"}";
    }
    std::string resp = "HTTP/1.1 " + status +
                       "\r\nContent-Type: " + ctype +
                       "\r\nContent-Length: " + std::to_string(body.size()) +
                       "\r\nConnection: close\r\n\r\n" + body;
    send_all(conn, resp.data(), resp.size());
  }

  bool kill_replica(const std::string& rid) {
    std::string addr;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (!state_.has_prev) return false;
      for (const auto& m : state_.prev_quorum.participants)
        if (m.replica_id == rid) addr = m.address;
    }
    if (addr.empty()) return false;
    try {
      int fd = dial(addr, 10.0);
      Writer w;
      w.str("killed from dashboard");
      send_frame(fd, MGR_KILL_REQ, w);
      ::close(fd);
      return true;
    } catch (const std::exception&) {
      return false;
    }
  }

  std::string status_json() {
    std::lock_guard<std::mutex> lock(mu_);
    std::string parts = "[";
    if (state_.has_prev) {
      bool first = true;
      for (const auto& m : state_.prev_quorum.participants) {
        if (!first) parts += ", ";
        first = false;
        parts += "{\"replica_id\": \"" + m.replica_id +
                 "\", \"address\": \"" + m.address +
                 "\", \"store_address\": \"" + m.store_address +
                 "\", \"step\": " + std::to_string(m.step) +
                 ", \"world_size\": " + std::to_string(m.world_size) + "}";
      }
    }
    parts += "]";
    std::string out = "{\"quorum_id\": " + std::to_string(state_.quorum_id) +
                      ", \"num_participants\": " +
                      (state_.has_prev
                           ? std::to_string(state_.prev_quorum.participants.size())
                           : "-1") +
                      ", \"participants\": " + parts +
                      ", \"impl\": \"cpp\"}";
    return out;
  }

  LighthouseConfig cfg_;
  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> shutdown_{false};
  std::thread accept_thread_;
  std::thread tick_thread_;

  // guards state_/parked_/generation_
  std::mutex mu_;
  std::condition_variable cv_;
  LighthouseState state_;
  std::map<uint64_t, QuorumMember> parked_;
  uint64_t generation_ = 0;
  std::atomic<uint64_t> next_token_{0};
  ConnRegistry conns_;
};

}  // namespace tpuft
