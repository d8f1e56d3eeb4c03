// Manager sidecar — C++ twin of torchft_tpu_torch/manager_server.py (reference:
// src/manager.rs): intra-group quorum barrier → lighthouse forward with
// retries, deterministic recovery assignment, should_commit AND-barrier,
// checkpoint metadata registry, kill RPC, lighthouse heartbeat loop.

#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <map>
#include <mutex>
#include <optional>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "types.h"
#include "wire.h"

namespace tpuft {

inline ManagerQuorumResult compute_quorum_results(
    const std::string& replica_id, int64_t group_rank, const Quorum& quorum,
    bool init_sync) {
  std::vector<QuorumMember> participants = quorum.participants;
  std::sort(participants.begin(), participants.end(),
            [](const QuorumMember& a, const QuorumMember& b) {
              return a.replica_id < b.replica_id;
            });

  int64_t replica_rank = -1;
  for (size_t i = 0; i < participants.size(); ++i)
    if (participants[i].replica_id == replica_id)
      replica_rank = static_cast<int64_t>(i);
  if (replica_rank < 0)
    throw WireError(ERR_NOT_FOUND,
                    "replica " + replica_id + " not participating in returned quorum");

  int64_t max_step = participants[0].step;
  for (const auto& p : participants) max_step = std::max(max_step, p.step);
  std::vector<size_t> max_idx;
  for (size_t i = 0; i < participants.size(); ++i)
    if (participants[i].step == max_step) max_idx.push_back(i);

  std::optional<int64_t> max_replica_rank;
  for (size_t j = 0; j < max_idx.size(); ++j)
    if (participants[max_idx[j]].replica_id == replica_id)
      max_replica_rank = static_cast<int64_t>(j);

  const QuorumMember& primary =
      participants[max_idx[static_cast<size_t>(group_rank) % max_idx.size()]];

  bool force_recover = init_sync && max_step == 0;
  std::vector<size_t> recover_dst;
  for (size_t i = 0; i < participants.size(); ++i) {
    const auto& p = participants[i];
    if (p.step != max_step ||
        (force_recover && primary.replica_id != p.replica_id))
      recover_dst.push_back(i);
  }
  std::set<size_t> dst_set(recover_dst.begin(), recover_dst.end());
  std::vector<size_t> up_to_date;
  for (size_t i = 0; i < participants.size(); ++i)
    if (!dst_set.count(i)) up_to_date.push_back(i);

  std::map<size_t, std::vector<int64_t>> assignments;
  std::optional<int64_t> recover_src;
  for (size_t i = 0; i < recover_dst.size(); ++i) {
    size_t src =
        up_to_date[(i + static_cast<size_t>(group_rank)) % up_to_date.size()];
    assignments[src].push_back(static_cast<int64_t>(recover_dst[i]));
    if (static_cast<int64_t>(recover_dst[i]) == replica_rank)
      recover_src = static_cast<int64_t>(src);
  }

  ManagerQuorumResult out;
  out.quorum_id = quorum.quorum_id;
  out.replica_rank = replica_rank;
  out.replica_world_size = static_cast<int64_t>(participants.size());
  out.recover_src_replica_rank = recover_src;
  out.recover_src_manager_address =
      recover_src ? participants[static_cast<size_t>(*recover_src)].address : "";
  if (assignments.count(static_cast<size_t>(replica_rank)))
    out.recover_dst_replica_ranks = assignments[static_cast<size_t>(replica_rank)];
  out.store_address = primary.store_address;
  out.max_step = max_step;
  out.max_replica_rank = max_replica_rank;
  out.max_world_size = static_cast<int64_t>(max_idx.size());
  out.heal = recover_src.has_value();
  out.commit_failures = 0;
  for (const auto& p : participants) {
    out.commit_failures = std::max(out.commit_failures, p.commit_failures);
    out.replica_ids.push_back(p.replica_id);
  }
  return out;
}

class ManagerServer {
 public:
  ManagerServer(std::string replica_id, std::string lighthouse_addr,
                std::string hostname, const std::string& bind_addr,
                std::string store_addr, uint64_t world_size,
                double heartbeat_interval_s, double connect_timeout_s,
                int64_t quorum_retries)
      : replica_id_(std::move(replica_id)),
        lighthouse_addr_(std::move(lighthouse_addr)),
        hostname_(std::move(hostname)),
        store_addr_(std::move(store_addr)),
        world_size_(world_size),
        heartbeat_interval_s_(heartbeat_interval_s),
        connect_timeout_s_(connect_timeout_s),
        quorum_retries_(quorum_retries) {
    listen_fd_ = listen_on(bind_addr, &port_);
    accept_thread_ = std::thread([this] { serve(); });
    heartbeat_thread_ = std::thread([this] { run_heartbeat(); });
  }

  ~ManagerServer() { shutdown(); }

  int port() const { return port_; }
  std::string address() const {
    return hostname_ + ":" + std::to_string(port_);
  }

  void shutdown() {
    bool expected = false;
    if (!shutdown_.compare_exchange_strong(expected, true)) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    cv_.notify_all();
    if (accept_thread_.joinable()) accept_thread_.join();
    if (heartbeat_thread_.joinable()) heartbeat_thread_.join();
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

  void run_heartbeat() {
    int fd = -1;
    while (!shutdown_) {
      try {
        if (fd < 0) fd = dial(lighthouse_addr_, connect_timeout_s_);
        Writer w;
        w.str(replica_id_);
        set_recv_timeout(fd, 5.0);
        send_frame(fd, LH_HEARTBEAT_REQ, w);
        auto [type, body] = recv_frame(fd);
        (void)type;
        (void)body;
      } catch (const std::exception&) {
        if (fd >= 0) ::close(fd);
        fd = -1;
      }
      std::this_thread::sleep_for(
          std::chrono::duration<double>(heartbeat_interval_s_));
    }
    if (fd >= 0) ::close(fd);
  }

  void handle(int conn) {
    try {
      while (true) {
        auto [type, body] = recv_frame(conn);
        Reader r(body.data(), body.size());
        switch (type) {
          case MGR_QUORUM_REQ:
            handle_quorum(conn, r);
            break;
          case MGR_CKPT_META_REQ: {
            int64_t rank = r.i64();
            std::optional<std::string> meta;
            {
              std::lock_guard<std::mutex> lock(mu_);
              auto it = checkpoint_metadata_.find(rank);
              if (it != checkpoint_metadata_.end()) meta = it->second;
            }
            if (!meta) {
              send_error(conn, ERR_INVALID, "rank not found");
            } else {
              Writer w;
              w.str(*meta);
              send_frame(conn, MGR_CKPT_META_RESP, w);
            }
            break;
          }
          case MGR_SHOULD_COMMIT_REQ:
            handle_should_commit(conn, r);
            break;
          case MGR_KILL_REQ: {
            send_frame(conn, MGR_KILL_RESP, Writer{});
            std::_Exit(1);
          }
          default:
            send_error(conn, ERR_INVALID, "bad manager op");
        }
      }
    } catch (const std::exception&) {
    }
    ::close(conn);
  }

  void handle_quorum(int conn, Reader& r) {
    int64_t group_rank = r.i64();
    int64_t step = r.i64();
    std::string checkpoint_metadata = r.str();
    bool shrink_only = r.boolean();
    bool init_sync = r.boolean();
    int64_t commit_failures = r.i64();
    uint64_t timeout_ms = r.u64();
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);

    Quorum quorum;
    bool failed = false;
    ErrCode fail_code = ERR_TIMEOUT;
    std::string fail_msg;
    {
      std::unique_lock<std::mutex> lock(mu_);
      checkpoint_metadata_[group_rank] = checkpoint_metadata;
      QuorumMember member;
      member.replica_id = replica_id_;
      member.address = address();
      member.store_address = store_addr_;
      member.step = step;
      member.world_size = world_size_;
      member.shrink_only = shrink_only;
      member.commit_failures = commit_failures;
      participants_[group_rank] = member;
      uint64_t gen = quorum_gen_;

      if (participants_.size() == world_size_) {
        participants_.clear();
        double timeout_s = static_cast<double>(timeout_ms) / 1000.0;
        std::thread([this, member, timeout_s] {
          run_quorum(member, timeout_s);
        }).detach();
      }

      while (quorum_gen_ == gen) {
        if (std::chrono::steady_clock::now() >= deadline || shutdown_) {
          failed = true;
          fail_code = shutdown_ ? ERR_SHUTDOWN : ERR_TIMEOUT;
          fail_msg = "manager quorum for group_rank " +
                     std::to_string(group_rank) +
                     (shutdown_ ? " aborted by shutdown" : " timed out");
          break;
        }
        cv_.wait_until(lock,
                       std::min(deadline, std::chrono::steady_clock::now() +
                                              std::chrono::milliseconds(100)));
      }
      if (!failed) {
        if (!latest_ok_) {
          failed = true;
          fail_code = ERR_UNKNOWN;
          fail_msg = latest_err_;
        } else {
          quorum = latest_;
        }
      }
    }

    if (failed) {
      send_error(conn, fail_code, fail_msg);
      return;
    }
    try {
      ManagerQuorumResult reply =
          compute_quorum_results(replica_id_, group_rank, quorum, init_sync);
      Writer w;
      reply.encode(w);
      send_frame(conn, MGR_QUORUM_RESP, w);
    } catch (const WireError& e) {
      send_error(conn, e.code, e.what());
    }
  }

  void run_quorum(const QuorumMember& requester, double timeout_s) {
    bool ok = false;
    Quorum quorum;
    std::string last_err = "unknown";
    // persistent lighthouse connection across rounds (reference keeps a
    // tonic channel, src/manager.rs:250-306); serialized by lh_fd_mu_
    std::lock_guard<std::mutex> fd_lock(lh_fd_mu_);
    for (int64_t attempt = 0; attempt <= quorum_retries_; ++attempt) {
      try {
        if (lh_fd_ < 0) lh_fd_ = dial(lighthouse_addr_, connect_timeout_s_);
        int fd = lh_fd_;
        Writer w;
        requester.encode(w);
        w.u64(static_cast<uint64_t>(timeout_s * 1000));
        set_recv_timeout(fd, timeout_s + 5.0);
        send_frame(fd, LH_QUORUM_REQ, w);
        auto [type, body] = recv_frame(fd);
        if (type == ERROR_FRAME) {
          Reader r(body.data(), body.size());
          ErrCode code = static_cast<ErrCode>(r.u8());
          throw WireError(code, r.str());
        }
        Reader r(body.data(), body.size());
        quorum = Quorum::decode(r);
        ok = true;
        break;
      } catch (const std::exception& e) {
        if (lh_fd_ >= 0) {
          ::close(lh_fd_);
          lh_fd_ = -1;
        }
        last_err = e.what();
        if (attempt < quorum_retries_) {
          double sleep_s =
              std::max(0.1, timeout_s / static_cast<double>(quorum_retries_ + 1));
          std::this_thread::sleep_for(std::chrono::duration<double>(sleep_s));
        }
      }
    }
    {
      std::lock_guard<std::mutex> lock(mu_);
      latest_ok_ = ok;
      latest_ = quorum;
      latest_err_ = ok ? "" : ("lighthouse quorum failed: " + last_err);
      quorum_gen_ += 1;
    }
    cv_.notify_all();
  }

  void handle_should_commit(int conn, Reader& r) {
    int64_t group_rank = r.i64();
    (void)r.i64();  // step (unchecked, matching the reference TODO)
    bool should_commit = r.boolean();
    uint64_t timeout_ms = r.u64();
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);

    bool decision = false;
    bool failed = false;
    ErrCode fail_code = ERR_TIMEOUT;
    std::string fail_msg;
    {
      std::unique_lock<std::mutex> lock(mu_);
      if (!should_commit) commit_failures_.insert(group_rank);
      commit_votes_.insert(group_rank);
      uint64_t gen = commit_gen_;

      if (commit_votes_.size() == world_size_) {
        commit_decision_ = commit_failures_.empty();
        commit_votes_.clear();
        commit_failures_.clear();
        commit_gen_ += 1;
        cv_.notify_all();
      }

      while (commit_gen_ == gen) {
        if (std::chrono::steady_clock::now() >= deadline || shutdown_) {
          failed = true;
          fail_code = shutdown_ ? ERR_SHUTDOWN : ERR_TIMEOUT;
          fail_msg = "should_commit for group_rank " +
                     std::to_string(group_rank) +
                     (shutdown_ ? " aborted by shutdown" : " timed out");
          break;
        }
        cv_.wait_until(lock,
                       std::min(deadline, std::chrono::steady_clock::now() +
                                              std::chrono::milliseconds(100)));
      }
      decision = commit_decision_;
    }

    if (failed) {
      send_error(conn, fail_code, fail_msg);
      return;
    }
    Writer w;
    w.boolean(decision);
    send_frame(conn, MGR_SHOULD_COMMIT_RESP, w);
  }

  std::string replica_id_;
  std::string lighthouse_addr_;
  std::string hostname_;
  std::string store_addr_;
  uint64_t world_size_;
  double heartbeat_interval_s_;
  double connect_timeout_s_;
  int64_t quorum_retries_;

  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> shutdown_{false};
  std::thread accept_thread_;
  std::thread heartbeat_thread_;

  // guards participants_/checkpoint_metadata_/quorum_gen_/latest_ok_/
  // latest_/latest_err_/commit_votes_/commit_failures_/commit_gen_/
  // commit_decision_
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<int64_t, QuorumMember> participants_;
  std::map<int64_t, std::string> checkpoint_metadata_;
  uint64_t quorum_gen_ = 0;
  bool latest_ok_ = false;
  Quorum latest_;
  std::string latest_err_;
  std::set<int64_t> commit_votes_;
  std::set<int64_t> commit_failures_;
  uint64_t commit_gen_ = 0;
  bool commit_decision_ = false;
  ConnRegistry conns_;
  // guards lh_fd_
  std::mutex lh_fd_mu_;
  int lh_fd_ = -1;
};

}  // namespace tpuft
