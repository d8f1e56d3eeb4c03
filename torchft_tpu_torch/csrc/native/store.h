// TCP KV store server — C++ twin of torchft_tpu_torch/store.py StoreServer.
// Wait-for-key gets with server-honored deadlines; atomic integer add;
// prefix delete.  One detached thread per connection (control-plane scale).

#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>

#include "wire.h"

namespace tpuft {

class StoreServer {
 public:
  explicit StoreServer(const std::string& bind_addr) {
    listen_fd_ = listen_on(bind_addr, &port_);
    accept_thread_ = std::thread([this] { serve(); });
  }

  ~StoreServer() { shutdown(); }

  int port() const { return port_; }

  void shutdown() {
    bool expected = false;
    if (!shutdown_.compare_exchange_strong(expected, true)) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    cv_.notify_all();
    if (accept_thread_.joinable()) accept_thread_.join();
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

  void handle(int conn) {
    try {
      while (true) {
        auto [type, body] = recv_frame(conn);
        Reader r(body.data(), body.size());
        switch (type) {
          case STORE_SET: {
            std::string key = r.str();
            std::string value = r.blob();
            {
              std::lock_guard<std::mutex> lock(mu_);
              data_[key] = value;
            }
            cv_.notify_all();
            send_frame(conn, STORE_OK, Writer{});
            break;
          }
          case STORE_GET: {
            std::string key = r.str();
            uint64_t timeout_ms = r.u64();
            auto deadline = std::chrono::steady_clock::now() +
                            std::chrono::milliseconds(timeout_ms);
            std::unique_lock<std::mutex> lock(mu_);
            bool ok = cv_.wait_until(lock, deadline, [&] {
              return shutdown_ || data_.count(key) > 0;
            });
            if (!ok || shutdown_ || data_.count(key) == 0) {
              lock.unlock();
              send_error(conn, ERR_TIMEOUT,
                         "store get timed out for '" + key + "'");
            } else {
              Writer w;
              w.blob(data_[key]);
              lock.unlock();
              send_frame(conn, STORE_OK, w);
            }
            break;
          }
          case STORE_ADD: {
            std::string key = r.str();
            int64_t delta = r.i64();
            int64_t result;
            bool bad = false;
            {
              std::lock_guard<std::mutex> lock(mu_);
              int64_t cur = 0;
              auto it = data_.find(key);
              if (it != data_.end()) {
                try {
                  cur = std::stoll(it->second);
                } catch (...) {
                  bad = true;
                }
              }
              if (!bad) {
                result = cur + delta;
                data_[key] = std::to_string(result);
              }
            }
            if (bad) {
              send_error(conn, ERR_INVALID, "add on non-integer key '" + key + "'");
            } else {
              cv_.notify_all();
              Writer w;
              w.i64(result);
              send_frame(conn, STORE_OK, w);
            }
            break;
          }
          case STORE_EXISTS: {
            std::string key = r.str();
            bool present;
            {
              std::lock_guard<std::mutex> lock(mu_);
              present = data_.count(key) > 0;
            }
            Writer w;
            w.boolean(present);
            send_frame(conn, STORE_OK, w);
            break;
          }
          case STORE_DELETE: {
            std::string prefix = r.str();
            int64_t removed = 0;
            {
              std::lock_guard<std::mutex> lock(mu_);
              for (auto it = data_.begin(); it != data_.end();) {
                if (it->first.rfind(prefix, 0) == 0) {
                  it = data_.erase(it);
                  ++removed;
                } else {
                  ++it;
                }
              }
            }
            Writer w;
            w.i64(removed);
            send_frame(conn, STORE_OK, w);
            break;
          }
          default:
            send_error(conn, ERR_INVALID, "bad store op");
        }
      }
    } catch (const std::exception&) {
      // connection closed or protocol error: drop the connection
    }
    ::close(conn);
  }

  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> shutdown_{false};
  std::thread accept_thread_;
  // guards data_
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> data_;
  ConnRegistry conns_;
};

// Minimal store client (used by the C++ communicator for rendezvous).
class StoreClient {
 public:
  StoreClient(const std::string& addr, double timeout_s)
      : addr_(addr), timeout_s_(timeout_s) {
    fd_ = dial(addr, timeout_s);
  }
  ~StoreClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  void set(const std::string& key, const std::string& value) {
    Writer w;
    w.str(key);
    w.blob(value);
    call(STORE_SET, w, timeout_s_);
  }

  std::string get(const std::string& key, double timeout_s) {
    Writer w;
    w.str(key);
    w.u64(static_cast<uint64_t>(timeout_s * 1000));
    auto body = call(STORE_GET, w, timeout_s);
    Reader r(body.data(), body.size());
    return r.blob();
  }

 private:
  std::vector<uint8_t> call(MsgType type, const Writer& w, double budget) {
    set_recv_timeout(fd_, budget + 5.0);
    send_frame(fd_, type, w);
    auto [resp, body] = recv_frame(fd_);
    if (resp == ERROR_FRAME) {
      Reader r(body.data(), body.size());
      ErrCode code = static_cast<ErrCode>(r.u8());
      throw WireError(code, r.str());
    }
    return body;
  }

  std::string addr_;
  double timeout_s_;
  int fd_ = -1;
};

}  // namespace tpuft
