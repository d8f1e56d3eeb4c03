// Framed binary wire protocol — C++ twin of torchft_tpu_torch/wire.py.
//
// The reference implements its control plane as tonic/gRPC Rust services
// (src/lighthouse.rs, src/manager.rs); torchft_tpu_torch uses this dependency-free
// framed protocol so the same servers exist in both Python (development) and
// C++ (production runtime), interchangeable behind the Python clients.
//
// Frame: u32 payload_len (LE) | u8 msg_type | body. Primitives little-endian;
// strings/bytes are u32 length + raw bytes.

#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <thread>
#include <optional>
#include <stdexcept>
#include <string>
#include <vector>

namespace tpuft {

enum MsgType : uint8_t {
  STORE_SET = 0x01,
  STORE_GET = 0x02,
  STORE_ADD = 0x03,
  STORE_EXISTS = 0x04,
  STORE_DELETE = 0x05,
  STORE_OK = 0x0E,
  LH_QUORUM_REQ = 0x10,
  LH_QUORUM_RESP = 0x11,
  LH_HEARTBEAT_REQ = 0x12,
  LH_HEARTBEAT_RESP = 0x13,
  LH_STATUS_REQ = 0x14,
  LH_STATUS_RESP = 0x15,
  MGR_QUORUM_REQ = 0x20,
  MGR_QUORUM_RESP = 0x21,
  MGR_CKPT_META_REQ = 0x22,
  MGR_CKPT_META_RESP = 0x23,
  MGR_SHOULD_COMMIT_REQ = 0x24,
  MGR_SHOULD_COMMIT_RESP = 0x25,
  MGR_KILL_REQ = 0x26,
  MGR_KILL_RESP = 0x27,
  ERROR_FRAME = 0x7F,
};

enum ErrCode : uint8_t {
  ERR_UNKNOWN = 0,
  ERR_TIMEOUT = 1,
  ERR_NOT_FOUND = 2,
  ERR_INVALID = 3,
  ERR_SHUTDOWN = 4,
};

constexpr uint64_t kMaxFrameBytes = 64ull * 1024 * 1024;

struct WireError : std::runtime_error {
  ErrCode code;
  explicit WireError(ErrCode c, const std::string& msg)
      : std::runtime_error(msg), code(c) {}
};

class Writer {
 public:
  void u8(uint8_t v) { buf_.push_back(v); }
  void u32(uint32_t v) { append(&v, 4); }
  void u64(uint64_t v) { append(&v, 8); }
  void i64(int64_t v) { append(&v, 8); }
  void f64(double v) { append(&v, 8); }
  void boolean(bool v) { u8(v ? 1 : 0); }
  void str(const std::string& s) {
    u32(static_cast<uint32_t>(s.size()));
    buf_.insert(buf_.end(), s.begin(), s.end());
  }
  void blob(const std::string& s) { str(s); }
  void opt_i64(const std::optional<int64_t>& v) {
    if (v.has_value()) {
      u8(1);
      i64(*v);
    } else {
      u8(0);
    }
  }
  const std::vector<uint8_t>& data() const { return buf_; }

 private:
  void append(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);  // little-endian hosts only
  }
  std::vector<uint8_t> buf_;
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t n) : data_(data), n_(n) {}

  uint8_t u8() { return *take(1); }
  uint32_t u32() { return load<uint32_t>(); }
  uint64_t u64() { return load<uint64_t>(); }
  int64_t i64() { return load<int64_t>(); }
  double f64() { return load<double>(); }
  bool boolean() { return u8() != 0; }
  std::string str() {
    uint32_t len = u32();
    const uint8_t* p = take(len);
    return std::string(reinterpret_cast<const char*>(p), len);
  }
  std::string blob() { return str(); }
  std::optional<int64_t> opt_i64() {
    if (u8() == 0) return std::nullopt;
    return i64();
  }

 private:
  template <typename T>
  T load() {
    T v;
    std::memcpy(&v, take(sizeof(T)), sizeof(T));
    return v;
  }
  const uint8_t* take(size_t n) {
    if (off_ + n > n_) throw WireError(ERR_INVALID, "truncated frame");
    const uint8_t* p = data_ + off_;
    off_ += n;
    return p;
  }
  const uint8_t* data_;
  size_t n_;
  size_t off_ = 0;
};

// ---------------------------------------------------------------------------
// socket helpers
// ---------------------------------------------------------------------------

inline void send_all(int fd, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (n > 0) {
    ssize_t sent = ::send(fd, p, n, MSG_NOSIGNAL);
    if (sent <= 0) throw WireError(ERR_UNKNOWN, "send failed");
    p += sent;
    n -= static_cast<size_t>(sent);
  }
}

inline void recv_exact(int fd, void* data, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(data);
  while (n > 0) {
    ssize_t got = ::recv(fd, p, n, 0);
    if (got == 0) throw WireError(ERR_UNKNOWN, "connection closed");
    if (got < 0) throw WireError(ERR_UNKNOWN, "recv failed");
    p += got;
    n -= static_cast<size_t>(got);
  }
}

inline void send_frame(int fd, MsgType type, const std::vector<uint8_t>& body) {
  uint32_t len = static_cast<uint32_t>(body.size() + 1);
  std::vector<uint8_t> frame;
  frame.reserve(5 + body.size());
  frame.insert(frame.end(), reinterpret_cast<uint8_t*>(&len),
               reinterpret_cast<uint8_t*>(&len) + 4);
  frame.push_back(type);
  frame.insert(frame.end(), body.begin(), body.end());
  send_all(fd, frame.data(), frame.size());
}

inline void send_frame(int fd, MsgType type, const Writer& w) {
  send_frame(fd, type, w.data());
}

inline void send_error(int fd, ErrCode code, const std::string& msg) {
  Writer w;
  w.u8(code);
  w.str(msg);
  send_frame(fd, ERROR_FRAME, w);
}

// returns (msg_type, body bytes)
inline std::pair<uint8_t, std::vector<uint8_t>> recv_frame(int fd) {
  uint32_t len;
  recv_exact(fd, &len, 4);
  if (len < 1 || len > kMaxFrameBytes)
    throw WireError(ERR_INVALID, "bad frame length");
  std::vector<uint8_t> body(len);
  recv_exact(fd, body.data(), len);
  uint8_t type = body[0];
  body.erase(body.begin());
  return {type, std::move(body)};
}

inline void configure_socket(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  ::setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
}

// bind a listening TCP socket on host:port (port 0 = ephemeral); returns fd
inline int listen_on(const std::string& bind_addr, int* out_port) {
  auto colon = bind_addr.rfind(':');
  std::string host = bind_addr.substr(0, colon);
  int port = std::stoi(bind_addr.substr(colon + 1));
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) throw WireError(ERR_UNKNOWN, "socket() failed");
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host == "0.0.0.0" || host.empty()) {
    addr.sin_addr.s_addr = INADDR_ANY;
  } else if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    throw WireError(ERR_INVALID, "bad bind host " + host);
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    throw WireError(ERR_UNKNOWN, "bind failed for " + bind_addr);
  }
  if (::listen(fd, 512) != 0) {
    ::close(fd);
    throw WireError(ERR_UNKNOWN, "listen failed");
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  *out_port = ntohs(addr.sin_port);
  return fd;
}

// dial host:port with a connect timeout (seconds)
inline int dial(const std::string& addr, double timeout_s) {
  auto colon = addr.rfind(':');
  std::string host = addr.substr(0, colon);
  std::string port = addr.substr(colon + 1);
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res)
    throw WireError(ERR_UNKNOWN, "getaddrinfo failed for " + addr);
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    throw WireError(ERR_UNKNOWN, "socket() failed");
  }
  timeval tv{};
  tv.tv_sec = static_cast<long>(timeout_s);
  tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    ::freeaddrinfo(res);
    ::close(fd);
    throw WireError(ERR_UNKNOWN, "connect failed to " + addr);
  }
  ::freeaddrinfo(res);
  configure_socket(fd);
  return fd;
}

inline void set_recv_timeout(int fd, double timeout_s) {
  timeval tv{};
  if (timeout_s > 0) {
    tv.tv_sec = static_cast<long>(timeout_s);
    tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
  }
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

// Tracks live connection handlers so a server can force-close their sockets
// and wait for every handler to exit before its state is destroyed.
class ConnRegistry {
 public:
  void add(int fd) {
    std::lock_guard<std::mutex> lock(mu_);
    fds_.insert(fd);
    ++active_;
  }
  void remove(int fd) {
    std::lock_guard<std::mutex> lock(mu_);
    fds_.erase(fd);
    --active_;
  }
  // close all handler sockets (unblocks their recv) and wait for exit
  void shutdown_all_and_wait() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (int fd : fds_) ::shutdown(fd, SHUT_RDWR);
    }
    for (int i = 0; i < 500 && active_.load() > 0; ++i)
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }

 private:
  // guards fds_ (the counter below is atomic: the waiter polls it lock-free)
  std::mutex mu_;
  std::set<int> fds_;
  std::atomic<int> active_{0};
};

}  // namespace tpuft
