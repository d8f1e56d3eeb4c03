// Host-side data-plane communicator — C++ twin of the Python
// TCPCommunicator mesh tier (torchft_tpu_torch/communicator.py), built for DCN
// throughput: blocking duplex IO on persistent per-lane worker threads,
// scatter-gather sendmsg/recvmsg framing (multi-buffer payloads are never
// assembled in a staging copy), -O3 vectorized reduction loops, ring
// allreduce (reduce-scatter + allgather), alltoall/allgather, broadcast,
// send/recv, and a token-bucket network emulator mirroring the Python
// tier's _NetEmu (same env knobs, same profiles) so cross-tier benches
// shape both planes identically.
//
// All ops are synchronous at this level and abortable: abort() flips a flag
// and shuts the sockets down, unblocking any op mid-IO (the userspace
// timeout/abort doctrine, SURVEY.md §5.8.5).  The Python wrapper
// (torchft_tpu_torch/native.py CppCommunicator) serializes ops on an op thread
// and layers Work/timeout semantics on top.

#pragma once

#include <fcntl.h>
#include <sys/socket.h>
#include <sys/uio.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "store.h"
#include "wire.h"

namespace tpuft {

enum DType : int32_t {
  DT_F32 = 0,
  DT_F64 = 1,
  DT_I32 = 2,
  DT_I64 = 3,
  DT_BF16 = 4,
  DT_U8 = 5,
  DT_I8 = 6,
};

enum RedOp : int32_t { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

inline size_t dtype_size(DType dt) {
  switch (dt) {
    case DT_F64:
    case DT_I64:
      return 8;
    case DT_F32:
    case DT_I32:
      return 4;
    case DT_BF16:
      return 2;
    default:
      return 1;
  }
}

inline float bf16_to_f32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

template <typename T>
inline void reduce_typed(T* acc, const T* in, size_t n, RedOp op) {
  switch (op) {
    case OP_SUM:
      for (size_t i = 0; i < n; ++i) acc[i] += in[i];
      break;
    case OP_MAX:
      for (size_t i = 0; i < n; ++i) acc[i] = acc[i] > in[i] ? acc[i] : in[i];
      break;
    case OP_MIN:
      for (size_t i = 0; i < n; ++i) acc[i] = acc[i] < in[i] ? acc[i] : in[i];
      break;
  }
}

inline void reduce_buffer(void* acc, const void* in, size_t nbytes, DType dt,
                          RedOp op) {
  switch (dt) {
    case DT_F32:
      reduce_typed(static_cast<float*>(acc), static_cast<const float*>(in),
                   nbytes / 4, op);
      break;
    case DT_F64:
      reduce_typed(static_cast<double*>(acc), static_cast<const double*>(in),
                   nbytes / 8, op);
      break;
    case DT_I32:
      reduce_typed(static_cast<int32_t*>(acc), static_cast<const int32_t*>(in),
                   nbytes / 4, op);
      break;
    case DT_I64:
      reduce_typed(static_cast<int64_t*>(acc), static_cast<const int64_t*>(in),
                   nbytes / 8, op);
      break;
    case DT_I8:
      reduce_typed(static_cast<int8_t*>(acc), static_cast<const int8_t*>(in),
                   nbytes, op);
      break;
    case DT_U8:
      reduce_typed(static_cast<uint8_t*>(acc), static_cast<const uint8_t*>(in),
                   nbytes, op);
      break;
    case DT_BF16: {
      auto* a = static_cast<uint16_t*>(acc);
      auto* b = static_cast<const uint16_t*>(in);
      size_t n = nbytes / 2;
      for (size_t i = 0; i < n; ++i) {
        float fa = bf16_to_f32(a[i]);
        float fb = bf16_to_f32(b[i]);
        float out = op == OP_SUM   ? fa + fb
                    : op == OP_MAX ? (fa > fb ? fa : fb)
                                   : (fa < fb ? fa : fb);
        a[i] = f32_to_bf16(out);
      }
      break;
    }
  }
}

struct CommError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// --- network emulation (mirror of communicator._NetEmu) ---------------------
//
// Deterministic sender-side pacing behind the SAME env knobs as the Python
// tier — TORCHFT_NET_EMU (named profile), TORCHFT_NET_GBPS /
// TORCHFT_NET_RTT_MS (raw overrides), TORCHFT_NET_CWND_KB (per-stream
// congestion-window cap) — so a cross-tier bench shapes both planes with
// one model: a process-shared link token bucket (one process = one
// emulated host NIC), a per-connection cwnd-limited stream bucket, and a
// half-RTT gate before each frame's first byte.  Profile names and values
// must match communicator._NET_EMU_PROFILES exactly (ftlint native-mirror
// checks them).

struct NetProfile {
  const char* name;
  double gbps;
  double rtt_ms;
};

// (name, link Gbit/s, RTT ms) — mirror of communicator._NET_EMU_PROFILES
constexpr NetProfile kNetEmuProfiles[] = {
    {"wan_1g", 1.0, 10.0},     {"wan_1g_10ms", 1.0, 10.0},
    {"dcn_10g", 10.0, 2.0},    {"dcn_10g_2ms", 10.0, 2.0},
    {"loopback", 0.0, 0.0},
};

class Pacer {
 public:
  // capped-accrual token bucket, the _StreamBucket math verbatim
  struct Bucket {
    double rate = 0.0;
    double burst = 0.0;
    double tokens = 0.0;
    std::chrono::steady_clock::time_point last;

    Bucket() = default;
    Bucket(double r, double b)
        : rate(r), burst(b), tokens(b), last(std::chrono::steady_clock::now()) {}

    size_t allow(size_t want) {
      auto now = std::chrono::steady_clock::now();
      tokens = std::min(
          burst, tokens + std::chrono::duration<double>(now - last).count() * rate);
      last = now;
      double cap = tokens < 0 ? 0.0 : tokens;
      return static_cast<size_t>(
          std::min<double>(static_cast<double>(want), cap));
    }
    void consume(size_t n) { tokens -= static_cast<double>(n); }
  };

  Pacer(double gbps, double rtt_ms, size_t cwnd_bytes)
      : bytes_per_s_(gbps * 1e9 / 8.0),
        rtt_s_(rtt_ms / 1e3),
        half_rtt_s_(rtt_ms / 2e3),
        cwnd_bytes_(cwnd_bytes) {
    stream_bytes_per_s_ = (cwnd_bytes_ > 0 && rtt_s_ > 0)
                              ? static_cast<double>(cwnd_bytes_) / rtt_s_
                              : 0.0;
    if (bytes_per_s_ > 0) {
      double burst = std::max<double>(64 << 10, bytes_per_s_ * 0.005);
      link_ = shared_link(bytes_per_s_, burst);
    }
  }

  // parse TORCHFT_NET_EMU / TORCHFT_NET_GBPS / TORCHFT_NET_RTT_MS /
  // TORCHFT_NET_CWND_KB; nullptr when unshaped.  An unknown profile is
  // LOUD (like the Python tier): a typo'd profile must not record
  // loopback numbers as a DCN run.
  static std::unique_ptr<Pacer> from_env() {
    const char* raw = std::getenv("TORCHFT_NET_EMU");
    std::string profile = raw ? raw : "";
    // strip + lowercase exactly like the Python _net_emu_from_env: a
    // trailing space from a YAML export must not fail only one tier
    while (!profile.empty() && std::isspace(profile.front()))
      profile.erase(profile.begin());
    while (!profile.empty() && std::isspace(profile.back()))
      profile.pop_back();
    std::transform(profile.begin(), profile.end(), profile.begin(), ::tolower);
    double prof_gbps = 0.0, prof_rtt = 0.0;
    if (!profile.empty()) {
      bool found = false;
      for (const auto& p : kNetEmuProfiles) {
        if (profile == p.name) {
          prof_gbps = p.gbps;
          prof_rtt = p.rtt_ms;
          found = true;
          break;
        }
      }
      if (!found)
        throw CommError("unknown TORCHFT_NET_EMU profile '" + profile + "'");
    }
    double gbps = env_double("TORCHFT_NET_GBPS", prof_gbps);
    double rtt_ms = env_double("TORCHFT_NET_RTT_MS", prof_rtt);
    size_t cwnd =
        static_cast<size_t>(env_double("TORCHFT_NET_CWND_KB", 256.0) * 1024);
    if (gbps <= 0 && rtt_ms <= 0) return nullptr;
    return std::make_unique<Pacer>(gbps, rtt_ms, cwnd);
  }

  double half_rtt_s() const { return half_rtt_s_; }
  double rtt_s() const { return rtt_s_; }
  double bytes_per_s() const { return bytes_per_s_; }
  double stream_bytes_per_s() const { return stream_bytes_per_s_; }

  // the largest grant allow() can ever return (the tightest engaged
  // bucket's burst) — callers batching paced sends must not wait for more
  size_t max_grant() const {
    double cap = 1e18;
    if (link_)
      cap = std::min(cap, std::max<double>(64 << 10, bytes_per_s_ * 0.005));
    if (stream_bytes_per_s_ > 0)
      cap = std::min(cap, static_cast<double>(cwnd_bytes_));
    return static_cast<size_t>(cap);
  }

  // RTT x bandwidth product — the natural frame size on this profile
  size_t bdp_bytes() const {
    if (bytes_per_s_ <= 0 || rtt_s_ <= 0) return 0;
    return static_cast<size_t>(bytes_per_s_ * rtt_s_);
  }

  // bytes the link (and, when RTT emulation is on, `stream`'s cwnd bucket)
  // permit right now (<= want); stream is the connection identity (its fd)
  size_t allow(size_t want, uint64_t stream) {
    if (link_) {
      std::lock_guard<std::mutex> lock(link_->mu);
      want = link_->bucket.allow(want);
    }
    if (stream_bytes_per_s_ > 0 && want > 0) {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = streams_.find(stream);
      if (it == streams_.end())
        it = streams_
                 .emplace(stream, Bucket(stream_bytes_per_s_,
                                         static_cast<double>(cwnd_bytes_)))
                 .first;
      want = it->second.allow(want);
    }
    return want;
  }

  void consume(size_t n, uint64_t stream) {
    if (link_) {
      std::lock_guard<std::mutex> lock(link_->mu);
      link_->bucket.consume(n);
    }
    if (stream_bytes_per_s_ > 0) {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = streams_.find(stream);
      if (it != streams_.end()) it->second.consume(n);
    }
  }

 private:
  struct Link {
    std::mutex mu;
    Bucket bucket;
  };

  // the LINK bucket is process-shared (one process = one emulated host
  // NIC, communicator._LinkBucket): every communicator in the process
  // draws from the same bucket keyed by the link parameters
  static Link* shared_link(double rate, double burst) {
    static std::mutex registry_mu;
    static std::map<std::pair<double, double>, std::unique_ptr<Link>> registry;
    std::lock_guard<std::mutex> lock(registry_mu);
    auto key = std::make_pair(rate, burst);
    auto it = registry.find(key);
    if (it == registry.end()) {
      auto link = std::make_unique<Link>();
      link->bucket = Bucket(rate, burst);
      it = registry.emplace(key, std::move(link)).first;
    }
    return it->second.get();
  }

  static double env_double(const char* name, double fallback) {
    const char* v = std::getenv(name);
    if (!v || !*v) return fallback;
    char* end = nullptr;
    double out = std::strtod(v, &end);
    if (end == v)
      throw CommError(std::string("unparseable ") + name + "=" + v);
    return out;
  }

  double bytes_per_s_;
  double rtt_s_;
  double half_rtt_s_;
  size_t cwnd_bytes_;
  double stream_bytes_per_s_ = 0.0;
  Link* link_ = nullptr;
  std::mutex mu_;
  std::map<uint64_t, Bucket> streams_;
};

// Parallel-connection ("lane") config for striped collectives — must agree
// with the Python tier (torchft_tpu_torch/communicator.py _ring_lanes /
// _stripe_floor) and be uniform across ranks (verified in the rendezvous
// hello).  "auto" resolves exactly like the Python tier: enough lanes that
// the aggregate cwnd-limited stream rate reaches the emulated link rate
// (capped at kMaxAutoLanes), 1 when unshaped.
constexpr size_t kMaxAutoLanes = 4;  // mirror of communicator._MAX_AUTO_LANES
constexpr size_t kMinStripeBytes =
    size_t(64) << 10;  // mirror of communicator._MIN_STRIPE_BYTES

inline size_t ring_lanes_from_env(const Pacer* pacer) {
  const char* v = std::getenv("TORCHFT_RING_LANES");
  if (v && *v && std::string(v) != "auto") {
    long n = std::strtol(v, nullptr, 10);
    return n >= 1 ? static_cast<size_t>(n) : 1;
  }
  if (!pacer || pacer->stream_bytes_per_s() <= 0 || pacer->bytes_per_s() <= 0)
    return 1;
  size_t link = static_cast<size_t>(pacer->bytes_per_s());
  size_t stream =
      std::max<size_t>(1, static_cast<size_t>(pacer->stream_bytes_per_s()));
  size_t need = (link + stream - 1) / stream;
  return std::max<size_t>(1, std::min(kMaxAutoLanes, need));
}

inline size_t stripe_floor_from_env(const Pacer* pacer) {
  const char* v = std::getenv("TORCHFT_RING_FRAME_KB");
  if (v && *v && std::string(v) != "auto") {
    double kb = std::strtod(v, nullptr);
    size_t b = static_cast<size_t>(kb * 1024);
    return b < 64 ? 64 : b;
  }
  if (pacer) {
    size_t bdp = pacer->bdp_bytes();
    if (bdp > 0)
      // jumbo frames on DCN: one sub-frame covers at least a BDP so the
      // half-RTT frame gate amortizes (mirror of communicator._stripe_floor)
      return std::max(kMinStripeBytes, std::min(bdp, size_t(8) << 20));
  }
  return kMinStripeBytes;
}

// --- scatter-gather framing --------------------------------------------------
//
// One logical frame may be backed by MANY caller buffers (a gradient
// bucket's arrays, quantized rows + scales, chunked outer shards).  The
// iovec plumbing below sends and receives such frames with sendmsg /
// recvmsg straight against the callers' memory — the payload is never
// assembled in a staging copy on either side.

// max payload iovec segments per sendmsg/recvmsg call (the header rides as
// one more); bounded well under IOV_MAX.  The batching is this file's
// alone: the binding passes whole buffer lists, so nothing in Python
// mirrors it.
constexpr size_t kMaxIovSegs = 64;

// paced sends coalesce token dribbles: below this floor (clamped to half
// the pacer's max grant) the sender naps briefly instead of issuing a
// sendmsg per few-KB accrual — the nap is short enough that the bucket
// (whose burst is at least twice the floor) never tops out and wastes
// tokens even when a loaded host oversleeps
constexpr size_t kPaceMinSendBytes = 32 << 10;

// Walks a logical byte range expressed as iovec segments; fill() emits a
// bounded iovec batch for one sendmsg/recvmsg, advance() consumes it.
class IovCursor {
 public:
  IovCursor() = default;
  explicit IovCursor(std::vector<struct iovec> iov) : iov_(std::move(iov)) {
    for (const auto& v : iov_) remaining_ += v.iov_len;
  }

  size_t remaining() const { return remaining_; }

  // fill up to max_segs entries covering at most max_bytes, starting at
  // the cursor; returns the entry count (0 when exhausted or clamped)
  int fill(struct iovec* out, size_t max_segs, size_t max_bytes) const {
    size_t idx = idx_, off = off_, budget = max_bytes;
    size_t cnt = 0;
    while (idx < iov_.size() && cnt < max_segs && budget > 0) {
      uint8_t* base = static_cast<uint8_t*>(iov_[idx].iov_base) + off;
      size_t len = std::min(iov_[idx].iov_len - off, budget);
      if (len == 0) break;
      out[cnt].iov_base = base;
      out[cnt].iov_len = len;
      ++cnt;
      budget -= len;
      ++idx;
      off = 0;
    }
    return static_cast<int>(cnt);
  }

  void advance(size_t n) {
    remaining_ -= n;
    while (n > 0) {
      size_t left = iov_[idx_].iov_len - off_;
      if (n < left) {
        off_ += n;
        return;
      }
      n -= left;
      ++idx_;
      off_ = 0;
    }
  }

 private:
  std::vector<struct iovec> iov_;
  size_t idx_ = 0;
  size_t off_ = 0;
  size_t remaining_ = 0;
};

// A logical contiguous byte space backed by scattered segments (one per
// caller buffer).  Ring chunk math runs over LOGICAL offsets; the IO layer
// resolves them to segment slices at the syscall boundary.  Segment
// boundaries fall between whole arrays of one dtype, so an element never
// straddles segments and per-segment reduction is exact.
class ScatterView {
 public:
  ScatterView(void* data, size_t nbytes) : total_(nbytes) {
    segs_.emplace_back(static_cast<uint8_t*>(data), nbytes);
    starts_.push_back(0);
  }

  ScatterView(void* const* bufs, const uint64_t* lens, size_t n) {
    size_t off = 0;
    for (size_t i = 0; i < n; ++i) {
      if (lens[i] == 0) continue;
      segs_.emplace_back(static_cast<uint8_t*>(bufs[i]),
                         static_cast<size_t>(lens[i]));
      starts_.push_back(off);
      off += lens[i];
    }
    total_ = off;
  }

  size_t size() const { return total_; }

  // iovec list covering logical [off, off+len)
  std::vector<struct iovec> slice(size_t off, size_t len) const {
    std::vector<struct iovec> out;
    if (len == 0) return out;
    size_t i = seg_at(off);
    while (len > 0) {
      size_t seg_off = off - starts_[i];
      size_t take = std::min(segs_[i].second - seg_off, len);
      out.push_back({segs_[i].first + seg_off, take});
      off += take;
      len -= take;
      ++i;
    }
    return out;
  }

  // pointer when [off, off+len) lies inside ONE segment, else nullptr
  uint8_t* contiguous(size_t off, size_t len) const {
    size_t i = seg_at(off);
    size_t seg_off = off - starts_[i];
    if (segs_[i].second - seg_off >= len) return segs_[i].first + seg_off;
    return nullptr;
  }

  // acc[off : off+len] ?= src, segment crossings handled (boundaries are
  // element-aligned by construction)
  void reduce_in(size_t off, const void* src, size_t len, DType dt, RedOp op) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    size_t i = seg_at(off);
    while (len > 0) {
      size_t seg_off = off - starts_[i];
      size_t take = std::min(segs_[i].second - seg_off, len);
      reduce_buffer(segs_[i].first + seg_off, s, take, dt, op);
      s += take;
      off += take;
      len -= take;
      ++i;
    }
  }

 private:
  size_t seg_at(size_t off) const {
    // binary search the covering segment
    size_t lo = 0, hi = starts_.size();
    while (lo + 1 < hi) {
      size_t mid = (lo + hi) / 2;
      if (starts_[mid] <= off)
        lo = mid;
      else
        hi = mid;
    }
    return lo;
  }

  std::vector<std::pair<uint8_t*, size_t>> segs_;
  std::vector<size_t> starts_;
  size_t total_ = 0;
};

// --- per-lane worker threads -------------------------------------------------
//
// One persistent tx and one persistent rx worker per (peer, lane) link,
// replacing the short-lived thread spawns of the round-1 build (a thread
// create + join per frame part per ring step).  Workers are created
// lazily at first use, live for the epoch, and drain with errors after
// abort() (sockets are shut down, so blocked IO returns immediately).

class LanePool {
 public:
  static constexpr int kTx = 0;
  static constexpr int kRx = 1;

  ~LanePool() { shutdown(); }

  void submit(int64_t peer, size_t lane, int dir, std::function<void()> fn) {
    // shared_ptr, not a raw pointer: shutdown() (a foreign thread's
    // configure() superseding this epoch) may join AND DESTROY the worker
    // between our mu_ release and the w->mu acquire below — the copy keeps
    // the Worker alive until this submit is done with it
    std::shared_ptr<Worker> w;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (!stopped_) {
        uint64_t key = (static_cast<uint64_t>(peer) << 16) |
                       (static_cast<uint64_t>(lane & 0x7FFF) << 1) |
                       static_cast<uint64_t>(dir & 1);
        auto it = workers_.find(key);
        if (it == workers_.end()) {
          it = workers_.emplace(key, std::make_shared<Worker>()).first;
          Worker* raw = it->second.get();
          raw->th = std::thread([raw] { raw->run(); });
        }
        w = it->second;
      }
    }
    if (w == nullptr) {
      // pool already stopped (epoch superseded): run inline — the task
      // fails fast against the shut-down sockets, releasing its latch
      fn();
      return;
    }
    {
      std::lock_guard<std::mutex> lock(w->mu);
      if (!w->stop) {
        w->q.push_back(std::move(fn));
        w->cv.notify_one();
        return;
      }
      // shutdown() won the race between our stopped_ check and this
      // enqueue: the worker may already have drained and exited, so a
      // task pushed now would sit in the queue forever and its latch
      // would never release — run inline instead (fails fast like the
      // pool-stopped path above)
    }
    fn();
  }

  void shutdown() {
    std::map<uint64_t, std::shared_ptr<Worker>> workers;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (stopped_) return;
      stopped_ = true;
      workers.swap(workers_);
    }
    for (auto& [key, w] : workers) {
      {
        std::lock_guard<std::mutex> lock(w->mu);
        w->stop = true;
      }
      w->cv.notify_all();
      if (w->th.joinable()) w->th.join();
    }
  }

 private:
  struct Worker {
    std::thread th;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::function<void()>> q;
    bool stop = false;

    void run() {
      while (true) {
        std::function<void()> fn;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv.wait(lock, [&] { return stop || !q.empty(); });
          if (q.empty()) return;  // stop requested and drained
          fn = std::move(q.front());
          q.pop_front();
        }
        fn();
      }
    }
  };

  std::mutex mu_;
  bool stopped_ = false;
  std::map<uint64_t, std::shared_ptr<Worker>> workers_;
};

// completion latch for a fan-out of lane tasks; collects the first error
struct OpLatch {
  std::mutex mu;
  std::condition_variable cv;
  size_t pending = 0;
  std::string err;

  void add(size_t n) {
    std::lock_guard<std::mutex> lock(mu);
    pending += n;
  }
  void done(const std::string& e) {
    std::lock_guard<std::mutex> lock(mu);
    if (!e.empty() && err.empty()) err = e;
    if (--pending == 0) cv.notify_all();
  }
  // wait without throwing; returns the first error ("" when clean)
  std::string wait_quiet() {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [&] { return pending == 0; });
    return err;
  }
  void wait() {
    std::string e = wait_quiet();
    if (!e.empty()) throw CommError(e);
  }
};

// --- hierarchical topology (leader ring) ------------------------------------
//
// Mirror of the Python tier's host grouping (communicator.py _HostTopology)
// so the tiers agree on the hierarchical WIRE SCHEDULE: hosts are ordered
// by their SMALLEST global rank, each host's leader IS that rank, and
// cross-host collectives run over the leader ring in that order (ring
// position replaces rank in the chunk schedule — see the `ring` parameter
// of ring_reduce_phase / ring_allgather_phase).  The shared-memory
// intra-host hop is host-local and never crosses tiers.  NOTE: this tier's
// configure() does not yet publish `topo_{rank}` keys, so a native rank in
// a group makes the Python ranks' "auto" fall back to the flat ring (and a
// forced TORCHFT_HIERARCHICAL=1 fail loudly); these helpers pin the math a
// full native topology integration must reproduce byte-for-byte.
// (tier.py data_plane_tier() downgrades auto-mode native selection to the
// Python tier whenever hierarchical dispatch is forced on, logging it.)

// TORCHFT_HIERARCHICAL: "auto" (default) | "0" | "1" — must be uniform
// across replicas, like TORCHFT_RING_LANES.
inline std::string hierarchical_mode_from_env() {
  const char* v = std::getenv("TORCHFT_HIERARCHICAL");
  std::string s = v ? v : "auto";
  if (s.empty() || s == "auto") return "auto";
  if (s == "1" || s == "true" || s == "on") return "1";
  if (s == "0" || s == "false" || s == "off") return "0";
  throw CommError("unparseable TORCHFT_HIERARCHICAL=" + s + " (auto|0|1)");
}

// TORCHFT_HOST_ID overrides the host identity (default: the advertised
// rendezvous address' host part — same-IP grouping).
inline std::string host_id_from_env(const std::string& fallback) {
  const char* v = std::getenv("TORCHFT_HOST_ID");
  return (v && *v) ? std::string(v) : fallback;
}

struct HostTopology {
  std::vector<std::vector<int64_t>> hosts;  // ordered by min global rank
  std::vector<int64_t> leader_ring;         // hosts[i][0] for each host

  // identical grouping math to the Python tier: ranks ascend within a
  // host, hosts order by their first (smallest) rank
  static HostTopology build(const std::map<int64_t, std::string>& host_of) {
    std::map<std::string, std::vector<int64_t>> groups;
    for (const auto& kv : host_of) groups[kv.second].push_back(kv.first);
    HostTopology t;
    for (const auto& kv : groups) t.hosts.push_back(kv.second);
    std::sort(t.hosts.begin(), t.hosts.end(),
              [](const std::vector<int64_t>& a, const std::vector<int64_t>& b) {
                return a.front() < b.front();
              });
    for (const auto& g : t.hosts) t.leader_ring.push_back(g.front());
    return t;
  }

  // the "auto" criterion, mirrored: >= 2 hosts AND a multi-member host
  bool worth_it() const {
    if (hosts.size() < 2) return false;
    for (const auto& g : hosts)
      if (g.size() > 1) return true;
    return false;
  }
};

// High bit of the hello's rank field marks the extended (multi-lane) hello:
// (rank|flag, lane, lane count, stripe floor).  Must match the Python
// tier's _LANE_HELLO_FLAG.
constexpr uint64_t kLaneHelloFlag = uint64_t(1) << 63;

// Explicit reduce_scatter API calls ride their own tag window, clear of
// the allreduce rings — mirror of wire.RING_REDUCE_TAG_BASE (the round-1
// build framed them at tag base 0, colliding with a Python peer's 30000
// window; mixed-tier meshes now pin this).
constexpr uint64_t kRingReduceTagBase = 30000;

// Flight-recorder event ids, mirror of the data-plane block of
// obs/flight.py FlightEvent (the ftlint native-mirror checker pins every
// kFlight* value against the Python enum).  The native tier records its
// epoch lifecycle into a fixed-slot ring drained into the Python dump via
// tpuft_comm_flight_drain.
constexpr uint32_t kFlightCommConfigure = 20;
constexpr uint32_t kFlightCommAbort = 21;
constexpr size_t kFlightRingSlots = 256;

// one C-side flight event: monotonic stamp (steady_clock seconds — the
// same CLOCK_MONOTONIC base as Python time.monotonic() on Linux) plus two
// small integer payload fields (rank/world for configure)
struct FlightSlot {
  uint64_t seq = 0;
  double t = 0.0;
  uint32_t ev = 0;
  int64_t a = 0;
  int64_t b = 0;
};

// Per-epoch IO state: the pacer, the per-lane counters, and the lane
// config they index.  Ops snapshot ONE shared_ptr at entry — configure()
// swaps in a fresh instance while a superseded op thread may still be
// mid-IO on the old epoch's state, and the shared_ptr keeps that state
// alive exactly as long as any late op references it (the same doctrine
// as the fd graveyard, without unbounded growth or torn pointer reads).
struct EpochIO {
  std::unique_ptr<Pacer> pacer;
  size_t lanes = 1;
  size_t stripe_floor = kMinStripeBytes;
  // the epoch's identity rides the snapshot too: an op body that read
  // rank_/world_size_ more than once could see configure() move them
  // between loads (size a vector from the old world, index it with the
  // new one — an out-of-bounds write, not just a stale value).  One
  // io_snapshot() at op entry yields all-or-nothing epoch state.
  int64_t rank = 0;
  int64_t world = 1;
  // per-lane observability: payload bytes moved and stall events (pacer
  // denials / kernel would-block), names mirroring _TcpMesh lane_tx_bytes
  // / lane_rx_bytes / lane_stalls
  std::unique_ptr<std::atomic<uint64_t>[]> tx, rx, stalls;

  void alloc_counters() {
    tx.reset(new std::atomic<uint64_t>[lanes]());
    rx.reset(new std::atomic<uint64_t>[lanes]());
    stalls.reset(new std::atomic<uint64_t>[lanes]());
  }
  void stall(size_t lane) {
    if (stalls && lane < lanes)
      stalls[lane].fetch_add(1, std::memory_order_relaxed);
  }
  void add_tx(size_t lane, size_t n) {
    if (tx && lane < lanes) tx[lane].fetch_add(n, std::memory_order_relaxed);
  }
  void add_rx(size_t lane, size_t n) {
    if (rx && lane < lanes) rx[lane].fetch_add(n, std::memory_order_relaxed);
  }

  // half-RTT gate before a frame's first byte (mirror of the Python
  // exchange loop's frame_gates) — the pacer's RTT model, not a stall
  void gate() const {
    if (!pacer || pacer->half_rtt_s() <= 0) return;
    std::this_thread::sleep_for(
        std::chrono::duration<double>(pacer->half_rtt_s()));
  }

  // deterministic per-lane split of one frame; identical math to the
  // Python tier (_lane_parts) — see Communicator::lane_parts
  std::vector<std::pair<size_t, size_t>> lane_parts(size_t nbytes) const {
    if (lanes <= 1 || nbytes < 2 * stripe_floor) return {{0, nbytes}};
    size_t k = std::min(lanes, std::max<size_t>(1, nbytes / stripe_floor));
    if (k <= 1) return {{0, nbytes}};
    std::vector<size_t> bounds{0};
    for (size_t i = 1; i < k; ++i) {
      size_t cut = (i * nbytes / k) / 64 * 64;
      bounds.push_back(std::max(cut, bounds.back()));
    }
    bounds.push_back(nbytes);
    std::vector<std::pair<size_t, size_t>> parts;
    for (size_t i = 0; i < k; ++i) parts.emplace_back(bounds[i], bounds[i + 1]);
    return parts;
  }
};

using IoPtr = std::shared_ptr<EpochIO>;

class Communicator {
 public:
  explicit Communicator(double timeout_s)
      : timeout_s_(timeout_s), io_(std::make_shared<EpochIO>()) {}

  ~Communicator() {
    abort();
    {
      std::shared_ptr<LanePool> pool;
      {
        std::lock_guard<std::mutex> lock(state_mu_);
        pool = std::move(pool_);
      }
      if (pool) pool->shutdown();
    }
    close_peers();
  }

  // Rendezvous over the store: publish our listener under "{prefix}/{rank}";
  // for each pair (i, j) with i < j, j dials i — once per LANE.  Lanes are
  // parallel TCP connections one logical collective stripes frames across
  // (lane_parts); the Python tier (_TcpMesh) speaks the identical protocol:
  // legacy 8-byte hello (rank) at 1 lane, 32-byte `(rank|flag, lane, lane
  // count, stripe floor)` hello otherwise, lane count verified loudly.
  // store_prefixed_addr is "host:port/prefix/..." exactly like the Python
  // tier.
  void configure(const std::string& store_prefixed_addr, int64_t rank,
                 int64_t world_size) {
    abort();  // supersede any previous epoch
    std::shared_ptr<LanePool> old_pool;
    {
      // old fds go to the graveyard (closed at destruction): an op thread
      // may still reference them, and closing now could recycle fd numbers
      std::lock_guard<std::mutex> lock(state_mu_);
      for (auto& [peer, fds] : peers_)
        for (int fd : fds) graveyard_.push_back(fd);
      peers_.clear();
      old_pool = std::move(pool_);
    }
    // join the superseded epoch's lane workers: their sockets are shut
    // down, so any in-flight task errors out within one IO quantum
    if (old_pool) old_pool->shutdown();
    // fresh per-epoch IO state; a superseded op thread keeps the OLD
    // instance alive through its own shared_ptr snapshot.  NOTHING is
    // published until the rendezvous is complete: ops racing configure()
    // keep failing fast on the latched abort + the old (cleared) peers
    // instead of seeing a half-built epoch (e.g. the new rank with the
    // old caller's buffer sizes), and abort is un-latched only after the
    // whole epoch — io, pool, peers — lands in one lock section.
    auto io = std::make_shared<EpochIO>();
    io->pacer = Pacer::from_env();
    io->lanes = ring_lanes_from_env(io->pacer.get());
    io->stripe_floor = stripe_floor_from_env(io->pacer.get());
    io->rank = rank;
    io->world = world_size;
    io->alloc_counters();
    const size_t lanes = io->lanes;
    const size_t stripe_floor = io->stripe_floor;
    auto publish = [&](std::map<int64_t, std::vector<int>> peers) {
      {
        std::lock_guard<std::mutex> lock(state_mu_);
        io_ = std::move(io);
        pool_ = std::make_shared<LanePool>();
        peers_ = std::move(peers);
      }
      lanes_ = lanes;
      stripe_floor_ = stripe_floor;
      rank_ = rank;
      world_size_ = world_size;
      aborted_ = false;
      flight_epochs_.fetch_add(1);
      flight_record(kFlightCommConfigure, rank, world_size);
    };
    if (world_size <= 1) {
      publish({});
      return;
    }

    auto slash = store_prefixed_addr.find('/');
    std::string store_addr = store_prefixed_addr.substr(0, slash);
    std::string prefix = slash == std::string::npos
                             ? std::string("root")
                             : store_prefixed_addr.substr(slash + 1);

    StoreClient store(store_addr, timeout_s_);

    int port = 0;
    int listen_fd = listen_on("0.0.0.0:0", &port);
    char host[256];
    ::gethostname(host, sizeof(host));
    std::string host_str(host);
    {
      // prefer a dialable address even on hosts with odd hostname setup
      addrinfo hints{}, *res = nullptr;
      hints.ai_family = AF_INET;
      if (::getaddrinfo(host_str.c_str(), nullptr, &hints, &res) != 0 || !res)
        host_str = "127.0.0.1";
      if (res) ::freeaddrinfo(res);
    }
    store.set(prefix + "/" + std::to_string(rank),
              host_str + ":" + std::to_string(port));

    // accept from higher ranks on a helper thread while dialing lower ranks
    int expected_inbound =
        static_cast<int>((world_size - rank - 1) * lanes);
    std::map<int64_t, std::vector<int>> inbound;
    std::string accept_err;
    // bound the whole accept phase: a dead higher-rank peer must not wedge
    // configure() (the Python twin sets listener.settimeout(timeout_s))
    set_recv_timeout(listen_fd, timeout_s_);
    std::thread acceptor([&] {
      try {
        for (int i = 0; i < expected_inbound; ++i) {
          int conn = ::accept(listen_fd, nullptr, nullptr);
          if (conn < 0)
            throw CommError("rendezvous accept timed out or failed");
          configure_socket(conn);
          set_recv_timeout(conn, timeout_s_);
          uint64_t first;
          recv_exact(conn, &first, 8);
          if (!(first & kLaneHelloFlag)) {
            // legacy 8-byte hello: a single-lane peer.  A lane mismatch is
            // a config error — fail LOUDLY instead of desynchronizing.
            if (lanes != 1)
              throw CommError(
                  "lane-count mismatch: rank " + std::to_string(first) +
                  " has 1 lane, we have " + std::to_string(lanes) +
                  " (TORCHFT_RING_LANES must be uniform)");
            auto& fds = inbound[static_cast<int64_t>(first)];
            fds.assign(1, conn);
          } else {
            uint64_t tail[3];  // lane, lane count, stripe floor
            recv_exact(conn, tail, 24);
            uint64_t peer_rank = first & ~kLaneHelloFlag;
            if (tail[1] != lanes)
              throw CommError(
                  "lane-count mismatch: rank " + std::to_string(peer_rank) +
                  " has " + std::to_string(tail[1]) + " lanes, we have " +
                  std::to_string(lanes) +
                  " (TORCHFT_RING_LANES must be uniform)");
            if (tail[2] != stripe_floor)
              throw CommError(
                  "stripe-floor mismatch: rank " + std::to_string(peer_rank) +
                  " has " + std::to_string(tail[2]) + " bytes, we have " +
                  std::to_string(stripe_floor) +
                  " (TORCHFT_RING_FRAME_KB must be uniform)");
            if (tail[0] >= lanes)
              throw CommError(
                  "lane index out of range in hello from rank " +
                  std::to_string(peer_rank) + ": lane " +
                  std::to_string(tail[0]) + " >= " + std::to_string(lanes));
            auto& fds = inbound[static_cast<int64_t>(peer_rank)];
            if (fds.size() < lanes) fds.resize(lanes, -1);
            fds[tail[0]] = conn;
          }
        }
      } catch (const std::exception& e) {
        accept_err = e.what();
      }
    });

    std::map<int64_t, std::vector<int>> fresh;
    try {
      for (int64_t peer = 0; peer < rank; ++peer) {
        std::string addr =
            store.get(prefix + "/" + std::to_string(peer), timeout_s_);
        auto& fds = fresh[peer];
        for (size_t lane = 0; lane < lanes; ++lane) {
          int fd = dial(addr, timeout_s_);
          if (lanes == 1) {
            uint64_t my_rank = static_cast<uint64_t>(rank);
            send_all(fd, &my_rank, 8);
          } else {
            uint64_t hello[4] = {static_cast<uint64_t>(rank) | kLaneHelloFlag,
                                 lane, lanes, stripe_floor};
            send_all(fd, hello, 32);
          }
          fds.push_back(fd);
        }
      }
      acceptor.join();
      if (!accept_err.empty())
        throw CommError("rendezvous accept failed: " + accept_err);
      for (auto& [peer, fds] : inbound) fresh[peer] = fds;
    } catch (...) {
      if (acceptor.joinable()) acceptor.join();
      for (auto& [peer, fds] : fresh)
        for (int fd : fds) ::close(fd);
      ::close(listen_fd);
      throw;
    }
    ::close(listen_fd);

    for (auto& [peer, fds] : fresh) {
      for (int fd : fds) {
        // NB: no explicit SO_SNDBUF/SO_RCVBUF — setting them disables the
        // kernel's TCP buffer autotuning, which reaches larger effective
        // windows than the rmem/wmem_max caps allow explicitly
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        // blocking IO with a short timeout quantum: throughput of plain
        // send/recv, abort/deadline checks every quantum on EAGAIN
        timeval tv{0, 200000};  // 200ms
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      }
    }
    publish(std::move(fresh));
  }

  void abort() {
    // Shut sockets down (don't close): an op thread may be mid-IO on these
    // fds; shutdown unblocks its IO with errors while keeping fd numbers
    // valid.  close happens at destruction.
    // flight: record the transition once per live epoch (configure() calls
    // abort() to supersede, so a bare flag write would log boot noise)
    if (!aborted_.exchange(true) && flight_epochs_.load() > 0)
      flight_record(kFlightCommAbort, 0, 0);
    std::lock_guard<std::mutex> lock(state_mu_);
    for (auto& [peer, fds] : peers_)
      for (int fd : fds) ::shutdown(fd, SHUT_RDWR);
  }

  // -- flight recorder (C-side fixed-slot ring; obs/flight.py merges it) ---

  void flight_record(uint32_t ev, int64_t a, int64_t b) {
    std::lock_guard<std::mutex> lock(flight_mu_);
    FlightSlot& slot = flight_[flight_seq_ % kFlightRingSlots];
    slot.seq = flight_seq_++;
    slot.t = std::chrono::duration<double>(
                 std::chrono::steady_clock::now().time_since_epoch())
                 .count();
    slot.ev = ev;
    slot.a = a;
    slot.b = b;
  }

  // Consume-drain the ring oldest-first into the caller's arrays (up to
  // `cap` events); already-drained and overwritten slots are skipped, so
  // repeated drains across dumps never duplicate an event.  Returns the
  // number of events copied.
  size_t flight_drain(uint64_t* seqs, double* ts, uint32_t* evs, int64_t* a,
                      int64_t* b, size_t cap) {
    std::lock_guard<std::mutex> lock(flight_mu_);
    uint64_t oldest =
        flight_seq_ > kFlightRingSlots ? flight_seq_ - kFlightRingSlots : 0;
    uint64_t start = std::max(flight_drained_, oldest);
    size_t n = 0;
    for (uint64_t s = start; s < flight_seq_ && n < cap; ++s, ++n) {
      const FlightSlot& slot = flight_[s % kFlightRingSlots];
      seqs[n] = slot.seq;
      ts[n] = slot.t;
      evs[n] = slot.ev;
      a[n] = slot.a;
      b[n] = slot.b;
    }
    flight_drained_ = start + n;
    return n;
  }

  void close_peers() {
    std::lock_guard<std::mutex> lock(state_mu_);
    for (auto& [peer, fds] : peers_)
      for (int fd : fds) ::close(fd);
    peers_.clear();
    for (int fd : graveyard_) ::close(fd);
    graveyard_.clear();
  }

  std::map<int64_t, std::vector<int>> peers_snapshot() const {
    std::lock_guard<std::mutex> lock(state_mu_);
    return peers_;
  }

  // deterministic per-lane split of one frame; identical math to the Python
  // tier (_lane_parts): both endpoints derive the split from the frame
  // length alone, 64-byte aligned so no element ever straddles lanes
  std::vector<std::pair<size_t, size_t>> lane_parts(size_t nbytes) const {
    size_t lanes = lanes_, stripe_floor = stripe_floor_;  // one read each
    if (lanes <= 1 || nbytes < 2 * stripe_floor) return {{0, nbytes}};
    size_t k = std::min(lanes, std::max<size_t>(1, nbytes / stripe_floor));
    if (k <= 1) return {{0, nbytes}};
    std::vector<size_t> bounds{0};
    for (size_t i = 1; i < k; ++i) {
      size_t cut = (i * nbytes / k) / 64 * 64;
      bounds.push_back(std::max(cut, bounds.back()));
    }
    bounds.push_back(nbytes);
    std::vector<std::pair<size_t, size_t>> parts;
    for (size_t i = 0; i < k; ++i) parts.emplace_back(bounds[i], bounds[i + 1]);
    return parts;
  }

  // deterministic per-replica shard split for the sharded outer optimizer;
  // identical math to the Python tier (communicator.outer_shard_parts): the
  // buffer is padded to a multiple of parts*unit and every shard is exactly
  // padded/parts bytes, so both tiers agree on shard ownership from the
  // payload size and participant count alone.  `unit` must be a positive
  // multiple of 64 (64 for raw f32 shards, the quantization row byte size
  // for int8 shards, so a boundary never splits a row).
  static std::vector<std::pair<size_t, size_t>> outer_shard_parts(
      size_t nbytes, size_t parts, size_t unit = 64) {
    if (parts < 1 || unit < 1 || unit % 64 != 0)
      throw std::invalid_argument("outer_shard_parts: bad parts/unit");
    size_t share = (nbytes + parts * unit - 1) / (parts * unit) * unit;
    std::vector<std::pair<size_t, size_t>> out;
    out.reserve(parts);
    for (size_t p = 0; p < parts; ++p)
      out.emplace_back(p * share, (p + 1) * share);
    return out;
  }

  int64_t rank() const { return rank_; }
  int64_t size() const { return world_size_; }
  size_t lanes() const { return lanes_; }
  size_t stripe_floor() const { return stripe_floor_; }
  void set_timeout(double t) { timeout_s_ = t; }

  // per-lane observability counters of the current epoch (payload bytes
  // moved + stall events: pacer denials / kernel would-block), the same
  // counters TCPCommunicator.lane_stats() exports — surfaced through
  // native.py so manager.last_quorum_timings is tier-agnostic.  Returns
  // the lane count; fills up to `cap` entries per array.
  size_t lane_stats(uint64_t* tx, uint64_t* rx, uint64_t* stalls,
                    size_t cap) const {
    IoPtr io = io_snapshot();
    if (!io->tx) return 0;
    for (size_t i = 0; i < std::min(io->lanes, cap); ++i) {
      tx[i] = io->tx[i].load(std::memory_order_relaxed);
      rx[i] = io->rx[i].load(std::memory_order_relaxed);
      stalls[i] = io->stalls[i].load(std::memory_order_relaxed);
    }
    return io->lanes;
  }

  // -- collectives (synchronous; caller provides an op thread) -------------

  // In-place ring allreduce over a contiguous buffer.
  void allreduce(void* data, size_t nbytes, DType dt, RedOp op) {
    ScatterView view(data, nbytes);
    IoPtr io = io_snapshot();
    allreduce_ring_io(io, view, dt, op, full_ring(io->world));
  }

  // In-place ring allreduce over MANY caller buffers treated as one
  // logical payload — the zero-copy multi-array path: frames are sent with
  // sendmsg straight from the callers' memory and received with recvmsg
  // straight into it; the payload is never assembled in a staging copy.
  // Every buffer must hold whole elements of `dt` (the Python binding
  // groups arrays by dtype), so chunk math never splits an element.
  void allreduce_iov(void* const* bufs, const uint64_t* lens, size_t n,
                     DType dt, RedOp op) {
    ScatterView view(bufs, lens, n);
    IoPtr io = io_snapshot();
    allreduce_ring_io(io, view, dt, op, full_ring(io->world));
  }

  // Ring allreduce over a RANK SUBSET (global ranks in ring order) — the
  // hierarchical leader ring.  Ring position replaces rank in the chunk
  // schedule; the full ring compiles to the identical legacy schedule
  // (position == rank), and the Python tier's `ring=` parameter speaks the
  // same frames, so mixed-tier leader rings interoperate.
  void allreduce_ring(void* data, size_t nbytes, DType dt, RedOp op,
                      const std::vector<int64_t>& ring) {
    ScatterView view(data, nbytes);
    allreduce_ring(view, dt, op, ring);
  }

  void allreduce_ring(ScatterView& view, DType dt, RedOp op,
                      const std::vector<int64_t>& ring) {
    allreduce_ring_io(io_snapshot(), view, dt, op, ring);
  }

  void allreduce_ring_io(IoPtr io, ScatterView& view, DType dt, RedOp op,
                         const std::vector<int64_t>& ring) {
    if (ring.size() <= 1) return;
    size_t esz = dtype_size(dt);
    auto deadline = deadline_in(timeout_s_);
    auto bounds = ring_bounds(view.size() / esz, ring.size());

    // shift -1 on BOTH phases: the Python tier's schedule (ring position p
    // ends the reduce phase owning chunk p, the conventional contract —
    // communicator._ring_reduce_scatter sends pos-step-1 / recvs
    // pos-step-2, then allgather sends pos-step / recvs pos-step-1).  The
    // round-1 build ran the textbook shift-0 schedule here: correct alone,
    // but chunk indices landed rotated by one against a Python peer — a
    // silent cross-tier corruption the constant-fill interop test never
    // saw (mixed-tier bit-identity tests now pin this).
    ring_reduce_phase(io, view, bounds, esz, dt, op, /*shift=*/-1, deadline,
                      ring, /*tag_base=*/0);
    ring_allgather_phase(io, view, bounds, esz, /*shift=*/-1, deadline, ring,
                         /*tag_base=*/0);
  }

  // reduce-scatter: `data` is reduced in place ring-wise; this rank's chunk
  // (chunk `rank` of ws near-equal chunks over the flattened elements) ends
  // up fully reduced and is copied into `out`.  Returns the chunk's bytes.
  size_t reduce_scatter(void* data, size_t nbytes, DType dt, RedOp op,
                        void* out, size_t out_cap) {
    IoPtr io = io_snapshot();
    const int64_t rank = io->rank, ws = io->world;
    size_t esz = dtype_size(dt);
    auto bounds = ring_bounds(nbytes / esz, static_cast<size_t>(ws));
    uint8_t* bytes = static_cast<uint8_t*>(data);
    size_t own_off = bounds[rank] * esz;
    size_t own_bytes = (bounds[rank + 1] - bounds[rank]) * esz;
    if (own_bytes > out_cap)
      throw CommError("reduce_scatter out buffer too small");
    if (ws > 1) {
      auto deadline = deadline_in(timeout_s_);
      ScatterView view(data, nbytes);
      // shift -1: rank ends owning chunk `rank` (conventional contract);
      // the explicit-API tag window keeps these frames clear of allreduce
      ring_reduce_phase(io, view, bounds, esz, dt, op, /*shift=*/-1, deadline,
                        full_ring(ws), kRingReduceTagBase);
    }
    std::memcpy(out, bytes + own_off, own_bytes);
    return own_bytes;
  }

  void broadcast(void* data, size_t nbytes, int64_t root) {
    IoPtr io = io_snapshot();
    if (io->world <= 1) return;
    auto deadline = deadline_in(timeout_s_);
    if (io->rank == root) {
      // concurrent fan-out to every peer (send-only multi_exchange)
      uint8_t* src = static_cast<uint8_t*>(data);
      multi_exchange(
          io, peers_snapshot(),
          [&](int64_t) { return std::make_pair(src, nbytes); },
          [&](int64_t) {
            return std::make_pair(static_cast<uint8_t*>(nullptr), size_t(0));
          },
          3000, deadline);
    } else {
      ScatterView view(data, nbytes);
      recv_striped(*io, peer_fds(root), root, 3000, view, 0, nbytes,
                   deadline);
    }
  }

  void send(const void* data, size_t nbytes, int64_t dst, uint64_t tag) {
    IoPtr io = io_snapshot();
    auto deadline = deadline_in(timeout_s_);
    std::vector<struct iovec> payload;
    if (nbytes)
      payload.push_back({const_cast<void*>(data), nbytes});
    send_framed_iov(*io, peer_fd(dst, io->lanes - 1), dst, tag,
                    std::move(payload), nbytes, deadline, io->lanes - 1);
  }

  // one frame written in parts on the p2p lane: the part with ``first``
  // writes the frame's header (``total`` payload bytes, ``tag``) ahead of
  // its bytes, every later part its bytes alone.  The wire is send()'s; the
  // caller keeps the parts of one frame in one op, so nothing interleaves
  void send_part(const void* data, size_t nbytes, int64_t dst, uint64_t tag,
                 size_t total, bool first) {
    IoPtr io = io_snapshot();
    auto deadline = deadline_in(timeout_s_);
    std::vector<struct iovec> payload;
    if (nbytes)
      payload.push_back({const_cast<void*>(data), nbytes});
    send_framed_iov(*io, peer_fd(dst, io->lanes - 1), dst, tag,
                    std::move(payload), total, deadline, io->lanes - 1, first);
  }

  // zero-copy: receive one frame directly into a caller buffer; returns
  // the payload size (must be <= cap)
  size_t recv_into(int64_t src, uint64_t tag, void* buf, size_t cap) {
    IoPtr io = io_snapshot();
    size_t p2p_lane = io->lanes - 1;
    auto deadline = deadline_in(timeout_s_);
    int fd = peer_fd(src, p2p_lane);
    uint64_t hdr[2];
    recv_loop(*io, fd, src, hdr, 16, deadline, p2p_lane);
    if (hdr[1] != tag)
      throw CommError("tag mismatch from rank " + std::to_string(src));
    if (hdr[0] > cap) {
      // drain the payload so the stream stays frame-aligned, THEN fail
      std::vector<uint8_t> scratch(1 << 20);
      uint64_t remaining = hdr[0];
      while (remaining > 0) {
        size_t take = std::min<uint64_t>(remaining, scratch.size());
        recv_loop(*io, fd, src, scratch.data(), take, deadline, p2p_lane);
        remaining -= take;
      }
      throw CommError("recv_into buffer too small: payload " +
                      std::to_string(hdr[0]) + " > cap " + std::to_string(cap));
    }
    recv_loop(*io, fd, src, buf, hdr[0], deadline, p2p_lane);
    return hdr[0];
  }

  // receiver learns the size from the frame header
  std::vector<uint8_t> recv_dynamic(int64_t src, uint64_t tag) {
    IoPtr io = io_snapshot();
    size_t p2p_lane = io->lanes - 1;
    auto deadline = deadline_in(timeout_s_);
    int fd = peer_fd(src, p2p_lane);
    uint64_t hdr[2];
    recv_loop(*io, fd, src, hdr, 16, deadline, p2p_lane);
    if (hdr[1] != tag)
      throw CommError("tag mismatch from rank " + std::to_string(src));
    std::vector<uint8_t> out(hdr[0]);
    recv_loop(*io, fd, src, out.data(), out.size(), deadline, p2p_lane);
    return out;
  }

  // symmetric alltoall of equal-size chunks; chunks laid out contiguously in
  // `data` (ws chunks of chunk_bytes); received into `out` by source rank.
  void alltoall(const void* data, void* out, size_t chunk_bytes, uint64_t tag) {
    IoPtr io = io_snapshot();
    const uint8_t* in = static_cast<const uint8_t*>(data);
    std::vector<const void*> ins(static_cast<size_t>(io->world));
    for (int64_t p = 0; p < io->world; ++p) ins[p] = in + p * chunk_bytes;
    alltoall_ptrs_io(io, ins.data(), out, chunk_bytes, tag);
  }

  // scatter-gather alltoall: one pointer per destination rank's chunk (the
  // chunks need not be contiguous with each other — no staging concat)
  void alltoall_ptrs(const void* const* ins, void* out, size_t chunk_bytes,
                     uint64_t tag) {
    alltoall_ptrs_io(io_snapshot(), ins, out, chunk_bytes, tag);
  }

  void alltoall_ptrs_io(IoPtr io, const void* const* ins, void* out,
                        size_t chunk_bytes, uint64_t tag) {
    uint8_t* o = static_cast<uint8_t*>(out);
    std::memcpy(o + io->rank * chunk_bytes, ins[io->rank], chunk_bytes);
    auto deadline = deadline_in(timeout_s_);
    // pairwise exchange with every peer concurrently
    multi_exchange(
        io, peers_snapshot(),
        [&](int64_t p) {
          return std::make_pair(
              static_cast<const uint8_t*>(ins[p]), chunk_bytes);
        },
        [&](int64_t p) { return std::make_pair(o + p * chunk_bytes, chunk_bytes); },
        4000 + tag, deadline);
  }

  void allgather(const void* data, void* out, size_t chunk_bytes, uint64_t tag) {
    IoPtr io = io_snapshot();
    const uint8_t* in = static_cast<const uint8_t*>(data);
    uint8_t* o = static_cast<uint8_t*>(out);
    std::memcpy(o + io->rank * chunk_bytes, in, chunk_bytes);
    auto deadline = deadline_in(timeout_s_);
    multi_exchange(
        io, peers_snapshot(),
        [&](int64_t) { return std::make_pair(in, chunk_bytes); },
        [&](int64_t p) { return std::make_pair(o + p * chunk_bytes, chunk_bytes); },
        5000 + tag, deadline);
  }

  void barrier() {
    float token = 0.0f;
    allreduce(&token, sizeof(token), DT_F32, OP_SUM);
  }

 private:
  using TimePoint = std::chrono::steady_clock::time_point;
  static TimePoint now() { return std::chrono::steady_clock::now(); }
  TimePoint deadline_in(double seconds) const {
    return now() + std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                       std::chrono::duration<double>(seconds));
  }

  std::vector<int> peer_fds(int64_t peer) {
    std::lock_guard<std::mutex> lock(state_mu_);
    auto it = peers_.find(peer);
    if (it == peers_.end())
      throw CommError("no peer " + std::to_string(peer) +
                      (aborted_ ? " (communicator aborted)" : ""));
    return it->second;
  }

  int peer_fd(int64_t peer, size_t lane = 0) {
    std::lock_guard<std::mutex> lock(state_mu_);
    auto it = peers_.find(peer);
    if (it == peers_.end() || lane >= it->second.size())
      throw CommError("no peer " + std::to_string(peer) +
                      (aborted_ ? " (communicator aborted)" : ""));
    return it->second[lane];
  }

  std::shared_ptr<LanePool> pool_snapshot() {
    std::lock_guard<std::mutex> lock(state_mu_);
    if (!pool_) throw CommError("communicator not configured");
    return pool_;
  }

  void check_abort() const {
    if (aborted_) throw CommError("communicator aborted");
  }

  IoPtr io_snapshot() const {
    std::lock_guard<std::mutex> lock(state_mu_);
    return io_;
  }

  // --- scatter-gather framed IO with abort/deadline checks per quantum ----
  //
  // One frame = 16-byte header (payload nbytes, tag) + payload, where the
  // payload may be scattered across many caller buffers: sendmsg pushes
  // header + payload segments in one syscall/TCP segment (with TCP_NODELAY
  // a separate header send costs a segment and a wakeup per frame), and
  // recvmsg lands payload bytes straight in the callers' segments.

  void send_framed_iov(EpochIO& io, int fd, int64_t peer, uint64_t tag,
                       std::vector<struct iovec> payload, size_t nbytes,
                       TimePoint deadline, size_t lane, bool header = true) {
    uint64_t hdr[2] = {nbytes, tag};
    size_t hdr_left = 0;
    if (header) {
      io.gate();
      payload.insert(payload.begin(), {hdr, sizeof(hdr)});
      hdr_left = sizeof(hdr);
    }
    IovCursor cursor(std::move(payload));
    struct iovec batch[kMaxIovSegs + 1];
    while (cursor.remaining() > 0) {
      check_abort();
      if (now() > deadline) throw CommError("send timed out");
      size_t budget = cursor.remaining();
      if (io.pacer && cursor.remaining() > hdr_left) {
        // the header rides free (16 bytes of framing noise vs the Python
        // tier's per-chunk accounting parity)
        size_t want =
            std::min(cursor.remaining() - hdr_left, size_t(1) << 20);
        size_t allowed = io.pacer->allow(want, static_cast<uint64_t>(fd));
        // coalesce dribbles: a cwnd-limited stream bucket refills a few
        // tens of KB per scheduling quantum, and pushing each dribble
        // costs a syscall + a wakeup PER LANE THREAD — on small hosts
        // that thrash (not the token rate) becomes the ceiling.  Below
        // the floor, nap briefly instead (tokens keep accruing while we
        // sleep; nothing is consumed).
        size_t floor =
            std::min({want, kPaceMinSendBytes, io.pacer->max_grant() / 2});
        if (allowed < floor) {
          io.stall(lane);
          std::this_thread::sleep_for(std::chrono::microseconds(200));
          continue;
        }
        budget = allowed + hdr_left;
      }
      int cnt = cursor.fill(batch, kMaxIovSegs + 1, budget);
      if (cnt == 0) break;
      struct msghdr msg {};
      msg.msg_iov = batch;
      msg.msg_iovlen = cnt;
      ssize_t sent = ::sendmsg(fd, &msg, MSG_NOSIGNAL);
      if (sent < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
          io.stall(lane);
          continue;  // quantum expired: re-check abort/deadline
        }
        throw CommError("send failed to rank " + std::to_string(peer));
      }
      size_t s = static_cast<size_t>(sent);
      size_t hdr_part = std::min(s, hdr_left);
      hdr_left -= hdr_part;
      if (io.pacer) io.pacer->consume(s - hdr_part, static_cast<uint64_t>(fd));
      io.add_tx(lane, s - hdr_part);
      cursor.advance(s);
    }
  }

  void recv_loop_iov(EpochIO& io, int fd, int64_t peer, IovCursor& cursor,
                     TimePoint deadline, size_t lane) {
    struct iovec batch[kMaxIovSegs];
    while (cursor.remaining() > 0) {
      check_abort();
      if (now() > deadline) throw CommError("recv timed out");
      int cnt = cursor.fill(batch, kMaxIovSegs, cursor.remaining());
      struct msghdr msg {};
      msg.msg_iov = batch;
      msg.msg_iovlen = cnt;
      ssize_t got = ::recvmsg(fd, &msg, 0);
      if (got == 0)
        throw CommError("connection to rank " + std::to_string(peer) +
                        " closed");
      if (got < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
          continue;  // quantum expired: re-check abort/deadline
        throw CommError("recv failed from rank " + std::to_string(peer));
      }
      io.add_rx(lane, static_cast<size_t>(got));
      cursor.advance(static_cast<size_t>(got));
    }
  }

  // --- lane-striped framed IO ---------------------------------------------
  //
  // One logical frame split across the lane connections by lane_parts();
  // part 0 runs on the calling thread, the rest on the epoch's persistent
  // per-lane workers, so on cwnd-limited links the streams genuinely run
  // in parallel.  Sub-frame boundaries are 64-byte aligned, so the reduce
  // variant can fold each lane's range independently — every element still
  // sees exactly one reduction per step: results are bit-identical to a
  // single lane.

  template <typename PartFn>
  void run_lane_parts(int64_t peer, int dir,
                      const std::vector<std::pair<size_t, size_t>>& parts,
                      PartFn fn) {
    if (parts.size() == 1) {
      fn(0, parts[0].first, parts[0].second);
      return;
    }
    auto pool = pool_snapshot();
    auto latch = std::make_shared<OpLatch>();
    latch->add(parts.size() - 1);
    for (size_t i = 1; i < parts.size(); ++i) {
      size_t s = parts[i].first, e = parts[i].second;
      pool->submit(peer, i, dir, [&fn, i, s, e, latch] {
        std::string err;
        try {
          fn(i, s, e);
        } catch (const std::exception& ex) {
          err = ex.what();
        }
        latch->done(err);
      });
    }
    std::string err0;
    try {
      fn(0, parts[0].first, parts[0].second);
    } catch (const std::exception& ex) {
      err0 = ex.what();
    }
    std::string err = latch->wait_quiet();
    if (!err0.empty()) throw CommError(err0);
    if (!err.empty()) throw CommError(err);
  }

  // striped send of view[off, off+nbytes) to peer, synchronous
  void send_striped(EpochIO& io, const std::vector<int>& fds, int64_t peer,
                    uint64_t tag, const ScatterView& view, size_t off,
                    size_t nbytes, TimePoint deadline) {
    auto parts = io.lane_parts(nbytes);
    if (io.pacer && parts.size() > 1) {
      // paced striped sends multiplex every lane on ONE thread: under a
      // token bucket the wire, not the CPU, is the bottleneck, and a
      // round-robin writer (exactly the Python select loop's shape)
      // saturates all cwnd-capped streams without n napping threads
      // fighting the scheduler on small hosts
      send_striped_multiplexed(io, fds, peer, tag, view, off, parts,
                               deadline);
      return;
    }
    run_lane_parts(peer, LanePool::kTx, parts,
                   [&](size_t lane, size_t s, size_t e) {
                     send_framed_iov(io, fds[lane], peer, tag,
                                     view.slice(off + s, e - s), e - s,
                                     deadline, lane);
                   });
  }

  // one thread drives every lane's sub-frame of a striped send,
  // round-robining the pacer grants; wire bytes are identical to the
  // per-lane-thread path (same frames on the same lanes, interleaving is
  // invisible to per-connection TCP streams)
  void send_striped_multiplexed(
      EpochIO& io, const std::vector<int>& fds, int64_t peer, uint64_t tag,
      const ScatterView& view, size_t off,
      const std::vector<std::pair<size_t, size_t>>& parts,
      TimePoint deadline) {
    io.gate();  // one gate arms every lane, like the Python loop
    struct LaneTx {
      int fd = -1;
      size_t lane = 0;
      uint64_t hdr[2] = {0, 0};
      IovCursor cursor;
      size_t hdr_left = sizeof(hdr);
    };
    std::vector<std::unique_ptr<LaneTx>> lanes;
    for (size_t i = 0; i < parts.size(); ++i) {
      size_t s = parts[i].first, e = parts[i].second;
      auto lt = std::make_unique<LaneTx>();
      lt->fd = fds[i];
      lt->lane = i;
      lt->hdr[0] = e - s;
      lt->hdr[1] = tag;
      auto iov = view.slice(off + s, e - s);
      // the header iovec points at THIS LaneTx's hdr storage
      iov.insert(iov.begin(), {lt->hdr, sizeof(lt->hdr)});
      lt->cursor = IovCursor(std::move(iov));
      lanes.push_back(std::move(lt));
    }
    struct iovec batch[kMaxIovSegs + 1];
    size_t live = lanes.size();
    while (live > 0) {
      check_abort();
      if (now() > deadline) throw CommError("send timed out");
      bool progressed = false;
      for (auto& lt : lanes) {
        if (lt->cursor.remaining() == 0) continue;
        size_t remaining = lt->cursor.remaining();
        size_t payload_left = remaining - lt->hdr_left;
        size_t budget = remaining;
        if (payload_left > 0) {
          size_t want = std::min(payload_left, size_t(1) << 20);
          size_t allowed =
              io.pacer->allow(want, static_cast<uint64_t>(lt->fd));
          size_t floor =
              std::min({want, kPaceMinSendBytes, io.pacer->max_grant() / 2});
          if (allowed < floor) {
            io.stall(lt->lane);
            continue;  // this lane is token-blocked; try the next
          }
          budget = allowed + lt->hdr_left;
        }
        int cnt = lt->cursor.fill(batch, kMaxIovSegs + 1, budget);
        if (cnt == 0) continue;
        struct msghdr msg {};
        msg.msg_iov = batch;
        msg.msg_iovlen = cnt;
        ssize_t sent = ::sendmsg(lt->fd, &msg, MSG_NOSIGNAL);
        if (sent < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
            io.stall(lt->lane);
            continue;
          }
          throw CommError("send failed to rank " + std::to_string(peer));
        }
        size_t s2 = static_cast<size_t>(sent);
        size_t hdr_part = std::min(s2, lt->hdr_left);
        lt->hdr_left -= hdr_part;
        io.pacer->consume(s2 - hdr_part, static_cast<uint64_t>(lt->fd));
        io.add_tx(lt->lane, s2 - hdr_part);
        lt->cursor.advance(s2);
        progressed = true;
        if (lt->cursor.remaining() == 0) --live;
      }
      if (!progressed && live > 0)
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
  }

  // striped send dispatched entirely onto the per-lane tx workers; the
  // returned latch completes when every part is on the wire (the ring's
  // duplex steps run send and recv concurrently without a thread spawn)
  std::shared_ptr<OpLatch> send_striped_async(
      IoPtr io, const std::vector<int>& fds, int64_t peer, uint64_t tag,
      const ScatterView& view, size_t off, size_t nbytes, TimePoint deadline) {
    auto pool = pool_snapshot();
    auto latch = std::make_shared<OpLatch>();
    auto parts = io->lane_parts(nbytes);
    if (io->pacer && parts.size() > 1) {
      // paced: one multiplexer task round-robins every lane (see
      // send_striped) instead of a napping worker per lane
      latch->add(1);
      pool->submit(peer, 0, LanePool::kTx,
                   [this, io, fds, peer, tag, &view, off, parts, deadline,
                    latch] {
                     std::string err;
                     try {
                       send_striped_multiplexed(*io, fds, peer, tag, view,
                                                off, parts, deadline);
                     } catch (const std::exception& ex) {
                       err = ex.what();
                     }
                     latch->done(err);
                   });
      return latch;
    }
    latch->add(parts.size());
    for (size_t i = 0; i < parts.size(); ++i) {
      size_t s = parts[i].first, e = parts[i].second;
      int fd = fds[i];
      pool->submit(peer, i, LanePool::kTx,
                   [this, io, fd, peer, tag, &view, off, s, e, deadline,
                    latch, i] {
                     std::string err;
                     try {
                       send_framed_iov(*io, fd, peer, tag,
                                       view.slice(off + s, e - s), e - s,
                                       deadline, i);
                     } catch (const std::exception& ex) {
                       err = ex.what();
                     }
                     latch->done(err);
                   });
    }
    return latch;
  }

  void recv_striped(EpochIO& io, const std::vector<int>& fds, int64_t peer,
                    uint64_t tag, ScatterView& view, size_t off,
                    size_t nbytes, TimePoint deadline) {
    run_lane_parts(peer, LanePool::kRx, io.lane_parts(nbytes),
                   [&](size_t lane, size_t s, size_t e) {
                     recv_framed_iov(io, fds[lane], peer, tag, view, off + s,
                                     e - s, deadline, lane);
                   });
  }

  void recv_striped_reduce(EpochIO& io, const std::vector<int>& fds,
                           int64_t peer, uint64_t tag, ScatterView& view,
                           size_t off, size_t nbytes, DType dt, RedOp op,
                           TimePoint deadline,
                           std::vector<std::vector<uint8_t>>& scratches) {
    auto parts = io.lane_parts(nbytes);
    // per-lane scratch from the caller's pool (grown once, reused across
    // ring steps): the quantum-pipelined reduce runs concurrently on every
    // lane over disjoint destination ranges
    if (scratches.size() < parts.size()) scratches.resize(parts.size());
    for (size_t i = 0; i < parts.size(); ++i) {
      size_t want =
          std::min<size_t>(parts[i].second - parts[i].first, size_t(4) << 20) +
          64;
      if (scratches[i].size() < want) scratches[i].resize(want);
    }
    run_lane_parts(peer, LanePool::kRx, parts,
                   [&](size_t lane, size_t s, size_t e) {
                     recv_framed_reduce(io, fds[lane], peer, tag, view,
                                        off + s, e - s,
                                        scratches[lane].data(), dt, op,
                                        deadline, lane);
                   });
  }

  // element bounds per ring chunk (first n%ws chunks one element longer)
  static std::vector<size_t> ring_bounds(size_t n, size_t ws) {
    std::vector<size_t> bounds(ws + 1, 0);
    size_t base = n / ws, extra = n % ws;
    for (size_t i = 0; i < ws; ++i)
      bounds[i + 1] = bounds[i] + base + (i < extra ? 1 : 0);
    return bounds;
  }

  static std::vector<int64_t> full_ring(int64_t ws) {
    std::vector<int64_t> ring(ws);
    for (int64_t i = 0; i < ws; ++i) ring[i] = i;
    return ring;
  }

  static int64_t ring_pos(const std::vector<int64_t>& ring, int64_t rank) {
    auto it = std::find(ring.begin(), ring.end(), rank);
    if (it == ring.end())
      throw CommError("rank " + std::to_string(rank) + " not in ring");
    return it - ring.begin();
  }

  // ring reduce phase: ws-1 duplex steps over `ring` (global ranks in ring
  // order; ws = ring.size()); with shift s, this rank's ring POSITION ends
  // up owning the fully-reduced chunk (pos + 1 + s) mod ws.  The (memory-
  // bound) reduction rides under the wire via quantum-pipelined recv; the
  // send leg runs on the per-lane tx workers, the recv leg on the calling
  // thread + rx workers.
  void ring_reduce_phase(IoPtr io, ScatterView& view,
                         const std::vector<size_t>& bounds, size_t esz,
                         DType dt, RedOp op, int64_t shift,
                         TimePoint deadline, const std::vector<int64_t>& ring,
                         uint64_t tag_base) {
    int64_t ws = static_cast<int64_t>(ring.size());
    int64_t pos = ring_pos(ring, io->rank);
    int64_t right = ring[(pos + 1) % ws];
    int64_t left = ring[(pos - 1 + ws) % ws];
    auto chunk_off = [&](int64_t i) {
      i = ((i % ws) + ws) % ws;
      return bounds[i] * esz;
    };
    auto chunk_bytes = [&](int64_t i) {
      i = ((i % ws) + ws) % ws;
      return (bounds[i + 1] - bounds[i]) * esz;
    };
    std::vector<int> right_fds = peer_fds(right);
    std::vector<int> left_fds = peer_fds(left);
    std::vector<std::vector<uint8_t>> scratches;  // grown once, reused/step
    for (int64_t step = 0; step < ws - 1; ++step) {
      int64_t send_idx = pos - step + shift;
      int64_t recv_idx = pos - step - 1 + shift;
      auto send_latch =
          send_striped_async(io, right_fds, right, tag_base + 1000 + step,
                             view, chunk_off(send_idx), chunk_bytes(send_idx),
                             deadline);
      try {
        recv_striped_reduce(*io, left_fds, left, tag_base + 1000 + step, view,
                            chunk_off(recv_idx), chunk_bytes(recv_idx), dt, op,
                            deadline, scratches);
      } catch (...) {
        send_latch->wait_quiet();
        throw;
      }
      send_latch->wait();
    }
  }

  // ring allgather phase: ws-1 duplex steps circulating the fully-reduced
  // chunks over `ring`; with shift s, this rank's ring position starts
  // owning chunk (pos + 1 + s) mod ws.
  void ring_allgather_phase(IoPtr io, ScatterView& view,
                            const std::vector<size_t>& bounds, size_t esz,
                            int64_t shift, TimePoint deadline,
                            const std::vector<int64_t>& ring,
                            uint64_t tag_base) {
    int64_t ws = static_cast<int64_t>(ring.size());
    int64_t pos = ring_pos(ring, io->rank);
    int64_t right = ring[(pos + 1) % ws];
    int64_t left = ring[(pos - 1 + ws) % ws];
    auto chunk_off = [&](int64_t i) {
      i = ((i % ws) + ws) % ws;
      return bounds[i] * esz;
    };
    auto chunk_bytes = [&](int64_t i) {
      i = ((i % ws) + ws) % ws;
      return (bounds[i + 1] - bounds[i]) * esz;
    };
    std::vector<int> right_fds = peer_fds(right);
    std::vector<int> left_fds = peer_fds(left);
    for (int64_t step = 0; step < ws - 1; ++step) {
      int64_t send_idx = pos + 1 + shift - step;
      int64_t recv_idx = pos + shift - step;
      auto send_latch =
          send_striped_async(io, right_fds, right, tag_base + 2000 + step,
                             view, chunk_off(send_idx), chunk_bytes(send_idx),
                             deadline);
      try {
        recv_striped(*io, left_fds, left, tag_base + 2000 + step, view,
                     chunk_off(recv_idx),
                     chunk_bytes(recv_idx), deadline);
      } catch (...) {
        send_latch->wait_quiet();
        throw;
      }
      send_latch->wait();
    }
  }

  // recv a frame in quanta, reducing each quantum into the view as it
  // arrives (TCP delivers in order, so progressive reduction needs only a
  // quantum-sized scratch and overlaps compute with the wire)
  void recv_framed_reduce(EpochIO& io, int fd, int64_t peer, uint64_t tag,
                          ScatterView& view, size_t dst_off, size_t nbytes,
                          uint8_t* scratch, DType dt, RedOp op,
                          TimePoint deadline, size_t lane) {
    static constexpr size_t kQuantum = size_t(4) << 20;
    uint64_t hdr[2];
    recv_loop(io, fd, peer, hdr, 16, deadline, lane, /*count=*/false);
    if (hdr[1] != tag)
      throw CommError("tag mismatch from rank " + std::to_string(peer));
    if (hdr[0] != nbytes)
      throw CommError("size mismatch from rank " + std::to_string(peer));
    size_t esz = dtype_size(dt);
    size_t quantum = kQuantum - (kQuantum % (esz ? esz : 1));
    size_t off = 0;
    while (off < nbytes) {
      size_t take = std::min(quantum, nbytes - off);
      recv_loop(io, fd, peer, scratch, take, deadline, lane);
      view.reduce_in(dst_off + off, scratch, take, dt, op);
      off += take;
    }
  }

  // recv one frame straight into the view's segments (zero staging copy)
  void recv_framed_iov(EpochIO& io, int fd, int64_t peer, uint64_t tag,
                       ScatterView& view, size_t dst_off, size_t nbytes,
                       TimePoint deadline, size_t lane) {
    uint64_t hdr[2];
    recv_loop(io, fd, peer, hdr, 16, deadline, lane, /*count=*/false);
    if (hdr[1] != tag)
      throw CommError("tag mismatch from rank " + std::to_string(peer));
    if (hdr[0] != nbytes)
      throw CommError("size mismatch from rank " + std::to_string(peer));
    IovCursor cursor(view.slice(dst_off, nbytes));
    recv_loop_iov(io, fd, peer, cursor, deadline, lane);
  }

  void recv_loop(EpochIO& io, int fd, int64_t peer, void* buf, size_t n,
                 TimePoint deadline, size_t lane, bool count = true) {
    uint8_t* p = static_cast<uint8_t*>(buf);
    while (n > 0) {
      check_abort();
      if (now() > deadline) throw CommError("recv timed out");
      ssize_t got = ::recv(fd, p, n, 0);
      if (got == 0)
        throw CommError("connection to rank " + std::to_string(peer) + " closed");
      if (got < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
          continue;  // quantum expired: re-check abort/deadline
        throw CommError("recv failed from rank " + std::to_string(peer));
      }
      if (count) io.add_rx(lane, static_cast<size_t>(got));
      p += got;
      n -= static_cast<size_t>(got);
    }
  }

  // all-peers concurrent exchange (alltoall/allgather/broadcast fan-out):
  // one duplex leg per peer on the persistent lane workers (the (peer, 0)
  // tx/rx pair coordinates; parts >= 1 fan out to that peer's lane
  // workers), each leg lane-striped.
  template <typename SendFn, typename RecvFn>
  void multi_exchange(IoPtr io,
                      const std::map<int64_t, std::vector<int>>& peers,
                      SendFn send_for, RecvFn recv_for, uint64_t tag,
                      TimePoint deadline) {
    auto pool = pool_snapshot();
    auto latch = std::make_shared<OpLatch>();
    std::vector<std::function<void()>> legs;
    for (const auto& entry : peers) {
      // plain locals (not structured bindings): C++17 lambdas cannot
      // portably capture the latter
      int64_t peer = entry.first;
      std::vector<int> pfds = entry.second;
      auto send_pair = send_for(peer);
      auto recv_pair = recv_for(peer);
      const uint8_t* sb = send_pair.first;
      size_t sn = send_pair.second;
      uint8_t* rb = recv_pair.first;
      size_t rn = recv_pair.second;
      latch->add(1);
      pool->submit(peer, 0, LanePool::kTx,
                   [this, io, pfds, peer, tag, sb, sn, deadline, latch] {
                     std::string err;
                     try {
                       ScatterView sv(const_cast<uint8_t*>(sb), sn);
                       send_striped(*io, pfds, peer, tag, sv, 0, sn,
                                    deadline);
                     } catch (const std::exception& ex) {
                       err = ex.what();
                     }
                     latch->done(err);
                   });
      if (rb != nullptr) {
        latch->add(1);
        pool->submit(peer, 0, LanePool::kRx,
                     [this, io, pfds, peer, tag, rb, rn, deadline, latch] {
                       std::string err;
                       try {
                         ScatterView rv(rb, rn);
                         recv_striped(*io, pfds, peer, tag, rv, 0, rn,
                                      deadline);
                       } catch (const std::exception& ex) {
                         err = ex.what();
                       }
                       latch->done(err);
                     });
      }
    }
    latch->wait();
  }

  // epoch-scalar mirrors for the PUBLIC accessors (rank()/size()/lanes()/
  // stripe_floor()/lane_parts()): written only by configure()'s publish
  // step, read by the binding from foreign threads — atomics because those
  // reads race the publish.  Op bodies never touch these: they read the
  // EpochIO snapshot, whose rank/world/lanes are immutable per epoch, so a
  // superseded op can never mix two epochs' values inside one collective.
  std::atomic<double> timeout_s_;
  std::atomic<int64_t> rank_{0};
  std::atomic<int64_t> world_size_{1};
  std::atomic<size_t> lanes_{1};
  std::atomic<size_t> stripe_floor_{kMinStripeBytes};
  std::atomic<bool> aborted_{false};
  // guards peers_/graveyard_/pool_/io_ STRUCTURE only — never held across
  // IO; ops snapshot the fds/pool/io they need at entry (fds stay open
  // until destruction, so a snapshot can never dangle; superseded pools
  // and EpochIO instances park in shared_ptrs held by in-flight ops)
  mutable std::mutex state_mu_;
  std::map<int64_t, std::vector<int>> peers_;
  std::shared_ptr<LanePool> pool_;
  IoPtr io_;
  std::vector<int> graveyard_;
  // epochs ever published (abort() only records a flight event once a
  // real epoch existed — configure()'s supersede-abort at boot is noise)
  std::atomic<int64_t> flight_epochs_{0};
  // guards flight_/flight_seq_/flight_drained_
  std::mutex flight_mu_;
  std::array<FlightSlot, kFlightRingSlots> flight_;
  uint64_t flight_seq_ = 0;
  uint64_t flight_drained_ = 0;
};

}  // namespace tpuft
