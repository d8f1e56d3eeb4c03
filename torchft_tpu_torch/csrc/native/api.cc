// C ABI for the torchft_tpu_torch native runtime (loaded from Python via ctypes —
// the environment has no pybind11; this keeps bindings dependency-free).
//
// Error convention: functions returning int use 0 = ok, -1 = error with the
// message retrievable via tpuft_last_error() (thread-local).

#include <cstdlib>
#include <cstring>
#include <string>

#include "comm.h"
#include "lighthouse.h"
#include "manager.h"
#include "store.h"

namespace {
thread_local std::string g_last_error;

template <typename Fn>
int guarded(Fn&& fn) {
  try {
    fn();
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  } catch (...) {
    g_last_error = "unknown error";
    return -1;
  }
}
}  // namespace

extern "C" {

const char* tpuft_last_error() { return g_last_error.c_str(); }

// ---------------- store ----------------

void* tpuft_store_new(const char* bind_addr) {
  try {
    return new tpuft::StoreServer(bind_addr);
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

int tpuft_store_port(void* h) {
  return static_cast<tpuft::StoreServer*>(h)->port();
}

void tpuft_store_free(void* h) {
  auto* server = static_cast<tpuft::StoreServer*>(h);
  server->shutdown();
  delete server;
}

// ---------------- lighthouse ----------------

void* tpuft_lighthouse_new(const char* bind_addr, uint64_t min_replicas,
                           uint64_t join_timeout_ms, uint64_t quorum_tick_ms,
                           uint64_t heartbeat_timeout_ms) {
  try {
    tpuft::LighthouseConfig cfg;
    cfg.min_replicas = min_replicas;
    cfg.join_timeout_ms = join_timeout_ms;
    cfg.quorum_tick_ms = quorum_tick_ms;
    cfg.heartbeat_timeout_ms = heartbeat_timeout_ms;
    return new tpuft::LighthouseServer(bind_addr, cfg);
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

int tpuft_lighthouse_port(void* h) {
  return static_cast<tpuft::LighthouseServer*>(h)->port();
}

void tpuft_lighthouse_free(void* h) {
  auto* server = static_cast<tpuft::LighthouseServer*>(h);
  server->shutdown();
  delete server;
}

// ---------------- manager ----------------

void* tpuft_manager_new(const char* replica_id, const char* lighthouse_addr,
                        const char* hostname, const char* bind_addr,
                        const char* store_addr, uint64_t world_size,
                        double heartbeat_interval_s, double connect_timeout_s,
                        int64_t quorum_retries) {
  try {
    return new tpuft::ManagerServer(replica_id, lighthouse_addr, hostname,
                                    bind_addr, store_addr, world_size,
                                    heartbeat_interval_s, connect_timeout_s,
                                    quorum_retries);
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

int tpuft_manager_port(void* h) {
  return static_cast<tpuft::ManagerServer*>(h)->port();
}

void tpuft_manager_free(void* h) {
  auto* server = static_cast<tpuft::ManagerServer*>(h);
  server->shutdown();
  delete server;
}

// ---------------- communicator ----------------

void* tpuft_comm_new(double timeout_s) {
  return new tpuft::Communicator(timeout_s);
}

int tpuft_comm_configure(void* h, const char* store_prefixed_addr,
                         int64_t rank, int64_t world_size) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->configure(store_prefixed_addr, rank, world_size); });
}

int tpuft_comm_allreduce(void* h, void* data, uint64_t nbytes, int32_t dtype,
                         int32_t op) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] {
    comm->allreduce(data, nbytes, static_cast<tpuft::DType>(dtype),
                    static_cast<tpuft::RedOp>(op));
  });
}

// zero-copy multi-buffer allreduce: `bufs`/`lens` describe n scattered
// caller buffers (all holding whole elements of `dtype`) treated as one
// logical payload — frames leave and land via sendmsg/recvmsg straight
// against these buffers, no staging concatenation on either side.
int tpuft_comm_allreduce_iov(void* h, void* const* bufs, const uint64_t* lens,
                             uint64_t n, int32_t dtype, int32_t op) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] {
    comm->allreduce_iov(bufs, lens, n, static_cast<tpuft::DType>(dtype),
                        static_cast<tpuft::RedOp>(op));
  });
}

int tpuft_comm_reduce_scatter(void* h, void* data, uint64_t nbytes,
                              int32_t dtype, int32_t op, void* out,
                              uint64_t out_cap, uint64_t* out_bytes) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] {
    *out_bytes = comm->reduce_scatter(data, nbytes,
                                      static_cast<tpuft::DType>(dtype),
                                      static_cast<tpuft::RedOp>(op), out,
                                      out_cap);
  });
}

int tpuft_comm_broadcast(void* h, void* data, uint64_t nbytes, int64_t root) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->broadcast(data, nbytes, root); });
}

int tpuft_comm_send(void* h, const void* data, uint64_t nbytes, int64_t dst,
                    uint64_t tag) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->send(data, nbytes, dst, tag); });
}

int tpuft_comm_send_part(void* h, const void* data, uint64_t nbytes,
                         int64_t dst, uint64_t tag, uint64_t total,
                         int first) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded(
      [&] { comm->send_part(data, nbytes, dst, tag, total, first != 0); });
}

int tpuft_comm_recv_alloc(void* h, int64_t src, uint64_t tag, uint8_t** out,
                          uint64_t* out_n) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] {
    auto data = comm->recv_dynamic(src, tag);
    *out = static_cast<uint8_t*>(std::malloc(data.size()));
    std::memcpy(*out, data.data(), data.size());
    *out_n = data.size();
  });
}

void tpuft_buffer_free(void* p) { std::free(p); }

int tpuft_comm_recv_into(void* h, int64_t src, uint64_t tag, void* buf,
                         uint64_t cap, uint64_t* out_n) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { *out_n = comm->recv_into(src, tag, buf, cap); });
}

int tpuft_comm_alltoall(void* h, const void* in, void* out,
                        uint64_t chunk_bytes, uint64_t tag) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->alltoall(in, out, chunk_bytes, tag); });
}

// scatter-gather alltoall: one pointer per destination rank's chunk (the
// chunks need not be contiguous with each other)
int tpuft_comm_alltoall_ptrs(void* h, const void* const* ins, void* out,
                             uint64_t chunk_bytes, uint64_t tag) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->alltoall_ptrs(ins, out, chunk_bytes, tag); });
}

int tpuft_comm_allgather(void* h, const void* in, void* out,
                         uint64_t chunk_bytes, uint64_t tag) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->allgather(in, out, chunk_bytes, tag); });
}

// per-lane counters of the current epoch (tx/rx payload bytes, stall
// events) — the native half of the tier-agnostic lane_stats() surface.
// Returns the lane count; fills up to `cap` entries per array.
uint64_t tpuft_comm_lane_stats(void* h, uint64_t* tx, uint64_t* rx,
                               uint64_t* stalls, uint64_t cap,
                               uint64_t* stripe_floor) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  *stripe_floor = comm->stripe_floor();
  return comm->lane_stats(tx, rx, stalls, cap);
}

// consume-drain of the C-side flight-recorder ring (fixed slots recording
// the epoch lifecycle): fills up to `cap` events oldest-first and returns
// the count.  obs/flight.py merges the drained events into the Python
// replica dump (the fleet postmortem view spans both tiers).
uint64_t tpuft_comm_flight_drain(void* h, uint64_t* seqs, double* ts,
                                 uint32_t* evs, int64_t* a, int64_t* b,
                                 uint64_t cap) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return comm->flight_drain(seqs, ts, evs, a, b, cap);
}

int tpuft_comm_barrier(void* h) {
  auto* comm = static_cast<tpuft::Communicator*>(h);
  return guarded([&] { comm->barrier(); });
}

void tpuft_comm_abort(void* h) {
  static_cast<tpuft::Communicator*>(h)->abort();
}

void tpuft_comm_free(void* h) { delete static_cast<tpuft::Communicator*>(h); }

}  // extern "C"
