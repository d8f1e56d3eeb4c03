// Control-plane message structs shared by lighthouse/manager (C++ twins of
// QuorumMember / Quorum / ManagerQuorumResult in torchft_tpu_torch/wire.py, which
// mirror the reference's proto/torchft.proto messages).

#pragma once

#include <optional>
#include <string>
#include <vector>

#include "wire.h"

namespace tpuft {

struct QuorumMember {
  std::string replica_id;
  std::string address;
  std::string store_address;
  int64_t step = 0;
  uint64_t world_size = 1;
  bool shrink_only = false;
  int64_t commit_failures = 0;
  std::string data;

  void encode(Writer& w) const {
    w.str(replica_id);
    w.str(address);
    w.str(store_address);
    w.i64(step);
    w.u64(world_size);
    w.boolean(shrink_only);
    w.i64(commit_failures);
    w.str(data);
  }
  static QuorumMember decode(Reader& r) {
    QuorumMember m;
    m.replica_id = r.str();
    m.address = r.str();
    m.store_address = r.str();
    m.step = r.i64();
    m.world_size = r.u64();
    m.shrink_only = r.boolean();
    m.commit_failures = r.i64();
    m.data = r.str();
    return m;
  }
};

struct Quorum {
  int64_t quorum_id = 0;
  std::vector<QuorumMember> participants;
  double created = 0.0;

  void encode(Writer& w) const {
    w.i64(quorum_id);
    w.f64(created);
    w.u32(static_cast<uint32_t>(participants.size()));
    for (const auto& p : participants) p.encode(w);
  }
  static Quorum decode(Reader& r) {
    Quorum q;
    q.quorum_id = r.i64();
    q.created = r.f64();
    uint32_t n = r.u32();
    q.participants.reserve(n);
    for (uint32_t i = 0; i < n; ++i) q.participants.push_back(QuorumMember::decode(r));
    return q;
  }
};

struct ManagerQuorumResult {
  int64_t quorum_id = 0;
  int64_t replica_rank = 0;
  int64_t replica_world_size = 1;
  std::string recover_src_manager_address;
  std::optional<int64_t> recover_src_replica_rank;
  std::vector<int64_t> recover_dst_replica_ranks;
  std::string store_address;
  int64_t max_step = 0;
  std::optional<int64_t> max_replica_rank;
  int64_t max_world_size = 1;
  bool heal = false;
  int64_t commit_failures = 0;
  std::vector<std::string> replica_ids;

  void encode(Writer& w) const {
    w.i64(quorum_id);
    w.i64(replica_rank);
    w.i64(replica_world_size);
    w.str(recover_src_manager_address);
    w.opt_i64(recover_src_replica_rank);
    w.u32(static_cast<uint32_t>(recover_dst_replica_ranks.size()));
    for (int64_t r : recover_dst_replica_ranks) w.i64(r);
    w.str(store_address);
    w.i64(max_step);
    w.opt_i64(max_replica_rank);
    w.i64(max_world_size);
    w.boolean(heal);
    w.i64(commit_failures);
    w.u32(static_cast<uint32_t>(replica_ids.size()));
    for (const auto& id : replica_ids) w.str(id);
  }
};

}  // namespace tpuft
