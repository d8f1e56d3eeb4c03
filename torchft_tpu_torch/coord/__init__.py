"""Hierarchical coordination plane (wire v4).

At the scale argued by the 100k-GPU HSDP report and SPARe (PAPERS.md), the
flat control plane — every replica (and spare) heartbeating one lighthouse,
every quorum broadcast carrying full membership, every status poll
recomputing fleet state — becomes the bottleneck long before the data plane
does.  This package is the aggregation tier that fixes all three:

- :class:`ZoneAggregator` — a per-host/per-zone process that batches member
  heartbeats (with their ``CommHealth`` summaries and spare warm-progress)
  into ONE upstream ``LH_AGG_BEAT`` RPC per flush tick.  The control-plane
  analog of the data plane's host-leader abstraction: members talk to a local
  leader, only leaders talk upstream.
- :class:`AggMemberClient` — the member side: managers route their beats
  through a discovered aggregator (``TORCHFT_AGG_ADDR``) and fall back to
  direct lighthouse beats on aggregator death.
- :mod:`torchft_tpu_torch.coord.scale` — the thread-plane scale harness: 500–1000
  simulated replicas plus a spare pool driven through quorum/kill/rejoin/
  promote churn, reporting p99 quorum latency, lighthouse CPU, and the
  lighthouse-inbound RPC reduction vs direct heartbeats.

The lighthouse side (accepting aggregated beats, the aggregator-death
reporting-gap grace, delta-coded quorum broadcasts, the TTL-cached /status
snapshot) lives in ``lighthouse.py``/``wire.py``; see docs/operations.md
§15 for the runbook.
"""

from torchft_tpu_torch.coord.aggregator import AggMemberClient, ZoneAggregator

__all__ = ["AggMemberClient", "ZoneAggregator"]
