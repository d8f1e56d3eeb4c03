"""``ftlint`` of the PyTorch/CUDA port — static analysis of ``torchft_tpu_torch``.

The JAX package's nine checkers (``torchft_tpu/analysis``), pointed at the
port's own tree: its package, its C++ runtime under
``torchft_tpu_torch/csrc/native/``, its registries and its doc,
``docs/torch_operations.md``.  Nine AST/text checkers enforce the invariants that keep a heavily
concurrent fault-tolerance control plane coherent, the ones the bug record
shows are otherwise caught only by hand:

- ``thread-safety`` (:mod:`.threads`): builds a thread-entry graph per
  class (``threading.Thread`` targets, executor ``submit`` targets, and
  everything transitively reachable — RPC handlers ride the accept-loop's
  reachability) and flags read-modify-write mutations of ``self.*`` state
  reachable from two or more entry points that are not lexically under a
  ``with <lock>`` — the ``_inflight_ops +=`` bug class, found statically.
- ``lock-order`` (:mod:`.concurrency`): per-class lock-acquisition graph
  (nested ``with`` scopes, including across ``self._method()`` calls) —
  cycles are potential deadlocks, and re-acquiring a plain ``Lock`` on the
  same thread is a certain one.
- ``blocking-under-lock`` (:mod:`.concurrency`): RPC round-trips, socket
  IO, ``Future.result()``, ``Event.wait()``, ``join()``, ``time.sleep``
  reachable while a lock is lexically held — the quorum-wedge shape.
- ``executor-starvation`` (:mod:`.concurrency`): submits onto a
  single-thread executor from code that itself runs on that executor
  (the task queues behind its submitter; waiting on it self-deadlocks).
- ``wire-protocol`` (:mod:`.wireproto`): every data-plane tag literal must
  come from the central registry in ``wire.py`` (no more scattered 103 /
  880 / 900 / 4000... constants), registered allocations must not collide,
  and every ``encode``/``decode`` pair in ``wire.py`` must be symmetric
  per wire-version gate — a field serialized under
  ``manager_quorum_wire_version() >= N`` must be parsed under the same
  guard, so a one-sided tail can never silently desync rolling upgrades.
- ``knob-registry`` (:mod:`.knobcheck`): every ``TORCHFT_*`` / ``TPUFT_*``
  environment knob mentioned in source must be declared in
  ``torchft_tpu_torch/knobs.py``, and the knob table in ``docs/torch_operations.md``
  must agree with the registry in both directions.
- ``metrics-registry`` (:mod:`.metricscheck`): every name served on a
  ``/metrics`` endpoint must be declared exactly once in
  ``torchft_tpu_torch/obs/metrics.py``, Prometheus-legal (counters end in
  ``_total``), documented in ``docs/torch_operations.md`` §2, and every
  metric-shaped literal in source must name a declared metric.
- ``native-mirror`` (:mod:`.nativemirror`): the hand-mirrored constants
  shared with the C++ tier (``csrc/native/comm.h`` / ``csrc/native/wire.h`` — lane
  hello flag, 64-byte stripe alignment, frame cap, message types, the
  ``lane_parts`` / ``outer_shard_parts`` / ``HostTopology`` mirrors) must
  match their Python counterparts so the tiers can't drift apart silently.
- ``native-locks`` (:mod:`.nativelocks`): C++ lock discipline, textually —
  ``// guards`` annotations enforced, raw deref of ``*_snapshot()``-style
  members banned (the torn-``EpochIO``-pointer class), dead mutexes and
  atomic/plain mixing flagged.

Run ``python -m torchft_tpu_torch.analysis`` from the repo root.  A
finding is suppressed either by an inline pragma on its line —
``# ftlint: ignore[<checker>] — <why>`` — or by a fingerprint in
``torchft_tpu_torch/analysis/baseline.json`` (grandfathered violations only;
kept empty).  See ``docs/torch_operations.md`` §3.
"""

from torchft_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    load_baseline,
    run_checkers,
)

CHECKERS = (
    "thread-safety",
    "lock-order",
    "blocking-under-lock",
    "executor-starvation",
    "wire-protocol",
    "knob-registry",
    "metrics-registry",
    "native-mirror",
    "native-locks",
)
