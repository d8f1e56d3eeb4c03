"""Runtime tier selection: C++ native plane vs pure-Python fallback.

The port's copy of ``torchft_tpu/tier.py``.  The C++ runtime (the port's
own ``libtpuft_torch``, built from ``csrc/native/`` by :mod:`.native`) is
the production tier: per-lane worker threads driving scatter-gather
(sendmsg/recvmsg) framed collectives, native lighthouse/manager servers
speaking the same framed wire protocol as their Python twins
(``tests/test_torch_native.py`` proves cross-tier interop, including rings
that mix tiers and packages).  The Python tier exists so the framework runs
anywhere the shared library doesn't build — and it remains the only tier
with hierarchical/shm topology dispatch, fault injection, and in-epoch lane
recovery.  This mirrors the reference, whose benched production path is
NCCL while Gloo is the portable fallback
(``torchft/process_group.py:643-891``).

``TORCHFT_TIER`` selects explicitly: ``cpp`` | ``python`` | ``auto``
(default — cpp whenever the library loads).  For the **data plane**
specifically (:func:`make_communicator`), ``auto`` additionally downgrades
to the Python tier when hierarchical dispatch is forced on
(``TORCHFT_HIERARCHICAL=1``): the native mesh speaks only the flat-ring
schedule today, and a forced-hierarchical fleet must not silently lose its
topology dispatch.  The downgrade is a single loud log line.
"""

from __future__ import annotations

import logging
from typing import Optional

from torchft_tpu_torch import knobs

logger = logging.getLogger("torchft_tpu_torch.tier")

TIER_ENV = "TORCHFT_TIER"


def _tier_env() -> str:
    return knobs.get_str(TIER_ENV, "auto").lower()


def default_tier() -> str:
    """Resolve the active tier name ("cpp" or "python")."""
    env = _tier_env()
    if env in ("cpp", "python"):
        return env
    if env not in ("", "auto"):
        logger.warning("unknown %s=%r; using auto", TIER_ENV, env)
    try:
        from torchft_tpu_torch import native

        return "cpp" if native.available() else "python"
    except Exception:  # noqa: BLE001 — a broken build falls back, not crashes
        return "python"


def data_plane_tier() -> str:
    """The tier the flat-ring DATA PLANE should run ("cpp" or "python").

    Same resolution as :func:`default_tier`, with one extra rule: in
    ``auto`` mode a topology that *forces* hierarchical dispatch keeps the
    Python tier (the native mesh has no shm/leader-ring dispatch yet), with
    a loud one-line log of the downgrade.  An explicit ``TORCHFT_TIER=cpp``
    is honored as stated — the Python peers' forced-hierarchical rendezvous
    will then fail loudly rather than desynchronize silently.
    """
    env = _tier_env()
    if env == "python":
        return "python"
    hier = knobs.get_str("TORCHFT_HIERARCHICAL", "auto").strip().lower()
    hier_forced = hier in ("1", "true", "on")
    if env == "cpp":
        if hier_forced:
            logger.warning(
                "TORCHFT_TIER=cpp with TORCHFT_HIERARCHICAL=1: the native "
                "mesh runs the flat ring only — hierarchical peers will "
                "fail rendezvous loudly"
            )
        return "cpp"
    tier = default_tier()
    if tier == "cpp" and hier_forced:
        logger.warning(
            "native tier downgraded to python data plane: "
            "TORCHFT_HIERARCHICAL=1 requests topology dispatch the cpp "
            "mesh does not implement (set TORCHFT_TIER=cpp to override)"
        )
        return "python"
    return tier


def make_communicator(timeout_s: float = 60.0, tier: Optional[str] = None):
    """Data-plane communicator for the active tier.

    This is the factory the train loop, the DiLoCo outer sync, and the
    heal drain all ride: ``Manager`` calls it when constructed without an
    explicit ``comm``, so ``TORCHFT_TIER=auto`` puts every data-plane byte
    on the native mesh whenever the library loads (and the topology does
    not force the Python tier — see :func:`data_plane_tier`).
    """
    tier = tier or data_plane_tier()
    if tier == "cpp":
        from torchft_tpu_torch.native import CppCommunicator

        return CppCommunicator(timeout_s=timeout_s)
    from torchft_tpu_torch.communicator import TCPCommunicator

    return TCPCommunicator(timeout_s=timeout_s)


def make_lighthouse(
    bind: str = "0.0.0.0:0",
    min_replicas: int = 1,
    join_timeout_ms: int = 100,
    quorum_tick_ms: int = 100,
    heartbeat_timeout_ms: int = 5_000,
    tier: Optional[str] = None,
):
    """Lighthouse server for the active tier (same ctor surface both ways).

    The Python lighthouse additionally serves the web dashboard; deployments
    that want both the C++ control plane and the dashboard can front the C++
    server with ``lighthouse.py``'s HTTP handler.
    """
    tier = tier or default_tier()
    kwargs = dict(
        bind=bind,
        min_replicas=min_replicas,
        join_timeout_ms=join_timeout_ms,
        quorum_tick_ms=quorum_tick_ms,
        heartbeat_timeout_ms=heartbeat_timeout_ms,
    )
    if tier == "cpp":
        from torchft_tpu_torch.native import CppLighthouseServer

        return CppLighthouseServer(**kwargs)
    from torchft_tpu_torch.lighthouse import LighthouseServer

    return LighthouseServer(**kwargs)


def manager_server_cls(tier: Optional[str] = None):
    """The ``server_cls`` to hand :class:`torchft_tpu_torch.manager.Manager`."""
    tier = tier or default_tier()
    if tier == "cpp":
        from torchft_tpu_torch.native import CppManagerServer

        return CppManagerServer
    from torchft_tpu_torch.manager_server import ManagerServer

    return ManagerServer
