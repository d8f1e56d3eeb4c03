"""Low-level coordination API for custom fault-tolerance algorithms.

Re-exports the quorum/heartbeat building blocks (the reference exposes the
same surface in ``torchft/coordination.py:23-39``) so users can build their
own FT protocols without the Manager:

- :class:`LighthouseClient` / :class:`LighthouseServer` — global membership
- :class:`ManagerClient` / :class:`ManagerServer` — per-group barrier/voting
- :class:`Quorum` / :class:`QuorumMember` — wire structs
- ``CppLighthouseServer`` / ``CppManagerServer`` / ``CppStoreServer`` — the
  native (C++) server implementations, drop-in behind the same clients,
  resolved lazily from the port's own :mod:`torchft_tpu_torch.native`
  (its library builds at first use, never at import)
"""

from torchft_tpu_torch.lighthouse import LighthouseClient, LighthouseServer
from torchft_tpu_torch.manager_server import (
    ManagerClient,
    ManagerServer,
    compute_quorum_results,
)
from torchft_tpu_torch.store import PrefixStore, StoreClient, StoreServer
from torchft_tpu_torch.wire import ManagerQuorumResult, Quorum, QuorumMember

__all__ = [
    "LighthouseClient",
    "LighthouseServer",
    "ManagerClient",
    "ManagerServer",
    "ManagerQuorumResult",
    "PrefixStore",
    "Quorum",
    "QuorumMember",
    "StoreClient",
    "StoreServer",
    "compute_quorum_results",
]


def __getattr__(name: str):
    # native servers are optional (require the built C++ runtime)
    if name in ("CppLighthouseServer", "CppManagerServer", "CppStoreServer"):
        from torchft_tpu_torch import native

        return getattr(native, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
