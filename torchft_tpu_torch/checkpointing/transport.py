"""Checkpoint transport interface for live peer-to-peer healing.

Mirror of the reference ABC (``torchft/checkpointing/transport.py:14-68``):
a transport advertises ``metadata()`` (carried through the manager quorum so
peers can find it), serves the current state dict to recovering destination
ranks, and fetches a peer's state dict when this replica heals.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class CheckpointTransport(ABC, Generic[T]):
    """Live peer-to-peer checkpoint channel: serve the current state dict
    to recovering replicas and fetch a peer's when healing
    (``torchft/checkpointing/transport.py:14-68``)."""

    @abstractmethod
    def metadata(self) -> str:
        """Opaque metadata handed to recovering peers (e.g. a URL)."""

    @abstractmethod
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: float
    ) -> None:
        """Make ``state_dict`` available to ``dst_ranks`` for ``step``."""

    def disallow_checkpoint(self) -> None:
        """Called after the quorum; the staged checkpoint may be dropped."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> T:
        """Fetch the checkpoint for ``step`` from the peer at ``metadata``."""

    # -- striped healing (multi-source recovery) ---------------------------
    #
    # A striped heal fetches disjoint chunk ranges of the SAME serialized
    # checkpoint from every healthy peer concurrently, reassigning a dead or
    # slow source's remaining chunks to survivors (the heal must survive
    # losing all but one source).  The base-class defaults degrade to the
    # single-peer methods so transports opt in incrementally.

    def send_checkpoint_striped(
        self,
        dst_ranks: List[int],
        step: int,
        state_dict: T,
        timeout: float,
        source_index: int = 0,
        num_sources: int = 1,
    ) -> None:
        """Serve this peer's share of a striped heal: chunk ``chunk_idx %
        num_sources == source_index`` of the canonical chunk index.  Pull
        transports (HTTP) ignore the share and simply stage; push transports
        send their share and then answer steal requests."""
        self.send_checkpoint(dst_ranks, step, state_dict, timeout)

    def recv_checkpoint_striped(
        self,
        sources: List[Tuple[int, Optional[str]]],
        step: int,
        timeout: float,
        **kwargs: object,
    ) -> T:
        """Fetch from ``sources`` — ordered (replica_rank, metadata) pairs;
        metadata None marks a source whose metadata could not be fetched
        (kept in the list so positional chunk assignments stay consistent
        across peers).  Default: single-source fallback on the first usable
        source."""
        src_rank, metadata = next(
            ((r, m) for r, m in sources if m is not None), sources[0]
        )
        return self.recv_checkpoint(src_rank, metadata or "", step, timeout, **kwargs)

    def shutdown(self, wait: bool = True) -> None:
        """Release resources (called from Manager.shutdown)."""
