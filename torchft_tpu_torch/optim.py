"""Optimizer wrapper: the whole per-step protocol in two verbs.

Twin of the reference wrapper (``torchft/optim.py:24-63``) and of the JAX
package's: ``zero_grad()`` (alias ``start_step()``) starts the quorum and
zeroes the gradients; ``step()`` runs the wrapped ``torch.optim``
optimizer only when ``manager.should_commit()`` votes yes.  Parameters are
updated in place, so a heal applied inside the vote is already what the
update sees.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchft_tpu_torch.manager import Manager


class OptimizerWrapper:
    """Usage::

        opt = OptimizerWrapper(manager, torch.optim.AdamW(model.parameters()))
        for tokens, targets in data:
            opt.zero_grad()                        # quorum (async) begins
            model.loss(tokens, targets).backward()
            allreduce_gradients(manager, model)    # replica-dim average
            committed = opt.step()
    """

    def __init__(self, manager: Manager, optimizer: torch.optim.Optimizer) -> None:
        self.manager = manager
        self.optimizer = optimizer

    def zero_grad(self, set_to_none: bool = True, **quorum_kwargs: Any) -> None:
        """Begin a step: start the quorum, then clear the gradients."""
        self.manager.start_quorum(**quorum_kwargs)
        self.optimizer.zero_grad(set_to_none=set_to_none)

    start_step = zero_grad

    def step(self, closure: Optional[Callable[[], float]] = None) -> bool:
        """Commit-gated optimizer step; returns whether it committed."""
        if not self.manager.should_commit():
            return False
        self.optimizer.step(closure)
        return True
