"""Optimizer wrapper: the whole per-step protocol in two verbs.

Twin of the reference wrapper (``torchft/optim.py:24-63``) and of the JAX
package's: ``zero_grad()`` (alias ``start_step()``) starts the quorum and
zeroes the gradients; ``step()`` runs the wrapped ``torch.optim``
optimizer only when ``manager.should_commit()`` votes yes.  Parameters are
updated in place, so a heal applied inside the vote is already what the
update sees.

:class:`OuterSGD` is DiLoCo's outer optimizer: a functional transform over
flat f32 host arrays, because the sharded outer sync steps it per chunk on
slices of its state (on the card the outer kernel, ``ops/outer.py``, does
the same arithmetic); the replicated sync steps it per leaf in the leaf's
dtype (:meth:`OuterSGD.update_leaves`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
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


class OuterSGD:
    """SGD with optional (Nesterov) momentum as a functional transform over
    flat f32 numpy arrays: the counterpart of ``optax.sgd(lr, momentum,
    nesterov)``, the outer optimizer every DiLoCo caller of the JAX package
    passes.

    ``init(flat)`` returns the state leaves: ``[trace]`` with momentum,
    ``[]`` without (``optax.sgd``'s ``tree_leaves``, so a reshard blob
    pickled by a JAX rank loads here and the other way round).
    ``update(grad, state, params)`` returns ``(updates, new_state)`` with
    optax's trace arithmetic: ``t = g + m·t``; the update is ``-lr·(g +
    m·t)`` with Nesterov, else ``-lr·t``.  With dampening 0 that is
    ``torch.optim.SGD``'s step.  ``momentum=0`` means no trace, as
    ``optax.sgd``'s default ``momentum=None``."""

    def __init__(self, lr: float, momentum: float = 0.0, nesterov: bool = False) -> None:
        if nesterov and not momentum:
            raise ValueError("OuterSGD: nesterov needs a momentum")
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, flat: np.ndarray) -> List[np.ndarray]:
        return [np.zeros(np.shape(flat), dtype=np.float32)] if self.momentum else []

    def update(
        self, grad: np.ndarray, state: List[np.ndarray], params: Any = None
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        g = np.asarray(grad, dtype=np.float32)
        neg_lr = np.float32(-self.lr)
        if not self.momentum:
            return neg_lr * g, []
        m = np.float32(self.momentum)
        trace = g + m * state[0]
        direction = g + m * trace if self.nesterov else trace
        return neg_lr * direction, [trace]

    def init_leaves(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The state of :meth:`update_leaves`: one trace per leaf, zeros in
        the leaf's dtype (``optax.sgd``'s ``init`` over a list of leaves)."""
        return [torch.zeros_like(p) for p in params] if self.momentum else []

    def update_leaves(
        self, grads: List[torch.Tensor], state: List[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """:meth:`update` on host tensors, each leaf in its own dtype, as
        ``optax.sgd`` steps a list of leaves eagerly: the scalars are cast
        to the leaf's dtype first, and every product and sum is rounded to
        it (round to nearest even) before the next operation reads it.  On
        f32 leaves this is :meth:`update`'s arithmetic."""

        def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.float32).to(like.dtype)

        if not self.momentum:
            return [scalar(-self.lr, g) * g for g in grads], []
        traces = [g + scalar(self.momentum, g) * t for g, t in zip(grads, state)]
        directions = (
            [g + scalar(self.momentum, g) * t for g, t in zip(grads, traces)]
            if self.nesterov
            else traces
        )
        return [scalar(-self.lr, d) * d for d in directions], traces
