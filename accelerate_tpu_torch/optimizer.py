"""The prepared optimizer — the counterpart of ``accelerate_tpu/optimizer.py``.

``AcceleratedOptimizer`` holds what the training step reads and writes: the
transform (a ``GradientTransformation`` of ``optim.py``), its state, the
gradient accumulation buffer and the fused-update plan (None for a chain the
fused pass does not cover, which then runs the reference chain). The kernel
spec is the ``Accelerator``'s, which its training step reads. The imperative ``step()`` /
``zero_grad()`` loop, the fp16 gradient scaler and ZeRO sharding are not
ported yet.
"""

from __future__ import annotations

from .ops.fused_update import plan_fused_update
from .optim import GradientTransformation


class AcceleratedOptimizer:
    """Wraps a ``GradientTransformation``; constructed by ``Accelerator.prepare``."""

    def __init__(self, tx):
        if not isinstance(tx, GradientTransformation):
            raise TypeError(f"expected an accelerate_tpu_torch.optim.GradientTransformation, "
                            f"got {type(tx)}")
        self.tx = tx
        self.handle = None  # TrainHandle: the parameters this optimizer updates
        self.plan = plan_fused_update(tx)
        self.opt_state = None
        self._accum_grads = None

    def _ensure_initialized(self):
        if self.handle is None:
            raise RuntimeError("the optimizer is bound to no model; prepare(model, optimizer)")
        if self.tx.device != self.handle.device:
            raise ValueError(f"the optimizer keeps its state on {self.tx.device}, the model's "
                             f"parameters are on {self.handle.device}")
        if self.opt_state is None:
            self.opt_state = self.tx.init(self.handle.params)

    @property
    def grads(self):
        """The accumulation buffer (a tree like the parameters), or None."""
        return self._accum_grads
