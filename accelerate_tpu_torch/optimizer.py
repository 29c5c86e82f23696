"""The prepared optimizer — the counterpart of ``accelerate_tpu/optimizer.py``.

``AcceleratedOptimizer`` holds what the training paths read and write: the
transform (a ``GradientTransformation`` of ``optim.py``), its state, the
gradient accumulation buffer and the fused-update plan (None for a chain the
fused pass does not cover, which then runs the reference chain).

Two paths use it. The fused step (``Accelerator.build_train_step``) runs its
own update. The imperative loop of the JAX package (``optimizer.py:331-510``)
is::

    with accelerator.accumulate(model):
        loss = model(**batch)["loss"]
        accelerator.backward(loss)   # banks the gradients: _accumulate(g, 1/accum)
        optimizer.step()             # a no-op until the window's last micro-step
        scheduler.step()
        optimizer.zero_grad()

``step()`` on a sync boundary takes the global norm of the banked gradients,
the clip factor ``where(clip > 0 & gnorm > clip, clip / (gnorm + 1e-6), 1)``
of a pending ``clip_grad_norm_`` (none: no clip), scales the gradients by it
once, and runs the update: the fused kernel (one launch per parameter leaf,
``fused_update_apply(..., clip_factor=1)``, in place) when the chain has a
plan, the reference chain otherwise (new parameter tensors on the handle). A
non-finite norm skips the update, as the JAX package's ``lax.cond`` does; the
port takes that branch on the host after one ``.item()``, the only read of
the device in ``step()``.

Not ported yet: the fp16 gradient scaler (``mixed_precision="fp16"`` raises
in ``AcceleratorState``; a state dict with a scale raises here), host offload
of the optimizer state, and ZeRO sharding.
"""

from __future__ import annotations

import logging

import torch

from .ops.fused_update import fused_update_apply, plan_fused_update
from .optim import GradientTransformation, apply_updates
from .state import GradientState
from .utils.tree import tree_leaves, tree_unflatten

logger = logging.getLogger(__name__)


def global_norm(grads):
    """``sqrt(Σ_leaves Σ g²)`` in f32, leaves in sorted-key order (the JAX
    package's ``_global_norm``), as a device scalar."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_factor(gnorm, clip):
    """``where(clip > 0 & gnorm > clip, clip / (gnorm + 1e-6), 1)`` as an
    f32 device scalar; ``clip`` is an f32 device scalar."""
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.where((clip > 0) & (gnorm > clip), clip / (gnorm + 1e-6), one)


class AcceleratedOptimizer:
    """Wraps a ``GradientTransformation``; constructed by ``Accelerator.prepare``.
    ``kernels`` is the accelerator's registry spec; ``gradient_state`` its
    accumulation bookkeeping."""

    def __init__(self, tx, gradient_state: GradientState | None = None, kernels=None):
        if not isinstance(tx, GradientTransformation):
            raise TypeError(f"expected an accelerate_tpu_torch.optim.GradientTransformation, "
                            f"got {type(tx)}")
        self.tx = tx
        self.handle = None  # TrainHandle: the parameters this optimizer updates
        self.plan = plan_fused_update(tx)
        self.kernels = kernels
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.opt_state = None
        self._accum_grads = None
        self._pending_clip_norm = None
        self._step_was_skipped = False
        self._step_count = 0  # updates applied

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

    # ------------------------------------------------------------ grad flow
    def _accumulate(self, grads, scale: float = 1.0):
        """Bank one micro-step's gradients (a tree like the parameters, or
        its leaves in ``tree_leaves`` order): the first as ``g * scale``
        (``g`` itself at scale 1), later ones as ``accum + g * scale``. The
        multiply is by the f32 of ``scale``, as in the JAX package's
        imperative path (its fused step divides instead)."""
        self._ensure_initialized()
        leaves = grads if isinstance(grads, (list, tuple)) else tree_leaves(grads)
        leaves = [g.contiguous() for g in leaves]
        with torch.no_grad():
            if self._accum_grads is None:
                if scale != 1.0:
                    leaves = [g * scale for g in leaves]
                self._accum_grads = tree_unflatten(self.handle.params, leaves)
            else:
                for a, g in zip(tree_leaves(self._accum_grads), leaves):
                    a.add_(g * scale)

    # ------------------------------------------------------------- stepping
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("closures are not supported")
        if not self.gradient_state.sync_gradients:
            return  # accumulating
        if self._accum_grads is None:
            logger.warning("optimizer.step() called with no accumulated gradients; skipping")
            return
        self._ensure_initialized()
        handle, grads = self.handle, self._accum_grads
        with torch.no_grad():
            gnorm = global_norm(grads)
            clip = self._pending_clip_norm if self._pending_clip_norm is not None else -1.0
            clip_t = torch.full((), clip, dtype=torch.float32, device=gnorm.device)
            factor = clip_factor(gnorm, clip_t)
            g_leaves = tree_leaves(grads)
            torch._foreach_mul_(g_leaves, factor)
            # JAX keeps this branch on the device (lax.cond); the port reads
            # the one flag it needs.
            if bool(torch.isfinite(gnorm).item()):
                if self.plan is not None:
                    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
                    self.opt_state = fused_update_apply(handle.params, self.opt_state, grads,
                                                        plan=self.plan, clip_factor=one,
                                                        kernels=self.kernels)
                else:
                    updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                              handle.params)
                    handle.params = apply_updates(handle.params, updates)
        self._accum_grads = None
        self._pending_clip_norm = None
        handle.last_grad_norm = gnorm
        # As in the JAX package without the fp16 scaler: the flag stays False
        # (it is the scaler's) and the step counts even when a non-finite
        # norm skipped the update.
        self._step_was_skipped = False
        self._step_count += 1

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last ``step()`` was skipped (only the fp16 scaler
        skips, and it is not ported, so always False)."""
        return self._step_was_skipped

    def zero_grad(self, set_to_none: bool = True):
        """Drop the banked gradients; a no-op while accumulating."""
        if self.gradient_state.sync_gradients:
            self._accum_grads = None

    # ----------------------------------------------------------- inspection
    def _hyperparams(self):
        state = self.opt_state
        if state is None:
            return None
        hp = getattr(state, "hyperparams", None)
        if hp is None and isinstance(state, tuple):
            for s in state:
                hp = getattr(s, "hyperparams", None) or hp
        return hp if hp and "learning_rate" in hp else None

    @property
    def learning_rate(self):
        """The ``inject_hyperparams`` learning rate as a float (a read of the
        device), or None."""
        hp = self._hyperparams()
        return None if hp is None else float(hp["learning_rate"])

    def set_learning_rate(self, lr: float) -> bool:
        """Write ``lr`` (rounded to f32) into the ``inject_hyperparams``
        state, in place on the device: no host wait. False when the chain
        has no such state."""
        hp = self._hyperparams()
        if hp is None:
            return False
        hp["learning_rate"].fill_(lr)
        return True

    @property
    def param_groups(self):
        """One group: the parameter leaves and the current learning rate."""
        return [{"params": tree_leaves(self.handle.params), "lr": self.learning_rate}]

    def state_dict(self):
        return {"opt_state": self.opt_state, "step_count": self._step_count, "scale": None}

    def load_state_dict(self, state_dict):
        if state_dict.get("scale") is not None:
            raise NotImplementedError("the fp16 gradient scaler is not ported yet (ROADMAP.md)")
        self.opt_state = state_dict["opt_state"]
        self._step_count = state_dict.get("step_count", 0)

