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

Sharded models (``parallel/fsdp.py``: an fsdp axis, ZeRO, a loopback): the
state is one tree per held rank (``rank_states``; ``opt_state`` is the first
held rank's), built by ``tx.init`` over that rank's update slices, so the
moments exist only as shards. With ``zero_sharding`` and a dp axis the ZeRO
plan (``parallel/sharding.plan_zero_shardings``, the JAX package's
``_plan_zero_shardings``) splits each update further over dp; it engages
when at least one leaf gains dp (``zero_active``). The buffer is the model's
sharded buffer, the norm the sharded one, and ``step()`` scales the shards
by the clip factor and runs the update on them.

Not ported yet: the fp16 gradient scaler (``mixed_precision="fp16"`` raises
in ``AcceleratorState``; a state dict with a scale raises here) and host
offload of the optimizer state.
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

    def __init__(self, tx, gradient_state: GradientState | None = None, kernels=None,
                 zero_sharding: bool = False):
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
        self.zero_sharding = bool(zero_sharding)
        self.accelerator = None  # the Accelerator that prepared it (shards a ZeRO model)
        self.rank_states = None  # sharded: per held rank, its state

    def _ensure_initialized(self):
        if self.handle is None:
            raise RuntimeError("the optimizer is bound to no model; prepare(model, optimizer)")
        if self.tx.device != self.handle.device:
            raise ValueError(f"the optimizer keeps its state on {self.tx.device}, the model's "
                             f"parameters are on {self.handle.device}")
        if self.opt_state is not None:
            return
        acc = self.accelerator
        if (self.zero_sharding and self.handle.sharded is None and acc is not None
                and acc.mesh_sizes["dp"] > 1):
            acc._shard(self.handle)
        engine = self.handle.sharded
        if engine is None:
            self.opt_state = self.tx.init(self.handle.params)
            return
        engine.set_zero_specs(self._plan_zero_specs())
        engine.ensure_accum()
        self.rank_states = [self.tx.init(engine.update_template(r)) for r in engine.ranks]
        self.opt_state = self.rank_states[0]

    def _plan_zero_specs(self):
        """The ZeRO specs of the model's leaves, or None when ZeRO is off,
        dp is 1, or no leaf gains a dp split (JAX ``optimizer.py:143-192``;
        no port model defines ZeRO rules, so the shape-aware plan runs)."""
        from .parallel.sharding import plan_zero_shardings, spec_axes

        engine = self.handle.sharded
        if not self.zero_sharding or engine.sizes["dp"] <= 1:
            return None
        plan = plan_zero_shardings(engine.template, engine.specs, dict(engine.sizes))
        base = tree_leaves(engine.specs)
        if not any("dp" in spec_axes(z) and "dp" not in spec_axes(b)
                   for z, b in zip(tree_leaves(plan), base)):
            return None
        return plan

    @property
    def zero_active(self) -> bool:
        """Whether ZeRO engaged: requested, dp > 1, and at least one leaf
        gained a dp split. Valid after ``_ensure_initialized()``."""
        engine = None if self.handle is None else self.handle.sharded
        return engine is not None and engine.zero_active

    def _sharded_sink(self, accum_steps: int):
        """The imperative backward's gradient sink: the buffer shard plus
        ``g * (1/accum)``, as :meth:`_accumulate` banks."""
        self._ensure_initialized()
        engine, scale = self.handle.sharded, 1.0 / accum_steps

        def sink(i, layer, key, g):
            target = engine.accum[i][key]
            (target if layer is None else target[layer]).add_(g * scale)

        return sink

    def _sharded_update(self, factor, kernels=None):
        """The update on the shards with clip factor ``factor``."""
        engine = self.handle.sharded
        self.rank_states = engine.update(self.tx, self.plan, self.rank_states, factor,
                                         kernels=self.kernels if kernels is None else kernels)
        self.opt_state = self.rank_states[0]

    def grad_norm(self):
        """The global norm of the banked gradients (the sharded norm on a
        sharded model)."""
        engine = None if self.handle is None else self.handle.sharded
        return global_norm(self.grads) if engine is None else engine.global_norm()

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
        if handle.sharded is not None:
            return self._sharded_step()
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

    def _sharded_step(self):
        engine = self.handle.sharded
        with torch.no_grad():
            gnorm = engine.global_norm()
            clip = self._pending_clip_norm if self._pending_clip_norm is not None else -1.0
            clip_t = torch.full((), clip, dtype=torch.float32, device=gnorm.device)
            factor = clip_factor(gnorm, clip_t)
            buffers = [t for shards in engine.accum for t in shards.values()]
            torch._foreach_mul_(buffers, factor)
            if bool(torch.isfinite(gnorm).item()):
                self._sharded_update(torch.ones((), dtype=torch.float32, device=gnorm.device))
            else:
                for t in buffers:
                    t.zero_()
        self._accum_grads = None
        self._pending_clip_norm = None
        self.handle.last_grad_norm = gnorm
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
            engine = None if self.handle is None else self.handle.sharded
            if engine is not None and engine.accum is not None:
                for shards in engine.accum:
                    for t in shards.values():
                        t.zero_()

    # ----------------------------------------------------------- inspection
    def _hyperparams(self, state=None):
        state = self.opt_state if state is None else state
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
        for state in (self.rank_states or [])[1:]:  # the loopback's other ranks
            self._hyperparams(state)["learning_rate"].fill_(lr)
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

