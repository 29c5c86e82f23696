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

Under ``mixed_precision="fp16"`` the optimizer holds the dynamic loss
scaler (:class:`GradScalerState`, JAX ``optimizer.py:89-112``): the
gradients arrive computed from ``loss * scale``, and ``step()`` unscales
them (``g * f32(1 / scale)``), then takes the global norm, the clip factor
and ``finite = isfinite(gnorm)``, in the JAX package's order
(``optimizer.py:273-322``). A non-finite step updates nothing: no
fused-update kernel is launched, the buffer is dropped, the scale halves
and the step is counted in ``skipped_steps``. The finite flag is the one
read of the device ``step()`` already made (the JAX package resolves its
flag at the next forward instead: one read a step either way), so the
scaler's update is known when ``step()`` returns. The scale travels in
``state_dict()`` and in checkpoints (``optimizer.meta.pkl``).

Host offload (``host_offload=True``, from
``FullyShardedDataParallelPlugin(cpu_offload=True)``; JAX ``optimizer.py:
244, 369-377``): between imperative steps the state (every tensor of it,
on every held rank under sharding) lives in pinned host memory; ``step()``
copies it to the device, runs the update there and copies it back into the
same pinned buffers, all on the current stream, so nothing waits for the
host. A read of ``opt_state`` or ``rank_states`` from outside waits for the
copy back to land. The fused ``build_train_step`` moves the state to the
device once and keeps it there, as the JAX package's fused step does.
"""

from __future__ import annotations

import logging

import torch

from .ops.fused_update import fused_update_apply, plan_fused_update
from .optim import GradientTransformation, apply_updates
from .state import GradientState
from .utils.tree import flatten_with_paths, map_with_paths, tree_leaves, tree_unflatten

logger = logging.getLogger(__name__)


def global_norm(grads):
    """``sqrt(Σ_leaves Σ g²)`` in f32, leaves in sorted-key order (the JAX
    package's ``_global_norm``), as a device scalar."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


class GradScalerState:
    """The fp16 dynamic loss scaler (JAX ``optimizer.py:89-112``, torch
    ``GradScaler``'s semantics): on non-finite gradients the step is skipped
    and the scale multiplies by ``backoff_factor``; after
    ``growth_interval`` good steps in a row it multiplies by
    ``growth_factor``."""

    def __init__(self, init_scale=2.0**15, growth_factor=2.0, backoff_factor=0.5,
                 growth_interval=2000):
        self.scale = float(init_scale)
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self._good_steps = 0

    def update(self, found_inf: bool):
        if found_inf:
            self.scale *= self.backoff_factor
            self._good_steps = 0
        else:
            self._good_steps += 1
            if self._good_steps >= self.growth_interval:
                self.scale *= self.growth_factor
                self._good_steps = 0

    def inv_scale(self, device):
        """``f32(1 / scale)`` as a device scalar (the JAX package's
        ``jnp.float32(1.0 / scaler.scale)``)."""
        return torch.full((), 1.0 / self.scale, dtype=torch.float32, device=device)


def _to_device(state, device):
    """The state's tensors copied to ``device`` (asynchronously from pinned
    memory); other leaves as they are."""
    return map_with_paths(
        lambda _, t: t.to(device, non_blocking=True) if isinstance(t, torch.Tensor) else t,
        state)


def _park(host, state):
    """``state`` copied into the host buffers of ``host`` (a state of the
    same structure, or None: new buffers, pinned when ``state`` lies on a
    card), without waiting; returns the host state."""
    if host is None:
        def new(_, t):
            if not isinstance(t, torch.Tensor):
                return t
            if t.is_cuda:
                out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return out.copy_(t, non_blocking=True)
            return t.detach().clone()

        return map_with_paths(new, state)
    dst = dict(flatten_with_paths(host))
    for path, t in flatten_with_paths(state):
        if isinstance(t, torch.Tensor):
            dst[path].copy_(t, non_blocking=True)
    return host


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
                 zero_sharding: bool = False, scaler: GradScalerState | None = None,
                 host_offload: bool = False):
        if not isinstance(tx, GradientTransformation):
            raise TypeError(f"expected an accelerate_tpu_torch.optim.GradientTransformation, "
                            f"got {type(tx)}")
        self.tx = tx
        self.handle = None  # TrainHandle: the parameters this optimizer updates
        self.plan = plan_fused_update(tx)
        self.kernels = kernels
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.scaler = scaler
        self.host_offload = bool(host_offload)
        self._opt_state = None
        self._rank_states = None  # sharded: per held rank, its state
        self._on_host = False     # the state lies in (pinned) host memory
        self._parked = None       # CUDA event of the last copy back to the host
        self._accum_grads = None
        self._pending_clip_norm = None
        self._step_was_skipped = False
        self._step_count = 0  # updates applied
        self.skipped_steps = 0  # fp16 updates skipped on a non-finite gradient
        self.zero_sharding = bool(zero_sharding)
        self.accelerator = None  # the Accelerator that prepared it (shards a ZeRO model)

    # ------------------------------------------------------------ state
    def _wait_parked(self):
        if self._parked is not None:
            self._parked.synchronize()
            self._parked = None

    @property
    def opt_state(self):
        """The state (the first held rank's under sharding); on the host
        under offload, once its last copy there has landed."""
        self._wait_parked()
        return self._opt_state

    @opt_state.setter
    def opt_state(self, state):
        self._wait_parked()
        self._opt_state = state
        if self._rank_states is not None:
            self._rank_states[0] = state

    @property
    def rank_states(self):
        """Sharded: per held rank, its state (as :attr:`opt_state`)."""
        self._wait_parked()
        return self._rank_states

    @rank_states.setter
    def rank_states(self, states):
        self._wait_parked()
        self._rank_states = states
        self._opt_state = None if states is None else states[0]

    def _states(self):
        return self._rank_states if self._rank_states is not None else [self._opt_state]

    def _set_states(self, states):
        if self._rank_states is not None:
            self._rank_states = list(states)
        self._opt_state = states[0]

    def _fetch_state(self):
        """Bring an offloaded state to the device (no wait: the copies run
        on the current stream, after the copies back)."""
        if self._on_host:
            dev = self.handle.device
            self._set_states([_to_device(s, dev) for s in self._states()])
            self._on_host = False
            self._parked = None

    def _park_state(self, host_states=None):
        """Copy the state back into host memory (into ``host_states``, the
        buffers it came from, when given), recording an event the host
        waits on before it reads them."""
        states = self._states()
        host_states = host_states or [None] * len(states)
        self._set_states([_park(h, s) for h, s in zip(host_states, states)])
        self._on_host = True
        if self.handle.device.type == "cuda":
            self._parked = torch.cuda.Event()
            self._parked.record()

    def _ensure_initialized(self):
        if self.handle is None:
            raise RuntimeError("the optimizer is bound to no model; prepare(model, optimizer)")
        if self.tx.device != self.handle.device:
            raise ValueError(f"the optimizer keeps its state on {self.tx.device}, the model's "
                             f"parameters are on {self.handle.device}")
        if self._opt_state is not None:
            return
        acc = self.accelerator
        if (self.zero_sharding and self.handle.sharded is None and acc is not None
                and acc.mesh_sizes["dp"] > 1):
            acc._shard(self.handle)
        engine = self.handle.sharded
        if engine is None:
            self._opt_state = self.tx.init(self.handle.params)
        else:
            engine.set_zero_specs(self._plan_zero_specs())
            engine.ensure_accum()
            self.rank_states = engine.init_states(self.tx)
        if self.host_offload:
            self._park_state()

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
        ``g * (1/accum)``, as :meth:`_accumulate` banks (gradients of the
        scaled loss under fp16)."""
        self._ensure_initialized()
        engine, scale = self.handle.sharded, 1.0 / accum_steps

        def sink(i, layer, key, g):
            target = engine.accum[i][key]
            (target if layer is None else target[layer]).add_(g * scale)

        return sink

    def _sharded_update(self, factor, kernels=None):
        """The update on the shards with clip factor ``factor``."""
        engine = self.handle.sharded
        self._fetch_state()
        self.rank_states = engine.update(self.tx, self.plan, self._rank_states, factor,
                                         kernels=self.kernels if kernels is None else kernels)

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
            g_leaves = tree_leaves(grads)
            if self.scaler is not None:
                torch._foreach_mul_(g_leaves, self.scaler.inv_scale(handle.device))
            gnorm = global_norm(grads)
            clip = self._pending_clip_norm if self._pending_clip_norm is not None else -1.0
            clip_t = torch.full((), clip, dtype=torch.float32, device=gnorm.device)
            factor = clip_factor(gnorm, clip_t)
            torch._foreach_mul_(g_leaves, factor)
            # JAX keeps this branch on the device (lax.cond); the port reads
            # the one flag it needs.
            finite = bool(torch.isfinite(gnorm).item())
            if finite:
                host = self._states() if self._on_host else None
                self._fetch_state()
                if self.plan is not None:
                    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
                    self._opt_state = fused_update_apply(handle.params, self._opt_state, grads,
                                                         plan=self.plan, clip_factor=one,
                                                         kernels=self.kernels)
                else:
                    updates, self._opt_state = self.tx.update(grads, self._opt_state,
                                                               handle.params)
                    handle.params = apply_updates(handle.params, updates)
                if self.host_offload:
                    self._park_state(host)
        self._accum_grads = None
        self._pending_clip_norm = None
        handle.last_grad_norm = gnorm
        self._count_step(finite)

    def _count_step(self, finite: bool):
        """The imperative step's bookkeeping. With the fp16 scaler, the
        scaler's (:meth:`_count_fused_step`) and only applied updates
        counted (JAX ``_resolve_pending_finite``). Without it, as in the
        JAX package: the flag stays False and the step counts even when a
        non-finite norm skipped the update."""
        if self.scaler is None:
            self._step_was_skipped = False
            self._step_count += 1
            return
        self._count_fused_step(finite)
        self._step_count += int(finite)

    def _count_fused_step(self, finite: bool):
        """The fused step's fp16 bookkeeping: the scale's backoff or growth,
        the skipped flag and count; the applied count stays the imperative
        path's, as in the JAX package."""
        self.scaler.update(not finite)
        self._step_was_skipped = not finite
        if not finite:
            self.skipped_steps += 1

    def _sharded_step(self):
        engine = self.handle.sharded
        with torch.no_grad():
            buffers = [t for shards in engine.accum for t in shards.values()]
            if self.scaler is not None:
                torch._foreach_mul_(buffers, self.scaler.inv_scale(self.handle.device))
            gnorm = engine.global_norm()
            clip = self._pending_clip_norm if self._pending_clip_norm is not None else -1.0
            clip_t = torch.full((), clip, dtype=torch.float32, device=gnorm.device)
            factor = clip_factor(gnorm, clip_t)
            torch._foreach_mul_(buffers, factor)
            finite = engine.all_finite(gnorm)
            if finite:
                host = self._states() if self._on_host else None
                self._sharded_update(torch.ones((), dtype=torch.float32, device=gnorm.device))
                if self.host_offload:
                    self._park_state(host)
            else:
                for t in buffers:
                    t.zero_()
        self._accum_grads = None
        self._pending_clip_norm = None
        self.handle.last_grad_norm = gnorm
        self._count_step(finite)

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last ``step()`` was skipped on a non-finite gradient
        (only the fp16 scaler skips)."""
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
        return {"opt_state": self.opt_state, "step_count": self._step_count,
                "scale": self.scaler.scale if self.scaler is not None else None}

    def load_state_dict(self, state_dict):
        """The state, step count and (under fp16) scale of ``state_dict``;
        under offload the state goes to pinned host memory."""
        scale = state_dict.get("scale")
        if scale is not None and self.scaler is not None:
            self.scaler.scale = float(scale)
        self.opt_state = state_dict["opt_state"]
        self._on_host = False
        if self.host_offload and self.handle is not None and self._opt_state is not None:
            self._park_state()
        self._step_count = state_dict.get("step_count", 0)

