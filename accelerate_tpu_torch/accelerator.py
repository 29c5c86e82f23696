"""Accelerator — the counterpart of ``accelerate_tpu/accelerator.py``.

This slice ports the fused training path the JAX package's ``bench.py``
measures::

    accelerator = Accelerator(mixed_precision="bf16")
    model, optimizer = accelerator.prepare(model, optim.adamw(3e-4))
    step = accelerator.build_train_step(model, optimizer)
    loss = step({"input_ids": ids, "labels": ids}, clip_norm=1.0)

One call of ``step`` is one micro-step: forward and backward through the
model (whose causal attention is the flash kernel at flash shapes on the
card), the gradient added into the accumulation buffer at ``1/accum``
scale, and, on an accumulation boundary, the global-norm clip and the fused
optimizer update (one kernel launch per parameter leaf), which also zeroes
the buffer. It keeps the JAX step's math: ``accum + g / accum_steps``, the
norm as ``sqrt(Σ_leaves Σ g²)`` in f32 over leaves in sorted-key order, the
factor ``where(clip > 0 & gnorm > clip, clip / (gnorm + 1e-6), 1)``.

Where JAX compiles one program with donated buffers, the port runs eagerly
and updates the parameters, the moments and the buffer in place. The
``lax.cond`` on the update boundary becomes a host ``if`` on a host-side
micro-step count: the count advances deterministically, so the step never
reads the device. ``step`` returns the loss as a device tensor and never
calls ``.item()``.

Mixed precision ``bf16`` keeps f32 master parameters and casts them to bf16
*inside* the differentiated function, so the gradients land in f32, as in
JAX. Not ported yet: ``build_train_window``, the imperative
``backward()``/``optimizer.step()`` loop, the fp16 gradient scaler, ZeRO and
all sharding, remat, the fused loss, adafactor and schedules, and the
telemetry, audit and health hooks of the step.
"""

from __future__ import annotations

import numpy as np
import torch

from .modules import Module
from .ops.fused_update import fused_update_apply, reference_update_apply
from .ops.registry import resolve_spec
from .optim import GradientTransformation
from .optimizer import AcceleratedOptimizer
from .state import AcceleratorState, GradientState
from .utils.device import host_to_device
from .utils.transfer import place_batch
from .utils.tree import tree_leaves, tree_map, tree_unflatten


def global_norm(grads):
    """``sqrt(Σ_leaves Σ g²)`` in f32, leaves in sorted-key order (the JAX
    package's ``_global_norm``), as a device scalar."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


class TrainHandle:
    """Binds a prepared model to its optimizer: the module, the current
    (master) parameters, the compute dtype and the device."""

    def __init__(self, module, params, compute_dtype, device):
        self.module = module
        self.params = params
        self.compute_dtype = compute_dtype
        self.device = device


class PreparedModel:
    """What ``prepare`` hands back in a model's slot."""

    def __init__(self, handle: TrainHandle, accelerator: "Accelerator"):
        self.handle = handle
        self.accelerator = accelerator

    @property
    def params(self):
        return self.handle.params

    def training_loss_fn(self):
        """``loss_of(params, batch)``: the forward on the parameters cast to
        the compute dtype, with the accelerator's kernel spec, and the loss
        the model computes from the batch's labels. Differentiating it with
        respect to the master parameters gives gradients in their dtype."""
        module, cast = self.handle.module, self._cast
        kernels = self.accelerator.kernels

        def loss_of(params, batch):
            outputs = module.apply(cast(params), kernels=kernels, **batch)
            if "loss" not in outputs:
                raise ValueError("the model computed no loss: pass labels in the batch")
            return outputs["loss"]

        return loss_of

    def _cast(self, params):
        dtype = self.handle.compute_dtype
        if dtype == torch.float32:
            return params
        return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


class Accelerator:
    """One process on one device. ``kernels`` is the registry spec: None
    (the hand-written kernels for CUDA tensors) or ``"off"`` (their plain
    versions, the comparison arm of ``chip_smoke.py``). The accumulation
    steps are fixed at construction."""

    def __init__(self, mixed_precision: str | None = None, gradient_accumulation_steps: int = 1,
                 kernels: str | None = None, device=None):
        self.state = AcceleratorState(mixed_precision=mixed_precision, device=device)
        self.gradient_state = GradientState(gradient_accumulation_steps)
        self.kernels = resolve_spec(kernels)
        self._models: list[PreparedModel] = []

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    def _place_batch(self, batch):
        return place_batch(batch, self.device)

    # ---------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Models (a ``Module`` with parameters) become ``PreparedModel``s,
        optimizer transforms ``AcceleratedOptimizer``s bound to the last
        model. Order is preserved. Dataloaders and schedulers are not
        ported and raise."""
        out = []
        for obj in args:
            if isinstance(obj, Module):
                out.append(self.prepare_model(obj))
            elif isinstance(obj, GradientTransformation):
                out.append(self.prepare_optimizer(obj))
            else:
                raise NotImplementedError(
                    f"prepare() of {type(obj).__name__} is not ported yet (ROADMAP.md, module "
                    "queue: data loaders and schedulers)")
        for opt in (o for o in out if isinstance(o, AcceleratedOptimizer)):
            if self._models:
                opt.handle = self._models[-1].handle
        return out[0] if len(out) == 1 else tuple(out)

    def prepare_model(self, model):
        if model.params is None:
            raise ValueError("Model has no parameters: call model.init_params(seed) first.")
        dev = self.device
        params = tree_map(lambda p: p.detach().to(dev), model.params)
        model.params = params  # the user's handle sees the prepared parameters
        handle = TrainHandle(model, params, self.state.compute_dtype, dev)
        prepared = PreparedModel(handle, self)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, tx):
        prepared = AcceleratedOptimizer(tx)
        if self._models:
            prepared.handle = self._models[-1].handle
        return prepared

    # ------------------------------------------------------------ fused step
    def _fused_value_and_grads(self, model: PreparedModel):
        """``(params, batch) -> (loss, grads)``: the loss as a detached device
        scalar and the gradient of every parameter leaf, in the order of
        ``tree_leaves(params)``."""
        loss_of = model.training_loss_fn()

        def value_and_grads(params, batch):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            with torch.enable_grad():
                loss = loss_of(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), grads

        return value_and_grads

    def _fused_step_body(self, model: PreparedModel, optimizer: AcceleratedOptimizer,
                         accum: int):
        """``(params, opt_state, accum_grads, count, batch, clip_norm) ->
        (params, opt_state, accum_grads, count, loss)``: forward and
        backward, accumulation at ``1/accum`` scale, and on a boundary the
        clip and the update (the fused pass, or the reference chain for a
        transform the fused pass does not cover)."""
        tx, plan, kernels = optimizer.tx, optimizer.plan, self.kernels
        value_and_grads = self._fused_value_and_grads(model)
        dev = model.handle.device
        # Divisor and fallback factor as device scalars: a CPU scalar divisor
        # would become a multiply by its reciprocal, which is not g / accum.
        accum_t = torch.full((), float(accum), dtype=torch.float32, device=dev)
        one = torch.ones((), dtype=torch.float32, device=dev)

        def upd(params, opt_state, grads, clip_norm):
            gnorm = global_norm(grads)
            factor = torch.where((clip_norm > 0) & (gnorm > clip_norm),
                                 clip_norm / (gnorm + 1e-6), one)
            if plan is not None:
                opt_state = fused_update_apply(params, opt_state, grads, plan=plan,
                                               clip_factor=factor, kernels=kernels)
                return params, opt_state, grads
            return reference_update_apply(params, opt_state, grads, tx=tx, clip_factor=factor)

        def step_body(params, opt_state, accum_grads, count, batch, clip_norm):
            loss, grads = value_and_grads(params, batch)
            with torch.no_grad():
                for a, g in zip(tree_leaves(accum_grads), grads):
                    a.add_(g / accum_t)
                del grads
                count += 1
                if count % accum == 0:
                    params, opt_state, accum_grads = upd(params, opt_state, accum_grads, clip_norm)
            return params, opt_state, accum_grads, count, loss

        return step_body

    def build_train_step(self, model: PreparedModel, optimizer: AcceleratedOptimizer):
        """Returns ``step(batch, clip_norm=0.0) -> loss``, one micro-step on
        the shared handle state (see the module docstring). A build zeroes
        the accumulation buffer and starts its micro-step count at 0."""
        handle = model.handle
        optimizer._ensure_initialized()
        step_body = self._fused_step_body(model, optimizer, self.gradient_accumulation_steps)
        optimizer._accum_grads = tree_map(torch.zeros_like, handle.params)
        count = 0

        def step(batch, clip_norm: float = 0.0):
            nonlocal count
            clip = host_to_device(np.float32(clip_norm), handle.device)
            (handle.params, optimizer.opt_state, optimizer._accum_grads, count,
             loss) = step_body(handle.params, optimizer.opt_state, optimizer._accum_grads,
                               count, self._place_batch(batch), clip)
            return loss

        return step
