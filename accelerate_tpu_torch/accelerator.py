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
the fsdp, tp, pp and ep axes, Ulysses, remat, adafactor and schedules, and
the telemetry, audit and health hooks of the step.

Sequence parallelism, one process per rank (``torchrun`` on cards,
``launchers.debug_launcher`` over gloo on the CPU)::

    accelerator = Accelerator(mixed_precision="bf16",
                              sp_plugin=SequenceParallelPlugin(sp_size=N))
    model, optimizer = accelerator.prepare(Llama(cfg), optim.adamw(3e-4))
    step = accelerator.build_train_step(model, optimizer)
    loss = step({"input_ids": ids, "labels": ids})   # ids: the GLOBAL batch

The ranks form a ``("dp", "sp")`` mesh (``parallel/mesh.py``). ``prepare``
refuses what the JAX package refuses under sp > 1 (per-layer windows, logit
softcaps, a query scale, a sliding window), sets the model's
``attention_impl`` from ``"auto"`` to ``"ring"``, and gives every rank rank
0's parameters. Each step cuts this rank's shard out of the global batch
(``utils/transfer.shard_batch``: global positions, labels shifted on the
global sequence), divides the rank's loss sum by the valid-target count
summed over the mesh, and sums the gradients over the mesh before
accumulation, clip and the fused update, so every rank keeps identical
parameters; the step returns the global mean loss. With one process and no
``sp`` axis none of this runs: the step is the single-process one above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .modules import Module
from .ops.fused_update import fused_update_apply, reference_update_apply
from .ops.registry import resolve_spec
from .optim import GradientTransformation
from .optimizer import AcceleratedOptimizer
from .parallel.mesh import ParallelismConfig
from .state import AcceleratorState, GradientState
from .utils.dataclasses import SequenceParallelPlugin
from .utils.device import host_to_device
from .utils.operations import broadcast, reduce
from .utils.transfer import place_batch, shard_batch
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
        mesh = self.accelerator.mesh

        def loss_of(params, batch):
            if mesh is not None and "targets" in batch:
                count = (batch["targets"] != -100).sum()
                batch = dict(batch, sp_group=mesh.get_group("sp"),
                             loss_normalizer=reduce(count).clamp(min=1))
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
    """One process, one device, one rank of the job. ``kernels`` is the
    registry spec: None (the hand-written kernels for CUDA tensors) or
    ``"off"`` (their plain versions, the comparison arm of
    ``chip_smoke.py``). The accumulation steps are fixed at construction.
    ``sp_plugin`` or ``parallelism_config`` ask for a ``("dp", "sp")`` mesh
    over the job's ranks (module docstring); ``init_method`` is handed to
    ``init_process_group`` when this process starts the job."""

    def __init__(self, mixed_precision: str | None = None, gradient_accumulation_steps: int = 1,
                 kernels: str | None = None, device=None,
                 sp_plugin: SequenceParallelPlugin | None = None,
                 parallelism_config: ParallelismConfig | None = None,
                 init_method: str | None = None):
        cfg = parallelism_config or ParallelismConfig()
        if sp_plugin is not None:
            if not sp_plugin.ring_attention:
                raise NotImplementedError(
                    "SequenceParallelPlugin(ring_attention=False) asks for Ulysses sequence "
                    "parallelism, which is not ported yet (ROADMAP.md, module queue)")
            cfg = dataclasses.replace(cfg, sp_size=sp_plugin.sp_size)
        self.state = AcceleratorState(mixed_precision=mixed_precision, device=device,
                                      parallelism_config=cfg, init_method=init_method)
        self.gradient_state = GradientState(gradient_accumulation_steps)
        self.kernels = resolve_spec(kernels)
        self._models: list[PreparedModel] = []

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The ``("dp", "sp")`` ``DeviceMesh``, or None for one process
        without sequence parallelism."""
        return self.state.mesh

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    def _place_batch(self, batch, module=None):
        mesh = self.mesh
        if mesh is None:
            return place_batch(batch, self.device)
        dp_index, sp_index = mesh.get_coordinate()
        return shard_batch(batch, self.device, dp_index=dp_index, dp_size=mesh["dp"].size(),
                           sp_index=sp_index, sp_size=mesh["sp"].size(),
                           shift_labels=module._shift_labels)

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
        if self.state.sp_size > 1:
            model.config = self._sequence_parallel_config(model.config)
        dev = self.device
        params = tree_map(lambda p: p.detach().to(dev), model.params)
        if self.mesh is not None:  # every rank starts from rank 0's parameters
            for leaf in tree_leaves(params):
                broadcast(leaf, src=0)
        model.params = params  # the user's handle sees the prepared parameters
        handle = TrainHandle(model, params, self.state.compute_dtype, dev)
        prepared = PreparedModel(handle, self)
        self._models.append(prepared)
        return prepared

    def _sequence_parallel_config(self, cfg):
        """The model's config under sp > 1: the JAX package's prepare-time
        refusals (``accelerator.py:850-879``), then ``attention_impl``
        ``"auto"`` becomes ``"ring"``. A new config object: one shared with
        another model must not change under it. The port's ranks hold only
        their shard, so any impl other than the ring raises."""
        lw = getattr(cfg, "layer_windows", None)
        if lw is not None and any(w is not None for w in lw):
            raise ValueError(
                "Sequence parallelism (sp>1) does not support per-layer windowed attention "
                "(layer_windows); train with sp=1.")
        if (getattr(cfg, "attn_logit_softcap", None) is not None
                or getattr(cfg, "query_pre_attn_scalar", None) is not None):
            raise ValueError(
                "Sequence parallelism (sp>1) does not support attention softcapping / "
                "query_pre_attn_scalar (Gemma-2); train with sp=1.")
        if getattr(cfg, "sliding_window", None):
            raise ValueError(
                "Sequence parallelism (sp>1) does not support sliding-window attention "
                f"(sliding_window={cfg.sliding_window}); train with sp=1, or clear "
                "config.sliding_window to use full attention.")
        if cfg.attention_impl == "auto":
            cfg = dataclasses.replace(cfg, attention_impl="ring")
        if cfg.attention_impl != "ring":
            raise ValueError(
                f"under sp>1 each rank holds a sequence shard, so attention must be the ring; "
                f"got attention_impl={cfg.attention_impl!r} (use 'auto' or 'ring')")
        return cfg

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
        summed = self.mesh is not None

        def value_and_grads(params, batch):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            with torch.enable_grad():
                loss = loss_of(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
            if summed:  # each rank's loss is its share of the global mean
                for g in grads:
                    reduce(g)
                return reduce(loss.detach()), grads
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
                               count, self._place_batch(batch, handle.module), clip)
            return loss

        return step
