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
JAX. Not ported yet: ``build_train_window``, the fp16 gradient scaler, ZeRO
and the fsdp, tp, pp and ep axes, Ulysses, remat, adafactor, trackers and
checkpoints, and the telemetry, audit and health hooks of the step.

The canonical imperative loop (``examples/nlp_example.py``; the port's
``accelerate_tpu_torch/examples/nlp_example.py``)::

    accelerator = Accelerator(mixed_precision="bf16")
    model, optimizer, train_dl, eval_dl, scheduler = accelerator.prepare(
        model, optim.inject_hyperparams(optim.adamw)(learning_rate=2e-5), train_dl,
        eval_dl, optim.linear_schedule(2e-5, 2e-6, len(train_dl)))
    for batch in train_dl:
        with accelerator.accumulate(model):
            outputs = model(**batch)
            accelerator.backward(outputs["loss"])
            accelerator.clip_grad_norm_(model, 1.0)
            optimizer.step(); scheduler.step(); optimizer.zero_grad()
    model.eval()
    for batch in eval_dl:
        logits = model(**batch)["logits"]
        preds, refs = accelerator.gather_for_metrics((logits.argmax(-1), batch["labels"]))
    accelerator.end_training()

``prepare`` sorts its arguments as the JAX package does (``accelerator.py:
727-813``): models, optimizer transforms (bound to the model of the same call,
or the last one), torch ``DataLoader``s and other iterables
(``data_loader.prepare_data_loader``: each rank yields its shard on its
device) and schedules (``scheduler.AcceleratedScheduler``, bound after the
optimizers); a callable that is not a schedule raises ``TypeError``. A
prepared model called in train mode runs the forward under autograd on the
parameters cast to the compute dtype and keeps ``(loss, leaves)`` pending;
``backward(loss)`` takes ``torch.autograd.grad`` with respect to the f32
master leaves and banks it at ``1/accum`` (``AcceleratedOptimizer._accumulate``).
Over several ranks (a dp mesh) the banked gradients are averaged over the dp
ranks on each sync boundary, as DDP averages them (under ``accumulate``, DDP
skips the reduction of the other micro-steps with ``no_sync``). In eval mode
the forward runs under ``torch.no_grad()``. Under ``sp_size > 1`` the
imperative path raises: train with ``build_train_step``.

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

import contextlib
import dataclasses

import numpy as np
import torch
import torch.utils.data as tud

from .data_loader import DataLoaderShard, prepare_data_loader
from .modules import Module
from .ops.fused_update import fused_update_apply, reference_update_apply
from .ops.registry import resolve_spec
from .optim import GradientTransformation
from .optimizer import AcceleratedOptimizer, clip_factor, global_norm
from .parallel.mesh import ParallelismConfig
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils import operations as ops
from .utils.dataclasses import DataLoaderConfiguration, SequenceParallelPlugin
from .utils.device import host_to_device
from .utils.operations import broadcast, reduce
from .utils.transfer import place_batch, shard_batch
from .utils.tree import tree_leaves, tree_map, tree_unflatten

# The seed of a prepared model's dropout generator (the JAX package seeds its
# dropout key with ACCELERATE_SEED + 7919; the port reads no environment).
DROPOUT_SEED = 7919


class TrainHandle:
    """Binds a prepared model to its optimizer: the module, the current
    (master) parameters, the compute dtype, the device, the dropout
    generator, and the ``(loss, leaves)`` of a train-mode forward that
    ``backward`` has not consumed yet."""

    def __init__(self, module, params, compute_dtype, device):
        self.module = module
        self.params = params
        self.compute_dtype = compute_dtype
        self.device = device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(DROPOUT_SEED)
        self.pending = None
        self.last_grad_norm = None


def _loss_of(outputs):
    """The scalar loss of a forward's outputs (HF convention)."""
    if isinstance(outputs, dict) and "loss" in outputs:
        return outputs["loss"]
    if isinstance(outputs, torch.Tensor) and outputs.dim() == 0:
        return outputs
    raise ValueError("Could not extract a loss from the model outputs: pass labels in the "
                     "batch, so that the model returns an output with a `loss` field.")


class PreparedModel:
    """What ``prepare`` hands back in a model's slot: callable like the
    module (train mode by default; module docstring)."""

    def __init__(self, handle: TrainHandle, accelerator: "Accelerator"):
        self.handle = handle
        self.accelerator = accelerator
        self.training = True

    def train(self, mode: bool = True):
        self.training = mode
        return self

    def eval(self):
        return self.train(False)

    @property
    def module(self) -> Module:
        return self.handle.module

    @property
    def params(self):
        return self.handle.params

    def __call__(self, *args, **kwargs):
        acc, handle = self.accelerator, self.handle
        if acc.state.sp_size > 1:
            raise NotImplementedError(
                "the imperative forward/backward loop is not ported under sequence "
                "parallelism (sp_size > 1); train with accelerator.build_train_step(model, "
                "optimizer), which takes the global batch")
        args, kwargs = acc._place_inputs((args, kwargs))
        module, kernels = handle.module, acc.kernels
        if not self.training:
            with torch.no_grad():
                return module.apply(self._cast(handle.params), *args, train=False,
                                    kernels=kernels, **kwargs)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(handle.params)]
        with torch.enable_grad():
            outputs = module.apply(self._cast(tree_unflatten(handle.params, leaves)), *args,
                                   train=True, generator=handle.generator, kernels=kernels,
                                   **kwargs)
        handle.pending = (_loss_of(outputs), leaves)
        return outputs

    def forward(self, *args, **kwargs):
        return self(*args, **kwargs)

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
                             loss_normalizer=reduce(count, reduction="sum").clamp(min=1))
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


def _looks_like_schedule(obj) -> bool:
    """A callable with exactly one required positional argument (the step
    count), or only ``*args``; the JAX package's test."""
    import inspect

    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return True
    required = [p for p in sig.parameters.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    has_varargs = any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values())
    return len(required) == 1 or (len(required) == 0 and has_varargs)


def _has_object_leaves(data) -> bool:
    """True when ``data`` holds a leaf the tensor all-gather cannot carry:
    an object or string array, or anything but a tensor, a numeric array or
    a number."""
    if isinstance(data, (list, tuple)):
        return any(_has_object_leaves(v) for v in data)
    if isinstance(data, dict):
        return any(_has_object_leaves(v) for v in data.values())
    if isinstance(data, torch.Tensor):
        return False
    if isinstance(data, np.ndarray):
        return data.dtype == object or data.dtype.kind in "SU"
    return not isinstance(data, (int, float, complex, bool, np.number))


class Accelerator:
    """One process, one device, one rank of the job. ``kernels`` is the
    registry spec: None (the hand-written kernels for CUDA tensors) or
    ``"off"`` (their plain versions, the comparison arm of
    ``chip_smoke.py``). The accumulation steps are fixed at construction.
    ``cpu=True`` is the JAX package's spelling of ``device="cpu"``.
    ``sp_plugin`` or ``parallelism_config`` ask for a ``("dp", "sp")`` mesh
    over the job's ranks (module docstring); ``init_method`` is handed to
    ``init_process_group`` when this process starts the job.
    ``split_batches``, ``dataloader_config`` and ``rng_types`` shape the
    prepared loaders, ``step_scheduler_with_optimizer`` the schedulers, as
    in the JAX package."""

    def __init__(self, mixed_precision: str | None = None, gradient_accumulation_steps: int = 1,
                 kernels: str | None = None, device=None,
                 sp_plugin: SequenceParallelPlugin | None = None,
                 parallelism_config: ParallelismConfig | None = None,
                 init_method: str | None = None, *, cpu: bool = False,
                 split_batches: bool = False,
                 dataloader_config: DataLoaderConfiguration | None = None,
                 rng_types: list | None = None, step_scheduler_with_optimizer: bool = True):
        if cpu:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(f"cpu=True contradicts device={device!r}")
            device = "cpu"
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
        self.split_batches = split_batches
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self.rng_types = rng_types or ["generator"]
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.step = 0
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list = []

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

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def num_processes(self) -> int:
        return self.state.partial.num_processes

    @property
    def process_index(self) -> int:
        return self.state.partial.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.partial.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.partial.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.partial.is_local_main_process

    def print(self, *args, **kwargs):
        self.state.partial.print(*args, **kwargs)

    def wait_for_everyone(self):
        self.state.partial.wait_for_everyone()

    def _dp_group(self):
        """The process group a batch is split over: the mesh's dp axis, or
        the default group."""
        return None if self.mesh is None else self.mesh.get_group("dp")

    def _dp_size_index(self):
        mesh = self.mesh
        if mesh is None:
            return 1, 0
        return mesh["dp"].size(), mesh.get_coordinate()[0]

    def _place_batch(self, batch, module=None):
        mesh = self.mesh
        if mesh is None:
            return place_batch(batch, self.device)
        dp_index, sp_index = mesh.get_coordinate()
        return shard_batch(batch, self.device, dp_index=dp_index, dp_size=mesh["dp"].size(),
                           sp_index=sp_index, sp_size=mesh["sp"].size(),
                           shift_labels=module._shift_labels)

    def _place_inputs(self, data):
        """Numpy and CPU-tensor leaves of a forward's inputs on the device;
        this rank's inputs, never sharded."""
        return ops.recursively_apply(lambda x: place_batch(x, self.device), data)

    # ---------------------------------------------------------------- prepare
    def _classify(self, obj) -> str:
        if isinstance(obj, GradientTransformation):
            return "optimizer"
        if isinstance(obj, (PreparedModel, Module)):
            return "model"
        if isinstance(obj, torch.nn.Module):
            raise NotImplementedError(
                "prepare() of a torch.nn.Module is not ported: the port's models are "
                "accelerate_tpu_torch Modules with explicit parameters (models/)")
        if isinstance(obj, tud.DataLoader) or (hasattr(obj, "__iter__") and not callable(obj)):
            return "dataloader"
        if callable(obj):
            if _looks_like_schedule(obj):
                return "scheduler"
            raise TypeError(
                f"prepare() received a callable ({getattr(obj, '__name__', type(obj).__name__)}) "
                "that does not look like an LR schedule (a schedule takes a single integer "
                "step count, e.g. optim.linear_schedule(...)). Models must be "
                "accelerate_tpu_torch Modules.")
        return "other"

    def prepare(self, *args):
        """Each argument, in order: models become ``PreparedModel``s,
        optimizer transforms ``AcceleratedOptimizer``s (bound to this call's
        model, or the last one prepared), loaders ``DataLoaderShard``s and
        schedules ``AcceleratedScheduler``s (bound to this call's
        optimizers, or all prepared so far); anything else comes back as it
        is."""
        result, prepared_model, prepared_opts = [], None, []
        for obj in args:
            kind = self._classify(obj)
            if kind == "model":
                prepared = prepared_model = self.prepare_model(obj)
            elif kind == "optimizer":
                prepared = self._new_optimizer(obj)
                prepared_opts.append(prepared)
            elif kind == "dataloader":
                prepared = self.prepare_data_loader(obj)
            else:
                prepared = obj  # a schedule is bound after the optimizers exist
            result.append((kind, prepared))
        handle = prepared_model.handle if prepared_model is not None else (
            self._models[-1].handle if self._models else None)
        for opt in prepared_opts:
            opt.handle = handle
        final = []
        for kind, prepared in result:
            if kind == "scheduler":
                prepared = self._new_scheduler(prepared, prepared_opts or self._optimizers)
            final.append(prepared)
        return final[0] if len(final) == 1 else tuple(final)

    def prepare_model(self, model):
        if isinstance(model, PreparedModel):
            return model
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
        if getattr(cfg, "attention_impl", "auto") == "auto":
            cfg = dataclasses.replace(cfg, attention_impl="ring")
        if cfg.attention_impl != "ring":
            raise ValueError(
                f"under sp>1 each rank holds a sequence shard, so attention must be the ring; "
                f"got attention_impl={cfg.attention_impl!r} (use 'auto' or 'ring')")
        return cfg

    def _new_optimizer(self, tx):
        prepared = AcceleratedOptimizer(tx, gradient_state=self.gradient_state,
                                        kernels=self.kernels)
        self._optimizers.append(prepared)
        return prepared

    def prepare_optimizer(self, tx):
        prepared = self._new_optimizer(tx)
        if self._models:
            prepared.handle = self._models[-1].handle
        return prepared

    def _new_scheduler(self, schedule, optimizers):
        prepared = AcceleratedScheduler(
            schedule, list(optimizers), step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.dataloader_config.split_batches,
            gradient_state=self.gradient_state)
        self._schedulers.append(prepared)
        return prepared

    def prepare_scheduler(self, schedule):
        return self._new_scheduler(schedule, self._optimizers)

    def prepare_data_loader(self, data_loader):
        """This rank's shard of ``data_loader`` on this rank's device, split
        over the dp ranks (``data_loader.prepare_data_loader``)."""
        if self.state.sp_size > 1:
            raise NotImplementedError(
                "prepared loaders are not ported under sequence parallelism (sp_size > 1): "
                "build_train_step takes the global batch and shards it itself")
        if isinstance(data_loader, DataLoaderShard):
            self._dataloaders.append(data_loader)
            return data_loader
        cfg = self.dataloader_config
        num_processes, process_index = self._dp_size_index()
        prepared = prepare_data_loader(
            data_loader, device=self.device, num_processes=num_processes,
            process_index=process_index, split_batches=cfg.split_batches,
            rng_types=self.rng_types if isinstance(data_loader, tud.DataLoader) else None,
            dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            use_seedable_sampler=cfg.use_seedable_sampler, data_seed=cfg.data_seed,
            non_blocking=cfg.non_blocking, use_stateful_dataloader=cfg.use_stateful_dataloader,
            gradient_state=self.gradient_state)
        self._dataloaders.append(prepared)
        return prepared

    # ------------------------------------------------------- training facade
    def backward(self, loss):
        """The gradients of ``loss`` (from a train-mode forward of a
        prepared model) with respect to its f32 master parameters, banked
        into its optimizer at ``1/accum``; on a sync boundary of a dp mesh,
        the banked gradients averaged over the dp ranks (module docstring)."""
        model = self._find_model_for_loss(loss)
        if model is None or model.handle.pending is None:
            raise RuntimeError(
                "backward() found no gradients: call it with the loss from a train-mode "
                "forward of a prepared model (or use build_train_step for the fused path).")
        loss, leaves = model.handle.pending
        model.handle.pending = None
        opt = self._optimizer_for_handle(model.handle)
        if opt is None:
            raise RuntimeError("No prepared optimizer is bound to this model.")
        # A parameter the loss does not reach gets a zero gradient, as in JAX.
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        opt._accumulate(grads, scale=1.0 / self.gradient_accumulation_steps)
        if self.mesh is not None and self.sync_gradients:
            with torch.no_grad():
                for g in tree_leaves(opt.grads):
                    reduce(g, reduction="mean", group=self._dp_group())

    def _find_model_for_loss(self, loss):
        for m in self._models:
            if m.handle.pending is not None and m.handle.pending[0] is loss:
                return m
        pending = [m for m in self._models if m.handle.pending is not None]
        return pending[0] if len(pending) == 1 else None

    def _optimizer_for_handle(self, handle):
        for opt in self._optimizers:
            if opt.handle is handle:
                return opt
        return self._optimizers[-1] if self._optimizers else None

    def _do_sync(self):
        """Whether this micro-step ends an accumulation window (JAX
        ``accelerator.py:1008-1018``): the last batch of the loader always
        does."""
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients((self.step % gs.num_steps) == 0)

    @contextlib.contextmanager
    def accumulate(self, *models):
        self._do_sync()
        yield

    @contextlib.contextmanager
    def no_sync(self, model):
        """The gradients are averaged over the dp ranks only on sync
        boundaries already (``backward``), so this context has nothing to
        suppress."""
        yield

    def _optimizer_for_parameters(self, parameters):
        """The prepared optimizer that owns ``parameters`` (a
        ``PreparedModel``, its parameter tree, or None with one optimizer)."""
        if parameters is None:
            if len(self._optimizers) > 1:
                raise ValueError("Multiple optimizers are prepared; pass the model (or its "
                                 "params) whose gradients should be clipped.")
            return self._optimizers[-1] if self._optimizers else None
        handle = getattr(parameters, "handle", None)
        for opt in self._optimizers:
            if handle is not None and opt.handle is handle:
                return opt
            if opt.handle is not None and opt.handle.params is parameters:
                return opt
        ids = {id(leaf) for leaf in tree_leaves(parameters)} if isinstance(parameters, dict) \
            else set()
        for opt in self._optimizers:
            if opt.handle is not None and ids & {id(p) for p in tree_leaves(opt.handle.params)}:
                return opt
        raise ValueError("clip_grad_norm_ received parameters that do not belong to any "
                         "prepared optimizer; pass a model returned by prepare().")

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: int = 2):
        """Clip the pending update's gradients to ``max_norm`` (applied in
        ``optimizer.step()``); returns the global norm of the banked
        gradients before the clip, as a device scalar."""
        if norm_type != 2:
            raise NotImplementedError("only the L2 global norm is supported")
        opt = self._optimizer_for_parameters(parameters)
        if opt is None or opt.grads is None:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        opt._pending_clip_norm = float(max_norm)
        return global_norm(opt.grads)

    def clip_grad_value_(self, parameters, clip_value: float):
        opt = self._optimizer_for_parameters(parameters)
        if opt is None or opt.grads is None:
            return
        with torch.no_grad():
            for g in tree_leaves(opt.grads):
                g.clamp_(-clip_value, clip_value)

    # ------------------------------------------------------------ collectives
    def gather(self, tensor):
        """Every rank's ``tensor`` concatenated along dim 0 over the dp ranks."""
        return ops.gather(tensor, group=self._dp_group())

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, then, on the loader's last batch, the rows past
        the real global tail (``remainder``) dropped: the padding that kept
        the last batch's shape. Numpy leaves travel as tensors on the
        device; objects that are not numbers or arrays go through
        ``gather_object``."""
        if not use_gather_object and self.num_processes > 1:
            use_gather_object = _has_object_leaves(input_data)
        if use_gather_object:
            all_tensors = ops.gather_object(input_data, group=self._dp_group())
        else:
            as_tensor = ops.recursively_apply(
                lambda x: torch.as_tensor(x, device=self.device), input_data,
                test_type=lambda x: isinstance(x, np.ndarray))
            all_tensors = self.gather(as_tensor)
        if not self.gradient_state.end_of_dataloader:
            return all_tensors
        remainder = self.gradient_state.remainder
        if remainder is None or remainder <= 0:
            return all_tensors
        if use_gather_object:
            return all_tensors[:remainder]
        return ops.recursively_apply(lambda t: t[:remainder] if t.dim() > 0 else t, all_tensors,
                                     test_type=lambda x: isinstance(x, torch.Tensor))

    def reduce(self, tensor, reduction="sum", scale=1.0):
        """``utils.operations.reduce`` over the job's ranks (this method's
        default is the sum, as in the JAX package)."""
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim=0, pad_index=0, pad_first=False):
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                        pad_first=pad_first, group=self._dp_group())

    def unwrap_model(self, model):
        """The module behind a ``PreparedModel``."""
        return model.module if isinstance(model, PreparedModel) else model

    def end_training(self):
        """Waits for every rank (no trackers or pending checkpoint writes
        are ported yet)."""
        self.wait_for_everyone()


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
                    reduce(g, reduction="sum")
                return reduce(loss.detach(), reduction="sum"), grads
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

        def upd(params, opt_state, grads, clip_norm):
            factor = clip_factor(global_norm(grads), clip_norm)
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
