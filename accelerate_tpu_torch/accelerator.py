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
JAX. ``fp16`` does the same in fp16 with the dynamic loss scaler
(``optimizer.GradScalerState``, JAX ``accelerator.py:444``): the loss is
multiplied by the scale before the backward, in the fused step and in the
imperative ``backward`` (JAX ``accelerator.py:252-303``), and the update
unscales, clips and skips a non-finite step (``optimizer.py``'s module
docstring). The fused step reads the finite flag once at each update
boundary, to launch no update kernel on a skipped step; the JAX package's
fused step carries no scaler. ``fp8`` computes in bf16 and ``prepare``
swaps the model's ``matmul_precision`` from ``"default"`` to ``"int8"``
(``fp8_backend`` ``"INT8"``, JAX ``accelerator.py:634-643, 835-846``), so
the block projections run the int8 matmul with the straight-through
backward. ``FullyShardedDataParallelPlugin(cpu_offload=True)`` (or
``ACCELERATE_FSDP_CPU_OFFLOAD``) keeps the imperative optimizer's state in
pinned host memory between steps.

``build_train_window(model, optimizer, window=K)`` returns
``step_window(batch) -> losses``: K fused steps over a batch whose every
leaf carries a leading K axis (``DeviceBatchPrefetcher(..., window=K)``
stacks them on the device), the K losses as one device tensor, bitwise K
calls of ``build_train_step`` (accumulation included). PyTorch has no
compiled scan: the window is a host loop over the step, with no read of
the device inside it (except the fp16 finite flag). Not ported yet: the ep
axis, and the telemetry, audit and health hooks of the step.

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
the forward runs under ``torch.no_grad()``. Under ``sp_size > 1`` a rank's
batch is its dp rows whole (a prepared loader's); the model call cuts the
rank's sequence shard, divides its loss by the valid targets over the sp
group, and gathers the logits back into sequence order; ``backward`` sums
the gradients over sp and averages them over dp.

Checkpoints and trackers (``checkpointing.py``, ``tracking.py``; the JAX
package's ``accelerator.py:1766-1935``)::

    accelerator = Accelerator(log_with="json", project_config=ProjectConfiguration(
        project_dir=out, automatic_checkpoint_naming=True, total_limit=2))
    accelerator.init_trackers("run", config)
    ...
    accelerator.save_state()              # checkpoints/checkpoint_<i>
    accelerator.load_state()              # the newest complete one, in place
    accelerator.log({"train_loss": loss}, step=step)
    accelerator.save_model(model, export_dir, max_shard_size="200MB")
    accelerator.end_training()            # finishes trackers, joins saves

``save_state`` and ``load_state`` serve both training paths: each reads and
writes the handle's parameters and the optimizer's state in place, which
``build_train_step`` and ``optimizer.step()`` share; the dropout generator
of each prepared model travels in ``random_states_<rank>.pkl``.

Sequence parallelism, one process per rank (``accelerate-tpu-torch launch``
on cards, ``launchers.debug_launcher`` over gloo on the CPU)::

    accelerator = Accelerator(mixed_precision="bf16",
                              sp_plugin=SequenceParallelPlugin(sp_size=N))
    model, optimizer = accelerator.prepare(Llama(cfg), optim.adamw(3e-4))
    step = accelerator.build_train_step(model, optimizer)
    loss = step({"input_ids": ids, "labels": ids})   # ids: the GLOBAL batch

The ranks form a ``("dp", "fsdp", "sp", "tp")`` mesh
(``parallel/mesh.py``). ``prepare`` refuses what the JAX package refuses
under sp > 1 (per-layer windows, logit softcaps, a query scale, a sliding
window), sets the model's ``attention_impl`` from ``"auto"`` to ``"ring"``
(``"ulysses"`` under ``SequenceParallelPlugin(ring_attention=False)``),
and gives every rank rank 0's parameters. Each step cuts this rank's shard out of the global batch
(``utils/transfer.shard_batch``: global positions, labels shifted on the
global sequence), divides the rank's loss sum by the valid-target count
summed over the mesh, and sums the gradients over the mesh before
accumulation, clip and the fused update, so every rank keeps identical
parameters; the step returns the global mean loss. With one process and no
``sp`` axis none of this runs: the step is the single-process one above.

Sharded training, one process per rank (``accelerate-tpu-torch launch
--num_processes 4`` on cards), or all ranks on one device with
``loopback=LoopbackShards(n)``::

    accelerator = Accelerator(mixed_precision="bf16", fsdp_plugin=
        FullyShardedDataParallelPlugin(fsdp_size=4, activation_checkpointing=True))
    accelerator.zero_sharding = True           # ZeRO over dp (ACCELERATE_ZERO_SHARDING)
    model, optimizer = accelerator.prepare(Llama(cfg), optim.adamw(3e-4))
    step = accelerator.build_train_step(model, optimizer)
    loss = step({"input_ids": ids, "labels": ids}, clip_norm=1.0)  # the GLOBAL batch

With an fsdp axis, ZeRO over a dp axis, or a loopback, ``prepare`` plans
each leaf's layout as the JAX package does (``parallel/sharding.py``, with
the model's ``sharding_rules`` and ``min_shard_size``), hands every rank rank
0's parameters and keeps only this rank's shards (``parallel/fsdp.py``):
``model.params`` is then this rank's tree of shards. Each step cuts this
rank's rows out of the global batch (rows split over dp x fsdp), gathers each
layer just before the model uses it, reduce-scatters its gradient into the
owning shard of the accumulation buffer, and runs the clip and the fused
update on the shards (on 1/dp of each under ZeRO, with the new parameters
all-gathered back). The imperative ``backward`` / ``optimizer.step()`` loop
runs on the same shards (one process per rank).

Tensor parallelism (``ParallelismConfig(tp_size=)``, ``tp_plugin=
TensorParallelPlugin(...)``, ``megatron_plugin=MegatronStylePlugin(...)``
or ``ACCELERATE_MESH_SHAPE=dp:2,tp:2``) always runs on shards: the
model's rules (Llama's, GPT-2's, GPTX's) split the heads, the MLP's
columns and the vocab over tp, each layer is gathered over fsdp only, and
the model runs Megatron's split on its tp pieces (``parallel/tensor.py``;
any model of ``SHARD_PROTOCOL``); the tp and sp ranks of one data coordinate
read the same rows, and the gradients are summed over dp, fsdp and sp,
never over tp. Under fp16 the sharded fused step scales the loss, unscales
each rank's shards and skips the update on every rank when the norm is not
finite anywhere.

Pipeline parallelism (``pp_plugin=PipelineParallelPlugin(pp_size=,
num_microbatches=, schedule=)``, ``ParallelismConfig(pp_size=)``,
``MegatronStylePlugin(pp_size=)``, or ``ACCELERATE_MESH_SHAPE=pp:2,...``
with ``ACCELERATE_PP_SCHEDULE`` and ``ACCELERATE_PP_MICROBATCHES``) also
runs on shards: each pp rank holds its stage's block of layers and
``prepare`` resolves the schedule (``parallel/pipeline.resolve_pipeline_
spec``, on the model's ``handle.pipeline_spec``; None, with JAX's warning,
when pp does not divide the layers, and the step then runs unpipelined on
every pp rank). The fused step and the window route as JAX's
``_fused_value_and_grads``: GPipe through ``model.apply(..., pipeline=
spec)``, 1F1B through ``parallel/pipeline.train_1f1b``. The imperative
loop (``backward`` / ``optimizer.step()``) under pp is not ported yet and
raises.

Expert parallelism (``ParallelismConfig(ep_size=)`` or
``ACCELERATE_MESH_SHAPE=ep:N``, alone or with dp, fsdp and tp; a
``MoELlama``, ``models/moe.py``) runs on shards too: the expert stacks
split over ep on their expert dim, the ep ranks of one data coordinate
read the same rows, every rank routes every token and runs its own
experts, and the layer's partial outputs meet in one all-reduce over the
expert group (``ops/moe.py``); gradients are never summed over ep. With
the rows split over data ranks, the router loss's top-1 fractions are
those of the global batch (``ops/moe.py``: an all-reduce a layer on a
process group; in the loopback, a first forward of every data
coordinate without autograd records them). ep with pp or with sp raises.

The process controls of the JAX package (``accelerator.py:671-689, 1033-1052,
1751-1762``) delegate to the state (``state.ProcessView``):
``split_between_processes``, ``main_process_first``,
``local_main_process_first`` and the ``on_*`` decorators; ``set_trigger`` /
``check_trigger`` sum a flag over the job's ranks; ``join_uneven_inputs`` is
a no-op (the prepared loaders even the ranks' tails); ``autocast(handler)``
sets the dtype policy of the models prepared inside it. A process started by
``accelerate-tpu-torch launch`` reads the launch contract: a bare
``Accelerator()`` takes its precision, device and accumulation from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os

import numpy as np
import torch
import torch.utils.data as tud

from .data_loader import DataLoaderShard, prepare_data_loader, skip_first_batches
from .modules import Module
from .ops.fused_update import fused_update_apply, reference_update_apply
from .ops.moe import DataRouterStats, RecordedRouterStats
from .ops.registry import resolve_spec
from .optim import GradientTransformation
from .optimizer import AcceleratedOptimizer, GradScalerState, clip_factor, global_norm
from .parallel.fsdp import LoopbackShards, ShardedModel
from .parallel.mesh import ParallelismConfig, mesh_coordinate
from .parallel.pipeline import (LoopbackStages, ProcessGroupStages, check_microbatch_grid,
                                resolve_pipeline_spec, train_1f1b)
from .parallel.ring import LoopbackRing
from .parallel.sharding import data_parallel_degree, plan_param_shardings
from .parallel.ulysses import LoopbackUlysses
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils import operations as ops
from .utils.constants import (
    ENV_CHECKPOINT_AUTO_NAMING,
    ENV_CHECKPOINT_TOTAL_LIMIT,
    ENV_FSDP_CPU_OFFLOAD,
    ENV_FSDP_MIN_SHARD_SIZE,
    ENV_GRADIENT_ACCUMULATION_STEPS,
    ENV_LOG_WITH,
    ENV_PP_MICROBATCHES,
    ENV_PP_SCHEDULE,
    ENV_PROJECT_DIR,
    ENV_TRAIN_WINDOW,
    ENV_ZERO_SHARDING,
)
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    Fp8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    KwargsHandler,
    MegatronStylePlugin,
    PipelineParallelPlugin,
    ProjectConfiguration,
    SequenceParallelPlugin,
    TensorParallelPlugin,
)
from .utils.device import host_to_device
from .utils.environment import parse_flag_from_env
from .utils.operations import all_gather_along, broadcast, reduce
from .utils.transfer import place_batch, shard_batch, split_rows
from .utils.tree import tree_leaves, tree_map, tree_unflatten

# The seed of a prepared model's dropout generator (the JAX package seeds its
# dropout key with ACCELERATE_SEED + 7919; no environment variable sets it).
DROPOUT_SEED = 7919


# What the shard engine needs of a model (``Accelerator._shard``): the stage
# protocol, the layer loop that reads a stacked leaf one index at a time
# (``parallel/fsdp._StackedLeaf``), and the tp hooks that run a block on the
# pieces of a leaf split over tp.
SHARD_PROTOCOL = ("embed", "block", "head", "run_layers", "_tp_attention", "_tp_mlp",
                  "sharding_rules")

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
        self.sharded: ShardedModel | None = None  # the shards, under fsdp, ZeRO or a loopback
        self.pipeline_spec = None  # parallel/pipeline.PipelineSpec under pp


def _is_causal_lm(module) -> bool:
    """Whether ``module`` trains on a token stream, as the port's causal LMs
    do (they carry the ``_shift_labels`` that ``shard_batch`` needs): under a
    mesh its batch is sharded with shifted labels and each rank's loss is its
    share of the global mean, summed over the ranks. Any other model's rows
    split over the data ranks and its gradients average."""
    return hasattr(module, "_shift_labels")


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
        args, kwargs = acc._place_inputs((args, kwargs))
        module, kernels = handle.module, acc.kernels
        if handle.sharded is not None:
            return self._sharded_call(args, kwargs)
        if acc.state.sp_size > 1:
            return self._sequence_parallel_call(args, kwargs)
        stats = acc._router_stats(module, share=False) if acc.mesh is not None else None
        if stats is not None:
            kwargs = dict(kwargs, router_stats=stats)
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

    def _sequence_parallel_call(self, args, kwargs):
        """The forward under sp: the batch holds this rank's dp rows whole
        (a prepared loader's); the rank runs its sequence shard
        (:meth:`_sequence_shard`) and the output reads as the rows'
        (:meth:`_sequence_gathered`). ``backward`` sums the gradients over
        sp and averages them over dp."""
        acc, handle = self.accelerator, self.handle
        mesh = acc.mesh
        sp_group = mesh.get_group("sp")
        run = dict(kernels=acc.kernels, sp_group=sp_group, **self._sequence_shard(
            args, kwargs, mesh_coordinate(mesh)["sp"], mesh["sp"].size(), sp_group))
        if not self.training:
            with torch.no_grad():
                out = handle.module.apply(self._cast(handle.params), train=False, **run)
            return self._sequence_gathered(out, sp_group)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(handle.params)]
        with torch.enable_grad():
            out = handle.module.apply(self._cast(tree_unflatten(handle.params, leaves)),
                                      train=True, generator=handle.generator, **run)
        out = self._sequence_gathered(out, sp_group)
        handle.pending = (_loss_of(out), leaves)
        return out

    def _sharded_call(self, args, kwargs):
        """The forward on this rank's shards, the layers gathered as the
        model reads them; in train mode the backward's gradients go to the
        optimizer's buffer, averaged over the data ranks (``backward``).
        Under sp the rank runs its sequence shard as
        :meth:`_sequence_parallel_call` does (the engine sums the gradients
        over sp)."""
        acc, handle = self.accelerator, self.handle
        engine = handle.sharded
        if engine.sizes["pp"] > 1:
            raise NotImplementedError(
                "the imperative loop (model(...), backward, optimizer.step()) under pp is not "
                "ported yet (ROADMAP.md, Queue 1: the imperative loop under pp); train with "
                "build_train_step or build_train_window")
        if engine.loopback:
            raise NotImplementedError("the imperative loop runs one rank a process; a "
                                      "LoopbackShards accelerator trains with build_train_step")
        opt = acc._optimizer_for_handle(handle)
        if opt is None:
            raise RuntimeError("No prepared optimizer is bound to this model.")
        rank = engine.ranks[0]
        unit = engine.unit_context(rank)
        sp_group = unit["sp_group"] if engine.sizes["sp"] > 1 else None
        if sp_group is not None:
            kwargs = self._sequence_shard(args, kwargs, engine.coord(rank)["sp"],
                                          engine.sizes["sp"], sp_group)
        stats = acc._router_stats(handle.module, share=False)
        if stats is not None:
            kwargs = dict(kwargs, router_stats=stats)
        if not self.training:
            aliases, anchor = engine.begin(None)
            with torch.no_grad():
                out = handle.module.apply(engine.rank_tree(rank, aliases, anchor), *args,
                                          train=False, kernels=acc.kernels, **unit, **kwargs)
            engine._sink = engine._bank = None
            return self._sequence_gathered(out, sp_group)
        aliases, anchor = engine.begin(opt._sharded_sink(acc.gradient_accumulation_steps),
                                       n_data_ranks=acc.num_data_ranks)
        with torch.enable_grad(), engine.hooks():
            outputs = handle.module.apply(engine.rank_tree(rank, aliases, anchor), *args,
                                          train=True, generator=handle.generator,
                                          kernels=acc.kernels, **unit, **kwargs)
        outputs = self._sequence_gathered(outputs, sp_group)
        handle.pending = (_loss_of(outputs), ("sharded", aliases))
        return outputs

    def _sequence_shard(self, args, kwargs, sp_index, sp_size, sp_group):
        """The model's keyword arguments for this rank's sequence shard of
        its dp rows (``utils/transfer.shard_batch``: global positions,
        labels shifted on the global sequence), the loss divided by the
        valid-target count over the sp group."""
        if args:
            raise TypeError("under sequence parallelism the model takes keyword arguments "
                            "(input_ids, labels, attention_mask)")
        acc = self.accelerator
        shard = shard_batch(kwargs, acc.device, dp_index=0, dp_size=1, sp_index=sp_index,
                            sp_size=sp_size, shift_labels=self.handle.module._shift_labels)
        if "targets" in shard:
            count = (shard["targets"] != -100).sum()
            shard["loss_normalizer"] = reduce(count, reduction="sum",
                                              group=sp_group).clamp(min=1)
        return shard

    def _sequence_gathered(self, out, sp_group):
        """``out`` of a sequence shard as the whole rows': the logits
        gathered over sp into sequence order; the loss reads as the sp
        ranks' shares summed (the rows' mean) while its gradient stays the
        rank's share."""
        if sp_group is None:
            return out
        if "logits" in out:
            out["logits"] = all_gather_along(out["logits"].detach(), 1, sp_group)
        if "loss" in out:
            share = out["loss"]
            total = reduce(share.detach().clone(), reduction="sum", group=sp_group)
            out["loss"] = share + (total - share).detach() if self.training else total
        return out

    def training_loss_fn(self, loss_fn=None):
        """``loss_of(params, batch)``: the forward on the parameters cast to
        the compute dtype, with the accelerator's kernel spec, and the loss:
        ``loss_fn(outputs, batch)`` when given (JAX ``training_loss_fn(
        extract)``), else the one the model computes from the batch's
        labels. Differentiating it with respect to the master parameters
        gives gradients in their dtype."""
        module, cast = self.handle.module, self._cast
        kernels = self.accelerator.kernels
        mesh = self.accelerator.mesh
        spec = self.handle.pipeline_spec
        if spec is not None and spec.schedule == "1f1b":
            # JAX accelerator.py:183-191: a custom value-and-grad cannot
            # honour the 1F1B schedule.
            raise ValueError(
                "schedule='1f1b' trains through build_train_step or the "
                "imperative prepared-model forward only; use "
                "PipelineParallelPlugin(schedule='gpipe') with this training path.")

        stats = self.accelerator._router_stats(module, share=True) if mesh is not None else None

        def loss_of(params, batch):
            if mesh is not None and "targets" in batch:
                count = (batch["targets"] != -100).sum()
                batch = dict(batch, sp_group=mesh.get_group("sp"),
                             loss_normalizer=reduce(count, reduction="sum").clamp(min=1))
                if stats is not None:
                    batch["router_stats"] = stats
            outputs = module.apply(cast(params), kernels=kernels, **batch)
            if loss_fn is not None:
                return loss_fn(outputs, batch)
            if "loss" not in outputs:
                raise ValueError("the model computed no loss: pass labels in the batch, or "
                                 "give build_train_step a loss_fn(outputs, batch)")
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
    ``chip_smoke.py``). The accumulation steps are fixed at construction (only
    ``load_state(reshard=True)`` rescales them, to keep the global batch).
    ``cpu=True`` is the JAX package's spelling of ``device="cpu"``.
    ``sp_plugin``, ``fsdp_plugin``, ``tp_plugin``, ``megatron_plugin``,
    ``pp_plugin`` or ``parallelism_config`` ask for a ``("pp", "dp",
    "fsdp", "sp", "tp")`` mesh over the job's ranks, or, with
    ``loopback=LoopbackShards(n)``, over n ranks held in this process
    (module docstring); ``init_method`` is handed to ``init_process_group``
    when this process starts the job.
    ``split_batches``, ``dataloader_config`` and ``rng_types`` shape the
    prepared loaders, ``step_scheduler_with_optimizer`` the schedulers, as
    in the JAX package. ``project_config`` (or ``project_dir``) places the
    checkpoints and tracker logs; without either, ``ACCELERATE_PROJECT_DIR``
    with ``ACCELERATE_CHECKPOINT_AUTO_NAMING`` and
    ``ACCELERATE_CHECKPOINT_TOTAL_LIMIT`` do. ``log_with`` names the
    trackers (``ACCELERATE_LOG_WITH``, comma-separated, when not given).
    ``gradient_accumulation_steps`` (None: ``ACCELERATE_GRADIENT_ACCUMULATION_
    STEPS``, else 1) or a ``GradientAccumulationPlugin``, not both;
    ``kwargs_handlers`` take ``Fp8RecipeKwargs`` and ``AutocastKwargs``."""

    def __init__(self, mixed_precision: str | None = None,
                 gradient_accumulation_steps: int | None = None,
                 kernels: str | None = None, device=None,
                 sp_plugin: SequenceParallelPlugin | None = None,
                 parallelism_config: ParallelismConfig | None = None,
                 init_method: str | None = None, *, cpu: bool = False,
                 split_batches: bool = False,
                 dataloader_config: DataLoaderConfiguration | None = None,
                 rng_types: list | None = None, step_scheduler_with_optimizer: bool = True,
                 log_with=None, project_dir: str | os.PathLike | None = None,
                 project_config: ProjectConfiguration | None = None,
                 fsdp_plugin: FullyShardedDataParallelPlugin | None = None,
                 loopback: LoopbackShards | None = None,
                 kwargs_handlers: list | None = None,
                 tp_plugin: TensorParallelPlugin | None = None,
                 megatron_plugin: MegatronStylePlugin | None = None,
                 pp_plugin: PipelineParallelPlugin | None = None,
                 gradient_accumulation_plugin: GradientAccumulationPlugin | None = None):
        if cpu:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(f"cpu=True contradicts device={device!r}")
            device = "cpu"
        cfg = parallelism_config or self._resolve_parallelism(tp_plugin, megatron_plugin)
        if fsdp_plugin is None and (os.environ.get(ENV_FSDP_MIN_SHARD_SIZE)
                                    or os.environ.get(ENV_FSDP_CPU_OFFLOAD)):
            # JAX accelerator.py:361-373: the per-feature options from the env.
            # The fsdp axis takes every rank the other axes leave (JAX sizes
            # it from ACCELERATE_MESH_SHAPE's fsdp entry instead).
            fsdp_plugin = FullyShardedDataParallelPlugin(
                fsdp_size=-1,
                min_shard_size=int(os.environ.get(ENV_FSDP_MIN_SHARD_SIZE, 2**14)),
                cpu_offload=parse_flag_from_env(ENV_FSDP_CPU_OFFLOAD))
        if pp_plugin is None and os.environ.get(ENV_PP_SCHEDULE):
            # JAX accelerator.py:374-379: the pp size comes from the mesh shape.
            pp_plugin = PipelineParallelPlugin(pp_size=max(cfg.pp_size, 1),
                                               schedule=os.environ[ENV_PP_SCHEDULE])
        if pp_plugin is not None:
            cfg = dataclasses.replace(cfg, pp_size=pp_plugin.pp_size)
        self.pp_plugin = pp_plugin
        self.fp8_recipe_handler = None
        self.autocast_handler = None
        seen = set()
        for handler in kwargs_handlers or []:
            if not isinstance(handler, KwargsHandler):
                raise TypeError(f"Unsupported kwargs handler passed: {handler}, must be one "
                                "that inherits `accelerate_tpu_torch.utils.dataclasses."
                                "KwargsHandler`.")
            if type(handler) in seen:
                raise ValueError(f"You can only pass one {type(handler).__name__} in "
                                 "`kwargs_handlers`.")
            seen.add(type(handler))
            if isinstance(handler, Fp8RecipeKwargs):
                self.fp8_recipe_handler = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
        self.sp_plugin = sp_plugin
        if sp_plugin is not None:
            cfg = dataclasses.replace(cfg, sp_size=sp_plugin.sp_size)
        if fsdp_plugin is not None:  # -1: full-shard over the ranks left over
            cfg = dataclasses.replace(
                cfg, fsdp_size=fsdp_plugin.fsdp_size if fsdp_plugin.fsdp_size > 0 else -1)
        self.fsdp_plugin = fsdp_plugin
        self.loopback = loopback
        self._zero_sharding = None
        if loopback is not None:
            cfg.resolved_sizes(loopback.size)  # the loopback must hold the mesh
        self.state = AcceleratorState(mixed_precision=mixed_precision, device=device,
                                      parallelism_config=cfg, init_method=init_method,
                                      loopback=loopback is not None)
        if loopback is not None and self.state.partial.distributed:
            raise ValueError("a LoopbackShards accelerator holds every rank in one process; "
                             "this process is one rank of a process group")
        sizes = self.mesh_sizes
        if sizes["fsdp"] > 1 and sizes["sp"] > 1:
            raise NotImplementedError("fsdp together with sp is not ported yet (ROADMAP.md, "
                                      "module queue)")
        if sizes["pp"] > 1 and sizes["sp"] > 1:
            raise NotImplementedError("pp together with sp is not ported yet (ROADMAP.md, "
                                      "Queue 1: pp with sp and with ep)")
        if sizes["ep"] > 1 and sizes["pp"] > 1:
            raise NotImplementedError("ep together with pp is not ported (the JAX package "
                                      "tests MoE under pp only without ep; ROADMAP.md, "
                                      "Queue 1: pp with sp and with ep)")
        if sizes["ep"] > 1 and sizes["sp"] > 1:
            raise NotImplementedError("ep together with sp is not ported (ROADMAP.md, "
                                      "Queue 1 item 5)")
        if gradient_accumulation_plugin is None:
            # JAX accelerator.py:422-436: the environment is a default, not an
            # override; any value passed (1 too) wins over the launcher's.
            steps = gradient_accumulation_steps
            if steps is None:
                steps = int(os.environ.get(ENV_GRADIENT_ACCUMULATION_STEPS, 1))
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=steps)
        elif gradient_accumulation_steps is not None and gradient_accumulation_steps > 1:
            raise ValueError(
                "You can only pass one of `gradient_accumulation_steps` and "
                "`gradient_accumulation_plugin`. Please only pass in the created "
                "`GradientAccumulationPlugin` object.")
        self.gradient_accumulation_plugin = gradient_accumulation_plugin
        self.gradient_state = GradientState(
            gradient_accumulation_plugin.num_steps or 1,
            sync_with_dataloader=gradient_accumulation_plugin.sync_with_dataloader)
        self.flag_tensor = None  # set_trigger's flag, cleared when check_trigger fires
        self.scaler = GradScalerState() if self.state.mixed_precision == "fp16" else None
        # cpu_offload: the imperative optimizer's state parks in pinned host
        # memory between steps; the fused step keeps it on the device.
        self._offload_opt_state = bool(fsdp_plugin.cpu_offload) if fsdp_plugin else False
        self._train_window = None  # lazy: ACCELERATE_TRAIN_WINDOW, then 1
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
        self._custom_objects: list = []
        if project_config is None and project_dir is None:
            env_dir = os.environ.get(ENV_PROJECT_DIR)
            if env_dir:
                limit = os.environ.get(ENV_CHECKPOINT_TOTAL_LIMIT)
                project_config = ProjectConfiguration(
                    project_dir=env_dir,
                    automatic_checkpoint_naming=parse_flag_from_env(
                        ENV_CHECKPOINT_AUTO_NAMING),
                    total_limit=int(limit) if limit else None)
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        if log_with is None and os.environ.get(ENV_LOG_WITH):
            log_with = [t.strip() for t in os.environ[ENV_LOG_WITH].split(",")
                        if t.strip()]
        from .tracking import filter_trackers

        self.log_with = filter_trackers(log_with, self.logging_dir) if log_with is not None \
            else []
        self.trackers = []

    @staticmethod
    def _resolve_parallelism(tp_plugin, megatron_plugin) -> ParallelismConfig:
        """The mesh without a ``parallelism_config`` (JAX ``accelerator.py:
        478-497``): a ``MegatronStylePlugin``'s sizes, else
        ``ACCELERATE_MESH_SHAPE`` with the tp plugin's size over it (the sp
        and fsdp plugins are laid over either afterwards)."""
        if megatron_plugin is not None:
            return ParallelismConfig(fsdp_size=megatron_plugin.fsdp_size,
                                     tp_size=megatron_plugin.tp_size,
                                     pp_size=megatron_plugin.pp_size,
                                     sp_size=megatron_plugin.sp_size)
        cfg = ParallelismConfig.from_env()
        if tp_plugin is not None:
            cfg = dataclasses.replace(cfg, tp_size=tp_plugin.tp_size)
        return cfg

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    @property
    def logging_dir(self):
        return self.project_configuration.logging_dir

    @property
    def iteration(self) -> int:
        """The index of the next automatically named checkpoint."""
        return self.project_configuration.iteration

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The ``("pp", "dp", "fsdp", "ep", "sp", "tp")`` ``DeviceMesh``, or None
        for one process without sequence parallelism (or with a
        loopback)."""
        return self.state.mesh

    @property
    def mesh_sizes(self) -> dict:
        """``{"pp", "dp", "fsdp", "ep", "sp", "tp"}`` of the job: its process mesh,
        its loopback's ranks, or one rank."""
        cfg = self.state.parallelism_config
        if self.loopback is not None:
            return cfg.resolved_sizes(self.loopback.size)
        return cfg.resolved_sizes(self.num_processes if self.mesh is not None else 1)

    @property
    def num_data_ranks(self) -> int:
        """How many ways a batch's rows split: dp x fsdp."""
        return data_parallel_degree(self.mesh_sizes)

    def _router_stats(self, module, share: bool):
        """The router loss's statistics over the data ranks
        (``ops/moe.py``) for a model that sows auxiliary losses, or None
        when the rows are whole. ``share``: each rank's loss is its share
        of the global mean (the fused steps), else the mean of its rows
        (the imperative loop)."""
        n = self.num_data_ranks
        if n == 1 or not getattr(module, "scan_aux_keys", ()):
            return None
        scale = 1.0 / n if share else 1.0
        if self.loopback is not None:
            return RecordedRouterStats(scale)
        return DataRouterStats(self.state.data_group, n, scale)

    @property
    def fp8_backend(self):
        """Which backend serves ``mixed_precision="fp8"`` (JAX
        ``accelerator.py:634-643``): ``"INT8"`` (the int8 QAT matmuls) or
        ``"BF16"`` (bf16 compute only); None without fp8."""
        if self.state.mixed_precision != "fp8":
            return None
        return (self.fp8_recipe_handler or Fp8RecipeKwargs()).backend.upper()

    @property
    def train_window(self) -> int:
        """How many fused steps ``build_train_window`` runs a call: from
        ``ACCELERATE_TRAIN_WINDOW`` (the launcher's ``--train_window``),
        else 1; ``build_train_window(window=K)`` pins it."""
        if self._train_window is None:
            raw = os.environ.get(ENV_TRAIN_WINDOW, "").strip()
            try:
                value = int(raw) if raw else 1
            except ValueError:
                raise ValueError(f"{ENV_TRAIN_WINDOW}={raw!r} is not an integer") from None
            if value < 1:
                raise ValueError(f"{ENV_TRAIN_WINDOW} must be >= 1, got {value}")
            self._train_window = value
        return self._train_window

    @train_window.setter
    def train_window(self, value):
        value = int(value)
        if value < 1:
            raise ValueError(f"train_window must be >= 1, got {value}")
        self._train_window = value

    @property
    def zero_sharding(self) -> bool:
        """ZeRO: the optimizer state and the update sharded over the dp axis
        (JAX ``accelerator.py:578-603``). The default comes from
        ``ACCELERATE_ZERO_SHARDING``, else off. Setting it reaches the
        optimizers prepared before, as long as their state does not exist
        yet."""
        if self._zero_sharding is None:
            self._zero_sharding = parse_flag_from_env(ENV_ZERO_SHARDING)
        return self._zero_sharding

    @zero_sharding.setter
    def zero_sharding(self, value):
        self._zero_sharding = bool(value)
        for opt in self._optimizers:
            if opt.opt_state is None:
                opt.zero_sharding = self._zero_sharding

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

    @property
    def is_last_process(self) -> bool:
        return self.state.partial.is_last_process

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    def print(self, *args, **kwargs):
        self.state.partial.print(*args, **kwargs)

    def wait_for_everyone(self):
        self.state.partial.wait_for_everyone()

    # The process-control surface of the state (JAX accelerator.py:671-689).
    def on_main_process(self, function=None):
        return self.state.partial.on_main_process(function)

    def on_local_main_process(self, function=None):
        return self.state.partial.on_local_main_process(function)

    def on_last_process(self, function):
        return self.state.partial.on_last_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.partial.on_process(function, process_index)

    def on_local_process(self, function=None, local_process_index=None):
        return self.state.partial.on_local_process(function, local_process_index)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.partial.split_between_processes(inputs, apply_padding=apply_padding)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.partial.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.partial.local_main_process_first():
            yield

    def set_trigger(self):
        """Raise this rank's early-stop flag; :meth:`check_trigger` on every
        rank then sees it (JAX ``accelerator.py:1751-1762``)."""
        self.flag_tensor = torch.ones((), dtype=torch.int32, device=self.device)

    def check_trigger(self) -> bool:
        """Whether any rank raised its flag since the last check that fired:
        a sum all-reduce of the ranks' flags over the job, read on the host
        (every rank must call it). The flag is cleared when it fires."""
        flag = self.flag_tensor if self.flag_tensor is not None else torch.zeros(
            (), dtype=torch.int32, device=self.device)
        if int(ops.reduce(flag.clone(), reduction="sum").item()) >= 1:
            self.flag_tensor = None
            return True
        return False

    def _dp_group(self):
        """The process group a batch's rows are split over (dp x fsdp): the
        default group unless the mesh has an sp or tp axis."""
        return self.state.data_group

    def _data_index(self, coord) -> int:
        """The rows a rank holds: its index over dp x fsdp."""
        return coord["dp"] * self.mesh_sizes["fsdp"] + coord["fsdp"]

    def _dp_size_index(self):
        mesh = self.mesh
        if mesh is None:
            return 1, 0
        return self.num_data_ranks, self._data_index(mesh_coordinate(mesh))

    def _place_batch(self, batch, module=None):
        mesh = self.mesh
        if mesh is None:
            return place_batch(batch, self.device)
        coord = mesh_coordinate(mesh)
        if not _is_causal_lm(module):
            # Every leaf's rows split over dp x fsdp, as JAX's batch sharding
            # splits them.
            if mesh["sp"].size() > 1:
                raise ValueError(f"{type(module).__name__} has no token stream to split over "
                                 "sp; sequence parallelism trains the causal LMs")
            return place_batch(split_rows(batch, self._data_index(coord), self.num_data_ranks),
                               self.device)
        return shard_batch(batch, self.device, dp_index=self._data_index(coord),
                           dp_size=self.num_data_ranks, sp_index=coord["sp"],
                           sp_size=mesh["sp"].size(), shift_labels=module._shift_labels)

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
        if self.mesh_sizes["sp"] > 1:
            model.config = self._sequence_parallel_config(model.config)
        if self.fsdp_plugin is not None and self.fsdp_plugin.activation_checkpointing:
            model.config = dataclasses.replace(model.config, remat=True)
        if self.fp8_backend == "INT8" and getattr(model.config, "matmul_precision",
                                                  None) == "default":
            # fp8 as int8 QAT: a new config, as a shared one must not change.
            model.config = dataclasses.replace(model.config, matmul_precision="int8")
        if self.pp_plugin is not None:  # a schedule's name is checked on any mesh (JAX)
            resolve_pipeline_spec(model, {}, {}, 0, self.pp_plugin.schedule)
        dev = self.device
        params = tree_map(lambda p: p.detach().to(dev), model.params)
        if self.mesh is not None:  # every rank starts from rank 0's parameters
            for leaf in tree_leaves(params):
                broadcast(leaf, src=0)
        compute_dtype = self.state.compute_dtype
        if self.autocast_handler is not None and not self.autocast_handler.enabled:
            compute_dtype = torch.float32  # AutocastKwargs(enabled=False): f32 compute
        handle = TrainHandle(model, params, compute_dtype, dev)
        sizes = self.mesh_sizes
        if sizes["fsdp"] > 1 or sizes["tp"] > 1 or sizes["pp"] > 1 or sizes["ep"] > 1 or \
                self.loopback is not None or (self.zero_sharding and sizes["dp"] > 1):
            self._shard(handle)
        model.params = handle.params  # the user's handle sees the prepared parameters
        prepared = PreparedModel(handle, self)
        self._models.append(prepared)
        return prepared

    def _shard(self, handle):
        """Keep only this rank's shards of ``handle``'s parameters
        (``parallel/fsdp.py``), laid out as the JAX package plans them."""
        module = handle.module
        missing = [m for m in SHARD_PROTOCOL if not callable(getattr(module, m, None))]
        if missing or not isinstance(handle.params.get("layers"), dict):
            raise NotImplementedError(
                f"sharded training (fsdp, tp, ZeRO, a loopback) runs models of the embed / "
                f"block / head protocol that read their stacked layers one index at a time "
                f"(run_layers) and run tp on their pieces (the tp hooks _tp_attention and "
                f"_tp_mlp), as Llama, MoELlama, GPT2 and GPTX do; {type(module).__name__} "
                f"lacks {missing or ['stacked layers']} (ROADMAP.md, Queue 1 item 5)")
        sizes = self.mesh_sizes
        n_experts = getattr(module.config, "num_experts", None)
        if n_experts is not None and (n_experts % sizes["ep"]
                                      or module.config.intermediate_size % sizes["tp"]):
            raise NotImplementedError(
                f"{n_experts} experts of width {module.config.intermediate_size} do not split "
                f"over ep={sizes['ep']} and tp={sizes['tp']}; the expert group takes the "
                "experts split over ep and their columns over tp")
        plugin = self.fsdp_plugin
        specs = plan_param_shardings(handle.params, sizes, rules=module.sharding_rules(),
                                     min_shard_size=plugin.min_shard_size if plugin else 2**14)
        rank = 0 if self.mesh is None else self.process_index
        handle.sharded = ShardedModel(
            handle.params, specs, sizes, comm=self.loopback, mesh=self.mesh, rank=rank,
            compute_dtype=handle.compute_dtype,
            reshard_after_forward=plugin.reshard_after_forward if plugin else True,
            sp_loopback=LoopbackUlysses if module.config.attention_impl == "ulysses"
            else LoopbackRing, expert_group=self.state.expert_group)
        handle.pipeline_spec = self._pipeline_spec(handle)
        handle.params = handle.sharded.param_tree(handle.sharded.ranks[0])
        if module.params is not None and module.params is not handle.params:
            module.params = handle.params  # drop the full tree: only the shards stay
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _pipeline_spec(self, handle):
        """The model's pipeline schedule under pp (JAX ``accelerator.py:
        893-912``): the plugin's microbatches, else ``ACCELERATE_PP_
        MICROBATCHES``, else one a stage; its transport this process's
        stage over the pp group, or every stage of the loopback."""
        plugin, engine = self.pp_plugin, handle.sharded
        mbs = plugin.num_microbatches if plugin is not None else 0
        if mbs <= 0:
            env = os.environ.get(ENV_PP_MICROBATCHES, "").strip()
            try:
                mbs = int(env) if env else 0
            except ValueError:
                raise ValueError(f"ACCELERATE_PP_MICROBATCHES={env!r} is not an integer") \
                    from None
        schedule = plugin.schedule if plugin is not None else "gpipe"
        sizes = engine.sizes
        transport = None
        if sizes["pp"] > 1 and engine.loopback:
            transport = LoopbackStages(sizes["pp"])
        elif sizes["pp"] > 1:
            coord = engine.coord(engine.ranks[0])
            stride = self.num_processes // sizes["pp"]
            rank = engine.ranks[0] - coord["pp"] * stride
            transport = ProcessGroupStages(self.mesh.get_group("pp"), coord["pp"],
                                           [rank + s * stride for s in range(sizes["pp"])])
        return resolve_pipeline_spec(handle.module, engine.template, sizes, mbs, schedule,
                                     transport=transport)

    def _sequence_parallel_config(self, cfg):
        """The model's config under sp > 1: the JAX package's prepare-time
        refusals (``accelerator.py:850-879``), then ``attention_impl``
        ``"auto"`` becomes ``"ring"``, or ``"ulysses"`` under
        ``SequenceParallelPlugin(ring_attention=False)``. A new config
        object: one shared with another model must not change under it. The
        port's ranks hold only their shard, so an impl other than the ring
        or Ulysses raises."""
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
            ring = self.sp_plugin.ring_attention if self.sp_plugin is not None else True
            cfg = dataclasses.replace(cfg, attention_impl="ring" if ring else "ulysses")
        if cfg.attention_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"under sp>1 each rank holds a sequence shard, so attention must be the ring or "
                f"Ulysses; got attention_impl={cfg.attention_impl!r} (use 'auto', 'ring' or "
                "'ulysses')")
        return cfg

    def _new_optimizer(self, tx):
        prepared = AcceleratedOptimizer(tx, gradient_state=self.gradient_state,
                                        kernels=self.kernels, zero_sharding=self.zero_sharding,
                                        scaler=self.scaler, host_offload=self._offload_opt_state)
        prepared.accelerator = self
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
        over the data ranks (dp x fsdp; ``data_loader.prepare_data_loader``):
        the tp and sp ranks of one data coordinate read the same rows (under
        sp, the model call cuts the rank's sequence shard)."""
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
        the banked gradients averaged over the dp ranks (module docstring).
        Under fp16 the gradients are those of ``loss * scale``."""
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
        if self.scaler is not None:
            loss = loss * torch.full((), self.scaler.scale, dtype=torch.float32,
                                     device=loss.device)
        if model.handle.sharded is not None:  # the gradients reach the buffer in the backward
            opt._ensure_initialized()
            torch.autograd.backward(loss)
            model.handle.sharded.end(leaves[1])
            opt._accum_grads = model.handle.sharded.accum_tree(model.handle.sharded.ranks[0])
            return
        # A parameter the loss does not reach gets a zero gradient, as in JAX.
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        opt._accumulate(grads, scale=1.0 / self.gradient_accumulation_steps)
        if self.mesh is not None and self.sync_gradients:
            sp = self.state.sp_size > 1
            with torch.no_grad():
                for g in tree_leaves(opt.grads):
                    if sp:  # each sp rank's loss is its share of its rows' mean
                        reduce(g, reduction="sum", group=self.mesh.get_group("sp"))
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
    def join_uneven_inputs(self, joinables, even_batches=None):
        """A no-op context, as in JAX (``accelerator.py:1033``): a prepared
        loader evens the ranks' tails already (``even_batches``, the short
        last batch padded by wrap-around), so no rank runs out of batches
        before the others."""
        yield

    @contextlib.contextmanager
    def autocast(self, autocast_handler: AutocastKwargs | None = None):
        """Models prepared inside the block follow ``autocast_handler``
        (``AutocastKwargs(enabled=False)``: f32 compute), as JAX's
        ``prepare`` consults it (``accelerator.py:1040-1052``); a model
        prepared before keeps its dtype policy."""
        prev = self.autocast_handler
        if autocast_handler is not None:
            self.autocast_handler = autocast_handler
        try:
            yield
        finally:
            self.autocast_handler = prev

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
        return opt.grad_norm()

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

    def get_state_dict(self, model, unwrap: bool = True):
        """The model's parameters copied to the host (a tree of CPU
        tensors)."""
        if isinstance(model, PreparedModel) and model.handle.sharded is not None:
            from .checkpointing import full_host_params

            return full_host_params(model.handle.sharded)
        params = model.params if isinstance(model, PreparedModel) else getattr(
            model, "params", model)
        return tree_map(lambda p: p.detach().cpu(), params)

    def free_memory(self, *objects):
        """Drop every prepared model, optimizer, scheduler and loader, reset
        the micro-step count, collect garbage and return the card's cached
        blocks; returns ``objects``."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self.step = 0
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    # ------------------------------------------------------- trackers / log
    def init_trackers(self, project_name: str, config: dict | None = None,
                      init_kwargs: dict | None = None):
        from .tracking import init_trackers

        self.trackers = init_trackers(self.log_with, project_name, self.logging_dir, config,
                                      init_kwargs, self)

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"Tracker {name} not found: available {[t.name for t in self.trackers]}")

    def log(self, values: dict, step: int | None = None, log_kwargs: dict | None = None):
        """``values`` to every tracker, on the main process."""
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log(values, step=step, **((log_kwargs or {}).get(tracker.name, {})))

    def end_training(self):
        """Finish the trackers, join the background checkpoint writes (a
        failed one raises here) and wait for every rank."""
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.finish()
        self.finish_pending_saves()
        self.wait_for_everyone()

    # ----------------------------------------------------------- checkpointing
    def register_for_checkpointing(self, *objects):
        """Objects with ``state_dict`` / ``load_state_dict`` that
        ``save_state`` saves and ``load_state`` restores."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"Objects lack state_dict/load_state_dict: {invalid}")
        self._custom_objects.extend(objects)

    def save_state(self, output_dir: str | None = None, **save_model_func_kwargs):
        """``checkpointing.save_accelerator_state``; ``blocking=False``
        returns once the arrays are copied to the host and writes them in
        the background (join with ``finish_pending_saves``)."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, **save_model_func_kwargs)

    def finish_pending_saves(self):
        from .checkpointing import finish_pending_saves

        finish_pending_saves()

    def load_state(self, input_dir: str | None = None, **load_model_func_kwargs):
        """``checkpointing.load_accelerator_state``, into the prepared
        objects in place."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, **load_model_func_kwargs)

    def save_model(self, model, save_directory, max_shard_size="10GB",
                   safe_serialization=True):
        from .checkpointing import save_model

        return save_model(self, model, save_directory, max_shard_size, safe_serialization)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def checkpoint_on_preemption(self, output_dir: str | None = None, step: int | None = None,
                                 window: int = 1) -> bool:
        raise NotImplementedError("preemption checkpointing (the preemption watcher, fault "
                                  "plans and the goodput ledger of resilience/) is not ported "
                                  "yet (ROADMAP.md, module queue)")


    # ------------------------------------------------------------ fused step
    def _fused_value_and_grads(self, model: PreparedModel, loss_fn=None):
        """``(params, batch, scale) -> (loss, grads)``: the loss as a detached
        device scalar and the gradient of every parameter leaf, in the order
        of ``tree_leaves(params)``; with an fp16 ``scale`` (an f32 device
        scalar) the gradients are those of ``loss * scale`` and the loss is
        ``(loss * scale) / scale``, as JAX's ``train_fwd`` returns it."""
        loss_of = model.training_loss_fn(loss_fn)
        summed = self.mesh is not None
        reduction = "sum" if _is_causal_lm(model.handle.module) else "mean"

        def value_and_grads(params, batch, scale=None):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            with torch.enable_grad():
                loss = loss_of(tree_unflatten(params, leaves), batch)
                if scale is not None:
                    loss = loss * scale
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach() if scale is None else loss.detach() / scale
            if summed:
                for g in grads:
                    reduce(g, reduction=reduction)
                return reduce(loss, reduction=reduction), grads
            return loss, grads

        return value_and_grads

    def _fused_step_body(self, model: PreparedModel, optimizer: AcceleratedOptimizer,
                         accum: int, loss_fn=None):
        """``(params, opt_state, accum_grads, count, batch, clip_norm) ->
        (params, opt_state, accum_grads, count, loss)``: forward and
        backward, accumulation at ``1/accum`` scale, and on a boundary the
        clip and the update (the fused pass, or the reference chain for a
        transform the fused pass does not cover). Under fp16 the boundary
        first unscales, then reads the finite flag: a non-finite step
        zeroes the buffer and launches no update."""
        tx, plan, kernels = optimizer.tx, optimizer.plan, self.kernels
        scaler = optimizer.scaler
        value_and_grads = self._fused_value_and_grads(model, loss_fn)
        dev = model.handle.device
        # Divisor and fallback factor as device scalars: a CPU scalar divisor
        # would become a multiply by its reciprocal, which is not g / accum.
        accum_t = torch.full((), float(accum), dtype=torch.float32, device=dev)

        def upd(params, opt_state, grads, clip_norm):
            if scaler is not None:
                torch._foreach_mul_(tree_leaves(grads), scaler.inv_scale(dev))
            gnorm = global_norm(grads)
            factor = clip_factor(gnorm, clip_norm)
            if scaler is not None:
                finite = bool(torch.isfinite(gnorm).item())
                optimizer._count_fused_step(finite)
                if not finite:
                    torch._foreach_zero_(tree_leaves(grads))
                    return params, opt_state, grads
            if plan is not None:
                opt_state = fused_update_apply(params, opt_state, grads, plan=plan,
                                               clip_factor=factor, kernels=kernels)
                return params, opt_state, grads
            return reference_update_apply(params, opt_state, grads, tx=tx, clip_factor=factor)

        def step_body(params, opt_state, accum_grads, count, batch, clip_norm):
            scale = None
            if scaler is not None:
                scale = torch.full((), scaler.scale, dtype=torch.float32, device=dev)
            loss, grads = value_and_grads(params, batch, scale)
            with torch.no_grad():
                for a, g in zip(tree_leaves(accum_grads), grads):
                    a.add_(g / accum_t)
                del grads
                count += 1
                if count % accum == 0:
                    params, opt_state, accum_grads = upd(params, opt_state, accum_grads, clip_norm)
            return params, opt_state, accum_grads, count, loss

        return step_body

    def build_train_step(self, model: PreparedModel, optimizer: AcceleratedOptimizer,
                         loss_fn=None):
        """Returns ``step(batch, clip_norm=0.0) -> loss``, one micro-step on
        the shared handle state (see the module docstring); ``loss_fn(
        outputs, batch)`` replaces the model's own loss (JAX
        ``accelerator.py:1322``). A build zeroes the accumulation buffer,
        starts its micro-step count at 0 and brings an offloaded optimizer
        state to the device, where the fused step keeps it."""
        handle = model.handle
        optimizer._ensure_initialized()
        optimizer._fetch_state()
        if handle.sharded is not None:
            return self._build_sharded_step(model, optimizer, loss_fn)
        accum = self.gradient_accumulation_steps
        step_body = self._fused_step_body(model, optimizer, accum, loss_fn)
        optimizer._accum_grads = tree_map(torch.zeros_like, handle.params)
        count = 0

        def step(batch, clip_norm: float = 0.0):
            nonlocal count
            self._check_accum(accum, "build_train_step")
            clip = host_to_device(np.float32(clip_norm), handle.device)
            (handle.params, optimizer._opt_state, optimizer._accum_grads, count,
             loss) = step_body(handle.params, optimizer._opt_state, optimizer._accum_grads,
                               count, self._place_batch(batch, handle.module), clip)
            return loss

        return step

    def _check_accum(self, accum: int, builder: str):
        if self.gradient_accumulation_steps != accum:  # load_state(reshard=True) rescaled it
            raise RuntimeError(
                f"gradient_accumulation_steps changed from {accum} to "
                f"{self.gradient_accumulation_steps} after {builder}; build the step again")

    def build_train_window(self, model: PreparedModel, optimizer: AcceleratedOptimizer,
                           window: int | None = None, loss_fn=None):
        """Returns ``step_window(batch, clip_norm=0.0) -> losses``: K fused
        steps a call (JAX ``accelerator.py:1392-1440``), K from ``window``
        (which pins :attr:`train_window`) or :attr:`train_window`. Every
        leaf of ``batch`` carries a leading K axis
        (``DeviceBatchPrefetcher(..., window=K)`` builds such batches on the
        device; a host batch goes to the device in one copy a window); step
        i runs on ``batch[i]`` through the step ``build_train_step`` builds,
        so K calls are bitwise K calls of ``build_train_step``, accumulation
        included. Returns the K losses stacked as one device tensor; nothing
        in the window reads the device (the fp16 finite flag aside)."""
        window = self.train_window if window is None else int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.train_window = window
        step = self.build_train_step(model, optimizer, loss_fn)
        direct = self.mesh is None and model.handle.sharded is None

        def step_window(batch, clip_norm: float = 0.0):
            if self.train_window != window:
                raise RuntimeError(
                    f"train_window changed from {window} to {self.train_window} after "
                    "build_train_window; call build_train_window again to pick up the new "
                    "value.")
            _check_leading_axis(batch, window)
            if direct:  # one copy a window; the steps index the device tensors
                batch = place_batch(batch, model.handle.device)
            losses = [step(_window_slice(batch, i), clip_norm) for i in range(window)]
            return torch.stack(losses)

        step_window.window = window
        return step_window

    def _build_sharded_step(self, model: PreparedModel, optimizer: AcceleratedOptimizer,
                            loss_fn=None):
        """``build_train_step`` on shards (``parallel/fsdp.py``): every
        forward unit's rows of the global batch (and, on a process group,
        its sp rank's tokens), forward and backward with the gradients
        reduce-scattered into the buffer at ``1/accum``, and on a boundary
        the clip from the sharded norm and the update on the shards. Under
        fp16 the loss is scaled before the backward and the boundary
        unscales each rank's shards, then skips the update on every rank
        when the norm is not finite anywhere (the flag MIN-reduced over the
        job): a skipped step launches no update kernel. Under pp the forward
        and backward run the model's pipeline schedule (module docstring)."""
        handle = model.handle
        engine, module = handle.sharded, handle.module
        spec = handle.pipeline_spec
        one_f_one_b = spec is not None and spec.schedule == "1f1b"
        if one_f_one_b and loss_fn is not None:  # JAX accelerator.py:222-229
            raise ValueError(
                "schedule='1f1b' computes the loss on the last pipeline stage "
                "via the model's own head (labels in the batch) — a custom "
                "loss_fn cannot be honored. Drop set_loss_fn/loss_fn or use "
                "PipelineParallelPlugin(schedule='gpipe').")
        scaler = optimizer.scaler
        accum = self.gradient_accumulation_steps
        n_data = self.num_data_ranks
        sizes = engine.sizes
        dev = handle.device
        accum_t = torch.full((), float(accum), dtype=torch.float32, device=dev)
        for shards in engine.ensure_accum():
            for t in shards.values():
                t.zero_()
        optimizer._accum_grads = engine.accum_tree(engine.ranks[0])

        def sink(i, layer, key, g):
            target = engine.accum[i][key]
            (target if layer is None else target[layer]).add_(g / accum_t)

        count = 0

        def step(batch, clip_norm: float = 0.0):
            nonlocal count
            self._check_accum(accum, "build_train_step")
            clip = host_to_device(np.float32(clip_norm), dev)
            rows = np.shape(batch["input_ids"])[0]
            if one_f_one_b and "labels" not in batch:  # JAX pipeline.py:497-502
                raise ValueError(
                    "1F1B pipeline training computes the loss on the last stage: the "
                    "batch must contain 'labels' (the head-loss protocol).")
            if spec is not None:
                check_microbatch_grid(rows, n_data, spec.num_microbatches)
            if rows % n_data:
                raise ValueError(f"global batch dim {rows} not divisible by data-parallel "
                                 f"degree {n_data}; pad the batch or change dp/fsdp.")
            shards = {}
            for u in engine.units:
                coord = engine.coord(u)
                sp_index, sp_size = (0, 1) if engine.loopback else (coord["sp"], sizes["sp"])
                shards[u] = shard_batch(batch, dev, dp_index=self._data_index(coord),
                                        dp_size=n_data, sp_index=sp_index, sp_size=sp_size,
                                        shift_labels=module._shift_labels)
            counts = None
            for u in engine.units:
                c = (shards[u]["targets"] != -100).sum()
                counts = c if counts is None else counts + c
            normalizer = engine._reduce(counts).clamp(min=1)
            scale = None if scaler is None else torch.full((), scaler.scale,
                                                           dtype=torch.float32, device=dev)

            stats = self._router_stats(module, share=True)

            def forward(unit, tree):
                out = module.apply(tree, kernels=self.kernels, loss_normalizer=normalizer,
                                   pipeline=spec, router_stats=stats,
                                   **engine.unit_context(unit), **shards[unit])
                loss = out["loss"] if loss_fn is None else loss_fn(out, shards[unit])
                return loss if scale is None else loss * scale

            with torch.no_grad():
                if isinstance(stats, RecordedRouterStats):  # every data coordinate's routing
                    aliases, anchor = engine.begin(None)
                    for u in engine.units:
                        module.apply(engine.rank_tree(u, aliases, anchor), kernels=self.kernels,
                                     loss_normalizer=normalizer, pipeline=spec,
                                     router_stats=stats, **engine.unit_context(u), **shards[u])
                    engine._sink = engine._bank = None
                    stats.replay = True
                if one_f_one_b:
                    loss = self._forward_backward_1f1b(engine, spec, module, shards, normalizer,
                                                       scale, sink, stats)
                else:
                    loss = engine.forward_backward(forward, sink)
                    if scale is not None:
                        loss = loss / scale
                count += 1
                if count % accum == 0:
                    self._sharded_boundary(engine, optimizer, clip)
            return loss

        return step

    def _forward_backward_1f1b(self, engine, spec, module, shards, normalizer, scale, sink,
                               stats=None):
        """Every forward unit's 1F1B schedule (``parallel/pipeline.
        train_1f1b``), the gradients into ``sink`` as
        ``engine.forward_backward`` delivers them, those of the leaves
        every stage holds summed over pp too. Returns the loss summed over
        the units and the ranks."""
        engine.pp_reduce = True
        try:
            aliases, anchor = engine.begin(sink)
            total = None
            for unit in engine.units:
                with torch.enable_grad():
                    tree = engine.rank_tree(unit, aliases, anchor)
                loss = train_1f1b(spec, module, tree, shards[unit], normalizer=normalizer,
                                  dtype=engine.compute_dtype, scale=scale,
                                  unit_ctx=dict(engine.unit_context(unit), router_stats=stats),
                                  kernels=self.kernels,
                                  hooks=engine.hooks)
                total = loss if total is None else total + loss
            engine.end(aliases)
            return engine._reduce(total)
        finally:
            engine.pp_reduce = False

    @staticmethod
    def _sharded_boundary(engine, optimizer, clip):
        """The update boundary of the sharded fused step (fp16: unscale,
        then skip every rank's update on a non-finite norm)."""
        scaler = optimizer.scaler
        buffers = [t for shards in engine.accum for t in shards.values()]
        if scaler is not None:
            torch._foreach_mul_(buffers, scaler.inv_scale(buffers[0].device))
        gnorm = engine.global_norm()
        if scaler is not None:
            finite = engine.all_finite(gnorm)
            optimizer._count_fused_step(finite)
            if not finite:
                torch._foreach_zero_(buffers)
                return
        optimizer._sharded_update(clip_factor(gnorm, clip))


def _check_leading_axis(batch, window: int):
    """Every array leaf of a window batch carries the leading K axis (JAX
    ``build_train_window``'s check)."""
    for leaf in (batch.values() if isinstance(batch, dict) else [batch]):
        if isinstance(leaf, dict):
            _check_leading_axis(leaf, window)
            continue
        shape = np.shape(leaf)
        if len(shape) > 0 and shape[0] != window:
            hint = ("Use DeviceBatchPrefetcher(..., window=K) or np.stack K batches."
                    if window > 1 else
                    "Stack a length-1 leading axis (np.expand_dims, axis=0): "
                    "DeviceBatchPrefetcher(window=1) yields PLAIN batches shaped for "
                    "build_train_step.")
            raise ValueError(f"build_train_window(window={window}) expects every batch leaf "
                             f"stacked on a leading K axis; got leading dim {shape[0]} (shape "
                             f"{tuple(shape)}). " + hint)


def _window_slice(batch, i: int):
    """Step ``i`` of a window batch: index ``i`` of every array leaf."""
    if isinstance(batch, dict):
        return {k: _window_slice(v, i) for k, v in batch.items()}
    return batch[i] if np.ndim(batch) > 0 else batch
