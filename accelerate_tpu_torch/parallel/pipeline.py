"""Pipeline-parallel training over the mesh's ``pp`` axis — the counterpart
of ``accelerate_tpu/parallel/pipeline.py``.

Each pp rank keeps its own contiguous block of ``L / pp`` layers (a
*stage*; ``parallel/fsdp.py`` stores it and never gathers it over pp), and
the activations move stage to stage, microbatch by microbatch. The JAX
package writes the schedules as ``lax.scan`` over ticks with ``lax.ppermute``
between stages inside ``shard_map``; the port runs the same tick loops in
Python over a **transport** that hands a stage's output to the next stage
and a stage's input gradient to the previous one:

- :class:`ProcessGroupStages`: one stage a process, the tensors sent with
  ``torch.distributed.batch_isend_irecv`` over the pp group (NCCL on cards,
  gloo on the CPU);
- :class:`LoopbackStages`: every stage in this process (the loopback of
  ``LoopbackShards``), a stage's output handed to the next stage by
  reference at the end of the tick, after every stage has run its units.

Both run one tick loop: at every tick each held stage runs its units from
what it received at the end of the previous tick, then the transport
exchanges what the stages sent. What a stage sends and receives at a tick
follows from the schedule alone, so the two sides of a send agree without
a handshake. Activations and their gradients cross in the compute dtype,
as JAX's TPU wire does (``pipeline.py:273-277``).

The batch a forward unit trains on (a data coordinate's rows,
``parallel/fsdp.py``) splits into ``M`` contiguous microbatches; across the
data coordinates this is JAX's :func:`microbatch` layout, where microbatch
``m`` takes the ``m``-th chunk of every data shard.

**GPipe** (:meth:`PipelineSpec.run`, JAX ``:254-384``; ``Llama.apply(...,
pipeline=spec)``): ``M + P - 1`` forward ticks, stage ``s`` running
microbatch ``t - s`` and keeping its autograd graph; the last stage's
outputs, concatenated, are handed to every stage (JAX's psum over pp), so
the head and the loss run on every stage as in JAX. The backward runs the
ticks in reverse: every backward after every forward, in reverse microbatch
order, each stage's input gradient sent to the stage before, and the first
stage's, concatenated, handed to every stage as the embedding's gradient.
The layers' gradients accumulate into each stage's stationary shards.

**1F1B** (:func:`train_1f1b`, JAX ``_pipeline_train_grads``, ``:443-735``):
``M + 2P - 2`` ticks, stage ``s`` running the forward of microbatch
``t - s`` (without autograd) and the backward of microbatch
``t - 2(P - 1) + s``, which recomputes its block's forward from the saved
stage input and backpropagates the gradient the next stage sent (the last
stage: its head's loss). A stage keeps its inputs in a ring of ``2P``
slots, so at most ``2(P - 1 - s) + 1`` are live whatever ``M`` is. The
embedding runs on stage 0 (again in the backward unit), the head and the
loss on the last stage; each microbatch's loss is its share of the full
batch's mean (the head divides by the global count of targets, JAX's
renormalisation at ``:728-735``), and the gradients of the leaves every
stage holds (the embedding, the final norm, the head) are summed over pp.

**Auxiliary losses** (the MoE router loss; JAX ``:263-271, 492-508``): each
stage's blocks sow per-layer values for each microbatch (the microbatch and
the layer name the context a block gets). GPipe returns, with the output,
each key's sum over the stages, layers and microbatches (summed over pp
by the transport), which ``Llama.apply`` turns into the mean over layers
and microbatches; its gradient reaches every unit's values in the
backward. 1F1B adds ``coef · value / (M · L)`` (``module.aux_loss_coefs()``)
to each backward unit's objective on every stage, so the router loss's
gradients flow stage-locally, and to the unit's loss.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves

logger = logging.getLogger(__name__)

SCHEDULES = ("gpipe", "1f1b")


# ------------------------------------------------------------- microbatches
def microbatch(x, num_microbatches: int, data_degree: int = 1):
    """``(B, ...) -> (M, B // M, ...)``, microbatch ``m`` holding the
    ``m``-th contiguous chunk of each of the ``data_degree`` data shards
    (JAX ``microbatch``, ``pipeline.py:97-116``)."""
    M = num_microbatches
    B = x.shape[0]
    mb = B // (data_degree * M)
    x = x.reshape(data_degree, M, mb, *x.shape[1:]).transpose(0, 1)
    return x.reshape(M, data_degree * mb, *x.shape[3:])


def unmicrobatch(xs, data_degree: int = 1):
    """The inverse of :func:`microbatch`."""
    M, Bm = xs.shape[0], xs.shape[1]
    mb = Bm // data_degree
    x = xs.reshape(M, data_degree, mb, *xs.shape[2:]).transpose(0, 1)
    return x.reshape(M * Bm, *xs.shape[2:])


def check_microbatch_grid(batch: int, data_degree: int, num_microbatches: int):
    """JAX's ``_check_microbatch_grid`` (``pipeline.py:393``)."""
    if batch % (data_degree * num_microbatches) != 0:
        raise ValueError(
            f"Pipeline needs batch {batch} divisible by data-parallel degree x "
            f"num_microbatches = {data_degree}*{num_microbatches}; adjust the batch size or "
            f"PipelineParallelPlugin(num_microbatches=...).")


def _split_ctx(ctx: dict, B: int, M: int) -> list:
    """Per microbatch, the model's read-only context: entries with a leading
    batch dim are cut into the microbatches' rows, the others shared."""
    out = [dict(ctx, microbatch=m) for m in range(M)]
    for key, value in ctx.items():
        if isinstance(value, torch.Tensor) and value.dim() > 0 and value.shape[0] == B:
            for m, part in enumerate(value.chunk(M)):
                out[m][key] = part
    return out


# ---------------------------------------------------------------- transports
class LoopbackStages:
    """Every stage of a pipeline in this process: what a stage sends is the
    next (or previous) stage's input at the next tick, by reference.
    ``messages`` and ``sent_bytes`` count the hand-overs."""

    def __init__(self, stages: int):
        self.size = int(stages)
        self.stages = tuple(range(self.size))
        self.messages = 0
        self.sent_bytes = 0

    def exchange(self, fwd: dict, bwd: dict, want_fwd, want_bwd, like):
        """``fwd[s]`` to stage ``s + 1``, ``bwd[s]`` to stage ``s - 1``;
        returns what each held stage of ``want_fwd`` / ``want_bwd``
        receives."""
        for t in list(fwd.values()) + list(bwd.values()):
            self.messages += 1
            self.sent_bytes += t.numel() * t.element_size()
        return ({s: fwd[s - 1] for s in want_fwd}, {s: bwd[s + 1] for s in want_bwd})

    def broadcast(self, t, src: int, like=None):
        return t

    def sum(self, t):
        """``t`` summed over the stages: every stage is held here."""
        return t


class ProcessGroupStages:
    """This process's stage ``stage`` of a pipeline over ``group`` (the pp
    process group); ``ranks[s]`` is stage s's global rank. Every stage
    calls :meth:`exchange` at every tick, so the first call is a collective
    of the whole group: NCCL wants the group's first operation to be one
    (``batch_isend_irecv``'s contract), and a tick where some stages send
    nothing is not."""

    def __init__(self, group, stage: int, ranks):
        self.group = group
        self.size = len(ranks)
        self.stages = (int(stage),)
        self.ranks = list(ranks)
        self.messages = 0
        self.sent_bytes = 0
        self._joined = False

    def exchange(self, fwd: dict, bwd: dict, want_fwd, want_bwd, like):
        if not self._joined:
            dist.all_reduce(torch.zeros(1, device=like.device), group=self.group)
            self._joined = True
        ops, got_fwd, got_bwd = [], {}, {}
        for s, t in fwd.items():
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.ranks[s + 1], self.group))
        for s, t in bwd.items():
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.ranks[s - 1], self.group))
        for s in want_fwd:
            got_fwd[s] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got_fwd[s], self.ranks[s - 1], self.group))
        for s in want_bwd:
            got_bwd[s] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got_bwd[s], self.ranks[s + 1], self.group))
        for t in list(fwd.values()) + list(bwd.values()):
            self.messages += 1
            self.sent_bytes += t.numel() * t.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got_fwd, got_bwd

    def broadcast(self, t, src: int, like=None):
        """``t`` (on stage ``src``) on every stage; ``like`` gives the
        others its shape and dtype."""
        if t is None:
            t = torch.empty_like(like)
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def sum(self, t):
        """``t`` summed over the stages (an all-reduce over the pp group)."""
        t = t.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


# -------------------------------------------------------------------- spec
@dataclass
class PipelineSpec:
    """What a model's forward needs to route its layer stack through the
    pipeline (JAX ``PipelineSpec``): the stage count, the microbatch count,
    the schedule and the transport (a :class:`LoopbackStages` of ``stages``
    when None). ``peak_saved`` records, per held stage, the most stage
    inputs the last run kept at once (GPipe: every microbatch's graph;
    1F1B: the ring's live slots)."""

    stages: int
    num_microbatches: int
    schedule: str = "gpipe"
    transport: object = None
    peak_saved: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.transport is None:
            self.transport = LoopbackStages(self.stages)

    def stage_layers(self, n_layers: int, stage: int) -> range:
        k = n_layers // self.stages
        return range(stage * k, (stage + 1) * k)

    def run(self, module, layers, x, ctx):
        """GPipe over ``module.run_layers`` (module docstring): ``x`` the
        ``(B, S, H)`` residual stream of this forward unit, ``ctx`` the
        model's context. Returns the last stage's output on every stage and
        ``{key: mean over layers and microbatches}`` of the module's
        ``scan_aux_keys``."""
        M = self.num_microbatches
        check_microbatch_grid(x.shape[0], 1, M)
        n_layers = module.config.num_hidden_layers
        ctx_mb = _split_ctx(ctx, x.shape[0], M)
        keys = tuple(getattr(module, "scan_aux_keys", ()))

        def stage_fn(s, x_in, m):
            r = self.stage_layers(n_layers, s)
            y, aux = module.run_layers(layers, x_in, ctx_mb[m], r.start, r.stop)
            return y, (torch.stack([aux[k].float().reshape(()) for k in keys]) if keys
                       else None)

        if not torch.is_grad_enabled():
            out, aux = _gpipe_forward(self, stage_fn, x, None, bool(keys))
        else:
            # Layer leaves that are tensors of autograd (an unsharded tree)
            # are inputs of the node, so torch.autograd.grad reaches them; a
            # shard engine's leaves hand their gradients to its sinks
            # themselves.
            leaves = [t for t in tree_leaves(layers)
                      if isinstance(t, torch.Tensor) and t.requires_grad]
            out, aux = _GPipe.apply(self, stage_fn, x, bool(keys), *leaves)
        return out, {k: aux[j] / (M * n_layers) for j, k in enumerate(keys)}


def _gpipe_forward(spec, stage_fn, x, saved, has_aux):
    """The forward ticks; with ``saved`` (a dict) each unit's ``(input,
    output, aux)`` is kept with its autograd graph under ``saved[(s, m)]``.
    Returns the output and the aux values summed over every unit and stage
    (an empty tensor without aux)."""
    M, P, tr = spec.num_microbatches, spec.stages, spec.transport
    xs = x.detach().chunk(M)
    outs, rx, aux_sum = [None] * M, {}, None
    for t in range(M + P - 1):
        sends = {}
        for s in tr.stages:
            m = t - s
            if not 0 <= m < M:
                continue
            x_in = xs[m] if s == 0 else rx[s]
            if saved is not None:
                x_in = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y, aux = stage_fn(s, x_in, m)
                saved[(s, m)] = (x_in, y, aux)
                spec.peak_saved[s] = max(spec.peak_saved.get(s, 0),
                                         sum(1 for k in saved if k[0] == s))
            else:
                y, aux = stage_fn(s, x_in, m)
            if aux is not None:
                aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
            if s < P - 1:
                sends[s] = y.detach()
            else:
                outs[m] = y.detach()
        want = [s for s in tr.stages if s > 0 and 0 <= t - (s - 1) < M]
        rx, _ = tr.exchange(sends, {}, want, (), xs[0])
    out = torch.cat(outs) if outs[0] is not None else None
    out = tr.broadcast(out, P - 1, like=x.detach())
    if not has_aux:
        return out, torch.zeros(0, device=x.device)
    return out, tr.sum(aux_sum)


class _GPipe(torch.autograd.Function):
    """GPipe as one autograd node: the forward ticks keep each unit's graph,
    the backward runs the ticks in reverse (module docstring)."""

    @staticmethod
    def forward(ctx, spec, stage_fn, x, has_aux, *leaves):
        ctx.spec, ctx.saved, ctx.leaves = spec, {}, leaves
        spec.peak_saved = {}
        return _gpipe_forward(spec, stage_fn, x, ctx.saved, has_aux)

    @staticmethod
    def backward(ctx, dout, daux):
        spec, saved, leaves = ctx.spec, ctx.saved, ctx.leaves
        M, P, tr = spec.num_microbatches, spec.stages, spec.transport
        douts = dout.chunk(M)
        dxs, rx = [None] * M, {}
        leaf_grads = [None] * len(leaves)

        def unit(t, s):  # the microbatch stage s backpropagates at reverse tick t
            m = (M - 1) - t + (P - 1 - s)
            return m if 0 <= m < M else None

        for t in range(M + P - 1):
            sends = {}
            for s in tr.stages:
                m = unit(t, s)
                if m is None:
                    continue
                x_in, y, aux = saved.pop((s, m))
                dy = (douts[m] if s == P - 1 else rx[s]).to(y.dtype)
                outs, grads = (y,), (dy,)
                if aux is not None and daux is not None:
                    outs, grads = (y, aux), (dy, daux)
                if leaves:
                    got = torch.autograd.grad(outs, (x_in,) + leaves, grads, allow_unused=True)
                    g = got[0]
                    leaf_grads = [a if b is None else b if a is None else a + b
                                  for a, b in zip(leaf_grads, got[1:])]
                else:
                    torch.autograd.backward(outs, grads)
                    g = x_in.grad
                g = g if g is not None else torch.zeros_like(x_in)
                if s > 0:
                    sends[s] = g
                else:
                    dxs[m] = g
            want = [s for s in tr.stages if s < P - 1 and unit(t, s + 1) is not None]
            _, rx = tr.exchange({}, sends, (), want, douts[0])
        dx = torch.cat(dxs) if dxs[0] is not None else None
        return (None, None, tr.broadcast(dx, 0, like=dout), None, *leaf_grads)


# --------------------------------------------------------------------- 1F1B
def train_1f1b(spec, module, tree, batch, *, normalizer, dtype, scale=None, unit_ctx=None,
               kernels=None, hooks=None):
    """The 1F1B schedule (module docstring) on one forward unit: ``tree``
    the unit's parameter tree, ``batch`` its rows (``input_ids``,
    ``targets`` already shifted, optional ``attention_mask`` and
    ``positions``), ``normalizer`` the global count of targets. Every
    gradient reaches the parameters' leaves through autograd (the shard
    engine's sinks); returns the loss this unit's held stages computed (the
    last stage's share of the global mean, and every stage's router-loss
    terms). ``dtype`` is the
    compute dtype, the wire's. Under fp16 ``scale`` multiplies the loss
    before each backward. ``hooks`` is the context each recomputed forward
    runs in (the engine's ``reshard_after_forward``)."""
    M, P, tr = spec.num_microbatches, spec.stages, spec.transport
    ids, targets = batch["input_ids"], batch["targets"]
    mask, positions = batch.get("attention_mask"), batch.get("positions")
    B = ids.shape[0]
    check_microbatch_grid(B, 1, M)
    unit_ctx = dict(unit_ctx or {})
    tp = unit_ctx.get("tp")
    n_layers = module.config.num_hidden_layers
    coefs = module.aux_loss_coefs() if hasattr(module, "aux_loss_coefs") else {}
    aux_scale = {k: float(coefs.get(k, 0.0)) / (M * n_layers)
                 for k in getattr(module, "scan_aux_keys", ())}

    def cut(t):
        return [None] * M if t is None else list(t.chunk(M))

    ids_mb, tgt_mb, mask_mb, pos_mb = cut(ids), cut(targets), cut(mask), cut(positions)
    ctx_mb = []
    for m in range(M):
        c = module.context(ids_mb[m], pos_mb[m], mask_mb[m])
        c.update(kernels=kernels, tp=tp, sp_group=unit_ctx.get("sp_group"),
                 experts=unit_ctx.get("experts"), router_stats=unit_ctx.get("router_stats"),
                 microbatch=m)
        ctx_mb.append(c)

    def embed(m):
        x, _ = module.embed(tree, ids_mb[m], pos_mb[m], mask_mb[m], tp=tp)
        return x

    def stage_fn(s, x_in, m):
        r = spec.stage_layers(n_layers, s)
        return module.run_layers(tree["layers"], x_in, ctx_mb[m], r.start, r.stop)

    def aux_term(aux):  # the unit's router-loss terms: coef * value / (M * L)
        term = None
        for k, c in aux_scale.items():
            v = c * aux[k].float()
            term = v if term is None else term + v
        return term

    R = 2 * P
    ring = {s: [None] * R for s in tr.stages}
    spec.peak_saved = {}
    loss = None
    rx_f, rx_b = {}, {}
    like = torch.empty((B // M, ids.shape[1], module.config.hidden_size), dtype=dtype,
                       device=ids.device)  # a boundary tensor's shape and dtype
    for t in range(M + 2 * P - 2):
        sends_f, sends_b = {}, {}
        for s in tr.stages:
            f = t - s
            if 0 <= f < M:  # the forward unit, without autograd
                with torch.no_grad():
                    x_in = embed(f) if s == 0 else rx_f[s]
                    y, _ = stage_fn(s, x_in, f)
                ring[s][f % R] = None if s == 0 else x_in
                spec.peak_saved[s] = max(spec.peak_saved.get(s, 0),
                                         sum(1 for v in ring[s] if v is not None) + (s == 0))
                if s < P - 1:
                    sends_f[s] = y
            b = t - 2 * (P - 1) + s
            if 0 <= b < M:  # the backward unit: the block's forward again, then its VJP
                with torch.enable_grad(), (hooks() if hooks else contextlib.nullcontext()):
                    if s == 0:
                        x_b = embed(b)
                    else:
                        x_b = ring[s][b % R].detach().requires_grad_(True)
                    ring[s][b % R] = None
                    y_b, aux_b = stage_fn(s, x_b, b)
                    term = aux_term(aux_b)
                    if s == P - 1:
                        out = module.head(tree, y_b, targets=tgt_mb[b],
                                          loss_normalizer=normalizer, tp=tp)
                        mb_loss = out["loss"] if term is None else out["loss"] + term
                        torch.autograd.backward(mb_loss if scale is None else mb_loss * scale)
                    else:
                        outs, grads = [y_b], [rx_b[s].to(y_b.dtype)]
                        if term is not None:
                            outs.append(term if scale is None else term * scale)
                            grads.append(torch.ones_like(term))
                        torch.autograd.backward(outs, grads)
                        mb_loss = None if term is None else term
                    if mb_loss is not None:
                        mb_loss = mb_loss.detach().float()
                        loss = mb_loss if loss is None else loss + mb_loss
                if s > 0:
                    sends_b[s] = x_b.grad if x_b.grad is not None else torch.zeros_like(x_b)
        want_f = [s for s in tr.stages if s > 0 and 0 <= t - (s - 1) < M]
        want_b = [s for s in tr.stages if s < P - 1 and 0 <= t - 2 * (P - 1) + s + 1 < M]
        rx_f, rx_b = tr.exchange(sends_f, sends_b, want_f, want_b, like)
    if loss is None:
        loss = torch.zeros((), dtype=torch.float32, device=ids.device)
    return loss


# ----------------------------------------------------------------- resolve
def resolve_pipeline_spec(module, params, sizes: dict, num_microbatches: int = 0,
                          schedule: str = "gpipe", transport=None):
    """A :class:`PipelineSpec`, or None when the pipeline does not apply
    (JAX ``resolve_pipeline_spec``, ``pipeline.py:737-797``, with its checks
    and warnings): pp > 1, a ``pipeline_capable`` model, and a layer count
    that pp divides. ``sizes``: the mesh's axis sizes."""
    if schedule not in SCHEDULES:
        raise ValueError(f"Unknown pipeline schedule {schedule!r}; use 'gpipe' or '1f1b'.")
    pp = int(sizes.get("pp", 1))
    if pp <= 1:
        return None
    if not getattr(module, "pipeline_capable", False):
        logger.warning(
            "pp=%d requested but %s is not pipeline-capable: falling back to "
            "GSPMD layer-dim sharding (all-gathers stage weights every step). "
            "Use a pipeline-capable family (the decoder zoo, BERT, T5, "
            "Whisper) or drop pp from the mesh.", pp, type(module).__name__)
        return None
    layers = params.get("layers") if isinstance(params, dict) else None
    if not layers:
        return None
    first = layers
    while isinstance(first, dict):
        first = first[sorted(first)[0]]
    n_layers = first.shape[0]
    if n_layers % pp != 0:
        logger.warning(
            "Pipeline schedule disabled: %d layers do not split evenly across "
            "pp=%d stages — falling back to the GSPMD layer-dim sharding "
            "(which all-gathers stage weights every step).", n_layers, pp)
        return None
    if num_microbatches <= 0:
        num_microbatches = pp
    if schedule == "1f1b" and not (hasattr(module, "embed") and hasattr(module, "head")
                                   and hasattr(module, "_shift_labels")):
        raise ValueError(
            "schedule='1f1b' needs the causal-LM stage protocol (embed/block/"
            f"head with labels + _shift_labels); {type(module).__name__} lacks "
            "it — use schedule='gpipe'.")
    return PipelineSpec(stages=pp, num_microbatches=num_microbatches, schedule=schedule,
                        transport=transport)
