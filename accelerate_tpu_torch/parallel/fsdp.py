"""Sharded training: the fsdp axis and ZeRO over dp.

The JAX package lays each parameter out by a ``PartitionSpec`` and lets
GSPMD insert the collectives (``accelerate_tpu/accelerator.py:884-886,
1136-1270``). The port runs one process per rank over ``torch.distributed``,
so :class:`ShardedModel` does that work by hand, from the specs the planners
of ``parallel/sharding.py`` choose:

- **Storage.** Each rank keeps its shard of a leaf (the *base* layout,
  ``plan_param_shardings``) as its own contiguous f32 tensor, and its
  accumulation buffer in the same layout. Leaves the plan replicates (the
  norms, leaves under ``min_shard_size``) are whole on every rank. A base
  spec may split one dim over one mesh axis (what the Llama rules and the
  auto plan give); other specs raise.
- **Forward.** The model receives a tree whose sharded leaves are gathered
  when the model reads them: a stacked ``(L, ...)`` leaf one layer at a time
  (``layers[i]``), the others (the embedding, the LM head) whole. A gather
  casts the shards to the compute dtype first (bf16 under
  ``mixed_precision="bf16"``, half the bytes) and all-gathers them along
  the sharded dim (``utils/operations.all_gather_along``). With
  ``reshard_after_forward`` a gathered tensor that autograd would keep for
  the backward is dropped and gathered again when the backward reads it
  (``saved_tensors_hooks``); under remat the whole layer is gathered again
  inside the recomputed region.
- **Backward.** A gathered leaf's gradient, in f32, is reduce-scattered
  over the axis it is sharded on (summed) and all-reduced over the other
  data axis, and added into the owning shard of the accumulation buffer at
  ``1/accum``. A replicated leaf's gradient is all-reduced. Each rank's
  loss is its share of the global mean (the batch is split over dp x fsdp
  rows, the loss divided by the global count of targets), so the sums are
  the global gradient.
- **Update.** The global norm is each rank's sum of squares of the shards
  it owns, per leaf in the JAX leaf order, one all-reduce of that vector,
  then the leaves summed in order. Under ZeRO (``plan_zero_shardings``) a
  leaf's update covers the 1/dp slice of its base shard that the ZeRO spec
  gives this rank: the slice of the parameter and of the buffer is copied
  out contiguous, the fused update kernel (row 4) runs on it with the
  moments, which exist only in that layout, and the new slice is
  all-gathered over dp back into the base shard; the buffer is zeroed.
  Without ZeRO the kernel runs in place on the base shard. Either way it
  launches once per (rank, leaf), on shards only.

One process holds one rank over a process group (NCCL on cards, gloo on the
CPU), or all ``n`` ranks with :class:`LoopbackShards` (one card driving the
kernels as n cards would, ``chip_smoke.py`` phase 13). The loopback ranks run
one after another. A gather concatenates the held shards. A backward
cannot wait for the ranks that run after it, so the loopback banks each
rank's f32 gradient of a sharded leaf into one buffer of the leaf's full
size, in rank order, and scatters it into the shards after the last rank;
process groups reduce-scatter each layer in its backward. Tensors the
layout replicates are shared by the loopback ranks (one parameter, one
buffer), and a replicated leaf's gradient sums over the ranks in the shared
leaf's ``.grad``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..ops.fused_update import fused_update_leaves, reference_update_apply
from ..ops.registry import dispatch
from ..utils.operations import all_gather_along, reduce_scatter_along
from ..utils.tree import tree_leaves, tree_unflatten
from .sharding import entry_axes, padded_spec

DATA_AXES = ("dp", "fsdp")


class LoopbackShards:
    """All ``n`` ranks of a sharded job in one process (module docstring);
    ranks ``0 .. n-1``, laid out on the mesh as a process group's would be."""

    def __init__(self, n: int):
        if int(n) < 1:
            raise ValueError(f"a sharded job needs at least one rank, got {n}")
        self.size = int(n)
        self.ranks = tuple(range(self.size))


def rank_coordinate(rank: int, sizes: dict) -> dict:
    """``{"dp": i, "fsdp": j}`` of ``rank`` on a dp x fsdp mesh
    (rank = i * fsdp + j)."""
    return {"dp": rank // sizes["fsdp"], "fsdp": rank % sizes["fsdp"]}


class _Layout:
    """One leaf's placement: its full shape, the dim its spec splits over a
    mesh axis of size > 1 (``dim``, ``axis``; None for a replicated leaf),
    and, under ZeRO, the dim its update slice further splits over dp
    (``zero_dim``)."""

    def __init__(self, path, shape, spec, sizes):
        self.path, self.shape, self.sizes = path, tuple(shape), sizes
        self.dim, self.axis = _split(path, shape, spec, sizes)
        self.parts = sizes[self.axis] if self.axis else 1
        self.local_shape = list(self.shape)
        if self.dim is not None:
            self.local_shape[self.dim] //= self.parts
        self.set_zero(None)

    def set_zero(self, zero_spec):
        """The ZeRO spec of the leaf (None: the update covers the base
        shard)."""
        path, shape, sizes = self.path, self.shape, self.sizes
        self.zero_dim = None
        if zero_spec is not None:
            z_splits = _effective(shape, zero_spec, sizes)
            base = {} if self.dim is None else {self.dim: (self.axis,)}
            added = {d: a for d, a in z_splits.items() if base.get(d) != a}
            if any(d not in z_splits for d in base) or len(added) > 1:
                raise NotImplementedError(f"the ZeRO spec {zero_spec} of {path} is not its "
                                          "base spec with dp added on one dim")
            for d, axes in added.items():
                if axes != base.get(d, ()) + ("dp",):
                    raise NotImplementedError(f"the ZeRO spec {zero_spec} of {path} is not "
                                              "its base spec with dp added on one dim")
                self.zero_dim = d
        self.update_shape = list(self.local_shape)
        if self.zero_dim is not None:
            self.update_shape[self.zero_dim] //= sizes["dp"]

    def key(self, coord) -> int:
        """Which base shard a rank holds (ranks with one key share it)."""
        return 0 if self.axis is None else coord[self.axis]

    def local(self, full, coord):
        """The base shard of ``full`` at ``coord`` (a view)."""
        if self.dim is None:
            return full
        n = self.local_shape[self.dim]
        return full.narrow(self.dim, self.key(coord) * n, n)

    def update_slice(self, local, coord):
        """The ZeRO slice of a base shard at ``coord`` (a view)."""
        if self.zero_dim is None:
            return local
        n = self.update_shape[self.zero_dim]
        return local.narrow(self.zero_dim, coord["dp"] * n, n)

    def owner(self, coord) -> bool:
        """Whether this rank's update slice counts towards the global norm:
        its coordinate is 0 on every data axis the slice is replicated over."""
        split = {self.axis} | ({"dp"} if self.zero_dim is not None else set())
        return all(coord[a] == 0 for a in DATA_AXES if a not in split)


def _effective(shape, spec, sizes) -> dict:
    """``{dim: axes}`` of the axes of size > 1 a spec splits each dim over."""
    out = {}
    for d, e in enumerate(padded_spec(spec, len(shape))):
        axes = tuple(a for a in entry_axes(e) if int(sizes.get(a, 1)) > 1)
        if axes:
            out[d] = axes
    return out


def _split(path, shape, spec, sizes):
    splits = _effective(shape, spec, sizes)
    if not splits:
        return None, None
    if len(splits) > 1 or len(next(iter(splits.values()))) > 1:
        raise NotImplementedError(f"the spec {spec} of {path} splits more than one dim, or a "
                                  "dim over more than one axis; the sharded step takes one")
    ((dim, (axis,)),) = splits.items()
    return dim, axis


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _walk_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _walk_paths(tree[key], f"{prefix}/{key}" if prefix else str(key))]
    return [prefix]


# ------------------------------------------------------------- model inputs
class _Gather(torch.autograd.Function):
    """A sharded leaf (or layer ``layer`` of a stacked one) gathered at the
    compute dtype; the backward hands the gradient to the owning shards.
    ``anchor`` (a scalar that requires grad) makes autograd call the
    backward; it gets no gradient."""

    @staticmethod
    def forward(ctx, model, i, layer, rank, anchor):
        ctx.model, ctx.i, ctx.layer, ctx.rank = model, i, layer, rank
        out = model.gather(i, layer, rank)
        out._fsdp_regather = (i, layer, rank)
        return out

    @staticmethod
    def backward(ctx, grad):
        ctx.model.reduce_grad(ctx.i, ctx.layer, ctx.rank, grad)
        return None, None, None, None, None


class _Deferred:
    """A whole sharded leaf, gathered when the model reads it."""

    def __init__(self, model, i, rank, anchor):
        self.args = (model, i, None, rank, anchor)

    def __call__(self):
        return _Gather.apply(*self.args)


class _StackedLeaf:
    """A stacked ``(L, ...)`` sharded leaf: ``leaf[i]`` gathers layer i."""

    def __init__(self, model, i, rank, anchor):
        self.model, self.i, self.rank, self.anchor = model, i, rank, anchor

    def __getitem__(self, layer):
        return _Gather.apply(self.model, self.i, int(layer), self.rank, self.anchor)


class _LazyDict(dict):
    """A parameter dict whose deferred leaves gather when read."""

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        return value() if isinstance(value, _Deferred) else value

    def items(self):
        return [(k, self[k]) for k in self]


def _lazy(tree):
    if isinstance(tree, dict):
        return _LazyDict({k: _lazy(v) for k, v in tree.items()})
    return tree


# ------------------------------------------------------------------- model
class ShardedModel:
    """The sharded parameters and accumulation buffer of one prepared model,
    and the collectives of its step (module docstring). ``params``: the full
    f32 tree, the same on every rank (rank 0's); ``specs``: the base plan's
    tree (:meth:`set_zero_specs` adds ZeRO's); ``sizes``: the mesh's
    ``{"dp", "fsdp"}``; ``comm``: a :class:`LoopbackShards`, or None for
    this process's rank ``rank`` of ``mesh``, the job's ``DeviceMesh``."""

    def __init__(self, params, specs, sizes, *, comm=None, mesh=None, rank=0,
                 compute_dtype=torch.float32, reshard_after_forward=True):
        self.sizes = {a: int(sizes.get(a, 1)) for a in DATA_AXES}
        self.loopback = isinstance(comm, LoopbackShards)
        if self.loopback and comm.size != self.sizes["dp"] * self.sizes["fsdp"]:
            raise ValueError(f"LoopbackShards({comm.size}) does not hold a dp x fsdp mesh of "
                             f"{self.sizes}")
        self.ranks = comm.ranks if self.loopback else (int(rank),)
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.reshard_after_forward = bool(reshard_after_forward)
        self.template = _meta_tree(params)  # shapes only: the full tensors are not kept
        self.paths = _walk_paths(params)
        full = tree_leaves(params)
        self.specs = specs
        self.layouts = [_Layout(p, f.shape, s, self.sizes)
                        for p, f, s in zip(self.paths, full, tree_leaves(specs))]
        self.stacked = [p.startswith("layers/") for p in self.paths]
        for layout, stacked in zip(self.layouts, self.stacked):
            if stacked and layout.dim == 0:
                raise NotImplementedError(f"{layout.path} is sharded on its layer dim; the "
                                          "sharded step gathers a stacked leaf a layer at a time")
        # local[i][key]: base shards (the full tensor itself when replicated).
        self.local = []
        for f, layout in zip(full, self.layouts):
            shards = {}
            for r in self.ranks:
                coord = self.coord(r)
                key = layout.key(coord)
                if key not in shards:
                    shards[key] = (f.detach() if layout.dim is None else
                                   layout.local(f.detach(), coord).clone(
                                       memory_format=torch.contiguous_format))
            self.local.append(shards)
        self.accum = None
        self._bank = None
        self._sink = None

    # ------------------------------------------------------------ layout
    def coord(self, rank) -> dict:
        return rank_coordinate(rank, self.sizes)

    @property
    def zero_active(self) -> bool:
        return any(layout.zero_dim is not None for layout in self.layouts)

    def set_zero_specs(self, zero_specs):
        """Each leaf's ZeRO spec (a tree like the parameters; None: off).
        Only the update's slices change: the storage stays the base
        layout."""
        leaves = tree_leaves(zero_specs) if zero_specs is not None else [None] * len(self.layouts)
        for layout, z in zip(self.layouts, leaves):
            layout.set_zero(z)

    def _group(self, axis):
        return self.mesh.get_group(axis)

    def param_tree(self, rank):
        """Rank ``rank``'s parameter tree: its base shards."""
        return tree_unflatten(self.template, [self.local[i][layout.key(self.coord(rank))]
                                              for i, layout in enumerate(self.layouts)])

    def accum_tree(self, rank):
        return tree_unflatten(self.template, [self.accum[i][layout.key(self.coord(rank))]
                                              for i, layout in enumerate(self.layouts)])

    def update_template(self, rank):
        """Meta tensors of rank ``rank``'s update slices, for ``tx.init``."""
        return tree_unflatten(self.template, [
            torch.empty(layout.update_shape, dtype=self.local[i][layout.key(self.coord(rank))].dtype,
                        device="meta") for i, layout in enumerate(self.layouts)])

    def state_bytes(self, rank) -> dict:
        """Bytes of rank ``rank``'s parameter shards and buffer."""
        params = sum(t.numel() * t.element_size() for t in tree_leaves(self.param_tree(rank)))
        buf = 0 if self.accum is None else sum(t.numel() * t.element_size()
                                               for t in tree_leaves(self.accum_tree(rank)))
        return {"params": params, "buffer": buf}

    def ensure_accum(self):
        if self.accum is None:
            self.accum = [{k: torch.zeros_like(t) for k, t in shards.items()}
                          for shards in self.local]
        return self.accum

    # ----------------------------------------------------------- gathers
    def _held_group(self, rank, axis):
        """The held ranks that share ``rank``'s coordinates but on ``axis``,
        in axis order."""
        coord = self.coord(rank)
        return [r for r in self.ranks
                if all(self.coord(r)[a] == coord[a] for a in DATA_AXES if a != axis)]

    def gather(self, i, layer, rank, dtype=None):
        """Leaf ``i`` (layer ``layer`` of it, when not None) whole, at
        ``dtype`` (the compute dtype)."""
        layout = self.layouts[i]
        dtype = self.compute_dtype if dtype is None else dtype

        def part(shard):
            t = shard if layer is None else shard[layer]
            return t.to(dtype)

        dim = layout.dim - (layer is not None)
        if self.loopback:
            return torch.cat([part(self.local[i][layout.key(self.coord(r))])
                              for r in self._held_group(rank, layout.axis)], dim)
        return all_gather_along(part(self.local[i][layout.key(self.coord(rank))]), dim,
                                self._group(layout.axis))

    def full_leaf(self, i, update_slices=None):
        """Leaf ``i`` whole in f32, one leaf at a time on the device
        (checkpoints): from its base shards, or from ``update_slices``, per
        held rank its ZeRO slice (the moments)."""
        layout = self.layouts[i]
        base = self.local[i]
        if update_slices is not None:
            by_rank = dict(zip(self.ranks, update_slices))
            base = {}
            for r in self.ranks:
                key = layout.key(self.coord(r))
                if key in base:
                    continue
                if layout.zero_dim is None:
                    base[key] = by_rank[r]
                elif self.loopback:
                    base[key] = torch.cat([by_rank[q] for q in self._held_group(r, "dp")],
                                          layout.zero_dim)
                else:
                    base[key] = all_gather_along(by_rank[r], layout.zero_dim, self._group("dp"))
        if layout.dim is None:
            return next(iter(base.values()))
        if self.loopback:
            return torch.cat([base[k] for k in range(layout.parts)], layout.dim)
        return all_gather_along(base[layout.key(self.coord(self.ranks[0]))], layout.dim,
                                self._group(layout.axis))

    # ----------------------------------------------------------- backward
    def reduce_grad(self, i, layer, rank, grad):
        """The backward of a gather: the f32 gradient summed over the ranks
        into the owning shard (banked in the loopback)."""
        g = grad.float()
        layout = self.layouts[i]
        if self.loopback:
            if i not in self._bank:
                self._bank[i] = torch.zeros(layout.shape, dtype=torch.float32, device=g.device)
            (self._bank[i] if layer is None else self._bank[i][layer]).add_(g)
            return
        part = reduce_scatter_along(g, layout.dim - (layer is not None),
                                    self._group(layout.axis))
        for axis in DATA_AXES:
            if axis != layout.axis and self.sizes[axis] > 1:
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self._group(axis))
        self._sink(i, layer, layout.key(self.coord(rank)), part)

    def _pack(self, t):
        key = getattr(t, "_fsdp_regather", None)
        return ("regather", key) if key is not None else t

    def _unpack(self, packed):
        if isinstance(packed, tuple) and len(packed) == 2 and packed[0] == "regather":
            with torch.no_grad():
                return self.gather(*packed[1])
        return packed

    def rank_tree(self, rank, aliases, anchor):
        """The tree the model reads for rank ``rank``: replicated leaves as
        their (cast) aliases, sharded ones gathered on read."""
        leaves = []
        for i, layout in enumerate(self.layouts):
            if layout.dim is None:
                a = aliases[i]
                leaves.append(a.to(self.compute_dtype) if a.is_floating_point() else a)
            elif self.stacked[i]:
                leaves.append(_StackedLeaf(self, i, rank, anchor))
            else:
                leaves.append(_Deferred(self, i, rank, anchor))
        return _lazy(tree_unflatten(self.template, leaves))

    def begin(self, sink, n_data_ranks=None):
        """Start a micro-step's backward passes: each gradient will reach
        ``sink(i, layer, key, grad)`` summed over the ranks (a stacked
        leaf's per layer on a process group, whole in the loopback); with
        ``n_data_ranks`` (the imperative path, whose ranks each take the
        mean of their own rows) divided by it first. Returns ``(aliases,
        anchor)`` for :meth:`rank_tree`: the replicated leaves as leaves of
        autograd, shared by the held ranks."""
        if n_data_ranks is not None:
            def mean_sink(i, layer, key, g):
                sink(i, layer, key, g / torch.full((), float(n_data_ranks), device=g.device))

            self._sink = mean_sink
        else:
            self._sink = sink
        self._bank = {} if self.loopback else None
        aliases = {i: self.local[i][0].detach().requires_grad_(True)
                   for i, layout in enumerate(self.layouts) if layout.dim is None}
        return aliases, torch.zeros((), requires_grad=True)

    def hooks(self):
        """The forward's context: with ``reshard_after_forward``, gathered
        tensors autograd keeps are dropped and gathered again on use."""
        if not self.reshard_after_forward:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def end(self, aliases):
        """After every held rank's backward: the loopback's banked
        gradients scattered into the shards, and the replicated leaves'
        gradients (all-reduced over a process group), into the sink."""
        if self.loopback:
            for i, bank in self._bank.items():
                layout = self.layouts[i]
                n = layout.local_shape[layout.dim]
                for key in range(layout.parts):
                    self._sink(i, None, key, bank.narrow(layout.dim, key * n, n))
            self._bank = None
        for i, a in aliases.items():
            g = a.grad if a.grad is not None else torch.zeros_like(a)
            if not self.loopback and dist.is_initialized() and dist.get_world_size() > 1:
                dist.all_reduce(g, op=dist.ReduceOp.SUM)
            self._sink(i, None, 0, g)
        self._sink = None

    def forward_backward(self, forward, sink):
        """Every held rank's forward (``forward(rank, tree) -> loss``, its
        share of the global mean loss) and backward, the gradients summed
        over the ranks into ``sink`` (:meth:`begin`). Returns the loss
        summed over the ranks."""
        aliases, anchor = self.begin(sink)
        total = None
        for rank in self.ranks:
            with torch.enable_grad():
                with self.hooks():
                    loss = forward(rank, self.rank_tree(rank, aliases, anchor))
                torch.autograd.backward(loss)
            total = loss.detach() if total is None else total + loss.detach()
        self.end(aliases)
        if not self.loopback and dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total

    # ------------------------------------------------------------- update
    def global_norm(self, grads=None):
        """``sqrt(Σ_leaves Σ g²)`` of the buffer (or ``grads``, per leaf a
        dict of base shards), from each rank's update slices (module
        docstring)."""
        grads = self.accum if grads is None else grads
        dev = next(iter(grads[0].values())).device
        vec = None
        for rank in self.ranks:
            coord = self.coord(rank)
            parts = []
            for i, layout in enumerate(self.layouts):
                if layout.owner(coord):
                    g = layout.update_slice(grads[i][layout.key(coord)], coord)
                    parts.append(torch.sum(torch.square(g.float())))
                else:
                    parts.append(torch.zeros((), dtype=torch.float32, device=dev))
            v = torch.stack(parts)
            vec = v if vec is None else vec + v
        if not self.loopback and dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(vec, op=dist.ReduceOp.SUM)
        total = vec[0]
        for s in vec[1:]:
            total = total + s
        return torch.sqrt(total)

    def _update_operands(self, i):
        """Per held rank, ``(rank, p, g, in_place)``: the update slices of
        leaf i's parameter and buffer, copied out contiguous unless they
        are a base shard no other held rank shares."""
        layout = self.layouts[i]
        keys = [layout.key(self.coord(r)) for r in self.ranks]
        out = []
        for rank, key in zip(self.ranks, keys):
            coord = self.coord(rank)
            p, g = self.local[i][key], self.accum[i][key]
            if layout.zero_dim is None and keys.count(key) == 1:
                out.append((rank, p, g, True))
            else:
                out.append((rank, layout.update_slice(p, coord).clone(
                    memory_format=torch.contiguous_format), layout.update_slice(g, coord).clone(
                    memory_format=torch.contiguous_format), False))
        return out

    def _write_back(self, i, operands):
        """The new update slices into the base shards (all-gathered over dp
        on a process group), and the buffer zeroed where it was copied."""
        layout = self.layouts[i]
        copied = [(rank, p) for rank, p, _, in_place in operands if not in_place]
        if not copied:
            return
        for rank, p in copied:
            coord = self.coord(rank)
            key = layout.key(coord)
            if layout.zero_dim is not None and not self.loopback:
                p = all_gather_along(p, layout.zero_dim, self._group("dp"))
                self.local[i][key].copy_(p)
            else:
                layout.update_slice(self.local[i][key], coord).copy_(p)
            self.accum[i][key].zero_()

    def update(self, tx, plan, states, factor, kernels=None):
        """One update of every leaf on every held rank with clip factor
        ``factor`` (an f32 device scalar); ``states``: per held rank its
        optimizer state over its update slices. Returns the new states.
        The fused kernel runs once per (rank, leaf) when ``plan`` is not
        None; else the reference chain runs per rank on copies of the
        slices."""
        if plan is None:
            return self._reference_update(tx, states, factor)
        per_rank = [fused_update_leaves(s, plan=plan) for s in states]
        for i in range(len(self.layouts)):
            operands = self._update_operands(i)
            for (rank, p, g, _), (moments, scalars, _) in zip(operands, per_rank):
                dispatch("fused_update", p, g, () if moments is None else moments[i], factor,
                         *scalars, plan=plan, kernels=kernels)
            self._write_back(i, operands)
        return [new for _, _, new in per_rank]

    def _reference_update(self, tx, states, factor):
        operands = [self._update_operands(i) for i in range(len(self.layouts))]
        new_states = []
        for j, state in enumerate(states):
            p_tree = tree_unflatten(self.template, [ops[j][1] for ops in operands])
            g_tree = tree_unflatten(self.template, [ops[j][2] for ops in operands])
            new_p, new_state, _ = reference_update_apply(p_tree, state, g_tree, tx=tx,
                                                         clip_factor=factor)
            for ops, leaf in zip(operands, tree_leaves(new_p)):
                rank, p, g, in_place = ops[j]
                if in_place:
                    p.copy_(leaf)
                    g.zero_()
                else:
                    ops[j] = (rank, leaf, g, False)
            new_states.append(new_state)
        for i, ops in enumerate(operands):
            self._write_back(i, ops)
        return new_states

    # -------------------------------------------------------- checkpoints
    def load_full(self, i, full):
        """Copy the base shards of a full leaf into the parameters, in
        place."""
        layout = self.layouts[i]
        for r in self.ranks:
            coord = self.coord(r)
            self.local[i][layout.key(coord)].copy_(layout.local(full, coord))

    def update_slices_of(self, i, full):
        """Per held rank, rank's update slice of a full leaf (views)."""
        layout = self.layouts[i]
        return [layout.update_slice(layout.local(full, self.coord(r)), self.coord(r))
                for r in self.ranks]
