"""Sharded training: the fsdp, tp, ep and pp axes, ZeRO over dp, and sp beside them.

The JAX package lays each parameter out by a ``PartitionSpec`` and lets
GSPMD insert the collectives (``accelerate_tpu/accelerator.py:884-886,
1136-1270``). The port runs one process per rank over ``torch.distributed``,
so :class:`ShardedModel` does that work by hand, from the specs the planners
of ``parallel/sharding.py`` choose:

- **Storage.** Each rank keeps its shard of a leaf (the *base* layout,
  ``plan_param_shardings``) as its own contiguous f32 tensor, and its
  accumulation buffer in the same layout. A base spec may split one dim
  over the fsdp axis and another over the tp axis (the Llama rules: wq
  ``(pp, fsdp, tp)``, wo ``(pp, tp, fsdp)``, the embedding ``(tp, fsdp)``),
  and one more over the ep axis (a mixture-of-experts layer's expert dim:
  ``w_gate`` ``(pp, ep, fsdp, tp)``); other specs raise. Leaves the plan
  replicates (the norms, leaves under
  ``min_shard_size``) are whole on every rank. A stacked ``(L, ...)`` leaf
  split on its layer dim over pp is the rank's own contiguous block of
  ``L / pp`` layers (a pipeline stage's, ``parallel/pipeline.py``): it is
  never gathered over pp, and its layer ``i`` is global layer
  ``stage * L / pp + i``; its fsdp and tp splits work as without pp.
- **Forward.** The model receives a tree whose sharded leaves are gathered
  over **fsdp only** when the model reads them: a stacked ``(L, ...)`` leaf
  one layer at a time (``layers[i]``, i the global layer index, which
  must lie in a stage this process holds), the others (the embedding, the
  LM head) whole. A gather casts the shards to the compute dtype first and
  all-gathers them along the fsdp dim (``utils/operations.all_gather_along``).
  A leaf split over tp or ep keeps that split: the model receives it as a
  list of the pieces this process holds (one on a process group; over ep
  and tp, ep major) and runs Megatron's split, or its experts, on it
  (``parallel/tensor.py``, ``models/llama.py``, ``ops/moe.py``).
  With ``reshard_after_forward`` a gathered tensor that autograd would keep
  for the backward is dropped and gathered again when the backward reads it
  (``saved_tensors_hooks``); under remat the whole layer is gathered again
  inside the recomputed region.
- **Backward.** A gathered leaf's gradient, in f32, is reduce-scattered over
  fsdp (summed) when the leaf is split there, all-reduced over the other
  axes of dp, fsdp and sp, and added into the owning shard of the
  accumulation buffer. It is never summed over tp or ep: a rank's gradient
  of its own piece is whole, and a replicated leaf's is the same on every tp
  and ep rank (Megatron's conjugate ops make it so; the ep ranks see the
  same rows). Over pp, a stage's layers
  have their own gradient; a leaf that every stage holds (the embedding,
  the head, the final norm) is summed over pp under the 1F1B schedule,
  where only the first and the last stage run those parts
  (``pp_reduce``; on a process group a sharded one is banked through the
  schedule and all-reduced over pp at its end by every rank, as the other
  stages never reach a collective inside its backward), and not under
  GPipe, where every stage runs them on the same inputs. Each rank's loss is its share
  of the global mean (the rows split over dp x fsdp, the sequence over sp,
  the loss divided by the global count of targets), so the sums are the
  global gradient.
- **Update.** The global norm is each rank's sum of squares of the shards
  it owns, per leaf in the JAX leaf order, one all-reduce of that vector,
  then the leaves summed in order; a rank owns a slice when its coordinate
  is 0 on every axis the slice is replicated over (so a tp-split leaf
  counts each tp or ep piece once, a stage's layers once on each stage, and
  a norm once). Under ZeRO
  (``plan_zero_shardings``) a leaf's update covers the 1/dp slice of its
  base shard that the ZeRO spec gives this rank: the slice of the
  parameter and of the buffer is copied out contiguous, the fused update
  kernel (row 4) runs on it with the moments, which exist only in that
  layout, and the new slice is all-gathered over dp back into the base
  shard; the buffer is zeroed. Without ZeRO the kernel runs in place on the
  base shard. Either way it launches once per (rank, leaf), on shards only;
  in the loopback, once per distinct update slice of a leaf: ranks that
  hold the same slice (replicas over dp without ZeRO, over tp, ep or sp) would
  each make the same update, so the first of them makes it, and their
  optimizer states share that slice's moments (one card holds them once).
- **Update statistics.** A transform that is not elementwise (adafactor's
  factored second moments and block RMS, ``optim.py``) needs sums over the
  whole global leaf. On a process group each rank runs the chain on its
  slices with ``optim.leaf_views`` naming, per leaf, its global shape and
  the process groups that split each of its dims, and the transforms
  all-reduce their partial sums over those groups (GSPMD's reductions in
  the JAX package). The loopback holds every slice, so it runs the chain
  once on the whole leaves and writes the new slices back.

One process holds one rank over a process group (NCCL on cards, gloo on the
CPU), or all ``n`` ranks with :class:`LoopbackShards` (one card driving the
kernels as n cards would, ``chip_smoke.py`` phases 13 and 15). The loopback
runs one forward and backward per data coordinate (dp, fsdp), one after
another; each covers that coordinate's pp, ep, tp and sp ranks: the pp
stages through the pipeline's loopback transport, the tp and ep ranks in
lockstep through ``parallel/tensor.LoopbackTP`` (each ep rank's partial
combine through its own reduce), the sp ranks as one
sequence whose position-wise work (the projections, the norms, the MLP)
runs as one product over their concatenated shards, with ring or Ulysses
attention over ``LoopbackRing`` / ``LoopbackUlysses`` in the middle. A
gather concatenates the held shards. A backward cannot wait for the data
coordinates that run after it, so the loopback banks the f32 gradient of a
sharded leaf into one buffer of the leaf's full size and scatters it into
the shards after the last one; process groups reduce-scatter each layer in
its backward. Tensors the layout replicates are shared by the loopback
ranks (one parameter, one buffer), and a replicated leaf's gradient sums
over the data coordinates in the shared leaf's ``.grad``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..ops.fused_update import fused_update_leaves, reference_update_apply
from ..ops.registry import dispatch
from ..utils.operations import all_gather_along, reduce_scatter_along
from ..utils.tree import flatten_with_paths, map_with_paths, tree_leaves, tree_unflatten
from ..optim import LeafView, leaf_views, needs_global_stats
from .mesh import MESH_AXES
from .sharding import entry_axes, padded_spec
from .tensor import LoopbackTP, ProcessGroupTP

# The axes a gradient is summed over: each rank's loss is its share of the
# global mean over the rows (dp x fsdp) and the sequence (sp).
REDUCE_AXES = ("dp", "fsdp", "sp")
# The axes a base spec may split a parameter over (pp only the layer dim of a
# stacked leaf).
SPLIT_AXES = ("pp", "fsdp", "ep", "tp")
# The axes whose pieces a forward unit receives as a list (ep major).
PIECE_AXES = ("ep", "tp")


class LoopbackShards:
    """All ``n`` ranks of a sharded job in one process (module docstring);
    ranks ``0 .. n-1``, laid out on the mesh as a process group's would be."""

    def __init__(self, n: int):
        if int(n) < 1:
            raise ValueError(f"a sharded job needs at least one rank, got {n}")
        self.size = int(n)
        self.ranks = tuple(range(self.size))


def rank_coordinate(rank: int, sizes: dict) -> dict:
    """``{"pp", "dp", "fsdp", "ep", "sp", "tp"}`` of ``rank`` on the mesh
    (``parallel/mesh.py``'s rank order, tp innermost)."""
    coord = {}
    for axis in reversed(MESH_AXES):
        n = int(sizes.get(axis, 1))
        coord[axis] = rank % n
        rank //= n
    return {a: coord[a] for a in MESH_AXES}


class _Layout:
    """One leaf's placement: its full shape, the dims its spec splits over
    the pp, fsdp, ep and tp axes (``splits``, ``{axis: dim}``; empty for a
    replicated leaf), and, under ZeRO, the dim its update slice further
    splits over dp (``zero_dim``)."""

    def __init__(self, path, shape, spec, sizes):
        self.path, self.shape, self.sizes = path, tuple(shape), sizes
        self.splits = _split(path, shape, spec, sizes)
        self.fsdp_dim, self.pp_dim = self.splits.get("fsdp"), self.splits.get("pp")
        self.local_shape = list(self.shape)
        for axis, d in self.splits.items():
            self.local_shape[d] //= sizes[axis]
        self.set_zero(None)

    def set_zero(self, zero_spec):
        """The ZeRO spec of the leaf (None: the update covers the base
        shard)."""
        path, shape, sizes = self.path, self.shape, self.sizes
        self.zero_dim = None
        if zero_spec is not None:
            z_splits = _effective(shape, zero_spec, sizes)
            base = {d: (a,) for a, d in self.splits.items()}
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

    def key(self, coord) -> tuple:
        """Which base shard a rank holds, ``(pp index, fsdp index, ep index,
        tp index)`` of the axes the leaf is split over, 0 for the others
        (ranks with one key share it)."""
        return tuple(coord[a] if a in self.splits else 0 for a in SPLIT_AXES)

    def local_of_key(self, full, key):
        """The base shard ``key`` of ``full`` (a view)."""
        for axis, index in zip(SPLIT_AXES, key):
            if axis in self.splits:
                d = self.splits[axis]
                n = self.local_shape[d]
                full = full.narrow(d, index * n, n)
        return full

    def local(self, full, coord):
        """The base shard of ``full`` at ``coord`` (a view)."""
        return self.local_of_key(full, self.key(coord))

    def update_slice(self, local, coord):
        """The ZeRO slice of a base shard at ``coord`` (a view)."""
        if self.zero_dim is None:
            return local
        n = self.update_shape[self.zero_dim]
        return local.narrow(self.zero_dim, coord["dp"] * n, n)

    def owner(self, coord) -> bool:
        """Whether this rank's update slice counts towards the global norm:
        its coordinate is 0 on every axis the slice is replicated over."""
        split = set(self.splits) | ({"dp"} if self.zero_dim is not None else set())
        return all(coord[a] == 0 for a in MESH_AXES if a not in split)


def _effective(shape, spec, sizes) -> dict:
    """``{dim: axes}`` of the axes of size > 1 a spec splits each dim over."""
    out = {}
    for d, e in enumerate(padded_spec(spec, len(shape))):
        axes = tuple(a for a in entry_axes(e) if int(sizes.get(a, 1)) > 1)
        if axes:
            out[d] = axes
    return out


def _split(path, shape, spec, sizes) -> dict:
    out = {}
    for d, axes in _effective(shape, spec, sizes).items():
        if len(axes) > 1 or axes[0] not in SPLIT_AXES or axes[0] in out:
            raise NotImplementedError(
                f"the spec {spec} of {path} splits a dim over {axes}; the sharded step takes "
                "at most one dim over each of pp, fsdp, ep and tp")
        out[axes[0]] = d
    return out


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
    """A sharded leaf (or layer ``layer`` of a stacked one) gathered over
    fsdp at the compute dtype, for forward unit ``unit``: one tensor, or,
    for a leaf split over tp, one piece per held tp rank; the backward
    hands the gradient to the owning shards. ``anchor`` (a scalar that
    requires grad) makes autograd call the backward; it gets no
    gradient."""

    @staticmethod
    def forward(ctx, model, i, layer, unit, anchor):
        ctx.model, ctx.i, ctx.layer, ctx.unit = model, i, layer, unit
        out = model.gather(i, layer, unit)
        for piece, t in enumerate(out if isinstance(out, tuple) else (out,)):
            t._fsdp_regather = (i, layer, unit, piece)
        return out

    @staticmethod
    def backward(ctx, *grads):
        ctx.model.reduce_grad(ctx.i, ctx.layer, ctx.unit, grads)
        return None, None, None, None, None


def _gathered(*args):
    out = _Gather.apply(*args)
    return list(out) if isinstance(out, tuple) else out


class _Deferred:
    """A whole sharded leaf, gathered when the model reads it."""

    def __init__(self, model, i, unit, anchor):
        self.args = (model, i, None, unit, anchor)

    def __call__(self):
        return _gathered(*self.args)


class _StackedLeaf:
    """A stacked ``(L, ...)`` sharded leaf: ``leaf[i]`` gathers layer i."""

    def __init__(self, model, i, unit, anchor):
        self.model, self.i, self.unit, self.anchor = model, i, unit, anchor

    def __getitem__(self, layer):
        return _gathered(self.model, self.i, int(layer), self.unit, self.anchor)


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
    tree (:meth:`set_zero_specs` adds ZeRO's); ``sizes``: the mesh's axis
    sizes; ``comm``: a :class:`LoopbackShards`, or None for this process's
    rank ``rank`` of ``mesh``, the job's ``DeviceMesh``. ``sp_loopback``:
    the class of the loopback sp group a forward unit hands the model
    (``LoopbackRing`` or ``LoopbackUlysses``). ``expert_group``: under ep x
    tp on a process group, this rank's joint ep x tp group
    (``parallel/tensor.py``)."""

    def __init__(self, params, specs, sizes, *, comm=None, mesh=None, rank=0,
                 compute_dtype=torch.float32, reshard_after_forward=True, sp_loopback=None,
                 expert_group=None):
        self.sizes = {a: int(sizes.get(a, 1)) for a in MESH_AXES}
        self.loopback = isinstance(comm, LoopbackShards)
        world = 1
        for n in self.sizes.values():
            world *= n
        if self.loopback and comm.size != world:
            raise ValueError(f"LoopbackShards({comm.size}) does not hold a mesh of "
                             f"{self.sizes}")
        self.ranks = comm.ranks if self.loopback else (int(rank),)
        # A forward unit: a process group's rank, or in the loopback one data
        # coordinate with all its pp, ep, tp and sp ranks (its rank at 0 on
        # those axes).
        self.units = tuple(r for r in self.ranks if not self.loopback or all(
            self.coord(r)[a] == 0 for a in ("pp", "ep", "sp", "tp")))
        self.expert_group = expert_group
        # Whether the gradients of the leaves every stage holds sum over pp
        # (the 1F1B schedule sets it for its steps; module docstring).
        self.pp_reduce = False
        self.mesh = mesh
        self.sp_loopback = sp_loopback
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
            if any(d == 0 and a != "pp" for a, d in layout.splits.items()) and stacked:
                raise NotImplementedError(f"{layout.path} is sharded on its layer dim over fsdp "
                                          "or tp; the sharded step gathers a stacked leaf a "
                                          "layer at a time")
            if layout.pp_dim is not None and (not stacked or layout.pp_dim != 0):
                raise NotImplementedError(f"{layout.path} is split over pp on dim "
                                          f"{layout.pp_dim}; pp splits the layer dim of a "
                                          "stacked leaf only")
        # local[i][key]: base shards (the full tensor itself when replicated).
        self.local = []
        for f, layout in zip(full, self.layouts):
            shards = {}
            for r in self.ranks:
                key = layout.key(self.coord(r))
                if key not in shards:
                    shards[key] = (f.detach() if not layout.splits else
                                   layout.local_of_key(f.detach(), key).clone(
                                       memory_format=torch.contiguous_format))
            self.local.append(shards)
        self.accum = None
        self._bank = None
        self._pp_bank = None
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

    def unit_context(self, unit) -> dict:
        """What the model's forward of ``unit`` needs besides the tree:
        ``tp`` (a ``parallel/tensor`` context, None without a tp axis),
        ``sp_group`` (the sp process group, a loopback sp group, or None)
        and ``experts`` (the expert group over ep x tp, None when both have
        size 1)."""
        tp = sp = experts = None
        n_tp, n_ep = self.sizes["tp"], self.sizes["ep"]
        if n_tp > 1:
            tp = LoopbackTP(n_tp) if self.loopback else ProcessGroupTP(self._group("tp"))
        if n_ep * n_tp > 1:
            if self.loopback:
                experts = LoopbackTP(n_ep * n_tp, minor=n_tp)
            else:
                group = self.expert_group if n_ep > 1 and n_tp > 1 else self._group(
                    "ep" if n_ep > 1 else "tp")
                experts = ProcessGroupTP(group, minor=n_tp)
        if self.sizes["sp"] > 1:
            sp = self.sp_loopback(self.sizes["sp"]) if self.loopback else self._group("sp")
        return {"tp": tp, "sp_group": sp, "experts": experts}

    def _reduce(self, t, axes=None):
        """``t`` summed in place over this process group rank's ``axes`` of
        size > 1 (when None: dp, fsdp and sp, and pp under ``pp_reduce``;
        nothing in the loopback); the default group when they are all of
        the job's ranks."""
        axes = (REDUCE_AXES + (("pp",) if self.pp_reduce else ())) if axes is None else axes
        if self.loopback or not dist.is_initialized() or dist.get_world_size() == 1:
            return t
        live = [a for a in axes if self.sizes[a] > 1]
        others = [a for a in MESH_AXES if a not in axes and self.sizes[a] > 1]
        if not others:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            return t
        for axis in live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group(axis))
        return t

    def all_finite(self, gnorm) -> bool:
        """Whether ``gnorm`` is finite on every rank: the flag MIN-reduced
        over the job (one read of the device)."""
        flag = torch.isfinite(gnorm).to(torch.int32).reshape(1)
        if not self.loopback and dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def param_tree(self, rank):
        """Rank ``rank``'s parameter tree: its base shards."""
        return tree_unflatten(self.template, [self.local[i][layout.key(self.coord(rank))]
                                              for i, layout in enumerate(self.layouts)])

    def accum_tree(self, rank):
        return tree_unflatten(self.template, [self.accum[i][layout.key(self.coord(rank))]
                                              for i, layout in enumerate(self.layouts)])

    def slice_id(self, i, rank) -> tuple:
        """Which update slice of leaf ``i`` rank ``rank`` updates: its base
        shard's key and, under ZeRO, its dp index."""
        layout, coord = self.layouts[i], self.coord(rank)
        return layout.key(coord), coord["dp"] if layout.zero_dim is not None else None

    def _leaders(self, i) -> list:
        """Per held rank, whether it is the first to hold its update slice
        of leaf ``i`` (the one that updates it)."""
        seen, out = set(), []
        for r in self.ranks:
            ident = self.slice_id(i, r)
            out.append(ident not in seen)
            seen.add(ident)
        return out

    def init_states(self, tx):
        """Per held rank ``tx.init`` over its update slices. A slice several
        held ranks share has one state, its first holder's: the others'
        state tensors for it are that rank's tensors (their own ``tx.init``
        sees an empty placeholder there, so it allocates nothing)."""
        if needs_global_stats(tx):
            if self.loopback:  # one state on the whole leaves (_whole_update)
                return [tx.init(self.template)] * len(self.ranks)
            with leaf_views(self._leaf_views()):
                return [tx.init(tree_unflatten(self.template, [
                    torch.empty(layout.update_shape, dtype=self.local[i][next(iter(
                        self.local[i]))].dtype, device="meta")
                    for i, layout in enumerate(self.layouts)]))]
        leaders = [self._leaders(i) for i in range(len(self.layouts))]
        states = [tx.init(tree_unflatten(self.template, [
            torch.empty(layout.update_shape if leaders[i][j] else (0,),
                        dtype=self.local[i][next(iter(self.local[i]))].dtype, device="meta")
            for i, layout in enumerate(self.layouts)])) for j in range(len(self.ranks))]
        index = {layout.path.replace("/", "."): i for i, layout in enumerate(self.layouts)}
        first = {}
        for j, r in enumerate(self.ranks):
            for i in range(len(self.layouts)):
                first.setdefault((i, self.slice_id(i, r)), j)
        flat = [dict(flatten_with_paths(state)) for state in states]

        def leaf_of(path):
            """The leaf a state entry belongs to: "0.mu.layers.attn.wq" is
            leaf "layers.attn.wq"'s (None for the step count)."""
            parts = path.split(".")
            return next((index[k] for k in (".".join(parts[m:]) for m in range(len(parts)))
                         if k in index), None)

        def alias(j):
            def one(path, t):
                i = leaf_of(path)
                if i is None or leaders[i][j]:
                    return t
                return flat[first[(i, self.slice_id(i, self.ranks[j]))]][path]

            return one

        return [states[0]] + [map_with_paths(alias(j), states[j])
                              for j in range(1, len(self.ranks))]

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
                if all(self.coord(r)[a] == coord[a] for a in MESH_AXES if a != axis)]

    def _pieces(self, unit, layout):
        """The ``(ep index, tp index)`` of each piece of a leaf split over ep
        or tp that forward unit ``unit`` receives, ep major (every index in
        the loopback, the unit's own on a process group; 0 on an axis the
        leaf is not split over); None for a leaf split over neither."""
        if not any(a in layout.splits for a in PIECE_AXES):
            return None
        coord = self.coord(unit)
        e_idx, t_idx = ((range(self.sizes[a]) if self.loopback else (coord[a],))
                        if a in layout.splits else (0,) for a in PIECE_AXES)
        return [(e, t) for e in e_idx for t in t_idx]

    def stage_layer(self, i, layer, unit=None):
        """``(stage, local index)`` of global layer ``layer`` of leaf ``i``
        (stage 0 for a leaf not split over pp); a process group's rank
        holds only its own stage's layers."""
        layout = self.layouts[i]
        if layout.pp_dim is None:
            return 0, layer
        n = layout.local_shape[0]
        stage = layer // n
        if unit is not None and not self.loopback and stage != self.coord(unit)["pp"]:
            raise RuntimeError(f"layer {layer} of {layout.path} lies on pipeline stage "
                               f"{stage}; this rank holds stage {self.coord(unit)['pp']}")
        return stage, layer % n

    def gather(self, i, layer, unit, piece=None, dtype=None):
        """Leaf ``i`` (global layer ``layer`` of it, when not None) gathered
        over fsdp at ``dtype`` (the compute dtype) for forward unit
        ``unit``: one tensor, or for a leaf split over ep or tp a tuple of
        the unit's pieces (:meth:`_pieces`; only piece ``piece`` when
        given)."""
        layout = self.layouts[i]
        dtype = self.compute_dtype if dtype is None else dtype
        coord = self.coord(unit)
        stage, local = (0, None) if layer is None else self.stage_layer(i, layer, unit)

        def part(shard):
            t = shard if local is None else shard[local]
            return t.to(dtype)

        def one(e, t):
            if layout.fsdp_dim is None:
                return part(self.local[i][(stage, 0, e, t)])
            dim = layout.fsdp_dim - (layer is not None)
            if self.loopback:
                return torch.cat([part(self.local[i][(stage, j, e, t)])
                                  for j in range(self.sizes["fsdp"])], dim)
            return all_gather_along(part(self.local[i][(stage, coord["fsdp"], e, t)]), dim,
                                    self._group("fsdp"))

        pieces = self._pieces(unit, layout)
        if pieces is None:
            return one(0, 0)
        if piece is not None:
            return one(*pieces[piece])
        return tuple(one(e, t) for e, t in pieces)

    @torch.no_grad()
    def full_leaf(self, i, update_slices=None, shards=None):
        """Leaf ``i`` whole in f32, one leaf at a time on the device
        (checkpoints): from its base shards (or ``shards``, a dict laid out
        as ``local[i]``: the buffer's), or from ``update_slices``, per held
        rank its ZeRO slice (the moments)."""
        layout = self.layouts[i]
        base = self.local[i] if shards is None else shards
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
        if not layout.splits:
            return next(iter(base.values()))
        if self.loopback:
            def along(k, key):  # concatenated over SPLIT_AXES[k:], key fixing the others
                if k == len(SPLIT_AXES):
                    return base[key]
                axis = SPLIT_AXES[k]
                if axis not in layout.splits:
                    return along(k + 1, key + (0,))
                return torch.cat([along(k + 1, key + (j,)) for j in range(self.sizes[axis])],
                                 layout.splits[axis])

            return along(0, ())
        out = base[layout.key(self.coord(self.ranks[0]))]
        for axis in SPLIT_AXES:
            if axis in layout.splits:
                out = all_gather_along(out, layout.splits[axis], self._group(axis))
        return out

    # ----------------------------------------------------------- backward
    def reduce_grad(self, i, layer, unit, grads):
        """The backward of a gather: the f32 gradient summed over the ranks
        into the owning shard (banked in the loopback)."""
        layout = self.layouts[i]
        if self.loopback:
            if i not in self._bank:
                self._bank[i] = torch.zeros(layout.shape, dtype=torch.float32,
                                            device=grads[0].device)
            bank = self._bank[i] if layer is None else self._bank[i][layer]
            pieces = self._pieces(unit, layout)
            if pieces is None:
                bank.add_(grads[0].float())
                return
            for index, g in zip(pieces, grads):
                view = bank
                for axis, j in zip(PIECE_AXES, index):
                    if axis in layout.splits:
                        d = layout.splits[axis]
                        n = layout.local_shape[d]
                        view = view.narrow(d - (layer is not None), j * n, n)
                view.add_(g.float())
            return
        part = grads[0].float()
        if layout.fsdp_dim is not None:
            part = reduce_scatter_along(part, layout.fsdp_dim - (layer is not None),
                                        self._group("fsdp"))
        self._reduce(part, tuple(a for a in REDUCE_AXES if a not in layout.splits))
        local = None if layer is None else self.stage_layer(i, layer)[1]
        if self._pp_bank is not None and layout.pp_dim is None:
            # Summed over pp in end(): the stages that do not run this leaf
            # (1F1B's embedding and head) join that sum with zeros.
            bank = self._pp_bank.setdefault(i, torch.zeros_like(self.local[i][layout.key(
                self.coord(unit))], dtype=torch.float32))
            (bank if local is None else bank[local]).add_(part)
            return
        self._sink(i, local, layout.key(self.coord(unit)), part)

    def _pack(self, t):
        key = getattr(t, "_fsdp_regather", None)
        return ("regather", key) if key is not None else t

    def _unpack(self, packed):
        if isinstance(packed, tuple) and len(packed) == 2 and packed[0] == "regather":
            with torch.no_grad():
                return self.gather(*packed[1])
        return packed

    def rank_tree(self, unit, aliases, anchor):
        """The tree the model reads for forward unit ``unit``: replicated
        leaves as their (cast) aliases, sharded ones gathered on read."""
        leaves = []
        for i, layout in enumerate(self.layouts):
            if not layout.splits:
                a = aliases[i]
                leaves.append(a.to(self.compute_dtype) if a.is_floating_point() else a)
            elif self.stacked[i]:
                leaves.append(_StackedLeaf(self, i, unit, anchor))
            else:
                leaves.append(_Deferred(self, i, unit, anchor))
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
        self._pp_bank = {} if (self.pp_reduce and not self.loopback
                               and self.sizes["pp"] > 1) else None
        aliases = {i: self.local[i][(0, 0, 0, 0)].detach().requires_grad_(True)
                   for i, layout in enumerate(self.layouts) if not layout.splits}
        return aliases, torch.zeros((), requires_grad=True)

    def hooks(self):
        """The forward's context: with ``reshard_after_forward``, gathered
        tensors autograd keeps are dropped and gathered again on use."""
        if not self.reshard_after_forward:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def end(self, aliases):
        """After every forward unit's backward: the loopback's banked
        gradients scattered into the shards, and the replicated leaves'
        gradients (summed over dp, fsdp and sp on a process group), into
        the sink."""
        if self.loopback:
            for i, bank in self._bank.items():
                for key in self.local[i]:
                    self._sink(i, None, key, self.layouts[i].local_of_key(bank, key))
            self._bank = None
        if self._pp_bank is not None:  # every rank, every such leaf, in leaf order
            for i, layout in enumerate(self.layouts):
                if layout.splits and layout.pp_dim is None:
                    key = layout.key(self.coord(self.ranks[0]))
                    g = self._pp_bank.pop(i, None)
                    if g is None:
                        g = torch.zeros_like(self.local[i][key], dtype=torch.float32)
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=self._group("pp"))
                    self._sink(i, None, key, g)
            self._pp_bank = None
        for i, a in aliases.items():
            g = a.grad if a.grad is not None else torch.zeros_like(a)
            self._reduce(g)
            self._sink(i, None, (0, 0, 0, 0), g)
        self._sink = None

    def forward_backward(self, forward, sink):
        """Every forward unit's forward (``forward(unit, tree) -> loss``,
        its share of the global mean loss) and backward, the gradients
        summed over the ranks into ``sink`` (:meth:`begin`). Returns the
        loss summed over the units (and over dp, fsdp and sp)."""
        aliases, anchor = self.begin(sink)
        total = None
        for unit in self.units:
            with torch.enable_grad():
                with self.hooks():
                    loss = forward(unit, self.rank_tree(unit, aliases, anchor))
                torch.autograd.backward(loss)
            total = loss.detach() if total is None else total + loss.detach()
        self.end(aliases)
        return self._reduce(total)

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

    def _update_operands(self, i, every_rank=True):
        """Per held rank (or only per first holder of an update slice),
        ``(rank, p, g, in_place)``: the update slices of leaf i's parameter
        and buffer, copied out contiguous unless they are a base shard no
        other rank updates."""
        layout = self.layouts[i]
        keys = [layout.key(self.coord(r)) for r in self.ranks]
        leaders = self._leaders(i)
        out = []
        for rank, key, leader in zip(self.ranks, keys, leaders):
            if not (every_rank or leader):
                continue
            coord = self.coord(rank)
            p, g = self.local[i][key], self.accum[i][key]
            if layout.zero_dim is None and (keys.count(key) == 1 or not every_rank):
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
        optimizer state over its update slices (:meth:`init_states`).
        Returns the new states. The fused kernel runs once per distinct
        update slice of a leaf (module docstring) when ``plan`` is not
        None; else the reference chain runs per rank on copies of the
        slices."""
        if plan is None:
            if self.loopback and needs_global_stats(tx):
                return self._whole_update(tx, states, factor)
            return self._reference_update(tx, states, factor)
        per_rank = dict(zip(self.ranks, (fused_update_leaves(s, plan=plan) for s in states)))
        for i in range(len(self.layouts)):
            operands = self._update_operands(i, every_rank=False)
            for rank, p, g, _ in operands:
                moments, scalars, _ = per_rank[rank]
                dispatch("fused_update", p, g, () if moments is None else moments[i], factor,
                         *scalars, plan=plan, kernels=kernels)
            self._write_back(i, operands)
        return [per_rank[r][2] for r in self.ranks]

    def _leaf_views(self):
        """Per leaf (a tree like the parameters), how this process group
        rank's update slice lies in the global leaf (``optim.LeafView``):
        its global shape and, per split dim, the groups of the axes that
        split it (dp too on a ZeRO dim)."""
        views = []
        for layout in self.layouts:
            dims = {}
            for axis, d in layout.splits.items():
                dims.setdefault(d, []).append(self._group(axis))
            if layout.zero_dim is not None:
                dims.setdefault(layout.zero_dim, []).append(self._group("dp"))
            views.append(LeafView(layout.shape, dims))
        return tree_unflatten(self.template, views)

    def _whole_update(self, tx, states, factor):
        """The loopback's update under a transform with global statistics:
        the chain once on the whole leaves (assembled from the distinct
        shards, the buffer's too), the new leaves copied into every shard
        and the buffer zeroed. Every held rank shares the one state."""
        n = len(self.layouts)
        p_tree = tree_unflatten(self.template, [self.full_leaf(i) for i in range(n)])
        g_tree = tree_unflatten(self.template, [self.full_leaf(i, shards=self.accum[i])
                                                for i in range(n)])
        new_p, new_state, _ = reference_update_apply(p_tree, states[0], g_tree, tx=tx,
                                                     clip_factor=factor)
        del p_tree, g_tree
        for i, leaf in enumerate(tree_leaves(new_p)):
            self.load_full(i, leaf)
            for g in self.accum[i].values():
                g.zero_()
        return [new_state] * len(self.ranks)

    def _reference_update(self, tx, states, factor):
        operands = [self._update_operands(i) for i in range(len(self.layouts))]
        new_states = []
        views = self._leaf_views() if needs_global_stats(tx) else None
        for j, state in enumerate(states):
            p_tree = tree_unflatten(self.template, [ops[j][1] for ops in operands])
            g_tree = tree_unflatten(self.template, [ops[j][2] for ops in operands])
            with leaf_views(views):
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
        for key, shard in self.local[i].items():
            shard.copy_(layout.local_of_key(full, key))

    def update_slices_of(self, i, full):
        """Per held rank, rank's update slice of a full leaf (views)."""
        layout = self.layouts[i]
        return [layout.update_slice(layout.local(full, self.coord(r)), self.coord(r))
                for r in self.ranks]
