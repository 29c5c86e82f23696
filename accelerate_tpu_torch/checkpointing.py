"""Checkpoint save and load — the counterpart of ``accelerate_tpu/checkpointing.py``.

``Accelerator.save_state`` / ``load_state`` write and read the JAX package's
folder layout under its file names::

    <output_dir>/
        model/  model_1/ ...        each prepared model's parameters
        optimizer/  optimizer_1/    each optimizer's state (when it has one)
        optimizer.meta.pkl          {"step_count", "scale"}
        manifest.json               {"items": [...], "mesh": {...}}
        scheduler.bin               {"step_count", "last_lr"}
        sampler.bin  sampler_1.bin  each prepared loader's resume position
        custom_checkpoint_<i>.pkl   each registered object's state_dict()
        random_states_<rank>.pkl    python and numpy streams, the micro-step,
                                    each model's dropout generator

with ``checkpoints/checkpoint_<i>`` naming and ``total_limit`` rotation under
``ProjectConfiguration(automatic_checkpoint_naming=True)``, the newest
complete checkpoint chosen by ``load_state()``, and the mesh record that
refuses a checkpoint of another layout unless ``reshard=True``.

**The array payload differs from the JAX package's, by design.** There each
``model`` / ``optimizer`` item is an orbax (tensorstore) checkpoint
directory: every process writes its own shards of global arrays. The port has
neither orbax nor tensorstore (nor the ``safetensors`` package on the card's
machine), and its ranks hold whole replicas, so each item is a directory
holding one safetensors file (``arrays.safetensors``, written by
``utils/safetensors_io.py``) under the JAX package's keys: the dotted paths
of the parameter tree or optimizer state (``layers.wq``, ``0.mu.layers.wq``,
``0.count``). An item is written into ``<item>.checkpoint-tmp-<pid>`` and
renamed when complete, as orbax commits its items, so a folder whose listed
items are not all there, or that holds a temporary directory, is incomplete.
The host pickles hold only Python and numpy objects, so each package reads
the other's. ``save_model``'s safetensors export is the JAX package's,
file for file.

``blocking=False`` copies every array to pinned host memory on a side stream
and waits for that copy before it returns (the fused update writes the
parameters and moments in place, so a writer reading the live tensors later
would save the next step's values), then writes the files on a background
thread. :func:`finish_pending_saves` joins the writers and raises if one
failed; ``load_state``, automatic naming and ``end_training`` join first,
and an ``atexit`` hook joins whatever is left.

**Sharded state** (``parallel/fsdp.py``: fsdp, ZeRO, a loopback) is saved
in the full layout, so a checkpoint does not depend on the mesh that wrote
it: every rank joins the gathers of one leaf at a time (parameters from
their base shards, moments from their ZeRO slices), so no rank holds the
whole model on its device, and the main process writes the full host
arrays. ``load_state`` slices each rank's shards out of the full arrays.
The mesh record holds the axes (``dp``, ``fsdp``, ``sp``), the dp x fsdp
degree and ``zero_sharding``; with ``reshard=True`` a checkpoint of another
mesh (fsdp 4 into one unsharded process, and back) loads, its accumulation
rescaled by the data-parallel degree.

Not ported yet: the JAX package's goodput ledger and fault-injection hooks
of ``save_state`` (they wait for ``resilience/``), the fp16 scaler's
``scale`` (a checkpoint that holds one raises) and the msgpack export
(``safe_serialization=False``).
"""

from __future__ import annotations

import atexit
import json
import os
import pickle
import random
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .logging import get_logger
from .utils.constants import (
    CHECKPOINT_DIR_PREFIX,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    SAMPLER_NAME,
    SCHEDULER_NAME,
)
from .utils.safetensors_io import load_file, save_file
from .parallel.sharding import data_parallel_degree
from .utils.tree import flatten_with_paths, map_with_paths, tree_unflatten

logger = get_logger(__name__)

PAYLOAD_NAME = "arrays.safetensors"  # the one file inside a model/optimizer item
TMP_MARK = "checkpoint-tmp"  # in the port's (and orbax's) uncommitted item names

_PENDING_SAVES: list = []


class _BackgroundWrite:
    """One thread writing the items of one ``save_state(blocking=False)``
    from their host copies; :meth:`join` raises what the write raised."""

    def __init__(self, items):
        self.error = None
        self.seconds = None  # the write's own duration, once it is done
        self.thread = threading.Thread(target=self._run, args=(items,),
                                       name="checkpoint-writer")
        self.thread.start()

    def _run(self, items):
        t0 = time.perf_counter()
        try:
            for path, tensors in items:
                _commit_item(path, tensors)
        except Exception as e:  # handed to join(), never dropped
            self.error = e
        self.seconds = time.perf_counter() - t0

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"a background checkpoint write failed: {self.error!r}") \
                from self.error


def finish_pending_saves():
    """Wait for every queued background write; raise if any failed (after
    joining them all)."""
    errors = []
    while _PENDING_SAVES:
        try:
            _PENDING_SAVES.pop(0).join()
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]


# A script that exits right after save_state(blocking=False) must not lose
# the writes still running; Accelerator.end_training() is the polite join.
atexit.register(finish_pending_saves)


def _reap_pending(max_pending: int = 4):
    """Join the oldest background writes beyond ``max_pending``."""
    while len(_PENDING_SAVES) > max_pending:
        _PENDING_SAVES.pop(0).join()


def _tensor_items(tree) -> list:
    return [(k, v) for k, v in flatten_with_paths(tree) if isinstance(v, torch.Tensor)]


def _host_copies(tree) -> dict:
    """Every tensor of ``tree`` copied to host memory before this returns:
    CUDA tensors into pinned buffers on a side stream that first waits for
    the work already queued (so the copy sees the last step's values), then
    is synchronised; CPU tensors cloned."""
    items = _tensor_items(tree)
    cuda = [t for _, t in items if t.is_cuda]
    if not cuda:
        return {k: t.detach().clone() for k, t in items}
    device = cuda[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    out = {}
    with torch.cuda.stream(side):
        for k, t in items:
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.detach().clone()
            out[k] = host
    side.synchronize()
    return out


def _commit_item(path: str, tensors: dict):
    """Write one item directory: into a temporary name, renamed when done."""
    tmp = f"{path}.{TMP_MARK}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_file(tensors, os.path.join(tmp, PAYLOAD_NAME))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_accelerator_state(accelerator, output_dir: str | None = None,
                           safe_serialization: bool = True, blocking: bool = True):
    """Save everything ``accelerator`` prepared or registered (module
    docstring) into ``output_dir``, or into the next
    ``checkpoints/checkpoint_<i>`` under automatic naming; returns the
    folder. ``blocking=False`` returns once every array is copied to the
    host, and writes the model and optimizer items on a background thread
    (join with :func:`finish_pending_saves`). ``safe_serialization`` is
    kept for the API: the arrays are safetensors either way, as the JAX
    package's are orbax either way."""
    project = accelerator.project_configuration
    if output_dir is None:
        if project.automatic_checkpoint_naming:
            output_dir = os.path.join(accelerator.project_dir, "checkpoints")
        else:
            raise ValueError("output_dir required unless automatic_checkpoint_naming is set")
    output_dir = os.path.abspath(output_dir)
    _reap_pending()
    if project.automatic_checkpoint_naming:
        # Every rank joins its writes and meets the others before rank 0
        # rotates: rotation must never delete a folder still being written.
        finish_pending_saves()
        accelerator.wait_for_everyone()
        if project.total_limit is not None and accelerator.is_main_process:
            folders = [f for f in (os.listdir(output_dir) if os.path.isdir(output_dir) else [])
                       if f.startswith(f"{CHECKPOINT_DIR_PREFIX}_")]
            # Incomplete folders go first, so rotation never counts them
            # against (and deletes) the complete ones a resume needs.
            complete = []
            for f in folders:
                if _checkpoint_complete(os.path.join(output_dir, f), accelerator):
                    complete.append(f)
                else:
                    logger.warning(f"Rotating out incomplete checkpoint {f}")
                    shutil.rmtree(os.path.join(output_dir, f), ignore_errors=True)
            if len(complete) + 1 > project.total_limit:
                complete.sort(key=lambda f: int(f.rsplit("_", 1)[-1]))
                for stale in complete[: len(complete) + 1 - project.total_limit]:
                    shutil.rmtree(os.path.join(output_dir, stale), ignore_errors=True)
        output_dir = os.path.join(output_dir, f"{CHECKPOINT_DIR_PREFIX}_{project.iteration}")
        if os.path.isdir(output_dir):
            raise ValueError(f"Checkpoint directory {output_dir} already exists.")
    accelerator.wait_for_everyone()
    main = accelerator.is_main_process
    if main:
        os.makedirs(output_dir, exist_ok=True)
    accelerator.wait_for_everyone()

    # Rank 0 writes the arrays: replicas as they are, sharded state gathered.
    items, expected_items = [], []
    for i, model in enumerate(accelerator._models):
        name = f"{MODEL_NAME}{'' if i == 0 else f'_{i}'}"
        engine = model.handle.sharded
        items.append((os.path.join(output_dir, name), model.handle.params) if engine is None
                     else (os.path.join(output_dir, name),
                           dict(flatten_with_paths(full_host_params(engine))), True))
        expected_items.append(name)
    for i, opt in enumerate(accelerator._optimizers):
        suffix = "" if i == 0 else f"_{i}"
        if opt.opt_state is not None:
            engine = None if opt.handle is None else opt.handle.sharded
            path = os.path.join(output_dir, f"{OPTIMIZER_NAME}{suffix}")
            items.append((path, opt.opt_state) if engine is None
                         else (path, full_host_opt_state(engine, opt), True))
            expected_items.append(f"{OPTIMIZER_NAME}{suffix}")
        _host_pickle(os.path.join(output_dir, f"{OPTIMIZER_NAME}{suffix}.meta.pkl"),
                     {"step_count": int(opt._step_count),
                      "scale": opt.scaler.scale if opt.scaler is not None else None},
                     accelerator)
    # The listed items, and the mesh record a load compares with its own.
    if main:
        with open(os.path.join(output_dir, "manifest.json"), "w") as f:
            json.dump({"items": expected_items, "mesh": _mesh_record(accelerator)}, f)
        # (path, tree) or, gathered to the host already, (path, arrays, True).
        snapshot = [(item[0], item[1] if len(item) == 3 else _host_copies(item[1]))
                    for item in items]
        if blocking:
            for path, tensors in snapshot:
                _commit_item(path, tensors)
        else:
            _PENDING_SAVES.append(_BackgroundWrite(snapshot))
    if blocking:
        finish_pending_saves()
    for i, sched in enumerate(accelerator._schedulers):
        suffix = "" if i == 0 else f"_{i}"
        _host_pickle(os.path.join(output_dir, f"{SCHEDULER_NAME}{suffix}.bin"),
                     sched.state_dict(), accelerator)
    for i, dl in enumerate(accelerator._dataloaders):
        suffix = "" if i == 0 else f"_{i}"
        if hasattr(dl, "state_dict"):
            _host_pickle(os.path.join(output_dir, f"{SAMPLER_NAME}{suffix}.bin"),
                         dl.state_dict(), accelerator)
    for i, obj in enumerate(accelerator._custom_objects):
        _host_pickle(os.path.join(output_dir, f"custom_checkpoint_{i}.pkl"), obj.state_dict(),
                     accelerator)
    rng_state = {"python": random.getstate(), "numpy": np.random.get_state(),
                 "step": accelerator.step}
    for i, model in enumerate(accelerator._models):
        rng_state[f"model_{i}_generator"] = model.handle.generator.get_state().numpy().tobytes()
    _host_pickle(os.path.join(output_dir, f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl"),
                 rng_state, accelerator, all_processes=True)
    if project.automatic_checkpoint_naming:
        project.iteration += 1
    logger.info(f"Saved accelerator state to {output_dir}")
    return output_dir


def _host_pickle(path, obj, accelerator, all_processes: bool = False):
    if accelerator.is_main_process or all_processes:
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def _mesh_record(accelerator) -> dict:
    """The mesh's axis sizes, the process count, the dp x fsdp degree, the
    accumulation and whether ZeRO engaged: what decides whether a checkpoint
    loads as it is."""
    axes = accelerator.mesh_sizes
    return {"axes": {name: int(size) for name, size in axes.items()},
            "process_count": int(accelerator.num_processes),
            "data_parallel": int(data_parallel_degree(axes)),
            "gradient_accumulation_steps": int(accelerator.gradient_accumulation_steps),
            "zero_sharding": bool(any(o.zero_active for o in accelerator._optimizers))}


def _axes_key(axes: dict) -> dict:
    """A record's axes without those of size 1 (a record written before an
    axis existed reads as that axis of size 1)."""
    return {k: int(v) for k, v in axes.items() if int(v) != 1}


def full_host_params(engine) -> dict:
    """A sharded model's parameters in the full layout, on the host: every
    rank joins each leaf's gather in turn; only the main process keeps the
    copies (the others get an empty tree's leaves as None)."""
    keep = _is_main()
    leaves = []
    for i in range(len(engine.layouts)):
        full = engine.full_leaf(i)
        leaves.append(full.detach().cpu().clone() if keep else None)
        del full
    return tree_unflatten(engine.template, leaves)


def _moment_leaf(engine, path, leaf):
    """The parameter leaf index whose update slice ``leaf`` (an optimizer
    state tensor at ``path``) mirrors, or None (a count, a scalar)."""
    for i, layout in enumerate(engine.layouts):
        dotted = layout.path.replace("/", ".")
        if (path == dotted or path.endswith("." + dotted)) and \
                list(leaf.shape) == layout.update_shape:
            return i
    return None


def _check_whole_leaf_state(engine, opt):
    """A transform with whole-leaf statistics (adafactor) keeps, on a
    process group, factored rows and columns of each rank's slice, which
    the full layout cannot be assembled from yet; a loopback keeps the
    whole leaves' state, which is the full layout."""
    from .optim import needs_global_stats

    if not engine.loopback and needs_global_stats(opt.tx) and any(
            layout.splits for layout in engine.layouts):
        raise NotImplementedError(
            "the optimizer state of a transform with whole-leaf statistics (adafactor) on "
            "process-group shards is not checkpointed yet (ROADMAP.md, Queue 1: what pp "
            "still lacks)")


def full_host_opt_state(engine, opt) -> dict:
    """A sharded optimizer's state in the full layout, on the host, keyed
    as the unsharded state's safetensors item (``0.mu.layers.wq``)."""
    _check_whole_leaf_state(engine, opt)
    per_rank = [dict(flatten_with_paths(s)) for s in opt.rank_states]
    out = {}
    keep = _is_main()
    for path, leaf in per_rank[0].items():
        if not isinstance(leaf, torch.Tensor):
            continue
        i = _moment_leaf(engine, path, leaf)
        # An offloaded state lies on the host: gather its slices on the device.
        dev = next(iter(engine.local[0].values())).device
        full = leaf if i is None else engine.full_leaf(i, [s[path].to(dev) for s in per_rank])
        if keep:
            out[path] = full.detach().cpu().clone()
        del full
    return out


def _is_main() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _load_sharded_params(engine, tensors: dict, where: str):
    expected = {p.replace("/", ".") for p in engine.paths}
    missing, extra = sorted(expected - set(tensors)), sorted(set(tensors) - expected)
    if missing or extra:
        raise KeyError(f"{where}: keys missing from the checkpoint {missing[:5]}, keys the "
                       f"live state lacks {extra[:5]}")
    for i, layout in enumerate(engine.layouts):
        src = tensors[layout.path.replace("/", ".")]
        if tuple(src.shape) != layout.shape:
            raise ValueError(f"{where}: {layout.path} is {tuple(src.shape)} in the "
                             f"checkpoint, {layout.shape} live")
        with torch.no_grad():
            engine.load_full(i, src.to(next(iter(engine.local[i].values())).device))


def _load_sharded_opt_state(engine, opt, tensors: dict, where: str):
    _check_whole_leaf_state(engine, opt)
    per_rank = [dict(flatten_with_paths(s)) for s in opt.rank_states]
    keys = {k for k, v in per_rank[0].items() if isinstance(v, torch.Tensor)}
    missing, extra = sorted(keys - set(tensors)), sorted(set(tensors) - keys)
    if missing or extra:
        raise KeyError(f"{where}: keys missing from the checkpoint {missing[:5]}, keys the "
                       f"live state lacks {extra[:5]}")
    with torch.no_grad():
        for path in keys:
            leaf = per_rank[0][path]
            src = tensors[path].to(leaf.device)
            i = _moment_leaf(engine, path, leaf)
            parts = [src] * len(per_rank) if i is None else engine.update_slices_of(i, src)
            for state, part in zip(per_rank, parts):
                if tuple(part.shape) != tuple(state[path].shape):
                    raise ValueError(f"{where}: {path} is {tuple(src.shape)} in the "
                                     "checkpoint, which does not hold the live slices")
                state[path].copy_(part)


def rescaled_accumulation(accum: int, old_dp: int, new_dp: int, *, context: str) -> int:
    """The accumulation that keeps ``per-rank batch x dp x accum`` (the
    samples per update) when dp changes, or ValueError when none does (the
    JAX package's ``resilience/elastic.py:101``)."""
    accum, old_dp, new_dp = int(accum), int(old_dp), int(new_dp)
    if old_dp == new_dp:
        return accum
    scaled = accum * old_dp
    if scaled % new_dp != 0:
        raise ValueError(
            f"{context} dp {old_dp} -> {new_dp} cannot preserve the global "
            f"batch: accumulation {accum} x dp {old_dp} = {scaled} "
            f"micro-gradients per update is not divisible by the new dp "
            f"degree. Use a dp that divides {scaled}, or change the global "
            "batch deliberately."
        )
    return scaled // new_dp


def _check_mesh_compatible(input_dir: str, accelerator, reshard: bool):
    """Compare the checkpoint's mesh record with this job's: silent when
    they match (or there is none), an error on a mismatch unless
    ``reshard=True``, which rescales the accumulation to keep the global
    batch."""
    manifest_path = os.path.join(input_dir, "manifest.json")
    if not os.path.isfile(manifest_path):
        return
    try:
        with open(manifest_path) as f:
            saved = json.load(f).get("mesh")
    except (OSError, ValueError):
        return
    if not saved:
        return
    current = _mesh_record(accelerator)
    if (_axes_key(saved["axes"]) == _axes_key(current["axes"])
            and saved.get("process_count") == current["process_count"]):
        return
    if reshard:
        _rescale_accumulation(accelerator, saved, current)
        logger.warning(f"Resharding checkpoint {os.path.basename(input_dir)}: written under "
                       f"mesh {saved['axes']}, restoring onto {current['axes']}.")
        return
    raise RuntimeError(
        f"Checkpoint {input_dir} was written under mesh {saved['axes']} "
        f"({saved.get('process_count', '?')} process(es), "
        f"dp={saved.get('data_parallel', '?')}) but the current mesh is "
        f"{current['axes']} ({current['process_count']} process(es), "
        f"dp={current['data_parallel']}): resharding is required. Pass "
        "load_state(..., reshard=True) to load it onto the current layout.")


def _rescale_accumulation(accelerator, saved: dict, current: dict):
    saved_dp = saved.get("data_parallel")
    saved_accum = saved.get("gradient_accumulation_steps")
    if not saved_dp or not saved_accum:
        return
    new_accum = rescaled_accumulation(saved_accum, saved_dp, current["data_parallel"],
                                      context="Cross-mesh restore")
    if new_accum != accelerator.gradient_accumulation_steps:
        logger.warning(
            f"Cross-mesh restore: gradient accumulation "
            f"{accelerator.gradient_accumulation_steps} -> {new_accum} "
            f"(save-time {saved_accum} x dp {saved_dp} / dp "
            f"{current['data_parallel']}; global batch preserved).")
        accelerator.gradient_state.num_steps = new_accum


def _checkpoint_complete(path: str, accelerator) -> bool:
    """Whether every array item of this checkpoint folder was committed: no
    temporary item directory is left, and every item ``manifest.json``
    lists exists (without a manifest, every model item)."""
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    if any(TMP_MARK in e for e in entries):
        return False
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.isfile(manifest_path):
        try:
            with open(manifest_path) as f:
                items = json.load(f)["items"]
        except (OSError, ValueError, KeyError):
            return False
        return all(os.path.isdir(os.path.join(path, item)) for item in items)
    for i, _ in enumerate(accelerator._models):
        if not os.path.isdir(os.path.join(path, f"{MODEL_NAME}{'' if i == 0 else f'_{i}'}")):
            return False
    return True


def _load_into(tree, tensors: dict, where: str):
    """Copy each stored tensor into the leaf of ``tree`` at its key, in
    place (so every reference to the leaf sees it); the stored shape and
    dtype must be the leaf's. Returns ``tree``'s structure rebuilt."""
    expected = {k for k, _ in _tensor_items(tree)}
    missing, extra = sorted(expected - set(tensors)), sorted(set(tensors) - expected)
    if missing or extra:
        raise KeyError(f"{where}: keys missing from the checkpoint {missing[:5]}, keys the "
                       f"live state lacks {extra[:5]}")

    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        src = tensors[path]
        if tuple(src.shape) != tuple(leaf.shape) or src.dtype != leaf.dtype:
            raise ValueError(f"{where}: {path} is {src.dtype}{tuple(src.shape)} in the "
                             f"checkpoint, {leaf.dtype}{tuple(leaf.shape)} live")
        with torch.no_grad():
            leaf.copy_(src)
        return leaf

    return map_with_paths(put, tree)


def load_accelerator_state(accelerator, input_dir: str | None = None, reshard: bool = False,
                           **kwargs):
    """Load what :func:`save_accelerator_state` wrote into the prepared
    objects, in place; with no ``input_dir`` under automatic naming, the
    newest complete ``checkpoint_<i>`` (incomplete ones are deleted, and the
    next save goes after the one loaded). Returns the folder."""
    finish_pending_saves()  # never load a folder this process is still writing
    project = accelerator.project_configuration
    if input_dir is None:
        if not project.automatic_checkpoint_naming:
            raise ValueError("input_dir required unless automatic_checkpoint_naming is set")
        base = os.path.join(accelerator.project_dir, "checkpoints")
        folders = sorted((f for f in os.listdir(base) if f.startswith(f"{CHECKPOINT_DIR_PREFIX}_")),
                         key=lambda f: int(f.rsplit("_", 1)[-1]))
        incomplete = []
        for f in reversed(folders):
            candidate = os.path.join(base, f)
            if _checkpoint_complete(candidate, accelerator):
                input_dir = candidate
                break
            logger.warning(f"Skipping incomplete checkpoint {candidate}")
            incomplete.append(candidate)
        if accelerator.is_main_process:
            for junk in incomplete:
                shutil.rmtree(junk, ignore_errors=True)
        accelerator.wait_for_everyone()
        if input_dir is None:
            project.iteration = 0
            raise FileNotFoundError(f"No complete checkpoint found under {base}")
        project.iteration = int(os.path.basename(input_dir).rsplit("_", 1)[-1]) + 1
    input_dir = os.path.abspath(input_dir)
    _check_mesh_compatible(input_dir, accelerator, reshard)

    for i, model in enumerate(accelerator._models):
        name = f"{MODEL_NAME}{'' if i == 0 else f'_{i}'}"
        tensors = load_file(os.path.join(input_dir, name, PAYLOAD_NAME))
        if model.handle.sharded is not None:
            _load_sharded_params(model.handle.sharded, tensors, name)
        else:
            _load_into(model.handle.params, tensors, name)
    for i, opt in enumerate(accelerator._optimizers):
        suffix = "" if i == 0 else f"_{i}"
        opt_dir = os.path.join(input_dir, f"{OPTIMIZER_NAME}{suffix}")
        if os.path.isdir(opt_dir):
            opt._ensure_initialized()
            tensors = load_file(os.path.join(opt_dir, PAYLOAD_NAME))
            if opt.handle.sharded is not None:
                _load_sharded_opt_state(opt.handle.sharded, opt, tensors,
                                        f"{OPTIMIZER_NAME}{suffix}")
            else:
                opt.opt_state = _load_into(opt.opt_state, tensors, f"{OPTIMIZER_NAME}{suffix}")
        meta_path = os.path.join(input_dir, f"{OPTIMIZER_NAME}{suffix}.meta.pkl")
        if os.path.isfile(meta_path):
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            opt._step_count = int(meta.get("step_count", 0))
            if opt.scaler is not None and meta.get("scale"):  # JAX checkpointing.py:450
                opt.scaler.scale = float(meta["scale"])
    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, f"{SCHEDULER_NAME}{'' if i == 0 else f'_{i}'}.bin")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                sched.load_state_dict(pickle.load(f))
    for i, dl in enumerate(accelerator._dataloaders):
        path = os.path.join(input_dir, f"{SAMPLER_NAME}{'' if i == 0 else f'_{i}'}.bin")
        if os.path.isfile(path) and hasattr(dl, "load_state_dict"):
            with open(path, "rb") as f:
                dl.load_state_dict(pickle.load(f))
    for i, obj in enumerate(accelerator._custom_objects):
        path = os.path.join(input_dir, f"custom_checkpoint_{i}.pkl")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                obj.load_state_dict(pickle.load(f))
    rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl")
    if not os.path.isfile(rng_path) and reshard:
        # A rank the saving job did not have takes rank 0's streams.
        fallback = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
        if os.path.isfile(fallback):
            logger.warning(f"No RNG state for process {accelerator.process_index} in "
                           f"{input_dir} (written by a smaller world); restoring rank 0's.")
            rng_path = fallback
    if os.path.isfile(rng_path):
        with open(rng_path, "rb") as f:
            rng_state = pickle.load(f)
        random.setstate(rng_state["python"])
        np.random.set_state(rng_state["numpy"])
        accelerator.step = rng_state.get("step", 0)
        for i, model in enumerate(accelerator._models):
            raw = rng_state.get(f"model_{i}_generator")
            if raw is not None:
                model.handle.generator.set_state(
                    torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy()))
    logger.info(f"Loaded accelerator state from {input_dir}")
    return input_dir


# ------------------------------------------------------------- model exports
def parse_shard_size(max_shard_size) -> int:
    """Bytes of ``"10GB"``, ``"200MB"``, ``"1GiB"`` or an int."""
    if isinstance(max_shard_size, int):
        return max_shard_size
    units = {"KB": 10**3, "MB": 10**6, "GB": 10**9, "KIB": 2**10, "MIB": 2**20, "GIB": 2**30}
    s = str(max_shard_size).upper().replace(" ", "")
    for unit, mult in units.items():
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * mult)
    return int(s)


def save_model(accelerator, model, save_directory, max_shard_size="10GB",
               safe_serialization=True):
    """The model's parameters as one safetensors file, or shards of at most
    ``max_shard_size`` bytes with an index, written by the main process."""
    params = accelerator.get_state_dict(model)
    if accelerator.is_main_process:
        export_full_weights(params, save_directory, max_shard_size=max_shard_size,
                            safe_serialization=safe_serialization)
    accelerator.wait_for_everyone()


def export_full_weights(params, save_directory, max_shard_size="10GB",
                        safe_serialization=True):
    """Write a parameter tree (host tensors) as the JAX package's export:
    ``model.safetensors``, or ``model-0000i-of-0000n.safetensors`` filled in
    key order up to ``max_shard_size`` with ``model.safetensors.index.json``
    (``metadata.total_size``, ``weight_map``)."""
    if not safe_serialization:
        raise NotImplementedError("the msgpack export (safe_serialization=False) needs flax's "
                                  "serializer and is not ported; export safetensors")
    os.makedirs(save_directory, exist_ok=True)
    flat = dict(flatten_with_paths(params))
    limit = parse_shard_size(max_shard_size)
    nbytes = {k: v.numel() * v.element_size() for k, v in flat.items()}
    shards, current, size = [], {}, 0
    for key, val in flat.items():
        if current and size + nbytes[key] > limit:
            shards.append(current)
            current, size = {}, 0
        current[key] = val
        size += nbytes[key]
    if current:
        shards.append(current)
    if len(shards) == 1:
        save_file(shards[0], os.path.join(save_directory, SAFE_WEIGHTS_NAME))
        return
    index = {"metadata": {"total_size": sum(nbytes.values())}, "weight_map": {}}
    for i, shard in enumerate(shards):
        name = SAFE_WEIGHTS_NAME.replace(".safetensors",
                                         f"-{i + 1:05d}-of-{len(shards):05d}.safetensors")
        save_file(shard, os.path.join(save_directory, name))
        for key in shard:
            index["weight_map"][key] = name
    with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)


def load_model_weights(save_directory, template_params):
    """The inverse of :func:`save_model`: the (possibly sharded) export read
    into the structure of ``template_params``, each tensor in its stored
    dtype on its template leaf's device."""
    save_directory = Path(save_directory)
    flat = {}
    index_file = save_directory / SAFE_WEIGHTS_INDEX_NAME
    if index_file.is_file():
        index = json.loads(index_file.read_text())
        for name in sorted(set(index["weight_map"].values())):
            flat.update(load_file(save_directory / name))
    elif (save_directory / SAFE_WEIGHTS_NAME).is_file():
        flat.update(load_file(save_directory / SAFE_WEIGHTS_NAME))
    else:
        raise FileNotFoundError(f"no {SAFE_WEIGHTS_NAME} or {SAFE_WEIGHTS_INDEX_NAME} in "
                                f"{save_directory} (the msgpack export is not ported)")

    def take(key, leaf):
        if key not in flat:
            raise KeyError(f"weight {key} missing from checkpoint {save_directory}")
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return flat[key].to(device)

    return map_with_paths(take, template_params)


def save_custom_state(obj, path, index: int = 0):
    with open(os.path.join(path, f"custom_checkpoint_{index}.pkl"), "wb") as f:
        pickle.dump(obj.state_dict(), f)


def load_custom_state(obj, path, index: int = 0):
    with open(os.path.join(path, f"custom_checkpoint_{index}.pkl"), "rb") as f:
        obj.load_state_dict(pickle.load(f))
