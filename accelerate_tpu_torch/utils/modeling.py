"""Model-placement algorithms: size accounting, memory budgets, the placement
planner and checkpoint loading — the counterpart of
``accelerate_tpu/utils/modeling.py``.

The planning algorithms are the JAX package's, line for line: a "module" is a
prefix of the parameter tree's dotted names (``layers``, ``embed``, ...), and
a placement target is an entry of ``{"cuda:0": bytes, ..., "cpu": bytes,
"disk": inf}``, cards first, then host memory, then disk. The JAX package
names its chips ``tpu:i``; the port names its cards ``cuda:i``, so the same
tree under the same budgets gives the same map with ``tpu:i`` read as
``cuda:i``.

Parameters may be ``meta`` tensors (``big_modeling.init_empty_weights``): the
planner reads only shapes and dtypes, so planning an 8B model costs no
memory, as ``jax.eval_shape`` does in the JAX package.

The budgets are the card's: ``torch.cuda.get_device_properties(i).
total_memory`` with the JAX package's 0.9 headroom, where the JAX package
reads the TPU's ``memory_stats`` or its per-generation table.

Checkpoints are read through ``utils/safetensors_io.py`` lazily, one memory
map a tensor, so a 16 GB checkpoint is not read into host memory before it
is placed. The JAX package's flax msgpack format is not read here.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
import re
from collections import defaultdict
from typing import Mapping

import numpy as np
import torch

from .constants import SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME
from .device import resolve_device
from .safetensors_io import load_file_lazy
from .tree import flatten_with_paths, map_with_paths

logger = logging.getLogger(__name__)

# Planners budget 90% of a card's memory, the JAX package's headroom.
HBM_HEADROOM = 0.9
OFFLOAD_TARGETS = ("cpu", "disk")


# --------------------------------------------------------------------------- sizes
def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch dtype, a numpy dtype or a dtype name
    (sub-byte names like ``int4`` give fractions, ``bool`` 1/8, as in the
    JAX package)."""
    if isinstance(dtype, torch.dtype):
        dtype_str = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        dtype_str = dtype
    else:
        dtype_str = str(np.dtype(dtype))
    if dtype_str == "bool":
        return 1 / 8
    m = re.search(r"[^\d](\d+)(_\w+)?$", dtype_str)
    if m is None:
        raise ValueError(f"`dtype` is not a valid dtype: {dtype}.")
    return int(m.group(1)) / 8


def named_parameters(params, prefix: str = "") -> dict:
    """The parameter tree as ``{'a.b.c': leaf}``, the JAX package's dotted
    names. A ``QuantizedTensor`` is one leaf."""
    return {prefix + key: leaf for key, leaf in flatten_with_paths(params)}


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


def _leaf_nbytes(leaf) -> int:
    if not isinstance(leaf, torch.Tensor):  # a QuantizedTensor: its data and scales
        return int(leaf.nbytes)
    size = dtype_byte_size(leaf.dtype)
    return int(_numel(leaf.shape) * size) if leaf.dim() else int(size)


def compute_module_sizes(params, dtype=None, special_dtypes: Mapping | None = None) -> dict:
    """Bytes of every name prefix: each parameter's size is charged to all
    its ancestors and to ``""``, the whole tree."""
    sizes: dict[str, int] = defaultdict(int)
    for name, leaf in named_parameters(params).items():
        if special_dtypes is not None and name in special_dtypes:
            size = int(_numel(leaf.shape) * dtype_byte_size(special_dtypes[name]))
        elif dtype is not None:
            size = int(_numel(leaf.shape) * dtype_byte_size(dtype))
        else:
            size = _leaf_nbytes(leaf)
        sizes[""] += size
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            sizes[".".join(parts[:i])] += size
    return dict(sizes)


def compute_module_total_buffer_size(params, dtype=None) -> int:
    """The models keep no buffers beside their parameters, so 0 (the JAX
    package's answer)."""
    return 0


def calculate_maximum_sizes(params):
    """``(total bytes, (largest block's bytes, its name))``."""
    sizes = compute_module_sizes(params)
    total = sizes.get("", 0)
    largest = max(((sizes[b], b) for b in get_top_level_blocks(params)), default=(total, ""))
    return total, largest


# ----------------------------------------------------------------------- structure
def get_top_level_blocks(params) -> list[str]:
    """The placement granularity: ``name.<i>`` for a numbered child (a list
    of blocks), else the first name component. Stacked layers (one leaf a
    kind, a leading layer axis) are therefore one block, ``layers``."""
    blocks: list[str] = []
    seen = set()
    for name in named_parameters(params):
        parts = name.split(".")
        block = ".".join(parts[:2]) if len(parts) >= 2 and parts[1].isdigit() else parts[0]
        if block not in seen:
            seen.add(block)
            blocks.append(block)
    return blocks


def _tie_key(leaf):
    """Leaves are tied when they are one tensor, or the same view of the same
    memory (a ``meta`` tensor has none, so only its identity counts)."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        start = leaf.untyped_storage().data_ptr() + leaf.storage_offset() * leaf.element_size()
        return (str(leaf.device), start, tuple(leaf.shape), leaf.stride(), leaf.dtype)
    return id(leaf)


def find_tied_parameters(params) -> list[list[str]]:
    """Groups of names that hold one underlying tensor."""
    groups: dict = defaultdict(list)
    for name, leaf in named_parameters(params).items():
        groups[_tie_key(leaf)].append(name)
    return [sorted(group) for group in groups.values() if len(group) > 1]


# ------------------------------------------------------------------ device memory
def device_hbm_bytes(device=None) -> int:
    """A card's memory in bytes (``total_memory``); ``None`` is the current
    card. The denominator of the planner's budgets."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_hbm_bytes reads a CUDA device's memory, got {dev}")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def get_max_memory(max_memory: Mapping | None = None) -> dict:
    """Memory a target may take: the given budgets in bytes (``"10GB"`` and
    ``"1GiB"`` strings converted), or every card at 90% of its memory and
    then 90% of host memory. Without a card only ``cpu`` is listed; disk
    is unbounded and implied."""
    if max_memory is not None:
        return {key: convert_file_size_to_int(val) if isinstance(val, str) else int(val)
                for key, val in max_memory.items()}
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = int(device_hbm_bytes(f"cuda:{i}") * HBM_HEADROOM)
    try:
        host_bytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):  # pragma: no cover
        host_bytes = 64 << 30
    out["cpu"] = int(host_bytes * HBM_HEADROOM)
    return out


def convert_file_size_to_int(size: int | str) -> int:
    """``'10GB'`` / ``'1GiB'`` / ``'512'`` → bytes."""
    if isinstance(size, int):
        return size
    mem_size = size.upper().strip()
    units = [("GIB", 1 << 30), ("MIB", 1 << 20), ("KIB", 1 << 10),
             ("GB", 10**9), ("MB", 10**6), ("KB", 10**3), ("B", 1)]
    for suffix, mult in units:
        if mem_size.endswith(suffix):
            return int(float(mem_size[: -len(suffix)]) * mult)
    if mem_size.isdigit():
        return int(mem_size)
    raise ValueError("`size` is not in a valid format. Use an integer or '10GB'/'1GiB'.")


def get_balanced_memory(params, max_memory: Mapping | None = None, no_split_module_classes=None,
                        dtype=None, special_dtypes=None, low_zero: bool = False) -> dict:
    """Cap each card's budget at an even share of the model plus 1.25 times
    its largest block, so the greedy planner spreads instead of filling
    card 0; ``low_zero`` leaves card 0 empty (for ``generate``'s
    activations)."""
    max_memory = get_max_memory(max_memory)
    accel_keys = [k for k in max_memory if k not in OFFLOAD_TARGETS]
    num_devices = len([k for k in accel_keys if max_memory[k] > 0])
    if num_devices == 0:
        return max_memory
    if num_devices == 1:
        low_zero = False
    sizes = compute_module_sizes(params, dtype=dtype, special_dtypes=special_dtypes)
    per_device = sizes.get("", 0) // (num_devices - 1 if low_zero else num_devices)
    block_sizes = [sizes[b] for b in get_top_level_blocks(params) if b in sizes]
    if block_sizes:
        mean_block = int(sum(block_sizes) / len(block_sizes))
        per_device += int(1.25 * max(block_sizes)) if len(block_sizes) > 1 else mean_block
    out = dict(max_memory)
    for i, key in enumerate(accel_keys):
        out[key] = min(0 if (low_zero and i == 0) else per_device, max_memory[key])
    return out


# ------------------------------------------------------------- placement planning
def infer_auto_device_map(params, max_memory: Mapping | None = None,
                          no_split_module_classes=None, dtype=None, special_dtypes=None,
                          verbose: bool = False, clean_result: bool = True,
                          offload_buffers: bool = False) -> dict:
    """Greedy block placement over cards → host → disk: ``{block: target}``
    with targets ``cuda:i``, ``cpu`` (host offload) or ``disk``. The planner
    never goes back to an earlier target. A block holding a parameter tied
    to one already placed goes where that one went, whatever the budgets."""
    max_memory = get_max_memory(max_memory)
    sizes = compute_module_sizes(params, dtype=dtype, special_dtypes=special_dtypes)
    tied_groups = find_tied_parameters(params)
    targets = [k for k in max_memory if k not in OFFLOAD_TARGETS] + list(OFFLOAD_TARGETS)
    budgets = {k: max_memory.get(k, 0) for k in targets}
    budgets["disk"] = float("inf")

    device_map: dict[str, str] = {}
    tied_target: dict[str, str] = {}
    all_names = list(named_parameters(params))
    ti = 0
    for block in get_top_level_blocks(params):
        size = sizes.get(block, 0)
        block_params = [n for n in all_names if n == block or n.startswith(block + ".")]
        forced = None
        for group in tied_groups:
            if any(p in group for p in block_params):
                placed = [tied_target[p] for p in group if p in tied_target]
                if placed:
                    forced = placed[0]
                    break
        if forced is not None:
            device_map[block] = forced
        else:
            while ti < len(targets) - 1 and budgets[targets[ti]] < size:
                if verbose:
                    logger.info("target %s full (%d left < %d needed)", targets[ti],
                                budgets[targets[ti]], size)
                ti += 1
            device_map[block] = targets[ti]
            budgets[targets[ti]] -= size
        for p in block_params:
            tied_target[p] = device_map[block]
    return _clean_device_map(device_map) if clean_result else device_map


def _clean_device_map(device_map: dict, module_name: str = "") -> dict:
    """Merge the children of a prefix that all landed on one target into
    the prefix."""
    prefix = module_name + "." if module_name else ""
    values = [v for k, v in device_map.items() if k.startswith(prefix)]
    if len(set(values)) == 1 and len(values) > 1 and module_name:
        for k in [k for k in device_map if k.startswith(prefix)]:
            del device_map[k]
        device_map[module_name] = values[0]
    depth = len(module_name.split(".")) if module_name else 0
    children = {k.split(".")[depth] for k in device_map
                if k != module_name and k.startswith(prefix)}
    for child in children:
        child_name = f"{module_name}.{child}" if module_name else child
        if child_name not in device_map:
            _clean_device_map(device_map, child_name)
    return device_map


def check_device_map(params, device_map: dict) -> None:
    """Raise unless every parameter is covered by some prefix of the map."""
    uncovered = [n for n in named_parameters(params)
                 if not any(n == k or n.startswith(k + ".") or k == "" for k in device_map)]
    if uncovered:
        raise ValueError(f"The device_map provided does not cover all parameters: "
                         f"{uncovered[:5]}" + ("..." if len(uncovered) > 5 else ""))


def check_tied_parameters_in_config(params, device_map: dict) -> list:
    """Tied groups that the map splits over several targets."""
    return [group for group in find_tied_parameters(params)
            if len({param_target(n, device_map) for n in group}) > 1]


def param_target(name: str, device_map: dict) -> str:
    """A parameter's target: the map's longest prefix of its name."""
    best = None
    for key in device_map:
        if key == "" or name == key or name.startswith(key + "."):
            if best is None or len(key) > len(best):
                best = key
    if best is None:
        raise KeyError(f"{name} not covered by device_map")
    return device_map[best]


def device_for_target(target: str, main_device=None):
    """The ``torch.device`` of a card target (None for ``cpu`` and
    ``disk``, which are offload). With ``main_device`` on the CPU every card
    target resolves to the CPU (a map's ``"cpu"`` means offload, so a CPU
    run names its execution device there); otherwise ``cuda:i`` must be a
    card of this process, and raises without one."""
    if target in OFFLOAD_TARGETS:
        return None
    if main_device is not None and torch.device(main_device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(target)
    if dev.type != "cuda":
        raise ValueError(f"device_map target {target!r}: cards are 'cuda:i'; 'cpu' and 'disk' "
                         "are offload")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"device_map target {target!r}: this process has "
                         f"{torch.cuda.device_count()} card(s)")
    return dev


# ------------------------------------------------------------ checkpoint loading
def load_state_dict(checkpoint_file: str, device_map: dict | None = None) -> dict:
    """A checkpoint file's tensors on the host: a ``.safetensors`` file as
    memory maps (nothing read until used), a pickle as its arrays. The flax
    msgpack format is not read."""
    if checkpoint_file.endswith(".safetensors"):
        return load_file_lazy(checkpoint_file)
    if checkpoint_file.endswith(".msgpack"):
        raise NotImplementedError(
            f"{checkpoint_file}: the flax msgpack checkpoint format is not ported (ROADMAP.md, "
            "Queue 1 item 6, the msgpack export); write safetensors")
    with open(checkpoint_file, "rb") as fh:
        return pickle.load(fh)


def _as_host_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def meta_like(leaf) -> torch.Tensor:
    """A ``meta`` tensor of ``leaf``'s shape and dtype: the placeholder of a
    weight that lives on disk (the JAX package's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")


def load_checkpoint_in_model(params, checkpoint: str, device_map: dict | None = None,
                             offload_folder: str | None = None, dtype=None,
                             offload_state_dict: bool = False, strict: bool = False):
    """Fill a parameter tree (``meta`` or real) from a checkpoint: one
    ``.safetensors`` or pickle file, a sharded index, or a folder holding
    either. Returns a new tree of host tensors (memory-mapped, read when
    used); a parameter the map sends to ``disk`` is written to
    ``offload_folder`` (``utils/offload.py``) and left as a ``meta``
    placeholder. Parameters missing from the checkpoint keep their leaf."""
    from .offload import offload_weight, save_offload_index

    loaded: dict = {}
    for f in _resolve_checkpoint_files(checkpoint):
        loaded.update(load_state_dict(f))
    names = named_parameters(params)
    missing = [n for n in names if n not in loaded]
    unexpected = [k for k in loaded if k not in names]
    if strict and (missing or unexpected):
        raise RuntimeError(f"Error loading state_dict: missing keys {missing[:5]}, "
                           f"unexpected {unexpected[:5]}")
    offload_index: dict = {}
    out_flat = {}
    for name, leaf in names.items():
        if name not in loaded:
            out_flat[name] = leaf
            continue
        value = _as_host_tensor(loaded[name])
        if dtype is not None and value.is_floating_point():
            value = value.to(dtype)
        if (param_target(name, device_map) if device_map else "cpu") == "disk":
            if offload_folder is None:
                raise ValueError("offload_folder required when device_map contains 'disk' "
                                 "entries")
            offload_weight(value, name, offload_folder, index=offload_index)
            out_flat[name] = meta_like(value)
        else:
            out_flat[name] = value
    if offload_index:
        save_offload_index(offload_index, offload_folder)
    return unflatten_names(out_flat, params)


def _resolve_checkpoint_files(checkpoint: str) -> list[str]:
    """The files of a checkpoint: a folder's index (safetensors, then
    msgpack) or its ``.safetensors`` / ``.msgpack`` files, an index's shards,
    or the one file."""
    if os.path.isdir(checkpoint):
        for index_name in (SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME):
            index = os.path.join(checkpoint, index_name)
            if os.path.isfile(index):
                return _resolve_checkpoint_files(index)
        cand = sorted(os.path.join(checkpoint, f) for f in os.listdir(checkpoint)
                      if f.endswith((".safetensors", ".msgpack")))
        if cand:
            return cand
        raise ValueError(f"No checkpoint files found in directory {checkpoint}")
    if checkpoint.endswith(".index.json"):
        with open(checkpoint) as fh:
            index = json.load(fh)
        folder = os.path.dirname(checkpoint)
        return sorted({os.path.join(folder, f) for f in index["weight_map"].values()})
    if os.path.isfile(checkpoint):
        return [checkpoint]
    raise ValueError(f"Checkpoint {checkpoint} not found")


def unflatten_names(flat: dict, template):
    """``template``'s structure with each leaf replaced by ``flat[name]``
    where the name is there."""
    return map_with_paths(lambda key, leaf: flat.get(key, leaf), template)


def get_mixed_precision_context_manager(*args, **kwargs):  # pragma: no cover
    """The dtype policy is applied by the model's own casts; there is no
    autocast context to build (the JAX package's answer)."""
    return contextlib.nullcontext()


def align_module_device(*args, **kwargs):  # pragma: no cover - parity stub
    return contextlib.nullcontext()
