"""Disk-backed weight storage for models larger than the card — the counterpart
of ``accelerate_tpu/utils/offload.py``, in the same on-disk format.

An offload folder holds one ``<name>.dat`` memory map a tensor (raw bytes in
C order) and an ``index.json`` of ``{"dtype", "shape"}`` by name. bf16,
which numpy memory maps cannot hold, is stored as its int16 bits under
``"dtype": "bfloat16"``; a 0-d tensor as one element. A folder written by
either package is read by the other.

Reading returns CPU tensors over copy-on-write memory maps, so slicing one
layer of a stacked weight reads only that layer's bytes
(``big_modeling.StreamedScanModel`` streams them to the card).
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from .safetensors_io import load_file_lazy


def _host_array(weight) -> tuple[np.ndarray, str]:
    """``weight`` as a contiguous numpy array and its index dtype name."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(weight)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def offload_weight(weight, weight_name: str, offload_folder: str, index: dict | None = None):
    """Write one tensor (or numpy array) as ``<weight_name>.dat`` and record
    it in ``index``."""
    array, dtype = _host_array(weight)
    if index is not None:
        index[weight_name] = {"dtype": dtype, "shape": list(array.shape)}
    if array.ndim == 0:
        array = array[None]
    os.makedirs(offload_folder, exist_ok=True)
    file_array = np.memmap(os.path.join(offload_folder, f"{weight_name}.dat"),
                           dtype=array.dtype, mode="w+", shape=array.shape)
    file_array[:] = array[:]
    file_array.flush()
    return index


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """One offloaded tensor as a CPU tensor over a memory map of its file."""
    shape = tuple(weight_info["shape"])
    dtype = weight_info["dtype"]
    np_dtype = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = np.memmap(weight_file, dtype=np_dtype, shape=shape or (1,), mode="c")
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t[0] if shape == () else t


def save_offload_index(index: dict, offload_folder: str):
    """Merge ``index`` into the folder's ``index.json``."""
    if not index:
        return
    os.makedirs(offload_folder, exist_ok=True)
    offload_index_file = os.path.join(offload_folder, "index.json")
    current_index = {}
    if os.path.isfile(offload_index_file):
        with open(offload_index_file) as f:
            current_index = json.load(f)
    current_index.update(index)
    with open(offload_index_file, "w") as f:
        json.dump(current_index, f, indent=2)


def offload_state_dict(save_dir: str, state_dict: Mapping) -> None:
    """Offload a flat ``{name: tensor}`` dict into ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    index = {}
    for name, parameter in state_dict.items():
        index = offload_weight(parameter, name, save_dir, index=index)
    save_offload_index(index, save_dir)


class PrefixedDataset(Mapping):
    """A view of a mapping under a key prefix."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter([key for key in self.dataset if key.startswith(self.prefix)])

    def __len__(self):
        return len([key for key in self.dataset if key.startswith(self.prefix)])


class OffloadedWeightsLoader(Mapping):
    """One lazy view over host tensors and an offload folder: ``[name]`` is a
    CPU tensor, from ``state_dict`` or read from the folder (or from the
    safetensors file an index entry names). Moving it to a card is the
    caller's business."""

    def __init__(self, state_dict: Mapping | None = None,
                 save_folder: str | os.PathLike | None = None, index: Mapping | None = None,
                 device=None):
        if state_dict is None and save_folder is None and index is None:
            raise ValueError("Need either a `state_dict`, a `save_folder` or an `index`.")
        self.state_dict = dict(state_dict or {})
        if index is None and save_folder is not None:
            with open(os.path.join(save_folder, "index.json")) as f:
                index = json.load(f)
        self.index = dict(index or {})
        self.save_folder = save_folder
        self.all_keys = list(self.state_dict.keys())
        self.all_keys.extend([key for key in self.index if key not in self.all_keys])
        self.device = device

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        weight_info = self.index[key]
        if weight_info.get("safetensors_file") is not None:
            return load_file_lazy(weight_info["safetensors_file"])[
                weight_info.get("weight_name", key)]
        return load_offloaded_weight(os.path.join(self.save_folder, f"{key}.dat"), weight_info)

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


def extract_submodules_state_dict(state_dict: Mapping, submodule_names: list[str]) -> dict:
    """The entries of a flat dict under the given block prefixes."""
    result = {}
    for name in submodule_names:
        result.update({key: param for key, param in state_dict.items()
                       if key == name or key.startswith(name + ".")})
    return result
