"""Miscellaneous helpers — the counterpart of ``accelerate_tpu/utils/other.py``.

``save`` / ``load`` (pickle, or safetensors for a tree of tensors),
``extract_model_from_parallel``, ``merge_dicts``, ``is_port_in_use``,
``convert_bytes``, ``check_os_kernel``, ``write_basic_config``,
``get_pretty_name``, ``save_json`` and ``load_json``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import platform
import re
import socket
from pathlib import Path

import torch

from .constants import DEFAULT_CONFIG_FILE, DEFAULT_CONFIG_FOLDER
from .safetensors_io import load_file, save_file
from .tree import flatten_with_paths, map_with_paths

logger = logging.getLogger(__name__)


def extract_model_from_parallel(model, keep_fp32_wrapper: bool = True, recursive: bool = False):
    """The module behind a ``PreparedModel`` (the port's only wrapper)."""
    from ..accelerator import PreparedModel

    while isinstance(model, PreparedModel):
        model = model.module
    return model


def _to_host(obj):
    """``obj`` with every tensor leaf copied to the CPU."""
    return map_with_paths(
        lambda _, x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, obj)


def save(obj, f, save_on_each_node: bool = False, safe_serialization: bool = False):
    """Save ``obj`` on the main process only (on each node's main process
    with ``save_on_each_node``), tensors copied to the CPU first. With
    ``safe_serialization`` a tree of tensors is written as safetensors under
    its dotted keys; otherwise ``obj`` is pickled."""
    from ..state import ProcessView

    proc = ProcessView()
    obj = _to_host(obj)
    should = proc.is_local_main_process if save_on_each_node else proc.is_main_process
    if not should:
        return
    if safe_serialization:
        save_file(dict(flatten_with_paths(obj)), f, metadata={"format": "pt"})
    else:
        with open(f, "wb") as fh:
            pickle.dump(obj, fh)


def load(f, map_location=None, **kwargs):
    """Read a file :func:`save` wrote: a ``.safetensors`` file gives its
    tensors by key (on ``map_location`` when given), anything else is
    unpickled."""
    f = str(f)
    if f.endswith(".safetensors"):
        tensors = load_file(f)
        if map_location is not None:
            tensors = {k: v.to(map_location) for k, v in tensors.items()}
        return tensors
    with open(f, "rb") as fh:
        return pickle.load(fh)


def merge_dicts(source: dict, destination: dict) -> dict:
    """Merge ``source`` into ``destination``, recursively."""
    for key, value in source.items():
        if isinstance(value, dict):
            node = destination.setdefault(key, {})
            merge_dicts(value, node)
        else:
            destination[key] = value
    return destination


def is_port_in_use(port: int | str | None = None) -> bool:
    """Whether something listens on ``localhost:port`` (default 29500)."""
    if port is None:
        port = 29500
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("localhost", int(port))) == 0


def convert_bytes(size: float) -> str:
    """Human-readable bytes: 1024 -> '1.0 KB'."""
    for unit in ["bytes", "KB", "MB", "GB", "TB"]:
        if size < 1024.0:
            return f"{round(size, 2)} {unit}"
        size /= 1024.0
    return f"{round(size, 2)} PB"


def check_os_kernel():
    """Warn on Linux kernels older than 5.5, on which multi-process
    rendezvous can hang."""
    info = platform.uname()
    if info.system != "Linux":
        return
    _, version, *_ = re.split(r"(\d+\.\d+\.\d+)", info.release)
    major, minor, _ = (int(x) for x in version.split("."))
    if (major, minor) < (5, 5):
        logger.warning(
            "Detected kernel version %s, which is below the recommended minimum of 5.5.0; "
            "this can cause the process to hang.",
            version,
        )


def default_config_file() -> str:
    """``$ACCELERATE_TPU_HOME`` or ``$XDG_CACHE_HOME/accelerate_tpu`` (else
    ``~/.cache/accelerate_tpu``), then ``default_config.yaml``: the JAX
    package's location."""
    home = os.environ.get("ACCELERATE_TPU_HOME", os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")),
        DEFAULT_CONFIG_FOLDER))
    return os.path.join(home, DEFAULT_CONFIG_FILE)


def write_basic_config(mixed_precision: str = "no", save_location: str | None = None):
    """Write a minimal one-process launch configuration without asking
    anything, unless the file exists (then warn and return False); returns
    the path. The JAX package writes its ``ClusterConfig`` as yaml; the port
    writes the same basic keys as JSON, which yaml readers read too."""
    path = Path(save_location) if save_location is not None else Path(default_config_file())
    if path.exists():
        logger.warning("Config file already exists at %s; skipping.", path)
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    config = {"compute_environment": "LOCAL_MACHINE", "distributed_type": "NO",
              "mixed_precision": mixed_precision, "num_processes": 1}
    path.write_text(json.dumps(config, indent=2, sort_keys=True) + "\n")
    return path


def get_pretty_name(obj) -> str:
    """A display name for ``obj``: its qualified name, or its class's."""
    if not hasattr(obj, "__qualname__") and not hasattr(obj, "__name__"):
        obj = getattr(obj, "__class__", obj)
    if hasattr(obj, "__qualname__"):
        return obj.__qualname__
    if hasattr(obj, "__name__"):
        return obj.__name__
    return str(obj)


def save_json(obj, path: str | os.PathLike, indent: int = 2) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=indent, sort_keys=True)


def load_json(path: str | os.PathLike):
    with open(path) as fh:
        return json.load(fh)
