"""Carry parameters across from the JAX package.

``llama_params_from_numpy`` takes the JAX package's Llama parameter tree with
its leaves already converted to numpy arrays (``jax.tree_util.tree_map(
np.asarray, params)`` on the JAX side — this module imports no JAX) and
returns the port's parameter dictionary. The layouts are the same by design
(stacked ``(L, ...)`` layer weights, ``(in, out)`` projections, ``(h, V)``
LM head), so the conversion is a shape check and a copy; both packages then
compute the same function on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .llama import Llama, LlamaConfig


def _expected_shapes(config: LlamaConfig) -> dict:
    """The parameter tree's shapes, from the port's own initializer run on
    the meta device (no memory, no numbers)."""
    probe = Llama.__new__(Llama)
    probe.config = config
    probe.device = torch.device("meta")
    return probe.init(0)


def llama_params_from_numpy(tree, config: LlamaConfig, device=None, dtype=torch.float32):
    """Numpy Llama parameter tree (the JAX layout) → the port's parameters
    on ``device`` in ``dtype``. Raises on a missing, extra or mis-shaped
    leaf instead of loading a partial model."""
    dev = resolve_device(device)
    expected = _expected_shapes(config)

    def convert(src, ref, path):
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                got = sorted(src) if isinstance(src, dict) else type(src).__name__
                raise ValueError(f"parameter tree mismatch at {path or '/'}: "
                                 f"expected keys {sorted(ref)}, got {got}")
            return {k: convert(src[k], ref[k], f"{path}/{k}") for k in ref}
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"parameter {path}: expected shape {tuple(ref.shape)}, "
                             f"got {arr.shape}")
        return torch.tensor(arr.astype(np.float32), device=dev, dtype=dtype)

    return convert(tree, expected, "")
