"""Forward-interception hooks, the offload and dispatch runtime — the
counterpart of ``accelerate_tpu/hooks.py``.

The models are a config plus a parameter tree passed to ``apply``, as in the
JAX package, so a hook wraps the instance's ``apply`` and transforms
``(params, args, kwargs)`` on the way in and the output on the way out.
Moving weights is ``.to(device)`` of the tree's leaves; "removing them from
the card" is dropping the card's copy (the caching allocator takes the
memory back). A leaf on the ``meta`` device is a weight that lives
elsewhere, read from the hook's ``weights_map`` by name.

The per-layer streaming runtime for host- and disk-offloaded inference is
``big_modeling.StreamedScanModel``.
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.operations import _leaves, recursively_apply
from .utils.quantization import QuantizedTensor, dequantize_tree
from .utils.tree import map_with_paths, tree_map


def _to(tree, device, non_blocking: bool = False):
    """Every tensor leaf of ``tree`` on ``device`` (``send_to_device``), a
    ``QuantizedTensor`` moved whole."""
    def move(x):
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(device, non_blocking=non_blocking)

    return recursively_apply(move, tree, test_type=lambda x: isinstance(
        x, (torch.Tensor, np.ndarray, QuantizedTensor)))


def _first_tensor_device(tree):
    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else None


class ModelHook:
    """The hook protocol: methods receive values and return them."""

    no_grad = False

    def init_hook(self, module):
        return module

    def pre_forward(self, module, params, args, kwargs):
        return params, args, kwargs

    def post_forward(self, module, output):
        return output

    def detach_hook(self, module):
        return module


class SequentialHook(ModelHook):
    """Hooks composed in order."""

    def __init__(self, *hooks):
        self.hooks = hooks

    def init_hook(self, module):
        for hook in self.hooks:
            module = hook.init_hook(module)
        return module

    def pre_forward(self, module, params, args, kwargs):
        for hook in self.hooks:
            params, args, kwargs = hook.pre_forward(module, params, args, kwargs)
        return params, args, kwargs

    def post_forward(self, module, output):
        for hook in self.hooks:
            output = hook.post_forward(module, output)
        return output

    def detach_hook(self, module):
        for hook in self.hooks:
            module = hook.detach_hook(module)
        return module


def add_hook_to_module(module, hook: ModelHook, append: bool = False):
    """Wrap the instance's ``apply`` with ``hook``; with ``append`` the
    hook already there runs first (a ``SequentialHook``), else it is
    replaced."""
    if append and getattr(module, "_at_hook", None) is not None:
        old = module._at_hook
        remove_hook_from_module(module)
        hook = SequentialHook(old, hook)
    if getattr(module, "_at_old_apply", None) is None:
        module._at_old_apply = module.apply
    old_apply = module._at_old_apply
    module = hook.init_hook(module)
    module._at_hook = hook

    @functools.wraps(old_apply)
    def new_apply(params, *args, **kwargs):
        params, args, kwargs = hook.pre_forward(module, params, args, kwargs)
        return hook.post_forward(module, old_apply(params, *args, **kwargs))

    module.apply = new_apply
    return module


def remove_hook_from_module(module, recurse: bool = False):
    """Restore the ``apply`` the first hook wrapped."""
    if getattr(module, "_at_hook", None) is not None:
        module._at_hook.detach_hook(module)
        module._at_hook = None
    if getattr(module, "_at_old_apply", None) is not None:
        module.apply = module._at_old_apply
        module._at_old_apply = None
    return module


class AlignDevicesHook(ModelHook):
    """Move the parameters onto the execution device before the forward.

    ``weights_map`` (an ``OffloadedWeightsLoader``) supplies by name the
    leaves that are not on a card: a ``meta`` placeholder, or a host copy.
    The whole tree is placed each call, and the call's copies are freed
    after it; ``offload=True`` also moves the tree stored on the module back
    to the host after each forward. ``io_same_device`` returns the outputs
    on the first input tensor's device."""

    def __init__(self, execution_device=None, offload: bool = False,
                 io_same_device: bool = False, weights_map: Mapping | None = None,
                 skip_keys=None):
        self.execution_device = execution_device
        self.offload = offload
        self.io_same_device = io_same_device
        self.weights_map = weights_map
        self.skip_keys = skip_keys
        self.input_device = None

    def pre_forward(self, module, params, args, kwargs):
        if self.weights_map is not None:
            def fill(name, leaf):
                if isinstance(leaf, torch.Tensor) and leaf.device.type not in ("meta", "cpu"):
                    return leaf
                return self.weights_map[name] if name in self.weights_map else leaf
            params = map_with_paths(fill, params)
        if self.execution_device is not None:
            if self.io_same_device:
                self.input_device = _first_tensor_device((args, kwargs))
            params = _to(params, self.execution_device)
            args, kwargs = _to((args, kwargs), self.execution_device)
        return params, args, kwargs

    def post_forward(self, module, output):
        if self.offload and getattr(module, "params", None) is not None:
            module.params = _to(module.params, "cpu")
        if self.io_same_device and self.input_device is not None:
            output = _to(output, self.input_device)
        return output


class CpuOffload(ModelHook):
    """The parameters stay on the host between calls and go to the
    execution device (``cuda`` unless given) for each forward;
    ``prev_module_hook`` (a :class:`UserCpuOffloadHook`) moves the previous
    model of a chain back to the host first."""

    def __init__(self, execution_device=None, prev_module_hook=None):
        self.execution_device = resolve_device(execution_device)
        self.prev_module_hook = prev_module_hook

    def pre_forward(self, module, params, args, kwargs):
        if self.prev_module_hook is not None:
            self.prev_module_hook.offload()
        return _to(params, self.execution_device), args, kwargs


class UserCpuOffloadHook:
    """A model and its hook: ``offload()`` moves the stored parameters to the
    host, ``remove()`` takes the hook off."""

    def __init__(self, model, hook):
        self.model = model
        self.hook = hook

    def offload(self):
        if getattr(self.model, "params", None) is not None:
            self.model.params = _to(self.model.params, "cpu")

    def remove(self):
        remove_hook_from_module(self.model)


class DequantizeHook(ModelHook):
    """Rebuild the whole tree in ``compute_dtype`` at the forward's entry
    from its quantized leaves (``utils/quantization.py``): the forward's
    products then run on the dequantized copy, which is freed after it."""

    def __init__(self, compute_dtype=torch.bfloat16):
        self.compute_dtype = compute_dtype

    def pre_forward(self, module, params, args, kwargs):
        return dequantize_tree(params, self.compute_dtype), args, kwargs


class LayerwiseCastingHook(ModelHook):
    """Floating leaves stored in ``storage_dtype`` (cast when the hook is
    attached) and cast to ``compute_dtype`` at each forward's entry."""

    def __init__(self, storage_dtype=torch.float8_e4m3fn, compute_dtype=torch.bfloat16):
        self.storage_dtype = storage_dtype
        self.compute_dtype = compute_dtype

    @staticmethod
    def _cast(tree, dtype):
        return tree_map(lambda p: p.to(dtype) if isinstance(p, torch.Tensor)
                        and p.is_floating_point() else p, tree)

    def init_hook(self, module):
        if getattr(module, "params", None) is not None:
            module.params = self._cast(module.params, self.storage_dtype)
        return module

    def pre_forward(self, module, params, args, kwargs):
        return self._cast(params, self.compute_dtype), args, kwargs
