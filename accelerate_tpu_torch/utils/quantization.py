"""Weight-only quantization, the bitsandbytes API — the counterpart of
``accelerate_tpu/utils/quantization.py``.

- **int8**: symmetric absmax quantization of every 2-D or wider leaf, one f32
  scale per output channel (the last axis), per layer for stacked leaves
  (a leading layer axis), so one outlier layer does not coarsen the others.
- **int4**: the same with qmax 7, the values packed two nibbles a byte over
  the flattened leaf (an odd count gets one pad nibble).
- **compute**: a ``DequantizeHook`` (``hooks.py``) rebuilds the whole tree in
  the compute dtype at every forward's entry, and the forward's products run
  on that copy as usual. This is the JAX package's function; it does not run
  the int8 matmul kernel, which also quantizes the activations and so
  computes another function.

The arithmetic follows the JAX package's op order (absmax, ``/ qmax`` in the
weight's dtype, a zero scale replaced by 1, ``round(w / scale)`` half to
even, the clip, the packing), so quantized data and scales are bitwise the
JAX package's. 1-D leaves (norms, biases) and ``skip_modules`` stay in full
precision.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .tree import tree_leaves


class QuantizedTensor:
    """A quantized weight: int8 (or nibble-packed int4) ``data`` and f32
    per-channel ``scale``, with the bit width and the logical shape. One
    leaf of a parameter tree (the tree helpers do not look inside it), which
    moves as a whole with ``.to(device)``."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, bits: int, shape: tuple):
        self.data = data
        self.scale = scale
        self.bits = int(bits)
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return int(self.data.numel() * self.data.element_size()
                   + self.scale.numel() * self.scale.element_size())

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device, non_blocking: bool = False) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device, non_blocking=non_blocking),
                               self.scale.to(device, non_blocking=non_blocking),
                               self.bits, self.shape)

    def __repr__(self):
        return f"QuantizedTensor(bits={self.bits}, shape={self.shape})"


@dataclass
class QuantizationConfig:
    """The fields of bitsandbytes' config that apply here."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    compute_dtype: str = "bfloat16"
    skip_modules: list = field(default_factory=list)
    keep_in_fp32_modules: list = field(default_factory=list)

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("load_in_8bit and load_in_4bit can't both be set")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("Set load_in_8bit or load_in_4bit")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4

    @property
    def target_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def quantize_leaf(w, bits: int) -> QuantizedTensor:
    """Symmetric absmax quantization of ``w`` on its own device, one scale
    per last-axis channel (per layer and channel for ndim >= 3)."""
    w = torch.as_tensor(w)
    qmax = 127.0 if bits == 8 else 7.0
    reduce_axes = tuple(range(1, w.dim() - 1)) if w.dim() >= 3 else tuple(range(w.dim() - 1))
    absmax = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    scale = (absmax / qmax).to(torch.float32)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        flat = q.reshape(-1)
        if flat.numel() % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        q = (flat[0::2] & 0x0F) | ((flat[1::2] & 0x0F) << 4)
    return QuantizedTensor(q, scale, bits, tuple(w.shape))


def dequantize_leaf(leaf: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q, scale = leaf.data, leaf.scale
    if leaf.bits == 4:
        lo = q & 0x0F
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = (q >> 4) & 0x0F
        hi = torch.where(hi > 7, hi - 16, hi)
        size = int(torch.Size(leaf.shape).numel())
        full = torch.stack([lo, hi], dim=1).reshape(-1)[:size].reshape(leaf.shape)
        return (full * scale).to(dtype)
    return (q.to(torch.float32) * scale).to(dtype)


def is_quantized_leaf(x) -> bool:
    return isinstance(x, QuantizedTensor)


def _should_quantize(name: str, leaf, config: QuantizationConfig) -> bool:
    if leaf.dim() < 2:
        return False
    skip = list(config.skip_modules) + list(config.keep_in_fp32_modules)
    return not any(s and s in name for s in skip)


def quantize_tree(params, config: QuantizationConfig, device=None):
    """The tree with its eligible leaves quantized (on ``device`` when
    given, a leaf at a time, else where each leaf is); the other leaves are
    kept (moved to ``device`` when given)."""
    from .modeling import named_parameters

    out: dict = {}
    for name, leaf in named_parameters(params).items():
        if device is not None:
            leaf = leaf.to(device)
        value = quantize_leaf(leaf, config.bits) if _should_quantize(name, leaf, config) else leaf
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def dequantize_tree(params, dtype=torch.bfloat16):
    """The full-precision tree: every quantized leaf dequantized to
    ``dtype``, the others as they are."""
    if isinstance(params, QuantizedTensor):
        return dequantize_leaf(params, dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    return params


def quantized_nbytes(params) -> int:
    """Bytes the tree holds at rest (a quantized leaf's data and scales)."""
    return sum(leaf.nbytes if isinstance(leaf, QuantizedTensor)
               else leaf.numel() * leaf.element_size() for leaf in tree_leaves(params))


def load_and_quantize_model(model, weights_location: str | None = None,
                            quantization_config: QuantizationConfig | None = None,
                            device_map=None, no_split_module_classes=None,
                            offload_folder: str | None = None):
    """Load the checkpoint (when given) onto the host, quantize the tree a
    leaf at a time on the model's device (``cuda`` unless the model was
    built with ``device="cpu"``), and hook ``model.apply`` so that forwards
    see the weights dequantized to ``compute_dtype``."""
    if quantization_config is None:
        raise ValueError("quantization_config is required")
    if weights_location is not None:
        from .modeling import load_checkpoint_in_model

        model.params = load_checkpoint_in_model(model.params, weights_location,
                                                device_map=device_map,
                                                offload_folder=offload_folder)
    if model.params is None:
        raise ValueError("Model has no params; init or load weights first")
    model.params = quantize_tree(model.params, quantization_config, device=model.device)

    from ..hooks import DequantizeHook, add_hook_to_module

    add_hook_to_module(model, DequantizeHook(quantization_config.target_dtype))
    model.is_quantized = True
    return model
