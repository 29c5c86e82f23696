"""A small convolutional image classifier, the model of the CV examples — the
counterpart of ``accelerate_tpu/models/vision.py``.

Stages of a 3x3 stride-2 convolution, an f32 GroupNorm and a relu, then a
global average pool and a linear head with f32 logits; ``loss`` when
``labels`` are given. The function is the JAX package's:

- Inputs are NHWC (``pixel_values``, as the examples' datasets give them);
  the forward permutes them once to NCHW for ``F.conv2d``, and the kernels
  are stored OIHW (``convnet_params_from_numpy`` permutes the JAX package's
  HWIO kernels). The head's kernel is (C, classes) in both packages.
- ``padding="SAME"`` in XLA pads a stride-2 convolution of an even width 0
  before and 1 after (the output has ceil(W / 2) columns); a symmetric
  ``padding=1`` would compute another function. The padding is derived from
  the shapes (:func:`same_padding`) and applied with ``F.pad``.
- The GroupNorm takes f32 statistics over each group's (H, W, C / G) values
  with the population variance, whatever the compute dtype.

The JAX package keeps the stages as a list; the port keeps a dict keyed
``"0"``, ``"1"``, ... (its tree helpers walk dicts), so the dotted names
(``stages.0.kernel``) are the same. ``init`` draws on a CPU generator and
moves the result, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..modules import ModelOutput, Module
from ..ops.losses import cross_entropy_loss
from ..utils.device import resolve_device


@dataclass
class ConvNetConfig:
    num_classes: int = 10
    in_channels: int = 3
    widths: tuple = (32, 64, 128)
    norm_groups: int = 8
    compute_dtype: str = "float32"

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(widths=(16, 32), norm_groups=4)
        defaults.update(kw)
        return cls(**defaults)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after), the odd
    pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, kernel, stride: int):
    """``x`` NCHW, ``kernel`` OIHW, XLA's ``"SAME"`` padding."""
    kh, kw = kernel.shape[2:]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, kernel.to(x.dtype), stride=stride)


def _group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    """GroupNorm of an NCHW ``x`` with f32 statistics, the population
    variance, cast back to ``x``'s dtype."""
    n, c, h, w = x.shape
    xg = x.float().reshape(n, groups, c // groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(n, c, h, w) * scale[None, :, None, None] + bias[None, :, None, None]
    return out.to(x.dtype)


class ConvNetForImageClassification(Module):
    """Conv → GroupNorm → relu stages (each halving H and W), global average
    pool, linear head."""

    def __init__(self, config: ConvNetConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = None

    def init(self, generator=None, dtype=torch.float32):
        """He-normal kernels (std sqrt(2 / fan_in)), a head of std
        sqrt(1 / C), ones and zeros for the norms and the bias. ``generator``
        is a CPU ``torch.Generator`` or an int seed."""
        cfg, dev = self.config, self.device
        if not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator().manual_seed(seed)

        def normal(shape, std):
            if dev.type == "meta":
                return torch.empty(shape, dtype=dtype, device=dev)
            t = torch.randn(shape, generator=generator, dtype=torch.float32) * std
            return t.to(device=dev, dtype=dtype)

        def const(shape, value):
            return torch.full(shape, value, dtype=dtype, device=dev)

        stages, c_in = {}, cfg.in_channels
        for i, c_out in enumerate(cfg.widths):
            stages[str(i)] = {"kernel": normal((c_out, c_in, 3, 3), math.sqrt(2.0 / (9 * c_in))),
                              "gn_scale": const((c_out,), 1.0), "gn_bias": const((c_out,), 0.0)}
            c_in = c_out
        head = {"kernel": normal((c_in, cfg.num_classes), math.sqrt(1.0 / c_in)),
                "bias": const((cfg.num_classes,), 0.0)}
        return {"stages": stages, "head": head}

    def apply(self, params, pixel_values=None, labels=None, train: bool = False, **kwargs):
        cfg = self.config
        x = torch.as_tensor(pixel_values).to(getattr(torch, cfg.compute_dtype))
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        stages = params["stages"]
        for i in range(len(stages)):
            stage = stages[str(i)]
            x = _conv(x, stage["kernel"], stride=2)
            x = F.relu(_group_norm(x, stage["gn_scale"], stage["gn_bias"], cfg.norm_groups))
        x = x.mean(dim=(2, 3))  # global average pool → (N, C)
        # f32 logits from parameters of any dtype (JAX promotes f32 @ bf16 to f32).
        logits = x.float() @ params["head"]["kernel"].float() + params["head"]["bias"].float()
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, torch.as_tensor(labels, device=logits.device))
        return out
