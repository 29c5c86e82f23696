"""Normalization primitives — the counterpart of ``accelerate_tpu/ops/norms.py``.

``layer_norm`` is the JAX package's f32 LayerNorm: the mean, then the mean of
the squared deviation, then ``rsqrt(var + eps)``, the affine transform in f32,
and the output in the input's dtype (the mixed-precision contract). RMSNorm
lives in ``models/llama.py``.
"""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * scale + bias).to(dtype)
