"""Int8 KV quantization — the counterpart of ``accelerate_tpu/ops/int8.py:43-66``.

Only the paged pool's per-token quantizer is ported in this slice;
``int8_matmul`` (and with it ``matmul_precision="int8"``) is a later slice.
Both functions are bitwise equal to the JAX versions: the scale is an f32
division, and ``torch.round`` rounds half to even like ``jnp.round``.
"""

from __future__ import annotations

import torch


def quantize_kv(t):
    """Per-token KV quantization for the paged pool (``kv_quant="int8"``).

    ``t``: ``(..., H, D)`` K or V rows. One scale per token row: absmax over
    (heads, head_dim) mapped to 127. Returns ``(int8 t-shaped, float32
    (...,) scales)``."""
    t32 = t.float()
    amax = t32.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(t32 / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: an f32 multiply, then one cast. The
    paged gather's dequant kernel replays exactly this expression."""
    return (q.float() * scale[..., None, None].float()).to(dtype)
