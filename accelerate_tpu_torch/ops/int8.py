"""Int8 quantization — the counterpart of ``accelerate_tpu/ops/int8.py``.

Two users:

- the paged pool's per-token KV quantizer (``kv_quant="int8"``):
  :func:`quantize_kv` / :func:`dequantize_kv`;
- the int8-weight matmul (``LlamaConfig(matmul_precision="int8")``):
  :func:`matmul` → :func:`int8_matmul`, which quantizes both operands
  dynamically (absmax symmetric: per row of x, per column of w), contracts
  int8 × int8 → int32 and rescales to ``x.dtype``. Its backward is the
  straight-through estimator in f32. The forward dispatches op
  ``int8_matmul`` (``ops/registry.py``): the hand-written CUDA kernel of
  ``csrc/int8_matmul.cu`` for CUDA tensors, :func:`int8_matmul_reference`
  for CPU tensors or ``kernels="off"``. The two are bitwise equal.

Every function here is bitwise equal to its JAX counterpart on the CPU, and
``torch.round`` rounds half to even like ``jnp.round``. The int8 matmul's
absmax scale is ``amax * f32(1/127)``: that is what the JAX package's jitted
programs compute (XLA's algebraic simplifier turns the division by the
constant 127 in ``_absmax_scale`` into a multiply by its f32 reciprocal),
and what the CUDA kernel computes. Eager JAX divides, and differs from both
in the last bit of some scales.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.int8_matmul import int8_matmul_cuda
from .registry import dispatch, register_op

PRECISIONS = ("default", "int8")
# 1/127 rounded to f32 once, as XLA folds it (InvertConstant) and as the
# kernel's constant is folded.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


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


def _absmax_scale(t, dim: int):
    """Symmetric per-vector scale: max|t| along ``dim`` mapped to 127 (kept
    as a size-1 dim), or 1.0 where the vector is all zeros."""
    amax = t.float().abs().amax(dim=dim, keepdim=True)
    return torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))


def quantize_rowwise(t, dim: int):
    """Quantize to int8 with one scale per vector along ``dim``: returns
    ``(int8 t-shaped, float32 scales with dim kept as 1)``."""
    scale = _absmax_scale(t, dim)
    q = torch.clamp(torch.round(t.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_reference(x, w):
    """Plain forward of the int8 matmul, the counterpart of
    ``_int8_matmul_fwd_value``: x ``(..., K)``, w ``(K, N)`` → ``(..., N)``
    in ``x.dtype``. The integer contraction runs in f64: every partial sum
    is an integer below 2**53 (|acc| <= K * 127**2), so it is exact in any
    order on any device, where CUDA has no int32 ``matmul``. The rescale is
    ``(acc * sx) * sw`` in f32, then one cast."""
    qx, sx = quantize_rowwise(x, -1)
    qw, sw = quantize_rowwise(w, 0)
    acc = (qx.double() @ qw.double()).to(torch.int32)
    return (acc.float() * sx * sw).to(x.dtype)


class _Int8Matmul(torch.autograd.Function):
    """Forward through op ``int8_matmul``; backward straight through in f32
    (``_int8_matmul_bwd``): gradients flow as if the matmul were exact."""

    @staticmethod
    def forward(ctx, x, w, kernels):
        ctx.save_for_backward(x, w)
        return dispatch("int8_matmul", x, w, kernels=kernels)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g32 = g.float()
        dx = (g32 @ w.float().T).to(x.dtype)
        lead = list(range(x.dim() - 1))
        dw = torch.tensordot(x.float(), g32, dims=(lead, lead)).to(w.dtype)
        return dx, dw, None


def int8_matmul(x, w, kernels=None):
    """``x @ w`` with both operands dynamically quantized to int8; ``kernels``
    is the registry spec (``"off"`` runs the plain forward on any device)."""
    return _Int8Matmul.apply(x, w, kernels)


def matmul(x, w, precision: str = "default", kernels=None):
    """Model-zoo matmul dispatch: ``default`` → ``x @ w``; ``int8`` → the
    quantized path with the straight-through backward."""
    if precision == "int8":
        return int8_matmul(x, w, kernels)
    if precision != "default":
        raise ValueError(f"matmul precision must be 'default' or 'int8', got {precision!r}")
    return x @ w


# Absmax int8 quantize of x rows and w columns, int32 contraction, rescale.
register_op("int8_matmul", int8_matmul_reference, int8_matmul_cuda)
