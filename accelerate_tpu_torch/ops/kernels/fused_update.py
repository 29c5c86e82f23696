"""Wrapper of the fused optimizer-update kernel (``csrc/fused_update.cu``).

The CUDA counterpart of the TPU kernel ``_fused_leaf_call``
(``accelerate_tpu/ops/pallas/fused_update.py:200``): one pass over one
parameter leaf that applies the clip factor, the optimizer's moment and
update math, and the learning-rate step, writes the parameter and the
moments in place, and zeroes the accumulation buffer. Its plain version is
``ops/fused_update.leaf_update``; the two are bitwise equal. One launch per
leaf, counted under the JAX kernel's family name
(``fused_{sgd,sgd_momentum,adam,adamw}_update``). A zero-size leaf launches
nothing.

Takes CUDA tensors only — CPU tensors reach the plain version through the
registry — and checks device, dtype (f32), size, contiguity and 16-byte
alignment; the clip factor and the bias corrections are f32 device scalars.
"""

from __future__ import annotations

import ctypes

import torch

from ..registry import record_launch
from ._build import load

_KIND = {"sgd": 0, "sgd_momentum": 1, "adam": 2}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("fused_update")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.fused_update_launch.argtypes = [i32, ptr, ptr, ptr, ptr, i64, ptr, ptr, ptr,
                                            f32, f32, f32, f32, f32, f32, i32, f32, f32, f32,
                                            ptr]
        lib.fused_update_launch.restype = i32
        lib.fused_update_error_string.argtypes = [i32]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_update kernel: {msg}")


def fused_update_cuda(p, g, moments, factor, bc1=None, bc2=None, *, plan):
    """Launch the update of one leaf in place. ``moments``: ``(mu, nu)`` for
    adam(w), ``(trace,)`` for sgd with momentum, ``()`` for sgd."""
    _check(p.is_cuda, f"takes CUDA tensors, got a tensor on {p.device}")
    want = {"adam": 2, "sgd_momentum": 1, "sgd": 0}[plan.kind]
    _check(len(moments) == want, f"{plan.kind} takes {want} moment tensors, got {len(moments)}")
    for name, t in (("param", p), ("grad", g), *((f"moment{i}", m) for i, m in enumerate(moments))):
        _check(t.device == p.device and t.dtype == torch.float32 and t.numel() == p.numel()
               and t.is_contiguous() and t.data_ptr() % 16 == 0,
               f"{name} must be a contiguous, 16-byte aligned float32 tensor of "
               f"{p.numel()} elements on {p.device}")
    scalars = [factor] + ([bc1, bc2] if plan.kind == "adam" else [])
    for t in scalars:
        _check(isinstance(t, torch.Tensor) and t.device == p.device and t.dtype == torch.float32
               and t.numel() == 1, "clip factor and bias corrections must be float32 scalars "
                                   "on the parameter's device")
    n = p.numel()
    if n == 0:
        return
    c = plan.f32_constants()
    ptrs = [m.data_ptr() for m in moments] + [None] * (2 - len(moments))
    bcs = [t.data_ptr() for t in scalars[1:]] + [None] * (3 - len(scalars))
    stream = torch.cuda.current_stream(p.device).cuda_stream
    lib = _lib()
    with torch.cuda.device(p.device):
        rc = lib.fused_update_launch(
            _KIND[plan.kind], p.data_ptr(), ptrs[0], ptrs[1], g.data_ptr(), n, factor.data_ptr(),
            bcs[0], bcs[1], c["one_minus_b1"], c["b1"], c["one_minus_b2"], c["b2"], c["eps"],
            c["eps_root"], int(plan.weight_decay is not None), c["wd"], c["step_size"],
            c["momentum"], stream)
    if rc != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error {rc} "
                           f"({lib.fused_update_error_string(rc).decode()})")
    record_launch(f"fused_{plan.describe()}_update")
