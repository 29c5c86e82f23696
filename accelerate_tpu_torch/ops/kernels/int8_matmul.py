"""Wrapper of the int8 matmul kernel (``csrc/int8_matmul.cu``).

The CUDA counterpart of the TPU kernel ``int8_matmul_kernel``
(``accelerate_tpu/ops/pallas/int8_mm.py:36``): ``x @ w`` with x quantized
per row and w per column (absmax symmetric int8), an int32 contraction on
the tensor cores, and the f32 rescale cast to ``x.dtype``. Its plain version
is ``ops/int8.int8_matmul_reference``; the two are bitwise equal.

The kernel runs as two launches, counted as one ``int8_matmul`` launch:
the rows of x quantized into a scratch ``qx``, then one cluster kernel that
reads each column panel of w from device memory once, quantizes it in shared
memory and contracts it by int8 wgmma (the source says how). This module
chooses the partition (:func:`plan`): the panel width, the cluster size and
each CTA's K slice, the rows of x a tile and the qx buffers, within the
shared memory a block can use. The wrapper takes CUDA tensors only — CPU
tensors reach the plain version through the registry — checks device,
dtype (x and w both f32 or both bf16) and shapes (K >= 1, a K slice that
fits), reshapes x's leading dims to rows, allocates the output and the
scratch with ``torch.empty``, launches on the current stream and raises on
a launch error.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..registry import record_launch
from ._build import load

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None

BLOCK_K = 128            # k of a block: one 128-byte row of the int8 operand
WG_ROWS = 64             # wgmma's M: rows of the int8 weight operand
SMEM_LIMIT = 232_448     # shared memory a block can use on sm_90
SM_SMEM = 233_472        # shared memory of an SM, 1024 bytes of it reserved for each CTA
MAX_CLUSTER = 8          # the portable cluster size
PANELS = (64, 32)        # panel widths, widest first
TILE_ROWS = (8, 32, 128)  # rows of x a tile: wgmma's N
STAGE_BYTES = 65_536     # qx buffers in flight, at most


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("int8_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_launch.argtypes = [i32] + [ptr] * 5 + [i32] * 10 + [ptr]
        lib.int8_matmul_launch.restype = i32
        lib.int8_matmul_check_quotient.argtypes = [i32, i32, i32, ptr, ptr]
        lib.int8_matmul_check_quotient.restype = i32
        lib.int8_matmul_error_string.argtypes = [i32]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _fail(msg: str):
    raise ValueError(f"int8_matmul kernel: {msg}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(itemsize: int, nt: int, per: int, mt: int, stages: int) -> int:
    """Dynamic shared memory of a CTA, as the kernel's ``Layout`` counts it:
    the K slice (``per`` blocks of 128 x ``nt`` elements), over which the
    int8 panel, the qx buffers and the int32 partials come to lie; then the
    mbarriers, column maxima, scales and reciprocals."""
    w_bytes = per * BLOCK_K * nt * itemsize
    q_bytes = per * nt * BLOCK_K
    data = max(w_bytes, q_bytes + stages * mt * BLOCK_K, q_bytes + mt * nt * 4,
               q_bytes + (WG_ROWS - nt) * BLOCK_K)
    data = _cdiv(data, 1024) * 1024
    return data + 8 * (per + stages) + 12 * nt


@dataclass(frozen=True)
class Plan:
    """The kernel's partition of ``x (M, K) @ w (K, N)``."""

    nt: int        # panel width: columns of w a cluster owns over all of K
    cluster: int   # CTAs of a cluster, each one K slice of the panel
    per: int       # 128-deep k blocks a CTA holds (the last CTA may hold fewer)
    mt: int        # rows of x a tile (wgmma's N)
    stages: int    # qx buffers
    smem: int      # dynamic shared memory of a CTA, bytes
    panels: int    # clusters: ceil(N / nt)
    kblocks: int   # ceil(K / 128)

    @property
    def ctas(self) -> int:
        return self.cluster * self.panels

    def k_slices(self) -> list[tuple[int, int]]:
        """The ``[k0, k1)`` range of K each CTA of a cluster holds."""
        K = self.kblocks * BLOCK_K
        return [(r * self.per * BLOCK_K, min(K, (r + 1) * self.per * BLOCK_K))
                for r in range(self.cluster)]


@functools.lru_cache(maxsize=256)
def plan(M: int, N: int, K: int, itemsize: int, sms: int = 132) -> Plan | None:
    """The partition for these shapes, or None when no K slice fits.

    Every (panel width, cluster size) whose CTAs fit is a candidate; the
    cluster size is cut back so that no CTA's K slice is empty. The choice
    goes to enough CTAs for two on each SM, then to CTAs small enough for
    two to share an SM (the copy of one under the quantization of the
    other), then to the wider panel (128-byte rows of bf16, no rows of the
    wgmma wasted), then to the smaller cluster, then to more qx buffers."""
    mt = next(t for t in TILE_ROWS if M <= t or t == TILE_ROWS[-1])
    kblocks = _cdiv(K, BLOCK_K)
    best, best_key = None, None
    for nt in PANELS:
        for c in (1, 2, 4, 8):
            if c > kblocks:
                break
            per = _cdiv(kblocks, c)
            cluster = _cdiv(kblocks, per)
            for stages in range(1, min(per, max(1, STAGE_BYTES // (mt * BLOCK_K))) + 1):
                smem = smem_bytes(itemsize, nt, per, mt, stages)
                if smem > SMEM_LIMIT:
                    break
                p = Plan(nt, cluster, per, mt, stages, smem, _cdiv(N, nt), kblocks)
                resident = SM_SMEM // (smem + 1024)  # CTAs an SM holds
                key = (min(p.ctas, 2 * sms), min(resident, 2), nt, -cluster, stages)
                if best_key is None or key > best_key:
                    best, best_key = p, key
    return best


def int8_matmul_cuda(x, w):
    """Launch the int8 matmul: x ``(..., K)``, w ``(K, N)`` → ``(..., N)``
    in ``x.dtype``. The checks build no message unless they fail: the
    wrapper runs 224 times a forward of a Llama-3-8B model."""
    if not x.is_cuda:
        _fail(f"takes CUDA tensors, got a tensor on {x.device}")
    dev = x.device
    if w.device != dev:
        _fail(f"w lies on {w.device}, x on {dev}")
    if x.dtype != w.dtype or x.dtype not in _KIND:
        _fail(f"x and w must both be float32 or both bfloat16, got {x.dtype} and {w.dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0] or w.shape[0] == 0:
        _fail(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not contract over K >= 1")
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    w = w.contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if out.numel():
        p = plan(M, N, K, x.element_size(), _sms(dev.index))
        if p is None:
            _fail(f"K = {K} is too deep for a cluster of {MAX_CLUSTER} CTAs ({x.dtype}): no K "
                  f"slice fits {SMEM_LIMIT} bytes of shared memory")
        if M >= 2**31 or p.panels > 65535:
            _fail(f"shape ({M}, {K}) @ ({K}, {N}) exceeds the kernel's index range")
        qx = torch.empty((M, p.kblocks * BLOCK_K), dtype=torch.int8, device=dev)
        sx = torch.empty((M,), dtype=torch.float32, device=dev)
        # TMA reads w where its rows are 16-byte aligned; other w by plain loads.
        use_tma = int((N * w.element_size()) % 16 == 0 and w.data_ptr() % 16 == 0)
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.int8_matmul_launch(_KIND[x.dtype], x2.data_ptr(), w.data_ptr(),
                                        qx.data_ptr(), sx.data_ptr(), out.data_ptr(), M, N, K,
                                        p.nt, p.cluster, p.per, p.mt, p.stages, use_tma, p.smem,
                                        stream)
        if rc != 0:
            raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc} "
                               f"({lib.int8_matmul_error_string(rc).decode()})")
        record_launch("int8_matmul")
    return out.reshape(lead + (N,))


def quotient_disagreements(stride: int = 1, device="cuda") -> tuple[int, int]:
    """The kernel's self-check of its bf16 division (``check_quotient`` in
    the source): over every ``stride``-th significand of the scale (all 2^23
    at stride 1) and every bf16 value whose quotient the kernels meet, the
    count of pairs where the division the kernels compute differs from
    ``__fdiv_rn``, and the count of pairs compared. No disagreement means
    the bf16 path is the reference's division."""
    dev = torch.device(device)
    if dev.type != "cuda":
        _fail(f"the self-check runs on the card, got {dev}")
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.int8_matmul_check_quotient(0, -(-(1 << 23) // stride), stride,
                                            counts.data_ptr(),
                                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul self-check launch failed: CUDA error {rc} "
                           f"({lib.int8_matmul_error_string(rc).decode()})")
    bad, pairs = counts.tolist()
    return bad, pairs
