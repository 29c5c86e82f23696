"""Wrapper of the fused paged decode attention kernel (``csrc/paged_decode.cu``).

The CUDA counterpart of the TPU kernel ``paged_attention_kernel``
(``accelerate_tpu/ops/pallas/paged_decode.py:64``): each slot's block chain
is read straight from the pool, dequantized when ``k_scale``/``v_scale`` are
given, and run through the math of ``cached_attention`` (GQA, causality on
chain order, the pool mask, windows in valid-slot distance, softcap, a query
chunk of any S). Slots with ``active == 0`` walk nothing and give zeros. Its
plain version is ``ops/paged_attention.paged_attention_plain`` (the plain
gather, then ``cached_attention``); the two agree to a tolerance: the
kernel sums in another order. ``ops/paged_attention.paged_decode_split_reference``
runs the kernel's partition and merge in plain PyTorch (for the tests).

The kernel is flash-decoding: a CTA per (KV head, chain split, slot x
16-row tile) writes its split's online-softmax state to an f32 scratch and a
second kernel merges the splits in a fixed order. :func:`plan` chooses the
split length and the ring of stages and counts the shared memory and the
scratch; it is pure Python (tested on the CPU) and the C launcher refuses a
shared-memory size that differs from its own count.

Takes CUDA tensors only — CPU tensors reach the plain version through the
registry — checks device, dtypes, shapes, alignment and the shared-memory
capacity, allocates the output and the scratch with ``torch.empty``,
launches on the current stream, raises on a launch error and counts each
call as one ``paged_decode`` launch (two CUDA kernels). A call launches no
other device work when ``active`` is bool (or None), ``q_positions`` int32
or int64, the tables and the mask int32, and every tensor contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..registry import record_launch
from ._build import load

_Q_KIND = {torch.float32: 0, torch.bfloat16: 1}
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELT = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
HEAD_DIMS = (64, 128, 256)
CONSUMERS = 3        # consumer warps a CTA (one more warp is the producer)
ROWS = 16            # query rows a CTA: G * S padded to a multiple of 16
LAUNCHES = 2         # CUDA kernels a call: the splits, then their merge
NUM_SMS = 132        # H100 SXM
CTAS_PER_SM = 3      # plan() aims at one wave of resident CTAs: three an SM (registers)
RING_BUDGET = 72 * 1024  # shared memory under which the ring gets 2 stages a consumer
SMEM_LIMIT = 227 * 1024  # H100: 227 KB a block
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("paged_decode")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.paged_decode_launch.argtypes = (
            [i32, i32] + [ptr] * 7 + [i32, i64, ptr, ptr, i32, ptr, ptr] + [i32] * 10
            + [i32, i32, f32, f32, i64, ptr])
        lib.paged_decode_launch.restype = i32
        lib.paged_decode_error_string.argtypes = [i32]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg):
    """Raise with ``msg`` (a string, or a function making one: a call
    formats no message unless it fails) when ``cond`` is false."""
    if not cond:
        raise ValueError(f"paged_decode kernel: {msg() if callable(msg) else msg}")


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def smem_bytes(D: int, bs: int, M: int, split_blocks: int, stages: int, q_elt: int,
               kv_elt: int, has_mask: bool, quant: bool, use_rank: bool) -> int:
    """Dynamic shared memory of one CTA, region by region as
    ``make_layout`` in ``csrc/paged_decode.cu`` counts it: the stages'
    mbarriers, each consumer's scores, probabilities, row stats and key
    ranks, the rows' positions and ranks, the chain's per-block valid counts
    (a window with a mask), the split's table entries, each stage's mask
    and scale rows, the query tile, then 1024 bytes of alignment and the
    ring of K and V tiles (bs x D each), which the consumers' final states
    reuse."""
    off = _up(2 * stages * 8, 16)
    off += _up(CONSUMERS * ROWS * bs * 4, 16)
    off += _up(CONSUMERS * ROWS * (bs * 4 + 16), 16)
    off += _up(CONSUMERS * 3 * ROWS * 4, 16)
    off += _up(CONSUMERS * bs * 4, 16)
    off += _up(2 * ROWS * 4, 16)
    off += _up(M * 4 if use_rank else 0, 16)
    off += _up(split_blocks * 4, 16)
    off += _up(stages * ((bs * 4 if has_mask else 0) + (2 * bs * 4 if quant else 0)), 16)
    off += _up(ROWS * (D * q_elt + 16), 16)
    return off + 1024 + max(stages * 2 * bs * D * kv_elt, CONSUMERS * ROWS * D * 4)


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, Hkv: int, D: int, bs: int, M: int, *, q_dtype=torch.bfloat16,
         kv_dtype=torch.bfloat16, has_mask: bool = True, use_rank: bool = False) -> dict:
    """The kernel's partition of a call. Each chain of M blocks is cut into
    ``splits`` runs of ``split_blocks`` whole blocks (the last may be
    shorter), so that the grid of ``Hkv x splits x B * row_tiles`` CTAs comes
    near ``CTAS_PER_SM`` CTAs an SM, the wave the card holds at once (or one
    CTA a block when the chain is too short for that). Measured on the H100
    (PERF.md section 6): the kernel is bound by latency where the pool is int8
    or the chains are short, and a CTA that waits for a second wave costs
    more than a split merged; ``ranges`` lists each split's blocks
    ``[j0, j1)``. The ring has two stages a consumer warp when the CTA's
    shared memory stays under ``RING_BUDGET`` (three CTAs an SM), else one.
    ``scratch_floats`` is the f32 scratch: each split's (m, l, o) for every
    (slot, query, head) row. Cached: the result is shared, not to be changed."""
    G = H // Hkv
    row_tiles = -(-(G * S) // ROWS)
    base = B * Hkv * row_tiles
    n = min(M, -(-CTAS_PER_SM * NUM_SMS // base))  # splits that would fill the wave
    split_blocks = -(-M // n)
    splits = -(-M // split_blocks)
    mma = q_dtype == torch.bfloat16 and kv_dtype != torch.float32
    q_elt = 2 if mma else 4
    kv_elt = _ELT[kv_dtype]
    quant = kv_dtype == torch.int8
    layout = (D, bs, M, split_blocks)
    flags = (q_elt, kv_elt, has_mask, quant, use_rank)
    stages = 2 * CONSUMERS
    smem = smem_bytes(*layout, stages, *flags)
    if smem > RING_BUDGET:
        stages = CONSUMERS
        smem = smem_bytes(*layout, stages, *flags)
    return {"split_blocks": split_blocks, "splits": splits, "row_tiles": row_tiles,
            "ctas": splits * base, "stages": stages, "smem": smem, "mma": mma,
            "ranges": tuple((j, min(M, j + split_blocks)) for j in range(0, M, split_blocks)),
            "scratch_floats": splits * B * S * H * (D + 2), "launches": LAUNCHES}


def paged_decode_cuda(q, k_pool, v_pool, block_tables, *, q_positions, pool_mask=None,
                      window=None, softcap=None, scale=None, active=None, k_scale=None,
                      v_scale=None):
    """Launch the fused decode attention. q ``(B, S, H, D)``; pools ``(N, bs,
    Hkv, D)`` (bf16, f32, or int8 with ``(N, bs)`` f32 scales); tables
    ``(B, M)``; ``q_positions`` ``(S,)`` or ``(B, S)``; ``pool_mask``
    ``(N, bs)``; ``active`` ``(B,)``. Returns ``(B, S, H, D)``: f32 for an
    int8 pool, else the promotion of q's and the pool's types. D is 64, 128
    or 256 and bs a multiple of 16."""
    _check(q.is_cuda, lambda: f"takes CUDA tensors, got a tensor on {q.device}")
    dev = q.device
    _check(q.dim() == 4 and q.dtype in _Q_KIND,
           lambda: f"q must be a (B, S, H, D) float32 or bfloat16 tensor, got "
           f"{tuple(q.shape)} {q.dtype}")
    B, S, H, D = q.shape
    _check(k_pool.dim() == 4 and tuple(v_pool.shape) == tuple(k_pool.shape)
           and k_pool.dtype == v_pool.dtype and k_pool.dtype in _KV_KIND,
           lambda: f"pools must be two (N, bs, Hkv, D) tensors of one type in "
           f"{list(_KV_KIND)}, got {tuple(k_pool.shape)} {k_pool.dtype} and "
           f"{tuple(v_pool.shape)} {v_pool.dtype}")
    N, bs, Hkv, Dk = k_pool.shape
    _check(Dk == D and Hkv > 0 and H % Hkv == 0,
           lambda: f"q heads {H} x {D} do not group over pool heads {Hkv} x {Dk}")
    _check(D in HEAD_DIMS and D * _ELT[k_pool.dtype] % 128 == 0,
           lambda: f"head width {D} must be one of {HEAD_DIMS}, and a multiple of 128 bytes of "
           f"{k_pool.dtype} (the pool's rows are read in 128-byte TMA boxes)")
    _check(bs % 16 == 0, lambda: f"block size {bs} must be a multiple of 16")
    quant = k_scale is not None
    _check(quant == (v_scale is not None), "k_scale and v_scale come together")
    _check(quant == (k_pool.dtype == torch.int8),
           "an int8 pool needs k_scale and v_scale, and only an int8 pool takes them")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B and block_tables.shape[1] > 0,
           lambda: f"block_tables must be (B={B}, M >= 1), got {tuple(block_tables.shape)}")
    M = block_tables.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                    ("q_positions", q_positions), ("pool_mask", pool_mask),
                    ("active", active), ("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t is None or t.device == dev, lambda: f"{name} must lie on q's device, {dev}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (N, bs),
                   lambda: f"{name} must be ({N}, {bs}) float32, got {tuple(t.shape)} {t.dtype}")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    if pool_mask is not None:
        _check(tuple(pool_mask.shape) == (N, bs), lambda: f"pool_mask must be ({N}, {bs})")
        pool_mask = pool_mask.to(torch.int32).contiguous()
    pos = q_positions
    _check(pos.dim() in (1, 2) and pos.shape[-1] == S and (pos.dim() == 1 or pos.shape[0] == B),
           lambda: f"q_positions must be ({S},) or ({B}, {S}), got {tuple(pos.shape)}")
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    pos_bstride = 0 if pos.dim() == 1 else S  # one row shared by every slot: stride 0
    if active is not None:
        _check(tuple(active.shape) == (B,),
               lambda: f"active must be ({B},), got {tuple(active.shape)}")
        if active.dtype not in (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64):
            active = active != 0
        active = active.contiguous()
    _check(softcap is None or softcap > 0, lambda: f"softcap must be positive, got {softcap}")
    use_rank = window is not None and pool_mask is not None
    p = plan(B, S, H, Hkv, D, bs, M, q_dtype=q.dtype, kv_dtype=k_pool.dtype,
             has_mask=pool_mask is not None, use_rank=use_rank)
    _check(p["smem"] <= SMEM_LIMIT,
           lambda: f"a CTA needs {p['smem']} bytes of shared memory (block size {bs}, chain "
           f"of {M} blocks), over the {SMEM_LIMIT} a block can have")
    _check(B * p["row_tiles"] <= 65535 and p["splits"] <= 65535 and N * bs < 2**31,
           lambda: f"grid ({Hkv}, {p['splits']}, {B * p['row_tiles']}) or pool rows "
           f"{N * bs} too large")
    out_dt = torch.float32 if quant else torch.promote_types(q.dtype, v_pool.dtype)
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("k_scale", k_scale),
                    ("v_scale", v_scale), ("pool_mask", pool_mask)):
        _check(t is None or t.data_ptr() % 16 == 0,
               lambda: f"{name} must be 16-byte aligned (TMA, bulk copies, 16-byte loads)")
    tables = block_tables.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, D), dtype=out_dt, device=dev)
    if out.numel() == 0:
        return out
    scratch = torch.empty((p["scratch_floats"],), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.paged_decode_launch(
            _Q_KIND[q.dtype], _KV_KIND[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ptr(k_scale), ptr(v_scale), tables.data_ptr(), pos.data_ptr(),
            pos.element_size(), pos_bstride, ptr(pool_mask), ptr(active),
            0 if active is None else active.element_size(), out.data_ptr(), scratch.data_ptr(),
            B, S, H, Hkv, D, N, bs, M, p["split_blocks"], p["stages"],
            int(window is not None), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), scale, p["smem"], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc} "
                           f"({lib.paged_decode_error_string(rc).decode()})")
    record_launch("paged_decode")
    return out
