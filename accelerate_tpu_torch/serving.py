"""Continuous batching over a paged KV pool — the PyTorch port of the paged
half of ``accelerate_tpu/serving.py``'s ``ContinuousBatcher``.

A fixed number of slots decode together and a slot refills the moment its
request finishes. The KV cache is a block pool (``ops/paged_attention.py``):
``num_blocks`` blocks of ``block_size`` token slots shared by every slot
through per-slot block tables of static ``max_blocks_per_slot`` width.

- **Allocation is host free-list surgery**: a request reserves its whole
  worst-case chain at admission (the only capacity decision point), and a
  finished request's chain is freed when its output is collected. Stale bits
  of reused blocks are masked by a chain-frontier comparison.
- **Cross-request prefix sharing**: full, hole-free blocks are indexed by
  their chain-prefix tokens, and a request whose prompt starts with an
  indexed chain aliases those blocks (refcounted). ``set_prefix`` is the
  special case of one prefix shared by every request.
- **Chunked prefill**: prompts split into ``prefill_chunk``-token chunks, and
  each engine iteration dispatches at most ONE chunk between decode windows.
- **Decode windows**: every ``sync_every`` steps run over a contiguous view of
  each slot's chain, assembled by op ``paged_gather`` (the hand-written CUDA
  kernel on the card, ``ops/kernels/paged_gather.py``), with one uniform
  write window; the written columns are then scattered onto the chain tails.
- **One-window lookahead**: each window's report (active, n_out, out_buf) is
  copied to pinned host memory behind a CUDA event and read only after the
  next window is enqueued, so the host never waits on the window it just
  dispatched.

The JAX version compiles each of these steps into a program; here they are
plain functions on tensors, and the pool and slot state are updated in place
where the JAX programs donate their buffers.

Greedy output is exactly ``generate(model, prompt)`` per request. A sampled
request draws from its own stream, a counter-based hash of (engine seed,
request id, step), so its tokens do not depend on traffic or slot
assignment.

``matmul_precision="int8"`` serves a memoized config variant of the module
(``generation._precision_variant``) whose block projections run through the
int8 matmul kernel; the parameters are shared, quantized inside the matmul.

Not ported yet, and raising when asked for: contiguous serving
(``paged=False``) and ``compact``, speculative decoding (``speculative_k``,
``draft_model``), SLO targets, the request tracer and streaming sink, and
the audit/fingerprint faces.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .generation import _precision_variant, _unwrap, _warp_scores, mask_positions
from .ops.int8 import quantize_kv
from .ops.paged_attention import gather_block_mask, gather_view, init_kv_pool
from .ops.registry import resolve_spec
from .utils.device import host_to_device, resolve_device

_M32 = 0xFFFFFFFF


def _hash32(x):
    """PCG output hash on 32-bit values held in int64 (a Python int or an
    int64 tensor); every intermediate stays below 2**62."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def _gumbel(keys, steps, vocab: int):
    """(B, V) Gumbel noise from per-row request keys and step indices."""
    row = _hash32(keys ^ _hash32(steps.long()))
    col = _hash32(torch.arange(vocab, device=keys.device, dtype=torch.int64))
    bits = _hash32((row[:, None] + col[None]) & _M32)
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def _first_stop_end(row: np.ndarray, stops: tuple) -> int | None:
    """End index (exclusive) of the earliest-ending completed stop-sequence
    occurrence in ``row``, or None."""
    best = None
    for s in stops:
        L = int(s.size)
        if L > row.size:
            continue
        win = np.lib.stride_tricks.sliding_window_view(row, L)
        hits = np.nonzero((win == s).all(axis=1))[0]
        if hits.size:
            end = int(hits[0]) + L
            if best is None or end < best:
                best = end
    return best


# Ring bound on per-request latency samples and the dispatch log.
_SLO_HISTORY = 4096


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # (P,) real tokens, no padding
    max_new: int
    temperature: float
    eos: int  # -1 = none
    stop: tuple  # tuple of np.int32 arrays; () = none
    submit_t: float = 0.0


class ContinuousBatcher:
    """Slot-based continuous batching over a decoder-only cached model.

    Usage::

        engine = ContinuousBatcher(model, batch_slots=8, max_new_tokens=64,
                                   max_cache_len=4096, eos_token_id=eos)
        ids = [engine.submit(p) for p in prompts]       # any ragged lengths
        outputs = engine.run()                           # {rid: np.ndarray}

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``), where
    the model's parameters must live. ``kernels="off"`` runs the plain
    PyTorch versions instead of the CUDA kernels (the gather and, with
    ``matmul_precision="int8"``, the int8 matmul): the comparison arm.
    """

    def __init__(
        self,
        model,
        *,
        batch_slots: int,
        max_new_tokens: int,
        max_cache_len: int,
        params=None,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        eos_token_id: int | None = None,
        pad_token_id: int = 0,
        cache_dtype=torch.bfloat16,
        bucket_sizes: tuple = (16, 32, 64, 128, 256, 512, 1024),
        sync_every: int = 8,
        paged: bool = True,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_chunk: int | None = None,
        max_tokens_per_request: int | None = None,
        slo=None,
        kernels: str | None = None,
        speculative_k: int = 0,
        draft_model=None,
        kv_quant: str | None = None,
        matmul_precision: str | None = None,
        trace_requests: bool = False,
        device=None,
    ):
        unported = {
            "paged=False (contiguous serving)": not paged,
            "speculative_k / draft_model": bool(speculative_k) or draft_model is not None,
            "slo targets": slo is not None,
            "trace_requests (request tracer)": trace_requests,
        }
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"ContinuousBatcher option {name} is not ported yet (ROADMAP.md, module queue)"
                )
        module, mparams = _unwrap(model)
        if matmul_precision in ("", "default"):
            matmul_precision = None
        if matmul_precision is not None:
            module = _precision_variant(module, matmul_precision)
        self.module = module
        self.params = params if params is not None else mparams
        if self.params is None:
            raise ValueError("Model has no params; pass params= or init the model first.")
        if hasattr(module, "encode"):
            raise ValueError("ContinuousBatcher supports decoder-only cached models.")
        self.device = resolve_device(device)
        if module.device != self.device:
            raise ValueError(f"model lives on {module.device}, the engine was asked for {self.device}")
        self.B = batch_slots
        self.max_new = max_new_tokens
        self.C = max_cache_len
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.eos = -1 if eos_token_id is None else eos_token_id
        self.pad = pad_token_id
        self.cache_dtype = cache_dtype
        self.buckets = tuple(sorted(bucket_sizes))
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        # Decode steps enqueued between host checks: finished slots idle at
        # most sync_every-1 extra steps, accounted in the chain reservation.
        self.sync_every = sync_every
        if kv_quant in ("", "none", "off"):
            kv_quant = None
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        self.kv_quant = kv_quant
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks is None:
            num_blocks = max(1, self.C // self.block_size)
        self.num_blocks = int(num_blocks)
        if prefill_chunk is None:
            # Largest block-aligned chunk within the biggest bucket: full
            # (non-final) chunks stay hole-free and block-aligned, which is
            # what makes their blocks registrable for cross-request sharing.
            prefill_chunk = min(self.buckets[-1], max(
                self.block_size, (self.buckets[-1] // self.block_size) * self.block_size))
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1 or self.prefill_chunk > self.buckets[-1]:
            raise ValueError(f"prefill_chunk must be in [1, largest bucket "
                             f"{self.buckets[-1]}], got {prefill_chunk}")
        # Per-request token ceiling (prompt incl. any shared prefix + output).
        # The static per-slot table additionally holds the final chunk's
        # bucket padding (_bucket rounds a <= prefill_chunk remainder up to at
        # most _bucket(prefill_chunk)) and 3 windows of post-finish slack
        # (finish detection + the one-window sync lookahead), block-rounded.
        if max_tokens_per_request is None:
            max_tokens_per_request = self.buckets[-1] + self.max_new
        self.max_tokens_per_request = int(max_tokens_per_request)
        self._decode_slack = 3 * self.sync_every
        worst_chain = (self.max_tokens_per_request + self._bucket(self.prefill_chunk)
                       + self._decode_slack)
        self.max_blocks_per_slot = -(-worst_chain // self.block_size)
        self.kernels = resolve_spec(kernels)
        self._seed = int(seed)
        self._queue: deque[_Request] = deque()
        self._next_rid = 0
        self._results: dict[int, np.ndarray] = {}
        # Per-request wall-clock marks and the admission loop's decision
        # tallies (ring-bounded like the JAX engine's).
        self._req_times: dict[int, dict] = {}
        self._decisions = {"admitted": 0, "chunked_prefills": 0, "aliased_blocks": 0}
        # Host-side trace of dispatches ("chunk:<P>" / "decode").
        self._dispatch_log: list[str] = []
        self._prefix_tokens: np.ndarray | None = None
        self.reset()

    # ------------------------------------------------------------- lifecycle
    def reset(self, keep_prefix: bool = True):
        """Fresh pool, tables, free list and slot state. Queued requests and
        finished results survive; in-flight slots are wiped. The shared-prefix
        TOKENS survive ``keep_prefix=True`` (the next wave re-prefills them
        lazily), but all resident blocks are dropped."""
        B, dev = self.B, self.device
        self._pool = init_kv_pool(self.module, self.num_blocks, self.block_size,
                                  dtype=self.cache_dtype, quant=self.kv_quant, device=dev)
        self._tok = torch.full((B,), self.pad, dtype=torch.int32, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._out_buf = torch.full((B, self.max_new), self.pad, dtype=torch.int32, device=dev)
        self._keys = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._slot_max = torch.full((B,), self.max_new, dtype=torch.int32, device=dev)
        self._slot_temp = torch.full((B,), float(self.temperature or 0.0), dtype=torch.float32,
                                     device=dev)
        self._slot_eos = torch.full((B,), self.eos, dtype=torch.int32, device=dev)
        self._slot_req: list[_Request | None] = [None] * B
        # Host-side paged bookkeeping. Block 0 is the reserved trash block.
        self._tables_np = np.zeros((B, self.max_blocks_per_slot), np.int32)
        self._slot_len = np.zeros((B,), np.int64)      # chain slots (incl holes)
        self._slot_base = np.zeros((B,), np.int64)     # real tokens in chain
        self._slot_mode = ["free"] * B                  # free | prefill | decode
        self._slot_chunks: list[list] = [[] for _ in range(B)]
        self._slot_blocks: list[list[int]] = [[] for _ in range(B)]
        self._slot_tokens: list[np.ndarray | None] = [None] * B
        self._free_blocks = list(range(1, self.num_blocks + 1))
        self._block_ref = np.zeros((self.num_blocks + 1,), np.int64)
        self._share_index: dict[bytes, int] = {}
        self._block_key: dict[int, bytes] = {}
        if not keep_prefix:
            self._prefix_tokens = None

    def set_prefix(self, prefix_ids) -> int:
        """Shared-prefix caching: every later ``submit()`` passes only its
        suffix, and outputs are exactly ``generate(model, prefix + suffix)``.
        The stored prefix is prepended to each prompt; the first request
        prefills it into blocks and later requests alias them. Needs a fresh
        engine (no admitted requests, no prior prefix). Returns its length."""
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        if prefix.size == 0:
            raise ValueError("empty prefix")
        if any(m != "free" for m in self._slot_mode) or self._prefix_tokens is not None:
            raise RuntimeError(
                "set_prefix needs a fresh cache (no admitted requests, no "
                "prior prefix): call reset(keep_prefix=False) first."
            )
        P = int(prefix.size)
        if P + self.buckets[0] + self.max_new > self.max_tokens_per_request:
            raise ValueError(
                f"prefix length {P} leaves no room for even one smallest-bucket "
                f"request within max_tokens_per_request={self.max_tokens_per_request}"
            )
        self._prefix_tokens = prefix
        return P

    @property
    def blocks_in_use(self) -> int:
        """Pool blocks currently owned by at least one chain."""
        return self.num_blocks - len(self._free_blocks)

    @property
    def kv_cache_bytes(self) -> int:
        """Persistent device bytes of the pool (trash block and scales included)."""
        return sum(t.numel() * t.element_size() for name, t in self._pool.items()
                   if name != "mask")

    def pool_stats(self) -> dict:
        """Host-side pool snapshot (no device readback)."""
        return {
            "paged": True,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "blocks_free": len(self._free_blocks),
            "blocks_in_use": self.blocks_in_use,
            "shared_blocks": len(self._block_key),
            "max_blocks_per_slot": self.max_blocks_per_slot,
            "pool_bytes": self.kv_cache_bytes,
            "kv_quant": self.kv_quant,
        }

    def slo_report(self) -> dict:
        """Per-request TTFT/TPOT samples (host wall clock, sync-cadence
        granularity) and the admission loop's decision tallies."""
        ttft = [t["first_token"] - t["submit"] for t in self._req_times.values()
                if "first_token" in t]
        tpot = [t["tpot"] for t in self._req_times.values() if "tpot" in t]
        return {"decisions": dict(self._decisions), "ttft_s": ttft, "tpot_s": tpot,
                "requests": len(self._req_times)}

    def submit(self, prompt_ids, *, max_new_tokens: int | None = None,
               temperature: float | None = None, eos_token_id: int | None = None,
               stop_sequences=None, request_id: int | None = None) -> int:
        """Queue one prompt (1-D array of token ids). Returns a request id.

        Per-request overrides (engine defaults when omitted):
        ``max_new_tokens`` (<= the engine's), ``temperature`` (0 = greedy),
        ``eos_token_id``, and ``stop_sequences`` — generation stops at the
        first completed occurrence, which is INCLUDED in the returned ids;
        detection runs at the sync cadence but the output is truncated at the
        exact first occurrence. ``request_id`` threads an external id."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if self._prefix_tokens is not None:
            prompt = np.concatenate([self._prefix_tokens, prompt])
        max_new = self.max_new if max_new_tokens is None else int(max_new_tokens)
        if prompt.size > self.max_tokens_per_request - max_new:
            raise ValueError(
                f"prompt length {prompt.size} (incl. prefix) exceeds "
                f"max_tokens_per_request={self.max_tokens_per_request} "
                f"minus the output reservation; raise max_tokens_per_request."
            )
        if not (1 <= max_new <= self.max_new):
            raise ValueError(
                f"per-request max_new_tokens must be in [1, {self.max_new}] "
                f"(the engine's max_new_tokens sizes the output buffer), got {max_new}"
            )
        temp = float(self.temperature or 0.0) if temperature is None else float(temperature)
        eos = self.eos if eos_token_id is None else int(eos_token_id)
        stop = ()
        if stop_sequences:
            stop = tuple(np.asarray(s, np.int32).reshape(-1) for s in stop_sequences)
            if any(s.size == 0 for s in stop):
                raise ValueError("empty stop sequence")
        if request_id is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            rid = int(request_id)
            if rid < 0:
                raise ValueError(f"request_id must be >= 0, got {request_id}")
            if (rid in self._results or any(q.rid == rid for q in self._queue)
                    or any(r is not None and r.rid == rid for r in self._slot_req)):
                raise ValueError(f"request_id {rid} is already in use")
            self._next_rid = max(self._next_rid, rid + 1)
        now = time.monotonic()
        self._queue.append(_Request(rid, prompt, max_new, temp, eos, stop, now))
        self._req_times[rid] = {"submit": now}
        while len(self._req_times) > _SLO_HISTORY:
            self._req_times.pop(next(iter(self._req_times)))
        return rid

    # ------------------------------------------------------------- sampling
    def _request_key(self, rid: int) -> int:
        """A request's sampling stream: a hash of (engine seed, request id)."""
        return _hash32(_hash32(self._seed & _M32) ^ (rid & _M32))

    def _sample_rows(self, logits, keys, step_idx, temps, sampled: bool):
        """Per-row draw: rows with temperature 0 take the raw argmax (exact
        greedy); others take Gumbel-max over the warped scores with noise
        from their request key and step index. ``sampled`` (host-known: does
        any live request sample?) skips the noise when no row needs it."""
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not sampled:
            return greedy
        safe_t = torch.where(temps > 0.0, temps, 1.0)
        scores = _warp_scores(logits.float() / safe_t[:, None], 1.0, self.top_k, self.top_p)
        noisy = scores + _gumbel(keys, step_idx, scores.shape[-1])
        return torch.where(temps > 0.0, torch.argmax(noisy, dim=-1).to(torch.int32), greedy)

    # ------------------------------------------------------- paged programs
    def _paged_view_cache(self, tables, lens, write_cols: int):
        """Gather the chains of ``tables`` ((b, M) int32 on the device) into a
        contiguous view cache plus a fresh ``write_cols``-wide write window at
        one uniform offset — the shape the unmodified model forward runs on.
        The frontier comparison (``lens``) masks stale bits of reused blocks.
        Slots with an empty chain are inactive: the kernel writes zeros there
        and the plain version masked garbage; attention ignores both."""
        pool = self._pool
        t = tables.shape[1] * self.block_size
        active = lens > 0
        # int8 pools dequantize here, at view assembly.
        scales_k, scales_v = pool.get("k_scale"), pool.get("v_scale")
        out_dt = self.cache_dtype if scales_k is not None else None
        view_k = gather_view(pool["k"], tables, active=active, scales=scales_k,
                             out_dtype=out_dt, kernels=self.kernels)  # (L, b, T, Hkv, D)
        view_v = gather_view(pool["v"], tables, active=active, scales=scales_v,
                             out_dtype=out_dt, kernels=self.kernels)
        vmask = gather_block_mask(pool["mask"], tables)  # (b, T)
        cols = torch.arange(t, device=self.device)
        vmask = torch.where(cols[None] < lens[:, None], vmask, 0)
        window = view_k.new_zeros(view_k.shape[:2] + (write_cols,) + view_k.shape[3:])
        return {
            "k": torch.cat([view_k, window], dim=2),
            "v": torch.cat([view_v, window], dim=2),
            "pos": t,
            "kv_mask": torch.cat([vmask, vmask.new_zeros((vmask.shape[0], write_cols))], dim=1),
        }

    def _scatter_pool(self, blk, off, k_new, v_new, mask_new):
        """Write freshly computed view columns onto chain tails, in place (the
        JAX programs donate the pool and return an updated copy). An int8 pool
        quantizes the rows here, one (int8 payload, f32 scale) pair per token
        row, and dequantizes at view assembly."""
        pool = self._pool
        if "k_scale" in pool:
            qk, sk = quantize_kv(k_new)
            qv, sv = quantize_kv(v_new)
            pool["k"][:, blk, off] = qk
            pool["v"][:, blk, off] = qv
            pool["k_scale"][:, blk, off] = sk
            pool["v_scale"][:, blk, off] = sv
        else:
            pool["k"][:, blk, off] = k_new
            pool["v"][:, blk, off] = v_new
        pool["mask"][blk, off] = mask_new

    def _device(self, array, dtype=None):
        return host_to_device(array, self.device, dtype)

    def _chunk_step(self, s: int, row: np.ndarray, mrow: np.ndarray, is_final: bool,
                    req: _Request):
        """Prefill one chunk of slot ``s``'s prompt against the pool: gather
        the slot's chain, run the chunk, scatter its K/V onto the chain tail,
        and sample the request's first token, arming the slot for decode on
        the FINAL chunk. Only the target slot's row runs (the JAX program
        runs all B rows with the others masked; their results are discarded
        there, so the outputs are the same)."""
        bs, t = self.block_size, self.max_blocks_per_slot * self.block_size
        P = int(row.size)
        c0, base_pos = int(self._slot_len[s]), int(self._slot_base[s])
        cache = self._paged_view_cache(self._device(self._tables_np[s:s + 1]),
                                       self._device([c0], torch.int32), P)
        ids, mask = self._device(row[None]), self._device(mrow[None])
        # Token positions continue the slot's REAL-token count, so rope is
        # exact across chunk boundaries and bucket-padding holes.
        out = self.module.apply(self.params, input_ids=ids, attention_mask=mask, cache=cache,
                                positions=mask_positions(mask) + base_pos, kernels=self.kernels)
        idx = c0 + np.arange(P)
        blk = self._device(self._tables_np[s][idx // bs], torch.int64)
        off = self._device(idx % bs, torch.int64)
        self._scatter_pool(blk, off, out["cache"]["k"][:, 0, t:t + P],
                           out["cache"]["v"][:, 0, t:t + P], torch.where(blk != 0, mask[0], 0))
        self._keys[s] = self._request_key(req.rid)
        self._slot_max[s] = req.max_new
        self._slot_temp[s] = req.temperature
        self._slot_eos[s] = req.eos
        first = self._sample_rows(out["logits"][0, -1][None], self._keys[s:s + 1],
                                  torch.zeros((1,), dtype=torch.int32, device=self.device),
                                  self._slot_temp[s:s + 1], req.temperature > 0)[0]
        self._tok[s] = first
        self._pos[s] = base_pos + int(mrow.sum())
        self._n_out[s] = 1
        self._out_buf[s] = self.pad
        self._out_buf[s, 0] = first
        done0 = (first == req.eos) | (req.max_new <= 1)
        self._active[s] = ~done0 if is_final else False

    def _decode_window(self, commit: np.ndarray, force_stop: np.ndarray):
        """``sync_every`` decode steps over every slot's chain view, then one
        scatter of the written columns onto each committed slot's chain tail
        (everything else lands in the trash block with a zero mask). Returns
        the window's report, copied off the card without waiting for it."""
        B, bs, w = self.B, self.block_size, self.sync_every
        t = self.max_blocks_per_slot * bs
        self._active &= ~self._device(force_stop)
        lens_np = self._slot_len.astype(np.int32)
        cache = self._paged_view_cache(self._device(self._tables_np), self._device(lens_np), w)
        sampled = any(r is not None and r.temperature > 0 for r in self._slot_req)
        rows = torch.arange(B, device=self.device)
        tok, pos, n_out, active = self._tok, self._pos, self._n_out, self._active
        out_buf = self._out_buf
        for _ in range(w):
            col = cache["pos"]  # view column this step writes
            feed = torch.where(active, tok, self.pad)
            out = self.module.apply(self.params, input_ids=feed[:, None], cache=cache,
                                    positions=pos[:, None], kernels=self.kernels)
            nxt = self._sample_rows(out["logits"][:, -1], self._keys, n_out, self._slot_temp,
                                    sampled)
            nxt = torch.where(active, nxt, self.pad).to(torch.int32)
            cache = out["cache"]
            kv_col = cache["kv_mask"][:, col]
            cache["kv_mask"][:, col] = torch.where(active, kv_col, 0)
            emit = torch.clamp(n_out, 0, self.max_new - 1).long()
            out_buf[rows, emit] = torch.where(active, nxt, out_buf[rows, emit])
            n_out = n_out + active.to(torch.int32)
            still = active & (nxt != self._slot_eos) & (n_out < self._slot_max)
            tok, pos, active = nxt, pos + 1, still
        self._tok, self._pos, self._n_out, self._active = tok, pos, n_out, active
        # Persist the window: committed slots append their written columns
        # (valid or holed); everything else goes to the trash block.
        idx = lens_np[:, None].astype(np.int64) + np.arange(w)[None]
        chain_col = np.minimum(idx // bs, self.max_blocks_per_slot - 1)
        blk_np = np.where(commit[:, None], np.take_along_axis(self._tables_np, chain_col, 1), 0)
        blk = self._device(blk_np, torch.int64)
        off = self._device(idx % bs, torch.int64)
        written = cache["kv_mask"][:, t:t + w]
        self._scatter_pool(blk, off, cache["k"][:, :, t:t + w], cache["v"][:, :, t:t + w],
                           torch.where(blk != 0, written, 0))
        return self._snapshot((self._active, self._n_out, self._out_buf))

    def _snapshot(self, tensors):
        """Copy ``tensors`` to the host behind an event (pinned memory on the
        card), so reading them later waits only for this point of the stream."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ----------------------------------------------------------------- loop
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError  # guarded in submit()

    def _finish(self, req: _Request, row: np.ndarray):
        """Bank one finished request's output with exact eos/stop truncation
        (tokens decoded past the stop are discarded, so output is
        cadence-independent), and its TTFT/TPOT samples."""
        row = row.copy()
        if req.eos >= 0 and (row == req.eos).any():
            row = row[: int(np.argmax(row == req.eos)) + 1]
        end = _first_stop_end(row, req.stop)
        if end is not None:
            row = row[:end]
        self._results[req.rid] = row
        times = self._req_times.get(req.rid)
        if times is not None:
            times["finish"] = time.monotonic()
            ft = times.get("first_token")
            if ft is not None and row.size > 1:
                times["tpot"] = (times["finish"] - ft) / (row.size - 1)

    def _alias_lookup(self, prompt: np.ndarray):
        """Longest resident block chain whose tokens prefix ``prompt``, capped
        one token short of the whole prompt so the final token always runs
        through a prefill chunk (its logits seed the first sampled token)."""
        bs = self.block_size
        blocks = []
        for k in range(1, (prompt.size - 1) // bs + 1):
            blk = self._share_index.get(prompt[: k * bs].tobytes())
            if blk is None:
                break
            blocks.append(blk)
        return blocks

    def _plan_chunks(self, remainder: np.ndarray, chunk_size: int) -> list:
        """Split the un-aliased prompt tail into exact ``chunk_size`` pieces
        (hole-free, block-aligned — registrable for sharing) plus one final
        ragged piece in (0, chunk_size]."""
        final = (remainder.size - 1) % chunk_size + 1
        n_full = (remainder.size - final) // chunk_size
        return [remainder[i * chunk_size:(i + 1) * chunk_size] for i in range(n_full)] + [
            remainder[n_full * chunk_size:]]

    def _register_shared(self, s: int, c0: int, p: int):
        """Index a hole-free block-aligned chunk's full blocks by their
        chain-prefix tokens so later requests alias them. First writer wins."""
        bs = self.block_size
        if c0 % bs or p % bs:
            return
        toks = self._slot_tokens[s]
        for j in range(p // bs):
            end = c0 + (j + 1) * bs
            blk = self._slot_blocks[s][end // bs - 1]
            key = toks[:end].tobytes()
            if key not in self._share_index:
                self._share_index[key] = blk
                self._block_key[blk] = key

    def _free_chain(self, s: int):
        """Retire slot ``s``'s chain: refcount-decrement every block and
        return rc-0 blocks to the free list (unregistering their share keys)."""
        for blk in self._slot_blocks[s]:
            self._block_ref[blk] -= 1
            if self._block_ref[blk] == 0:
                self._free_blocks.append(blk)
                key = self._block_key.pop(blk, None)
                if key is not None:
                    self._share_index.pop(key, None)
        self._slot_blocks[s] = []
        self._tables_np[s, :] = 0
        self._slot_len[s] = 0
        self._slot_base[s] = 0
        self._slot_tokens[s] = None
        self._slot_req[s] = None
        self._slot_chunks[s] = []
        self._slot_mode[s] = "free"

    def _log_dispatch(self, event: str):
        self._dispatch_log.append(event)
        if len(self._dispatch_log) > 2 * _SLO_HISTORY:
            del self._dispatch_log[:_SLO_HISTORY]

    def _chain_need(self, k: int, chunks: list, max_new: int) -> int:
        bs = self.block_size
        aligned = k * bs + sum(c.size if i + 1 < len(chunks) else self._bucket(c.size)
                               for i, c in enumerate(chunks))
        return aligned + (max_new - 1) + self._decode_slack

    def _admit_paged(self):
        """Fill free slots from the queue: alias resident prefix blocks,
        reserve the WHOLE request's worst-case chain up front (prompt chunks
        with bucket padding + max_new - 1 decode slots + 3 windows of
        finish-detection slack), and stage the chunk plan. Up-front
        reservation makes admission the only capacity decision point."""
        free_slots = [s for s in range(self.B) if self._slot_mode[s] == "free"]
        bs = self.block_size
        while free_slots and self._queue:
            req = self._queue[0]
            blocks = self._alias_lookup(req.prompt)
            k = len(blocks)
            chunks = self._plan_chunks(req.prompt[k * bs:], self.prefill_chunk)
            need = self._chain_need(k, chunks, req.max_new)
            if need > self.max_blocks_per_slot * bs:
                raise AssertionError(
                    f"internal: chain need {need} exceeds the static table "
                    f"({self.max_blocks_per_slot} x {bs}) — submit() validation out of sync"
                )
            need_blocks = -(-need // bs) - k
            if need_blocks > len(self._free_blocks):
                break  # backpressure; the loop dead-ends loudly if nothing can free
            self._queue.popleft()
            s = free_slots.pop(0)
            chain = blocks + [self._free_blocks.pop(0) for _ in range(need_blocks)]
            for blk in chain:
                self._block_ref[blk] += 1
            self._tables_np[s, :] = 0
            self._tables_np[s, : len(chain)] = chain
            self._slot_blocks[s] = chain
            self._slot_len[s] = k * bs
            self._slot_base[s] = k * bs  # aliased region is all real tokens
            self._slot_chunks[s] = chunks
            self._slot_tokens[s] = req.prompt
            self._slot_req[s] = req
            self._slot_mode[s] = "prefill"
            self._decisions["admitted"] += 1
            self._decisions["aliased_blocks"] += k
            if len(chunks) > 1:
                self._decisions["chunked_prefills"] += 1

    def _pick_chunk_slot(self):
        """At most ONE prefill chunk interleaves per engine iteration (the
        bounded-decode-stall contract): the oldest waiting request's."""
        slots = [s for s in range(self.B)
                 if self._slot_mode[s] == "prefill" and self._slot_chunks[s]]
        if not slots:
            return None
        return min(slots, key=lambda s: self._slot_req[s].submit_t)

    def _dispatch_chunk(self, s: int):
        chunk = self._slot_chunks[s].pop(0)
        final = not self._slot_chunks[s]
        if final:
            p = self._bucket(int(chunk.size))
            # Left-aligned inside the bucket: the last real token sits at p-1
            # (its logits row seeds the first sampled token).
            row = np.full((p,), self.pad, np.int32)
            mrow = np.zeros((p,), np.int32)
            row[p - chunk.size:] = chunk
            mrow[p - chunk.size:] = 1
        else:
            p = int(chunk.size)  # exact: hole-free, registrable
            row = chunk.astype(np.int32)
            mrow = np.ones((p,), np.int32)
        c0 = int(self._slot_len[s])
        self._chunk_step(s, row, mrow, final, self._slot_req[s])
        self._log_dispatch(f"chunk:{p}")
        if not final:
            self._register_shared(s, c0, p)
        self._slot_len[s] += p
        self._slot_base[s] += int(chunk.size)
        if final:
            self._slot_mode[s] = "decode"

    def _dispatch_decode(self, force_stop: np.ndarray):
        commit = np.asarray([m == "decode" for m in self._slot_mode], bool)
        for s in np.nonzero(commit)[0]:
            if self._slot_len[s] + self.sync_every > len(self._slot_blocks[s]) * self.block_size:
                raise AssertionError("internal: slot chain reservation exhausted mid-request")
        report = self._decode_window(commit, force_stop)
        self._slot_len[commit] += self.sync_every
        self._log_dispatch("decode")
        # Tag the report with the occupants it describes: by the time it is
        # processed (one window later) a collected slot may host a NEW request.
        req_map = [self._slot_req[s].rid if commit[s] and self._slot_req[s] is not None
                   else None for s in range(self.B)]
        return report, req_map

    def _process_report(self, pending, force_stop: np.ndarray):
        """Consume one decode window's report (active, n_out, out_buf):
        record first-token times, run the host-side stop-sequence scan
        (verdicts ride ``force_stop`` into the NEXT window), bank finished
        requests, and free their chains."""
        (host, event), req_map = pending
        if event is not None:
            event.synchronize()
        active_np, n_np, out_np = (h.numpy() for h in host)
        active_np = active_np.copy()
        now = time.monotonic()
        for s in range(self.B):
            req = self._slot_req[s]
            if req is None or self._slot_mode[s] != "decode" or req_map[s] != req.rid:
                continue  # empty at dispatch, or refilled since
            times = self._req_times.get(req.rid)
            if times is not None and "first_token" not in times and n_np[s] >= 1:
                times["first_token"] = now
            if active_np[s] and req.stop:
                if _first_stop_end(out_np[s][: int(n_np[s])], req.stop) is not None:
                    force_stop[s] = True
            if not active_np[s]:
                self._finish(req, out_np[s][: int(n_np[s])])
                self._free_chain(s)

    def run(self) -> dict[int, np.ndarray]:
        """Drive admits, prefill chunks and decode windows until the queue
        drains and all slots finish. Per iteration: admit; dispatch at most
        ONE prefill chunk; dispatch one decode window; then process the
        PREVIOUS window's report — a one-window lookahead, so the window just
        enqueued overlaps all host work. Returns THIS wave's results:
        {request_id: generated token ids (eos included, no pads)}."""
        pending = None
        force_stop = np.zeros((self.B,), bool)
        while True:
            self._admit_paged()
            chunk_slot = self._pick_chunk_slot()
            if chunk_slot is not None:
                self._dispatch_chunk(chunk_slot)
            decoding = any(m == "decode" for m in self._slot_mode)
            new_pending = None
            if decoding:
                new_pending = self._dispatch_decode(force_stop)
                force_stop[:] = False
            if pending is not None:
                self._process_report(pending, force_stop)
            pending = new_pending
            if pending is None and chunk_slot is None and not decoding:
                if self._queue:
                    if any(m != "free" for m in self._slot_mode):
                        continue
                    raise RuntimeError(
                        f"KV pool capacity exhausted ({len(self._free_blocks)} of "
                        f"{self.num_blocks} blocks free; the next request needs "
                        "more); raise max_cache_len/num_blocks, or catch this, "
                        "reset(), and run() again."
                    )
                if all(m == "free" for m in self._slot_mode):
                    break
        wave, self._results = self._results, {}
        return {rid: wave[rid] for rid in sorted(wave)}
