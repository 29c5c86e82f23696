#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # what the checks need; a few minutes
    python3 chip_smoke.py --profile  # adds torch.profiler passes over a
                                     # serving wave with bf16 weights and
                                     # one with int8 weights, one Llama and
                                     # one Gemma-2 training step, one step
                                     # of the canonical BERT loop
    python3 chip_smoke.py --paged-decode  # only phase 2b, the paged decode
                                     # kernel's cells (the same use)
    python3 chip_smoke.py --loop     # only phase 11, the canonical BERT loop
                                     # (with --profile: one profiled step)
    python3 chip_smoke.py --splash-times  # only the splash kernels' times at
                                     # Gemma-2-9B's layers (to set two trees
                                     # side by side in one run: copy this
                                     # script beside the other tree's package)

Phases, in order; any failure exits non-zero and nothing is caught:

1. Build every CUDA source of ``accelerate_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together), log each flash,
   splash, int8 matmul and paged decode kernel's registers and spills (``-Xptxas -v``; any
   spill fails the phase) and the highest register each uses (``cuobjdump
   -sass``: the consumers' share under ``setmaxnreg``), and print the card's
   name and power limit.
2. Op phase at the engine's shapes: the paged gather kernel, bf16 and
   int8-dequant-to-bf16, against its plain PyTorch version (bitwise on
   active slots, zeros on inactive ones), with times for the kernel, the
   plain version and one library call, beside the bytes-moved bound.
2a. Op phase of the int8 matmul at the 7 Llama-3-8B projection shapes
   ((K, N) of 4096x4096, 4096x1024, 4096x14336, 14336x4096) for M = 8
   (a decode step over 8 slots) and M = 128 (a prefill chunk), bf16:
   bitwise against its plain version; times for the kernel (CUDA events,
   and device time from the profiler's raw records), the plain version,
   ``torch._int_mm`` on pre-quantized operands (the contraction only) and
   the bf16 ``x @ w`` (cuBLAS, which reads the same weight bytes), beside
   the bound, with each cell's partition.
2b. Op phase of the fused paged decode attention at the engine's geometry
   (8 slots, block 16, 32 heads over 8 KV heads of 128, M = 26 blocks a
   slot), on 4096-token chains (M = 256) and for one slot with a 4096-token
   chain: bf16 and int8 pools, ragged chains with trash-block tails, holes
   in the mask, two inactive slots (of 8). The op face ``paged_attention``
   is driven for one decode step over all 32 layers (the launches counted),
   then the kernel is held to its plain version per (slot, head) row, with
   the kernel's plan (splits, CTAs, stages, shared memory), its time by CUDA
   events and its device time (the profiler's records of both of a call's
   kernels), TB/s and share of the bound, and times for the plain version,
   the gather kernel plus ``cached_attention`` (what the engine runs), and
   ``scaled_dot_product_attention`` on the gathered view.
3. Engine phase: ``ContinuousBatcher(paged=True)`` on Llama-3-8B widths
   (all 32 layers, bf16, random weights from a seed) answers a wave of
   greedy requests behind a shared prefix, with chunked prefill engaged.
   Every request finishes, the pool's blocks all return, the kernel was
   launched, and the tokens equal those of an engine built with
   ``kernels="off"`` (the plain gather).
4. The same with an int8 KV pool (the dequant variant of the kernel).
4a. Int8-weight serving: ``ContinuousBatcher(matmul_precision="int8",
   kv_quant="int8")`` on the same model and wave: every block projection
   through the int8 matmul kernel (224 launches a forward), tokens equal
   to a ``kernels="off"`` arm's; tokens/s and TTFT beside phase 3's.
5. Small-input reference check: on ``LlamaConfig.tiny()`` in fp32 the engine's
   output equals per-request ``generate()``, and the 8B forward's logits are
   finite with the expected shape. The 16 GB serving model is then freed.
6. Training-kernel op phase: causal flash attention (forward, and backward
   through autograd) against its plain version at the training shape
   (B2, S2048, H32, D128, bf16), with a right-padding mask, at S=1024
   (the crossover), at a ragged S=1088 (an odd multiple of 64, so the last
   128-row tile is half past the end) with padding, and at D=64, held to
   pinned tolerances; the fused optimizer update,
   every family, bitwise against its plain version on the largest leaf of
   the training cell (the embedding or LM head, 128256 x 4096 = 525M f32)
   and on 1- and 0-element leaves. Times for kernel, plain version and the library call
   (``scaled_dot_product_attention``; ``torch.optim.AdamW``/``SGD`` with
   ``fused=True``, another op order) beside the bound.
7. Training phase: ``Accelerator(mixed_precision="bf16").prepare(model,
   adamw(3e-4))`` → ``build_train_step`` on Llama-3-8B widths cut to 4
   layers, batch 2 x 2048 seeded tokens, ``clip_norm=1.0``: 2 warm-up and 5
   timed steps with finite, falling losses and the flash and update kernels
   launched every step; a ``kernels="off"`` arm whose first 3 losses agree
   with the kernel arm's; and an accumulation-2 build whose update launches
   only at the 2 boundaries of 4 micro-steps. Prints step time, tokens/s,
   MFU against 989 TFLOP/s and each arm's peak memory.
8. Splash-kernel op phase: causal splash attention (window, logit softcap,
   pre-scaled q, segment ids; forward, and backward through autograd)
   against its plain version at Gemma-2-9B's local layer (B1, S8192, H16,
   D256, window 4096, softcap 50, scale 1/16), its global layer, the local
   layer with right padding, Mistral-7B-v0.1's attention (32 heads over 8 KV
   heads of 128, window 4096), S=1024 (the crossover), a ragged S=1088
   (an odd multiple of 64: the last 128-row query tile is half past the
   end) padded with a window of 300, and the padded local
   layer on logits of standard deviation 16, which reach the cap, under
   flash's pins; on that last case the kernel without the softcap and the
   plain version without the cap's derivative must both miss the pins. Times for kernel, plain version and the library call
   (``flex_attention`` with a sliding-window block mask and a softcap
   ``score_mod``) beside the bound.
9. Gemma-2 training: ``gemma2_config_from_hf`` of the published
   google/gemma-2-9b config cut to 4 layers (two local, two global; 1.710B
   parameters), ``fused_loss=True``, ``Accelerator(mixed_precision="bf16")``,
   ``adamw(3e-4)``, batch 1 x 8192, ``clip_norm=1.0``: 2 warm-up and 5 timed
   steps with finite, falling losses, splash launched 4 + 4 times a step
   and flash never; then one local and one global layer trained by a
   kernel arm and a ``kernels="off"`` arm whose first 3 losses agree.
10. Ring attention (sequence parallelism) at Llama-3-8B's attention widths
   (32 query heads over 8 KV heads of 128, the KV heads repeated to 32
   before the ring as the model does), B1, a 32768-token sequence over
   sp = 4 ranks (8192 tokens a shard), bf16, all four ranks driven in this
   process by ``parallel.ring.LoopbackRing(4)``, through the same block
   calls a ring of four cards makes. Each ring-block kernel (forward and
   backward) against its plain twin at a shard of 8192 in modes 0
   (diagonal), 1 (full), 1 with right padding in the KV block and 2
   (skipped: no launch); the whole ring, forward and backward (10 + 10
   launches), against single-card ``flash_attention_cuda`` of the
   unsharded sequence (which phase 6 holds to its plain version); and the
   whole ring at S=4096 against ``kernels="off"`` with padding in a KV
   shard other than the query's own and a left-padded row (rows that see
   no key come out 0). Times for each block kernel, its twin and
   ``scaled_dot_product_attention`` on the same block, and for the whole
   ring against single-card flash, beside the bounds.
11. The canonical Accelerate loop of ``examples/nlp_example.py`` (the port's
   ``accelerate_tpu_torch/examples/nlp_example.py``) at bert-base-cased's
   published widths (``bert_config_from_hf`` of its config: 12 layers of
   768, vocabulary 28996; random weights from the seed, dropout off):
   ``Accelerator(mixed_precision="bf16")``, the example's key-match data at
   MRPC's split sizes (3668 train, 408 eval), sequences of 128, batch 16.
   Arm A, the example as written: ``inject_hyperparams(adamw)(2e-5)`` and
   ``linear_schedule(2e-5, 2e-6, 229)``, ``clip_grad_norm_(model, 1.0)``,
   one epoch and the eval: finite losses, the reference chain (no fused
   update launched), the learning rate after the last step equal to the
   schedule's, ``gather_for_metrics`` returning exactly 408 rows (the tail
   of 25 x 16 + 8 padded and trimmed); accuracy printed. Arm B, a constant
   ``adamw(2e-5)``: 40 steps with the fused update launched from
   ``optimizer.step()`` 25 times a step (one per BERT parameter leaf), the
   first 3 losses against a ``kernels="off"`` arm within phase 7's pin,
   and an accumulation-2 build launching the update only at the
   boundaries. Steps/s and tokens/s (host clock over 30 steps after 5
   warm-up, ending in ``synchronize()``) and peak memory of both arms;
   ``--profile`` adds one profiled step of arm B.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12    # H100 SXM int8 tensor cores, dense
SEED = 0
# Flash kernel vs its plain version, bf16 in and out: the kernel rounds P to
# bf16 before P.V (as the TPU library does) and the plain version does not,
# and both round the output to bf16, each a relative error of about 2^-9 an
# element. A causal output row i mixes i+1 values and shrinks as
# sqrt(e / (i + 1)), so the forward is held per 64-row query tile against
# that tile's own size: a dropped or wrong KV tile moves its query tile's
# output by tens of percent.
FLASH_FWD_TILE_REL = 1e-2  # forward: max over (batch, head, 64-row tile) of
                           # ||kernel - plain||_F / ||plain||_F, real-token rows
FLASH_BWD_REL = 2e-2       # dq, dk, dv: ||kernel - plain||_F / ||plain||_F
# Ring-block row stats vs the plain twin: both are f32 maxima and sums of the
# same bf16 products, summed in another order (and the kernel's exp is
# __expf), so l is held relative to max(l, 1) and m absolutely.
RING_STATS_ATOL = 1e-3
# Paged decode attention vs its plain version: the kernel sums the scores,
# the softmax and P.V in another order (f32), rounding the bf16 dot and the
# probabilities as the plain version does, so the pin is the largest
# ||kernel - plain|| / ||plain|| over the (slot, query, head) rows of active
# slots; a dropped or wrong block moves its row by far more.
PAGED_DECODE_ROW_REL = 1e-2
# (K, N) of the Llama-3-8B block projections: wq and wo, wk and wv, w_gate
# and w_up, w_down.
INT8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# Training: losses of the kernel arm vs the kernels="off" arm, first 3 steps.
TRAIN_LOSS_ATOL = 3e-2
TRAIN_CUT = dict(num_hidden_layers=4, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
# google/gemma-2-9b on the Hugging Face hub, config.json: the published
# widths; only the depth is cut (GEMMA2_LAYERS, and GEMMA2_PAIR_LAYERS for
# the comparison with kernels="off").
GEMMA2_9B = dict(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                 num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
                 head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
                 rope_theta=10000.0, sliding_window=4096, query_pre_attn_scalar=256,
                 attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                 hidden_activation="gelu_pytorch_tanh")
GEMMA2_LAYERS, GEMMA2_PAIR_LAYERS = 4, 2
GEMMA2_BATCH, GEMMA2_SEQ = 1, 8192
# Phase 8: the attention of one Gemma-2-9B layer at the training shape.
GEMMA2_ATTENTION = dict(B=GEMMA2_BATCH, S=GEMMA2_SEQ, H=16, Hkv=8, D=256, scale=256 ** -0.5,
                        softcap=50.0)
# Phase 10: Llama-3-8B attention widths over a 4-rank ring.
RING_RANKS, RING_SEQ, RING_SMALL_SEQ = 4, 32768, 4096
RING_HEADS, RING_KV_HEADS, RING_HEAD_DIM = 32, 8, 128
# bert-base-cased on the Hugging Face hub, config.json: the published widths
# (phase 11, the canonical loop; random weights, dropout off).
BERT_BASE_CASED = dict(vocab_size=28996, hidden_size=768, num_hidden_layers=12,
                       num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                       hidden_dropout_prob=0.1, max_position_embeddings=512, type_vocab_size=2,
                       layer_norm_eps=1e-12, position_embedding_type="absolute",
                       model_type="bert")
# MRPC's split sizes, the reference example's batch, sequences of 128 tokens.
LOOP_TRAIN, LOOP_EVAL, LOOP_BATCH, LOOP_SEQ = 3668, 408, 16, 128
LOOP_LR, LOOP_END_LR = 2e-5, 2e-6
LOOP_B_STEPS, LOOP_WARMUP, LOOP_TIMED = 40, 5, 30
T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}")


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> list:
    """One line per kernel entry of an ``nvcc -Xptxas -v`` log: its
    (mangled) name, registers, static shared memory and spills."""
    import re

    out, entry, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{entry}: {m.group(1)} registers, static shared memory "
                       f"{smem.group(1) if smem else 0} B, {spill}")
            entry, spill = None, ""
    return out


def check_no_spills(summary: list, name: str) -> None:
    """Fails the run if ptxas spilled in any kernel of ``name``."""
    for line in summary:
        if "spill" in line and not line.endswith("spill stores 0 B, loads 0 B"):
            raise SystemExit(f"build[{name}]: a kernel spills registers: {line}")


def sass_registers(path) -> dict:
    """The highest register each kernel of a built library uses, from
    ``cuobjdump -sass`` (``Used N registers`` from ptxas is the launch
    bound's share; code after ``setmaxnreg`` may use more)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = -1
            continue
        if fn is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[fn] = max(out[fn], int(r))
    return out


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event) -> float:
    """Self device time of one ``torch.profiler`` key average, in us."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def device_records(prof) -> list:
    """The profiler's raw device records, ``(name, kind, us)`` with kind
    "kernel" or "copy" (memcpy, memset): what CUPTI reported, one record a
    launch, before ``key_averages`` nests events into a tree and subtracts
    the time of an event's children from its self time."""
    import torch

    return [(e.name(), "copy" if e.name().startswith(("Memcpy", "Memset")) else "kernel",
             e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]


def profile_calls(fn, iters: int = 10, warmup: bool = True) -> list:
    """The raw device records (``device_records``) of ``iters`` calls of
    ``fn`` (after one outside) under ``torch.profiler``. With ``warmup``
    the profiler first traces one call in a cycle it discards
    (``torch.profiler.schedule``), so the measured calls run under a trace
    that is already recording."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=int(warmup), active=1),
                 on_trace_ready=lambda prof: got.append(device_records(prof))) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return got[0]


def profiled_ms(fn, kernels: int, iters: int = 10, label: str = "") -> float:
    """Device time of the CUDA kernels ``fn()`` launches, per call, summed
    from the raw records of ``torch.profiler`` over ``iters`` calls.
    ``cuda_ms`` times back-to-back calls between two events, so for a kernel
    of tens of microseconds it counts the gaps in which the card waits for
    the host's per-call work; this leaves them out. ``kernels`` is the
    number of kernels one call launches. The profiler now and then drops
    records (PERF.md section 7): a trace with fewer than ``iters * kernels``
    kernel records is taken again, and after three such traces the time is
    ``synced_ms``'s (CUDA events around single synchronised calls, launch
    included: never shorter than the device time), logged as such, so a
    lost record never passes as a shorter time."""
    for _ in range(3):
        records = profile_calls(fn, iters)
        n_kernels = sum(a == "kernel" for _, a, _ in records)
        if n_kernels >= iters * kernels:
            break
    else:
        ms = synced_ms(fn, iters)
        log(f"profiled_ms {label}: the profiler kept {n_kernels} kernel records of "
            f"{iters * kernels} in three traces; {ms:.4f} ms a call by CUDA events around "
            f"single synchronised calls instead (an upper bound)")
        return ms
    ms = sum(us for _, _, us in records) / 1e3 / iters
    per_kernel = {}
    for name, _, us in records:
        per_kernel[name[:60]] = per_kernel.get(name[:60], 0.0) + us / 1e3 / iters
    log(f"profiled_ms {label}: {n_kernels} kernel records, {ms:.4f} ms a call ("
        + ", ".join(f"{n} {t:.4f}" for n, t in sorted(per_kernel.items(), key=lambda kv: -kv[1]))
        + ")")
    return ms


def synced_ms(fn, iters: int = 10) -> float:
    """Mean CUDA-event time of single calls of ``fn``, each between two
    synchronizes: the card's time for a call, its launch included, with no
    other work queued around it."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def engine_geometry(model):
    """The pool's blocks and a slot's table length of the serving engine
    built with ``engine_kwargs()``."""
    from accelerate_tpu_torch import ContinuousBatcher

    probe = ContinuousBatcher(model, **engine_kwargs())
    return probe.num_blocks, probe.max_blocks_per_slot


def engine_kwargs():
    import torch

    # 8 slots x 26 blocks of 16 tokens: every slot can hold its worst-case chain.
    return dict(batch_slots=8, block_size=16, bucket_sizes=(16, 32, 64, 128),
                max_new_tokens=32, sync_every=8, max_tokens_per_request=256,
                max_cache_len=8 * 26 * 16, cache_dtype=torch.bfloat16, device="cuda")


def make_traffic(vocab: int):
    import numpy as np

    rng = np.random.default_rng(SEED)
    prefix = rng.integers(1, vocab, (48,)).astype(np.int32)
    # The first suffix makes a 198-token prompt: longer than prefill_chunk
    # (128), so its prefill runs in two chunks and registers shareable blocks.
    lengths = (150, 5, 17, 40, 3, 90, 12, 60, 8, 25)
    return prefix, [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lengths]


def run_wave(engine, prefix, suffixes):
    import torch

    engine.set_prefix(prefix)
    rids = [engine.submit(s) for s in suffixes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [out[r] for r in rids], wall


def op_phase(model_cfg, kw, engine_blocks: int, max_blocks: int):
    """Kernel vs plain version at the engine's shapes; returns kernel rows."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.ops.kernels.paged_gather import paged_gather
    from accelerate_tpu_torch.ops.paged_attention import gather_block_view

    L, Hkv, D = model_cfg.num_hidden_layers, model_cfg.num_key_value_heads, model_cfg.head_dim
    bs, B, M, N = kw["block_size"], kw["batch_slots"], max_blocks, engine_blocks + 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    tables = np.zeros((B, M), np.int32)
    active = np.ones((B,), bool)
    active[[2, 5]] = False  # two slots between requests
    free = rng.permutation(np.arange(1, N))
    for b in np.nonzero(active)[0]:
        n = int(rng.integers(M // 2, M + 1))
        tables[b, :n], free = free[:n], free[n:]
    tables_t = torch.tensor(tables, device=dev)
    active_t = torch.tensor(active, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    pools = {
        "paged_gather": dict(
            pool=torch.randn((L, N, bs, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16),
            scales=None, out_dtype=None),
        "paged_gather_dequant": dict(
            pool=torch.randint(-127, 128, (L, N, bs, Hkv, D), generator=g, device=dev,
                               dtype=torch.int8),
            scales=torch.rand((L, N, bs), generator=g, device=dev) * 0.05 + 1e-3,
            out_dtype=torch.bfloat16),
    }
    used = np.unique(tables[active])  # distinct pool blocks the active slots read
    rows = []
    for name, case in pools.items():
        pool, scales, out_dtype = case["pool"], case["scales"], case["out_dtype"]
        kernel = lambda: paged_gather(pool, tables_t, active=active_t, scales=scales,
                                      out_dtype=out_dtype)
        plain = lambda: gather_block_view(pool, tables_t, active=active_t, scales=scales,
                                          out_dtype=out_dtype)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise SystemExit(f"{name}: kernel gave {got.shape}/{got.dtype}, "
                             f"plain {ref.shape}/{ref.dtype}")
        act = torch.tensor(active, device=dev)
        same = torch.equal(got[:, act].view(torch.int16 if got.element_size() == 2 else torch.int32),
                           ref[:, act].view(torch.int16 if ref.element_size() == 2 else torch.int32))
        zeros = bool((got[:, ~act] == 0).all())
        err = float((got[:, act].float() - ref[:, act].float()).abs().max())
        if not (same and zeros):
            raise SystemExit(f"{name}: kernel disagrees with the plain version "
                             f"(bitwise={same}, inactive zeros={zeros}, max_abs_err={err})")
        flat = tables_t.reshape(-1).long()
        library = None
        if scales is None:
            shape = (L, B, M * bs, Hkv, D)
            library = lambda: pool.index_select(1, flat).reshape(shape)
        out_bytes = got.numel() * got.element_size()
        in_bytes = L * len(used) * bs * Hkv * D * pool.element_size()
        if scales is not None:
            in_bytes += L * len(used) * bs * 4
        moved = in_bytes + out_bytes + tables.nbytes + active.nbytes
        ops = L * int(active.sum()) * M * bs * Hkv * D if scales is not None else 0
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": "accelerate_tpu_torch/csrc/paged_gather.cu",
            "replaces": "accelerate_tpu/ops/pallas/paged_decode.py:204",
            "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(library) if library is not None else None,
        }
        log(f"op {name}: shape {tuple(got.shape)} {got.dtype}, bitwise equal on active "
              f"slots, zeros on inactive; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'n/a' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'}, "
              f"bound {row['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB)")
        rows.append(row)
    del pools
    torch.cuda.empty_cache()
    return rows


def engine_forwards(engine) -> int:
    """Model forwards the engine ran: one per prefill chunk, ``sync_every``
    per decode window."""
    log_ = engine._dispatch_log
    return sum(e.startswith("chunk") for e in log_) + engine.sync_every * log_.count("decode")


def engine_phase(model, kv_quant, kernel_names, card: str, matmul_precision=None):
    """Both arms on one wave; returns the kernel arm's launch counts, its
    forwards, tokens/s and TTFT p50 (s)."""
    import numpy as np

    from accelerate_tpu_torch import ContinuousBatcher
    from accelerate_tpu_torch.ops import registry

    kw = dict(engine_kwargs(), kv_quant=kv_quant, matmul_precision=matmul_precision)
    prefix, suffixes = make_traffic(model.config.vocab_size)
    off = ContinuousBatcher(model, kernels="off", **kw)
    ref_tokens, off_wall = run_wave(off, prefix, suffixes)
    del off
    engine = ContinuousBatcher(model, **kw)
    registry.reset_launch_counts()
    tokens, wall = run_wave(engine, prefix, suffixes)
    launches = dict(registry.launch_counts)
    stats, slo = engine.pool_stats(), engine.slo_report()
    label = f"engine[kv_quant={kv_quant}, matmul_precision={matmul_precision}]"
    if len(tokens) != len(suffixes) or any(t.size == 0 for t in tokens):
        raise SystemExit(f"{label}: not every request finished")
    if stats["blocks_free"] != stats["num_blocks"]:
        raise SystemExit(f"{label}: {stats['blocks_free']} of {stats['num_blocks']} blocks free")
    for name in kernel_names:
        if launches.get(name, 0) <= 0:
            raise SystemExit(f"{label}: {name} was never launched ({launches})")
    if slo["decisions"]["chunked_prefills"] < 1:
        raise SystemExit(f"{label}: chunked prefill did not engage")
    for i, (a, b) in enumerate(zip(tokens, ref_tokens)):
        if not np.array_equal(a, b):
            raise SystemExit(f"{label}: request {i} differs from kernels='off': {a} vs {b}")
    vocab = model.config.vocab_size
    if any(((t < 0) | (t >= vocab)).any() for t in tokens):
        raise SystemExit(f"{label}: token id outside the vocabulary")
    forwards = engine_forwards(engine)
    n_tok = int(sum(t.size for t in tokens))
    ttft = float(np.median(slo["ttft_s"]))
    log(f"{label}: {len(tokens)} requests, {n_tok} tokens generated, wall {wall:.3f} s "
        f"(kernels='off' arm {off_wall:.3f} s), {n_tok / wall:.1f} tokens/s, TTFT p50 "
        f"{ttft * 1e3:.1f} ms, {forwards} forwards, launches {launches}, decisions "
        f"{slo['decisions']}, pool {stats['pool_bytes'] / 2**20:.0f} MiB; identical to "
        f"kernels='off' [{card}]")
    for i, (suffix, toks) in enumerate(zip(suffixes, tokens)):
        log(f"{label}: request {i}: prompt {prefix.size}+{suffix.size} tokens -> "
            f"{toks.size} tokens {toks.tolist()}")
    return dict(launches=launches, forwards=forwards, tokens_per_s=n_tok / wall, ttft_s=ttft)


def int8_engine_phase(model, card: str, bf16_run: dict):
    """Int8-weight serving on the int8 pool; returns its run."""
    L = model.config.num_hidden_layers
    run = engine_phase(model, "int8", ("int8_matmul", "paged_gather_dequant"), card,
                       matmul_precision="int8")
    want = 7 * L * run["forwards"]
    got = run["launches"]["int8_matmul"]
    if got != want:
        raise SystemExit(f"int8 engine: int8_matmul launched {got} times over "
                         f"{run['forwards']} forwards, expected {want} (7 projections x {L} layers)")
    log(f"int8 engine: int8_matmul {got} launches = {got // run['forwards']} per forward over "
        f"{run['forwards']} forwards; {run['tokens_per_s']:.1f} tokens/s and TTFT p50 "
        f"{run['ttft_s'] * 1e3:.1f} ms, against {bf16_run['tokens_per_s']:.1f} tokens/s and "
        f"{bf16_run['ttft_s'] * 1e3:.1f} ms with bf16 weights and pool in this process")
    return run


def reference_phase(model):
    """Engine == per-request generate() on a tiny fp32 model; 8B logits finite."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import ContinuousBatcher, Llama, LlamaConfig, generate

    ids = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    logits = model.apply(model.params, input_ids=ids)["logits"]
    if tuple(logits.shape) != (1, 8, model.config.vocab_size) or not torch.isfinite(logits).all():
        raise SystemExit(f"8B forward: logits {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    tiny = Llama(LlamaConfig.tiny(), device="cuda")
    tiny.init_params(SEED)
    prefix, suffixes = make_traffic(tiny.config.vocab_size)
    engine = ContinuousBatcher(tiny, batch_slots=2, block_size=4, bucket_sizes=(8, 16, 32),
                               max_new_tokens=6, sync_every=2, max_tokens_per_request=256,
                               max_cache_len=2048, cache_dtype=torch.float32, device="cuda")
    engine.set_prefix(prefix[:10])
    rids = [engine.submit(s) for s in suffixes[:4]]
    out = engine.run()
    for rid, s in zip(rids, suffixes[:4]):
        full = np.concatenate([prefix[:10], s])[None]
        ref = generate(tiny, full, max_new_tokens=6, cache_dtype=torch.float32,
                       include_prompt=False, device="cuda")[0].cpu().numpy()
        if not np.array_equal(out[rid], ref):
            raise SystemExit(f"tiny engine differs from generate(): {out[rid]} vs {ref}")
    log("reference: 8B logits finite (1, 8, 128256); tiny fp32 engine == generate() "
          "for 4 requests")


def row_rel_err(got, ref, active) -> float:
    """Largest ``||got - ref|| / ||ref||`` over the (slot, query, head) rows
    of (B, S, H, D) outputs, on the slots ``active`` marks (the absolute
    error where a row of ``ref`` is all zeros)."""
    import torch

    g, r = got[active].float(), ref[active].float()
    num, den = (g - r).square().sum(-1), r.square().sum(-1)
    return float(torch.where(den > 0, num / den.clamp_min(1e-30), num).sqrt().max())


def int8_op_phase():
    """Int8 matmul kernel vs its plain version at the projection shapes;
    returns the kernel-table row (M = 8, the gate projection)."""
    import torch

    from accelerate_tpu_torch.ops.int8 import int8_matmul_reference, quantize_rowwise
    from accelerate_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul_cuda,
        plan,
        quotient_disagreements,
    )

    t0 = time.perf_counter()
    bad, pairs = quotient_disagreements(stride=1)
    if bad or pairs != (1 << 23) * 11 * 128:
        raise SystemExit(f"int8_matmul self-check: the bf16 division disagrees with __fdiv_rn "
                         f"for {bad} of {pairs} pairs")
    log(f"op int8_matmul self-check: the bf16 division equals __fdiv_rn for all {pairs} pairs of "
        f"a scale significand and a bf16 value with a quotient in [2^-3, 2^7] "
        f"({time.perf_counter() - t0:.2f} s)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row, cells = None, []
    for M in (8, 128):
        for K, N in INT8_SHAPES:
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            w = (torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)).to(torch.bfloat16)
            got, ref = int8_matmul_cuda(x, w), int8_matmul_reference(x, w)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if got.dtype != ref.dtype or not torch.equal(got.view(torch.int16),
                                                         ref.view(torch.int16)):
                raise SystemExit(f"int8_matmul M={M} K={K} N={N}: kernel disagrees with the "
                                 f"plain version (max_abs_err={err})")
            qx, _ = quantize_rowwise(x, -1)
            qw, _ = quantize_rowwise(w, 0)
            # torch._int_mm takes more than 16 rows: decode rows are padded
            # with zeros; the weight is column-major, cuBLASLt's int8 layout.
            qa = qx if M > 16 else torch.cat([qx, qx.new_zeros((32 - M, K))])
            qb = qw.t().contiguous().t()
            t_kernel = cuda_ms(lambda: int8_matmul_cuda(x, w), 20)
            t_device = profiled_ms(lambda: int8_matmul_cuda(x, w), kernels=2,
                                   label=f"int8_matmul M={M} K={K} N={N}")
            t_plain = cuda_ms(lambda: int8_matmul_reference(x, w), 5)
            t_lib = cuda_ms(lambda: torch._int_mm(qa, qb), 20)
            t_bf16 = cuda_ms(lambda: x @ w, 20)  # cuBLAS: reads the same weight bytes
            moved = 2 * (M * K + K * N + M * N)  # bf16 x and w in, bf16 out
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * M * N * K / INT8_OPS_PER_S * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            pl = plan(M, N, K, 2, sms)
            log(f"op int8_matmul M={M} K={K} N={N} bf16: bitwise equal; kernel "
                f"{t_kernel:.4f} ms ({t_device:.4f} ms of device time, profiler), plain "
                f"{t_plain:.4f} ms, library {t_lib:.4f} ms "
                f"(torch._int_mm on pre-quantized operands{'' if M > 16 else ', 32 rows'}: the "
                f"contraction only), bf16 x @ w (cuBLAS) {t_bf16:.4f} ms, bound {bound:.4f} ms "
                f"({by}, {moved / 1e6:.1f} MB, {moved / t_kernel / 1e9:.2f} TB/s achieved, "
                f"{bound / t_kernel:.1%} of the bound); panels of {pl.nt} columns, clusters of "
                f"{pl.cluster} CTAs x {pl.per} k blocks, tiles of {pl.mt} rows, {pl.ctas} CTAs "
                f"of {pl.smem} B shared memory")
            cells.append(dict(M=M, K=K, N=N, ms=round(t_kernel, 4), device_ms=round(t_device, 4),
                              bound_ms=round(bound, 4), tb_s=round(moved / t_kernel / 1e9, 3),
                              int_mm_ms=round(t_lib, 4), bf16_ms=round(t_bf16, 4),
                              plain_ms=round(t_plain, 4)))
            if (M, K, N) == (8, 4096, 14336):
                row = {"name": "int8_matmul", "route": "cuda",
                       "source": "accelerate_tpu_torch/csrc/int8_matmul.cu",
                       "replaces": "accelerate_tpu/ops/pallas/int8_mm.py:36", "launches": 0,
                       "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                       "bound_ms": bound, "bound_by": by, "library_ms": t_lib}
            del x, w, got, ref, qx, qw, qa, qb
    log(f"op int8_matmul cells: {json.dumps(cells)}")
    free_cuda()
    return row


def paged_decode_inputs(model_cfg, bs: int, slots: int, M: int, N: int, quant: bool, layers=None):
    """Pools (one layer, or ``layers`` stacked), tables of ``slots`` slots
    with ragged chains and trash-block tails, a mask with holes, slots 2 and
    5 inactive (where there are that many), one query per slot at its
    chain's last token; made on the card from the seed."""
    import numpy as np
    import torch

    Hkv, D, H = model_cfg.num_key_value_heads, model_cfg.head_dim, model_cfg.num_attention_heads
    B = slots
    rng = np.random.default_rng(SEED + M)
    tables = np.zeros((B, M), np.int32)
    active = np.ones((B,), bool)
    active[[i for i in (2, 5) if i < B]] = False
    free = rng.permutation(np.arange(1, N))
    pos = np.zeros((B, 1), np.int32)
    for b in np.nonzero(active)[0]:
        n = int(rng.integers(M // 2, M + 1)) if B > 1 else M
        tables[b, :n], free = free[:n], free[n:]
        pos[b, 0] = n * bs - 1 - int(rng.integers(0, bs))  # the frontier inside the last block
    mask = (rng.random((N, bs)) > 0.1).astype(np.int32)
    mask[0] = 0  # the trash block
    g = torch.Generator(device="cuda").manual_seed(SEED + M)
    lead = () if layers is None else (layers,)
    shape = lead + (N, bs, Hkv, D)
    if quant:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
                for _ in range(2))
        scales = [torch.rand(lead + (N, bs), generator=g, device="cuda") * 0.05 + 1e-3
                  for _ in range(2)]
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        scales = [None, None]
    q = torch.randn((B, 1, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    dev = torch.device("cuda")
    return dict(q=q, k=k, v=v, k_scale=scales[0], v_scale=scales[1],
                tables=torch.tensor(tables, device=dev), pos=torch.tensor(pos, device=dev),
                mask=torch.tensor(mask, device=dev), active=torch.tensor(active, device=dev),
                used=np.unique(tables[active]))


def paged_decode_phase(model_cfg, kw, engine_blocks: int, max_blocks: int):
    """Drive the op face over one decode step of all layers at the engine's
    geometry (launches counted), then hold the kernel to its plain version
    at the engine's geometry, on 4096-token chains (M = 256) and for one
    slot with a 4096-token chain; returns the kernel-table rows (bf16 and
    int8 pools, engine geometry)."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels import paged_decode as decode_kernel
    from accelerate_tpu_torch.ops.kernels.paged_decode import paged_decode_cuda
    from accelerate_tpu_torch.ops.paged_attention import (
        gather_block_mask,
        gather_block_view,
        paged_attention,
        paged_attention_plain,
        paged_attention_reference,
    )

    L, bs, B = model_cfg.num_hidden_layers, kw["block_size"], kw["batch_slots"]
    H, Hkv, D = model_cfg.num_attention_heads, model_cfg.num_key_value_heads, model_cfg.head_dim
    launches = {}
    for quant in (False, True):
        c = paged_decode_inputs(model_cfg, bs, B, max_blocks, engine_blocks + 1, quant, layers=L)
        registry.reset_launch_counts()
        for layer in range(L):
            scales = {} if not quant else dict(k_scale=c["k_scale"][layer],
                                               v_scale=c["v_scale"][layer])
            paged_attention(c["q"], c["k"][layer], c["v"][layer], c["tables"],
                            q_positions=c["pos"], pool_mask=c["mask"], active=c["active"],
                            **scales)
        torch.cuda.synchronize()
        launches[quant] = dict(registry.launch_counts)
        if launches[quant] != {"paged_decode": L}:
            raise SystemExit(f"paged_attention over {L} layers ({'int8' if quant else 'bf16'} "
                             f"pool): launches {launches[quant]}, expected paged_decode {L}")
        del c
    log(f"paged_attention driven over one decode step of {L} layers at the engine's geometry "
        f"(B={B}, M={max_blocks}, bs={bs}): launches {launches[False]} (bf16 pool), "
        f"{launches[True]} (int8 pool)")
    rows, cells = [], []
    for label, slots, M, N in (("engine M=%d" % max_blocks, B, max_blocks, engine_blocks + 1),
                               ("long M=256", B, 256, 6 * 256 + 1),
                               ("one slot M=256", 1, 256, 256 + 1)):
        for quant in (False, True):
            c = paged_decode_inputs(model_cfg, bs, slots, M, N, quant)
            kwargs = dict(q_positions=c["pos"], pool_mask=c["mask"], active=c["active"],
                          k_scale=c["k_scale"], v_scale=c["v_scale"])
            args = (c["q"], c["k"], c["v"], c["tables"])
            # (a tree from before the split kernel has no plan(): one kernel a call)
            part = (decode_kernel.plan(slots, 1, H, Hkv, D, bs, M, q_dtype=c["q"].dtype,
                                       kv_dtype=c["k"].dtype)
                    if hasattr(decode_kernel, "plan") else
                    {"splits": 1, "split_blocks": M, "ctas": slots * H, "stages": 0, "smem": 0,
                     "launches": 1})
            got, ref = paged_decode_cuda(*args, **kwargs), paged_attention_plain(*args, **kwargs)
            torch.cuda.synchronize()
            act = c["active"]
            rel = row_rel_err(got, ref, act)
            zeros = bool((got[~act] == 0).all())
            err = float((got[act].float() - ref[act].float()).abs().max())
            name = "paged_decode_int8" if quant else "paged_decode"
            if got.dtype != ref.dtype or not zeros or not math.isfinite(rel) \
                    or rel > PAGED_DECODE_ROW_REL:
                raise SystemExit(f"{name} {label}: kernel disagrees with the plain version "
                                 f"(row rel err {rel}, pin {PAGED_DECODE_ROW_REL}; inactive zeros "
                                 f"{zeros}; dtypes {got.dtype}/{ref.dtype})")
            # The library yardstick: sdpa on the already-gathered bf16 view
            # (attention only), with the causal and validity mask.
            k_view = gather_block_view(c["k"], c["tables"], scales=c["k_scale"],
                                       out_dtype=torch.bfloat16 if quant else None)
            v_view = gather_block_view(c["v"], c["tables"], scales=c["v_scale"],
                                       out_dtype=torch.bfloat16 if quant else None)
            T = M * bs
            keep = gather_block_mask(c["mask"], c["tables"]).bool() & (
                torch.arange(T, device="cuda")[None] <= c["pos"])
            qt, kt, vt = c["q"].transpose(1, 2), k_view.transpose(1, 2), v_view.transpose(1, 2)
            attn_mask = keep[:, None, None, :]
            t_kernel = cuda_ms(lambda: paged_decode_cuda(*args, **kwargs), 20)
            t_device = profiled_ms(lambda: paged_decode_cuda(*args, **kwargs),
                                   kernels=part["launches"], label=f"{name} {label}")
            t_plain = cuda_ms(lambda: paged_attention_plain(*args, **kwargs), 5)
            t_status = cuda_ms(lambda: paged_attention_reference(*args, **kwargs), 10)
            t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, enable_gqa=True), 20)
            el = c["k"].element_size()
            per_block = 2 * bs * Hkv * D * el + bs * 4 + (2 * bs * 4 if quant else 0)
            moved = (len(c["used"]) * per_block + c["q"].numel() * 2
                     + got.numel() * got.element_size() + c["tables"].numel() * 4)
            n_keys = int(act.sum()) * T
            ops = 4 * H * D * n_keys  # q.k and p.v, a multiply and an add each
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            log(f"op {name} {label}: out {tuple(got.shape)} {got.dtype}, row rel err {rel:.3e} "
                f"(pin {PAGED_DECODE_ROW_REL}), max|err| {err:.3e}, inactive slots zero; plan "
                f"{part['splits']} splits of {part['split_blocks']} blocks, {part['ctas']} CTAs, "
                f"{part['stages']} stages, {part['smem']} B shared memory, {part['launches']} "
                f"kernels a call; kernel {t_kernel:.4f} ms ({t_device:.4f} ms of device time, "
                f"profiler: {moved / t_device / 1e9:.2f} TB/s, {bound / t_device:.1%} of the "
                f"bound), plain {t_plain:.4f} ms, gather kernel + cached_attention "
                f"{t_status:.4f} ms, library {t_lib:.4f} ms (scaled_dot_product_attention on "
                f"the gathered view: attention only), bound {bound:.4f} ms ({by}, "
                f"{moved / 1e6:.2f} MB)")
            cells.append({"cell": f"{name} {label}", "slots": slots, "M": M,
                          "splits": part["splits"], "ctas": part["ctas"],
                          "stages": part["stages"], "smem": part["smem"], "ms": t_kernel,
                          "device_ms": t_device, "bound_ms": bound,
                          "share": bound / t_device, "tb_s": moved / t_device / 1e9,
                          "plain_ms": t_plain, "library_ms": t_lib, "max_abs_err": err,
                          "row_rel_err": rel})
            if M == max_blocks:
                rows.append({"name": name, "route": "cuda",
                             "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
                             "replaces": "accelerate_tpu/ops/pallas/paged_decode.py:64",
                             "launches": launches[quant]["paged_decode"], "max_abs_err": err,
                             "ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": t_lib})
            del c, got, ref, k_view, v_view, qt, kt, vt
    log(f"op paged_decode cells: {json.dumps(cells)}")
    free_cuda()
    return rows


def profile_wave(model, label: str, **engine_kw):
    """torch.profiler over one wave: device time by kernel, busy share, and
    the int8 matmul's kernels a forward (from the raw device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import ContinuousBatcher

    prefix, suffixes = make_traffic(model.config.vocab_size)
    engine = ContinuousBatcher(model, **dict(engine_kwargs(), **engine_kw))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_wave(engine, prefix, suffixes)
    by_name = {}
    for name, _, us in device_records(prof):
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, n + 1)
    total = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    forwards = engine_forwards(engine)
    int8_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "int8_matmul_cluster" in name or "quantize_rows" in name)
    int8_n = sum(n for name, (_, n) in by_name.items() if "int8_matmul_cluster" in name)
    log(f"profile {label} wave: wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / (wall * 1e3):.1f}%), {launches} device records over {forwards} "
        f"forwards ({launches / forwards:.0f} per forward, "
        f"{wall * 1e3 / forwards:.1f} ms wall and {total / forwards:.2f} ms device per forward); "
        f"int8 matmul kernels {int8_ms:.2f} ms ({int8_n} calls, {int8_ms / forwards:.2f} ms a "
        f"forward, {100 * int8_ms / max(total, 1e-9):.1f}% of device time)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile {label}:   {ms:9.2f} ms  {n:6d}x  {name[:90]}")
    del engine
    free_cuda()


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def bound_row(flops: float, moved: float):
    t_ops, t_bytes = flops / BF16_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def speed_note(flops: float, ms: float, library_ms: float, bound_ms: float) -> str:
    """A kernel row's rate, its time over the library call's and its share
    of the bound (bound time over kernel time)."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / library_ms:.2f}x the library call, "
            f"{bound_ms / ms:.1%} of the bound")


def tile_rel_err(got, ref, real, tile: int = 64) -> float:
    """Largest ``||got - ref||_F / ||ref||_F`` over the (batch, head,
    ``tile``-row query tile) blocks of (B, S, H, D) outputs, on the rows
    ``real`` (B, S) marks; a tile with no such row is skipped."""
    B, S, H, D = ref.shape
    keep = real[:, :, None, None].float()
    diff = ((got.float() - ref.float()) * keep).reshape(B, S // tile, tile, H, D)
    base = (ref.float() * keep).reshape(B, S // tile, tile, H, D)
    num, den = diff.square().sum((2, 4)), base.square().sum((2, 4))
    return float((num[den > 0] / den[den > 0]).sqrt().max())


def flash_case(B, S, H, D, padded: bool):
    """Inputs of one flash case, made on the card from the seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    seg = None
    if padded:  # right padding: the last quarter of row 1 is pads
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        seg[1, -S // 4:] = 1
    return q, k, v, do, seg


def flash_op_phase():
    """Flash kernel vs its plain version; returns the fwd and bwd rows at
    the training shape (the first case)."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.attention import flash_attention_reference
    from accelerate_tpu_torch.ops.kernels import flash_attention as fk

    cases = [("causal S2048", 2, 2048, 32, 128, False), ("padded S2048", 2, 2048, 32, 128, True),
             ("crossover S1024", 2, 1024, 32, 128, False), ("ragged S1088", 2, 1088, 32, 128, True),
             ("D64 S2048", 2, 2048, 32, 64, False)]
    rows = []
    for label, B, S, H, D, padded in cases:
        q, k, v, do, seg = flash_case(B, S, H, D, padded)
        scale = 1.0 / math.sqrt(D)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fk.flash_attention_cuda(*leaves, segment_ids=seg, causal=True, sm_scale=scale)
        out.backward(do)
        ref = flash_attention_reference(*ref_leaves, segment_ids=seg, causal=True,
                                        sm_scale=scale)
        ref.backward(do)
        torch.cuda.synchronize()
        out, ref = out.detach(), ref.detach()
        real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
        fwd_err = float((out.float() - ref.float())[real].abs().max())
        fwd_rel = tile_rel_err(out, ref, real)
        if not math.isfinite(fwd_rel) or fwd_rel > FLASH_FWD_TILE_REL:
            raise SystemExit(f"flash {label}: forward relative error of a query tile "
                             f"{fwd_rel} > {FLASH_FWD_TILE_REL}")
        bwd_err = {}
        for name, a, b in zip("qkv", leaves, ref_leaves):
            rel = float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
            if not math.isfinite(rel) or rel > FLASH_BWD_REL:
                raise SystemExit(f"flash {label}: d{name} relative error {rel} > {FLASH_BWD_REL}")
            bwd_err[f"d{name}"] = rel
        # Work this run's data needs: kept (query, key) pairs.
        keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
        if seg is None:
            pairs = H * B * int(keep.sum())
        else:
            same = seg[:, :, None] == seg[:, None, :]
            pairs = H * int((same & keep).sum())
        el = 2  # bf16 bytes
        fwd_flops, bwd_flops = 4 * D * pairs, 10 * D * pairs
        fwd_bytes = 4 * B * S * H * D * el + B * H * S * 4          # q,k,v in; o, lse out
        bwd_bytes = 8 * B * S * H * D * el + 2 * B * H * S * 4      # q,k,v,o,dO in; dq,dk,dv out
        mask = None
        if seg is not None:
            mask = (same & keep)[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library_fwd():
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        with torch.no_grad():
            t_fwd = cuda_ms(lambda: fk.flash_attention_cuda(q, k, v, segment_ids=seg,
                                                            causal=True, sm_scale=scale), 20)
            t_plain_fwd = cuda_ms(lambda: flash_attention_reference(
                q, k, v, segment_ids=seg, causal=True, sm_scale=scale), 5)
            t_lib_fwd = cuda_ms(library_fwd, 20)
        o, lse = fk._forward(q, k, v, seg, True, scale)
        t_bwd = cuda_ms(lambda: fk._backward(q, k, v, seg, o, lse, do, True, scale), 20)
        ref_out = flash_attention_reference(*ref_leaves, segment_ids=seg, causal=True,
                                            sm_scale=scale)
        t_plain_bwd = cuda_ms(lambda: torch.autograd.grad(ref_out, ref_leaves, do,
                                                          retain_graph=True), 5)
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        qt, kt, vt = lib_leaves
        lib_out = library_fwd()
        t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do.transpose(1, 2),
                                                        retain_graph=True), 20)
        fb, fby = bound_row(fwd_flops, fwd_bytes)
        bb, bby = bound_row(bwd_flops, bwd_bytes)
        log(f"op flash {label} (B{B} S{S} H{H} D{D}): fwd rel per query tile {fwd_rel:.3e} "
            f"(pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
            f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_err.items())} (pin {FLASH_BWD_REL}); "
            f"fwd kernel {t_fwd:.4f} ms, plain {t_plain_fwd:.4f}, library {t_lib_fwd:.4f}, "
            f"bound {fb:.4f} ({fby}, {fwd_flops / 1e9:.1f} GFLOP); "
            f"{speed_note(fwd_flops, t_fwd, t_lib_fwd, fb)}; bwd kernel {t_bwd:.4f} ms, plain "
            f"{t_plain_bwd:.4f}, library {t_lib_bwd:.4f}, bound {bb:.4f} ({bby}); "
            f"{speed_note(bwd_flops, t_bwd, t_lib_bwd, bb)}")
        if not rows:  # the training shape: the rows of the kernel table
            base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "accelerate_tpu/ops/attention.py:144", "launches": 0}
            rows = [dict(base, name="flash_attention_fwd", max_abs_err=fwd_err, ms=t_fwd,
                         plain_ms=t_plain_fwd, bound_ms=fb, bound_by=fby, library_ms=t_lib_fwd),
                    dict(base, name="flash_attention_bwd",
                         max_abs_err=float(max((a.grad.float() - b.grad.float()).abs().max()
                                               for a, b in zip(leaves, ref_leaves))),
                         ms=t_bwd, plain_ms=t_plain_bwd, bound_ms=bb, bound_by=bby,
                         library_ms=t_lib_bwd)]
        del q, k, v, do, leaves, ref_leaves, out, ref, o, lse, ref_out, lib_out, lib_leaves
        free_cuda()
    return rows


def update_op_phase(cfg):
    """Fused update kernel vs its plain version, bitwise, every family;
    returns one row per family at the largest leaf."""
    import torch

    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.ops.fused_update import leaf_update, plan_fused_update
    from accelerate_tpu_torch.ops.kernels.fused_update import fused_update_cuda

    big = cfg.vocab_size * cfg.hidden_size  # embed and lm_head, the largest leaves
    families = {"adamw": optim.adamw(3e-4), "adam": optim.adam(3e-4), "sgd": optim.sgd(3e-4),
                "sgd_momentum": optim.sgd(3e-4, momentum=0.9)}
    streams = {"adam": 8, "sgd_momentum": 6, "sgd": 4}  # f32 reads + writes per element
    ops_per_elem = {"adam": 16, "sgd_momentum": 5, "sgd": 4}
    factor = torch.tensor(0.7, device="cuda")
    bc1, bc2 = torch.tensor(0.271, device="cuda"), torch.tensor(0.002997, device="cuda")
    rows = []
    for name, tx in families.items():
        plan = plan_fused_update(tx)
        n_mom = {"adam": 2, "sgd_momentum": 1, "sgd": 0}[plan.kind]
        for n in (big, 1, 0):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            p = torch.randn(n, generator=g, device="cuda")
            grad = torch.randn(n, generator=g, device="cuda")
            moments = tuple(torch.rand(n, generator=g, device="cuda") for _ in range(n_mom))
            p2, grad2, moments2 = p.clone(), grad.clone(), tuple(m.clone() for m in moments)
            fused_update_cuda(p, grad, moments, factor, bc1, bc2, plan=plan)
            leaf_update(p2, grad2, moments2, factor, bc1, bc2, plan=plan)
            torch.cuda.synchronize()
            same = torch.equal(p.view(torch.int32), p2.view(torch.int32)) and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(moments, moments2))
            zeroed = bool((grad == 0).all()) and bool((grad2 == 0).all())
            if not (same and zeroed):
                raise SystemExit(f"fused_{plan.describe()}_update n={n}: kernel disagrees "
                                 f"with the plain version (bitwise={same}, zeroed={zeroed})")
            if n != big:
                continue
            err = float((p - p2).abs().max())
            t_kernel = cuda_ms(lambda: fused_update_cuda(p, grad, moments, factor, bc1, bc2,
                                                         plan=plan), 20)
            t_plain = cuda_ms(lambda: leaf_update(p2, grad2, moments2, factor, bc1, bc2,
                                                  plan=plan), 5)
            del p2, grad2, moments2
            leaf = torch.nn.Parameter(p)
            leaf.grad = grad
            if plan.kind == "adam":
                lib = torch.optim.AdamW([leaf], lr=3e-4, weight_decay=plan.weight_decay or 0.0,
                                        fused=True)
            else:
                lib = torch.optim.SGD([leaf], lr=3e-4, momentum=plan.momentum, fused=True)
            t_lib = cuda_ms(lib.step, 20)
            bound, by = bound_row(0, streams[plan.kind] * 4 * n)
            t_ops = ops_per_elem[plan.kind] * n / FP32_OPS_PER_S * 1e3
            if t_ops > bound:
                bound, by = t_ops, "operations"
            rows.append({"name": f"fused_{plan.describe()}_update", "route": "cuda",
                         "source": "accelerate_tpu_torch/csrc/fused_update.cu",
                         "replaces": "accelerate_tpu/ops/pallas/fused_update.py:200",
                         "launches": 0, "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                         "bound_ms": bound, "bound_by": by, "library_ms": t_lib})
            log(f"op fused_{plan.describe()}_update: {n} f32 elements, bitwise equal (also at "
                f"1 and 0 elements), buffer zeroed; kernel {t_kernel:.4f} ms, plain "
                f"{t_plain:.4f} ms, library {t_lib:.4f} ms (torch.optim "
                f"{type(lib).__name__}(fused=True), another op order), bound {bound:.4f} ms "
                f"({by}, {streams[plan.kind] * 4 * n / 1e9:.2f} GB, "
                f"{streams[plan.kind] * 4 * n / t_kernel / 1e9:.2f} TB/s)")
            del leaf, lib
        del p, grad, moments
        free_cuda()
    return rows


def train_arm(cfg, steps: int, kernels=None, accum: int = 1, warmup: int = 0,
              per_step_counts: bool = False, shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """Build the training step on a fresh model from the seed and run it;
    returns (loss values, wall seconds of the steps after warm-up, launch
    counts of all steps, per-step counts, peak bytes)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Llama, adamw
    from accelerate_tpu_torch.ops import registry

    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=accum, kernels=kernels)
    pm, po = acc.prepare(model, adamw(3e-4))
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    registry.reset_launch_counts()
    losses, per_step = [], []
    for _ in range(warmup):
        losses.append(step(batch, clip_norm=1.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - warmup):
        losses.append(step(batch, clip_norm=1.0))
        if per_step_counts:
            per_step.append(dict(registry.launch_counts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(registry.launch_counts)
    values = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    del model, acc, pm, po, step, losses
    free_cuda()
    return values, wall, counts, per_step, peak


def train_phase(card):
    """Phase 7; returns the kernel arm's launch counts."""
    from accelerate_tpu_torch import Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(**TRAIN_CUT)
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers, tokens = cfg.num_hidden_layers, TRAIN_BATCH * TRAIN_SEQ
    losses, wall, counts, _, peak = train_arm(cfg, steps=7, warmup=2)
    want = {"flash_attention_fwd": 7 * layers, "flash_attention_bwd": 7 * layers,
            "fused_adamw_update": 7 * 12}
    if counts != want:
        raise SystemExit(f"train: launch counts {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train: losses not finite and falling: {losses}")
    step_s = wall / 5
    mfu = fpt * tokens / step_s / BF16_OPS_PER_S
    log(f"train: Llama-3-8B widths, {layers} layers, {n_params / 1e9:.3f}B params, bf16 "
        f"compute on f32 masters, adamw(3e-4), clip 1.0, batch {TRAIN_BATCH}x{TRAIN_SEQ}; "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"({fpt:.4g} FLOP/token); launches over 7 steps {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    off, _, off_counts, _, off_peak = train_arm(cfg, steps=3, kernels="off")
    diff = max(abs(a - b) for a, b in zip(off, losses[:3]))
    if off_counts or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"train kernels='off': losses {off} vs {losses[:3]} (max |diff| "
                         f"{diff}, pin {TRAIN_LOSS_ATOL}), launches {off_counts}")
    log(f"train kernels='off': losses {[round(x, 4) for x in off]}, max |diff| {diff:.3e} "
        f"vs the kernel arm (pin {TRAIN_LOSS_ATOL}); no launches; peak memory "
        f"{off_peak / 2**30:.2f} GiB")
    acc_losses, _, _, per_step, acc_peak = train_arm(cfg, steps=4, accum=2,
                                                     per_step_counts=True)
    updates = [c.get("fused_adamw_update", 0) for c in per_step]
    if updates != [0, 12, 12, 24] or not all(math.isfinite(x) for x in acc_losses):
        raise SystemExit(f"train accumulation 2: update launches after each micro-step "
                         f"{updates}, expected [0, 12, 12, 24]; losses {acc_losses}")
    log(f"train accumulation 2: 4 micro-steps, update launches after each {updates}, "
        f"losses {[round(x, 4) for x in acc_losses]}; peak memory {acc_peak / 2**30:.2f} GiB")
    return counts


def log_profile(prof, wall: float, label: str) -> None:
    """Device time of a profiled step by kernel family and by kernel, and
    the busy share of its wall time."""
    import torch

    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in events) / 1e3
    log(f"profile {label} step: wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / (wall * 1e3):.1f}%), {sum(e.count for e in events)} kernel launches")

    def group(key):
        if "splash_" in key:
            return "splash attention (csrc/splash_attention.cu)"
        if "flash_" in key:
            return "flash attention (csrc/flash_attention.cu)"
        if "fused_update" in key:
            return "fused update (csrc/fused_update.cu)"
        if "nvjet" in key or "gemm" in key.lower() or "splitKreduce" in key:
            return "cuBLAS GEMMs"
        return "other PyTorch kernels"

    groups = {}
    for e in events:
        ms, n = groups.get(group(e.key), (0.0, 0))
        groups[group(e.key)] = (ms + device_us(e) / 1e3, n + e.count)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"profile {label}: {ms:9.2f} ms ({100 * ms / total:5.1f}%) {n:5d}x  {name}")
    for e in sorted(events, key=lambda e: -device_us(e))[:20]:
        log(f"profile {label}:   {device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


def profile_train_step(cfg, shape, label: str):
    """torch.profiler over one training step: device time by kernel, busy
    share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator, Llama, adamw

    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16")
    pm, po = acc.prepare(model, adamw(3e-4))
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    step(batch, clip_norm=1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, clip_norm=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    log_profile(prof, wall, label)
    del model, acc, pm, po, step
    free_cuda()


def gemma2_config(layers: int):
    """The published Gemma-2-9B config through the port's converter, cut to
    ``layers`` (layer 0 local, then alternating), with the fused loss."""
    import dataclasses

    from accelerate_tpu_torch import gemma2_config_from_hf

    cfg = gemma2_config_from_hf(dict(GEMMA2_9B, num_hidden_layers=layers))
    return dataclasses.replace(cfg, fused_loss=True)


_FLEX = None


def library_attention(q, k, v, seg, window, softcap):
    """One PyTorch call computing the splash function on (B, S, H, D)
    inputs (q pre-scaled): compiled ``flex_attention`` with a block mask
    (causal, the window, segment ids) and a softcap ``score_mod``. Returns
    (call, leaves): ``call()`` runs it on the leaves, (B, H, S, D) views
    that require grad. A yardstick only, never used by the port."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    global _FLEX
    if _FLEX is None:
        # The backward is timed on one retained graph: compiled backwards
        # donate their buffers unless told not to.
        torch._functorch.config.donated_buffer = False
        _FLEX = torch.compile(flex_attention, dynamic=False)
    B, S = q.shape[:2]
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        if window:
            keep = keep & (qi - ki < window)
        if seg is not None:
            keep = keep & (seg[b, qi] == seg[b, ki])
        return keep

    def score_mod(score, b, h, qi, ki):
        return torch.tanh(score / softcap) * softcap

    block_mask = create_block_mask(mask_mod, B if seg is not None else None, None, S, S,
                                   device="cuda")
    return (lambda: _FLEX(*leaves, score_mod=score_mod if softcap else None,
                          block_mask=block_mask, scale=1.0)), leaves


def splash_case(B, S, H, Hkv, D, scale, padded: bool, q_std: float = 1.0):
    """Inputs of one splash case, made on the card from the seed: q of
    standard deviation ``q_std`` scaled in bf16 as the wrapper scales it
    (the logits' standard deviation is ``q_std * scale * sqrt(D)``), GQA
    heads repeated as the wrapper repeats them, right padding on the last
    quarter of row 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16) * q_std
    q = (q * torch.tensor(scale, dtype=torch.bfloat16).item()).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda", dtype=torch.bfloat16)
            .repeat_interleave(H // Hkv, dim=2).contiguous() for _ in range(2))
    do = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    seg = None
    if padded:
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        seg[0, -S // 4:] = 1
    return q, k, v, do, seg


def plain_without_cap_derivative(q, k, v, **kw):
    """The splash plain version with the softcap's derivative left out of
    its backward (``tanh`` passes its cotangent through unchanged; the
    forward is the same): the gradients of a backward that dropped the
    factor ``1 - tanh^2``. A control only, never used by the port."""
    import torch
    from torch.overrides import TorchFunctionMode

    from accelerate_tpu_torch.ops.attention import splash_attention_reference

    class TanhWithoutDerivative(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.tanh:
                x = args[0]
                return x + (torch.tanh(x) - x).detach()
            return func(*args, **(kwargs or {}))

    with TanhWithoutDerivative():
        return splash_attention_reference(q, k, v, **kw)


def splash_grad_rel(leaves, ref_leaves) -> dict:
    """``||grad - ref grad||_F / ||ref grad||_F`` for q, k and v."""
    return {f"d{n}": float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
            for n, a, b in zip("qkv", leaves, ref_leaves)}


def softcap_controls(q, k, v, do, out_ref, ref_leaves, kw, real, label):
    """On a case whose logits reach the cap: the kernel run without the
    softcap, and the plain version without the cap's derivative, must each
    miss the capped plain version by more than the pins. The phase fails
    if they do not (its inputs could then not tell a kernel that drops the
    cap, or its backward factor, from a right one)."""
    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    uncapped = dict(kw, softcap=None)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sk.splash_attention_cuda(*leaves, **uncapped)
    out.backward(do)
    fwd_rel, bwd_rel = tile_rel_err(out.detach(), out_ref, real), splash_grad_rel(leaves, ref_leaves)
    st_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_without_cap_derivative(*st_leaves, **kw).backward(do)
    st_rel = splash_grad_rel(st_leaves, ref_leaves)
    log(f"op splash {label}: controls against the capped plain version: the kernel "
        f"without the softcap, fwd rel per query tile {fwd_rel:.3e}, bwd rel "
        f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())}; the plain version "
        f"without the cap's derivative, bwd rel "
        f"{', '.join(f'{n} {e:.3e}' for n, e in st_rel.items())} (each must exceed its pin, "
        f"{FLASH_FWD_TILE_REL} and {FLASH_BWD_REL}; dv does not see the derivative)")
    if (not fwd_rel > FLASH_FWD_TILE_REL
            or not all(bwd_rel[g] > FLASH_BWD_REL and st_rel[g] > FLASH_BWD_REL
                       for g in ("dq", "dk"))):
        raise SystemExit(f"splash {label}: the inputs do not reach the softcap: a kernel "
                         f"without it would pass the pins")


def visible_pairs(S, window, seg, B) -> int:
    """(query, key) pairs the mask keeps, summed over the batch: the work
    this run's data needs."""
    import torch

    i = torch.arange(S, device="cuda")
    d = i[:, None] - i[None, :]
    keep = d >= 0
    if window:
        keep = keep & (d < window)
    if seg is None:
        return B * int(keep.sum())
    return int((keep[None] & (seg[:, :, None] == seg[:, None, :])).sum())


def splash_op_phase():
    """Splash kernel vs its plain version; returns the fwd and bwd rows at
    Gemma-2-9B's local layer (the first case)."""
    import torch

    from accelerate_tpu_torch.ops.attention import splash_attention_reference
    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    gemma = GEMMA2_ATTENTION
    cases = [("gemma2-9b local", dict(gemma, window=4096, padded=False)),
             ("gemma2-9b global", dict(gemma, window=None, padded=False)),
             ("gemma2-9b local padded", dict(gemma, window=4096, padded=True)),
             ("mistral-7b", dict(B=1, S=8192, H=32, Hkv=8, D=128, scale=128 ** -0.5,
                                 softcap=None, window=4096, padded=False)),
             ("crossover S1024", dict(gemma, S=1024, window=4096, padded=False)),
             # An odd multiple of 64: the last 128-row query tile is half
             # past the end; a window that cuts tiles, and padding.
             ("ragged S1088", dict(gemma, S=1088, window=300, padded=True, timed=False)),
             # Logits of standard deviation 16 against Gemma-2's cap of 50:
             # with unit logits the cap moves them by about l^3 / (3 cap^2),
             # below the pins, so only this case sees the softcap.
             ("gemma2-9b local, logits at the cap", dict(gemma, window=4096, padded=True,
                                                          q_std=16.0, controls=True,
                                                          timed=False))]
    rows = []
    for label, c in cases:
        B, S, H, D, window, softcap = c["B"], c["S"], c["H"], c["D"], c["window"], c["softcap"]
        q, k, v, do, seg = splash_case(B, S, H, c["Hkv"], D, c["scale"], c["padded"],
                                       c.get("q_std", 1.0))
        kw = dict(segment_ids=seg, window=window, softcap=softcap)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sk.splash_attention_cuda(*leaves, **kw)
        out.backward(do)
        ref = splash_attention_reference(*ref_leaves, **kw)
        ref.backward(do)
        torch.cuda.synchronize()
        out, ref = out.detach(), ref.detach()
        real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
        fwd_err = float((out.float() - ref.float())[real].abs().max())
        fwd_rel = tile_rel_err(out, ref, real)
        if not math.isfinite(fwd_rel) or fwd_rel > FLASH_FWD_TILE_REL:
            raise SystemExit(f"splash {label}: forward relative error of a query tile "
                             f"{fwd_rel} > {FLASH_FWD_TILE_REL}")
        bwd_rel = splash_grad_rel(leaves, ref_leaves)
        for name, rel in bwd_rel.items():
            if not math.isfinite(rel) or rel > FLASH_BWD_REL:
                raise SystemExit(f"splash {label}: {name} relative error {rel} > {FLASH_BWD_REL}")
        bwd_err = float(max((a.grad.float() - b.grad.float()).abs().max()
                            for a, b in zip(leaves, ref_leaves)))
        if not c.get("timed", True):  # checked, not timed
            log(f"op splash {label} (B{B} S{S} H{H} D{D}, window {window}, softcap {softcap}, "
                f"{'padded' if seg is not None else 'unpadded'}, logit std "
                f"{c.get('q_std', 1.0) * c['scale'] * math.sqrt(D):g}): fwd rel per query tile "
                f"{fwd_rel:.3e} (pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
                f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())} (pin {FLASH_BWD_REL})")
            del leaves
            free_cuda()
            if c.get("controls"):
                softcap_controls(q, k, v, do, ref, ref_leaves, kw, real, label)
            del q, k, v, do, seg, out, ref, ref_leaves
            free_cuda()
            continue
        del leaves, ref_leaves, ref
        free_cuda()

        pairs = H * visible_pairs(S, window, seg, B)
        fwd_flops, bwd_flops = 4 * D * pairs, 10 * D * pairs
        el = 2  # bf16 bytes
        fwd_bytes = 4 * B * S * H * D * el + B * H * S * 4          # q,k,v in; o, lse out
        bwd_bytes = 8 * B * S * H * D * el + 2 * B * H * S * 4      # q,k,v,o,dO in; dq,dk,dv out
        win = 0 if window is None else min(window, S)
        cap = 0.0 if softcap is None else softcap
        # Device times from single synchronised calls: torch.profiler lost
        # splash's kernel records in this phase (PERF.md section 7); its
        # record count is logged beside them.

        def fwd_call():
            return sk._forward(q, k, v, seg, win, cap)

        with torch.no_grad():
            t_fwd = cuda_ms(fwd_call, 20)
            dev_fwd = synced_ms(fwd_call)
            prof_fwd = [profile_calls(fwd_call, warmup=w) for w in (False, True)]
            t_plain_fwd = cuda_ms(lambda: splash_attention_reference(q, k, v, **kw), 3)
        o, lse = sk._forward(q, k, v, seg, win, cap)

        def bwd_call():
            return sk._backward(q, k, v, seg, o, lse, do, win, cap)

        t_bwd = cuda_ms(bwd_call, 20)
        dev_bwd = synced_ms(bwd_call)
        prof_bwd = [profile_calls(bwd_call, warmup=w) for w in (False, True)]
        for what, profiles, want in (("forward", prof_fwd, 10), ("backward", prof_bwd, 30)):
            for records, how in zip(profiles, ("without", "with")):
                kernels = [us for _, kind, us in records if kind == "kernel"]
                log(f"op splash {label} {what}: the profiler {how} a warm-up cycle kept "
                    f"{len(kernels)} of {want} kernel records ({sum(kernels) / 1e3 / 10:.4f} ms a "
                    f"call from them)")
        plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_out = splash_attention_reference(*plain_leaves, **kw)
        t_plain_bwd = cuda_ms(lambda: torch.autograd.grad(plain_out, plain_leaves, do,
                                                          retain_graph=True), 3)
        del plain_out, plain_leaves
        free_cuda()
        call, lib_leaves = library_attention(q, k, v, seg, window, softcap)
        t_lib_fwd = cuda_ms(call, 10)  # with grad on, as compiled: no second compile
        lib_out = call()
        do_t = do.transpose(1, 2)
        t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do_t,
                                                        retain_graph=True), 10)
        fb, fby = bound_row(fwd_flops, fwd_bytes)
        bb, bby = bound_row(bwd_flops, bwd_bytes)
        log(f"op splash {label} (B{B} S{S} H{H} D{D}, window {window}, softcap {softcap}, "
            f"{'padded' if seg is not None else 'unpadded'}): fwd rel per query tile "
            f"{fwd_rel:.3e} (pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
            f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())} (pin {FLASH_BWD_REL}); "
            f"fwd kernel {t_fwd:.4f} ms ({dev_fwd:.4f} ms a single synchronised call), plain "
            f"{t_plain_fwd:.4f}, library {t_lib_fwd:.4f}, bound {fb:.4f} ({fby}, "
            f"{fwd_flops / 1e9:.1f} GFLOP, {pairs / H / 1e6:.2f}M visible pairs a head, "
            f"{fwd_flops / t_fwd / 1e9:.1f} TFLOP/s); bwd kernel {t_bwd:.4f} ms (a single "
            f"synchronised call {dev_bwd:.4f}), plain {t_plain_bwd:.4f}, library {t_lib_bwd:.4f}, bound {bb:.4f} "
            f"({bby}, {bwd_flops / t_bwd / 1e9:.1f} TFLOP/s); library: compiled "
            f"flex_attention, block mask and softcap score_mod")
        if not rows:  # Gemma-2-9B's local layer: the rows of the kernel table
            base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/splash_attention.cu",
                    "replaces": "accelerate_tpu/ops/attention.py:180", "launches": 0}
            rows = [dict(base, name="splash_attention_fwd", max_abs_err=fwd_err, ms=t_fwd,
                         plain_ms=t_plain_fwd, bound_ms=fb, bound_by=fby, library_ms=t_lib_fwd),
                    dict(base, name="splash_attention_bwd", max_abs_err=bwd_err, ms=t_bwd,
                         plain_ms=t_plain_bwd, bound_ms=bb, bound_by=bby, library_ms=t_lib_bwd)]
        del q, k, v, do, seg, out, o, lse, lib_out, lib_leaves, call, fwd_call, bwd_call
        free_cuda()
    return rows


def splash_times() -> dict:
    """``--splash-times``: the splash kernels' forward and backward times
    (CUDA events, 20 calls) at Gemma-2-9B's local and global layers, from
    phase 8's inputs, and nothing else."""
    import torch

    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    c = GEMMA2_ATTENTION
    times = {}
    for label, window in (("local", 4096), ("global", 0)):
        q, k, v, do, _ = splash_case(c["B"], c["S"], c["H"], c["Hkv"], c["D"], c["scale"], False)
        with torch.no_grad():
            fwd = cuda_ms(lambda: sk._forward(q, k, v, None, window, c["softcap"]), 20)
        o, lse = sk._forward(q, k, v, None, window, c["softcap"])
        bwd = cuda_ms(lambda: sk._backward(q, k, v, None, o, lse, do, window, c["softcap"]), 20)
        times[label] = {"fwd_ms": fwd, "bwd_ms": bwd}
        # The profiler here, early in a process, against phase 8 (PERF.md section 7).
        with torch.no_grad():
            kept_fwd = profile_calls(lambda: sk._forward(q, k, v, None, window, c["softcap"]),
                                     warmup=False)
        kept_bwd = profile_calls(lambda: sk._backward(q, k, v, None, o, lse, do, window,
                                                      c["softcap"]), warmup=False)
        log(f"splash times {label}: the profiler without a warm-up cycle kept "
            f"{sum(k == 'kernel' for _, k, _ in kept_fwd)} of 10 forward and "
            f"{sum(k == 'kernel' for _, k, _ in kept_bwd)} of 30 backward kernel records")
        log(f"splash times {label} (B{c['B']} S{c['S']} H{c['H']} D{c['D']}, window "
            f"{window or None}, softcap {c['softcap']}): fwd {fwd:.4f} ms, bwd {bwd:.4f} ms")
        del q, k, v, do, o, lse
        free_cuda()
    return times


def gemma2_train_phase(card):
    """Phase 9; returns the kernel arm's launch counts."""
    from accelerate_tpu_torch import Llama

    cfg = gemma2_config(GEMMA2_LAYERS)
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers, shape = cfg.num_hidden_layers, (GEMMA2_BATCH, GEMMA2_SEQ)
    tokens = GEMMA2_BATCH * GEMMA2_SEQ
    losses, wall, counts, _, peak = train_arm(cfg, steps=7, warmup=2, shape=shape)
    want = {"splash_attention_fwd": 7 * layers, "splash_attention_bwd": 7 * layers,
            "fused_adamw_update": 7 * 13}
    if counts != want:
        raise SystemExit(f"gemma2 train: launch counts {counts}, expected {want} (no flash)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"gemma2 train: losses not finite and falling: {losses}")
    step_s = wall / 5
    mfu = fpt * tokens / step_s / BF16_OPS_PER_S
    log(f"gemma2 train: Gemma-2-9B widths, {layers} layers (windows {cfg.layer_windows}), "
        f"{n_params / 1e9:.3f}B params, bf16 compute on f32 masters, fused loss (chunk "
        f"{cfg.fused_loss_chunk}), adamw(3e-4), clip 1.0, batch {GEMMA2_BATCH}x{GEMMA2_SEQ}; "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"({fpt:.4g} FLOP/token); launches over 7 steps {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    pair = gemma2_config(GEMMA2_PAIR_LAYERS)
    kern, _, kern_counts, _, kern_peak = train_arm(pair, steps=3, shape=shape)
    off, _, off_counts, _, off_peak = train_arm(pair, steps=3, kernels="off", shape=shape)
    diff = max(abs(a - b) for a, b in zip(off, kern))
    want = {"splash_attention_fwd": 3 * GEMMA2_PAIR_LAYERS,
            "splash_attention_bwd": 3 * GEMMA2_PAIR_LAYERS, "fused_adamw_update": 3 * 13}
    if kern_counts != want or off_counts or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"gemma2 train, {GEMMA2_PAIR_LAYERS} layers: kernel arm {kern} "
                         f"(launches {kern_counts}), kernels='off' arm {off} (launches "
                         f"{off_counts}); max |diff| {diff}, pin {TRAIN_LOSS_ATOL}")
    log(f"gemma2 train, {GEMMA2_PAIR_LAYERS} layers (windows {pair.layer_windows}): kernel arm "
        f"losses {[round(x, 4) for x in kern]}, kernels='off' arm {[round(x, 4) for x in off]}, "
        f"max |diff| {diff:.3e} (pin {TRAIN_LOSS_ATOL}); peak memory {kern_peak / 2**30:.2f} "
        f"GiB and {off_peak / 2**30:.2f} GiB")
    return counts


def ring_case(B: int, S: int, seed: int = SEED):
    """q, k, v (KV heads repeated to the query heads, as the Llama block
    does before the ring) and dO, (B, S, 32, 128) bf16, made on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn((B, S, heads, RING_HEAD_DIM), generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q = randn(RING_HEADS)
    k, v = (randn(RING_KV_HEADS).repeat_interleave(RING_HEADS // RING_KV_HEADS, dim=2)
            for _ in range(2))
    return q, k, v, randn(RING_HEADS)


def rel_fro(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def check_ring_block(label, q, k, v, do, mask, mode):
    """One block kernel, forward and backward, against its plain twin at
    the cell's shard; returns (forward max|err|, backward max|err|)."""
    import torch

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels import ring_block as rk
    from accelerate_tpu_torch.parallel import ring

    registry.reset_launch_counts()
    o, l, m = rk.ring_block_fwd_cuda(q, k, v, mask, mode)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = ring.ring_block_fwd_reference(q, k, v, mask, mode)
    seen = l_ref > 0
    errs = {}
    if bool(((l > 0) != seen).any()) or not bool((m[~seen] == ring.NEG_INF).all()):
        raise SystemExit(f"ring block {label}: rows with no visible key differ from the twin's")
    if mode != ring.SKIP:
        errs["o tile"] = tile_rel_err(o, o_ref, seen[:, 0])
        errs["l"] = float(((l - l_ref).abs() / l_ref.clamp(min=1))[seen].max())
        errs["m"] = float((m - m_ref)[seen].abs().max())
    fwd_err = float((o.float() - o_ref.float()).abs().max())
    lse = ring._lse_to_m(torch.where(seen, m_ref + torch.log(l_ref.clamp(min=1e-30)),
                                     torch.inf))
    delta = (o_ref.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    del o, l, m, o_ref, l_ref, m_ref
    free_cuda()
    got = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    rk.ring_block_bwd_cuda(q, k, v, mask, mode, lse, do, delta, *got)
    torch.cuda.synchronize()
    want = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    ring.ring_block_bwd_reference(q, k, v, mask, mode, lse, do, delta, *want)
    counts = dict(registry.launch_counts)
    expect = {} if mode == ring.SKIP else {"ring_block_fwd": 1, "ring_block_bwd": 1}
    if counts != expect:
        raise SystemExit(f"ring block {label}: launches {counts}, expected {expect}")
    bwd_err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        bwd_err = max(bwd_err, float((a - b).abs().max()))
        errs[name] = 0.0 if float(b.norm()) == 0 and float(a.norm()) == 0 else rel_fro(a, b)
    for name, err in errs.items():
        pin = (FLASH_FWD_TILE_REL if name == "o tile" else
               RING_STATS_ATOL if name in ("l", "m") else FLASH_BWD_REL)
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring block {label}: {name} error {err} > {pin}")
    log(f"op ring block {label}: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (pins: o per query tile {FLASH_FWD_TILE_REL}, l/m {RING_STATS_ATOL}, "
        f"gradients {FLASH_BWD_REL}); launches {counts}")
    del got, want, lse, delta
    free_cuda()
    return fwd_err, bwd_err


def time_ring_block(q, k, v, do, mode: int):
    """(kernel, twin, sdpa) ms forward and backward on one block."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.kernels import ring_block as rk
    from accelerate_tpu_torch.parallel import ring

    o, l, m = rk.ring_block_fwd_cuda(q, k, v, None, mode)
    lse = ring._lse_to_m(m + torch.log(l))
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    acc = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    t = {"fwd": cuda_ms(lambda: rk.ring_block_fwd_cuda(q, k, v, None, mode), 10),
         "bwd": cuda_ms(lambda: rk.ring_block_bwd_cuda(q, k, v, None, mode, lse, do, delta,
                                                       *acc), 10),
         "plain_fwd": cuda_ms(lambda: ring.ring_block_fwd_reference(q, k, v, None, mode), 3, 1),
         "plain_bwd": cuda_ms(lambda: ring.ring_block_bwd_reference(q, k, v, None, mode, lse, do,
                                                                    delta, *acc), 3, 1)}
    del acc, o, l, m
    free_cuda()
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    causal = mode == ring.DIAGONAL
    with torch.no_grad():
        t["library_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=causal), 10)
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    t["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                           retain_graph=True), 10)
    del out, leaves
    free_cuda()
    return t


def ring_shards(x, n=RING_RANKS):
    return list(x.chunk(n, dim=1))


def ring_phase():
    """Phase 10; returns the rows of the two ring-block kernels."""
    import torch

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels.flash_attention import flash_attention_cuda
    from accelerate_tpu_torch.parallel.ring import LoopbackRing, ring_attention

    n, S, H, D = RING_RANKS, RING_SEQ, RING_HEADS, RING_HEAD_DIM
    s_loc = S // n
    q, k, v, do = ring_case(1, S)
    qs, ks, vs, dos = (ring_shards(x) for x in (q, k, v, do))
    # Each block kernel against its twin: rank 3's queries against its own
    # block (diagonal), rank 1's block (full), rank 1's with right padding,
    # and a skipped block.
    pad = torch.ones((1, s_loc), dtype=torch.int32, device="cuda")
    pad[:, -1000:] = 0
    errs = {}
    torch.cuda.reset_peak_memory_stats()
    for label, kv, mask, mode in (("diagonal", 3, None, 0), ("full", 1, None, 1),
                                  ("full, right-padded KV", 1, pad, 1), ("skipped", 3, None, 2)):
        errs[label] = check_ring_block(f"{label} (s_loc {s_loc}, mode {mode})", qs[3], ks[kv],
                                       vs[kv], dos[3], mask, mode)
    peak_blocks = torch.cuda.max_memory_allocated() / 2**30
    times = {label: time_ring_block(qs[3], ks[kv], vs[kv], dos[3], mode)
             for label, kv, mode in (("full", 1, 1), ("diagonal", 3, 0))}

    # The main path: the whole ring, forward and backward, counted.
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    outs = ring_attention(*(ring_shards(x) for x in leaves), causal=True, group=LoopbackRing(n))
    torch.autograd.backward(outs, dos)
    torch.cuda.synchronize()
    counts = dict(registry.launch_counts)
    peak_ring = torch.cuda.max_memory_allocated() / 2**30
    want = {"ring_block_fwd": n * (n + 1) // 2, "ring_block_bwd": n * (n + 1) // 2}
    if counts != want:
        raise SystemExit(f"ring S{S}: launches {counts}, expected {want}")
    out = torch.cat(outs, 1).detach()
    del outs
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_attention_cuda(*ref_leaves, causal=True)
    ref.backward(do)
    torch.cuda.synchronize()
    real = torch.ones((1, S), dtype=torch.bool, device="cuda")
    ring_errs = {"o tile": tile_rel_err(out, ref.detach(), real)}
    ring_errs.update({f"d{x}": rel_fro(a.grad, b.grad)
                      for x, a, b in zip("qkv", leaves, ref_leaves)})
    for name, err in ring_errs.items():
        pin = FLASH_FWD_TILE_REL if name == "o tile" else FLASH_BWD_REL
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring S{S} vs single-card flash: {name} error {err} > {pin}")
    del ref, ref_leaves, out
    free_cuda()
    t_ring_fwd = cuda_ms(lambda: ring_attention(*(ring_shards(x) for x in (q, k, v)),
                                                causal=True, group=LoopbackRing(n)), 3, 1)
    outs = ring_attention(*(ring_shards(x) for x in leaves), causal=True, group=LoopbackRing(n))
    t_ring_bwd = cuda_ms(lambda: torch.autograd.grad(outs, leaves, dos, retain_graph=True), 3, 1)
    del outs, leaves
    free_cuda()
    t_flash_fwd = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), 3, 1)
    flash_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_out = flash_attention_cuda(*flash_leaves, causal=True)
    t_flash_bwd = cuda_ms(lambda: torch.autograd.grad(flash_out, flash_leaves, do,
                                                      retain_graph=True), 3, 1)
    del flash_out, flash_leaves, q, k, v, do, qs, ks, vs, dos
    free_cuda()

    # The ring at S=4096 against kernels="off": right padding in row 0 that
    # sits in KV shards 2-3, a left-padded row 1 whose first 1500 queries
    # see no key at all (the -1e30 start, and zero rows out).
    small = RING_SMALL_SEQ
    q, k, v, do = ring_case(2, small, seed=SEED + 1)
    mask = torch.ones((2, small), dtype=torch.int32, device="cuda")
    mask[0, 2500:] = 0
    mask[1, :1500] = 0
    arms = []
    for kernels in (None, "off"):
        arm_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        registry.reset_launch_counts()
        outs = ring_attention(*(ring_shards(x) for x in arm_leaves), causal=True,
                              mask=ring_shards(mask), group=LoopbackRing(n), kernels=kernels)
        torch.autograd.backward(outs, ring_shards(do))
        torch.cuda.synchronize()
        arms.append((torch.cat(outs, 1).detach(), [x.grad for x in arm_leaves],
                     dict(registry.launch_counts)))
    (o_k, g_k, c_k), (o_off, g_off, c_off) = arms
    sees = mask.cumsum(1) > 0
    small_errs = {"o tile": tile_rel_err(o_k, o_off, sees)}
    small_errs.update({f"d{x}": rel_fro(a, b) for x, a, b in zip("qkv", g_k, g_off)})
    if c_k != want or c_off != {}:
        raise SystemExit(f"ring S{small} padded: launches {c_k} / {c_off}")
    if not (bool((o_k[~sees] == 0).all()) and bool((o_off[~sees] == 0).all())):
        raise SystemExit(f"ring S{small} padded: rows that see no key are not 0")
    for name, err in small_errs.items():
        pin = FLASH_FWD_TILE_REL if name == "o tile" else FLASH_BWD_REL
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring S{small} padded vs kernels='off': {name} error {err} > {pin}")
    del arms, o_k, o_off, g_k, g_off, q, k, v, do
    free_cuda()

    # Bounds: a full block is 4 s_loc^2 H D flops forward and 2.5 times that
    # backward (five products, as rows 5b and 6b); the whole causal ring is
    # causal attention at S.
    el = 2
    full_fwd = 4 * s_loc * s_loc * H * D
    block_bytes_fwd = 4 * s_loc * H * D * el + 2 * H * s_loc * 4     # q,k,v in; o, l, m out
    block_bytes_bwd = (4 * s_loc * H * D * el + 2 * H * s_loc * 4    # q,k,v,dO, lse, delta in
                       + 2 * 3 * s_loc * H * D * 4)                  # dq,dk,dv f32 read + written
    fb, fby = bound_row(full_fwd, block_bytes_fwd)
    bb, bby = bound_row(2.5 * full_fwd, block_bytes_bwd)
    db, _ = bound_row(full_fwd * (s_loc + 1) / (2 * s_loc), block_bytes_fwd)
    causal_fwd = 4 * D * H * S * (S + 1) / 2
    rb, _ = bound_row(causal_fwd, 4 * S * H * D * el)
    rbb, _ = bound_row(2.5 * causal_fwd, 8 * S * H * D * el)
    for label, t in times.items():
        part = 1.0 if label == "full" else (s_loc + 1) / (2 * s_loc)  # kept pairs
        f_bound = fb if label == "full" else db
        b_bound = bb * part
        fwd_note = speed_note(full_fwd * part, t["fwd"], t["library_fwd"], f_bound)
        bwd_note = speed_note(2.5 * full_fwd * part, t["bwd"], t["library_bwd"], b_bound)
        log(f"op ring block {label} (B1 s_loc {s_loc} H{H} D{D}): fwd kernel {t['fwd']:.4f} ms, "
            f"plain {t['plain_fwd']:.4f}, sdpa {t['library_fwd']:.4f}, bound {f_bound:.4f}; "
            f"{fwd_note}; bwd kernel {t['bwd']:.4f} ms, plain {t['plain_bwd']:.4f}, sdpa "
            f"{t['library_bwd']:.4f}, bound {b_bound:.4f}; {bwd_note}")
    log(f"ring S{S} over {n} ranks (LoopbackRing): launches {counts}; vs single-card flash "
        + ", ".join(f"{name} {e:.3e}" for name, e in ring_errs.items())
        + f"; S{small} padded vs kernels='off' "
        + ", ".join(f"{name} {e:.3e}" for name, e in small_errs.items())
        + f"; ring fwd {t_ring_fwd:.3f} ms, bwd {t_ring_bwd:.3f} ms (bounds {rb:.3f} / "
        f"{rbb:.3f}); single-card flash fwd {t_flash_fwd:.3f} ms, bwd {t_flash_bwd:.3f} ms; "
        f"peak memory {peak_blocks:.2f} GiB in the block checks, {peak_ring:.2f} GiB in the "
        f"ring's forward and backward")
    full = times["full"]
    base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/flash_attention.cu"}
    return [dict(base, name="ring_block_fwd", replaces="accelerate_tpu/parallel/ring.py:93",
                 launches=counts["ring_block_fwd"], max_abs_err=errs["full"][0], ms=full["fwd"],
                 plain_ms=full["plain_fwd"], bound_ms=fb, bound_by=fby,
                 library_ms=full["library_fwd"]),
            dict(base, name="ring_block_bwd", replaces="accelerate_tpu/parallel/ring.py:209",
                 launches=counts["ring_block_bwd"], max_abs_err=errs["full"][1], ms=full["bwd"],
                 plain_ms=full["plain_bwd"], bound_ms=bb, bound_by=bby,
                 library_ms=full["library_bwd"])]


def bert_base_config():
    """bert-base-cased's published config through the port's converter,
    dropout off (parity with ``kernels="off"`` needs the same draws)."""
    import dataclasses

    from accelerate_tpu_torch import bert_config_from_hf

    return dataclasses.replace(bert_config_from_hf(BERT_BASE_CASED), hidden_dropout_prob=0.0)


def loop_arm(cfg, inject: bool, steps=None, kernels=None, accum: int = 1, evaluate=False,
             profile=False):
    """The canonical loop on a fresh model from the seed; returns a dict of
    the losses, launch counts (all steps, and after each step), the wall
    seconds of steps [LOOP_WARMUP, LOOP_WARMUP + LOOP_TIMED), the peak
    bytes, the learning rates and, with ``evaluate``, the eval's rows and
    accuracy."""
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        BertForSequenceClassification,
        adamw,
        inject_hyperparams,
        linear_schedule,
        set_seed,
    )
    from accelerate_tpu_torch.examples.nlp_example import get_dataloaders
    from accelerate_tpu_torch.ops import registry

    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=accum, kernels=kernels)
    set_seed(SEED)
    model = BertForSequenceClassification(cfg)
    model.init_params(SEED)
    train_dl, eval_dl = get_dataloaders(LOOP_BATCH, cfg.vocab_size, train_size=LOOP_TRAIN,
                                        eval_size=LOOP_EVAL, seq_len=LOOP_SEQ,
                                        eval_drop_last=False)
    train_dl, eval_dl = acc.prepare(train_dl, eval_dl)
    schedule = None
    if inject:
        schedule = linear_schedule(LOOP_LR, LOOP_END_LR, len(train_dl) // accum)
        model, opt, sched = acc.prepare(model, inject_hyperparams(adamw)(learning_rate=LOOP_LR),
                                        schedule)
    else:
        (model, opt), sched = acc.prepare(model, adamw(LOOP_LR)), None
    out = {"losses": [], "per_step": [], "wall": None, "schedule": schedule, "opt": opt,
           "sched": sched}
    model.train()
    train_dl.set_epoch(0)
    registry.reset_launch_counts()
    for i, batch in enumerate(train_dl):
        if steps is not None and i == steps:
            break
        if i == LOOP_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        prof = None
        if profile and i == LOOP_WARMUP + LOOP_TIMED:  # after the timed steps
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            if acc.sync_gradients:
                acc.clip_grad_norm_(model, 1.0)
            opt.step()
            if sched is not None:
                sched.step()
            opt.zero_grad()
        out["losses"].append(loss.detach())
        out["per_step"].append(dict(registry.launch_counts))
        if prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            log_profile(prof, wall, "loop arm B")
        if i == LOOP_WARMUP + LOOP_TIMED - 1:
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["counts"] = dict(registry.launch_counts)
    out["losses"] = [float(x) for x in out["losses"]]
    out["lr"] = opt.learning_rate
    out["peak"] = torch.cuda.max_memory_allocated()
    if evaluate:
        model.eval()
        correct = rows = 0
        for batch in eval_dl:
            labels = batch.pop("labels")
            preds, refs = acc.gather_for_metrics((model(**batch)["logits"].argmax(-1), labels))
            correct += int((preds == refs).sum())
            rows += len(refs)
        out["rows"], out["accuracy"] = rows, correct / rows
    acc.end_training()
    del acc, model, opt, sched, train_dl, eval_dl
    free_cuda()
    return out


def loop_phase(card, profile: bool = False) -> dict:
    """Phase 11; returns arm B's launch counts."""
    from accelerate_tpu_torch import BertForSequenceClassification

    cfg = bert_base_config()
    probe = BertForSequenceClassification(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token(LOOP_SEQ)
    tokens = LOOP_BATCH * LOOP_SEQ
    n_steps = LOOP_TRAIN // LOOP_BATCH
    shape = (f"bert-base-cased widths ({cfg.num_hidden_layers} layers of {cfg.hidden_size}, "
             f"vocabulary {cfg.vocab_size}, {n_params / 1e6:.1f}M params), bf16 compute on f32 "
             f"masters, batch {LOOP_BATCH}x{LOOP_SEQ}, clip 1.0")

    def speed(run, label):
        step_s = run["wall"] / LOOP_TIMED
        log(f"loop {label}: {1 / step_s:.2f} steps/s, {tokens / step_s:.0f} tokens/s "
            f"(host clock over steps {LOOP_WARMUP}-{LOOP_WARMUP + LOOP_TIMED - 1}, ending in "
            f"synchronize(); {step_s * 1e3:.2f} ms a step, MFU "
            f"{100 * fpt * tokens / step_s / BF16_OPS_PER_S:.2f}% of 989 TFLOP/s at "
            f"{fpt:.4g} FLOP/token); peak memory {run['peak'] / 2**30:.2f} GiB "
            f"[finding, not a limit; {card}]")
        return step_s

    a = loop_arm(cfg, inject=True, evaluate=True)
    want_lr = float(a["schedule"](n_steps))
    if (a["counts"] or len(a["losses"]) != n_steps
            or not all(math.isfinite(x) for x in a["losses"])):
        raise SystemExit(f"loop arm A: {len(a['losses'])} steps (want {n_steps}), launches "
                         f"{a['counts']} (want none: the reference chain), losses finite: "
                         f"{all(math.isfinite(x) for x in a['losses'])}")
    if not (a["lr"] == want_lr == a["sched"].get_last_lr()[0]):
        raise SystemExit(f"loop arm A: learning rate after the last step {a['lr']}, the "
                         f"schedule's {want_lr}, the scheduler's {a['sched'].get_last_lr()}")
    if a["rows"] != LOOP_EVAL:
        raise SystemExit(f"loop arm A: gather_for_metrics gave {a['rows']} rows, the eval set "
                         f"has {LOOP_EVAL}")
    log(f"loop arm A (inject_hyperparams(adamw) + linear_schedule, the reference chain): "
        f"{shape}; {n_steps} steps, losses first {[round(x, 4) for x in a['losses'][:3]]} "
        f"last {[round(x, 4) for x in a['losses'][-3:]]}; no fused update launched; lr after "
        f"the last step {a['lr']:.6g} (the schedule's); eval rows {a['rows']}, accuracy "
        f"{a['accuracy']:.4f} (random init, one epoch at 2e-5; a finding, not a check)")
    speed(a, "arm A")

    b = loop_arm(cfg, inject=False, steps=LOOP_B_STEPS, profile=profile)
    per_step = [c.get("fused_adamw_update", 0) for c in b["per_step"]]
    leaves = 25
    if (b["counts"] != {"fused_adamw_update": leaves * LOOP_B_STEPS}
            or per_step != [leaves * (i + 1) for i in range(LOOP_B_STEPS)]
            or not all(math.isfinite(x) for x in b["losses"])):
        raise SystemExit(f"loop arm B: launches {b['counts']} (want fused_adamw_update "
                         f"{leaves} a step over {LOOP_B_STEPS} steps), after each step "
                         f"{per_step[:5]}..., losses {b['losses'][:5]}...")
    log(f"loop arm B (constant adamw(2e-5), the fused update from optimizer.step()): "
        f"{LOOP_B_STEPS} steps, fused_adamw_update launched {leaves} times a step "
        f"({b['counts']}); losses first {[round(x, 4) for x in b['losses'][:3]]} last "
        f"{[round(x, 4) for x in b['losses'][-3:]]}")
    speed(b, "arm B")
    off = loop_arm(cfg, inject=False, steps=3, kernels="off")
    diff = max(abs(x - y) for x, y in zip(off["losses"], b["losses"][:3]))
    if off["counts"] or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"loop kernels='off': losses {off['losses']} vs {b['losses'][:3]} "
                         f"(max |diff| {diff}, pin {TRAIN_LOSS_ATOL}), launches {off['counts']}")
    log(f"loop kernels='off': losses {[round(x, 6) for x in off['losses']]}, max |diff| "
        f"{diff:.3e} vs arm B (pin {TRAIN_LOSS_ATOL}); no launches")
    acc2 = loop_arm(cfg, inject=False, steps=4, accum=2)
    updates = [c.get("fused_adamw_update", 0) for c in acc2["per_step"]]
    if updates != [0, leaves, leaves, 2 * leaves]:
        raise SystemExit(f"loop accumulation 2: update launches after each micro-step "
                         f"{updates}, expected [0, {leaves}, {leaves}, {2 * leaves}]")
    log(f"loop accumulation 2: 4 micro-steps, update launches after each {updates}")
    return b["counts"]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from accelerate_tpu_torch import Llama, LlamaConfig
    from accelerate_tpu_torch.ops.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    if "--paged-decode" in argv:
        _build.build(["paged_decode", "paged_gather"])
        card = card_info()
        log(f"build: paged_decode, paged_gather in {time.perf_counter() - t0:.1f} s; device: "
            f"{card}")
        probe = Llama(LlamaConfig.tiny(), device="cuda")  # the geometry needs no 8B weights
        probe.init_params(SEED, dtype=torch.bfloat16)
        paged_decode_phase(LlamaConfig.llama3_8b(), engine_kwargs(), *engine_geometry(probe))
        print(card)
        return 0
    if "--loop" in argv:
        _build.build(["fused_update"])
        card = card_info()
        log(f"build: fused_update in {time.perf_counter() - t0:.1f} s; device: {card}")
        loop_phase(card, profile="--profile" in argv)
        print(card)
        return 0
    if "--splash-times" in argv:
        _build.build(["splash_attention"])
        card = card_info()
        log(f"build: splash_attention in {time.perf_counter() - t0:.1f} s; device: {card}")
        print(json.dumps({"splash_times": splash_times(), "card": card}))
        return 0
    logs = _build.build(ptxas_info=True)
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"build[{name}]: {line}")
    for name in ("flash_attention", "splash_attention", "int8_matmul", "paged_decode"):
        summary = ptxas_summary(logs.get(name, ""))
        for line in summary:
            log(f"build[{name}] summary: {line}")
        check_no_spills(summary, name)
        for fn, reg in sass_registers(_build.library_path(name)).items():
            log(f"build[{name}] sass: {fn}: highest register R{reg}")
    card = card_info()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    cfg = LlamaConfig.llama3_8b()
    model = Llama(cfg, device="cuda")
    t0 = time.perf_counter()
    model.init_params(SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model: Llama-3-8B widths, {cfg.num_hidden_layers} layers, bf16, "
          f"{model.num_params() / 1e9:.2f}B params, random init (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")

    blocks, max_blocks = engine_geometry(model)
    rows = op_phase(cfg, engine_kwargs(), blocks, max_blocks)
    int8_row = int8_op_phase()
    rows += paged_decode_phase(cfg, engine_kwargs(), blocks, max_blocks)
    bf16_run = engine_phase(model, None, ("paged_gather",), card)
    rows[0]["launches"] = bf16_run["launches"]["paged_gather"]
    rows[1]["launches"] = engine_phase(model, "int8", ("paged_gather_dequant",),
                                       card)["launches"]["paged_gather_dequant"]
    int8_run = int8_engine_phase(model, card, bf16_run)
    int8_row["launches"] = int8_run["launches"]["int8_matmul"]
    rows.append(int8_row)
    reference_phase(model)
    if "--profile" in argv:
        profile_wave(model, "bf16")
        profile_wave(model, "int8", kv_quant="int8", matmul_precision="int8")
    del model  # free the 16 GB serving model before training
    free_cuda()

    train_rows = flash_op_phase() + update_op_phase(LlamaConfig.llama3_8b(**TRAIN_CUT))
    counts = train_phase(card)
    for row in train_rows:
        row["launches"] = counts.get(row["name"], 0)
    rows += train_rows
    if "--profile" in argv:
        profile_train_step(LlamaConfig.llama3_8b(**TRAIN_CUT), (TRAIN_BATCH, TRAIN_SEQ), "train")
    free_cuda()

    splash_rows = splash_op_phase()
    counts = gemma2_train_phase(card)
    for row in splash_rows:
        row["launches"] = counts.get(row["name"], 0)
    rows += splash_rows
    if "--profile" in argv:
        profile_train_step(gemma2_config(GEMMA2_LAYERS), (GEMMA2_BATCH, GEMMA2_SEQ), "gemma2")
    free_cuda()

    rows += ring_phase()
    free_cuda()

    loop_counts = loop_phase(card, profile="--profile" in argv)
    for row in rows:  # phase 7's launches plus the loop's
        if row["name"] in loop_counts:
            log(f"kernel {row['name']}: {row['launches']} launches in phase 7, "
                f"{loop_counts[row['name']]} in phase 11")
            row["launches"] += loop_counts[row["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
