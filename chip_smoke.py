#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # what the checks need; a few minutes
    python3 chip_smoke.py --profile  # adds a torch.profiler pass over one wave

Phases, in order; any failure exits non-zero and nothing is caught:

1. Build every CUDA source of ``accelerate_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together), and print the card's
   name and power limit.
2. Op phase at the engine's shapes: the paged gather kernel, bf16 and
   int8-dequant-to-bf16, against its plain PyTorch version (bitwise on
   active slots, zeros on inactive ones), with times for the kernel, the
   plain version and one library call, beside the bytes-moved bound.
3. Engine phase: ``ContinuousBatcher(paged=True)`` on Llama-3-8B widths
   (all 32 layers, bf16, random weights from a seed) answers a wave of
   greedy requests behind a shared prefix, with chunked prefill engaged.
   Every request finishes, the pool's blocks all return, the kernel was
   launched, and the tokens equal those of an engine built with
   ``kernels="off"`` (the plain gather).
4. The same with an int8 KV pool (the dequant variant of the kernel).
5. Small-input reference check: on ``LlamaConfig.tiny()`` in fp32 the engine's
   output equals per-request ``generate()``, and the 8B forward's logits are
   finite with the expected shape.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 0
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


def engine_phase(model, kv_quant, kernel_name: str, card: str):
    """Both arms on one wave; returns the kernel arm's launch count."""
    import numpy as np

    from accelerate_tpu_torch import ContinuousBatcher
    from accelerate_tpu_torch.ops import registry

    kw = engine_kwargs()
    prefix, suffixes = make_traffic(model.config.vocab_size)
    off = ContinuousBatcher(model, kernels="off", kv_quant=kv_quant, **kw)
    ref_tokens, _ = run_wave(off, prefix, suffixes)
    del off
    engine = ContinuousBatcher(model, kv_quant=kv_quant, **kw)
    registry.reset_launch_counts()
    tokens, wall = run_wave(engine, prefix, suffixes)
    launches = dict(registry.launch_counts)
    stats, slo = engine.pool_stats(), engine.slo_report()
    label = f"engine[kv_quant={kv_quant}]"
    if len(tokens) != len(suffixes) or any(t.size == 0 for t in tokens):
        raise SystemExit(f"{label}: not every request finished")
    if stats["blocks_free"] != stats["num_blocks"]:
        raise SystemExit(f"{label}: {stats['blocks_free']} of {stats['num_blocks']} blocks free")
    if launches.get(kernel_name, 0) <= 0:
        raise SystemExit(f"{label}: {kernel_name} was never launched ({launches})")
    if slo["decisions"]["chunked_prefills"] < 1:
        raise SystemExit(f"{label}: chunked prefill did not engage")
    for i, (a, b) in enumerate(zip(tokens, ref_tokens)):
        if not np.array_equal(a, b):
            raise SystemExit(f"{label}: request {i} differs from kernels='off': {a} vs {b}")
    vocab = model.config.vocab_size
    if any(((t < 0) | (t >= vocab)).any() for t in tokens):
        raise SystemExit(f"{label}: token id outside the vocabulary")
    n_tok = int(sum(t.size for t in tokens))
    ttft = float(np.median(slo["ttft_s"]))
    log(f"{label}: {len(tokens)} requests, {n_tok} tokens generated, wall {wall:.3f} s, "
          f"{n_tok / wall:.1f} tokens/s, TTFT p50 {ttft * 1e3:.1f} ms, launches {launches}, "
          f"decisions {slo['decisions']}, pool {stats['pool_bytes'] / 2**20:.0f} MiB; "
          f"identical to kernels='off' [{card}]")
    for i, (suffix, toks) in enumerate(zip(suffixes, tokens)):
        log(f"{label}: request {i}: prompt {prefix.size}+{suffix.size} tokens -> "
            f"{toks.size} tokens {toks.tolist()}")
    return launches[kernel_name]


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


def profile_wave(model):
    """torch.profiler over one wave: device time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import ContinuousBatcher

    prefix, suffixes = make_traffic(model.config.vocab_size)
    engine = ContinuousBatcher(model, **engine_kwargs())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_wave(engine, prefix, suffixes)
    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in events) / 1e3  # ms
    launches = sum(e.count for e in events)
    log_ = engine._dispatch_log
    forwards = sum(e.startswith("chunk") for e in log_) + engine.sync_every * log_.count("decode")
    log(f"profile: wave wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / (wall * 1e3):.1f}%), {launches} kernel launches over {forwards} "
        f"forwards ({launches / forwards:.0f} per forward, "
        f"{wall * 1e3 / forwards:.1f} ms wall and {total / forwards:.2f} ms device per forward)")
    for e in sorted(events, key=lambda e: -device_us(e))[:12]:
        log(f"profile:   {device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


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
    logs = _build.build(ptxas_info=True)
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"build[{name}]: {line}")
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

    from accelerate_tpu_torch import ContinuousBatcher

    probe = ContinuousBatcher(model, **engine_kwargs())
    rows = op_phase(cfg, engine_kwargs(), probe.num_blocks, probe.max_blocks_per_slot)
    del probe
    rows[0]["launches"] = engine_phase(model, None, "paged_gather", card)
    rows[1]["launches"] = engine_phase(model, "int8", "paged_gather_dequant", card)
    reference_phase(model)
    if "--profile" in argv:
        profile_wave(model)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
